"""BENCHMARK.json against the contract's characters, keys and files, and
every name it lists found where the harness looks for it."""

import json
import os
import re

import pytest

from portbench.run import HERE, ROOT, cell_metrics

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                        "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    assert MAN["paths"] == ["portbench"]
    assert len(MAN["command"]) <= 32 and all(LINE.match(w) for w in MAN["command"])


def test_the_check_fits_its_time():
    n = 24      # the most cells the benchmark may grow to
    total = (2 + 14 * n) * (MAN["run_seconds"] + 60) + n * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("entry", MAN["configs"] + MAN["workloads"] + MAN["end_to_end"]
                         + MAN["per_layer"], ids=lambda e: e["name"])
def test_names_units_and_lines(entry):
    assert NAME.match(entry["name"])
    for k in ("config", "traffic"):
        if k in entry:
            assert NAME.match(entry[k])
    for k in ("why", "layer", "source"):
        if k in entry:
            assert LINE.match(entry[k])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for k in entry.get("reduced", []):
        assert NAME.match(k)


def test_unique_names_and_the_keys_of_each_entry():
    names = [e["name"] for part in ("configs", "workloads", "end_to_end", "per_layer")
             for e in MAN[part]]
    assert len(names) == len(set(names))
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and os.path.isfile(ROOT / c["file"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in MAN["end_to_end"]}


def test_four_chip_cells_are_few():
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda w: w["name"])
def test_each_cell_is_found_by_name(cell):
    spec = json.loads((HERE / "workloads" / f"{cell['name']}.json").read_text())
    assert (spec["config"], spec["traffic"], spec["chips"]) == (cell["config"], cell["traffic"],
                                                                cell["chips"])
    assert (HERE / "configs" / f"{spec['config']}.json").is_file()
    traffic = json.loads((HERE / "traffic" / f"{spec['traffic']}.json").read_text())
    assert (HERE / "runners" / f"{traffic['runner']}.py").is_file()
    assert spec["limits"]
    e2e, layer = cell_metrics(MAN, cell["name"])
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer
    for m in layer:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in names
