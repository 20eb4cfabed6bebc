"""Nothing of the benchmark imports JAX, Flax or the JAX package, compared
by whole top-level name (the port's name begins with the JAX package's),
and the plain reference imports nothing of the port."""

import ast
import sys
from pathlib import Path

import pytest

from portbench import run

PB = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "mc_nerf_tpu"}


def imported(path: Path):
    """Top-level names of every module a file imports, relative imports
    resolved to the benchmark."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield "portbench" if node.level else (node.module or "").split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


FILES = sorted(PB.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(PB)))
def test_no_jax(path):
    assert not FORBIDDEN & set(imported(path))


@pytest.mark.parametrize("path", sorted((PB / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    names = set(imported(path))
    assert "mc_nerf_torch" not in names
    assert names <= {"__future__", "math", "typing", "numpy", "torch", "portbench"}
    text = path.read_text()
    assert "portbench.program" not in text and "portbench.runners" not in text


def test_only_the_program_module_and_the_runners_import_the_port():
    users = {p.relative_to(PB).as_posix() for p in FILES if "mc_nerf_torch" in set(imported(p))}
    assert users <= {"program.py", "run.py", "tests/test_portbench_reference.py",
                     "tests/test_portbench_stats.py", "tests/test_portbench_faults.py"}


def test_the_run_refuses_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "mc_nerf_tpu.models", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    monkeypatch.setitem(sys.modules, "jax_like_but_not", object())
    found = run.forbidden_modules()
    assert "mc_nerf_tpu.models" in found and "jaxlib" in found
    assert "jax_like_but_not" not in found
    assert not any(m.split(".")[0] == "mc_nerf_torch" for m in found)
    assert run.report({"checks": {}}) == 3
