"""The port's config loader and CLI flags against the JAX package's, and
its yaml reader against ``yaml.safe_load``.

``load_yaml`` is held field by field over every sub-config the port has
on three texts: the reference-schema yaml of ``tests/test_config.py``,
its extension-keys yaml without the keys of the coarse-free modes, the
density PMF and the bitpacked map, and the verify recipe's tiny yaml; then
on the extension yaml as written, and on each of those keys alone.  All
comparisons are exact.
"""

import ast
import dataclasses
import logging
import pathlib
import re

import pytest
import yaml

from mc_nerf_tpu import config as j_config

from mc_nerf_torch import config as t_config
from mc_nerf_torch.yaml_subset import loads

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_TESTS = (ROOT / "tests" / "test_config.py").read_text()
REF_YAML = next(node.value.value for node in ast.parse(JAX_TESTS).body
                if isinstance(node, ast.Assign) and node.targets[0].id == "REF_YAML")


def _extension_yaml() -> str:
    """The extension-keys yaml of ``tests/test_config.py``, as written there."""
    return re.search(r'def test_extension_keys_loadable.*?p\.write_text\(\s*"""(.*?)"""',
                     JAX_TESTS, re.S).group(1)


SAMPLING_KEYS = ("coarse_free", "occ_pmf", "coarse_free_from_stage", "occ_refresh_source",
                 "cf_uniform_samples", "allow_measured_harmful")


def _ported_extension_yaml() -> str:
    """The extension-keys yaml without the keys of the sampling modes
    (coarse-free, the density PMF)."""
    return "\n".join(line for line in _extension_yaml().splitlines()
                     if line.strip().split(":")[0] not in SAMPLING_KEYS)


def _verify_yaml() -> str:
    text = (ROOT / ".claude" / "skills" / "verify" / "SKILL.md").read_text()
    return text.split("```yaml")[1].split("```")[0]


TEXTS = {"reference": REF_YAML, "extension": _ported_extension_yaml(), "verify": _verify_yaml()}


def _write(tmp_path, text):
    p = tmp_path / "config.yaml"
    p.write_text(text)
    return str(p)


# the port's fields that the JAX config has no counterpart of, by class:
# the hash-grid field's keys
PORT_ONLY = {"NerfConfig": {"field", "hash_levels", "hash_log2_size", "hash_base_res",
                            "hash_max_res", "ngp_width", "ngp_density_hidden",
                            "ngp_geo_features", "ngp_color_hidden", "ngp_dir_degree"}}


def _assert_same_config(t_cfg, j_cfg):
    """Every field of the port's config equal to the JAX config's, value and
    type; a field of ``PORT_ONLY`` absent from the JAX config and at its
    default."""
    def same(t, j, where):
        if dataclasses.is_dataclass(t):
            for f in dataclasses.fields(t):
                if f.name in PORT_ONLY.get(type(t).__name__, ()):
                    assert not hasattr(j, f.name), (where, f.name)
                    assert getattr(t, f.name) == f.default, (where, f.name)
                    continue
                same(getattr(t, f.name), getattr(j, f.name), f"{where}.{f.name}")
        else:
            assert type(t) is type(j) and t == j, (where, t, j)

    same(t_cfg, j_cfg, "cfg")


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_load_yaml_matches_jax(tmp_path, name):
    path = _write(tmp_path, TEXTS[name])
    _assert_same_config(t_config.load_yaml(path), j_config.load_yaml(path))


def test_the_extension_yaml_as_written_is_refused(tmp_path):
    """The extension yaml as written, the sampling-mode keys included,
    loads as the JAX loader loads it (the name stays from when those keys
    were refused)."""
    path = _write(tmp_path, _extension_yaml())
    cfg = t_config.load_yaml(path)
    _assert_same_config(cfg, j_config.load_yaml(path))
    assert cfg.nerf.coarse_free and cfg.nerf.occ_pmf == "density"
    assert cfg.eval_coarse_free is False


@pytest.mark.parametrize("section,key,value", [
    ("model:\n    nerf", "coarse_free", "True"),
    ("model:\n    nerf", "coarse_free_from_stage", "2"),
    ("model:\n    nerf", "occ_pmf", "'density'"),
    ("model:\n    nerf", "occ_refresh_source", "fine"),
    ("model:\n    nerf", "cf_uniform_samples", "4"),
    ("model:\n    nerf", "allow_measured_harmful", "true"),
    ("system:\n    test_params", "coarse_free", "False"),
    ("model:\n    nerf", "occ_map_dtype", "bitpack"),
])
def test_each_unported_key_is_refused(tmp_path, section, key, value):
    """Each key of the sampling modes once refused now loads as the JAX
    loader loads it, away from its default (the name stays)."""
    path = _write(tmp_path, f"{section}:\n        {key}: {value}\n")
    cfg = t_config.load_yaml(path)
    _assert_same_config(cfg, j_config.load_yaml(path))
    where = cfg.eval if section.startswith("system") else cfg.nerf
    assert getattr(where, key) != getattr(type(where)(), key)


def test_unported_keys_at_their_defaults_load(tmp_path):
    text = ("model:\n  nerf:\n    coarse_free: False\n    occ_pmf: binary\n"
            "    coarse_free_from_stage: 1\n    occ_refresh_source: auto\n"
            "    cf_uniform_samples: 0\n    allow_measured_harmful: false\n"
            "    occ_map_dtype: int8\nsystem:\n  test_params:\n    coarse_free: ~\n")
    path = _write(tmp_path, text)
    _assert_same_config(t_config.load_yaml(path), j_config.load_yaml(path))


def test_xla_keys_are_logged_not_applied(tmp_path, caplog):
    path = _write(tmp_path, "system:\n  train_params:\n    max_steps_per_program: 100\n"
                            "    prng_impl: rbg\n    batch: 64\n")
    with caplog.at_level(logging.WARNING):
        cfg = t_config.load_yaml(path)
    assert cfg.train.rays_per_batch == 64
    logged = [r.getMessage() for r in caplog.records]
    assert sum("max_steps_per_program" in m for m in logged) == 1
    assert sum("prng_impl" in m for m in logged) == 1


# --------------------------------------------------------------- the reader

EDGE_CASES = {
    "comments": "# head\na: 1  # trailing\nb: 'x # kept'  # gone\n#c: 3\n",
    "quoted and plain strings": "a: 'single'\nb: \"double\\tq\"\nc: plain words\n"
                                "d: 'it''s'\ne: don't\nf: \"\"\n",
    "booleans": "a: True\nb: true\nc: FALSE\nd: yes\ne: off\nf: On\n",
    "exponents": "a: 1e-4\nb: 1.0e-4\nc: 1.0e4\nd: 1.5E+3\ne: -2.\nf: .5\n",
    "integers": "a: 010\nb: 0x1F\nc: -0b101\nd: 1_000\ne: +7\nf: -0\n",
    "nulls and specials": "a: null\nb: ~\nc:\nd: .inf\ne: -.Inf\n",
    "nested flow maps": "a: {b: 1, c: [2, 4], d: {e: [x, 'y z', {f: null}]}}\n"
                        "g: []\nh: {}\ni: [1, 2,]\n",
    "nested blocks": "a:\n  b:\n      c: 1\n      d: [1]\n  e: 2\nf: 3\n",
    "indented document": "   a: 1\n   b:\n     c: 2\n",
    "empty file": "",
    "comments only": "# nothing\n\n   # here\n",
    "quoted keys": "'a b': 1\n\"c\": {'d e': 2}\n",
}


@pytest.mark.parametrize("name", sorted(EDGE_CASES) + sorted(f"config {k}" for k in TEXTS))
def test_reader_matches_safe_load(name):
    text = TEXTS[name[7:]] if name.startswith("config ") else EDGE_CASES[name]
    got, want = loads(text), yaml.safe_load(text)
    assert got == want

    def types(x):
        if isinstance(x, dict):
            return {k: types(v) for k, v in x.items()}
        if isinstance(x, list):
            return [types(v) for v in x]
        return type(x).__name__

    assert types(got) == types(want)


@pytest.mark.parametrize("text,line", [
    ("a: &anchor 1\n", 1),
    ("a: 1\nb: *alias\n", 2),
    ("a: !!float 1\n", 1),
    ("a: 1\nb: |\n  text\n", 2),
    ("a:\n  - 1\n  - 2\n", 2),
    ("a: first\n  continued\n", 2),
    ("a: 2024-01-02\n", 1),
    ("a: 1:30\n", 1),
    ("---\na: 1\n", 1),
    ("a: [1,\n    2]\n", 1),
    ("a: b: c\n", 1),
    ("a: 1\n  b: 2\n", 2),
    ("a:\n\tb: 1\n", 2),
])
def test_reader_refuses_other_constructs_with_the_line(text, line):
    with pytest.raises(ValueError, match=f"line {line}:"):
        loads(text)


# ------------------------------------------------------------- the CLI flags

def _actions(parser):
    return [(a.dest, a.option_strings, a.default, a.type, a.help, type(a).__name__)
            for a in parser._actions]


def test_argparser_matches_jax():
    t_p, j_p = t_config.build_argparser(), j_config.build_argparser()
    assert _actions(t_p) == _actions(j_p)
    assert len([a for a in t_p._actions if a.dest != "help"]) == 8


@pytest.mark.parametrize("argv", [
    ["--train", "--root_data", "/d", "--data_name", "Ball_Lego", "--log"],
    ["--demo", "--tensorboard", "--start_device", "3"],
    ["--train", "--demo"],
    [],
])
@pytest.mark.parametrize("with_yaml", [True, False])
def test_from_args_matches_jax(tmp_path, argv, with_yaml):
    if with_yaml:
        _write(tmp_path, REF_YAML)
    argv = ["--config", str(tmp_path), *argv]
    t_cfg = t_config.from_args(t_config.build_argparser().parse_args(argv))
    j_cfg = j_config.from_args(j_config.build_argparser().parse_args(argv))
    _assert_same_config(t_cfg, j_cfg)
    assert t_cfg.train.rays_per_batch == (1234 if with_yaml else 7000)
