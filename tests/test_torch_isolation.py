"""The PyTorch port stands alone: no JAX, nothing of the JAX package, and
no silent fall back to the CPU."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "mc_nerf_tpu")

_IMPORT_ALL = f"""
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {BLOCKED!r}:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import mc_nerf_torch
names = [m.name for m in pkgutil.walk_packages(mc_nerf_torch.__path__, "mc_nerf_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert not any(m.split(".")[0] in {BLOCKED!r} for m in sys.modules)
print(len(names))
"""


def test_every_module_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 15


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_name_no_jax_import():
    files = [ROOT / "chip_smoke.py", *sorted((ROOT / "mc_nerf_torch").rglob("*.py"))]
    assert len(files) > 15
    for f in files:
        bad = set(_imported_roots(f)) & set(BLOCKED)
        assert not bad, f"{f.relative_to(ROOT)} imports {bad}"


def test_entry_points_without_device_raise_when_cuda_is_absent(monkeypatch):
    from mc_nerf_torch.config import Config, NerfConfig
    from mc_nerf_torch.data.blender import SplitData
    from mc_nerf_torch.models.nerf import init_nerf_params
    from mc_nerf_torch.train.engine import Engine, demo
    from mc_nerf_torch.train.steps import make_render_fn

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    nc = NerfConfig(coarse_width=16, fine_width=16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_nerf_params(nc)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_render_fn(Config(), 8, 8)
    params = init_nerf_params(nc, device="cpu")
    split = SplitData(np.zeros((1, 8, 8, 3), np.uint8), np.zeros((1, 3, 4), np.float32),
                      np.eye(3, dtype=np.float32)[None], np.ones(1, np.float32), 8, 8, ["a"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        demo(params, split, Config(nerf=nc))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(Config())
