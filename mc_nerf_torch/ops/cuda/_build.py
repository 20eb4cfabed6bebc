"""Build and load the hand-written CUDA kernels under ``mc_nerf_torch/csrc``.

Each ``csrc/*.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``) into its
own shared library with a plain C interface, loaded with ``ctypes``.  All
sources build in parallel (one ``nvcc`` each, started together) at first
use, into ``build/mc_nerf_torch/<hash>/`` at the repository root, keyed by a
hash of every source and header and of the flags, so an edited kernel
rebuilds and an unchanged one loads as is.  Nothing here runs at import
time: a machine with no ``nvcc`` imports the package and runs the plain
versions on CPU tensors.  The counter ``kernels.built`` counts the
libraries ``nvcc`` compiled in this process (``utils/trace.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

from mc_nerf_torch.utils import trace

_PKG = Path(__file__).resolve().parents[2]          # .../mc_nerf_torch
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "mc_nerf_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_libs: Dict[str, ctypes.CDLL] = {}   # process-wide cache of loaded libraries


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc",
    ]:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every ``csrc/*.cu`` that has no library in the build
    directory yet, all at once; raise with the compiler's output on
    failure.  Returns the build directory."""
    out = _build_dir()
    todo = [cu for cu in sorted(CSRC.glob("*.cu"))
            if not (out / f"lib{cu.stem}.so").exists()]
    if not todo:
        return out
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for cu in todo:
        tmp = out / f"lib{cu.stem}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC),
               "-o", str(tmp), str(cu)]
        procs.append((cu, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for cu, tmp, proc in procs:
        log, _ = proc.communicate()
        (out / f"{cu.stem}.log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"--- nvcc {cu.name} (rc {proc.returncode}):\n{log}")
        else:
            tmp.replace(out / f"lib{cu.stem}.so")   # atomic publish
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    trace.count("kernels.built", len(todo))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building all first; the
    first load of each is the span ``kernels.load``."""
    if name not in _libs:
        with trace.span("kernels.load", library=name):
            _libs[name] = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
    return _libs[name]
