"""MC-NeRF in PyTorch for NVIDIA Hopper: the port of ``mc_nerf_tpu``.

Module paths and function names mirror the JAX package, so each function
here has its counterpart at the same path there.  The hot kernels are
hand-written CUDA under ``csrc/``, built at first use
(``ops/cuda/_build.py``); each has a plain PyTorch version beside it that
runs for CPU tensors.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises when CUDA is asked for (or defaulted to) and absent —
    the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def compute_dtype(name: str) -> torch.dtype:
    """``Config.compute_dtype`` string -> torch dtype."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]
