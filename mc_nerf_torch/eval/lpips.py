"""LPIPS with the AlexNet backbone (counterpart of ``mc_nerf_tpu/eval/lpips_jax.py``).

The metric the reference computes through the ``lpips`` pip package
(``main.py:238-241``): AlexNet's conv features at 5 taps after a
per-channel input scaling, each tap unit-normalized over its channels,
weighted per channel by the learned linear weights, averaged over space
and summed over the taps.

The weights are not in the repository.  They are looked for, in order, at
the ``weights_path`` argument, at ``$MC_NERF_LPIPS_WEIGHTS`` and at
``weights/lpips_alex.npz`` under the current directory; without a file
:func:`load_default` returns None and callers report LPIPS as unavailable.
The file is the JAX package's ``.npz``: ``conv{1..5}_w`` [kh, kw, cin,
cout] (HWIO), ``conv{1..5}_b`` [cout], ``lin{0..4}`` [c], ``shift`` [3],
``scale`` [3] (its ``convert_torch_lpips`` writes one from an ``lpips``
state dict).

The convolutions run in fp32 with TF32 off: cuDNN's default TF32 would
move the score by ~1e-3 relative on the card.
"""

from __future__ import annotations

import contextlib
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

ENV_VAR = "MC_NERF_LPIPS_WEIGHTS"
DEFAULT_PATH = "weights/lpips_alex.npz"

# AlexNet's features (torchvision's layout): (stride, padding) of each conv
_CONV_SPECS = ((4, 2), (1, 2), (1, 1), (1, 1), (1, 1))
_POOL_AFTER = (0, 1)   # a 3x3 stride-2 max-pool after the first two taps


class LpipsModel(NamedTuple):
    conv_w: Tuple[torch.Tensor, ...]    # [cout, cin, kh, kw] (OIHW), fp32
    conv_b: Tuple[torch.Tensor, ...]    # [cout]
    lin: Tuple[torch.Tensor, ...]       # [c]
    shift: torch.Tensor                 # [3]
    scale: torch.Tensor                 # [3]


def weights_file(weights_path: Optional[str] = None) -> Optional[str]:
    """The weights file to use: the argument, ``$MC_NERF_LPIPS_WEIGHTS``,
    then ``weights/lpips_alex.npz``, the first that exists; None if none."""
    for cand in (weights_path, os.environ.get(ENV_VAR), DEFAULT_PATH):
        if cand and os.path.exists(cand):
            return cand
    return None


def load(path: str, device=None) -> LpipsModel:
    """The model in ``path`` (the ``.npz`` format above) on ``device``
    (the CPU unless named)."""
    z = np.load(path)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return LpipsModel(
        conv_w=tuple(t(z[f"conv{i + 1}_w"]).permute(3, 2, 0, 1).contiguous() for i in range(5)),
        conv_b=tuple(t(z[f"conv{i + 1}_b"]) for i in range(5)),
        lin=tuple(t(z[f"lin{i}"]) for i in range(5)),
        shift=t(z["shift"]),
        scale=t(z["scale"]),
    )


def load_default(weights_path: Optional[str] = None, device=None) -> Optional[LpipsModel]:
    """:func:`load` of :func:`weights_file`, or None without a file."""
    path = weights_file(weights_path)
    return None if path is None else load(path, device)


@contextlib.contextmanager
def _no_tf32():
    """cuDNN convolutions in full fp32 inside the block."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _alexnet_taps(model: LpipsModel, x: torch.Tensor):
    """x: [1, 3, H, W] in [-1, 1] -> the 5 ReLU feature maps [1, c, h, w]."""
    x = (x - model.shift.view(1, 3, 1, 1)) / model.scale.view(1, 3, 1, 1)
    taps = []
    for i, (stride, pad) in enumerate(_CONV_SPECS):
        x = F.relu(F.conv2d(x, model.conv_w[i], model.conv_b[i], stride=stride, padding=pad))
        taps.append(x)
        if i in _POOL_AFTER:
            x = F.max_pool2d(x, 3, 2)
    return taps


@torch.no_grad()
def lpips_distance(model: LpipsModel, pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """LPIPS between two [H, W, 3] images in [0, 1] (tensors on the
    model's device), as a 0-d fp32 tensor."""
    def nchw(img):
        return img.float().permute(2, 0, 1)[None] * 2.0 - 1.0

    with _no_tf32():
        taps_p, taps_g = _alexnet_taps(model, nchw(pred)), _alexnet_taps(model, nchw(gt))
    total = torch.zeros((), dtype=torch.float32, device=pred.device)
    for tp, tg, lin in zip(taps_p, taps_g, model.lin):
        tp = tp / (tp.norm(dim=1, keepdim=True) + 1e-10)
        tg = tg / (tg.norm(dim=1, keepdim=True) + 1e-10)
        total = total + torch.mean(torch.sum((tp - tg) ** 2 * lin.view(1, -1, 1, 1), dim=1))
    return total
