"""Sinusoidal positional encoding with the BARF coarse-to-fine gate.

Counterpart of ``mc_nerf_tpu/models/encoding.py``.  Channel layout matches
the reference (``model/net_block.py:6-35``): ``[x (3) | per-dim: sin(f0..fL-1),
cos(f0..fL-1)]``.  Only the natural ``[P, C]`` form is ported; the JAX
package's transposed ``[C, P]`` variants exist for the TPU's lane layout.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def barf_weights(n_freqs: int, step_r, barf_start: float,
                 barf_end: float) -> torch.Tensor:
    """Per-frequency BARF gate in [0, 1]: octave k ramps up with a
    half-cosine as ``alpha = (step_r - start)/(end - start) * L`` crosses
    [k, k+1] (ref ``net_block.py:27-29``).  Returns [L] float32."""
    step_r = torch.as_tensor(step_r, dtype=torch.float32)
    alpha = (step_r - barf_start) / (barf_end - barf_start) * n_freqs
    k = torch.arange(n_freqs, dtype=torch.float32, device=step_r.device)
    return (1.0 - torch.cos(torch.clamp(alpha - k, 0.0, 1.0) * math.pi)) / 2.0


def spectrum_octaves(x: torch.Tensor, n_freqs: int):
    """Lists of L tensors shaped like ``x``: sin and cos of ``x * 2^f``.

    The double-angle recurrence ``s' = 2sc, c' = 1 - 2s^2`` from one base
    sin/cos, exactly as the JAX package computes it — it differs from
    ``sin(2^f x)`` by up to ~5e-5 after 9 doublings, and parity with the
    JAX package depends on following the same recurrence.
    """
    sins = [torch.sin(x)]
    coss = [torch.cos(x)]
    for _ in range(n_freqs - 1):
        s, c = sins[-1], coss[-1]
        sins.append(2.0 * s * c)
        coss.append(1.0 - 2.0 * s * s)
    return sins, coss


def sincos_spectrum(x: torch.Tensor, n_freqs: int):
    """(sin, cos) of ``x * 2^f`` for f in [0, L), each [..., 3, L]."""
    sins, coss = spectrum_octaves(x, n_freqs)
    return torch.stack(sins, dim=-1), torch.stack(coss, dim=-1)


def sincos_encode(x: torch.Tensor, n_freqs: int,
                  freq_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[..., 3] -> [..., 3(2L+1)] features ``[x, sin/cos spectrum]``."""
    sin, cos = sincos_spectrum(x, n_freqs)               # [..., 3, L]
    if freq_weights is not None:
        w = freq_weights.to(x.dtype)
        sin = sin * w
        cos = cos * w
    enc = torch.stack([sin, cos], dim=-2)                 # [..., 3, 2, L]
    enc = enc.reshape(*x.shape[:-1], 6 * n_freqs)
    return torch.cat([x, enc], dim=-1)
