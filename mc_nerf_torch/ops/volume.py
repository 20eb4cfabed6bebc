"""Volume-rendering math (counterpart of ``mc_nerf_tpu/ops/volume.py``).

Semantics from the reference (``model/mc_nerf.py:682-736``): alpha =
1 - exp(-softplus(sigma + noise) * delta); the rgb composite uses those
(optionally noisy) weights; depth/opacity use the noise-free
transmittance.  Random draws come in as tensors (``noise``, ``uniforms``)
or from an explicit ``torch.Generator``, so the same draws can be handed
to the JAX package in tests.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F


def compute_deltas(z_vals: torch.Tensor, last_inf: bool = True,
                   max_delta: Optional[float] = None) -> torch.Tensor:
    """[..., S] sorted depths -> [..., S] inter-sample distances; the last
    is 1e10 (``last_inf``) or repeats the final spacing."""
    d = z_vals[..., 1:] - z_vals[..., :-1]
    if max_delta is not None:
        d = torch.clamp(d, max=max_delta)
    last = torch.full_like(d[..., :1], 1e10) if last_inf else d[..., -1:]
    return torch.cat([d, last], dim=-1)


def _exclusive_transmittance(sd: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros_like(sd[..., :1])
    return torch.exp(-torch.cumsum(torch.cat([zero, sd[..., :-1]], dim=-1), dim=-1))


def sigma_to_weights(deltas: torch.Tensor, sigma: torch.Tensor,
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Compositing weights from raw densities (ref ``sigma2weights``);
    ``noise`` is the training-time N(0, 1) draw added to sigma."""
    if noise is not None:
        sigma = sigma + noise
    sd = deltas * F.softplus(sigma)
    alpha = 1.0 - torch.exp(-sd)
    return alpha * _exclusive_transmittance(sd)


class CompositeResult(NamedTuple):
    rgb: torch.Tensor       # [..., 3]
    depth: torch.Tensor     # [..., 1]
    opacity: torch.Tensor   # [..., 1]
    weights: torch.Tensor   # [..., S] (the rgb-path weights, possibly noisy)


def composite(z_vals: torch.Tensor, sigma: torch.Tensor, rgb: torch.Tensor,
              noise: Optional[torch.Tensor] = None, white_back: bool = True,
              last_inf: bool = True,
              max_delta: Optional[float] = None) -> CompositeResult:
    """Alpha-composite per-sample density/colour into per-ray outputs
    (ref ``inference``, mc_nerf.py:705-727)."""
    deltas = compute_deltas(z_vals, last_inf=last_inf, max_delta=max_delta)
    sigma_delta = F.softplus(sigma) * deltas
    alpha = 1.0 - torch.exp(-sigma_delta)
    prob = _exclusive_transmittance(sigma_delta) * alpha
    opacity = torch.sum(prob, dim=-1, keepdim=True)
    depth = torch.sum(z_vals * prob, dim=-1, keepdim=True)
    weights = prob if noise is None else sigma_to_weights(deltas, sigma, noise)
    rgb_out = torch.sum(weights[..., None] * rgb, dim=-2)
    if white_back:
        rgb_out = rgb_out + (1.0 - torch.sum(weights, dim=-1, keepdim=True))
    return CompositeResult(rgb_out, depth, opacity, weights)


def sample_pdf(
    z_vals: torch.Tensor,
    weights: torch.Tensor,
    n_samples: int,
    uniforms: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Inverse-CDF importance sampling of depths from coarse weights.

    Args:
      z_vals: [R, S] sorted coarse depths.
      weights: [R, S] coarse weights (noise-free).
      n_samples: fine samples per ray K.
      uniforms: [R, K] U[0, 1) draws for stratified jitter, or None.
      generator: draws the uniforms when ``uniforms`` is None; with neither,
        the strata midpoints are used (the eval default).
      eps: PMF floor so background rays fall back to uniform sampling.

    Returns:
      [R, K] sorted depths.
    """
    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])            # [R, S-1]
    w = weights[..., 1:-1] + eps                                 # [R, S-2]
    pdf = w / torch.sum(w, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [R, S-1]

    shape = (*cdf.shape[:-1], n_samples)
    strata = torch.arange(n_samples, dtype=torch.float32, device=z_vals.device)
    if uniforms is None and generator is not None:
        uniforms = torch.rand(shape, generator=generator, dtype=torch.float32,
                              device=generator.device).to(z_vals.device)
    if uniforms is None:
        u = ((strata + 0.5) / n_samples).expand(shape)
    else:
        u = (strata + uniforms) / n_samples
    u = torch.clamp(u, max=1.0 - 1e-6)

    # bracketing values as masked max/min over the monotone cdf/mids —
    # the JAX package's formulation, kept for bitwise agreement with it
    mask = cdf[..., None, :] <= u[..., None]                     # [R, K, S-1]
    big = torch.tensor(1e10, dtype=torch.float32, device=z_vals.device)
    cdf_lo = torch.where(mask, cdf[..., None, :], -big).amax(-1)
    z_lo = torch.where(mask, mids[..., None, :], -big).amax(-1)
    cdf_hi = torch.where(mask, big, cdf[..., None, :]).amin(-1)
    z_hi = torch.where(mask, big, mids[..., None, :]).amin(-1)
    denom = torch.where(cdf_hi - cdf_lo < 1e-8, torch.ones_like(cdf_lo),
                        cdf_hi - cdf_lo)
    t = (u - cdf_lo) / denom
    return z_lo + t * (z_hi - z_lo)
