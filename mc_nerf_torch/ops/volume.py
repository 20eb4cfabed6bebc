"""Volume-rendering math (counterpart of ``mc_nerf_tpu/ops/volume.py``).

Semantics from the reference (``model/mc_nerf.py:682-736``): alpha =
1 - exp(-softplus(sigma + noise) * delta); the rgb composite uses those
(optionally noisy) weights; depth/opacity use the noise-free
transmittance.  The grid fine mode's bin selection is the JAX package's
static-shape top-k (``select_fine_bins``, ``expand_bins_to_samples``).
Random draws come in as tensors (``noise``, ``uniforms``) or from an
explicit ``torch.Generator``, so the same draws can be handed to the JAX
package in tests.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from mc_nerf_torch.ops.cuda.sample_pdf import sample_pdf_cuda
from mc_nerf_torch.utils import trace


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


def select_fine_bins(weights_coarse: torch.Tensor, k: int, weight_thresh: float,
                     batch_max: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Static-shape replacement for the reference's fine-bin selection
    (mc_nerf.py:623-632; the JAX package's ``select_fine_bins``): keep the
    FIRST k bins per ray in z order whose weight is at least
    ``min(weight_thresh, max over the whole [R, S] batch)``.  ``batch_max``
    (a 0-d tensor) stands for that max where the batch is wider than
    ``weights_coarse``: a data-parallel step passes the max over every
    rank's rays, which is what the JAX package's max means on its mesh.

    The cutoff stays on the device (no host sync).  Each kept bin's slot is
    the count of kept bins before it (a cumsum); one scatter writes the bin
    indices into their slots, and every bin past the k-th goes to a spare
    slot that is dropped.  Slots past a ray's count are invalid and hold
    ``S - 1`` (safe to gather).

    Args:
      weights_coarse: [R, S] coarse compositing weights (no gradient).
      k: static per-ray bin budget.
      weight_thresh: the yaml ``weight_thresh`` (1e-3).
      batch_max: the batch's max weight; None: ``weights_coarse.max()``.

    Returns:
      (bin_idx [R, k] int64 ascending per ray, valid [R, k] bool).
    """
    r, num_bins = weights_coarse.shape
    cutoff = torch.clamp(weights_coarse.max() if batch_max is None else batch_max,
                         max=weight_thresh)
    mask = weights_coarse >= cutoff                                 # [R, S]
    pos = torch.cumsum(mask.to(torch.int64), dim=-1) - 1            # slot per kept bin
    slot = torch.where(mask & (pos < k), pos, torch.full_like(pos, k))
    bins = torch.arange(num_bins, device=weights_coarse.device).expand(r, num_bins)
    bin_idx = torch.full((r, k + 1), num_bins - 1, dtype=torch.int64,
                         device=weights_coarse.device).scatter_(1, slot, bins)[:, :k]
    valid = torch.arange(k, device=weights_coarse.device)[None, :] < mask.sum(-1, keepdim=True)
    return bin_idx, valid


def expand_bins_to_samples(bin_idx: torch.Tensor, valid: torch.Tensor,
                           sample_scale: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each selected coarse bin b owns fine-grid slots [b * scale,
    (b + 1) * scale) (the reference's index arithmetic, mc_nerf.py:628).
    [R, k] -> (sample_idx [R, k * scale], sample_valid [R, k * scale])."""
    offsets = torch.arange(sample_scale, dtype=bin_idx.dtype, device=bin_idx.device)
    sample_idx = bin_idx[..., None] * sample_scale + offsets        # [R, k, scale]
    sample_valid = valid[..., None].expand(sample_idx.shape)
    flat = (*sample_idx.shape[:-2], sample_idx.shape[-2] * sample_scale)
    return sample_idx.reshape(flat), sample_valid.reshape(flat)


def sample_pdf(
    z_vals: torch.Tensor,
    weights: torch.Tensor,
    n_samples: int,
    uniforms: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Inverse-CDF importance sampling of depths from coarse weights:
    :func:`sample_pdf_plain`'s contract, and its values within rounding.

    On CUDA tensors one launch of ``ops/cuda/sample_pdf.py::sample_pdf_cuda``
    computes it (its ``check_args`` raises on inputs the kernel does not
    take: the card has no other route); on the CPU :func:`sample_pdf_plain`
    does.  Each call adds one to the tracer's counter ``sample_pdf.kernel``
    or ``sample_pdf.plain`` (``utils/trace.py``; under a CUDA graph, one a
    capture)."""
    if weights.is_cuda:
        if uniforms is None and generator is not None:
            uniforms = _draw_uniforms(generator, (weights.shape[0], n_samples), z_vals.device)
        # a row-broadcast z (the eval's probe ladder, row stride 0) stays a view
        out = sample_pdf_cuda(z_vals if z_vals.stride(-1) == 1 else z_vals.contiguous(),
                              weights.contiguous(), n_samples,
                              None if uniforms is None else uniforms.contiguous(), eps)
        trace.count("sample_pdf.kernel")
        return out
    trace.count("sample_pdf.plain")
    return sample_pdf_plain(z_vals, weights, n_samples, uniforms, generator, eps)


def _draw_uniforms(generator: torch.Generator, shape, device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, dtype=torch.float32,
                      device=generator.device).to(device)


def sample_pdf_plain(
    z_vals: torch.Tensor,
    weights: torch.Tensor,
    n_samples: int,
    uniforms: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Inverse-CDF importance sampling of depths from coarse weights, in
    plain PyTorch: the CPU route and the kernel's oracle.

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
        uniforms = _draw_uniforms(generator, shape, z_vals.device)
    if uniforms is None:
        u = ((strata + 0.5) / n_samples).expand(shape)
    else:
        u = (strata + uniforms) / n_samples
    u = torch.clamp(u, max=1.0 - 1e-6)

    # bracketing values as masked max/min over the monotone cdf/mids —
    # the JAX package's formulation, kept for bitwise agreement with it
    # (a Python constant, not a tensor made on the host: copying one to the
    # card each call would wait for it)
    mask = cdf[..., None, :] <= u[..., None]                     # [R, K, S-1]
    big = 1e10
    cdf_lo = torch.where(mask, cdf[..., None, :], -big).amax(-1)
    z_lo = torch.where(mask, mids[..., None, :], -big).amax(-1)
    cdf_hi = torch.where(mask, big, cdf[..., None, :]).amin(-1)
    z_hi = torch.where(mask, big, mids[..., None, :]).amin(-1)
    denom = torch.where(cdf_hi - cdf_lo < 1e-8, torch.ones_like(cdf_lo),
                        cdf_hi - cdf_lo)
    t = (u - cdf_lo) / denom
    return z_lo + t * (z_hi - z_lo)
