"""Inverse-CDF sampling on the card: ``csrc/sample_pdf.cu``.

:func:`sample_pdf_cuda` is ``ops/volume.py::sample_pdf_plain`` (the plain
PyTorch body, its oracle) as one kernel launch: a warp a ray, the ray's
PMF row in registers, its CDF and midpoints in shared memory, two draws
a lane.  It replaces no TPU kernel (the JAX package's ``sample_pdf`` in
``mc_nerf_tpu/ops/volume.py`` is plain ``jnp``): the plain body's
[R, K, S-1] masks, ``where`` and reductions took ~100 ms of a 240 ms
800x800 frame on an H100 (PERF.md), where the call's own bytes take
~0.2 ms at 3.35 TB/s.

The kernel sums and scans each PMF row in its own order, so its CDF may
differ from the plain body's in the last bits.  A draw in a bin that holds
little mass magnifies that in depth (by the bin's width over its mass), so
the kernel is held to its oracle by :func:`draw_gap`: a draw may stray by
its depth's rounding or by its CDF's, not by more.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch


def _lib():
    from mc_nerf_torch.ops.cuda import _build

    lib = _build.load("sample_pdf")
    lib.mcn_sample_pdf.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] +
                                   [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 +
                                   [ctypes.c_float, ctypes.c_void_p])
    lib.mcn_sample_pdf.restype = ctypes.c_int
    lib.mcn_sample_pdf_max_bins.restype = ctypes.c_int
    return lib


def max_bins() -> int:
    """The most bins (S - 1) a row may have on the kernel
    (``mcn_sample_pdf_max_bins``); builds the kernels at first use."""
    return _lib().mcn_sample_pdf_max_bins()


def _launch(z, w, u, out, eps: float) -> None:
    rays, s = w.shape
    stream = torch.cuda.current_stream(w.device).cuda_stream
    err = _lib().mcn_sample_pdf(z.data_ptr(), z.stride(0), w.data_ptr(),
                                None if u is None else u.data_ptr(), out.data_ptr(),
                                rays, s, out.shape[1], eps, stream)
    if err:
        raise RuntimeError(f"sample_pdf kernel launch failed: CUDA error {err}")
    sample_pdf_cuda.launches += 1


def check_args(z: torch.Tensor, weights: torch.Tensor, n_samples: int,
               uniforms: Optional[torch.Tensor]) -> None:
    """Raise ValueError unless the kernel takes these inputs: ``weights``
    a contiguous float32 [R, S], ``z`` float32 [R, S] with contiguous
    rows (any row stride, 0 included), ``uniforms`` None or a contiguous
    float32 [R, K], no input that needs a gradient (none flows through the
    kernel), all on one CUDA device, 2 <= S - 1 <= :func:`max_bins`."""
    if weights.dim() != 2 or z.dim() != 2:
        raise ValueError("sample_pdf_cuda: z and weights must be [R, S]")
    if z.shape != weights.shape:
        raise ValueError(f"sample_pdf_cuda: z {tuple(z.shape)} and weights "
                         f"{tuple(weights.shape)} differ")
    ins = (("z", z), ("weights", weights), ("uniforms", uniforms))
    for name, t in ins:
        if t is not None and t.dtype != torch.float32:
            raise ValueError(f"sample_pdf_cuda: {name} must be float32, not {t.dtype}")
    if not weights.is_contiguous():
        raise ValueError("sample_pdf_cuda: weights must be contiguous")
    if z.stride(1) != 1 or z.stride(0) < 0:
        raise ValueError("sample_pdf_cuda: z's rows must be contiguous")
    if uniforms is not None and (tuple(uniforms.shape) != (weights.shape[0], n_samples)
                                 or not uniforms.is_contiguous()):
        raise ValueError(f"sample_pdf_cuda: uniforms must be a contiguous "
                         f"[{weights.shape[0]}, {n_samples}]")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for _, t in ins):
        raise ValueError("sample_pdf_cuda: an input requires grad, and no gradient flows "
                         "through the kernel: detach it, or draw under torch.no_grad()")
    if n_samples < 1:
        raise ValueError("sample_pdf_cuda: n_samples must be 1 or more")
    if weights.device.type != "cuda" or any(
            t is not None and t.device != weights.device for t in (z, uniforms)):
        raise ValueError(f"sample_pdf_cuda: unsupported device {weights.device}: the "
                         "inputs must share one CUDA device")
    if not 2 <= weights.shape[1] - 1 <= max_bins():
        raise ValueError(f"sample_pdf_cuda: {weights.shape[1] - 1} bins, the kernel takes "
                         f"2 to {max_bins()}")


def sample_pdf_cuda(z: torch.Tensor, weights: torch.Tensor, n_samples: int,
                    uniforms: Optional[torch.Tensor] = None,
                    eps: float = 1e-5) -> torch.Tensor:
    """``sample_pdf_plain(z, weights, n_samples, uniforms, eps=eps)`` as
    one launch on the current stream (no synchronisation): [R, K] depths,
    allocated here.  Inputs as :func:`check_args` says, which raises on
    any other; a refused launch raises."""
    check_args(z, weights, n_samples, uniforms)
    out = torch.empty((weights.shape[0], n_samples), dtype=torch.float32,
                      device=weights.device)
    _launch(z, weights, uniforms, out, eps)
    return out


sample_pdf_cuda.launches = 0


def draw_gap(depths: torch.Tensor, ref: torch.Tensor, z: torch.Tensor,
             weights: torch.Tensor, eps: float = 1e-5, depth_tol: float = 2e-5,
             cdf_tol: float = 4e-6) -> float:
    """How far the draws ``depths`` stray from ``ref`` (the plain body's
    for the same call), over what rounding explains: the largest, over the
    draws, of the smaller of |depth gap| / ``depth_tol`` and |F gap| /
    ``cdf_tol``, 1 or less where every draw is within rounding of its
    oracle.  F is the plain body's piecewise-linear CDF of the row
    (``weights[1:-1] + eps`` normalised, its running sum at the midpoints
    of ``z``; past the last midpoint the plain body's 1e10 bracket, a unit
    slope), in float64.  Two sums of the PMF in other orders move a draw
    in a bin of little mass far in depth (its width over its mass times
    the CDF's last bits) but not in F; a depth's own rounding in a bin of
    much mass moves F (its mass over its width times the depth's last
    bits) but not the depth.  A draw of another u, or one a bin late,
    moves both.  ``z`` [R, S] sorted, ``depths`` and ``ref`` [R, K]; a
    NaN in both counts 0, in one of them without end.  The default
    tolerances: ~20 of a depth's last bits at 8; ~7x the largest CDF
    difference that the kernel's order of sums left against a
    left-to-right one on two-surface rows of 5 to 128 PMF values."""
    z, w = z.double(), weights.double()
    mids = (0.5 * (z[:, 1:] + z[:, :-1])).contiguous()          # [R, S-1]
    pmf = w[:, 1:-1] + eps
    cdf = torch.cat([torch.zeros_like(pmf[:, :1]),
                     torch.cumsum(pmf / pmf.sum(-1, keepdim=True), -1)], -1)
    last = mids.shape[1] - 1

    def at(d):
        d = d.double().contiguous()
        j = torch.searchsorted(mids, d, right=True)              # midpoints <= d
        lo, hi = (j - 1).clamp(0, last), j.clamp(max=last)
        z_lo, z_hi = mids.gather(1, lo), mids.gather(1, hi)
        c_lo, c_hi = cdf.gather(1, lo), cdf.gather(1, hi)
        width = z_hi - z_lo
        t = torch.where(width > 0, (d - z_lo) / torch.where(width > 0, width, 1.0), 0.0)
        inside = c_lo + t.clamp(0.0, 1.0) * (c_hi - c_lo)
        return torch.where(j > last, cdf[:, -1:] + (d - mids[:, -1:]), inside)

    over = torch.minimum((depths.double() - ref.double()).abs() / depth_tol,
                         (at(depths) - at(ref)).abs() / cdf_tol)
    both_nan = torch.isnan(depths) & torch.isnan(ref)
    over = torch.where(both_nan, 0.0, torch.where(torch.isnan(over), float("inf"), over))
    return float(over.max()) if over.numel() else 0.0
