"""Fully-fused render forward: MLP + SH shading + alpha composite.

Counterpart of ``mc_nerf_tpu/ops/pallas/fused_render.py`` (forward).  The
kernel, ``csrc/fused_render.cu``, replaces the Pallas
``_render_fwd_kernel`` (``fused_render.py:211``, called through
``_render_fwd_call`` at ``:476`` and ``fused_render`` at ``:650``): blocks
of whole rays run the MLP of ``csrc/mlp_tile.cuh`` on their points, shade
them against a per-ray SH basis, and composite each ray in a warp with a
shuffle prefix scan.  Only per-ray results (and, optionally, the per-sample
selection weights) reach device memory.

Bound on an H100 SXM (989 TFLOP/s dense bf16): compute.  The eval fine
pass (8x256, 629,248 MAC per point needed) over a 16384 x 32 chunk is
>= 0.667 ms; see PERF.md for the measured time beside it.

Composite semantics are ``ops/volume.py``'s (ref ``inference``,
``model/mc_nerf.py:705-736``): rgb weights from softplus(sigma + noise),
depth/opacity from the noise-free transmittance, the white background
adds (1 - sum w), the last delta is 1e10.  The backward (training) comes
with the training slice.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from mc_nerf_torch.ops.cuda.fused_mlp import (
    BASIS_LANES,
    PackedMLP,
    _check_mlp_args,
    launch_args,
    mlp_plain,
)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # max(x, 0) + log(1 + exp(-|x|)): the kernels' form
    return torch.clamp(x, min=0.0) + torch.log(1.0 + torch.exp(-torch.abs(x)))


def _deltas_flat(z: torch.Tensor) -> torch.Tensor:
    """[rays, s] depths -> [rays*s, 1] deltas, last = 1e10."""
    d = torch.cat([z[:, 1:] - z[:, :-1],
                   torch.full((z.shape[0], 1), 1e10, dtype=z.dtype, device=z.device)],
                  dim=1)
    return d.reshape(-1, 1)


def fused_render_plain(packed, feat, basis16, z, noise, noise_sel, depth, skips,
                       s, nb, with_noise, emit_wsel, white_back=True):
    """The kernel's arithmetic in plain PyTorch (fp32 on bf16-rounded MLP
    operands).  Same contract as :func:`fused_render`."""
    rays = basis16.shape[0]
    out32 = mlp_plain(packed, feat, depth, skips).reshape(rays, s, -1)
    sigma = out32[..., 0]
    sh = out32[..., 1:1 + 3 * nb].reshape(rays, s, 3, nb)
    rgb = torch.sigmoid((sh * basis16[:, None, None, :nb]).sum(-1))   # [R, s, 3]
    d = _deltas_flat(z).reshape(rays, s)

    def weights(sig):
        sd = _softplus(sig) * d
        cum = torch.cumsum(torch.cat([torch.zeros_like(sd[:, :1]), sd[:, :-1]], 1), 1)
        return (1.0 - torch.exp(-sd)) * torch.exp(-cum)

    prob = weights(sigma)
    w = weights(sigma + noise) if with_noise else prob
    rgb_out = (w[..., None] * rgb).sum(1)
    if white_back:
        rgb_out = rgb_out + (1.0 - w.sum(1, keepdim=True))
    ray_out = torch.cat([rgb_out, (z * prob).sum(1, keepdim=True),
                         prob.sum(1, keepdim=True),
                         torch.zeros((rays, 3), dtype=torch.float32, device=z.device)], 1)
    if not emit_wsel:
        return ray_out, None
    return ray_out, (weights(sigma + noise_sel) if with_noise else prob)


# csrc/fused_render.cu's shared memory per block: the MLP tile of
# csrc/mlp_tile.cuh (mlp_smem_bytes) plus 16 bytes per staged sample, within
# the 227 KB a block may opt into on an H100
_SMEM_PER_BLOCK = 227 * 1024


def max_samples(packed: PackedMLP) -> int:
    """The most samples per ray the kernel takes with this pack (1,952 for
    the fine 8x256 pack at 10 octaves); shorter rays share a block."""
    enc, width = packed.trunk_w[0].shape
    head0 = packed.head_w0.shape[1]
    act_pitch = -(-enc // 16) * 16 + width + 8
    h1_pitch = min(head0, 256) + 8
    mlp_tile = 2 * (128 * act_pitch + 128 * h1_pitch + 2 * 32 * 256) + 4 * 128 * 33
    return (_SMEM_PER_BLOCK - mlp_tile) // 16


def _lib():
    from mc_nerf_torch.ops.cuda import _build

    fn = _build.load("fused_render").mcn_fused_render
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return fn


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def fused_render(
    packed: PackedMLP,
    feat: torch.Tensor,
    basis16: torch.Tensor,
    z: torch.Tensor,
    noise: Optional[torch.Tensor],
    noise_sel: Optional[torch.Tensor],
    depth: int,
    skips: Sequence[int],
    s: int,
    nb: int,
    with_noise: bool,
    emit_wsel: bool,
    white_back: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Fused render forward: encode-order feat -> per-ray outputs.

    Args:
      packed: full (sigma+SH) kernel weights.
      feat: [rays * s, 4+6L] encoded points, ray-major (bf16 on CUDA).
      basis16: [rays, 16] fp32 SH basis padded to 16 lanes.
      z: [rays, s] sorted fp32 sample depths.
      noise / noise_sel: [rays, s] fp32 N(0,1) draws (training) or None;
        read only when ``with_noise`` (and ``emit_wsel`` for noise_sel).
      s: samples per ray, >= 2 (and <= :func:`max_samples` on CUDA
        tensors); nb: (sh_deg+1)^2 <= 9.
      with_noise: noisy rgb weights with a separate noise-free
        depth/opacity path.  emit_wsel: also return the selection weights
        (from noise_sel under ``with_noise``, else the noise-free ones).

    Returns:
      (ray_out [rays, 8] fp32 — rgb(3), depth, opacity, 3 zeros;
       wsel [rays, s] fp32 or None).  CPU tensors take the plain version;
      CUDA tensors launch ``csrc/fused_render.cu``.
    """
    skips = tuple(skips)
    _check_mlp_args(packed, feat, depth, skips)
    rays = basis16.shape[0]
    if s < 2 or not 1 <= nb <= 9:
        raise ValueError(f"fused_render takes s >= 2 and 1 <= nb <= 9; got s={s}, nb={nb}")
    if feat.shape[0] != rays * s or tuple(z.shape) != (rays, s) \
            or tuple(basis16.shape) != (rays, BASIS_LANES):
        raise ValueError(f"shape mismatch: feat {tuple(feat.shape)}, basis16 "
                         f"{tuple(basis16.shape)}, z {tuple(z.shape)}, s={s}")
    noise = noise if with_noise else None
    noise_sel = noise_sel if (with_noise and emit_wsel) else None
    if with_noise and (noise is None or (emit_wsel and noise_sel is None)):
        raise ValueError("with_noise needs noise (and noise_sel when emit_wsel)")
    if feat.device.type == "cpu":
        return fused_render_plain(packed, feat, basis16, z, noise, noise_sel, depth,
                                  skips, s, nb, with_noise, emit_wsel, white_back)
    if feat.device.type != "cuda":
        raise ValueError(f"fused_render: unsupported device {feat.device}")
    if feat.dtype != torch.bfloat16:
        raise ValueError("fused_render: feat must be bfloat16")
    if s > max_samples(packed):
        raise ValueError(f"fused_render: s={s} exceeds the kernel's shared-memory "
                         f"ceiling of {max_samples(packed)} samples per ray")
    for name, t in (("feat", feat), ("basis16", basis16), ("z", z),
                    ("noise", noise), ("noise_sel", noise_sel)):
        if t is None:
            continue
        if t.device != feat.device or not t.is_contiguous():
            raise ValueError(f"fused_render: {name} must be contiguous on {feat.device}")
        if name != "feat" and (t.dtype != torch.float32 or tuple(t.shape)[0] != rays):
            raise ValueError(f"fused_render: {name} must be float32 with {rays} rays")
    for t in (noise, noise_sel):
        if t is not None and tuple(t.shape) != (rays, s):
            raise ValueError(f"fused_render: noise must be [{rays}, {s}]")
    _keep, skip_mask, width, head0, wp, bp = launch_args(packed, skips, feat.device)
    ray_out = torch.empty((rays, 8), dtype=torch.float32, device=feat.device)
    wsel = (torch.empty((rays, s), dtype=torch.float32, device=feat.device)
            if emit_wsel else None)
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    err = _lib()(feat.data_ptr(), basis16.data_ptr(), z.data_ptr(), _ptr(noise),
                 _ptr(noise_sel), ray_out.data_ptr(), _ptr(wsel), rays, s, nb,
                 int(white_back), feat.shape[1], depth, skip_mask, width, head0,
                 wp, bp, stream)
    if err:
        raise RuntimeError(f"fused_render kernel launch failed: CUDA error {err}")
    fused_render.launches += 1
    return ray_out, wsel


fused_render.launches = 0
