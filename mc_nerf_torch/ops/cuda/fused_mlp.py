"""Fused NeRF-MLP kernel (trunk + packed heads) and the kernel-order encode.

Counterpart of ``mc_nerf_tpu/ops/pallas/fused_mlp.py`` (the forward kernel,
the encode with its analytic VJP, and the pack).
The kernel, ``csrc/fused_mlp.cu``, replaces the Pallas ``_kernel``
(``fused_mlp.py:241``, called through ``fused_mlp_apply`` at ``:276``):
a block of 256 threads runs 128 pre-encoded points through every trunk
layer and both heads with ``wgmma`` bf16 tiles and fp32 accumulation,
and only the packed ``[P, 32]`` fp32 output reaches device memory.

Bound on an H100 SXM (989 TFLOP/s dense bf16): compute.  The eval coarse
pass (sigma-only 4x128, 81,792 MAC per point needed) over a 16384 x 48
chunk is >= 0.130 ms; see PERF.md for the measured time beside it.

Layout (as in the JAX package):
  * features ``[x, y, z, 0, sin(f0) x3, cos(f0) x3, sin(f1) x3, ...]``,
    4 + 6L lanes; ``pack_mlp_params`` permutes the first layer's rows (and
    each skip layer's feature block) to match;
  * both heads pack into two GEMMs: first layers concatenate to
    [width, 2*width]; second layers form a block-diagonal [2*width, 32]
    with column 0 = sigma and columns 1..27 = SH.  A ``sigma_only`` pack
    (the eval coarse pass) keeps just the sigma pair.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from mc_nerf_torch.models.encoding import spectrum_octaves
from mc_nerf_torch.models.mlp import NerfMLP

ENC_PAD = 4        # [x, y, z, pad] header lanes in the encode layout
BASIS_LANES = 16   # SH deg <= 2 basis (9) padded to 16 lanes
OUT_COLS = 32      # packed head output lanes


class PackedMLP(NamedTuple):
    """Kernel-ready weights in the JAX pack's layout ([in, out], bf16)."""

    trunk_w: Tuple[torch.Tensor, ...]   # first/skip layers row-permuted
    trunk_b: Tuple[torch.Tensor, ...]   # [1, width]
    head_w0: torch.Tensor               # [width, 2*width] (or [w, w] sigma-only)
    head_b0: torch.Tensor               # [1, 2*width]
    head_w1: torch.Tensor               # [2*width, 32] block diagonal
    head_b1: torch.Tensor               # [1, 32]


def encode_width(n_freqs: int) -> int:
    return ENC_PAD + 6 * n_freqs


def _encode_fwd(xyz: torch.Tensor, n_freqs: int, freq_weights: Optional[torch.Tensor],
                dtype) -> torch.Tensor:
    p = xyz.shape[0]
    sins, coss = spectrum_octaves(xyz, n_freqs)
    spec = torch.stack(sins + coss).view(2, n_freqs, p, 3)   # [2, L, P, 3]
    if freq_weights is not None:
        spec = spec * freq_weights.to(spec.dtype)[:, None, None]
    out = torch.empty((p, encode_width(n_freqs)), dtype=dtype, device=xyz.device)
    out[:, :3] = xyz
    out[:, 3] = 0
    out[:, ENC_PAD:].view(p, n_freqs, 2, 3).copy_(spec.permute(2, 1, 0, 3))
    return out


@functools.lru_cache(maxsize=None)
def _encode_selection(n_freqs: int, device: torch.device) -> torch.Tensor:
    """[4 + 6L, 3] 0/1: lane -> the coordinate it derives from (none for
    the pad lane).  Made once per device: a copy from the host each step
    would wait for the card."""
    sel = np.zeros((encode_width(n_freqs), 3), np.float32)
    for d in range(3):
        sel[d, d] = 1.0
        for f in range(n_freqs):
            sel[ENC_PAD + 6 * f + d, d] = 1.0
            sel[ENC_PAD + 6 * f + 3 + d, d] = 1.0
    return torch.as_tensor(sel, device=device)


class _Encode(torch.autograd.Function):
    """The kernel-order encode with the JAX package's analytic VJP
    (``fused_mlp.py:91-125``): the derivative spectrum (d sin = 2^f cos,
    d cos = -2^f sin, times the BARF gate) in kernel lane order, multiplied
    lane-wise by the upcast cotangent and reduced with one [4 + 6L, 3]
    selection product.  ``freq_weights`` is a schedule: no gradient."""

    @staticmethod
    def forward(ctx, xyz, n_freqs, freq_weights, dtype):
        ctx.n_freqs = n_freqs
        ctx.save_for_backward(xyz, freq_weights)
        return _encode_fwd(xyz, n_freqs, freq_weights, dtype)

    @staticmethod
    def backward(ctx, dfeat):
        xyz, freq_weights = ctx.saved_tensors
        n = ctx.n_freqs
        x32 = xyz.float()
        p = x32.shape[0]
        sins, coss = spectrum_octaves(x32, n)
        f = 2.0 ** torch.arange(n, dtype=torch.float32, device=xyz.device)
        if freq_weights is not None:
            f = f * freq_weights.float()
        f = f[:, None, None]
        spec = torch.stack([torch.stack(coss) * f, -torch.stack(sins) * f])  # [2, L, P, 3]
        deriv = torch.empty((p, encode_width(n)), dtype=torch.float32, device=xyz.device)
        deriv[:, :3] = 1.0
        deriv[:, 3] = 0.0
        deriv[:, ENC_PAD:].view(p, n, 2, 3).copy_(spec.permute(2, 1, 0, 3))
        dx = (dfeat.float() * deriv) @ _encode_selection(n, xyz.device)
        return dx.to(xyz.dtype), None, None, None


def encode_kernel_order(xyz: torch.Tensor, n_freqs: int,
                        freq_weights: Optional[torch.Tensor] = None,
                        dtype=torch.bfloat16) -> torch.Tensor:
    """[P, 3] points -> [P, 4 + 6L] features in the kernel's lane order,
    computed in the points' dtype and cast to ``dtype`` at the end.
    Differentiable in ``xyz`` with the JAX package's analytic VJP
    (:class:`_Encode`); the cotangent arrives in ``dtype`` (bf16-rounded,
    as in the JAX package) and is upcast.

    The octaves stack along a new leading axis and land in the output with
    one strided copy: stacking [P, 3] tensors along an inner axis cost
    ~5 ms per 16384-ray chunk on an H100 (PERF.md)."""
    return _Encode.apply(xyz, n_freqs, freq_weights, dtype)


def _enc_permutation(n_freqs: int) -> np.ndarray:
    """perm[new_row] = old_row (or -1 for the pad lane): original encode
    order [x(3), per-dim: sin f0..fL-1, cos f0..fL-1] -> kernel lane order
    [x(3), pad, per-freq: sin over dims, cos over dims]."""
    perm = np.full(encode_width(n_freqs), -1, dtype=np.int64)
    perm[0:3] = [0, 1, 2]
    for f in range(n_freqs):
        for d in range(3):
            perm[ENC_PAD + 6 * f + d] = 3 + d * 2 * n_freqs + f
            perm[ENC_PAD + 6 * f + 3 + d] = 3 + d * 2 * n_freqs + n_freqs + f
    return perm


@functools.lru_cache(maxsize=None)
def _permutation_tensors(n_freqs: int, device: torch.device):
    """(source rows, live mask [rows, 1]) of :func:`_enc_permutation` on
    the device, made once: the training pack runs every step, and a copy
    from the host each time would wait for the card."""
    perm = _enc_permutation(n_freqs)
    return (torch.as_tensor(np.where(perm >= 0, perm, 0), device=device),
            torch.as_tensor(perm >= 0, device=device)[:, None])


def _permute_rows(w: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """[3 + 6L, out] -> [4 + 6L, out] in kernel lane order, with a zero
    row at the pad lane."""
    src, mask = _permutation_tensors(n_freqs, w.device)
    return torch.where(mask, w[src], torch.zeros((), dtype=w.dtype, device=w.device))


def pack_mlp_params(mlp: NerfMLP, n_freqs: int, skips: Sequence[int],
                    sigma_only: bool = False, dtype=torch.bfloat16) -> PackedMLP:
    """fp32 module weights -> the kernel layout; leaves equal the JAX
    package's ``pack_mlp_params`` bit for bit.

    A float32 pack (training, ``models/nerf.py``) is differentiable: its
    autograd carries the kernels' fp32 weight gradients back to the module
    (the inverse row permutation, nothing for the pad lane, only the live
    blocks of ``head_w1``).  Other dtypes pack without autograd (eval)."""
    with torch.set_grad_enabled(torch.is_grad_enabled() and dtype == torch.float32):
        n_enc = 3 + 6 * n_freqs
        trunk_w, trunk_b = [], []
        for i, layer in enumerate(mlp.trunk):
            w = layer.weight.t()                            # [in, out]
            if i == 0:
                w = _permute_rows(w, n_freqs)
            elif i in skips:
                # skip input rows are [enc(3+6L) | h]; the kernel's are
                # [feat(4+6L) | h]: permute/pad the encode block only
                w = torch.cat([_permute_rows(w[:n_enc], n_freqs), w[n_enc:]], dim=0)
            trunk_w.append(w.to(dtype).contiguous())
            trunk_b.append(layer.bias.reshape(1, -1).to(dtype))

        width = mlp.sigma0.weight.shape[0]
        dev = mlp.sigma0.weight.device
        sw0, sb0 = mlp.sigma0.weight.t(), mlp.sigma0.bias
        sw1, sb1 = mlp.sigma1.weight.t(), mlp.sigma1.bias
        if sigma_only:
            head_w0, head_b0 = sw0, sb0[None]
            head_w1 = torch.zeros((width, OUT_COLS), dtype=torch.float32, device=dev)
            head_w1[:, 0:1] = sw1
            head_b1 = torch.zeros((1, OUT_COLS), dtype=torch.float32, device=dev)
            head_b1[0, 0] = sb1[0]
        else:
            hw1, hb1 = mlp.sh1.weight.t(), mlp.sh1.bias
            sh_dim = hw1.shape[1]
            if sh_dim > OUT_COLS - 1:
                raise ValueError(
                    f"packed head holds sigma + <=31 SH cols; got sh_dim={sh_dim} "
                    "(SH degree > 2): use the plain route")
            head_w0 = torch.cat([sw0, mlp.sh0.weight.t()], dim=1)
            head_b0 = torch.cat([sb0, mlp.sh0.bias])[None]
            head_w1 = torch.zeros((2 * width, OUT_COLS), dtype=torch.float32, device=dev)
            head_w1[:width, 0:1] = sw1
            head_w1[width:, 1:1 + sh_dim] = hw1
            head_b1 = torch.zeros((1, OUT_COLS), dtype=torch.float32, device=dev)
            head_b1[0, 0] = sb1[0]
            head_b1[0, 1:1 + sh_dim] = hb1
        return PackedMLP(
            tuple(trunk_w), tuple(trunk_b),
            head_w0.to(dtype).contiguous(), head_b0.to(dtype).contiguous(),
            head_w1.to(dtype).contiguous(), head_b1.to(dtype).contiguous(),
        )


def _flat_weights(packed: PackedMLP):
    """(weights, biases) in layer order, bf16 and contiguous, as the kernel
    reads them (the JAX call casts every leaf once, fused_mlp.py:308)."""
    ws = [*packed.trunk_w, packed.head_w0, packed.head_w1]
    bs = [*packed.trunk_b, packed.head_b0, packed.head_b1]
    cast = lambda t: t.detach().to(torch.bfloat16).contiguous()
    return [cast(w) for w in ws], [cast(b) for b in bs]


def mlp_plain(packed: PackedMLP, feat: torch.Tensor, depth: int,
              skips: Sequence[int]) -> torch.Tensor:
    """The MLP of both kernels in plain PyTorch: fp32 products of
    bf16-rounded values, the kernel's rounding points.  [P, E] -> [P, 32]."""
    return mlp_plain_flat(*_flat_weights(packed), feat, depth, skips)


def mlp_plain_flat(ws, bs, feat: torch.Tensor, depth: int,
                   skips: Sequence[int]) -> torch.Tensor:
    """:func:`mlp_plain` on the bf16 (weights, biases) of
    :func:`_flat_weights`."""
    f = feat.detach().to(torch.bfloat16).float()
    h = f
    for i in range(depth):
        if i in skips:
            h = torch.cat([f, h], dim=1)
        h = torch.relu(h @ ws[i].float() + bs[i].float()).bfloat16().float()
    h1 = torch.relu(h @ ws[depth].float() + bs[depth].float()).bfloat16().float()
    return h1 @ ws[depth + 1].float() + bs[depth + 1].float()


def _check_mlp_args(packed: PackedMLP, feat: torch.Tensor, depth: int,
                    skips: Sequence[int]) -> None:
    if len(packed.trunk_w) != depth:
        raise ValueError(f"pack has {len(packed.trunk_w)} trunk layers, depth={depth}")
    if 0 in skips:
        raise ValueError("a skip at layer 0 is not a skip")
    if feat.dim() != 2 or feat.shape[1] != packed.trunk_w[0].shape[0]:
        raise ValueError(f"feat {tuple(feat.shape)} does not match the pack's "
                         f"{packed.trunk_w[0].shape[0]} feature lanes")


def launch_args(packed: PackedMLP, skips: Sequence[int], device: torch.device):
    """The C arguments that describe the MLP: (keep-alive tensors,
    skip_mask, width, head0, weight pointer array, bias pointer array)."""
    return launch_args_flat(*_flat_weights(packed), skips, device)


def launch_args_flat(ws, bs, skips: Sequence[int], device: torch.device):
    """:func:`launch_args` on the bf16 (weights, biases) of
    :func:`_flat_weights`."""
    for t in ws + bs:
        if t.device != device:
            raise ValueError(f"weights on {t.device}, feat on {device}")
    width, head0 = ws[0].shape[1], ws[-2].shape[1]
    if width not in (32, 64, 128, 256):
        raise ValueError(f"the kernels take trunk widths 32, 64, 128 or 256; got {width}")
    skip_mask = sum(1 << i for i in skips)
    wp = (ctypes.c_void_p * len(ws))(*[t.data_ptr() for t in ws])
    bp = (ctypes.c_void_p * len(bs))(*[t.data_ptr() for t in bs])
    return (ws, bs), skip_mask, width, head0, wp, bp


def _lib():
    from mc_nerf_torch.ops.cuda import _build

    lib = _build.load("fused_mlp")
    fn = lib.mcn_fused_mlp
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_mlp_apply(packed: PackedMLP, feat: torch.Tensor, depth: int,
                    skips: Sequence[int]) -> torch.Tensor:
    """Run the fused MLP over pre-encoded points.

    Args:
      packed: kernel-layout weights (:func:`pack_mlp_params`).
      feat: [P, 4+6L] encoded features (:func:`encode_kernel_order`).
      depth/skips: trunk config.

    Returns:
      [P, 32] fp32: col 0 raw sigma, cols 1..27 SH (zeros past col 0 for a
      sigma-only pack).  CPU tensors take the plain version; CUDA tensors
      launch ``csrc/fused_mlp.cu``.
    """
    skips = tuple(skips)
    _check_mlp_args(packed, feat, depth, skips)
    if feat.device.type == "cpu":
        return mlp_plain(packed, feat, depth, skips)
    if feat.device.type != "cuda":
        raise ValueError(f"fused_mlp_apply: unsupported device {feat.device}")
    if feat.dtype != torch.bfloat16 or not feat.is_contiguous():
        raise ValueError("fused_mlp_apply: feat must be contiguous bfloat16")
    _keep, skip_mask, width, head0, wp, bp = launch_args(packed, skips, feat.device)
    p = feat.shape[0]
    out = torch.empty((p, OUT_COLS), dtype=torch.float32, device=feat.device)
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    err = _lib()(feat.data_ptr(), out.data_ptr(), p, feat.shape[1], depth,
                 skip_mask, width, head0, wp, bp, stream)
    if err:
        raise RuntimeError(f"fused_mlp kernel launch failed: CUDA error {err}")
    fused_mlp_apply.launches += 1
    return out


fused_mlp_apply.launches = 0
