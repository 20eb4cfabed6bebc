"""Fused NeRF-MLP kernels (trunk + packed heads, optionally SH-shaded),
their backwards, and the kernel-order encode.

Counterpart of ``mc_nerf_tpu/ops/pallas/fused_mlp.py`` (the kernels, the
encode with its analytic VJP, and the pack).  Four hand-written CUDA
kernels replace its four Pallas bodies:

* ``csrc/fused_mlp.cu``, the Pallas ``_kernel`` (``fused_mlp.py:241``,
  via ``fused_mlp_apply`` at ``:276``): the forward kernel of
  ``csrc/shaded_fwd.cuh`` (below) with a raw epilogue runs pre-encoded
  points through every trunk layer and both heads with ``wgmma`` bf16
  products and fp32 accumulation, and only the packed ``[P, 32]`` fp32
  output reaches device memory;
* ``csrc/fused_shaded.cu`` (+ ``shaded_fwd.cuh``), ``_shaded_fwd_kernel``
  (``:381``, via ``fused_shaded_mlp`` at ``:686``): the MLP with the SH
  shading per point, ``[P, 8]`` out, as the points stage's recompute
  (``csrc/mlp_bwd_points.cuh``) on a forward-only plan: persistent blocks,
  a TMA ring of weight images the wrapper allocates, A from shared memory;
* ``csrc/fused_mlp_bwd.cu``, ``_shaded_bwd_kernel`` (``:423``) and
  ``_bwd_kernel`` (``:739``, the ``fused_mlp`` custom VJP at ``:901``):
  recompute into a device workspace, the shading backward (shaded only),
  the heads and trunk backward per 128-point tile, and the weight
  gradients by split-K with a fixed-order reduction (``csrc/mlp_bwd.cuh``,
  shared with ``fused_render``'s backward).

The eval entry points :func:`fused_mlp_apply_rays` and
:func:`fused_shaded_mlp_rays` (and ``fused_render_rays``) take the rays
and depths in place of features: the forward kernel encodes each point in
its prologue, bit for bit :func:`encode_kernel_order`, so the features
never pass through device memory.  Training keeps the feat entry points.

Bound on an H100 SXM (989 TFLOP/s dense bf16): compute.  The eval coarse
pass (sigma-only 4x128, 81,792 MAC per point needed) over a 16384 x 48
chunk is >= 0.130 ms; a backward needs about three times its forward's
MACs.  See PERF.md for the measured times beside the bounds.

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
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from mc_nerf_torch.models.encoding import spectrum_octaves
from mc_nerf_torch.models.mlp import NerfMLP
from mc_nerf_torch.utils import trace

ENC_PAD = 4        # [x, y, z, pad] header lanes in the encode layout
BASIS_LANES = 16   # SH deg <= 2 basis (9) padded to 16 lanes
OUT_COLS = 32      # packed head output lanes
SHADED_COLS = 8    # fused_shaded_mlp output lanes: sigma, rgb, 4 zeros


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


def mlp_recompute_plain(ws, bs, feat: torch.Tensor, depth: int, skips: Sequence[int],
                        dtype=torch.float32):
    """:func:`mlp_plain_flat` with products and sums in ``dtype``, keeping
    what a backward needs: (xins, each trunk layer's bf16-rounded input;
    h_last; h1; out32)."""
    bf = lambda t: t.to(torch.bfloat16).to(dtype)
    W = [w.to(dtype) for w in ws]
    B = [b.to(dtype) for b in bs]
    f = bf(feat.detach())
    h, xins = f, []
    for i in range(depth):
        if i in skips:
            h = torch.cat([f, h], dim=1)
        xins.append(h)
        h = bf(torch.relu(h @ W[i] + B[i]))
    h1 = bf(torch.relu(h @ W[depth] + B[depth]))
    return xins, h, h1, h1 @ W[depth + 1] + B[depth + 1]


def _split_skip_grad(d_xin: torch.Tensor, e_lanes: int):
    """A skip layer's input gradient [feat | h] -> (its share of dfeat, d h)."""
    return d_xin[:, :e_lanes], d_xin[:, e_lanes:]


def _weight_grad(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """One layer's weight gradient summed over the points: x^T @ d."""
    return x.t() @ d


def _bias_grad(d: torch.Tensor) -> torch.Tensor:
    """One layer's bias gradient summed over the points: [1, N]."""
    return d.sum(0, keepdim=True)


def _trunk_masks(xins, h_last, widths):
    """Each trunk layer's ReLU mask from its bf16 output: layer li's output
    is the hidden lanes of layer li + 1's input (the last layer's, h_last)."""
    depth = len(xins)
    return [(xins[li + 1][:, -widths[li]:] if li + 1 < depth else h_last) > 0
            for li in range(depth)]


def mlp_bwd_plain(ws, xins, h_last, h1, dout32, depth: int, skips: Sequence[int]):
    """The heads and trunk backward of the Pallas backward bodies at their
    rounding points (``fused_render.py:401-436``, ``fused_mlp.py:495-531``,
    ``:783-823``), from :func:`mlp_recompute_plain`'s activations and the
    packed output's cotangent ``dout32`` [P, 32] (in the working dtype):
    dout32, d_h1 and every d_a rounded to bf16, products and sums in
    ``dout32``'s dtype; d_hb1 sums ``dout32`` as given.  Returns (dws,
    dbs, dfeat): every layer's weight [K, N] and bias [1, N] gradient,
    summed over all points, and dfeat [P, E]."""
    skips = tuple(skips)
    sd_t = dout32.dtype
    bf = lambda t: t.to(torch.bfloat16).to(sd_t)
    W = [w.to(sd_t) for w in ws]
    dout_b = bf(dout32)
    d_hw1 = _weight_grad(h1, dout_b)
    d_hb1 = _bias_grad(dout32)
    d_h1 = bf(torch.where(h1 > 0, dout_b @ W[depth + 1].t(), 0.0))
    d_hw0 = _weight_grad(h_last, d_h1)
    d_hb0 = _bias_grad(d_h1)
    d_h = d_h1 @ W[depth].t()
    e_lanes = xins[0].shape[1]
    d_feat = torch.zeros_like(xins[0])
    dws: List[torch.Tensor] = [None] * depth
    dbs: List[torch.Tensor] = [None] * depth
    masks = _trunk_masks(xins, h_last, [w.shape[1] for w in W[:depth]])
    for li in reversed(range(depth)):
        d_a = bf(torch.where(masks[li], d_h, 0.0))
        dws[li] = _weight_grad(xins[li], d_a)
        dbs[li] = _bias_grad(d_a)
        d_xin = d_a @ W[li].t()
        if li in skips:
            share, d_h = _split_skip_grad(d_xin, e_lanes)
            d_feat = d_feat + share
        else:
            d_h = d_xin
    d_feat = d_feat + d_h
    return dws + [d_hw0, d_hw1], dbs + [d_hb0, d_hb1], d_feat


def _check_mlp_args(packed: PackedMLP, feat: Optional[torch.Tensor], depth: int,
                    skips: Sequence[int]) -> None:
    """The pack against depth and skips, and ``feat`` (where given) against
    the pack's feature lanes."""
    if len(packed.trunk_w) != depth:
        raise ValueError(f"pack has {len(packed.trunk_w)} trunk layers, depth={depth}")
    if 0 in skips:
        raise ValueError("a skip at layer 0 is not a skip")
    if feat is None:
        return
    if feat.dim() != 2 or feat.shape[1] != packed.trunk_w[0].shape[0]:
        raise ValueError(f"feat {tuple(feat.shape)} does not match the pack's "
                         f"{packed.trunk_w[0].shape[0]} feature lanes")


def launch_args_flat(ws, bs, skips: Sequence[int], device: torch.device):
    """The C arguments that describe the MLP, from the bf16 (weights,
    biases) of :func:`_flat_weights`: (keep-alive tensors, skip_mask,
    width, head0, weight pointer array, bias pointer array)."""
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


def _mlp_fwd_fns():
    from mc_nerf_torch.ops.cuda import _build

    lib = _build.load("fused_mlp")
    ws_fn, fn = lib.mcn_fused_mlp_workspace, lib.mcn_fused_mlp
    ws_fn.argtypes = [ctypes.c_int] * 5
    ws_fn.restype = ctypes.c_longlong
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return ws_fn, fn


def _mlp_fwd(ws, bs, feat, depth, skips) -> torch.Tensor:
    """K1 on the bf16 layer weights of a CUDA tensor (feat checked): one
    call of ``mcn_fused_mlp``, counted as one launch."""
    _keep, skip_mask, width, head0, wp, bp = launch_args_flat(ws, bs, skips, feat.device)
    p, enc = feat.shape
    ws_fn, fn = _mlp_fwd_fns()
    # the weight images, written anew by every call (the weights may have
    # been updated in place since the last)
    images = torch.empty(max(ws_fn(enc, depth, skip_mask, width, head0), 1), dtype=torch.uint8,
                         device=feat.device)
    out = torch.empty((p, OUT_COLS), dtype=torch.float32, device=feat.device)
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    err = fn(feat.data_ptr(), out.data_ptr(), images.data_ptr(), p, enc, depth, skip_mask, width,
             head0, wp, bp, stream)
    if err:
        raise RuntimeError(f"fused_mlp kernel launch failed: CUDA error {err}")
    fused_mlp_apply.launches += 1
    return out


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
      launch ``csrc/fused_mlp.cu`` (counted as one launch per call,
      whatever it launches inside).
    """
    skips = tuple(skips)
    _check_mlp_args(packed, feat, depth, skips)
    if feat.device.type == "cpu":
        return mlp_plain(packed, feat, depth, skips)
    _check_cuda("fused_mlp_apply", feat)
    return _mlp_fwd(*_flat_weights(packed), feat, depth, skips)


fused_mlp_apply.launches = 0


# ---------------------------------------------------------------------------
# The eval entry points that take rays and depths in place of features: on
# CUDA tensors the forward kernel encodes each point in its prologue
# (``csrc/shaded_fwd.cuh``, ``encode_rows``), so the features never pass
# through device memory; on CPU tensors :func:`encode_kernel_order` of
# :func:`ray_points` and the plain body.  Either way the result is the
# feat entry point's on those features, bit for bit.  Each call adds one
# to the tracer's counter ``encode.kernel`` (the kernel encoded) or
# ``encode.glue`` (``encode_kernel_order``'s features; under a CUDA graph,
# one a capture).  No autograd: training passes ``feat``, whose encode's
# VJP carries the cameras' gradients.
# ---------------------------------------------------------------------------


def ray_points(rays_o: torch.Tensor, rays_d: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """[R, 3], [R, 3], [R, S] -> [R, S, 3] points o + d z: the product,
    then the sum, each rounded (what the kernels' encode computes)."""
    return rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]


def pack_freqs(packed: PackedMLP) -> int:
    """The octaves L of a pack's 4 + 6L feature lanes."""
    enc = packed.trunk_w[0].shape[0]
    if enc <= ENC_PAD or (enc - ENC_PAD) % 6:
        raise ValueError(f"the pack's {enc} feature lanes are not 4 + 6L")
    return (enc - ENC_PAD) // 6


def _check_rays(name: str, rays_o, rays_d, z, s: int, **tensors) -> int:
    """A rays entry point's inputs: rays_o, rays_d [R, 3] and z [R, s]
    (s >= 1); on a CUDA device all of them and ``tensors`` contiguous
    float32 on one device.  Returns R."""
    rays = rays_o.shape[0] if rays_o.dim() == 2 else -1
    if (tuple(rays_o.shape) != (rays, 3) or tuple(rays_d.shape) != (rays, 3)
            or tuple(z.shape) != (rays, s) or s < 1):
        raise ValueError(f"{name}: rays_o {tuple(rays_o.shape)}, rays_d {tuple(rays_d.shape)} "
                         f"and z {tuple(z.shape)} are not [R, 3], [R, 3], [R, {s}]")
    if rays_o.device.type == "cpu":
        return rays
    if rays_o.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {rays_o.device}")
    for key, t in {"rays_o": rays_o, "rays_d": rays_d, "z": z, **tensors}.items():
        if t.device != rays_o.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous float32 on {rays_o.device}")
    return rays


def _glue_feat(packed: PackedMLP, rays_o, rays_d, z) -> torch.Tensor:
    """The CPU route's features: :func:`encode_kernel_order` of the points,
    counted as ``encode.glue``."""
    trace.count("encode.glue")
    return encode_kernel_order(ray_points(rays_o, rays_d, z).reshape(-1, 3), pack_freqs(packed))


def ray_args(rays_o, rays_d, z):
    """The rays and depths as the kernels' C calls take them."""
    return rays_o.data_ptr(), rays_d.data_ptr(), z.data_ptr()


@torch.no_grad()
def fused_mlp_apply_rays(packed: PackedMLP, rays_o: torch.Tensor, rays_d: torch.Tensor,
                         z: torch.Tensor, depth: int, skips: Sequence[int]) -> torch.Tensor:
    """:func:`fused_mlp_apply` on the points ``o + d z`` of rays_o, rays_d
    [R, 3] and depths z [R, S], ray-major: [R * S, 32] fp32, the same bits
    as ``fused_mlp_apply(packed, encode_kernel_order(points), ...)``.
    CUDA tensors launch ``csrc/fused_mlp.cu``'s ``mcn_fused_mlp_rays``
    (one launch a call), the encode in the kernel."""
    skips = tuple(skips)
    s = z.shape[-1] if z.dim() == 2 else 0
    rays = _check_rays("fused_mlp_apply_rays", rays_o, rays_d, z, s)
    if rays_o.device.type == "cpu":
        return fused_mlp_apply(packed, _glue_feat(packed, rays_o, rays_d, z), depth, skips)
    _check_mlp_args(packed, None, depth, skips)
    pack_freqs(packed)
    ws, bs = _flat_weights(packed)
    enc = ws[0].shape[0]
    _keep, skip_mask, width, head0, wp, bp = launch_args_flat(ws, bs, skips, rays_o.device)
    fn = _rays_fns()[0]
    images = torch.empty(max(_mlp_fwd_fns()[0](enc, depth, skip_mask, width, head0), 1),
                         dtype=torch.uint8, device=rays_o.device)
    out = torch.empty((rays * s, OUT_COLS), dtype=torch.float32, device=rays_o.device)
    stream = torch.cuda.current_stream(rays_o.device).cuda_stream
    err = fn(*ray_args(rays_o, rays_d, z), out.data_ptr(), images.data_ptr(), rays * s, s, enc,
             depth, skip_mask, width, head0, wp, bp, stream)
    if err:
        raise RuntimeError(f"fused_mlp_apply_rays kernel launch failed: CUDA error {err}")
    trace.count("encode.kernel")
    fused_mlp_apply_rays.launches += 1
    return out


fused_mlp_apply_rays.launches = 0


def _rays_fns():
    """(``mcn_fused_mlp_rays``, ``mcn_fused_shaded_rays``) with their C
    signatures."""
    from mc_nerf_torch.ops.cuda import _build

    mlp_fn = _build.load("fused_mlp").mcn_fused_mlp_rays
    mlp_fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 6
                       + [ctypes.c_void_p] * 3)
    mlp_fn.restype = ctypes.c_int
    shaded_fn = _build.load("fused_shaded").mcn_fused_shaded_rays
    shaded_fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 7
                          + [ctypes.c_void_p] * 3)
    shaded_fn.restype = ctypes.c_int
    return mlp_fn, shaded_fn


# ---------------------------------------------------------------------------
# The shaded MLP (fused_shaded_mlp) and the differentiable fused_mlp, with
# their backwards.  Plain versions first: the kernels' arithmetic at their
# rounding points, written out (not autograd), products and sums in the
# dtype of the cotangent (float32 is the kernels', float64 a reference).
# ---------------------------------------------------------------------------


def _shade_grad(dout_rgb: torch.Tensor, sig: torch.Tensor) -> torch.Tensor:
    """The sigmoid's backward on the rgb lanes: dout_rgb * sig * (1 - sig)."""
    return dout_rgb * (sig * (1.0 - sig))


def _shaded_plain_flat(ws, bs, feat, basis16, depth, skips, s, nb) -> torch.Tensor:
    out32 = mlp_plain_flat(ws, bs, feat, depth, skips)
    p = out32.shape[0]
    sh = out32[:, 1:1 + 3 * nb].reshape(p // s, s, 3, nb)
    rgb = torch.sigmoid((sh * basis16.detach().float()[:, None, None, :nb]).sum(-1))
    out = torch.zeros((p, SHADED_COLS), dtype=torch.float32, device=out32.device)
    out[:, 0] = out32[:, 0]
    out[:, 1:4] = rgb.reshape(p, 3)
    return out


def fused_shaded_mlp_plain(packed: PackedMLP, feat, basis16, depth, skips, s, nb):
    """K4's arithmetic in plain PyTorch: :func:`mlp_plain`, then per point
    rgb_c = sigmoid(sum_b out32[1 + nb*c + b] * basis[ray, b]) in fp32.
    Same contract as :func:`fused_shaded_mlp`, no autograd."""
    return _shaded_plain_flat(*_flat_weights(packed), feat, basis16, depth, tuple(skips), s, nb)


def _recompute_or(acts, ws, bs, feat, depth, skips, dtype):
    """:func:`mlp_recompute_plain`, or the given activations (xins, h_last,
    h1) in ``dtype`` with the packed output computed from h1."""
    if acts is None:
        return mlp_recompute_plain(ws, bs, feat, depth, skips, dtype)
    xins, h_last, h1 = ([x.to(dtype) for x in acts[0]], acts[1].to(dtype), acts[2].to(dtype))
    return xins, h_last, h1, h1 @ ws[depth + 1].to(dtype) + bs[depth + 1].to(dtype)


def fused_shaded_mlp_bwd_plain(ws, bs, feat, basis16, dout8, depth, skips, s, nb, acts=None):
    """The shaded backward kernel's arithmetic in plain PyTorch, at the
    Pallas body's rounding points (``fused_mlp.py:440-535``): recompute,
    the shading backward (the sigmoid's derivative on the rgb lanes only;
    dout32[0] = dout8[0], dout32[1 + nb*c + b] = draw[c] * basis[b], dbasis
    summed over each ray's samples), then :func:`mlp_bwd_plain` with d_hb1
    summing the unrounded dout32.

    Args: ``ws``/``bs`` the bf16 layer weights and biases
    (:func:`_flat_weights`), ``dout8`` [P, 8] the cotangent of the output;
    the rest as :func:`fused_shaded_mlp`; ``acts``, where given, the
    activations (xins, h_last, h1) to use instead of the recompute.
    Returns (dws, dbs, dfeat [P, E], dbasis [P / s, 16]) in ``dout8``'s
    dtype."""
    skips = tuple(skips)
    sd_t = dout8.dtype
    xins, h_last, h1, out32 = _recompute_or(acts, ws, bs, feat, depth, skips, sd_t)
    p = out32.shape[0]
    rays = p // s
    sh = out32[:, 1:1 + 3 * nb].reshape(rays, s, 3, nb)
    bas = basis16.detach().to(sd_t)[:, None, None, :nb]
    sig = torch.sigmoid((sh * bas).sum(-1))                           # [R, s, 3]
    d8 = dout8.detach().reshape(rays, s, SHADED_COLS)
    draw = _shade_grad(d8[..., 1:4], sig)
    dout32 = torch.zeros((rays, s, OUT_COLS), dtype=sd_t, device=dout8.device)
    dout32[..., 0] = d8[..., 0]
    dout32[..., 1:1 + 3 * nb] = (draw[..., None] * bas).reshape(rays, s, 3 * nb)
    dbasis = torch.zeros((rays, BASIS_LANES), dtype=sd_t, device=dout8.device)
    dbasis[:, :nb] = (draw[..., None] * sh).sum(dim=(1, 2))
    dws, dbs, dfeat = mlp_bwd_plain(ws, xins, h_last, h1, dout32.reshape(p, OUT_COLS), depth,
                                    skips)
    return dws, dbs, dfeat, dbasis


def fused_mlp_bwd_plain(ws, bs, feat, dout, depth, skips, acts=None):
    """K6's arithmetic in plain PyTorch, at the Pallas ``_bwd_kernel``'s
    rounding points (``fused_mlp.py:760-824``): the cotangent ``dout``
    [P, 32] rounds to bf16 first, so d_hb1 sums the rounded values; then
    recompute (or ``acts``, as :func:`fused_shaded_mlp_bwd_plain`) and
    :func:`mlp_bwd_plain`.  Returns (dws, dbs, dfeat [P, E]) in ``dout``'s
    dtype."""
    skips = tuple(skips)
    sd_t = dout.dtype
    xins, h_last, h1, _ = _recompute_or(acts, ws, bs, feat, depth, skips, sd_t)
    dout_b = dout.detach().to(torch.bfloat16).to(sd_t)
    return mlp_bwd_plain(ws, xins, h_last, h1, dout_b, depth, skips)


def _shaded_fwd_fns():
    from mc_nerf_torch.ops.cuda import _build

    lib = _build.load("fused_shaded")
    ws_fn, fn = lib.mcn_fused_shaded_workspace, lib.mcn_fused_shaded
    ws_fn.argtypes = [ctypes.c_int] * 5
    ws_fn.restype = ctypes.c_longlong
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 7
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return ws_fn, fn


def _bwd_fns():
    from mc_nerf_torch.ops.cuda import _build

    lib = _build.load("fused_mlp_bwd")
    ws_fn, shaded_fn, mlp_fn, w_fn, pts_fn = (
        lib.mcn_mlp_bwd_workspace, lib.mcn_shaded_bwd, lib.mcn_mlp_bwd, lib.mcn_mlp_bwd_weights,
        lib.mcn_mlp_bwd_points)
    ws_fn.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 6
    ws_fn.restype = ctypes.c_longlong
    shaded_fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 7
                          + [ctypes.c_void_p] * 3)
    shaded_fn.restype = ctypes.c_int
    mlp_fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] * 3)
    mlp_fn.restype = ctypes.c_int
    w_fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 6
                     + [ctypes.c_void_p])
    w_fn.restype = ctypes.c_int
    pts_fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 7
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p])
    pts_fn.restype = ctypes.c_int
    return ws_fn, shaded_fn, mlp_fn, w_fn, pts_fn


def _check_cuda(name: str, feat: torch.Tensor, **tensors) -> None:
    """A kernel's inputs: feat contiguous bf16 on a CUDA device, the rest
    contiguous float32 on the same device."""
    if feat.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {feat.device}")
    if feat.dtype != torch.bfloat16 or not feat.is_contiguous():
        raise ValueError(f"{name}: feat must be contiguous bfloat16")
    for key, t in tensors.items():
        if t.device != feat.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous float32 on {feat.device}")


def _workspace(points, enc, ws, skips, shaded, device) -> torch.Tensor:
    """The backward kernels' device workspace, from the caching allocator."""
    nbytes = _bwd_fns()[0](points, enc, len(ws) - 2, sum(1 << i for i in skips),
                           ws[0].shape[1], ws[-2].shape[1], int(shaded))
    return torch.empty(max(nbytes, 1), dtype=torch.uint8, device=device)


def _grad_buffers(ws, bs, device):
    w_shapes, b_shapes = [tuple(w.shape) for w in ws], [tuple(b.shape) for b in bs]
    dw = torch.empty(sum(a * b for a, b in w_shapes), dtype=torch.float32, device=device)
    db = torch.empty(sum(a * b for a, b in b_shapes), dtype=torch.float32, device=device)

    def split():
        return ([g.view(sh) for g, sh in zip(torch.split(dw, [a * b for a, b in w_shapes]),
                                             w_shapes)],
                [g.view(sh) for g, sh in zip(torch.split(db, [a * b for a, b in b_shapes]),
                                             b_shapes)])
    return dw, db, split


def _shaded_fwd(ws, bs, feat, basis16, depth, skips, s, nb) -> torch.Tensor:
    """K4 on the bf16 layer weights: plain on CPU tensors, the kernel on
    CUDA tensors."""
    if feat.device.type == "cpu":
        return _shaded_plain_flat(ws, bs, feat, basis16, depth, skips, s, nb)
    _check_cuda("fused_shaded_mlp", feat, basis16=basis16)
    _keep, skip_mask, width, head0, wp, bp = launch_args_flat(ws, bs, skips, feat.device)
    p, enc = feat.shape
    ws_fn, fn = _shaded_fwd_fns()
    # the weight images, written anew by every call (the weights may have
    # been updated in place since the last)
    images = torch.empty(max(ws_fn(enc, depth, skip_mask, width, head0), 1), dtype=torch.uint8,
                         device=feat.device)
    out = torch.empty((p, SHADED_COLS), dtype=torch.float32, device=feat.device)
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    err = fn(feat.data_ptr(), basis16.data_ptr(), out.data_ptr(), images.data_ptr(), p, s, nb,
             enc, depth, skip_mask, width, head0, wp, bp, stream)
    if err:
        raise RuntimeError(f"fused_shaded_mlp kernel launch failed: CUDA error {err}")
    fused_shaded_mlp.launches += 1
    return out


def fused_shaded_mlp_bwd(ws, bs, feat, basis16, dout8, depth, skips, s, nb):
    """The backward of :func:`fused_shaded_mlp` on the bf16 layer weights:
    :func:`fused_shaded_mlp_bwd_plain` on CPU tensors, one call of
    ``csrc/fused_mlp_bwd.cu``'s ``mcn_shaded_bwd`` (points kernel, per-ray
    dbasis sums, weight gradients) on CUDA tensors.  Same returns (fp32)."""
    skips = tuple(skips)
    if feat.device.type == "cpu":
        return fused_shaded_mlp_bwd_plain(ws, bs, feat, basis16, dout8, depth, skips, s, nb)
    work = _workspace(feat.shape[0], feat.shape[1], ws, skips, True, feat.device)
    return _shaded_bwd_launch(ws, bs, feat, basis16, dout8, depth, skips, s, nb, work)


def _shaded_bwd_launch(ws, bs, feat, basis16, dout8, depth, skips, s, nb, work):
    """:func:`fused_shaded_mlp_bwd`'s kernel call on CUDA tensors, into the
    device workspace ``work`` (``_workspace(..., shaded=True)``)."""
    _check_cuda("fused_shaded_mlp_bwd", feat, basis16=basis16, dout8=dout8)
    _keep, skip_mask, width, head0, wp, bp = launch_args_flat(ws, bs, skips, feat.device)
    p, enc = feat.shape
    dfeat = torch.empty((p, enc), dtype=torch.float32, device=feat.device)
    dbasis = torch.empty((p // s, BASIS_LANES), dtype=torch.float32, device=feat.device)
    dw, db, split = _grad_buffers(ws, bs, feat.device)
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    err = _bwd_fns()[1](feat.data_ptr(), basis16.data_ptr(), dout8.data_ptr(), dfeat.data_ptr(),
                        dbasis.data_ptr(), dw.data_ptr(), db.data_ptr(), work.data_ptr(), p, s,
                        nb, enc, depth, skip_mask, width, head0, wp, bp, stream)
    if err:
        raise RuntimeError(f"fused_shaded_mlp backward kernel launch failed: CUDA error {err}")
    fused_shaded_mlp_bwd.launches += 1
    dws, dbs = split()
    return dws, dbs, dfeat, dbasis


def fused_mlp_bwd(ws, bs, feat, dout, depth, skips):
    """The backward of :func:`fused_mlp` on the bf16 layer weights:
    :func:`fused_mlp_bwd_plain` on CPU tensors, ``csrc/fused_mlp_bwd.cu``'s
    ``mcn_mlp_bwd`` on CUDA tensors.  Returns (dws, dbs, dfeat) fp32."""
    skips = tuple(skips)
    if feat.device.type == "cpu":
        return fused_mlp_bwd_plain(ws, bs, feat, dout, depth, skips)
    work = _workspace(feat.shape[0], feat.shape[1], ws, skips, False, feat.device)
    return _mlp_bwd_launch(ws, bs, feat, dout, depth, skips, work)


def _mlp_bwd_launch(ws, bs, feat, dout, depth, skips, work):
    """:func:`fused_mlp_bwd`'s kernel call on CUDA tensors, into the device
    workspace ``work`` (``_workspace(..., shaded=False)``)."""
    _check_cuda("fused_mlp_bwd", feat, dout=dout)
    _keep, skip_mask, width, head0, wp, bp = launch_args_flat(ws, bs, skips, feat.device)
    p, enc = feat.shape
    dfeat = torch.empty((p, enc), dtype=torch.float32, device=feat.device)
    dw, db, split = _grad_buffers(ws, bs, feat.device)
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    err = _bwd_fns()[2](feat.data_ptr(), dout.data_ptr(), dfeat.data_ptr(), dw.data_ptr(),
                        db.data_ptr(), work.data_ptr(), p, enc, depth, skip_mask, width, head0,
                        wp, bp, stream)
    if err:
        raise RuntimeError(f"fused_mlp backward kernel launch failed: CUDA error {err}")
    fused_mlp_bwd.launches += 1
    dws, dbs = split()
    return dws, dbs, dfeat


def mlp_bwd_weights(ws, bs, feat, skips, shaded: bool, work):
    """The weight stage of K5 (``shaded``) or K6 alone, ``mcn_mlp_bwd_weights``
    on CUDA tensors: every layer's weight and bias gradient from the
    workspace ``work`` that :func:`_shaded_bwd_launch` or
    :func:`_mlp_bwd_launch` filled at the same shapes.  Returns (dws, dbs)
    fp32.  It lets ``tools/weight_stage_time.py`` time the stage apart; no
    path of the port calls it."""
    _check_cuda("mlp_bwd_weights", feat)
    p, enc = feat.shape
    dw, db, split = _grad_buffers(ws, bs, feat.device)
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    err = _bwd_fns()[3](feat.data_ptr(), work.data_ptr(), dw.data_ptr(), db.data_ptr(), p, enc,
                        len(ws) - 2, sum(1 << i for i in skips), ws[0].shape[1],
                        ws[-2].shape[1], int(shaded), stream)
    if err:
        raise RuntimeError(f"mlp_bwd_weights kernel launch failed: CUDA error {err}")
    mlp_bwd_weights.launches += 1
    return split()


def mlp_bwd_points(ws, bs, feat, basis16, dout, depth, skips, s, nb, shaded: bool, work):
    """The points stage of K5 (``shaded``: ``dout`` is dout8 [P, 8]) or K6
    (``dout`` [P, 32]) alone, ``mcn_mlp_bwd_points`` on CUDA tensors: the
    recompute, the heads-and-trunk backward and (K5) the per-ray dbasis
    sums, into the workspace ``work`` (``_workspace`` at the same shapes),
    with no weight stage.  Returns (dfeat, dbasis or None) fp32.  It lets
    ``tools/points_stage_time.py`` time the stage apart; no path of the
    port calls it."""
    skips = tuple(skips)
    if shaded:
        _check_cuda("mlp_bwd_points", feat, basis16=basis16, dout=dout)
    else:
        _check_cuda("mlp_bwd_points", feat, dout=dout)
    _keep, skip_mask, width, head0, wp, bp = launch_args_flat(ws, bs, skips, feat.device)
    p, enc = feat.shape
    dfeat = torch.empty((p, enc), dtype=torch.float32, device=feat.device)
    dbasis = (torch.empty((p // s, BASIS_LANES), dtype=torch.float32, device=feat.device)
              if shaded else None)
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    err = _bwd_fns()[4](feat.data_ptr(), basis16.data_ptr() if shaded else None,
                        dout.data_ptr(), dfeat.data_ptr(),
                        dbasis.data_ptr() if shaded else None, work.data_ptr(), p, s, nb, enc,
                        depth, skip_mask, width, head0, wp, bp, int(shaded), stream)
    if err:
        raise RuntimeError(f"mlp_bwd_points kernel launch failed: CUDA error {err}")
    mlp_bwd_points.launches += 1
    return dfeat, dbasis


fused_shaded_mlp_bwd.launches = 0
fused_mlp_bwd.launches = 0
mlp_bwd_weights.launches = 0
mlp_bwd_points.launches = 0


def _leaves(packed: PackedMLP):
    return (*packed.trunk_w, *packed.trunk_b, packed.head_w0, packed.head_b0,
            packed.head_w1, packed.head_b1)


def _leaf_grads(ctx, dws, dbs, first: int):
    """The packed leaves' gradients (order of :func:`_leaves`) cast to each
    leaf's dtype, None where autograd needs none; ``first`` is the index
    of the first leaf among the Function's inputs."""
    depth = len(dws) - 2
    grads = [*dws[:depth], *dbs[:depth], dws[depth], dbs[depth], dws[depth + 1], dbs[depth + 1]]
    need = ctx.needs_input_grad
    return [g.reshape(shape).to(dtype) if need[first + i] else None
            for i, (g, (shape, dtype)) in enumerate(zip(grads, ctx.leaf_meta))]


class _FusedShadedMLP(torch.autograd.Function):
    """The custom VJP of ``fused_mlp.py:685-729``: K4 forward, K5 backward
    on the same bf16 weight copy, cast once per call."""

    @staticmethod
    def forward(ctx, meta, feat, basis16, *leaves):
        depth, skips, s, nb = meta
        ws, bs = _flat_weights(PackedMLP(leaves[:depth], leaves[depth:2 * depth],
                                         *leaves[2 * depth:]))
        out = _shaded_fwd(ws, bs, feat, basis16, depth, skips, s, nb)
        ctx.meta = meta
        ctx.leaf_meta = [(t.shape, t.dtype) for t in leaves]
        ctx.save_for_backward(feat, basis16, *ws, *bs)
        return out

    @staticmethod
    def backward(ctx, dout8):
        depth, skips, s, nb = ctx.meta
        feat, basis16, *flat = ctx.saved_tensors
        ws, bs = flat[:depth + 2], flat[depth + 2:]
        dws, dbs, dfeat, dbasis = fused_shaded_mlp_bwd(
            ws, bs, feat, basis16, dout8.float().contiguous(), depth, skips, s, nb)
        need = ctx.needs_input_grad
        return (None, dfeat.to(feat.dtype) if need[1] else None,
                dbasis.to(basis16.dtype) if need[2] else None, *_leaf_grads(ctx, dws, dbs, 3))


def fused_shaded_mlp(packed: PackedMLP, feat: torch.Tensor, basis16: torch.Tensor, depth: int,
                     skips: Sequence[int], s: int, nb: int) -> torch.Tensor:
    """Differentiable fused MLP + SH shading.

    Args:
      packed: full (sigma + SH) kernel weights: bf16 for eval, fp32 leaves
        (a differentiable ``pack_mlp_params(..., dtype=float32)``) for
        training; the kernels read a bf16 copy cast once per call.
      feat: [rays * s, 4+6L] encoded points, ray-major (bf16 on CUDA).
      basis16: [rays, 16] fp32 SH basis padded to 16 lanes.
      s: samples per ray (>= 1); nb: (sh_deg + 1)^2 <= 9.

    Returns:
      [rays * s, 8] fp32: col 0 raw sigma, cols 1..3 rgb (sigmoid
      applied), cols 4..7 zero.  CPU tensors take the plain versions,
      forward and backward; CUDA tensors launch ``csrc/fused_shaded.cu``
      and, in the backward, ``csrc/fused_mlp_bwd.cu``.  The backward
      returns fp32 weight gradients cast to the pack's dtype, dfeat in
      feat's dtype and dbasis in basis16's.
    """
    skips = tuple(skips)
    _check_mlp_args(packed, feat, depth, skips)
    if s < 1 or not 1 <= nb <= 9:
        raise ValueError(f"fused_shaded_mlp takes s >= 1 and 1 <= nb <= 9; got s={s}, nb={nb}")
    if packed.head_w0.shape[1] != 2 * packed.trunk_w[0].shape[1]:
        raise ValueError("fused_shaded_mlp needs a full (sigma + SH) pack")
    if feat.shape[0] % s or tuple(basis16.shape) != (feat.shape[0] // s, BASIS_LANES):
        raise ValueError(f"shape mismatch: feat {tuple(feat.shape)}, basis16 "
                         f"{tuple(basis16.shape)}, s={s}")
    return _FusedShadedMLP.apply((depth, skips, s, nb), feat, basis16, *_leaves(packed))


fused_shaded_mlp.launches = 0


@torch.no_grad()
def fused_shaded_mlp_rays(packed: PackedMLP, rays_o: torch.Tensor, rays_d: torch.Tensor,
                          z: torch.Tensor, basis16: torch.Tensor, depth: int,
                          skips: Sequence[int], s: int, nb: int) -> torch.Tensor:
    """:func:`fused_shaded_mlp`'s forward on the points ``o + d z`` of
    rays_o, rays_d [R, 3] and depths z [R, s], ray-major: [R * s, 8] fp32,
    the same bits as ``fused_shaded_mlp(packed, encode_kernel_order(points),
    ...)``.  CUDA tensors launch ``csrc/fused_shaded.cu``'s
    ``mcn_fused_shaded_rays`` (one launch a call), the encode in the
    kernel.  No autograd."""
    skips = tuple(skips)
    rays = _check_rays("fused_shaded_mlp_rays", rays_o, rays_d, z, s, basis16=basis16)
    if rays_o.device.type == "cpu":
        return fused_shaded_mlp(packed, _glue_feat(packed, rays_o, rays_d, z), basis16, depth,
                                skips, s, nb)
    _check_mlp_args(packed, None, depth, skips)
    pack_freqs(packed)
    enc = packed.trunk_w[0].shape[0]
    if not 1 <= nb <= 9:
        raise ValueError(f"fused_shaded_mlp_rays takes 1 <= nb <= 9; got nb={nb}")
    if packed.head_w0.shape[1] != 2 * packed.trunk_w[0].shape[1]:
        raise ValueError("fused_shaded_mlp_rays needs a full (sigma + SH) pack")
    if tuple(basis16.shape) != (rays, BASIS_LANES):
        raise ValueError(f"fused_shaded_mlp_rays: basis16 {tuple(basis16.shape)} is not "
                         f"[{rays}, {BASIS_LANES}]")
    ws, bs = _flat_weights(packed)
    _keep, skip_mask, width, head0, wp, bp = launch_args_flat(ws, bs, skips, rays_o.device)
    images = torch.empty(max(_shaded_fwd_fns()[0](enc, depth, skip_mask, width, head0), 1),
                         dtype=torch.uint8, device=rays_o.device)
    out = torch.empty((rays * s, SHADED_COLS), dtype=torch.float32, device=rays_o.device)
    stream = torch.cuda.current_stream(rays_o.device).cuda_stream
    err = _rays_fns()[1](*ray_args(rays_o, rays_d, z), basis16.data_ptr(), out.data_ptr(),
                         images.data_ptr(), rays * s, s, nb, enc, depth, skip_mask, width, head0,
                         wp, bp, stream)
    if err:
        raise RuntimeError(f"fused_shaded_mlp_rays kernel launch failed: CUDA error {err}")
    trace.count("encode.kernel")
    fused_shaded_mlp_rays.launches += 1
    return out


fused_shaded_mlp_rays.launches = 0


class _FusedMLP(torch.autograd.Function):
    """The custom VJP of ``fused_mlp.py:900-937``: the forward of
    :func:`fused_mlp_apply` (K1), the K6 backward, on one bf16 weight
    copy."""

    @staticmethod
    def forward(ctx, meta, feat, *leaves):
        depth, skips = meta
        ws, bs = _flat_weights(PackedMLP(leaves[:depth], leaves[depth:2 * depth],
                                         *leaves[2 * depth:]))
        bf16_pack = PackedMLP(tuple(ws[:depth]), tuple(bs[:depth]), ws[depth], bs[depth],
                              ws[depth + 1], bs[depth + 1])
        out = fused_mlp_apply(bf16_pack, feat, depth, skips)
        ctx.meta = meta
        ctx.leaf_meta = [(t.shape, t.dtype) for t in leaves]
        ctx.save_for_backward(feat, *ws, *bs)
        return out

    @staticmethod
    def backward(ctx, dout):
        depth, skips = ctx.meta
        feat, *flat = ctx.saved_tensors
        ws, bs = flat[:depth + 2], flat[depth + 2:]
        dws, dbs, dfeat = fused_mlp_bwd(ws, bs, feat, dout.float().contiguous(), depth, skips)
        return (None, dfeat.to(feat.dtype) if ctx.needs_input_grad[1] else None,
                *_leaf_grads(ctx, dws, dbs, 2))


def fused_mlp(packed: PackedMLP, feat: torch.Tensor, depth: int,
              skips: Sequence[int]) -> torch.Tensor:
    """Differentiable fused MLP (the JAX package's ``fused_mlp``, which has
    no caller on its training path): the forward is :func:`fused_mlp_apply`,
    the backward recomputes the activations and runs the heads and trunk
    backward (``csrc/fused_mlp_bwd.cu`` on CUDA tensors, the plain version
    on CPU tensors).  Same contract as :func:`fused_mlp_apply`; gradients
    reach the packed leaves (cast to their dtype) and feat (in its dtype)."""
    skips = tuple(skips)
    _check_mlp_args(packed, feat, depth, skips)
    return _FusedMLP.apply((depth, skips), feat, *_leaves(packed))
