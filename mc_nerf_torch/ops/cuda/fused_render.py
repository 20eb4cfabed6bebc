"""Fully-fused render: MLP + SH shading + alpha composite, and its backward.

Counterpart of ``mc_nerf_tpu/ops/pallas/fused_render.py``.  Two kernels:

* ``csrc/fused_render.cu`` replaces the Pallas ``_render_fwd_kernel``
  (``fused_render.py:211``, called through ``_render_fwd_call`` at
  ``:476`` and ``fused_render`` at ``:650``): K4's forward kernel
  (``csrc/shaded_fwd.cuh``: persistent blocks on a TMA ring of weight
  images) runs the MLP and the SH shading of every point into a [P, 8]
  buffer of the workspace, then a composite kernel runs each ray in a
  warp with a shuffle prefix scan into the per-ray results (and,
  optionally, the per-sample selection weights).
* ``csrc/fused_render_bwd.cu`` replaces ``_render_bwd_kernel``
  (``fused_render.py:290``, via ``_render_bwd_call`` ``:559`` and the
  custom VJP ``_fused_render_bwd`` ``:697``) in two launches:
  :func:`render_bwd_points` (the points stage: the composite backward per
  ray gives each point's cotangent dout8 from its sigma and rgb, and
  ``fused_shaded_mlp``'s points stage runs the shading and MLP backward
  per point from it into a device workspace; in one kernel where whole
  rays fill a tile, else as a forward, a composite kernel and that stage)
  and :func:`render_bwd_weights` (the weight gradients summed over all
  points, split over chunks of points and reduced in a fixed order).
  :func:`render_composite_bwd_plain` is the composite step's oracle.

Bound on an H100 SXM (989 TFLOP/s dense bf16): compute.  The eval fine
pass (8x256, 629,248 MAC per point needed) over a 16384 x 32 chunk is
>= 0.667 ms; the backward needs about three times its forward's MACs.
See PERF.md for the measured times beside them.

Composite semantics are ``ops/volume.py``'s (ref ``inference``,
``model/mc_nerf.py:705-736``): rgb weights from softplus(sigma + noise),
depth/opacity from the noise-free transmittance, the white background
adds (1 - sum w), the last delta is 1e10.  :func:`fused_render` is
differentiable (a ``torch.autograd.Function``): ``z`` and the noise get
no gradient and ``wsel`` is stop-gradient, as in the JAX custom VJP.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from mc_nerf_torch.ops.cuda.fused_mlp import (
    BASIS_LANES,
    OUT_COLS,
    PackedMLP,
    _check_mlp_args,
    _check_rays,
    _flat_weights,
    _glue_feat,
    launch_args_flat,
    mlp_bwd_plain,
    mlp_plain_flat,
    mlp_recompute_plain,
    pack_freqs,
    ray_args,
)
from mc_nerf_torch.utils import trace


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # max(x, 0) + log(1 + exp(-|x|)): the kernels' form
    return torch.clamp(x, min=0.0) + torch.log(1.0 + torch.exp(-torch.abs(x)))


def _deltas_flat(z: torch.Tensor) -> torch.Tensor:
    """[rays, s] depths -> [rays*s, 1] deltas, last = 1e10."""
    d = torch.cat([z[:, 1:] - z[:, :-1],
                   torch.full((z.shape[0], 1), 1e10, dtype=z.dtype, device=z.device)],
                  dim=1)
    return d.reshape(-1, 1)


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], 1), 1)


def _exclusive_suffix_sum(x: torch.Tensor) -> torch.Tensor:
    """Per row, the sum over the later columns (the later samples of a ray)."""
    suffix = torch.flip(torch.cumsum(torch.flip(x[:, 1:], [1]), 1), [1])
    return torch.cat([suffix, torch.zeros_like(x[:, :1])], 1)


def fused_render_plain(packed, feat, basis16, z, noise, noise_sel, depth, skips,
                       s, nb, with_noise, emit_wsel, white_back=True):
    """The kernel's arithmetic in plain PyTorch (fp32 on bf16-rounded MLP
    operands).  Same contract as :func:`fused_render`, no autograd."""
    return _render_plain_flat(*_flat_weights(packed), feat, basis16, z, noise, noise_sel,
                              depth, skips, s, nb, with_noise, emit_wsel, white_back)


def _render_plain_flat(ws, bs, feat, basis16, z, noise, noise_sel, depth, skips,
                       s, nb, with_noise, emit_wsel, white_back=True):
    rays = basis16.shape[0]
    basis16, z = basis16.detach(), z.detach()
    out32 = mlp_plain_flat(ws, bs, feat, depth, skips).reshape(rays, s, -1)
    sigma = out32[..., 0]
    sh = out32[..., 1:1 + 3 * nb].reshape(rays, s, 3, nb)
    rgb = torch.sigmoid((sh * basis16[:, None, None, :nb]).sum(-1))   # [R, s, 3]
    d = _deltas_flat(z).reshape(rays, s)

    def weights(sig):
        sd = _softplus(sig) * d
        return (1.0 - torch.exp(-sd)) * torch.exp(-_exclusive_cumsum(sd))

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


def _composite_bwd(sigma, rgb, z, noise, dray, white_back):
    """The composite's backward per ray (``fused_render.py:343-392``): from
    the raw sigma [R, s], the sigmoid rgb [R, s, 3] and the cotangent dray
    [R, 8] of (rgb, depth, opacity), d sigma [R, s] and the rgb-path
    weights w [R, s] (noisy where ``noise`` is given); exclusive suffix
    sums of d(cum), the last delta 1e10, the white background's -sum(drgb)."""
    rays, s = sigma.shape
    d = _deltas_flat(z).reshape(rays, s)
    drgb = dray[:, None, 0:3]
    dw = (drgb * rgb).sum(-1)
    if white_back:
        dw = dw - drgb.sum(-1)
    dprob = dray[:, 3:4] * z + dray[:, 4:5]
    cols = [(sigma, dprob), (sigma + noise, dw)] if noise is not None else [(sigma, dprob + dw)]
    dsigma = torch.zeros_like(sigma)
    for sig_c, dwc in cols:
        sd = _softplus(sig_c) * d
        t_ex = torch.exp(-_exclusive_cumsum(sd))
        e = torch.exp(-sd)
        alpha = 1.0 - e
        w = alpha * t_ex
        dcum = -(dwc * alpha) * t_ex
        dsd = _exclusive_suffix_sum(dcum) + dwc * t_ex * e
        dsigma = dsigma + dsd * d * torch.sigmoid(sig_c)
    # w is the rgb-path weight: the last column's (noisy under noise)
    return dsigma, w


def render_composite_bwd_plain(sigma, rgb, z, noise, dray, white_back=True):
    """The composite backward's arithmetic (``composite_ray`` in
    ``csrc/mlp_bwd_points.cuh``, which both paths of ``render_bwd_points``
    run) in plain PyTorch: the per-point cotangent of
    ``fused_shaded_mlp``'s outputs that the render's composite hands back.

    Args: ``sigma`` [rays, s] the raw sigma, ``rgb`` [rays, s, 3] the
    sigmoid rgb, ``z`` [rays, s] sorted depths, ``noise`` [rays, s] or None
    (noisy rgb weights, noise-free depth and opacity), ``dray`` [rays, 8]
    the cotangent of the rays' (rgb, depth, opacity).  Returns dout8
    [rays * s, 8] in ``dray``'s dtype: d sigma, w * d rgb_c (w the rgb-path
    weight of the point), zeros; :func:`fused_shaded_mlp_bwd_plain` on it
    gives :func:`fused_render_bwd_plain`'s gradients."""
    rays, s = sigma.shape
    sd_t = dray.dtype
    dray = dray.detach()
    noise = None if noise is None else noise.detach().to(sd_t)
    dsigma, w = _composite_bwd(sigma.detach().to(sd_t), rgb.detach().to(sd_t),
                               z.detach().to(sd_t), noise, dray, white_back)
    dout8 = torch.zeros((rays, s, 8), dtype=sd_t, device=dray.device)
    dout8[..., 0] = dsigma
    dout8[..., 1:4] = w[..., None] * dray[:, None, 0:3]
    return dout8.reshape(rays * s, 8)


def fused_render_bwd_plain(ws, bs, feat, basis16, z, noise, dray, depth, skips, s, nb,
                           with_noise, white_back=True):
    """The backward kernels' arithmetic in plain PyTorch, with the Pallas
    backward's rounding points (``fused_render.py:343-441``): recompute,
    composite backward (exclusive suffix sums of d(cum)), shading backward,
    then heads and trunk with dout32, d_h1 and every d_a rounded to bf16
    and fp32 products.  Not autograd of :func:`fused_render_plain`, which
    would not round the cotangents.

    Args: ``ws``/``bs`` the bf16 layer weights and biases
    (``fused_mlp._flat_weights``), ``dray`` [rays, 8] the cotangent of
    ``ray_out``; the rest as :func:`fused_render`.  Every sum and product
    between the rounding points runs in ``dray``'s dtype: float32 is the
    kernels' arithmetic, float64 a reference of the same rounding points.

    Returns (dws, dbs, dfeat [rays*s, E], dbasis [rays, 16]) in ``dray``'s
    dtype: gradients of every layer's weight [K, N] and bias [1, N],
    summed over all points.
    """
    skips = tuple(skips)
    rays = basis16.shape[0]
    sd_t = dray.dtype
    basis16, z, dray = basis16.detach().to(sd_t), z.detach().to(sd_t), dray.detach().to(sd_t)
    noise = None if noise is None else noise.to(sd_t)
    # ---- forward recompute, keeping every layer's (bf16-rounded) input
    xins, h_last, h1, out32 = mlp_recompute_plain(ws, bs, feat, depth, skips, sd_t)
    out = out32.reshape(rays, s, OUT_COLS)
    sigma = out[..., 0]
    sh = out[..., 1:1 + 3 * nb].reshape(rays, s, 3, nb)
    bas = basis16[:, None, None, :nb]
    rgb = torch.sigmoid((sh * bas).sum(-1))                           # [R, s, 3]

    # ---- composite backward
    dsigma, w = _composite_bwd(sigma, rgb, z, noise if with_noise else None, dray, white_back)
    draw = w[..., None] * dray[:, None, 0:3] * rgb * (1.0 - rgb)      # [R, s, 3]
    dout32 = torch.zeros((rays, s, OUT_COLS), dtype=sd_t, device=z.device)
    dout32[..., 0] = dsigma
    dout32[..., 1:1 + 3 * nb] = (draw[..., None] * bas).reshape(rays, s, 3 * nb)
    dbasis = torch.zeros((rays, BASIS_LANES), dtype=sd_t, device=z.device)
    dbasis[:, :nb] = (draw[..., None] * sh).sum(dim=(1, 2))

    # ---- heads and trunk backward
    dws, dbs, d_feat = mlp_bwd_plain(ws, xins, h_last, h1, dout32.reshape(rays * s, OUT_COLS),
                                     depth, skips)
    return dws, dbs, d_feat, dbasis


def _lib(name: str):
    from mc_nerf_torch.ops.cuda import _build

    return _build.load(name)


def _ceiling(lib: str, fn_name: str, packed: PackedMLP) -> int:
    fn = getattr(_lib(lib), fn_name)
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    enc, width = packed.trunk_w[0].shape
    return fn(enc, len(packed.trunk_w), width, packed.head_w0.shape[1])


def max_samples(packed: PackedMLP) -> int:
    """The most samples per ray the forward kernels take with this pack
    (``mcn_render_max_samples`` in ``csrc/fused_render.cu``): no limit
    (2**31 - 1) for any full pack, the composite reading each ray's rows
    from device memory; 0 for a pack they do not take.  Builds the
    kernels at first use."""
    return _ceiling("fused_render", "mcn_render_max_samples", packed)


def max_samples_bwd(packed: PackedMLP) -> int:
    """The most samples per ray the backward kernels take with this pack
    (``mcn_render_bwd_max_samples`` in ``csrc/fused_render_bwd.cu``): no
    limit (2**31 - 1) for any pack they take, so every ray the forward
    takes; builds the kernels at first use."""
    return _ceiling("fused_render_bwd", "mcn_render_bwd_max_samples", packed)


def _fwd_fns():
    lib = _lib("fused_render")
    ws_fn, fn = lib.mcn_fused_render_workspace, lib.mcn_fused_render
    ws_fn.argtypes = [ctypes.c_int] * 7
    ws_fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return ws_fn, fn


def _bwd_fns():
    lib = _lib("fused_render_bwd")
    ws_fn, pts_fn, w_fn = (lib.mcn_render_bwd_workspace, lib.mcn_render_bwd_points,
                           lib.mcn_render_bwd_weights)
    ws_fn.argtypes = [ctypes.c_int] * 7
    ws_fn.restype = ctypes.c_longlong
    pts_fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 3
    pts_fn.restype = ctypes.c_int
    w_fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    w_fn.restype = ctypes.c_int
    return ws_fn, pts_fn, w_fn


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check_cuda_inputs(feat, basis16, z, noise, noise_sel, rays, s) -> None:
    if feat.device.type != "cuda":
        raise ValueError(f"fused_render: unsupported device {feat.device}")
    if feat.dtype != torch.bfloat16:
        raise ValueError("fused_render: feat must be bfloat16")
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


def _render_fwd(ws, bs, feat, basis16, z, noise, noise_sel, depth, skips, s, nb,
                with_noise, emit_wsel, white_back):
    """The forward on the bf16 layer weights: plain on CPU tensors, the
    kernel on CUDA tensors (inputs already checked)."""
    if feat.device.type == "cpu":
        return _render_plain_flat(ws, bs, feat, basis16, z, noise, noise_sel, depth, skips,
                                  s, nb, with_noise, emit_wsel, white_back)
    rays, enc = basis16.shape[0], feat.shape[1]
    _keep, skip_mask, width, head0, wp, bp = launch_args_flat(ws, bs, skips, feat.device)
    ws_fn, fn = _fwd_fns()
    # the weight images (written anew by every call: the weights may have
    # been updated in place since the last) and the [P, 8] rows of the MLP
    # and shading, which the composite reads
    work = torch.empty(max(ws_fn(rays, s, enc, depth, skip_mask, width, head0), 1),
                       dtype=torch.uint8, device=feat.device)
    ray_out = torch.empty((rays, 8), dtype=torch.float32, device=feat.device)
    wsel = (torch.empty((rays, s), dtype=torch.float32, device=feat.device)
            if emit_wsel else None)
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    err = fn(feat.data_ptr(), basis16.data_ptr(), z.data_ptr(), _ptr(noise), _ptr(noise_sel),
             ray_out.data_ptr(), _ptr(wsel), work.data_ptr(), rays, s, nb, int(white_back), enc,
             depth, skip_mask, width, head0, wp, bp, stream)
    if err:
        raise RuntimeError(f"fused_render kernel launch failed: CUDA error {err}")
    fused_render.launches += 1
    return ray_out, wsel


def _bwd_shapes(ws, bs):
    return [tuple(w.shape) for w in ws], [tuple(b.shape) for b in bs]


def render_bwd_points(ws, bs, feat, basis16, z, noise, dray, depth, skips, s, nb,
                      white_back, workspace) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch stage 1 of ``csrc/fused_render_bwd.cu`` into ``workspace``:
    the recompute, the composite backward's dout8, then the shading and
    MLP backward per point (``fused_shaded_mlp``'s points stage; bias
    partials, the per-ray dbasis sums), one call counted as one launch.
    Returns (dfeat [rays*s, E] fp32, dbasis [rays, 16] fp32)."""
    rays, enc = basis16.shape[0], feat.shape[1]
    _keep, skip_mask, width, head0, wp, bp = launch_args_flat(ws, bs, skips, feat.device)
    dfeat = torch.empty((rays * s, enc), dtype=torch.float32, device=feat.device)
    dbasis = torch.empty((rays, BASIS_LANES), dtype=torch.float32, device=feat.device)
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    err = _bwd_fns()[1](feat.data_ptr(), basis16.data_ptr(), z.data_ptr(), _ptr(noise),
                        dray.data_ptr(), dfeat.data_ptr(), dbasis.data_ptr(),
                        workspace.data_ptr(), rays, s, nb, int(white_back), enc, depth,
                        skip_mask, width, head0, wp, bp, stream)
    if err:
        raise RuntimeError(f"render_bwd_points kernel launch failed: CUDA error {err}")
    render_bwd_points.launches += 1
    return dfeat, dbasis


def render_bwd_weights(ws, bs, feat, rays, s, skips, workspace):
    """Launch stage 2 of ``csrc/fused_render_bwd.cu``: every layer's
    weight and bias gradient summed over all points (split-K partials,
    reduced in a fixed order), from the workspace stage 1 filled.
    Returns (dws, dbs) fp32 in the shapes of ``ws``/``bs``."""
    w_shapes, b_shapes = _bwd_shapes(ws, bs)
    depth = len(ws) - 2
    width, head0 = ws[0].shape[1], ws[-2].shape[1]
    skip_mask = sum(1 << i for i in skips)
    dw = torch.empty(sum(a * b for a, b in w_shapes), dtype=torch.float32, device=feat.device)
    db = torch.empty(sum(a * b for a, b in b_shapes), dtype=torch.float32, device=feat.device)
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    err = _bwd_fns()[2](feat.data_ptr(), workspace.data_ptr(), dw.data_ptr(), db.data_ptr(),
                        rays, s, feat.shape[1], depth, skip_mask, width, head0, stream)
    if err:
        raise RuntimeError(f"render_bwd_weights kernel launch failed: CUDA error {err}")
    render_bwd_weights.launches += 1
    return (list(torch.split(dw, [a * b for a, b in w_shapes])),
            list(torch.split(db, [a * b for a, b in b_shapes])))


def fused_render_bwd(ws, bs, feat, basis16, z, noise, dray, depth, skips, s, nb,
                     with_noise, white_back=True):
    """The backward of :func:`fused_render` on the bf16 layer weights:
    :func:`fused_render_bwd_plain` on CPU tensors, the two launches of
    ``csrc/fused_render_bwd.cu`` on CUDA tensors.  Same returns as
    :func:`fused_render_bwd_plain`."""
    skips = tuple(skips)
    noise = noise if with_noise else None
    if feat.device.type == "cpu":
        return fused_render_bwd_plain(ws, bs, feat, basis16, z, noise, dray, depth, skips,
                                      s, nb, with_noise, white_back)
    rays = basis16.shape[0]
    _check_cuda_inputs(feat, basis16, z, noise, None, rays, s)
    if dray.dtype != torch.float32 or tuple(dray.shape) != (rays, 8) \
            or not dray.is_contiguous() or dray.device != feat.device:
        raise ValueError(f"fused_render_bwd: dray must be contiguous float32 [{rays}, 8]")
    enc, width, head0 = feat.shape[1], ws[0].shape[1], ws[-2].shape[1]
    nbytes = _bwd_fns()[0](rays, s, enc, depth, sum(1 << i for i in skips), width, head0)
    workspace = torch.empty(max(nbytes, 1), dtype=torch.uint8, device=feat.device)
    dfeat, dbasis = render_bwd_points(ws, bs, feat, basis16, z, noise, dray, depth, skips,
                                      s, nb, white_back, workspace)
    dws, dbs = render_bwd_weights(ws, bs, feat, rays, s, skips, workspace)
    w_shapes, b_shapes = _bwd_shapes(ws, bs)
    return ([g.view(sh) for g, sh in zip(dws, w_shapes)],
            [g.view(sh) for g, sh in zip(dbs, b_shapes)], dfeat, dbasis)


render_bwd_points.launches = 0
render_bwd_weights.launches = 0


class _FusedRender(torch.autograd.Function):
    """The custom VJP of ``fused_render.py:649-716``: the forward launch,
    and the backward kernels on the same bf16 weight copy, cast once."""

    @staticmethod
    def forward(ctx, meta, feat, basis16, z, noise, noise_sel, *leaves):
        depth, skips, s, nb, with_noise, emit_wsel, white_back = meta
        ws, bs = _flat_weights(PackedMLP(leaves[:depth], leaves[depth:2 * depth],
                                         *leaves[2 * depth:]))
        ray_out, wsel = _render_fwd(ws, bs, feat, basis16, z, noise, noise_sel, depth, skips,
                                    s, nb, with_noise, emit_wsel, white_back)
        ctx.meta = meta
        ctx.leaf_meta = [(t.shape, t.dtype) for t in leaves]
        ctx.save_for_backward(feat, basis16, z, noise, *ws, *bs)
        if wsel is not None:
            ctx.mark_non_differentiable(wsel)
        return ray_out, wsel

    @staticmethod
    def backward(ctx, dray, _dwsel):
        depth, skips, s, nb, with_noise, _emit, white_back = ctx.meta
        feat, basis16, z, noise, *flat = ctx.saved_tensors
        ws, bs = flat[:depth + 2], flat[depth + 2:]
        dws, dbs, dfeat, dbasis = fused_render_bwd(
            ws, bs, feat, basis16, z, noise, dray.contiguous(), depth, skips, s, nb,
            with_noise, white_back)
        grads = [*dws[:depth], *dbs[:depth], dws[depth], dbs[depth], dws[depth + 1],
                 dbs[depth + 1]]
        need = ctx.needs_input_grad
        leaf_grads = [g.reshape(shape).to(dtype) if need[6 + i] else None
                      for i, (g, (shape, dtype)) in enumerate(zip(grads, ctx.leaf_meta))]
        return (None, dfeat.to(feat.dtype) if need[1] else None,
                dbasis.to(basis16.dtype) if need[2] else None, None, None, None, *leaf_grads)


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
    """Differentiable fused render: encode-order feat -> per-ray outputs.

    Args:
      packed: full (sigma+SH) kernel weights: bf16 for eval, fp32 leaves
        (a differentiable ``pack_mlp_params(..., dtype=float32)``) for
        training; the kernels read a bf16 copy cast once per call.
      feat: [rays * s, 4+6L] encoded points, ray-major (bf16 on CUDA).
      basis16: [rays, 16] fp32 SH basis padded to 16 lanes.
      z: [rays, s] sorted fp32 sample depths (no gradient).
      noise / noise_sel: [rays, s] fp32 N(0,1) draws (training) or None;
        read only when ``with_noise`` (and ``emit_wsel`` for noise_sel).
      s: samples per ray, >= 2 (on CUDA tensors also <= :func:`max_samples`
        and, under autograd, :func:`max_samples_bwd`: both 2**31 - 1, no
        limit); nb: (sh_deg+1)^2 <= 9.
      with_noise: noisy rgb weights with a separate noise-free
        depth/opacity path.  emit_wsel: also return the selection weights
        (from noise_sel under ``with_noise``, else the noise-free ones;
        stop-gradient).

    Returns:
      (ray_out [rays, 8] fp32 — rgb(3), depth, opacity, 3 zeros;
       wsel [rays, s] fp32 or None).  CPU tensors take the plain versions,
      forward and backward; CUDA tensors launch ``csrc/fused_render.cu``
      (counted as one launch per call, whatever it launches inside) and,
      in the backward, ``csrc/fused_render_bwd.cu``.
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
    leaves = (*packed.trunk_w, *packed.trunk_b, packed.head_w0, packed.head_b0,
              packed.head_w1, packed.head_b1)
    if feat.device.type != "cpu":
        _check_cuda_inputs(feat, basis16, z, noise, noise_sel, rays, s)
        if s > max_samples(packed):
            raise ValueError(f"fused_render: s={s} exceeds the forward kernels' "
                             f"ceiling of {max_samples(packed)} samples per ray")
        grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in (feat, basis16, *leaves))
        if grad and s > max_samples_bwd(packed):
            raise ValueError(f"fused_render: s={s} exceeds the backward kernel's "
                             f"ceiling of {max_samples_bwd(packed)} samples per ray")
    meta = (depth, skips, s, nb, with_noise, emit_wsel, white_back)
    return _FusedRender.apply(meta, feat, basis16, z, noise, noise_sel, *leaves)


fused_render.launches = 0


@torch.no_grad()
def fused_render_rays(packed: PackedMLP, rays_o: torch.Tensor, rays_d: torch.Tensor,
                      basis16: torch.Tensor, z: torch.Tensor, depth: int, skips: Sequence[int],
                      s: int, nb: int, white_back: bool = True) -> torch.Tensor:
    """The eval form of :func:`fused_render` (no noise, no wsel) on the
    points ``o + d z`` of rays_o, rays_d [R, 3] and depths z [R, s]:
    ray_out [R, 8] fp32, the same bits as ``fused_render(packed,
    encode_kernel_order(points), basis16, z, None, None, ..., False,
    False, white_back)[0]``.  CUDA tensors launch ``csrc/fused_render.cu``'s
    ``mcn_fused_render_rays`` (one launch a call), the encode in the
    kernel; CPU tensors the plain version on the encode's features.  No
    autograd (``ops/cuda/fused_mlp.py`` says why)."""
    skips = tuple(skips)
    rays = _check_rays("fused_render_rays", rays_o, rays_d, z, s, basis16=basis16)
    if rays_o.device.type == "cpu":
        return fused_render(packed, _glue_feat(packed, rays_o, rays_d, z), basis16, z, None,
                            None, depth, skips, s, nb, False, False, white_back)[0]
    _check_mlp_args(packed, None, depth, skips)
    pack_freqs(packed)
    if s < 2 or not 1 <= nb <= 9:
        raise ValueError(f"fused_render_rays takes s >= 2 and 1 <= nb <= 9; got s={s}, nb={nb}")
    if tuple(basis16.shape) != (rays, BASIS_LANES):
        raise ValueError(f"fused_render_rays: basis16 {tuple(basis16.shape)} is not "
                         f"[{rays}, {BASIS_LANES}]")
    ws, bs = _flat_weights(packed)
    enc = ws[0].shape[0]
    _keep, skip_mask, width, head0, wp, bp = launch_args_flat(ws, bs, skips, rays_o.device)
    work = torch.empty(max(_fwd_fns()[0](rays, s, enc, depth, skip_mask, width, head0), 1),
                       dtype=torch.uint8, device=rays_o.device)
    ray_out = torch.empty((rays, 8), dtype=torch.float32, device=rays_o.device)
    stream = torch.cuda.current_stream(rays_o.device).cuda_stream
    err = _rays_fn()(*ray_args(rays_o, rays_d, z), basis16.data_ptr(), ray_out.data_ptr(),
                     work.data_ptr(), rays, s, nb, int(white_back), enc, depth, skip_mask, width,
                     head0, wp, bp, stream)
    if err:
        raise RuntimeError(f"fused_render_rays kernel launch failed: CUDA error {err}")
    trace.count("encode.kernel")
    fused_render_rays.launches += 1
    return ray_out


fused_render_rays.launches = 0


def _rays_fn():
    fn = _lib("fused_render").mcn_fused_render_rays
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn
