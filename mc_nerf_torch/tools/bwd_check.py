"""What the checks of the backward kernels share (``chip_smoke.py``,
``tests/test_torch_gpu.py``): loss-shaped cotangents, the relative L2
error of each output, planted faults of the plain backwards, each of
which a check must see, the work the MLP needs and the bytes the
backward's two stages move.

The plants that sit inside a plain version (the composite's prefix sums
in the forward, or its suffix sums in the backward, taken one sample late, the skip layers' share of dfeat dropped, the
sigmoid's derivative dropped on one channel, dW without the last tile of
points) swap one of its helpers for the length of one call; the
package's functions carry no fault switch.
"""

from __future__ import annotations

from typing import Dict
from unittest import mock

import torch

from mc_nerf_torch.ops.cuda import fused_mlp as _fm
from mc_nerf_torch.ops.cuda import fused_render as _fr

_SUFFIX, _SPLIT, _SHADE = _fr._exclusive_suffix_sum, _fm._split_skip_grad, _fm._shade_grad
_PREFIX = _fr._exclusive_cumsum
_WGRAD, _BGRAD, _MASKS = _fm._weight_grad, _fm._bias_grad, _fm._trunk_masks
WEIGHT_TILE = 64   # points per stage of the weight-gradient kernel (csrc/mlp_bwd.cuh WKT)
POINTS_TILE = 128  # points per tile of the points stage (csrc/mlp_bwd_points.cuh)
# A backward's weight and bias sums under last_tile_cotangent against the
# plain version's (relative L2): with 64 points left, one bf16 rounding or
# ReLU mask that falls the other way moves them more than a loss over all
# points does, so the bound is its own: ~10x the largest measured on an
# H100 over tests/test_torch_gpu.py's cases (dW 6.7e-3, db 5.1e-3, last
# layer 2.7e-4, PERF.md); the plants land at exactly 1
LAST_TILE_TOL = {"dW": 7e-2, "db": 7e-2, "last layer": 3e-3}


def mse_cotangent(ray_out: torch.Tensor, far: float) -> torch.Tensor:
    """d loss / d ray_out [rays, 8] of an MSE of the rendered rays against a
    white image, the far plane's depth and full opacity (depth scaled by
    1 / far), averaged over rays and the 5 columns.  Every residual is <= 0
    (rgb <= 1 under the white background, depth <= far, opacity <= 1), so
    the sums over points that make the weight gradients add up the way a
    real rgb loss's do instead of cancelling, as N(0, 1) cotangents would."""
    rays = ray_out.shape[0]
    out = ray_out[:, :5].detach().float()
    scale = torch.ones(5, device=out.device)
    scale[3] = 1.0 / far
    target = torch.ones(5, device=out.device)
    target[3] = far
    dray = torch.zeros((rays, 8), dtype=torch.float32, device=out.device)
    dray[:, :5] = 2.0 * (out - target) * scale * scale / (5 * rays)
    return dray


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b||, in float64."""
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-300))


def shaded_cotangent(out8: torch.Tensor, s: int) -> torch.Tensor:
    """d loss / d out8 [P, 8] of a loss on a shaded MLP's outputs shaped as
    a render's: an MSE of the per-ray mean rgb against white (rgb residuals
    of one sign, so the weight gradients add up) and of the per-ray mean
    softplus(sigma) against 1, averaged over rays and 4 columns; lanes 4..7
    get 0."""
    p = out8.shape[0]
    rays = p // s
    o = out8.detach().float().reshape(rays, s, 8)
    d = torch.zeros((rays, s, 8), dtype=torch.float32, device=out8.device)
    rgb_res = o[..., 1:4].mean(1, keepdim=True) - 1.0
    d[..., 1:4] = (2.0 * rgb_res / (4 * rays * s)).expand(rays, s, 3)
    sp = torch.nn.functional.softplus(o[..., 0])
    d[..., 0] = 2.0 * (sp.mean(1, keepdim=True) - 1.0) * torch.sigmoid(o[..., 0]) / (4 * rays * s)
    return d.reshape(p, 8)


def mlp_cotangent(out32: torch.Tensor) -> torch.Tensor:
    """d loss / d out32 [P, 32] of an MSE of the packed output's 28 live
    lanes (sigma and 27 SH) against 1 (one-sign residuals, as a render's
    loss gives), averaged; lanes 28..31 get 0."""
    p = out32.shape[0]
    d = torch.zeros((p, 32), dtype=torch.float32, device=out32.device)
    d[:, :28] = 2.0 * (out32.detach().float()[:, :28] - 1.0) / (28 * p)
    return d


def bwd_errs(k, ref) -> Dict[str, float]:
    """Relative L2 error of each output of the backward against a
    reference: the worst weight and the worst bias of every layer but the
    last, the last layer's (the worse of its weight and bias), dfeat and
    (where the backward has one) dbasis.  L2, not max: a ReLU mask or a bf16 rounding that falls the
    other way moves a few entries a lot, and fp32 sums in another order
    alone do that; in a deep trunk each such flip moves the layers below
    it.  The last layer's gradients (h1^T dout and the fp32 sum of dout)
    sit before that cascade: they see the composite and shading backward
    at the fp32 noise of their own sums."""
    dws, dbs, dfeat = k[:3]
    if not all(bool(torch.isfinite(t).all()) for t in (*dws, *dbs, *k[2:])):
        raise AssertionError("the backward's output is not finite")
    errs = {"dW": max(rel_l2(a, b) for a, b in zip(dws[:-1], ref[0][:-1])),
            "db": max(rel_l2(a, b) for a, b in zip(dbs[:-1], ref[1][:-1])),
            "last layer": max(rel_l2(dws[-1], ref[0][-1]), rel_l2(dbs[-1], ref[1][-1])),
            "dfeat": rel_l2(dfeat, ref[2])}
    if len(k) > 3:
        errs["dbasis"] = rel_l2(k[3], ref[3])
    return errs


def _suffix_late(x: torch.Tensor) -> torch.Tensor:
    s = _SUFFIX(x)
    return torch.cat([s[:, 1:], torch.zeros_like(s[:, :1])], 1)


def mixed_in_tiles(out: torch.Tensor) -> torch.Tensor:
    """The rows of every full 128-point tile (of all rows, below 128) in
    reverse order: points mixed up inside a tile."""
    tile = min(POINTS_TILE, out.shape[0])
    n = out.shape[0] // tile * tile
    return torch.cat([out[:n].view(-1, tile, out.shape[1]).flip(1).reshape(n, -1), out[n:]])


def pair_swapped(out: torch.Tensor) -> torch.Tensor:
    """The rows of every pair of consecutive 128-point tiles swapped (of
    halves of the rows, from 2 to 255 rows): neighbouring tiles written to
    each other's rows, as a block or a pair of blocks that took the wrong
    tile would."""
    tile = POINTS_TILE if out.shape[0] >= 2 * POINTS_TILE else out.shape[0] // 2
    n = out.shape[0] // (2 * tile) * 2 * tile
    return torch.cat([out[:n].view(-1, 2, tile, out.shape[1]).flip(1).reshape(n, -1), out[n:]])


def _prefix_late(x: torch.Tensor) -> torch.Tensor:
    p = _PREFIX(x)
    return torch.cat([torch.zeros_like(p[:, :1]), p[:, :-1]], 1)


def render_scan_late(*args):
    """``fused_render_plain(*args)`` with the composite's exclusive prefix
    sums taken one sample late (each sample's transmittance misses the
    sample before it): a scan shifted by one, which a check of the forward
    must see."""
    with mock.patch.object(_fr, "_exclusive_cumsum", _prefix_late):
        return _fr.fused_render_plain(*args)


def _skip_share_dropped(d_xin: torch.Tensor, e_lanes: int):
    share, d_h = _SPLIT(d_xin, e_lanes)
    return torch.zeros_like(share), d_h


def _shade_grad_dropped(dout_rgb: torch.Tensor, sig: torch.Tensor) -> torch.Tensor:
    g = _SHADE(dout_rgb, sig)
    return torch.cat([dout_rgb[..., :1], g[..., 1:]], -1)


def _last_tile_dropped(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    keep = (x.shape[0] - 1) // WEIGHT_TILE * WEIGHT_TILE
    return _WGRAD(x[:keep], d[:keep])


def last_tile_cotangent(d: torch.Tensor, per: int = 1) -> torch.Tensor:
    """``d`` with its rows zeroed outside the last WEIGHT_TILE-point tile
    (the ragged one where the count is not a multiple of it).  Rows are
    points (``per`` 1) or rays of ``per`` points each, a ray kept where
    any of its points lies in that tile.  Under this cotangent dW comes
    from that tile alone (for K5 and K6 exactly; for a ray-level one from
    the rays that reach it), so :func:`planted_last_tile` lands far
    outside any tolerance at any point count."""
    first = (d.shape[0] * per - 1) // WEIGHT_TILE * WEIGHT_TILE
    keep = torch.zeros(d.shape[0], dtype=d.dtype, device=d.device)
    keep[first // per:] = 1
    return d * keep[:, None]


def planted_last_tile(fn, args, ref) -> Dict[str, float]:
    """:func:`bwd_errs` against ``ref`` of the plain backward ``fn`` on
    ``args`` whose every dW leaves out the points of the last WEIGHT_TILE
    tile (the ragged one where the count is not a multiple of it): the
    edge a split-K weight kernel most often drops."""
    with mock.patch.object(_fm, "_weight_grad", _last_tile_dropped):
        return bwd_errs(fn(*args), ref)


def weight_stage_bytes(enc: int, depth: int, width: int, skips, head0: int,
                       points: int) -> int:
    """The bytes the weight-gradient stage must move at this pack and point
    count, over the jobs ``launch_weight_grads`` runs (``weight_jobs`` in
    ``csrc/mlp_bwd.cuh``): each job's X and D rows read once (bf16), every layer's fp32 dW
    written once.  Per layer l: (feat [P, enc] or h[l-1] [P, width]) with
    d_a[l] [P, width], a skip layer as two jobs (feat and h[l-1], each with
    d_a[l]); head 0: h[depth-1] with d_h1 [P, head0]; head 1: h1 [P, head0]
    with dout [P, 32]."""
    jobs = []
    for layer in range(depth):
        if layer == 0 or layer in skips:
            jobs.append((enc, width))
        if layer > 0:
            jobs.append((width, width))
    jobs += [(width, head0), (head0, 32)]
    # each job's [m, n] block of the flat dW is written once, in fp32
    return sum(2 * (m + n) * points + 4 * m * n for m, n in jobs)


def _masks_shifted(xins, h_last, widths):
    m = _MASKS(xins, h_last, widths)
    return [m[max(li - 1, 0)] for li in range(len(m))]


def _bias_last_tile_dropped(d: torch.Tensor) -> torch.Tensor:
    keep = (d.shape[0] - 1) // POINTS_TILE * POINTS_TILE
    return _BGRAD(d[:keep])


def planted_points(fn, args, ref) -> Dict[str, Dict[str, float]]:
    """The points stage's own plants on the plain backward ``fn`` (K5's or
    K6's) at ``args``: each trunk layer l > 0 masked with layer l - 1's
    ReLU mask, and every bias gradient without the points of the last
    128-point tile (the ragged one where the count is not a multiple of
    it), the partials a persistent tile loop most often drops.  The
    second shows at any point count under :func:`last_tile_cotangent`."""
    with mock.patch.object(_fm, "_trunk_masks", _masks_shifted):
        shifted = bwd_errs(fn(*args), ref)
    with mock.patch.object(_fm, "_bias_grad", _bias_last_tile_dropped):
        dropped = bwd_errs(fn(*args), ref)
    return {"a layer masked with the one below's": shifted,
            "bias partials of the last tile dropped": dropped}


def workspace_acts(work: torch.Tensor, feat: torch.Tensor, depth: int, skips, width: int,
                   head0: int):
    """The recompute's activations as a K5 or K6 backward left them in its
    workspace ``work`` (``make_layout`` in ``csrc/mlp_bwd.cuh``: h [depth,
    P, width] at byte 0, then h1 [P, head0] at the next 256-byte boundary,
    bf16): (xins, h_last, h1) for the plain backwards' ``acts``, float32.
    The plain backward from these runs on the kernel's own bf16
    activations, so that a value its fp32 sums round the other way (a ReLU
    mask flipped between the two) does not stand between them."""
    p = feat.shape[0]
    n_h = 2 * p * depth * width
    h = work[:n_h].view(torch.bfloat16).view(depth, p, width).float()
    at = (n_h + 255) // 256 * 256
    h1 = work[at:at + 2 * p * head0].view(torch.bfloat16).view(p, head0).float()
    f = feat.to(torch.bfloat16).float()
    xins = [f] + [torch.cat([f, h[i - 1]], 1) if i in skips else h[i - 1]
                  for i in range(1, depth)]
    return xins, h[depth - 1], h1


def needed_macs(nc, depth: int, width: int, skips, sigma_only: bool) -> int:
    """Multiply-adds per point that the MLP needs: the 3 + 6L real encode
    lanes (not the pack's pad lane) at layer 0 and at each skip, the trunk,
    head layer 0, and of the packed last head layer only its live blocks
    (the sigma column; with SH also the SH block), not its zeros."""
    enc = nc.embed_dim
    trunk = sum(((enc if i == 0 else width) + (enc if i in skips else 0)) * width
                for i in range(depth))
    heads = width * width + width if sigma_only else width * 2 * width + width * (1 + nc.sh_dim)
    return trunk + heads


BIAS_GROUPS = 132   # bias-partial groups of the points stage (csrc/mlp_bwd_points.cuh)
GROUP_ROWS = 8      # bias-partial rows per group: one per consumer warp


def points_stage_images(enc: int, depth: int, width: int, skips, head0: int,
                        shaded: bool, recompute_only: bool = False) -> int:
    """Bytes of the points stage's weight images (``pt_schedule`` in
    ``csrc/mlp_bwd_points.cuh``): every product of a tile's schedule as
    32-row K tiles x its columns, bf16.  The recompute: each trunk layer
    (K: the encode padded to 32, plus the width at a skip, or the width;
    N: the width), head layer 0 in passes of 128 columns where head0 > 128
    (else one pass), each followed for K5 by its head-layer-1 share (K: the
    pass, N: 32); the backward: d_h1 in passes of up to 256 (K 32), head
    layer 0 (K head0, N the width), then from the top trunk layer down its
    feature rows (layer 0 and the skips; K the width, N the encode rounded
    up to 32, 64, 128 or 256) and its hidden rows (layers above 0).
    ``recompute_only``: the recompute's products alone."""
    ep = (enc + 31) // 32 * 32
    enc_nc = next(n for n in (32, 64, 128, 256) if enc <= n)
    nch = 128 if head0 > 128 else head0
    prods = []
    for layer in range(depth):
        tf = layer == 0 or layer in skips
        prods.append((ep if layer == 0 else (ep + width if tf else width), width))
    for c0 in range(0, head0, nch):
        prods.append((width, min(nch, head0 - c0)))
        if shaded:
            prods.append((min(nch, head0 - c0), 32))
    if recompute_only:
        return sum((k + 31) // 32 * 32 * n * 2 for k, n in prods)
    prods += [(32, min(256, head0 - c0)) for c0 in range(0, head0, 256)]
    prods.append((head0, width))
    for layer in reversed(range(depth)):
        if layer == 0 or layer in skips:
            prods.append((width, enc_nc))
        if layer > 0:
            prods.append((width, width))
    return sum((k + 31) // 32 * 32 * n * 2 for k, n in prods)


def points_stage_bytes(enc: int, depth: int, width: int, skips, head0: int, points: int,
                       shaded: bool = False, s: int = 1, tiles=None) -> int:
    """The bytes the points stage of K5 (``shaded``, ``s`` points per ray)
    or K6 moves at this pack and point count, as ``csrc/mlp_bwd_points.cuh``
    reads and writes them, each once: feat (bf16) and the cotangent
    (dout8 [P, 8] and the rays' basis [P / s, 16] for K5, dout [P, 32] for
    K6, fp32) read; the recompute's h [depth, P, width] and h1 [P, head0]
    and the backward's dout_b [P, 32], d_a [depth, P, width] and d_h1
    [P, head0] written (bf16); dfeat [P, enc] written (fp32); the bias
    partials (min(tiles, BIAS_GROUPS) groups of GROUP_ROWS rows, fp32)
    written; the weights and biases read (bf16) and the weight images
    (:func:`points_stage_images`) written and read.  K5 also writes the
    per-point dbasis partials [P, 16] (fp32), which the per-ray sum reads
    back before writing dbasis [P / s, 16].  ``tiles``: the stage's tiles,
    128 points each where not given."""
    tiles = (points + 127) // 128 if tiles is None else tiles
    nbias = depth * width + head0 + 32
    w_in = sum(((enc if i == 0 else width) + (enc if i in skips else 0)) * width
               for i in range(depth)) + width * head0 + head0 * 32
    per_point = 2 * enc + 2 * (2 * depth * width + 2 * head0 + 32) + 4 * enc
    per_point += (8 * 4 + 2 * 16 * 4) if shaded else 32 * 4
    per_ray = 2 * 16 * 4 if shaded else 0
    return (per_point * points + per_ray * (points // s)
            + min(tiles, BIAS_GROUPS) * GROUP_ROWS * nbias * 4 + 2 * (w_in + nbias)
            + 2 * points_stage_images(enc, depth, width, skips, head0, shaded))


def _forward_weight_bytes(enc: int, depth: int, width: int, skips, head0: int) -> int:
    """The bytes of weights a forward on the ring moves: the pack's weights
    and biases read (bf16), and the recompute's weight images
    (:func:`points_stage_images`, recompute only) written and read."""
    w_in = sum(((enc if i == 0 else width) + (enc if i in skips else 0)) * width
               for i in range(depth)) + width * head0 + head0 * 32
    nbias = depth * width + head0 + 32
    return 2 * (w_in + nbias) + 2 * points_stage_images(enc, depth, width, skips, head0, True,
                                                        recompute_only=True)


def shaded_forward_bytes(enc: int, depth: int, width: int, skips, head0: int, points: int,
                         s: int) -> int:
    """The bytes K4 (``fused_shaded_mlp``'s forward, ``csrc/fused_shaded.cu``)
    moves at this pack and point count, each once: feat (bf16) and the rays'
    basis [P / s, 16] (fp32) read, the output [P, 8] (fp32) written, and the
    weights (:func:`_forward_weight_bytes`)."""
    return (2 * enc * points + 16 * 4 * (points // s) + 8 * 4 * points
            + _forward_weight_bytes(enc, depth, width, skips, head0))


def render_forward_bytes(enc: int, depth: int, width: int, skips, head0: int, points: int,
                         s: int, draws: int = 0, wsel: bool = False) -> int:
    """The bytes K2 (``fused_render``'s forward, ``csrc/fused_render.cu``)
    moves at this pack and point count, each once: feat (bf16), the rays'
    basis [P / s, 16], z [P] and ``draws`` noise draws [P] (noise, and
    noise_sel with wsel; fp32) read, ray_out [P / s, 8] and, with ``wsel``,
    wsel [P] written (fp32), the weights (:func:`_forward_weight_bytes`),
    and the round trip between its two kernels: the forward's [P, 8] fp32
    rows written, and the 32-byte sector of each that holds sigma and rgb
    read back by the composite (64 bytes a point)."""
    rays = points // s
    return (2 * enc * points + 16 * 4 * rays + 4 * (1 + draws) * points + 8 * 4 * rays
            + (4 * points if wsel else 0) + 64 * points
            + _forward_weight_bytes(enc, depth, width, skips, head0))


def mlp_forward_bytes(enc: int, depth: int, width: int, skips, head0: int, points: int) -> int:
    """The bytes K1 (``fused_mlp_apply``, ``csrc/fused_mlp.cu``) moves at
    this pack (sigma-only: head0 = width) and point count, each once: feat
    (bf16) read, the raw rows [P, 32] (fp32) written, and the weights
    (:func:`_forward_weight_bytes`)."""
    return (2 * enc * points + 32 * 4 * points
            + _forward_weight_bytes(enc, depth, width, skips, head0))


def forward_l2_bytes_per_point(enc: int, depth: int, width: int, skips, head0: int,
                               rows_per_read: int) -> float:
    """Bytes of weight images that K4's ring brings from L2 into shared
    memory per point, when one read of the recompute's images
    (:func:`points_stage_images`, recompute only) serves ``rows_per_read``
    points: 128 for a block's tile, 256 for a 2-CTA cluster whose weight
    slots are multicast into both blocks."""
    return points_stage_images(enc, depth, width, skips, head0, True,
                               recompute_only=True) / rows_per_read


RAY_ROWS = 64   # rows of a warpgroup of K3's fused path (csrc/fused_render_bwd.cu)


def render_fused_rays(s: int) -> int:
    """Rays per warpgroup of K3's fused path, or 0 for its composed path, as
    ``fused_rays`` in ``csrc/fused_render_bwd.cu`` picks them: fused where
    whole rays of s samples fill at least 7/8 of RAY_ROWS rows."""
    k = RAY_ROWS // s if s <= RAY_ROWS else 0
    return k if 8 * k * s >= 7 * RAY_ROWS else 0


def render_points_stage_bytes(enc: int, depth: int, width: int, skips, head0: int,
                              points: int, s: int) -> int:
    """The bytes K3's points stage (``render_bwd_points``) moves at this
    pack, ``points`` points and ``s`` samples per ray, with noise, each
    once.  The fused path (:func:`render_fused_rays` k > 0: one launch,
    tiles of 2k whole rays): K5's points stage (:func:`points_stage_bytes`,
    shaded, over those tiles) without its dout8 read, plus the composite's
    inputs z and the noise [P] and dray [P / s, 8] (fp32); dout8 lives in
    shared memory.  The composed path (over one set of weight images): the
    forward (K4's kernel, ``csrc/shaded_fwd.cuh``) reads feat (bf16), the
    rays' basis [P / s, 16] and the recompute's weight images, and writes
    rows of [P, 8] (fp32: sigma, rgb and four zeros); the composite
    backward reads sigma and rgb, z, the noise and dray, writes its two
    prefix sums [P, 2] and reads them back, and writes dout8 [P, 4] over
    sigma and rgb; then K5's points stage from that dout8."""
    rays = points // s
    inputs = 2 * 4 * points + 8 * 4 * rays   # z and noise, dray
    k = render_fused_rays(s)
    if k:
        return inputs - 8 * 4 * points + points_stage_bytes(
            enc, depth, width, skips, head0, points, True, s, tiles=-(-rays // (2 * k)))
    fwd = 2 * enc * points + 16 * 4 * rays + 8 * 4 * points + points_stage_images(
        enc, depth, width, skips, head0, True, recompute_only=True)
    composite = inputs + 4 * 4 * points + 2 * 2 * 4 * points + 4 * 4 * points
    return fwd + composite + points_stage_bytes(enc, depth, width, skips, head0, points, True, s)


def _weight_plants(ref, depth: int) -> Dict[str, Dict[str, float]]:
    """The last trunk layer's dW written transposed, layer 1's dW zeroed,
    and (given two points or more) the rows of dfeat mixed up: reversed in
    each 128-point tile, or over all points below 128."""
    dws, dfeat = ref[0], ref[2]
    last = depth - 1
    dws_t = list(dws)
    dws_t[last] = dws[last].t().reshape(dws[last].shape)
    dws_z = list(dws)
    dws_z[1] = torch.zeros_like(dws[1])
    tile = min(128, dfeat.shape[0])
    n = dfeat.shape[0] // tile * tile
    mixed = torch.cat([dfeat[:n].reshape(-1, tile, dfeat.shape[1]).flip(1).reshape(n, -1),
                       dfeat[n:]])
    plants = {"a layer's dW transposed": bwd_errs((dws_t, *ref[1:]), ref),
              "a layer's dW zeroed": bwd_errs((dws_z, *ref[1:]), ref)}
    if dfeat.shape[0] > 1:
        plants["points mixed in a tile"] = bwd_errs((dws, ref[1], mixed, *ref[3:]), ref)
    return plants


def _skip_plant(fn, args, ref) -> Dict[str, float]:
    with mock.patch.object(_fm, "_split_skip_grad", _skip_share_dropped):
        return bwd_errs(fn(*args), ref)


def dout8_moved(dout8: torch.Tensor, s: int) -> torch.Tensor:
    """``dout8`` [rays * s, 8] with, in every ray, the row of the sample of
    the largest |d sigma| swapped with its neighbour's (the next sample's;
    the last sample's with the one before): a composite that writes one
    sample's cotangent one row off."""
    d = dout8.reshape(-1, s, dout8.shape[1]).clone()
    r = torch.arange(d.shape[0], device=d.device)
    j = d[..., 0].abs().argmax(1)
    k = torch.where(j == s - 1, j - 1, j + 1)
    dj, dk = d[r, j].clone(), d[r, k].clone()
    d[r, j], d[r, k] = dk, dj
    return d.reshape(dout8.shape)


def planted_dout8_moved(args, ref) -> Dict[str, float]:
    """:func:`bwd_errs` against ``ref`` of K3's plain decomposition
    (``render_composite_bwd_plain`` on the plain forward's sigma and rgb,
    then ``fused_shaded_mlp_bwd_plain``) on ``args`` of
    ``fused_render_bwd_plain``, with :func:`dout8_moved` between the two."""
    ws, bs, feat, basis16, z, noise, dray, depth, skips, s, nb, with_noise, white_back = args
    rays = basis16.shape[0]
    out8 = _fm._shaded_plain_flat(ws, bs, feat, basis16, depth, skips, s, nb).reshape(rays, s, 8)
    dout8 = _fr.render_composite_bwd_plain(out8[..., 0], out8[..., 1:4], z,
                                           noise if with_noise else None, dray, white_back)
    return bwd_errs(_fm.fused_shaded_mlp_bwd_plain(ws, bs, feat, basis16, dout8_moved(dout8, s),
                                                   depth, skips, s, nb), ref)


def planted_errs(args, ref) -> Dict[str, Dict[str, float]]:
    """For ``args`` of ``fused_render_bwd_plain`` and ``ref`` its result:
    :func:`bwd_errs` of each planted fault against ``ref``: the last trunk
    layer's dW written transposed, layer 1's dW zeroed, dfeat's points
    mixed in a tile, the skip layers' share of dfeat dropped, another
    ray's SH basis, the composite's suffix sums one sample late, one
    sample's dout8 moved to its neighbour (:func:`planted_dout8_moved`)."""
    other = list(args)
    other[3] = args[3].roll(1, 0)
    with mock.patch.object(_fr, "_exclusive_suffix_sum", _suffix_late):
        late = _fr.fused_render_bwd_plain(*args)
    return {**_weight_plants(ref, args[7]),
            "the skip's dfeat share dropped": _skip_plant(_fr.fused_render_bwd_plain, args, ref),
            "another ray's basis": bwd_errs(_fr.fused_render_bwd_plain(*other), ref),
            "suffix scan shifted by one": bwd_errs(late, ref),
            "one sample's dout8 moved to its neighbour": planted_dout8_moved(args, ref)}


def planted_errs_shaded(args, ref) -> Dict[str, Dict[str, float]]:
    """For ``args`` of ``fused_shaded_mlp_bwd_plain`` (ws, bs, feat,
    basis16, dout8, depth, skips, s, nb) and ``ref`` its result: the weight
    and point plants, the skip layers' share of dfeat dropped, another
    ray's SH basis, the sigmoid's derivative dropped on the red channel."""
    fn = _fm.fused_shaded_mlp_bwd_plain
    other = list(args)
    other[3] = args[3].roll(1, 0)
    with mock.patch.object(_fm, "_shade_grad", _shade_grad_dropped):
        dropped = fn(*args)
    return {**_weight_plants(ref, args[5]),
            "the skip's dfeat share dropped": _skip_plant(fn, args, ref),
            "another ray's basis": bwd_errs(fn(*other), ref),
            "sigmoid derivative dropped on one channel": bwd_errs(dropped, ref)}


def planted_errs_mlp(args, ref) -> Dict[str, Dict[str, float]]:
    """For ``args`` of ``fused_mlp_bwd_plain`` (ws, bs, feat, dout, depth,
    skips) and ``ref`` its result: the weight and point plants and the skip
    layers' share of dfeat dropped."""
    return {**_weight_plants(ref, args[4]),
            "the skip's dfeat share dropped": _skip_plant(_fm.fused_mlp_bwd_plain, args, ref)}
