"""The points stage of the flat MLP backwards on the CPU: its byte count,
the planted fault that the card tests hold the weight stage against at any
point count, and the port's depth colormap against the JAX package's.

``tools/bwd_check.points_stage_bytes`` follows the reads and writes of
``csrc/mlp_bwd_points.cuh`` (``tools/points_stage_time.py`` divides it by
the card's memory rate for the stage's ``floor_ms``); the counts below are
summed by hand from that kernel's schedule.  ``last_tile_cotangent`` zeroes a cotangent outside the
last 64-point tile, so that ``planted_last_tile`` (dW without that tile)
removes all of dW however many points come before it.
"""

import numpy as np
import pytest
import torch

from mc_nerf_torch.config import NerfConfig
from mc_nerf_torch.models.sh import sh_basis
from mc_nerf_torch.ops.cuda.fused_mlp import (
    BASIS_LANES,
    _flat_weights,
    encode_kernel_order,
    fused_mlp_bwd_plain,
    fused_shaded_mlp_bwd_plain,
    fused_shaded_mlp_plain,
    mlp_plain,
    mlp_recompute_plain,
    pack_mlp_params,
)
from mc_nerf_torch.tools.bwd_check import (
    BIAS_GROUPS,
    GROUP_ROWS,
    WEIGHT_TILE,
    bwd_errs,
    last_tile_cotangent,
    mlp_cotangent,
    planted_last_tile,
    planted_points,
    points_stage_bytes,
    points_stage_images,
    render_points_stage_bytes,
    shaded_cotangent,
)
from mc_nerf_torch.tools.scene import scene_params

NARROW = dict(emb_freqs_xyz=4, coarse_depth=2, coarse_width=32, coarse_skips=(1,),
              fine_depth=3, fine_width=64, fine_skips=(1,))
# (enc, depth, width, skips, head0) of the four packs the tests and the card run
PACKS = {"fine": (64, 8, 256, (4,), 512), "coarse": (64, 4, 128, (2,), 256),
         "narrow-coarse": (28, 2, 32, (1,), 64), "narrow-fine": (28, 3, 64, (1,), 128)}


# Bytes per point, by hand, past 132 tiles (the bias groups no longer grow):
# feat 2 enc + the bf16 workspace 2 (2 depth width + 2 head0 + 32) + dfeat
# 4 enc, then K6's dout 128, or K5's dout8 32 + the dbasis partials written
# and read back 128 + (one point per ray) the basis read and dbasis written
# 128:
#   fine 128 + 2 (4096 + 1024 + 32) + 256 = 10,688; + 128 = 10,816 (K6);
#     + 288 = 10,976 (K5)
#   coarse 128 + 2 (1024 + 512 + 32) + 256 = 3,520; 3,648 / 3,808
#   narrow coarse 56 + 2 (128 + 128 + 32) + 112 = 744; 872 / 1,032
#   narrow fine 56 + 2 (384 + 256 + 32) + 112 = 1,512; 1,640 / 1,800
@pytest.mark.parametrize("shaded", [False, True], ids=["K6", "K5"])
@pytest.mark.parametrize("pack,want", [("fine", (10816, 10976)), ("coarse", (3648, 3808)),
                                       ("narrow-coarse", (872, 1032)),
                                       ("narrow-fine", (1640, 1800))])
def test_points_stage_bytes_per_point(pack, want, shaded):
    p = 200_000
    got = (points_stage_bytes(*PACKS[pack], p + 1, shaded, 1)
           - points_stage_bytes(*PACKS[pack], p, shaded, 1))
    assert got == want[shaded]


# K3 (render_points_stage_bytes), bytes of one more ray past the bias
# groups' 132, by hand.  K5's stage per point without its per-ray terms:
# fine 10,688 + dout8 32 + the dbasis partials 128 = 10,848, coarse 3,680;
# per ray the basis read and dbasis written, 128.  Fused (rays filling 7/8
# of 64 rows or more: s = 32, 20): less the dout8 read (32), plus z and
# noise (8) a point and dray (32) a ray:
#   fine, s = 32: 32 x 10,824 + 160 = 346,528
#   coarse, s = 20: 20 x 3,656 + 160 = 73,280
# Composed (s = 48: 48 of 64 rows; s = 130): plus the forward (feat 128,
# its [P, 8] rows written 32) and the composite (z and noise 8, sigma and
# rgb read 16, the prefix sums written and read back 16, dout8 written 16)
# a point, and the forward's basis read 64 and dray 32 a ray:
#   coarse, s = 48: 48 x 3,896 + 224 = 187,232
#   fine, s = 130: 130 x 11,064 + 224 = 1,438,544
@pytest.mark.parametrize("pack,s,want", [("fine", 32, 346528), ("coarse", 20, 73280),
                                         ("coarse", 48, 187232), ("fine", 130, 1438544)])
def test_render_points_stage_bytes_per_ray(pack, s, want):
    rays = 100_000
    got = (render_points_stage_bytes(*PACKS[pack], (rays + 1) * s, s)
           - render_points_stage_bytes(*PACKS[pack], rays * s, s))
    assert got == want


# The weight images, by hand (bytes = K rounded to 32 x N x 2 per product):
#   fine, recompute: layer 0 64 x 256 (32,768), six 256 x 256 (131,072
#   each), the skip 320 x 256 (163,840), head 0 four passes 256 x 128
#   (65,536 each), K5's head-1 shares four 128 x 32 (8,192 each) =
#   1,277,952 (K6 1,245,184); backward: d_h1 two 32 x 256 (16,384 each),
#   head 0 512 x 256 (262,144), seven hidden 256 x 256, two feature blocks
#   256 x 64 (32,768 each) = 1,277,952
#   coarse, recompute: 64 x 128 (16,384), 128 x 128 (32,768) twice, the
#   skip 192 x 128 (49,152), head 0 two passes 128 x 128 (32,768 each),
#   K5's head-1 shares two 128 x 32 (8,192 each) = 212,992 (K6 196,608);
#   backward: 32 x 256
#   (16,384), 256 x 128 (65,536), three hidden 128 x 128, two feature
#   blocks 128 x 64 (16,384 each) = 212,992
@pytest.mark.parametrize("pack,shaded,want", [("fine", True, 2555904), ("fine", False, 2523136),
                                              ("coarse", True, 425984),
                                              ("coarse", False, 409600)])
def test_points_stage_images(pack, shaded, want):
    assert points_stage_images(*PACKS[pack], shaded) == want


# The recompute's images alone (K3's forward reads them once more): fine
# 1,277,952, coarse 212,992, as summed above; narrow coarse: layer 0 32 x
# 32 (2,048), the skip 64 x 32 (4,096), head 0 32 x 64 (4,096), its head-1
# share 64 x 32 (4,096) = 14,336
@pytest.mark.parametrize("pack,want", [("fine", 1277952), ("coarse", 212992),
                                       ("narrow-coarse", 14336)])
def test_points_stage_images_recompute(pack, want):
    assert points_stage_images(*PACKS[pack], True, recompute_only=True) == want


def test_render_points_stage_bytes_at_the_importance_shapes():
    """K3's count beside K5's stage at the same points and 7000 rays, the
    importance step's passes: fused at the fine pass (s = 32; 1750 tiles,
    past the 132 bias groups): z and noise 8 a point and dray 32 a ray for
    the dout8 read, 32 a point; composed at the coarse pass (s = 48) and
    at s = 130: the forward's (feat, its [P, 8] rows) and the composite's
    bytes, and the recompute's images read once more."""
    p = 7000 * 32
    assert render_points_stage_bytes(*PACKS["fine"], p, 32) == (
        points_stage_bytes(*PACKS["fine"], p, True, 32) - 24 * p + 32 * 7000)
    for pack, s, images in (("coarse", 48, 212992), ("fine", 130, 1277952),
                            ("coarse", 130, 212992)):
        enc, p = PACKS[pack][0], 7000 * s
        assert render_points_stage_bytes(*PACKS[pack], p, s) == (
            points_stage_bytes(*PACKS[pack], p, True, s)
            + (2 * enc + 32 + 8 + 16 + 16 + 16) * p + (64 + 32) * 7000 + images)


def test_points_stage_bytes_fixed_part():
    """Beside the per-point bytes: the bias partials of min(tiles, 132)
    groups of 8 rows, the pack read once, the images written and read."""
    enc, depth, width, skips, head0 = PACKS["fine"]
    nbias = depth * width + head0 + 32
    pack = 2 * (enc * width + 6 * width * width + (enc + width) * width + width * head0
                + head0 * 32 + nbias)
    per = points_stage_bytes(*PACKS["fine"], 1) - points_stage_bytes(*PACKS["fine"], 0)
    for p in (128, 128 * 200):
        groups = min((p + 127) // 128, BIAS_GROUPS)
        assert points_stage_bytes(*PACKS["fine"], p) == (
            (per - GROUP_ROWS * nbias * 4) * p + groups * GROUP_ROWS * nbias * 4 + pack
            + 2 * 2523136)


def _case(kind, coarse, rays, s):
    """(plain backward, its args under a cotangent zero outside the last
    64-point tile) on the narrow config's scene."""
    nc = NerfConfig(**NARROW)
    params = scene_params(nc, 0, device="cpu")
    mlp, depth, skips = ((params.coarse, nc.coarse_depth, nc.coarse_skips) if coarse else
                         (params.fine, nc.fine_depth, nc.fine_skips))
    packed = pack_mlp_params(mlp, nc.emb_freqs_xyz, skips)
    ws, bs = _flat_weights(packed)
    rng = np.random.default_rng(rays + s)
    d = torch.as_tensor(rng.normal(size=(rays, 3)), dtype=torch.float32)
    d = d / d.norm(dim=-1, keepdim=True)
    z = torch.as_tensor(rng.uniform(1.0, 8.0, (rays, s)), dtype=torch.float32)
    feat = encode_kernel_order((torch.tensor([0.0, 0.0, -4.0]) + d[:, None] * z[..., None])
                               .reshape(-1, 3), nc.emb_freqs_xyz)
    if kind == "shaded":
        nb = (nc.sh_deg + 1) ** 2
        basis16 = torch.nn.functional.pad(sh_basis(nc.sh_deg, d), (0, BASIS_LANES - nb))
        out8 = fused_shaded_mlp_plain(packed, feat, basis16, depth, skips, s, nb)
        dout8 = last_tile_cotangent(shaded_cotangent(out8, s))
        return fused_shaded_mlp_bwd_plain, (ws, bs, feat, basis16, dout8, depth, skips, s, nb)
    dout = last_tile_cotangent(mlp_cotangent(mlp_plain(packed, feat, depth, skips)))
    return fused_mlp_bwd_plain, (ws, bs, feat, dout, depth, skips)


@pytest.mark.parametrize("kind,coarse,rays,s", [
    ("shaded", False, 2731, 3), ("shaded", True, 7000, 32),
    ("mlp", True, 8193, 1), ("mlp", False, 224000, 1)],
    ids=["K5-fine-8193", "K5-coarse-224000", "K6-coarse-8193", "K6-fine-224000"])
def test_last_tile_plant_is_caught_at_any_size(kind, coarse, rays, s):
    """Under a cotangent zero outside the last 64-point tile, dW comes from
    that tile alone: the plant that drops it leaves every dW at zero (a
    relative error of exactly 1, far past every tolerance, 0.25 at most),
    and moves nothing else; the cotangent keeps exactly that tile's rows."""
    fn, args = _case(kind, coarse, rays, s)
    p = rays * s
    cot = args[4] if kind == "shaded" else args[3]
    live = (cot.abs().sum(1) > 0).nonzero().flatten()
    first = (p - 1) // WEIGHT_TILE * WEIGHT_TILE
    assert int(live.min()) >= first and len(live) > 0
    ref = fn(*args)
    errs = planted_last_tile(fn, args, ref)
    assert errs["dW"] == pytest.approx(1.0) and errs["last layer"] == pytest.approx(1.0)
    assert errs["db"] == 0.0 and errs["dfeat"] == 0.0
    assert bwd_errs(ref, ref)["dW"] == 0.0


@pytest.mark.parametrize("kind,coarse,rays,s", [("shaded", False, 2731, 3), ("mlp", True, 8193, 1)],
                         ids=["K5-fine-8193", "K6-coarse-8193"])
def test_points_plants(kind, coarse, rays, s):
    """The points stage's plants through the plain versions, under a
    cotangent zero outside the last 64-point tile: the bias gradients
    without the last 128-point tile are all zero (relative error exactly
    1 on db and the last layer), nothing else moves; a trunk layer masked
    with the mask of the layer below moves dW, db and dfeat."""
    fn, args = _case(kind, coarse, rays, s)
    ref = fn(*args)
    plants = planted_points(fn, args, ref)
    dropped = plants["bias partials of the last tile dropped"]
    assert dropped["db"] == pytest.approx(1.0) and dropped["last layer"] == pytest.approx(1.0)
    assert dropped["dW"] == 0.0 and dropped["dfeat"] == 0.0
    shifted = plants["a layer masked with the one below's"]
    assert min(shifted["dW"], shifted["db"], shifted["dfeat"]) > 1e-2


@pytest.mark.parametrize("kind", ["shaded", "mlp"], ids=["K5", "K6"])
def test_plain_backward_on_given_activations(kind):
    """The plain backwards on activations handed to them (``acts``, what the
    card tests pass from a kernel's workspace) give the same bits as their
    own recompute when handed that recompute's activations, and other
    activations move them."""
    fn, args = _case(kind, False, 300, 1)
    ws, bs, feat = args[:3]
    depth, skips = (args[5], args[6]) if kind == "shaded" else (args[4], args[5])
    xins, h_last, h1, _ = mlp_recompute_plain(ws, bs, feat, depth, skips)
    own, given = fn(*args), fn(*args, acts=(xins, h_last, h1))
    flat = lambda r: [*r[0], *r[1], *r[2:]]
    assert all(torch.equal(a, b) for a, b in zip(flat(own), flat(given)))
    moved = fn(*args, acts=(xins, h_last, h1.roll(1, 0)))
    assert not torch.equal(moved[0][-1], own[0][-1])


def test_depth_colormap_matches_the_jax_package():
    """``apply_depth_colormap`` (17 inferno points, interpolated) against
    the JAX package's matplotlib table on a seeded ramp with values past
    both ends: within the 0.026 its comment states, the [63, 255] clip
    the same."""
    pytest.importorskip("matplotlib")
    from mc_nerf_torch.utils.visualization import apply_depth_colormap
    from mc_nerf_tpu.utils.visualization import apply_depth_colormap as reference

    rng = np.random.default_rng(0)
    depth = np.concatenate([np.linspace(-0.2, 1.2, 2001), rng.uniform(0, 1, 999)]).reshape(60, 50)
    got, want = apply_depth_colormap(depth), reference(depth)
    assert got.shape == want.shape == (60, 50, 3)
    assert float(np.abs(got - want).max()) <= 0.026
    low = depth < 63 / 255
    assert np.array_equal(got[low], np.broadcast_to(got[low][0], got[low].shape))
