"""The CUDA kernels against their plain PyTorch versions, on a CUDA card:
fused_mlp_apply, fused_render (forward and backward), fused_shaded_mlp
(forward and backward), the differentiable fused_mlp's backward and
sample_pdf's inverse-CDF kernel.

Every test here is marked ``gpu`` and skips without a card (the kernels
have no CPU build).  The file imports nothing of JAX, so it runs on a
machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

The weights are the seeded scene of ``mc_nerf_torch.tools.scene``
(``scene_params``: the init scaled by He's gain, so outputs vary with the
point; at the init as drawn the outputs are nearly all bias and a wrong
kernel could pass).  Shapes go beyond the main path's: narrow widths, an
encode width that is not a multiple of 16, ragged point and ray counts,
and sample counts from 2 to rays longer than any tile.
Tolerances are about 10x the largest error measured on an H100 (PERF.md).
"""

import copy
import functools

import numpy as np
import pytest
import torch

from mc_nerf_torch.config import NerfConfig
from mc_nerf_torch.models.nerf import pack_eval_params
from mc_nerf_torch.models.sh import sh_basis
from mc_nerf_torch.ops.cuda.fused_mlp import (
    BASIS_LANES,
    _flat_weights,
    _mlp_bwd_launch,
    _mlp_fwd,
    _shaded_bwd_launch,
    _shaded_fwd,
    _workspace,
    encode_kernel_order,
    fused_mlp,
    fused_mlp_apply,
    fused_mlp_apply_rays,
    fused_mlp_bwd,
    fused_mlp_bwd_plain,
    fused_shaded_mlp,
    fused_shaded_mlp_bwd,
    fused_shaded_mlp_bwd_plain,
    fused_shaded_mlp_plain,
    fused_shaded_mlp_rays,
    mlp_plain,
    pack_mlp_params,
)
from mc_nerf_torch.ops.cuda.fused_render import (
    _render_fwd,
    fused_render,
    fused_render_bwd,
    fused_render_bwd_plain,
    fused_render_plain,
    fused_render_rays,
    max_samples,
    max_samples_bwd,
    render_bwd_points,
    render_bwd_weights,
)
from mc_nerf_torch.ops.cuda.sample_pdf import _launch, draw_gap, max_bins, sample_pdf_cuda
from mc_nerf_torch.ops.volume import sample_pdf, sample_pdf_plain
from mc_nerf_torch.tools.bwd_check import (
    WEIGHT_TILE,
    LAST_TILE_TOL,
    bwd_errs,
    last_tile_cotangent,
    mixed_in_tiles,
    mlp_cotangent,
    mse_cotangent,
    pair_swapped,
    planted_errs,
    planted_errs_mlp,
    planted_errs_shaded,
    planted_last_tile,
    planted_points,
    rel_l2,
    render_scan_late,
    shaded_cotangent,
    workspace_acts,
)
from mc_nerf_torch.tools.card_kinds import COARSE_FREE, FRAME_LAUNCHES, FRAME_MODES, STEP_KINDS
from mc_nerf_torch.tools.scene import scene_params
from mc_nerf_torch.utils import trace

NARROW = dict(emb_freqs_xyz=4, coarse_depth=2, coarse_width=32, coarse_skips=(1,),
              fine_depth=3, fine_width=64, fine_skips=(1,))
CFGS = {"narrow": NARROW, "default": {}}
# about 10x the largest error measured over this file's cases on an H100
MLP_RTOL = 5e-2       # max abs error / max abs output (measured 5.2e-3)
RENDER_ATOL = 5e-3    # rgb / opacity (measured 5.4e-4)
WSEL_ATOL = 1e-2      # selection weights (measured 9.7e-4)
DEPTH_ATOL = 2e-2     # depth in [1, 8] (measured 1.7e-3)
# relative L2 error of each backward output (tools/bwd_check.bwd_errs), per
# (config, pass): about 10x the largest error measured over that group's
# cases on an H100 (PERF.md).  The narrow fine dbasis: 10x the fp32 plain
# version's own spread against float64 sums at 256 x 32 (1.45e-4; the
# kernel lands at 1.4e-6 there, test_render_backward_narrow_fine_dbasis_spread)
BWD_TOL = {
    ("narrow", "coarse"): {"dW": 1.3e-3, "db": 6.2e-4, "last layer": 5.3e-4, "dfeat": 5e-3,
                           "dbasis": 1.5e-4},
    ("narrow", "fine"): {"dW": 1.8e-4, "db": 1.7e-4, "last layer": 1.2e-4, "dfeat": 7e-4,
                         "dbasis": 1.5e-3},
    ("default", "coarse"): {"dW": 0.16, "db": 0.13, "last layer": 1e-3, "dfeat": 0.25,
                            "dbasis": 3.3e-3},
    ("default", "fine"): {"dW": 0.2, "db": 0.22, "last layer": 3.6e-3, "dfeat": 0.23,
                          "dbasis": 7.8e-3},
}
# fused_shaded_mlp: sigma as MLP_RTOL (measured 1.0e-2); rgb max abs
# (measured 7.0e-3)
SHADED_RGB_ATOL = 5e-2
# its backward under tools/bwd_check.shaded_cotangent, and fused_mlp's
# under mlp_cotangent: relative L2 per output, per (config, pass), about
# 10x the largest error measured over the group's cases on an H100
SHADED_BWD_TOL = {
    ("narrow", "coarse"): {"dW": 1e-4, "db": 5e-5, "last layer": 1e-4, "dfeat": 1e-3,
                           "dbasis": 1e-4},
    ("narrow", "fine"): {"dW": 7e-4, "db": 5.4e-4, "last layer": 1.2e-4, "dfeat": 6.6e-3,
                         "dbasis": 1.3e-4},
    ("default", "coarse"): {"dW": 1.7e-3, "db": 1.3e-3, "last layer": 2.2e-4, "dfeat": 2.5e-2,
                            "dbasis": 4.6e-4},
    ("default", "fine"): {"dW": 6.7e-2, "db": 5.9e-2, "last layer": 1.5e-3, "dfeat": 0.21,
                          "dbasis": 3.7e-3},
}
MLP_BWD_TOL = {
    ("narrow", "coarse"): {"dW": 1e-4, "db": 1e-5, "last layer": 1.1e-4, "dfeat": 7.7e-4},
    ("narrow", "fine"): {"dW": 1e-4, "db": 3e-5, "last layer": 1.1e-4, "dfeat": 5.7e-3},
    ("default", "coarse"): {"dW": 5.3e-3, "db": 2.9e-3, "last layer": 1.2e-4, "dfeat": 5e-2},
    ("default", "fine"): {"dW": 8.9e-3, "db": 5.3e-3, "last layer": 1.6e-4, "dfeat": 0.12},
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _params(cfg_kw, seed=0):
    nc = NerfConfig(**cfg_kw)
    return nc, scene_params(nc, seed, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cfg_kw", [NARROW, {}], ids=["narrow", "default"])
@pytest.mark.parametrize("n_points", [1, 127, 129, 1000, 4099, 8193])
def test_fused_mlp_kernel_matches_plain(cuda, cfg_kw, n_points):
    """K1 on the coarse sigma-only pack (the demos'), the coarse full pack
    and the fine full pack (the fused_mlp VJP's, the importance demo's
    fine pass): max abs error within MLP_RTOL of the output's largest
    magnitude, zeros past column 0 of the sigma-only pack, one launch
    counted, the same bits on a second call; from 127 points on, the
    planted faults at 2x the tolerance or more: the skip input dropped,
    the first layer lost, the points of a tile mixed up, two tiles swapped
    (256 points or more).  At one point a plant may move the one output by
    less than the tolerance, which is relative to its own magnitude (the
    skip input dropped: 0.9x it at the default fine pack on an H100), so
    the plants are printed there and not held."""
    nc, params = _params(cfg_kw)
    rng = np.random.default_rng(n_points)
    xyz = torch.as_tensor(rng.uniform(-3.5, 3.5, (n_points, 3)), dtype=torch.float32,
                          device=cuda)
    feat = encode_kernel_order(xyz, nc.emb_freqs_xyz)
    for mlp, depth, skips, sigma_only in (
            (params.coarse, nc.coarse_depth, nc.coarse_skips, True),
            (params.coarse, nc.coarse_depth, nc.coarse_skips, False),
            (params.fine, nc.fine_depth, nc.fine_skips, False)):
        packed = pack_mlp_params(mlp, nc.emb_freqs_xyz, skips, sigma_only)
        before = fused_mlp_apply.launches
        ker = fused_mlp_apply(packed, feat, depth, skips)
        assert fused_mlp_apply.launches == before + 1
        assert torch.equal(ker, fused_mlp_apply(packed, feat, depth, skips))
        ref = mlp_plain(packed, feat, depth, skips)

        def over(out):
            return float((out - ref).abs().max()) / float(ref.abs().max()) / MLP_RTOL

        print(f"measured mlp rel {over(ker) * MLP_RTOL:.3e}")
        assert over(ker) <= 1.0
        if sigma_only:
            assert float(ker[:, 1:].abs().max()) == 0.0
        skipless = pack_mlp_params(mlp, nc.emb_freqs_xyz, skips, sigma_only)
        for i in skips:
            skipless.trunk_w[i][:feat.shape[1]] = 0
        firstless = pack_mlp_params(mlp, nc.emb_freqs_xyz, skips, sigma_only)
        firstless.trunk_w[0].zero_()
        plants = {"skip input dropped": over(mlp_plain(skipless, feat, depth, skips)),
                  "first layer lost": over(mlp_plain(firstless, feat, depth, skips))}
        if n_points > 1:
            plants["points mixed in a tile"] = over(mixed_in_tiles(ker))
        if n_points >= 256:
            plants["two tiles swapped"] = over(pair_swapped(ker))
        print(f"measured mlp plants over tolerance (P={n_points}) "
              + " ".join(f"{n}: {r:.1f}" for n, r in plants.items()))
        if n_points >= 127:
            assert all(r >= 2.0 for r in plants.values()), plants


@pytest.mark.gpu
def test_fused_mlp_refused_launch_raises(cuda):
    """A call the kernel refuses (a layer's weights not 16-byte aligned)
    raises and counts no launch: nothing falls back to the plain
    version."""
    nc, params = _params(NARROW)
    ws, bs = _flat_weights(pack_mlp_params(params.coarse, nc.emb_freqs_xyz, nc.coarse_skips,
                                           True))
    w1 = torch.empty(ws[1].numel() + 1, dtype=ws[1].dtype, device=cuda)[1:].view(ws[1].shape)
    w1.copy_(ws[1])
    feat = encode_kernel_order(torch.zeros((129, 3), device=cuda), nc.emb_freqs_xyz)
    before = fused_mlp_apply.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        _mlp_fwd([ws[0], w1, *ws[2:]], bs, feat, nc.coarse_depth, tuple(nc.coarse_skips))
    assert fused_mlp_apply.launches == before


def _render_args(nc, packed_f, depth, skips, s, rays, with_noise, emit_wsel, device):
    nb = (nc.sh_deg + 1) ** 2
    rng = np.random.default_rng(s)
    d = torch.as_tensor(rng.normal(size=(rays, 3)), dtype=torch.float32, device=device)
    d = d / d.norm(dim=-1, keepdim=True)
    z = torch.sort(torch.as_tensor(rng.uniform(1.0, 8.0, (rays, s)), dtype=torch.float32,
                                   device=device), dim=-1).values.contiguous()
    xyz = torch.tensor([0.0, 0.0, -4.0], device=device) + d[:, None] * z[..., None]
    feat = encode_kernel_order(xyz.reshape(-1, 3), nc.emb_freqs_xyz)
    basis16 = torch.nn.functional.pad(sh_basis(nc.sh_deg, d), (0, BASIS_LANES - nb)).contiguous()
    noise = torch.as_tensor(rng.normal(size=(rays, s)), dtype=torch.float32, device=device)
    noise_sel = torch.as_tensor(rng.normal(size=(rays, s)), dtype=torch.float32, device=device)
    return (packed_f, feat, basis16, z, noise, noise_sel, depth, skips, s, nb, with_noise,
            emit_wsel, nc.white_back)


def _render_close(ko, kw, po, pw):
    print("measured render rgb/opacity {:.3e} depth {:.3e} wsel {:.3e}".format(
        float((ko[:, [0, 1, 2, 4]] - po[:, [0, 1, 2, 4]]).abs().max()),
        float((ko[:, 3] - po[:, 3]).abs().max()),
        0.0 if pw is None else float((kw - pw).abs().max())))
    torch.testing.assert_close(ko[:, [0, 1, 2, 4]], po[:, [0, 1, 2, 4]], rtol=0,
                               atol=RENDER_ATOL)
    torch.testing.assert_close(ko[:, 3], po[:, 3], rtol=0, atol=DEPTH_ATOL)
    assert float(ko[:, 5:].abs().max()) == 0.0
    if pw is not None:
        torch.testing.assert_close(kw, pw, rtol=0, atol=WSEL_ATOL)
    else:
        assert kw is None


@pytest.mark.gpu
@pytest.mark.parametrize("cfg_kw", [NARROW, {}], ids=["narrow", "default"])
@pytest.mark.parametrize("s", [2, 17, 31, 32, 33, 48, 64, 65, 130, 300])
@pytest.mark.parametrize("with_noise,emit_wsel",
                         [(False, False), (True, True), (True, False), (False, True)])
def test_fused_render_kernel_matches_plain(cuda, cfg_kw, s, with_noise, emit_wsel):
    """The fine eval pack and the coarse full (training) pack over 53 rays:
    rays that straddle the forward's 128-point tiles (s = 31, 33, 48, 65,
    130, 300) or fill them (32, 64), and a ragged last tile at every s
    but 64 and 128's multiples."""
    nc, params = _params(cfg_kw, seed=s)
    for mlp, depth, skips in ((params.fine, nc.fine_depth, nc.fine_skips),
                              (params.coarse, nc.coarse_depth, nc.coarse_skips)):
        packed = pack_mlp_params(mlp, nc.emb_freqs_xyz, skips)
        args = _render_args(nc, packed, depth, skips, s, 53, with_noise, emit_wsel, cuda)
        before = fused_render.launches
        (ko, kw), (po, pw) = fused_render(*args), fused_render_plain(*args)
        assert fused_render.launches == before + 1
        _render_close(ko, kw, po, pw)


@pytest.mark.gpu
def test_fused_render_sample_ceiling(cuda):
    """The forward has no ceiling on samples per ray (max_samples is 2**31
    - 1 at both packs; the composite reads each ray's rows from device
    memory): rays of 4,099 samples, past the 1,952 of the shared-memory
    design it replaced, render at the default fine pack with noise and
    wsel and agree with the plain version."""
    nc, params = _params({})
    _, packed_f = pack_eval_params(params, nc)
    assert max_samples(packed_f) == 2**31 - 1
    nc_n, params_n = _params(NARROW)
    assert max_samples(pack_eval_params(params_n, nc_n)[1]) == 2**31 - 1
    args = _render_args(nc, packed_f, nc.fine_depth, nc.fine_skips, 4099, 3, True, True, cuda)
    _render_close(*fused_render(*args), *fused_render_plain(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("s,with_noise,emit_wsel", [(32, True, True), (48, True, True),
                                                    (130, False, False)])
def test_fused_render_same_bits_twice(cuda, s, with_noise, emit_wsel):
    """K2 over 1000 rays on the default fine pack gives the same bits on a
    second call: each row of the forward comes from one warpgroup in an
    order fixed by the shapes, each ray's composite from one warp."""
    nc, params = _params({})
    packed = pack_mlp_params(params.fine, nc.emb_freqs_xyz, nc.fine_skips)
    args = _render_args(nc, packed, nc.fine_depth, nc.fine_skips, s, 1000, with_noise,
                        emit_wsel, cuda)
    (a, aw), (b, bw) = fused_render(*args), fused_render(*args)
    assert torch.equal(a, b)
    assert (aw is None and bw is None) or torch.equal(aw, bw)


def _render_over(out, w, ref, ref_w):
    """The largest of K2's errors over its tolerance."""
    errs = [float((out[:, [0, 1, 2, 4]] - ref[:, [0, 1, 2, 4]]).abs().max()) / RENDER_ATOL,
            float((out[:, 3] - ref[:, 3]).abs().max()) / DEPTH_ATOL]
    if ref_w is not None:
        errs.append(float((w - ref_w).abs().max()) / WSEL_ATOL)
    return max(errs)


@pytest.mark.gpu
@pytest.mark.parametrize("cfg_kw", [NARROW, {}], ids=["narrow", "default"])
@pytest.mark.parametrize("s", [31, 32, 48])
def test_fused_render_planted_faults(cuda, cfg_kw, s):
    """K2 at the training flags (noise, noise_sel, wsel) on the fine and the
    coarse full pack over 54 rays within its tolerances, and each planted
    fault of the plain version at 2x them or more: the skip input dropped,
    the first layer lost, the samples of each pair of rays swapped, another
    ray's SH basis, the composite's prefix sums one sample late
    (``tools/bwd_check.render_scan_late``)."""
    nc, params = _params(cfg_kw, seed=s)
    for name, mlp, depth, skips in (("fine", params.fine, nc.fine_depth, nc.fine_skips),
                                    ("coarse", params.coarse, nc.coarse_depth, nc.coarse_skips)):
        packed = pack_mlp_params(mlp, nc.emb_freqs_xyz, skips)
        args = _render_args(nc, packed, depth, skips, s, 54, True, True, cuda)
        ref = fused_render_plain(*args)
        assert _render_over(*fused_render(*args), *ref) <= 1.0
        skipless = pack_mlp_params(mlp, nc.emb_freqs_xyz, skips)
        for i in skips:
            skipless.trunk_w[i][:args[1].shape[1]] = 0
        firstless = pack_mlp_params(mlp, nc.emb_freqs_xyz, skips)
        firstless.trunk_w[0].zero_()
        swapped = args[1].view(54, s, -1)[torch.arange(54, device=cuda).view(-1, 2).flip(1)
                                           .reshape(-1)].reshape(54 * s, -1)
        plants = {"skip input dropped": fused_render_plain(skipless, *args[1:]),
                  "first layer lost": fused_render_plain(firstless, *args[1:]),
                  "pairs of rays swapped": fused_render_plain(args[0], swapped, *args[2:]),
                  "another ray's basis": fused_render_plain(*args[:2], args[2].roll(1, 0),
                                                            *args[3:]),
                  "scan one sample late": render_scan_late(*args)}
        over = {n: _render_over(*o, *ref) for n, o in plants.items()}
        print(f"measured render plants over tolerance {cfg_kw and 'narrow' or 'default'} "
              f"{name} s={s}: " + " ".join(f"{n}: {r:.1f}" for n, r in over.items()))
        assert all(r >= 2.0 for r in over.values()), (name, over)


@pytest.mark.gpu
def test_fused_render_refused_launch_raises(cuda):
    """A call the kernels refuse (noise_sel without noise) raises and counts
    no launch: nothing falls back to the plain version."""
    nc, params = _params(NARROW)
    packed = pack_mlp_params(params.fine, nc.emb_freqs_xyz, nc.fine_skips)
    args = _render_args(nc, packed, nc.fine_depth, nc.fine_skips, 32, 7, True, True, cuda)
    ws, bs = _flat_weights(packed)
    before = fused_render.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        _render_fwd(ws, bs, args[1], args[2], args[3], None, args[5], nc.fine_depth,
                    tuple(nc.fine_skips), 32, args[9], True, True, True)
    assert fused_render.launches == before


def _bwd_case(cfg, coarse, s, rays, with_noise, device, seed=0):
    """A backward case on the scene's weights, its cotangent an MSE's of the
    plain forward's rays (``tools/bwd_check.mse_cotangent``)."""
    nc, params = _params(CFGS[cfg], seed)
    mlp, depth, skips = ((params.coarse, nc.coarse_depth, nc.coarse_skips) if coarse else
                         (params.fine, nc.fine_depth, nc.fine_skips))
    packed = pack_mlp_params(mlp, nc.emb_freqs_xyz, skips)
    r_args = _render_args(nc, packed, depth, skips, s, rays, with_noise, False, device)
    _, feat, basis16, z, noise, _, depth, skips, s, nb, *_ = r_args
    ws, bs = _flat_weights(packed)
    dray = mse_cotangent(fused_render_plain(*r_args)[0], nc.far)
    return packed, (ws, bs, feat, basis16, z, noise, dray, depth, skips, s, nb, with_noise,
                    nc.white_back)


def _bwd_close(k, ref, case, plants=None, tols=BWD_TOL):
    """Each output's relative L2 error within its tolerance for ``case``
    (cfg, pass); every planted fault (``tools/bwd_check.planted_errs``)
    beyond one of them."""
    tol = tols[case]
    errs = bwd_errs(k, ref)
    caught = {n: max(e[o] / tol[o] for o in e) for n, e in (plants or {}).items()}
    print(f"measured backward {case} " + " ".join(f"{o} {v:.3e}" for o, v in errs.items())
          + "; plants over tolerance " + " ".join(f"{n}: {r:.1f}" for n, r in caught.items()))
    assert all(errs[o] <= tol[o] for o in errs), errs
    assert all(r > 1.0 for r in caught.values()), caught


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", ["narrow", "default"])
@pytest.mark.parametrize("coarse", [True, False], ids=["coarse", "fine"])
@pytest.mark.parametrize("s,rays", [(2, 53), (17, 53), (32, 77), (48, 101), (64, 59), (300, 5)])
@pytest.mark.parametrize("with_noise", [True, False])
def test_backward_kernels_match_plain(cuda, cfg, coarse, s, rays, with_noise):
    """dW, db, dfeat and dbasis of the two backward launches against
    ``fused_render_bwd_plain``, relative L2 per output within the case's
    tolerance, and every planted fault outside it, one sample's dout8
    moved to its neighbour at 2x or more; each launch counted once.  s =
    2, 32 and 64 take the fused path (rays fill a warpgroup's 64 rows),
    17, 48 and 300 the composed one."""
    _, args = _bwd_case(cfg, coarse, s, rays, with_noise, cuda)
    before = (render_bwd_points.launches, render_bwd_weights.launches)
    k = fused_render_bwd(*args)
    assert (render_bwd_points.launches, render_bwd_weights.launches) == \
        (before[0] + 1, before[1] + 1)
    ref = fused_render_bwd_plain(*args)
    case = (cfg, "coarse" if coarse else "fine")
    plants = planted_errs(args, ref)
    _bwd_close(k, ref, case, plants)
    moved = plants["one sample's dout8 moved to its neighbour"]
    assert max(moved[o] / BWD_TOL[case][o] for o in moved) >= 2.0, moved


@pytest.mark.gpu
def test_backward_sample_ceiling_and_determinism(cuda):
    """At the default fine pack the backward takes rays of 1,301 samples
    (the ceiling of the shared-memory design it replaced; it now has none:
    max_samples_bwd is 2**31 - 1 at both packs) and agrees with the plain
    version; two runs give the same bits (a fixed-order reduction, no
    atomics); the forward has no ceiling either, so under autograd no ray
    is refused for its length (max_samples and max_samples_bwd are both
    2**31 - 1 at the training pack)."""
    packed, args = _bwd_case("default", False, 1301, 3, True, cuda)
    assert max_samples_bwd(packed) >= 1301
    nc_n, params_n = _params(NARROW)
    assert max_samples_bwd(pack_mlp_params(params_n.fine, nc_n.emb_freqs_xyz,
                                           nc_n.fine_skips)) >= 1301
    a, b = fused_render_bwd(*args), fused_render_bwd(*args)
    for x, y in zip([*a[0], *a[1], a[2], a[3]], [*b[0], *b[1], b[2], b[3]]):
        assert torch.equal(x, y)
    _bwd_close(a, fused_render_bwd_plain(*args), ("default", "fine"))
    nc, params = _params({})
    train_pack = pack_mlp_params(params.fine, nc.emb_freqs_xyz, nc.fine_skips,
                                 dtype=torch.float32)
    assert max_samples(train_pack) == max_samples_bwd(train_pack) == 2**31 - 1


@pytest.mark.gpu
def test_autograd_on_cuda_runs_the_backward_kernels(cuda):
    """``fused_render`` on an fp32 training pack: backward() under an MSE's
    cotangent launches both backward kernels, and the leaf gradients equal
    the plain backward's (cast to the leaves) within the narrow fine
    pass's tolerances."""
    nc, params = _params(NARROW)
    packed = pack_mlp_params(params.fine, nc.emb_freqs_xyz, nc.fine_skips, dtype=torch.float32)
    args = list(_render_args(nc, packed, nc.fine_depth, nc.fine_skips, 32, 77, True, False,
                             cuda))
    args[1] = args[1].detach().requires_grad_()
    leaves = [*packed.trunk_w, *packed.trunk_b, packed.head_w0, packed.head_b0,
              packed.head_w1, packed.head_b1]
    for leaf in leaves:
        leaf.retain_grad()
    before = render_bwd_points.launches
    out, _ = fused_render(*args)
    dray = mse_cotangent(out, nc.far)
    out.backward(dray)
    assert render_bwd_points.launches == before + 1
    ws, bs = _flat_weights(packed)
    ref = fused_render_bwd_plain(ws, bs, args[1].detach(), args[2], args[3], args[4], dray,
                                 nc.fine_depth, nc.fine_skips, 32, args[9], True, nc.white_back)
    d = nc.fine_depth
    assert args[1].grad.dtype == torch.bfloat16
    got = ([leaf.grad for leaf in leaves[:d]], [leaf.grad for leaf in leaves[d:2 * d]],
           args[1].grad.float(), ref[3])
    got[0].extend([leaves[2 * d].grad, leaves[2 * d + 2].grad])
    got[1].extend([leaves[2 * d + 1].grad, leaves[2 * d + 3].grad])
    # dfeat reaches feat rounded to feat's bf16, as in the JAX custom VJP
    _bwd_close(got, (*ref[:2], ref[2].to(torch.bfloat16).float(), ref[3]), ("narrow", "fine"))


# ------------------------------------------- fused_shaded_mlp and fused_mlp

def _pass(cfg, coarse, seed=0):
    nc, params = _params(CFGS[cfg], seed)
    mlp, depth, skips = ((params.coarse, nc.coarse_depth, nc.coarse_skips) if coarse else
                         (params.fine, nc.fine_depth, nc.fine_skips))
    return nc, mlp, depth, skips


def _shaded_inputs(nc, rays, s, device):
    """Features of points on seeded rays from (0, 0, -4) at depths in
    [1, 8] (one sample per point, in any order: nothing here composites),
    and the rays' SH basis padded to 16 lanes."""
    nb = (nc.sh_deg + 1) ** 2
    rng = np.random.default_rng(rays + s)
    d = torch.as_tensor(rng.normal(size=(rays, 3)), dtype=torch.float32, device=device)
    d = d / d.norm(dim=-1, keepdim=True)
    z = torch.as_tensor(rng.uniform(1.0, 8.0, (rays, s)), dtype=torch.float32, device=device)
    xyz = torch.tensor([0.0, 0.0, -4.0], device=device) + d[:, None] * z[..., None]
    feat = encode_kernel_order(xyz.reshape(-1, 3), nc.emb_freqs_xyz)
    basis16 = torch.nn.functional.pad(sh_basis(nc.sh_deg, d), (0, BASIS_LANES - nb)).contiguous()
    return feat, basis16, nb


SHADED_SHAPES = [(1, 130), (53, 7), (7, 1), (37, 130), (1000, 130)]
# K4's edges beyond those: one tile (1 and 7 points), an odd tile count
# (301 points in 3 tiles), rays straddling tiles (390 points), more tiles
# than the persistent grid with a ragged last round (an eval chunk, 16640
# tiles)
K4_SHAPES = SHADED_SHAPES + [(1, 1), (7, 43), (3, 130), (16384, 130)]


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", ["narrow", "default"])
@pytest.mark.parametrize("coarse", [True, False], ids=["coarse", "fine"])
@pytest.mark.parametrize("rays,s", K4_SHAPES)
def test_fused_shaded_mlp_kernel_matches_plain(cuda, cfg, coarse, rays, s):
    """K4 on both full packs: sigma's max abs error within MLP_RTOL of its
    largest magnitude, rgb within SHADED_RGB_ATOL, lanes 4..7 zero; one
    launch counted; another ray's basis (where there is one), the skip
    input dropped and, where there is more than one point, the points of
    a tile mixed up and two tiles swapped land outside the tolerances."""
    nc, mlp, depth, skips = _pass(cfg, coarse)
    packed = pack_mlp_params(mlp, nc.emb_freqs_xyz, skips)
    feat, basis16, nb = _shaded_inputs(nc, rays, s, cuda)
    before = fused_shaded_mlp.launches
    ker = fused_shaded_mlp(packed, feat, basis16, depth, skips, s, nb)
    assert fused_shaded_mlp.launches == before + 1
    ref = fused_shaded_mlp_plain(packed, feat, basis16, depth, skips, s, nb)

    def over(out):
        return max(float((out[:, 0] - ref[:, 0]).abs().max() / ref[:, 0].abs().max()) / MLP_RTOL,
                   float((out[:, 1:4] - ref[:, 1:4]).abs().max()) / SHADED_RGB_ATOL)

    sig_rel = float((ker[:, 0] - ref[:, 0]).abs().max() / ref[:, 0].abs().max())
    print(f"measured shaded sigma rel {sig_rel:.3e} "
          f"rgb {float((ker[:, 1:4] - ref[:, 1:4]).abs().max()):.3e}")
    assert over(ker) <= 1.0
    assert float(ker[:, 4:].abs().max()) == 0.0
    ws_skip = pack_mlp_params(mlp, nc.emb_freqs_xyz, skips)
    for i in skips:
        ws_skip.trunk_w[i][:feat.shape[1]] = 0
    assert over(fused_shaded_mlp_plain(ws_skip, feat, basis16, depth, skips, s, nb)) > 1.0
    if rays > 1:
        assert over(fused_shaded_mlp_plain(packed, feat, basis16.roll(1, 0), depth, skips, s,
                                           nb)) > 1.0
    if rays * s > 1:
        assert over(mixed_in_tiles(ker)) > 1.0
        assert over(pair_swapped(ker)) > 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("coarse", [True, False], ids=["coarse", "fine"])
def test_fused_shaded_mlp_same_bits_twice(cuda, coarse):
    """K4 at 1000 x 130 on the default packs gives the same bits on a
    second call: each row comes from one warpgroup in an order fixed by
    the shapes, whatever block took its tile."""
    nc, mlp, depth, skips = _pass("default", coarse)
    packed = pack_mlp_params(mlp, nc.emb_freqs_xyz, skips)
    feat, basis16, nb = _shaded_inputs(nc, 1000, 130, cuda)
    a = fused_shaded_mlp(packed, feat, basis16, depth, skips, 130, nb)
    b = fused_shaded_mlp(packed, feat, basis16, depth, skips, 130, nb)
    assert torch.equal(a, b)


@pytest.mark.gpu
def test_fused_shaded_mlp_refused_launch_raises(cuda):
    """A call the kernel refuses (points not a whole number of rays) raises
    and counts no launch: nothing falls back to the plain version."""
    nc, mlp, depth, skips = _pass("narrow", False)
    ws, bs = _flat_weights(pack_mlp_params(mlp, nc.emb_freqs_xyz, skips))
    feat, basis16, nb = _shaded_inputs(nc, 7, 43, cuda)
    before = fused_shaded_mlp.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        _shaded_fwd(ws, bs, feat[:300].contiguous(), basis16, depth, tuple(skips), 43, nb)
    assert fused_shaded_mlp.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", ["narrow", "default"])
@pytest.mark.parametrize("coarse", [True, False], ids=["coarse", "fine"])
@pytest.mark.parametrize("rays,s", SHADED_SHAPES)
def test_shaded_backward_kernel_matches_plain(cuda, cfg, coarse, rays, s):
    """K5 against ``fused_shaded_mlp_bwd_plain`` under a render-shaped
    cotangent (``tools/bwd_check.shaded_cotangent``): relative L2 per output
    within the case's tolerance, every planted fault outside it (another
    ray's basis only where there is another ray), one launch counted, and
    the same bits on a second run (fixed-order sums, no atomics)."""
    nc, mlp, depth, skips = _pass(cfg, coarse)
    packed = pack_mlp_params(mlp, nc.emb_freqs_xyz, skips)
    feat, basis16, nb = _shaded_inputs(nc, rays, s, cuda)
    ws, bs = _flat_weights(packed)
    dout8 = shaded_cotangent(fused_shaded_mlp_plain(packed, feat, basis16, depth, skips, s, nb),
                             s)
    args = (ws, bs, feat, basis16, dout8, depth, skips, s, nb)
    before = fused_shaded_mlp_bwd.launches
    k = fused_shaded_mlp_bwd(*args)
    assert fused_shaded_mlp_bwd.launches == before + 1
    again = fused_shaded_mlp_bwd(*args)
    for x, y in zip([*k[0], *k[1], k[2], k[3]], [*again[0], *again[1], again[2], again[3]]):
        assert torch.equal(x, y)
    ref = fused_shaded_mlp_bwd_plain(*args)
    plants = planted_errs_shaded(args, ref)
    if rays == 1:
        plants.pop("another ray's basis")
    _bwd_close(k, ref, (cfg, "coarse" if coarse else "fine"), plants, SHADED_BWD_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", ["narrow", "default"])
@pytest.mark.parametrize("coarse", [True, False], ids=["coarse", "fine"])
@pytest.mark.parametrize("n_points", [1, 4099, 224000])
def test_fused_mlp_backward_kernel_matches_plain(cuda, cfg, coarse, n_points):
    """K6 against ``fused_mlp_bwd_plain`` under an MSE of the packed output
    (``tools/bwd_check.mlp_cotangent``): relative L2 per output within the
    case's tolerance, the planted faults outside it, one launch counted,
    the same bits twice."""
    nc, mlp, depth, skips = _pass(cfg, coarse)
    packed = pack_mlp_params(mlp, nc.emb_freqs_xyz, skips)
    feat, _, _ = _shaded_inputs(nc, n_points, 1, cuda)
    ws, bs = _flat_weights(packed)
    args = (ws, bs, feat, mlp_cotangent(mlp_plain(packed, feat, depth, skips)), depth, skips)
    before = fused_mlp_bwd.launches
    k = fused_mlp_bwd(*args)
    assert fused_mlp_bwd.launches == before + 1
    again = fused_mlp_bwd(*args)
    for x, y in zip([*k[0], *k[1], k[2]], [*again[0], *again[1], again[2]]):
        assert torch.equal(x, y)
    ref = fused_mlp_bwd_plain(*args)
    _bwd_close(k, ref, (cfg, "coarse" if coarse else "fine"), planted_errs_mlp(args, ref),
               MLP_BWD_TOL)


@pytest.mark.gpu
def test_autograd_on_cuda_runs_the_shaded_and_mlp_kernels(cuda):
    """Autograd on CUDA tensors: ``fused_shaded_mlp`` on an fp32 training
    pack launches K4 forward and K5 backward, ``fused_mlp`` launches K1
    and K6; the leaf gradients equal the plain backwards' (cast to the
    leaves, dfeat to feat's bf16) within the narrow fine tolerances."""
    nc, mlp, depth, skips = _pass("narrow", False)
    feat, basis16, nb = _shaded_inputs(nc, 77, 13, cuda)
    for fwd, plain_bwd, counters, tols in (
            ("shaded", fused_shaded_mlp_bwd_plain, (fused_shaded_mlp, fused_shaded_mlp_bwd),
             SHADED_BWD_TOL),
            ("mlp", fused_mlp_bwd_plain, (fused_mlp_apply, fused_mlp_bwd), MLP_BWD_TOL)):
        packed = pack_mlp_params(mlp, nc.emb_freqs_xyz, skips, dtype=torch.float32)
        leaves = [*packed.trunk_w, *packed.trunk_b, packed.head_w0, packed.head_b0,
                  packed.head_w1, packed.head_b1]
        ws, bs = _flat_weights(packed)
        f = feat.detach().clone().requires_grad_()
        b = basis16.detach().clone().requires_grad_()
        for leaf in leaves:
            leaf.retain_grad()
        before = [c.launches for c in counters]
        if fwd == "shaded":
            out = fused_shaded_mlp(packed, f, b, depth, skips, 13, nb)
            cot = shaded_cotangent(out, 13)
        else:
            out = fused_mlp(packed, f, depth, skips)
            cot = mlp_cotangent(out)
        out.backward(cot)
        assert [c.launches for c in counters] == [n + 1 for n in before]
        ref = (plain_bwd(ws, bs, f.detach(), basis16, cot, depth, skips, 13, nb)
               if fwd == "shaded" else plain_bwd(ws, bs, f.detach(), cot, depth, skips))
        assert f.grad.dtype == torch.bfloat16
        got = [[leaf.grad for leaf in leaves[:depth]] + [leaves[2 * depth].grad,
                                                          leaves[2 * depth + 2].grad],
               [leaf.grad for leaf in leaves[depth:2 * depth]] + [leaves[2 * depth + 1].grad,
                                                                   leaves[2 * depth + 3].grad],
               f.grad.float()]
        want = [ref[0], ref[1], ref[2].to(torch.bfloat16).float()]
        if fwd == "shaded":
            assert b.grad.dtype == torch.float32
            got.append(b.grad)
            want.append(ref[3])
        _bwd_close(got, want, ("narrow", "fine"), None, tols)


@pytest.mark.gpu
def test_grid_train_step_autograd_launches_k4_and_k5(cuda):
    """A grid-mode training render on CUDA tensors through the kernel
    route: forward and backward launch K4 and K5 once per pass (two each),
    and nothing falls back to the plain versions."""
    from mc_nerf_torch.models.nerf import draw_render, render_rays_train

    nc = NerfConfig(**NARROW)
    params = scene_params(nc, 0, device="cuda")
    rng = np.random.default_rng(0)
    d = torch.as_tensor(rng.normal(size=(300, 3)), dtype=torch.float32, device=cuda)
    rays_d = d / d.norm(dim=-1, keepdim=True)
    rays_o = torch.tensor([[0.0, 0.0, -4.0]], device=cuda).expand(300, 3)
    draws = draw_render(300, nc, 32, False, torch.Generator(device=cuda).manual_seed(0), "grid")
    before = (fused_shaded_mlp.launches, fused_shaded_mlp_bwd.launches)
    rgb_c, rgb_f = render_rays_train(params, rays_d, rays_o, draws, torch.tensor(0.5, device=cuda),
                                     nc, (0.1, 0.5), True, fine_mode="grid", use_kernels=True)
    ((rgb_c - 1.0) ** 2).mean().add(((rgb_f - 1.0) ** 2).mean()).backward()
    assert (fused_shaded_mlp.launches, fused_shaded_mlp_bwd.launches) == \
        (before[0] + 2, before[1] + 2)
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in params.parameters())


# one GLOBAL_OPTIM step's loss and gradients, the kernel route against the
# bf16 plain route from the same params and draws: the plain route rounds
# sigma and SH to bf16 (the kernels keep them fp32), so its importance
# samples land apart a little, and in the grid fine mode a ray near the
# selection's threshold may pick another bin.  About 10x the loss and
# worst leaf measured on an H100 at the default widths (importance 2.6e-5
# and 1.4e-2; grid 18x and 6x, 5.6e-6 and 4.7e-2)
STEP_ROUTE_TOL = {"importance": {"loss rel": 3e-4, "grad rel L2 (worst leaf)": 0.15},
                  "grid": {"loss rel": 1e-4, "grad rel L2 (worst leaf)": 0.3}}


@pytest.mark.gpu
@pytest.mark.parametrize("fine_mode", sorted(STEP_ROUTE_TOL))
def test_train_step_kernel_route_matches_the_plain_route(cuda, fine_mode):
    """A GLOBAL_OPTIM step at Config()'s widths on the workload bench.py
    times (``tools/scene.train_workload``, 4 of its 800x800 images; step
    143,000 of 286,000: the BARF gate half open): the kernel route's loss
    and gradients within STEP_ROUTE_TOL of the bf16 plain route's, the
    fine MLP's skip input dropped on the plain route outside it; then 20
    kernel-route steps on one fixed batch lower the rgb loss."""
    import dataclasses

    from mc_nerf_torch.config import Config, TrainConfig
    from mc_nerf_torch.tools.scene import STEPS_PER_EPOCH, TOTAL_STEPS, train_workload
    from mc_nerf_torch.train.optim import build_optimizers, counter, flatten_params
    from mc_nerf_torch.train.steps import TrainState, draw_step, make_loss_fn, make_stage_step

    cfg = Config(train=TrainConfig(fine_mode=fine_mode))
    plain = cfg.replace(train=dataclasses.replace(cfg.train, use_pallas=False))
    params, data = train_workload(cfg, 0, cuda, n_images=4)
    p_flat = flatten_params(params)
    txs, states = build_optimizers(cfg, params, p_flat, STEPS_PER_EPOCH)
    state = TrainState(params, p_flat, states, counter(TOTAL_STEPS // 2, cuda))
    draws = draw_step(cfg, 1, 4, 800, 800, data.occ is not None,
                      torch.Generator(device=cuda).manual_seed(0))

    def loss_and_grads(c, prm):
        for q in prm.parameters():
            q.grad = None
        total, _ = make_loss_fn(c, 1, 800, 800, TOTAL_STEPS)(prm, data, draws, state.step)
        total.backward()
        return float(total.detach()), {n: q.grad.detach().clone()
                                       for n, q in prm.named_parameters()}

    def gaps(a, b):
        return {"loss rel": abs(a[0] - b[0]) / abs(b[0]),
                "grad rel L2 (worst leaf)": max(rel_l2(a[1][n], b[1][n]) for n in b[1]
                                                if float(b[1][n].norm()) > 0)}

    tol = STEP_ROUTE_TOL[fine_mode]
    ker, pln = loss_and_grads(cfg, params), loss_and_grads(plain, params)
    broken = copy.deepcopy(params)
    with torch.no_grad():
        broken.nerf.fine.trunk[cfg.nerf.fine_skips[0]].weight[:, :cfg.nerf.embed_dim] = 0
    got, planted = gaps(ker, pln), gaps(loss_and_grads(plain, broken), pln)
    print(f"measured {fine_mode} step, kernel route vs plain route {got}; the plant {planted}")
    assert all(got[k] <= tol[k] for k in tol), got
    assert max(planted[k] / tol[k] for k in tol) > 1.0, planted
    step = make_stage_step(cfg, 1, txs[1], 800, 800, TOTAL_STEPS)
    rgb = []
    for _ in range(20):
        m = step(state, data, draws)
        rgb.append(float(m["loss_rgb_c"] + m["loss_rgb_f"]))
    print(f"measured {fine_mode} rgb loss over 20 steps on one batch: {rgb[0]:.6f} -> "
          f"{rgb[-1]:.6f}")
    assert rgb[-1] < rgb[0], rgb


# ------------------------------------------------- the weight-gradient stage

# Point counts at the edges of the weight stage's splits (csrc/mlp_bwd.cuh
# weight_splits: ceil(P / 4096) splits below 65,536 points, at most 16,
# each whole 64-point stages but the last), as (rays, samples per ray):
# below one split; two whole splits of 4096 (on a split boundary); one
# point past it (8193; for fused_render 8194 = 34 x 241, rays of a few
# hundred samples); 224,000 = 7000 x 32, the importance
# fine pass, 14 or 15 splits.  1000 and 8193/8194 are no multiple of the
# 64-point stage.
WEIGHT_EDGES = {"render": [(50, 20), (256, 32), (34, 241), (7000, 32)],
                "shaded": [(40, 25), (64, 128), (2731, 3), (7000, 32)],
                "mlp": [(1000, 1), (8192, 1), (8193, 1), (224000, 1)]}


def _weight_edge_case(kind, cfg, coarse, rays, s, device, last_tile=False):
    """(kernel, plain version, args, tolerances) of one backward; with
    ``last_tile`` its cotangent is zero outside the last 64-point tile
    (``tools/bwd_check.last_tile_cotangent``; for K3 outside the rays that
    reach it)."""
    if kind == "render":
        args = list(_bwd_case(cfg, coarse, s, rays, True, device)[1])
        if last_tile:
            args[6] = last_tile_cotangent(args[6], s)
        return fused_render_bwd, fused_render_bwd_plain, tuple(args), BWD_TOL
    nc, mlp, depth, skips = _pass(cfg, coarse)
    packed = pack_mlp_params(mlp, nc.emb_freqs_xyz, skips)
    feat, basis16, nb = _shaded_inputs(nc, rays, s, device)
    ws, bs = _flat_weights(packed)
    cut = last_tile_cotangent if last_tile else (lambda d: d)
    if kind == "shaded":
        out8 = fused_shaded_mlp_plain(packed, feat, basis16, depth, skips, s, nb)
        return (fused_shaded_mlp_bwd, fused_shaded_mlp_bwd_plain,
                (ws, bs, feat, basis16, cut(shaded_cotangent(out8, s)), depth, skips, s, nb),
                SHADED_BWD_TOL)
    return (fused_mlp_bwd, fused_mlp_bwd_plain,
            (ws, bs, feat, cut(mlp_cotangent(mlp_plain(packed, feat, depth, skips))), depth,
             skips),
            MLP_BWD_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["render", "shaded", "mlp"])
@pytest.mark.parametrize("cfg", ["narrow", "default"])
@pytest.mark.parametrize("coarse", [True, False], ids=["coarse", "fine"])
@pytest.mark.parametrize("edge", range(4), ids=["below-split", "on-split", "past-split", "224000"])
def test_weight_stage_edges(cuda, kind, cfg, coarse, edge):
    """The three backwards (K3, K5, K6) at the weight stage's split edges,
    in both configs (narrow: 56-byte encode rows, the element path): the
    outputs of ``launch_weight_grads`` (every dW, every db, the last
    layer's) within their unchanged tolerances.  dfeat and dbasis come from
    the points kernels, which the tests above hold.  The planted fault
    ``planted_last_tile`` (dW without the last 64-point tile) must land
    outside them where that tile holds 1/200 of the points or more (1000
    and 8192 points); one point past a whole tile, or 64 of 224,000, moves
    dW by 1e-4 to 3e-4 under a loss over all points, below the default
    config's deep-trunk tolerances: printed there.  So at 8193 (K3: 8194)
    and 224,000 points the stage is held again under a cotangent zero
    outside the last tile, where dW comes from that tile alone: within
    ``LAST_TILE_TOL``, and the plant at 2x it or more.  Not for K3 at 8194
    = 34 x 241: its last tile is the last 2 samples of a 241-sample ray,
    behind the ray's opacity, whose points carry no gradient at all (the
    plant moves dW by ~1e-11 there: printed)."""
    rays, s = WEIGHT_EDGES[kind][edge]
    kernel, plain, args, tols = _weight_edge_case(kind, cfg, coarse, rays, s, cuda)
    k = kernel(*args)
    ref = plain(*args)
    p = rays * s
    tail = p - (p - 1) // WEIGHT_TILE * WEIGHT_TILE
    tol = tols[(cfg, "coarse" if coarse else "fine")]
    stage = ("dW", "db", "last layer")
    errs = {o: v for o, v in bwd_errs(k, ref).items() if o in stage}
    plant = {o: v for o, v in planted_last_tile(plain, args, ref).items() if o in stage}
    caught = max(plant[o] / tol[o] for o in stage)
    print(f"measured {kind} {cfg} P={p}: " + " ".join(f"{o} {v:.3e}" for o, v in errs.items())
          + f"; last tile {tail} points, the plant over tolerance {caught:.2f}")
    assert all(errs[o] <= tol[o] for o in stage), errs
    if tail * 200 >= p:
        assert caught > 1.0, plant
    if edge >= 2:
        kernel, plain, args, tols = _weight_edge_case(kind, cfg, coarse, rays, s, cuda, True)
        k = kernel(*args)
        ref = plain(*args)
        errs = {o: v for o, v in bwd_errs(k, ref).items() if o in stage}
        plant = {o: v for o, v in planted_last_tile(plain, args, ref).items() if o in stage}
        caught = max(plant[o] / LAST_TILE_TOL[o] for o in stage)
        print(f"measured {kind} {cfg} P={p}, cotangent on the last tile only: "
              + " ".join(f"{o} {v:.3e}" for o, v in errs.items())
              + f"; the plant over tolerance {caught:.2f}")
        assert all(errs[o] <= LAST_TILE_TOL[o] for o in stage), errs
        if kind != "render" or edge == 3:
            assert caught >= 2.0, plant


# The points stage (csrc/mlp_bwd_points.cuh) of K5 and K6 at the edges of
# its 128-point tiles and of its persistent grid (132 groups: 224,000 points
# are 1,750 tiles, 13 or 14 a block)
POINTS_EDGES = [1, 127, 128, 129, 4099, 224000]


def _points_run(kind, cfg, coarse, p, device, last_tile=False):
    """K5 (p rays of one sample) or K6 at p points through its kernel call,
    and the plain backward on the kernel's own recompute
    (``tools/bwd_check.workspace_acts``): at these shapes a bf16 value that
    the two recomputes' fp32 sums round the other way flips a ReLU mask in
    a few points, and one flipped point out of a few moves the sums by up
    to 14% (one ray of 4099 samples; the previous points kernel alike),
    past the tolerances measured at the main path's shapes.  Returns
    (kernel outputs, reference, plain backward bound to those activations,
    args, the pass's tolerances, launches counted)."""
    kernel, plain, args, tols = _weight_edge_case(kind, cfg, coarse, p, 1, device, last_tile)
    ws, bs, feat = args[:3]
    depth, skips = (args[5], args[6]) if kind == "shaded" else (args[4], args[5])
    work = _workspace(feat.shape[0], feat.shape[1], ws, skips, kind == "shaded", feat.device)
    before = kernel.launches
    k = (_shaded_bwd_launch if kind == "shaded" else _mlp_bwd_launch)(*args, work)
    launched = kernel.launches - before
    fn = functools.partial(plain, acts=workspace_acts(work, feat, depth, skips, ws[0].shape[1],
                                                      ws[-2].shape[1]))
    return k, fn(*args), fn, args, tols[(cfg, "coarse" if coarse else "fine")], launched


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["shaded", "mlp"], ids=["K5", "K6"])
@pytest.mark.parametrize("cfg", ["narrow", "default"])
@pytest.mark.parametrize("coarse", [True, False], ids=["coarse", "fine"])
@pytest.mark.parametrize("p", POINTS_EDGES)
def test_points_stage_matches_plain(cuda, kind, cfg, coarse, p):
    """K5 and K6 at the points stage's edges against the plain backward on
    the kernel's own recompute: every output within the pass's tolerance,
    one launch counted, the planted faults outside (the weight and point
    plants, the skip's dfeat share, for K5 another ray's basis and the
    sigmoid's derivative) and the points stage's own: a trunk layer masked
    with the layer below's mask, at 2x the tolerance or more."""
    k, ref, fn, args, tol, launched = _points_run(kind, cfg, coarse, p, cuda)
    assert launched == 1
    plants = planted_errs_shaded(args, ref) if kind == "shaded" else planted_errs_mlp(args, ref)
    if p == 1:
        plants.pop("another ray's basis", None)
    own = planted_points(fn, args, ref)["a layer masked with the one below's"]
    errs = bwd_errs(k, ref)
    print(f"measured points stage {kind} {cfg} P={p}: "
          + " ".join(f"{o} {v:.3e}" for o, v in errs.items())
          + f"; wrong mask over tolerance {max(own[o] / tol[o] for o in own):.1f}")
    _bwd_close(k, ref, (cfg, "coarse" if coarse else "fine"), plants,
               SHADED_BWD_TOL if kind == "shaded" else MLP_BWD_TOL)
    assert max(own[o] / tol[o] for o in own) >= 2.0, own


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["shaded", "mlp"], ids=["K5", "K6"])
@pytest.mark.parametrize("cfg", ["narrow", "default"])
@pytest.mark.parametrize("coarse", [True, False], ids=["coarse", "fine"])
@pytest.mark.parametrize("p", [4099, 224000])
def test_points_stage_last_tile(cuda, kind, cfg, coarse, p):
    """Under a cotangent zero outside the last 64-point tile, K5's and K6's
    weight and bias sums within the pass's tolerance of the plain backward
    on the kernel's own recompute, and the bias gradients without the last
    128-point tile (the partials a persistent tile loop drops) and dW
    without the last 64-point tile both at 2x it or more."""
    k, ref, fn, args, tol, _ = _points_run(kind, cfg, coarse, p, cuda, True)
    stage = ("dW", "db", "last layer")
    errs = {o: v for o, v in bwd_errs(k, ref).items() if o in stage}
    caught = {"bias partials of the last tile dropped":
              planted_points(fn, args, ref)["bias partials of the last tile dropped"],
              "dW without the last tile": planted_last_tile(fn, args, ref)}
    over = {n: max(e[o] / tol[o] for o in stage) for n, e in caught.items()}
    print(f"measured points stage {kind} {cfg} P={p}, last tile only: "
          + " ".join(f"{o} {v:.3e}" for o, v in errs.items())
          + "; plants over tolerance " + " ".join(f"{n}: {r:.1f}" for n, r in over.items()))
    assert all(errs[o] <= tol[o] for o in stage), errs
    assert all(r >= 2.0 for r in over.values()), over


@pytest.mark.gpu
def test_weight_stage_same_bits_at_the_grid_fine_shape(cuda):
    """K5 at the grid step's fine pass, 7000 x 130 = 910,000 points (15
    weight splits): two runs give the same bits (fixed-order sums, no
    atomics)."""
    nc, mlp, depth, skips = _pass("default", False)
    packed = pack_mlp_params(mlp, nc.emb_freqs_xyz, skips)
    feat, basis16, nb = _shaded_inputs(nc, 7000, 130, cuda)
    ws, bs = _flat_weights(packed)
    dout8 = shaded_cotangent(fused_shaded_mlp_plain(packed, feat, basis16, depth, skips, 130, nb),
                             130)
    args = (ws, bs, feat, basis16, dout8, depth, skips, 130, nb)
    a = fused_shaded_mlp_bwd(*args)
    b = fused_shaded_mlp_bwd(*args)
    for x, y in zip([*a[0], *a[1], a[2], a[3]], [*b[0], *b[1], b[2], b[3]]):
        assert torch.equal(x, y)


# K3's narrow fine dbasis beyond the shapes its tolerance was set at (53-101
# rays): 256 x 32, 34 x 241 and 7000 x 32 points
DBASIS_SHAPES = [(256, 32), (34, 241), (7000, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("rays,s", DBASIS_SHAPES)
def test_render_backward_narrow_fine_dbasis_spread(cuda, rays, s):
    """K3 at the narrow fine pass: dbasis of the kernel and of the fp32
    plain backward, each against the plain backward with float64 sums
    (the same rounding points), and the worst ray of each.  The kernel is
    at least as close to the float64 sums as the fp32 plain version (whose
    own spread sets the narrow fine dbasis tolerance), and within that
    tolerance of the plain version."""
    _, args = _bwd_case("narrow", False, s, rays, True, cuda)
    k = fused_render_bwd(*args)
    ref = fused_render_bwd_plain(*args)
    ref64 = fused_render_bwd_plain(*args[:6], args[6].double(), *args[7:])
    spread = {}
    for name, got in (("kernel", k[3]), ("plain fp32", ref[3])):
        spread[name] = rel_l2(got, ref64[3])
        err = (got.double() - ref64[3]).norm(dim=1)
        ray = int(err.argmax())
        print(f"measured {rays}x{s} {name} dbasis vs float64: rel L2 "
              f"{rel_l2(got, ref64[3]):.3e}, worst ray {ray} abs {float(err[ray]):.3e} "
              f"(its norm {float(ref64[3][ray].norm()):.3e})")
    print(f"measured {rays}x{s} kernel vs plain fp32 dbasis rel L2 {rel_l2(k[3], ref[3]):.3e}")
    assert spread["kernel"] <= spread["plain fp32"], spread
    assert rel_l2(k[3], ref[3]) <= BWD_TOL[("narrow", "fine")]["dbasis"]


# ------------------------------------------------------- the compiled epoch

# step kinds of the graph route (train/steps.py StageEpoch): (stage, image
# side, widths, the train config's and the NeRF config's changes).  The
# narrow kinds take 128 rays of 16 importance samples: the 24x24 images
# have 576 pixels <= 8 x 128 rays, drawn with torch.randperm; the 64x64
# ones with torch.randint.  The default kinds are the main path's step
# kinds (tools/card_kinds.STEP_KINDS): Config() widths, 7000 rays from
# 800x800 images.
GRAPH_KINDS = {
    "importance stage 1": (1, 64, "narrow", {}, {}),
    "importance stage 2": (2, 64, "narrow", {}, {}),
    "randperm pixels": (1, 24, "narrow", {}, {}),
    "grid stage 1": (1, 64, "narrow", {"fine_mode": "grid"}, {}),
    "grid remat_shade": (1, 64, "narrow", {"fine_mode": "grid", "remat_shade": True}, {}),
    "coarse-free stage 2": (2, 64, "narrow", {}, COARSE_FREE),
    "cam_param stage 0": (0, 64, "narrow", {}, {}),
    **{f"{kind} default": (stage, 800, "default", train_kw, nerf_kw)
       for kind, (stage, train_kw, nerf_kw) in STEP_KINDS.items()},
}


def _graph_workload(kind, device):
    from mc_nerf_torch.config import Config, TrainConfig
    from mc_nerf_torch.tools.scene import train_workload
    from mc_nerf_torch.train.optim import build_optimizers, counter, flatten_params
    from mc_nerf_torch.train.steps import TrainState

    stage, side, widths, train_kw, nerf_kw = GRAPH_KINDS[kind]
    small = {"rays_per_batch": 128, "importance_samples": 16} if widths == "narrow" else {}
    cfg = Config(train=TrainConfig(**small, **train_kw),
                 nerf=NerfConfig(**CFGS[widths], **nerf_kw))
    params, data = train_workload(cfg, 0, device, n_images=4, img_h=side, img_w=side)
    p_flat = flatten_params(params)
    txs, states = build_optimizers(cfg, params, p_flat, 10)
    # the middle of the protocol: the BARF gate moves every step
    return cfg, stage, side, TrainState(params, p_flat, states, counter(143000, device)), data, txs


def _graph_state(state, stage):
    o = state.opt_states[stage]
    return [state.p_flat, o.mu, o.nu, o.count, state.step]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(GRAPH_KINDS))
def test_graph_epoch_matches_the_loop_bit_for_bit(cuda, kind):
    """Two epochs of 6 steps through the captured step and
    through the loop, from the same state and seeds: the same p_flat,
    moments, count and step, bit for bit, and the same metric means; the
    graph was captured once (after its warm-up) and replayed 12 times;
    the kernels' wrappers count as many launches a step in the loop's
    steps as in the graph's warm-up and capture (a replay runs the
    captured launches without them)."""
    from mc_nerf_torch.train.steps import WARMUP_STEPS, make_stage_epoch

    cfg, stage, side, state, data, txs = _graph_workload(kind, cuda)
    start = [t.clone() for t in _graph_state(state, stage)]
    counters = (fused_render, render_bwd_points, render_bwd_weights, fused_mlp_apply,
                fused_shaded_mlp, fused_shaded_mlp_bwd, sample_pdf_cuda)
    out = {}
    for graph in (False, True):
        for t, s in zip(_graph_state(state, stage), start):
            t.copy_(s)
        ep = make_stage_epoch(cfg, stage, txs[stage], side, side, 286000, 6, graph=graph)
        gen = torch.Generator(device=cuda)
        before = [c.launches for c in counters]
        means = [ep(state, data, gen.manual_seed(seed)) for seed in (1, 2)]
        torch.cuda.synchronize()
        launched = [c.launches - n for c, n in zip(counters, before)]
        out[graph] = ([t.clone() for t in _graph_state(state, stage)], means, dict(ep.counts),
                      launched)
    (a, ma, ca, la), (b, mb, cb, lb) = out[False], out[True]
    assert ca == {"warmup": 0, "captured": 0, "replayed": 0, "looped": 12}
    assert cb == {"warmup": WARMUP_STEPS, "captured": 1, "replayed": 12, "looped": 0}
    assert [n / 12 for n in la] == [n / (WARMUP_STEPS + 1) for n in lb], (la, lb)
    assert stage == 0 or sum(la) > 0
    for name, x, y in zip(("p_flat", "mu", "nu", "count", "step"), a, b):
        assert torch.equal(x, y), name
    assert int(b[4]) == 143012 and not torch.equal(a[0], start[0])
    for m, n in zip(ma, mb):
        assert {k: float(v) for k, v in m.items()} == {k: float(v) for k, v in n.items()}


@pytest.mark.gpu
def test_graph_epoch_refuses_a_rebound_map(cuda):
    """A map rebound after the capture (``data._replace(occ=...)``) is
    refused before the first replay of the epoch, naming it; the map
    written in place is taken."""
    from mc_nerf_torch.train.steps import StaleGraphBuffer, make_stage_epoch

    cfg, stage, side, state, data, txs = _graph_workload("importance stage 1", cuda)
    ep = make_stage_epoch(cfg, stage, txs[stage], side, side, 286000, 3, graph=True)
    gen = torch.Generator(device=cuda).manual_seed(1)
    ep(state, data, gen)
    data.occ.copy_(torch.zeros_like(data.occ))
    ep(state, data, gen)
    with pytest.raises(StaleGraphBuffer, match="occ"):
        ep(state, data._replace(occ=data.occ.clone()), gen)
    assert ep.counts["replayed"] == 6


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["importance stage 1", "cam_param stage 0"])
def test_graph_epoch_departs_from_the_loop_on_a_value_the_capture_freezes(cuda, kind,
                                                                         monkeypatch):
    """A value made from the host's count of the steps it issued (stage 1:
    the progress clock the loss reads; stage 0: the count of the LR
    schedule) is right in the loop and frozen by a capture: two epochs of
    6 steps from the start state and seed with it, the loop's ends on the
    loop's bits without it, the graph's (its warm-up and capture, then its
    replays alone) does not.  The plant shows that the bit comparison of
    the graph route sees a value the capture froze."""
    import mc_nerf_torch.train.steps as steps_module
    from mc_nerf_torch.train.optim import FlatRAdam

    cfg, stage, side, state, data, txs = _graph_workload(kind, cuda)
    live = _graph_state(state, stage)
    start = [t.clone() for t in live]
    host = {"n": 0}
    gen = torch.Generator(device=cuda)

    def issued(dtype):
        host["n"] += 1
        return torch.full((), host["n"] - 1, dtype=dtype, device=cuda)

    def run(graph, tx):
        ep = steps_module.make_stage_epoch(cfg, stage, tx, side, side, 286000, 6, graph=graph)
        for _ in range(2):
            host["n"] = 0
            for t, s in zip(live, start):
                t.copy_(s)
            ep(state, data, gen.manual_seed(1))
        torch.cuda.synchronize()
        return [t.clone() for t in live]

    tx = txs[stage]
    want = run(False, tx)
    if stage == 1:
        real = steps_module.make_loss_fn

        def make_loss_fn(*a, **kw):
            fn = real(*a, **kw)
            return lambda prm, dat, draws, step: fn(prm, dat, draws,
                                                    issued(torch.int32) + 143000)

        monkeypatch.setattr(steps_module, "make_loss_fn", make_loss_fn)
    else:
        lr = tx.lr
        tx = FlatRAdam(tx.mask, lambda t: lr(issued(torch.float32)), tx.weight_decay, tx.clip)
    assert all(torch.equal(x, y) for x, y in zip(run(False, tx), want))
    graph = run(True, tx)
    gap = max(float((x.double() - y.double()).abs().max()) for x, y in zip(graph, want))
    print(f"measured {kind}: the graph with the host's count {gap:.3e} from the loop's bits")
    assert gap > 0


# -------------------------------------------------------- the compiled frame

# eval modes of the graph frame (train/steps.py FrameRender) and their
# launches a chunk of the eval wrappers FRAME_COUNTERS: tools/card_kinds'
# FRAME_MODES and FRAME_LAUNCHES
FRAME_COUNTERS = (fused_mlp_apply_rays, fused_render_rays, fused_shaded_mlp_rays, sample_pdf_cuda)
# (side, chunk, NeRF config) by widths: narrow, 40 x 40 = 1600 pixels in
# chunks of 512 rays, the fourth chunk mostly padding; the main path's,
# Config() at the engine's validation size, 200 x 200 in chunks of 16384,
# the third padded
FRAME_SIDE, FRAME_CHUNK = 40, 512
FRAME_WIDTHS = {"narrow": (FRAME_SIDE, FRAME_CHUNK, dict(NARROW, occ_grid_size=32)),
                "default": (200, 16384, {})}


def _frame_workload(mode, device, seed=0, epoch=0, widths="narrow"):
    """A config of ``mode`` at ``widths``, seeded weights and, where the
    mode has one, a fresh map refreshed from them with ``epoch``'s jitter."""
    from mc_nerf_torch.config import Config, EvalConfig
    from mc_nerf_torch.tools.scene import scene_params
    from mc_nerf_torch.train.engine import refresh_occupancy

    ev_kw, nerf_kw, occ = FRAME_MODES[mode]
    _, chunk, nerf_widths = FRAME_WIDTHS[widths]
    cfg = Config(nerf=NerfConfig(**nerf_widths, **nerf_kw),
                 eval=EvalConfig(rays_per_chunk=chunk, **ev_kw))
    params = scene_params(cfg.nerf, seed, device=device)
    return cfg, params, refresh_occupancy(params, cfg, device, epoch) if occ else None


def _frame_views(side=FRAME_SIDE):
    from mc_nerf_torch.tools.scene import orbit_views

    return orbit_views((0.3, 2.2), side, side)


@pytest.mark.gpu
@pytest.mark.parametrize("widths", sorted(FRAME_WIDTHS))
@pytest.mark.parametrize("mode", sorted(FRAME_MODES))
def test_graph_frame_matches_the_loop_bit_for_bit(cuda, mode, widths):
    """One frame through the captured graph and through the chunk loop,
    from the same weights, pose and map: rgb, depth and opacity the same
    bits; the graph captured once, for the map's kind, and replayed once
    a frame; each eval kernel (K1, K2 and K4 through the eval path's rays
    entry points, sample_pdf's) launched by the loop as often a chunk as
    the mode wants, and at the capture as often (the wrappers count the
    capture's launches once)."""
    from mc_nerf_torch.train.steps import make_render_fn

    cfg, params, occ = _frame_workload(mode, cuda, widths=widths)
    side, chunk, _ = FRAME_WIDTHS[widths]
    (pose, _), K = _frame_views(side)
    loop = make_render_fn(cfg, side, side, device=cuda, graph=False)
    graph = make_render_fn(cfg, side, side, device=cuda, graph=True)
    launched = {}
    for name, render in (("loop", loop), ("graph", graph)):
        for c in FRAME_COUNTERS:
            c.launches = 0
        out = render(params, pose, K, occ)
        torch.cuda.synchronize()
        launched[name] = [c.launches for c in FRAME_COUNTERS]
        launched[name + " out"] = out
    a, b = launched["loop out"], launched["graph out"]
    for name, x, y in zip(("rgb", "depth", "opacity"), a, b):
        assert x.shape == y.shape and torch.equal(x, y), name
    assert bool(torch.isfinite(a[0]).all()) and float(a[0].std()) > 0
    chunks = -(-side ** 2 // chunk)
    assert launched["loop"] == [FRAME_LAUNCHES[mode].get(c.__name__, 0) * chunks
                                  for c in FRAME_COUNTERS]
    # the capture's launches are the loop's, plus one chunk of warm-up
    assert launched["graph"] == [n + n // chunks for n in launched["loop"]]
    assert loop.counts == {"captured": 0, "replayed": 0, "looped": 1}
    assert graph.counts == {"captured": 1, "replayed": 1, "looped": 0}
    assert list(graph.captures) == [graph.graph_key(occ)]


@pytest.mark.gpu
@pytest.mark.parametrize("widths", sorted(FRAME_WIDTHS))
@pytest.mark.parametrize("mode", sorted(FRAME_MODES))
def test_graph_frame_takes_new_weights_pose_and_map(cuda, mode, widths):
    """After the capture, new weights (the first scaled by 1.01), a new
    pose and a new map of the same kind (the first with the half of the
    box at x < 0 emptied) reach the replay: it equals the loop on them,
    bit for bit, without a second capture; the first frame's tensors
    still hold what they held."""
    from mc_nerf_torch.train.steps import make_render_fn

    cfg, params, occ = _frame_workload(mode, cuda, widths=widths)
    side = FRAME_WIDTHS[widths][0]
    (pose, pose2), K = _frame_views(side)
    graph = make_render_fn(cfg, side, side, device=cuda, graph=True)
    loop = make_render_fn(cfg, side, side, device=cuda, graph=False)
    first = graph(params, pose, K, occ)
    kept = [t.clone() for t in first]
    params2 = copy.deepcopy(params)
    with torch.no_grad():
        for p in params2.parameters():
            p.mul_(1.01)
    occ2 = None
    if occ is not None:
        occ2 = occ.clone()
        occ2[: occ.shape[0] // 2] = 0
        assert not torch.equal(occ2, occ)
    second = graph(params2, pose2, K, occ2)
    want = loop(params2, pose2, K, occ2)
    torch.cuda.synchronize()
    for name, x, y in zip(("rgb", "depth", "opacity"), second, want):
        assert torch.equal(x, y), name
    for x, y in zip(first, kept):
        assert torch.equal(x, y)
    assert not torch.equal(second[0], first[0])
    assert graph.counts == {"captured": 1, "replayed": 2, "looped": 0}


@pytest.mark.gpu
def test_graph_frame_captures_anew_after_release(cuda, tmp_path):
    """``Engine.close`` releases the frame graphs of the engine's
    renderers and forgets them; the next frame captures anew, in a new
    renderer, and renders the same bits.  A renderer released alone
    captures again at its next frame."""
    from mc_nerf_torch.config import PathsConfig
    from mc_nerf_torch.data.synthetic import make_dataset
    from mc_nerf_torch.train.engine import Engine

    cfg, params, occ = _frame_workload("importance culled", cuda)
    (pose, _), K = _frame_views()
    make_dataset(str(tmp_path / "Tiny"), n_train=2, n_val=1, n_test=1, img_h=FRAME_SIDE,
                 img_w=FRAME_SIDE, seed=3)
    out = str(tmp_path / "out")
    eng = Engine(cfg.replace(data_root=str(tmp_path), data_name="Tiny", tensorboard=False,
                             paths=PathsConfig(root_weights=out, root_out=out, log_path=out,
                                               tb_path=out)), device=cuda)
    render = eng._render_fn(FRAME_SIDE, FRAME_SIDE)
    a = render(params, pose, K, occ)
    assert render.counts["captured"] == 1 and render._graphs
    eng.close()
    assert eng._render_fns == {} and render._graphs == {}
    again = eng._render_fn(FRAME_SIDE, FRAME_SIDE)
    assert again is not render
    b = again(params, pose, K, occ)
    assert again.counts == {"captured": 1, "replayed": 1, "looped": 0}
    again.release()
    c = again(params, pose, K, occ)
    torch.cuda.synchronize()
    assert again.counts == {"captured": 2, "replayed": 2, "looped": 0}
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(x, z)


# ------------------------------------------------------------ sample_pdf

# Depths in [1, 8].  The kernel sums and scans each PMF row in its own
# order, so a draw on a plateau of the CDF may move far in depth; each
# draw is held within rounding of the plain body's by draw_gap (its depth
# within 2e-5, or its place on the CDF within 4e-6)
SAMPLE_PDF_SHAPES = [(66, 48), (48, 32), (128, 64), (130, 64), (7, 3)]
# PMF values (eps 0) whose CDF ends below 1: -3M at 0 and 1, 3M + 1 at 32
# and 33, 1 at 64 (M = 2**21) sum to 3, and divided by it read -M, -M,
# M + 1/4 (M + 1/3 rounded), M + 1/4, 1/3, so the CDF climbs -M, -2M, ...,
# -M + 1/4, 1/2, ..., 5/6 and a draw above 5/6 finds no bin above it (the
# 1e10 bracket).  Every sum of the weights is exact, and so is every
# prefix of the PMF that the kernel (its scan a slot of 32 at a time) or a
# left-to-right sum takes; other windows (1/3 with an odd number of the
# M's) round, and the card's scan of a single row (CUB) may take them
BELOW_U_PMF = {0: -3.0 * 2 ** 21, 1: -3.0 * 2 ** 21, 32: 3.0 * 2 ** 21 + 1,
               33: 3.0 * 2 ** 21 + 1, 64: 1.0}


def _pdf_case(s, k, rows, rays, draws, device, seed=0):
    """(z, weights, uniforms or None, eps) of one sample_pdf call: sorted
    depths in [1, 8] (``"stride-0 z"``: one row for every ray, as the
    eval's probe ladder), weights of half empty bins (``"all-zero"``: the
    uniform fallback; ``"spike"``: one bin a ray; ``"two surfaces"``: two
    peaks with a plateau between; ``"last CDF below u"``: BELOW_U_PMF, the
    last draw at 0.99 where there are uniforms)."""
    rng = np.random.default_rng(seed * 1000 + 7 * s + k)
    z = np.sort(rng.uniform(1.0, 8.0, (rays, s)), axis=-1)
    w = rng.uniform(0.0, 1.0, (rays, s)) * (rng.uniform(size=(rays, s)) < 0.5)
    u = rng.uniform(size=(rays, k)) if draws == "uniforms" else None
    eps = 1e-5
    if rows in ("all-zero", "spike", "last CDF below u"):
        w[:] = 0.0
    if rows == "spike":
        w[np.arange(rays), rng.integers(1, s - 1, rays)] = 1.0
    if rows == "two surfaces":
        j = np.arange(s)[None]
        c1, c2 = rng.integers(1, max(2, s // 2), (2, rays, 1)) + np.array([0, s // 2])[:, None, None]
        a = rng.uniform(size=(rays, 1))
        w = a * np.exp(-0.5 * (j - c1) ** 2) + (1 - a) * np.exp(-0.5 * (j - np.minimum(c2, s - 2)) ** 2)
    if rows == "last CDF below u":
        for j, v in BELOW_U_PMF.items():
            w[:, 1 + j] = v
        eps = 0.0
        if u is not None:
            u[:, -1] = 0.99
    z = torch.as_tensor(z, dtype=torch.float32, device=device)
    if rows == "stride-0 z":
        z = z[:1].expand(rays, s)
    w = torch.as_tensor(w, dtype=torch.float32, device=device)
    u = None if u is None else torch.as_tensor(u, dtype=torch.float32, device=device)
    return z, w, u, eps


def _pdf_counts():
    c = trace.snapshot()["counters"]
    return c.get("sample_pdf.kernel", 0), c.get("sample_pdf.plain", 0), sample_pdf_cuda.launches


@pytest.mark.gpu
@pytest.mark.parametrize("s,k", SAMPLE_PDF_SHAPES)
@pytest.mark.parametrize("draws", ["midpoints", "uniforms"])
@pytest.mark.parametrize("rows", ["random", "all-zero", "spike", "two surfaces", "stride-0 z"])
@pytest.mark.parametrize("rays", [1, 1001])
def test_sample_pdf_kernel_matches_plain(cuda, s, k, draws, rows, rays):
    """The kernel against sample_pdf_plain: every draw within rounding
    (draw_gap), one launch counted; 1001 rays is no multiple of a block's
    8; S = 130 is the kernel's ceiling of 128 PMF values."""
    z, w, u, eps = _pdf_case(s, k, rows, rays, draws, cuda)
    before = sample_pdf_cuda.launches
    out = sample_pdf_cuda(z, w, k, u, eps)
    assert sample_pdf_cuda.launches == before + 1
    ref = sample_pdf_plain(z, w, k, u, eps=eps)
    gap = draw_gap(out, ref, z, w, eps)
    print(f"measured sample_pdf draw gap {gap:.3e}, max abs depth "
          f"{float((out - ref).abs().max()):.3e} s={s} k={k} {draws} {rows} R={rays}")
    assert tuple(out.shape) == (rays, k) and bool(torch.isfinite(out).all())
    assert gap <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("s", [128, 130])
@pytest.mark.parametrize("draws", ["midpoints", "uniforms"])
@pytest.mark.parametrize("rays", [1, 1001])
def test_sample_pdf_kernel_takes_the_1e10_bracket(cuda, s, draws, rays):
    """On rows whose CDF ends at 5/6 (BELOW_U_PMF), the draws above it
    find no bin above them and take the plain body's 1e10 bracket: past
    the last midpoint, within rounding of the plain body run on the CPU,
    whose left-to-right prefix in double is exact on these rows."""
    z, w, u, eps = _pdf_case(s, 64, "last CDF below u", rays, draws, cuda)
    out = sample_pdf_cuda(z, w, 64, u, eps)
    ref = sample_pdf_plain(z.cpu(), w.cpu(), 64, None if u is None else u.cpu(), eps=eps)
    gap = draw_gap(out.cpu(), ref, z.cpu(), w.cpu(), eps)
    last_mid = 0.5 * (z[:, -1] + z[:, -2]).cpu()
    beyond = int((out.cpu() > last_mid[:, None]).sum())
    print(f"measured sample_pdf 1e10 bracket S={s} {draws} R={rays}: draw gap {gap:.3e}, "
          f"{beyond} draws past the last midpoint")
    assert gap <= 1.0
    assert beyond > 0 and beyond == int((ref > last_mid[:, None]).sum())


# (rays, S, K, draws): the frame chunk's two calls (the coarse draw on the
# stride-0 probe ladder, the fine from the coarse weights), the train
# step's two (uniforms), and other shapes of rays and rows
SAMPLE_PDF_MAIN = [(16384, 66, 48, "midpoints"), (16384, 48, 32, "midpoints"),
                   (7000, 66, 48, "uniforms"), (7000, 48, 32, "uniforms"),
                   (8, 100, 16, "midpoints"), (40000, 66, 48, "midpoints"),
                   (16384, 7, 3, "uniforms"), (1001, 34, 20, "uniforms"),
                   (1001, 130, 64, "midpoints")]


@pytest.mark.gpu
@pytest.mark.parametrize("rays,s,k,draws", SAMPLE_PDF_MAIN)
@pytest.mark.parametrize("rows", ["random", "two surfaces"])
def test_sample_pdf_kernel_at_the_main_path_shapes(cuda, rays, s, k, draws, rows):
    """At the main path's shapes the kernel's draws are within rounding of
    the plain body's (draw_gap), and the same bits on a second call; each
    planted fault of the plain body (the midpoints one bin late; the
    draws' jitter dropped, or added where there is none) at 2x that or
    more."""
    z, w, u, eps = _pdf_case(s, k, "stride-0 z" if s == 66 and rows == "random" else rows,
                             rays, draws, cuda)
    a = sample_pdf_cuda(z, w, k, u, eps)
    b = sample_pdf_cuda(z, w, k, u, eps)
    ref = sample_pdf_plain(z, w, k, u, eps=eps)
    jitter = None if u is not None else torch.rand(
        (rays, k), generator=torch.Generator(device=cuda).manual_seed(0), device=cuda)
    plants = {"midpoints one bin late": sample_pdf_plain(z.roll(1, 1), w, k, u, eps=eps),
              "jitter " + ("dropped" if u is not None else "added"):
              sample_pdf_plain(z, w, k, jitter, eps=eps)}
    torch.cuda.synchronize()
    gap = draw_gap(a, ref, z, w, eps)
    caught = {n: draw_gap(x, ref, z, w, eps) for n, x in plants.items()}
    print(f"measured sample_pdf R={rays} S={s} K={k} {draws} {rows}: draw gap {gap:.3e}, "
          f"{int((a != ref).sum())} of {a.numel()} depths differ, max abs "
          f"{float((a - ref).abs().max()):.3e}; plants " + " ".join(
              f"{n}: {g:.1f}" for n, g in caught.items()))
    assert torch.equal(a, b)
    assert gap <= 1.0
    assert all(g >= 2.0 for g in caught.values()), caught


@pytest.mark.gpu
def test_sample_pdf_kernel_carries_nan_as_plain(cuda):
    """A NaN weight, depth or uniform makes its ray's depths NaN where the
    plain body's are; the other rays keep within rounding of them."""
    z, w, u, eps = _pdf_case(48, 32, "random", 64, "uniforms", cuda)
    z = z.clone()
    w[3, 10] = float("nan")
    z[7, 20] = float("nan")
    u[11, 5] = float("nan")
    out = sample_pdf_cuda(z, w, 32, u, eps)
    ref = sample_pdf_plain(z, w, 32, u, eps=eps)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(out), torch.isnan(ref))
    assert bool(torch.isnan(ref[[3, 7, 11]]).any(dim=1).all())
    keep = ~torch.isnan(ref).any(dim=1)
    assert draw_gap(out[keep], ref[keep], z[keep], w[keep], eps) <= 1.0


@pytest.mark.gpu
def test_sample_pdf_kernel_replays_in_a_cuda_graph(cuda):
    """sample_pdf captured in a CUDA graph (the stride-0 probe ladder, as
    in the frame's graph): a replay on new inputs copied into the captured
    tensors gives the eager call's bits; the capture counts one kernel
    call, the replay none."""
    z, w, u, eps = _pdf_case(66, 48, "random", 4096, "uniforms", cuda)
    z2, w2, u2, _ = _pdf_case(66, 48, "random", 4096, "uniforms", cuda, seed=1)
    ladder = z[:1].clone()
    zs, ws, us = ladder.expand(4096, 66), w.clone(), u.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sample_pdf(zs, ws, 48, uniforms=us)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = _pdf_counts()
    with torch.cuda.graph(graph):
        out = sample_pdf(zs, ws, 48, uniforms=us)
    assert _pdf_counts() == (before[0] + 1, before[1], before[2] + 1)
    ladder.copy_(z2[:1])
    ws.copy_(w2)
    us.copy_(u2)
    graph.replay()
    want = sample_pdf(z2[:1].expand(4096, 66), w2, 48, uniforms=u2)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert not torch.equal(out, sample_pdf(z[:1].expand(4096, 66), w, 48, uniforms=u))
    assert _pdf_counts() == (before[0] + 3, before[1], before[2] + 3)


@pytest.mark.gpu
def test_sample_pdf_refused_launch_raises(cuda):
    """A launch the kernel refuses (no draws a ray) raises and counts no
    launch."""
    z, w, u, eps = _pdf_case(48, 32, "random", 100, "uniforms", cuda)
    out = torch.empty((100, 0), device=cuda)
    before = sample_pdf_cuda.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        _launch(z, w, None, out, eps)
    assert sample_pdf_cuda.launches == before


@pytest.mark.gpu
def test_sample_pdf_routes_by_what_it_sees_on_the_card(cuda):
    """On CUDA tensors sample_pdf launches the kernel and nothing else: an
    input that requires grad (outside no_grad), a float64 input and a row
    past the kernel's ceiling raise ValueError, and count no call; an
    input that requires grad under no_grad launches."""
    z, w, u, eps = _pdf_case(48, 32, "random", 300, "uniforms", cuda)
    before = _pdf_counts()
    out = sample_pdf(z, w, 32, uniforms=u)
    assert _pdf_counts() == (before[0] + 1, before[1], before[2] + 1)
    wg = w.clone().requires_grad_()
    zl, wl, _, _ = _pdf_case(max_bins() + 2, 8, "random", 30, "midpoints", cuda)
    for args in ((z, wg, 32, u), (z.double(), w.double(), 32, u.double()), (zl, wl, 8, None)):
        with pytest.raises(ValueError, match="sample_pdf_cuda"):
            sample_pdf(args[0], args[1], args[2], uniforms=args[3])
    assert _pdf_counts() == (before[0] + 1, before[1], before[2] + 1)
    with torch.no_grad():
        out_g = sample_pdf(z, wg, 32, uniforms=u)
    torch.cuda.synchronize()
    assert _pdf_counts() == (before[0] + 2, before[1], before[2] + 2)
    assert torch.equal(out, out_g)
