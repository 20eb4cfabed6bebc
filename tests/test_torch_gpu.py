"""The CUDA kernels against their plain PyTorch versions, on a CUDA card:
fused_mlp_apply, fused_render (forward and backward), fused_shaded_mlp
(forward and backward) and the differentiable fused_mlp's backward.

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
    fused_mlp_bwd,
    fused_mlp_bwd_plain,
    fused_shaded_mlp,
    fused_shaded_mlp_bwd,
    fused_shaded_mlp_bwd_plain,
    fused_shaded_mlp_plain,
    mlp_plain,
    pack_mlp_params,
)
from mc_nerf_torch.ops.cuda.fused_render import (
    _render_fwd,
    fused_render,
    fused_render_bwd,
    fused_render_bwd_plain,
    fused_render_plain,
    max_samples,
    max_samples_bwd,
    render_bwd_points,
    render_bwd_weights,
)
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
from mc_nerf_torch.tools.scene import scene_params

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
    """K2 at the training flags (noise, noise_sel, wsel) on the fine pack
    over 54 rays within its tolerances, and each planted fault of the plain
    version at 2x them or more: the skip input dropped, the first layer
    lost, the samples of each pair of rays swapped, the composite's prefix
    sums one sample late (``tools/bwd_check.render_scan_late``)."""
    nc, params = _params(cfg_kw, seed=s)
    packed = pack_mlp_params(params.fine, nc.emb_freqs_xyz, nc.fine_skips)
    args = _render_args(nc, packed, nc.fine_depth, nc.fine_skips, s, 54, True, True, cuda)
    ref = fused_render_plain(*args)
    assert _render_over(*fused_render(*args), *ref) <= 1.0
    skipless = pack_mlp_params(params.fine, nc.emb_freqs_xyz, nc.fine_skips)
    for i in nc.fine_skips:
        skipless.trunk_w[i][:args[1].shape[1]] = 0
    firstless = pack_mlp_params(params.fine, nc.emb_freqs_xyz, nc.fine_skips)
    firstless.trunk_w[0].zero_()
    swapped = args[1].view(54, s, -1)[torch.arange(54, device=cuda).view(-1, 2).flip(1)
                                       .reshape(-1)].reshape(54 * s, -1)
    plants = {"skip input dropped": fused_render_plain(skipless, *args[1:]),
              "first layer lost": fused_render_plain(firstless, *args[1:]),
              "pairs of rays swapped": fused_render_plain(args[0], swapped, *args[2:]),
              "scan one sample late": render_scan_late(*args)}
    over = {n: _render_over(*o, *ref) for n, o in plants.items()}
    print(f"measured render plants over tolerance {cfg_kw and 'narrow' or 'default'} s={s}: "
          + " ".join(f"{n}: {r:.1f}" for n, r in over.items()))
    assert all(r >= 2.0 for r in over.values()), over


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
    launch counted; another ray's basis (where there is one) and the skip
    input dropped land outside the tolerances."""
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
