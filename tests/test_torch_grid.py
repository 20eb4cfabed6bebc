"""The grid fine mode of the port against the JAX package, on the CPU:
its modules and the eval render.

``select_fine_bins`` and ``expand_bins_to_samples``; ``fused_shaded_mlp``
forward and backward and the differentiable ``fused_mlp`` (the port's
plain versions of their kernels on CPU tensors, against the Pallas kernels
in interpret mode, as the JAX package's own tests run them);
``render_rays_eval`` in grid mode by both routes; ``make_render_fn`` over
padded chunks; ``demo``.  Inputs come from numpy with a seed, the weights
through ``nerf_params_from_numpy``.  Sizes: 2x32 MLPs with a skip at 1, 4
octaves, 16 coarse samples, 5 bins x 3 fine samples per ray, 40 rays.
The training slice is ``tests/test_torch_grid_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_nerf_tpu import config as j_config
from mc_nerf_tpu.models.mlp import init_nerf_mlp as j_init_mlp
from mc_nerf_tpu.models.nerf import init_nerf_params as j_init_params
from mc_nerf_tpu.models.nerf import pack_eval_params as j_pack_eval
from mc_nerf_tpu.models.nerf import render_rays_eval as j_render_eval
from mc_nerf_tpu.models.sh import sh_basis as j_sh_basis
from mc_nerf_tpu.ops import volume as j_vol
from mc_nerf_tpu.ops.pallas import fused_mlp as j_fm
from mc_nerf_tpu.train.steps import make_render_fn as j_make_render_fn

from mc_nerf_torch import config as t_config
from mc_nerf_torch.models.nerf import (
    _mlp_from_numpy,
    nerf_params_from_numpy,
    pack_eval_params,
    render_rays_eval,
)
from mc_nerf_torch.ops import volume as t_vol
from mc_nerf_torch.ops.cuda import fused_mlp as t_fm
from mc_nerf_torch.train import steps as t_steps

CPU = "cpu"
NFREQ, SH_DEG = 4, 2
NB = (SH_DEG + 1) ** 2
DEPTH, WIDTH, SKIPS = 2, 32, (1,)
CFG_KW = dict(samples_coarse=16, sample_scale=3, fine_bins_topk=5, emb_freqs_xyz=NFREQ,
              coarse_depth=DEPTH, coarse_width=WIDTH, coarse_skips=SKIPS,
              fine_depth=DEPTH, fine_width=WIDTH, fine_skips=SKIPS, sh_deg=SH_DEG,
              occ_grid_size=16, occ_probes=16, occ_coarse_samples=16)


def _t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x)).to(dtype)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close_scaled(got, ref, frac, name, floor=0.0):
    """max |got - ref| <= frac * max|ref| + floor."""
    ref = np.asarray(ref, np.float32)
    scale = max(1e-6, float(np.abs(ref).max()))
    np.testing.assert_allclose(_np(got), ref, rtol=0, atol=frac * scale + floor, err_msg=name)


# --------------------------------------------------------- select / expand

def _weights_case(case):
    rng = np.random.default_rng(3)
    w = rng.uniform(0.0, 0.02, size=(33, 16)).astype(np.float32)
    w *= rng.random((33, 16)) < 0.5                 # rays with few or many bins
    if case == "below_thresh":
        w *= 0.04                                   # the batch's max < weight_thresh
    elif case == "empty_rays":
        w[:5] = 0.0                                 # rays with no bin at all
    elif case == "dense":
        w[:] = rng.uniform(0.01, 0.02, size=w.shape)  # every bin kept, k binds
    return w


@pytest.mark.parametrize("case", ["random", "below_thresh", "empty_rays", "dense"])
@pytest.mark.parametrize("k", [4, 16])
def test_select_and_expand_match_jax(case, k):
    """bin_idx / valid and the expanded sample indices equal the JAX
    package's exactly: the cutoff is min(thresh, the batch's max), the
    first k kept bins in z order, invalid slots at S - 1."""
    w = _weights_case(case)
    if case == "below_thresh":
        assert w.max() < 1e-3
    jb, jv = j_vol.select_fine_bins(jnp.asarray(w), k, 1e-3)
    tb, tv = t_vol.select_fine_bins(torch.as_tensor(w), k, 1e-3)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    js, jsv = j_vol.expand_bins_to_samples(jb, jv, 3)
    ts, tsv = t_vol.expand_bins_to_samples(tb, tv, 3)
    assert tuple(ts.shape) == (w.shape[0], 3 * k)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tsv.numpy(), np.asarray(jsv))


# ------------------------------------------------- fused_shaded_mlp, fused_mlp

def _mlp_setup(seed, rays, s):
    """The same MLP on both sides (JAX leaves into the port's module) and
    seeded numpy inputs: kernel-order features of points on rays from
    (0, 0, -3), the rays' SH basis padded to 16 lanes."""
    jm = j_init_mlp(jax.random.PRNGKey(seed), 3 * (2 * NFREQ + 1), DEPTH, WIDTH, SKIPS, 3 * NB)
    tm = _mlp_from_numpy(jax.tree.map(np.asarray, jm), SKIPS, CPU)
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    z = rng.uniform(1.0, 6.0, size=(rays, s)).astype(np.float32)
    xyz = (np.array([0.0, 0.0, -3.0], np.float32) + d[:, None] * z[..., None]).reshape(-1, 3)
    feat = np.asarray(j_fm.encode_kernel_order(jnp.asarray(xyz), NFREQ), np.float32)
    basis16 = np.pad(np.asarray(j_sh_basis(SH_DEG, jnp.asarray(d))),
                     ((0, 0), (0, 16 - NB))).astype(np.float32)
    return jm, tm, feat, basis16, rng


def _leaves(p):
    return [*p.trunk_w, *p.trunk_b, p.head_w0, p.head_b0, p.head_w1, p.head_b1]


@pytest.mark.parametrize("rays,s", [(37, 6), (9, 1)])
def test_fused_shaded_mlp_forward_matches_pallas(rays, s):
    """Ragged ray counts (not a multiple of the Pallas 8-ray block): sigma
    max abs error over the largest output within 2e-2, rgb atol 2e-2
    (tests/test_fused_mlp.py:75-114), lanes 4..7 zero."""
    jm, tm, feat, basis16, _ = _mlp_setup(0, rays, s)
    ref = np.asarray(j_fm.fused_shaded_mlp(j_fm.pack_mlp_params(jm, NFREQ, SKIPS),
                                           jnp.asarray(feat, jnp.bfloat16), jnp.asarray(basis16),
                                           DEPTH, SKIPS, s, NB, True))
    out = t_fm.fused_shaded_mlp(t_fm.pack_mlp_params(tm, NFREQ, SKIPS),
                                torch.as_tensor(feat).bfloat16(), torch.as_tensor(basis16),
                                DEPTH, SKIPS, s, NB).numpy()
    assert out.shape == ref.shape == (rays * s, 8)
    assert np.abs(out[:, 0] - ref[:, 0]).max() <= 2e-2 * np.abs(ref[:, 0]).max()
    np.testing.assert_allclose(out[:, 1:4], ref[:, 1:4], rtol=0, atol=2e-2)
    assert np.abs(out[:, 4:]).max() == 0.0
    # the same plain arithmetic as the kernels' oracle
    np.testing.assert_array_equal(out, t_fm.fused_shaded_mlp_plain(
        t_fm.pack_mlp_params(tm, NFREQ, SKIPS), torch.as_tensor(feat).bfloat16(),
        torch.as_tensor(basis16), DEPTH, SKIPS, s, NB).numpy())


@pytest.mark.parametrize("rays,s", [(37, 6), (9, 1)])
def test_fused_shaded_mlp_grads_match_pallas(rays, s):
    """Gradients of the packed fp32 leaves, feat and basis16 against
    jax.grad through the Pallas custom VJP in interpret mode, per leaf
    atol 5e-3 * max|ref| (tests/test_fused_render.py:131); dfeat arrives in
    feat's bf16, dbasis in fp32."""
    jm, tm, feat, basis16, rng = _mlp_setup(1, rays, s)
    coeff = rng.normal(size=(rays * s, 8)).astype(np.float32)

    def j_loss(packed, f, b):
        out = j_fm.fused_shaded_mlp(packed, f, b, DEPTH, SKIPS, s, NB, True)
        return jnp.sum(out * jnp.asarray(coeff))

    j_val, (jg_p, jg_f, jg_b) = jax.value_and_grad(j_loss, argnums=(0, 1, 2))(
        j_fm.pack_mlp_params(jm, NFREQ, SKIPS, dtype=jnp.float32),
        jnp.asarray(feat, jnp.bfloat16), jnp.asarray(basis16))
    tp = t_fm.pack_mlp_params(tm, NFREQ, SKIPS, dtype=torch.float32)
    for leaf in _leaves(tp):
        leaf.retain_grad()
    t_feat = torch.as_tensor(feat).bfloat16().requires_grad_()
    t_basis = torch.as_tensor(basis16).requires_grad_()
    loss = (t_fm.fused_shaded_mlp(tp, t_feat, t_basis, DEPTH, SKIPS, s, NB)
            * torch.as_tensor(coeff)).sum()
    loss.backward()
    assert abs(float(loss.detach()) - float(j_val)) <= 2e-3 * max(1.0, abs(float(j_val)))
    for i, (a, b) in enumerate(zip(_leaves(tp), _leaves(jg_p))):
        assert a.grad.dtype == torch.float32
        _close_scaled(a.grad, b, 5e-3, f"packed leaf {i}")
    assert t_feat.grad.dtype == torch.bfloat16 and t_basis.grad.dtype == torch.float32
    _close_scaled(t_feat.grad, np.asarray(jg_f, np.float32), 5e-3, "dfeat")
    _close_scaled(t_basis.grad, jg_b, 5e-3, "dbasis")


def test_fused_shaded_mlp_bwd_plain_is_the_wrapper_on_cpu():
    """On CPU tensors the backward wrapper is the plain backward and
    launches nothing; in float64 the plain backward agrees with float32
    within relative L2 1e-3; a CUDA-less device other than the CPU raises."""
    _, tm, feat, basis16, rng = _mlp_setup(2, 11, 4)
    ws, bs = t_fm._flat_weights(t_fm.pack_mlp_params(tm, NFREQ, SKIPS))
    dout8 = torch.as_tensor(rng.normal(size=(44, 8)).astype(np.float32))
    args = (ws, bs, torch.as_tensor(feat).bfloat16(), torch.as_tensor(basis16), dout8, DEPTH,
            SKIPS, 4, NB)
    before = t_fm.fused_shaded_mlp_bwd.launches
    a, b = t_fm.fused_shaded_mlp_bwd(*args), t_fm.fused_shaded_mlp_bwd_plain(*args)
    assert t_fm.fused_shaded_mlp_bwd.launches == before
    for x, y in zip([*a[0], *a[1], a[2], a[3]], [*b[0], *b[1], b[2], b[3]]):
        assert torch.equal(x, y)
    c = t_fm.fused_shaded_mlp_bwd_plain(*args[:4], dout8.double(), *args[5:])
    for x, y in zip([*b[0], *b[1], b[2], b[3]], [*c[0], *c[1], c[2], c[3]]):
        assert float((x.double() - y).norm()) <= 1e-3 * float(y.norm())
    with pytest.raises(ValueError):
        t_fm.fused_shaded_mlp(t_fm.pack_mlp_params(tm, NFREQ, SKIPS),
                              torch.empty((44, feat.shape[1]), dtype=torch.bfloat16,
                                          device="meta"),
                              torch.empty((11, 16), device="meta"), DEPTH, SKIPS, 4, NB)


def test_fused_mlp_grads_match_custom_vjp():
    """The differentiable fused_mlp against the JAX custom VJP (the Pallas
    _bwd_kernel in interpret mode) under an MSE: the forward as
    fused_mlp_apply, the leaves' and feat's gradients within atol
    0.05 * max|ref| + 5e-5 (tests/test_fused_mlp.py:147-151), 96 points."""
    jm, tm, feat, _, rng = _mlp_setup(4, 16, 6)
    tgt = rng.uniform(0, 1, size=(96, 28)).astype(np.float32)

    def j_loss(packed, f):
        out = j_fm.fused_mlp(packed, f, DEPTH, SKIPS, 32, True)
        return jnp.mean((out[:, :28] - jnp.asarray(tgt)) ** 2)

    jg_p, jg_f = jax.grad(j_loss, argnums=(0, 1))(
        j_fm.pack_mlp_params(jm, NFREQ, SKIPS, dtype=jnp.float32), jnp.asarray(feat, jnp.bfloat16))
    tp = t_fm.pack_mlp_params(tm, NFREQ, SKIPS, dtype=torch.float32)
    for leaf in _leaves(tp):
        leaf.retain_grad()
    t_feat = torch.as_tensor(feat).bfloat16().requires_grad_()
    out = t_fm.fused_mlp(tp, t_feat, DEPTH, SKIPS)
    np.testing.assert_array_equal(out.detach().numpy(), t_fm.fused_mlp_apply(
        t_fm.pack_mlp_params(tm, NFREQ, SKIPS), t_feat.detach(), DEPTH, SKIPS).numpy())
    ((out[:, :28] - torch.as_tensor(tgt)) ** 2).mean().backward()
    for i, (a, b) in enumerate(zip(_leaves(tp), _leaves(jg_p))):
        _close_scaled(a.grad, b, 0.05, f"packed leaf {i}", 5e-5)
    assert t_feat.grad.dtype == torch.bfloat16
    _close_scaled(t_feat.grad, np.asarray(jg_f, np.float32), 0.05, "dfeat", 5e-5)


# --------------------------------------------------------------- the renders

def _render_setup(n_rays=40):
    jc, tc = j_config.NerfConfig(**CFG_KW), t_config.NerfConfig(**CFG_KW)
    jp = j_init_params(jax.random.PRNGKey(0), jc)
    tp = nerf_params_from_numpy(jax.tree.map(np.asarray, jp), tc, device=CPU)
    rng = np.random.default_rng(1)
    rd = rng.normal(size=(n_rays, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    ro = np.tile(np.array([[0.0, 0.0, -4.0]], np.float32), (n_rays, 1))
    return jc, tc, jp, tp, rd, ro


def test_render_rays_eval_grid_plain_route_fp32():
    """Plain route in fp32 vs the JAX XLA path in fp32: rgb and opacity
    1e-4, depth 1e-3."""
    jc, tc, jp, tp, rd, ro = _render_setup()
    ref = jax.jit(lambda: j_render_eval(jp, jnp.asarray(rd), jnp.asarray(ro), jc, jnp.float32,
                                        fine_mode="grid"))()
    out = render_rays_eval(tp, torch.as_tensor(rd), torch.as_tensor(ro), tc, torch.float32,
                           fine_mode="grid")
    for a, b, atol in zip(out, ref, (1e-4, 1e-3, 1e-4)):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=atol)


def test_render_rays_eval_grid_kernel_route():
    """Kernel route (the plain versions of fused_mlp_apply and
    fused_shaded_mlp on CPU tensors) vs the JAX Pallas path in interpret
    mode: max abs < 0.05 (tests/test_render_eval.py:131)."""
    jc, tc, jp, tp, rd, ro = _render_setup()
    ref = jax.jit(lambda: j_render_eval(jp, jnp.asarray(rd), jnp.asarray(ro), jc, jnp.bfloat16,
                                        fine_mode="grid", packed=j_pack_eval(jp, jc),
                                        interpret=True))()
    out = render_rays_eval(tp, torch.as_tensor(rd), torch.as_tensor(ro), tc, torch.bfloat16,
                           fine_mode="grid", packed=pack_eval_params(tp, tc))
    for a, b, name in zip(out, ref, ("rgb", "depth", "opacity")):
        err = float(np.abs(a.numpy() - np.asarray(b)).max())
        assert err < 0.05, f"{name}: {err}"


def _camera(h, w):
    from mc_nerf_torch.data.blender import _blender_pose_to_w2c_np

    c2w = np.array([[1, 0, 0, 0.3], [0, 0, -1, -4.0], [0, 1, 0, 0.2], [0, 0, 0, 1]],
                   np.float32)
    f = (w / 2.0) / np.tan(0.35)
    K = np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1]], np.float32)
    return _blender_pose_to_w2c_np(c2w), K


def test_make_render_fn_grid_matches_jax():
    """A 16x16 frame in chunks of 96 rays (the last one padded): the
    selection's cutoff is a max over each chunk, padding included, as the
    JAX lax.map over padded chunks; plain route fp32 vs JAX fp32 at 1e-4."""
    jc, tc, jp, tp, _, _ = _render_setup()
    ev = dict(fine_mode="grid", rays_per_chunk=96, use_pallas=False)
    jcfg = j_config.Config(nerf=jc, eval=j_config.EvalConfig(**ev), compute_dtype="float32")
    tcfg = t_config.Config(nerf=tc, eval=t_config.EvalConfig(**ev), compute_dtype="float32")
    pose, K = _camera(16, 16)
    ref = j_make_render_fn(jcfg, 16, 16)(jp, jnp.asarray(pose), jnp.asarray(K))
    out = t_steps.make_render_fn(tcfg, 16, 16, device=CPU)(tp, pose, K)
    for a, b in zip(out, ref):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-4)


def test_demo_grid_renders_without_occupancy(monkeypatch):
    """demo() in the grid fine mode builds no occupancy map (as
    Engine._occ_eval) and scores finite views through the kernel route."""
    from mc_nerf_torch.data.blender import SplitData
    from mc_nerf_torch.train import engine

    def no_refresh(*_a, **_k):
        raise AssertionError("grid mode refreshed the occupancy map")

    monkeypatch.setattr(engine, "refresh_occupancy", no_refresh)
    _, tc, _, tp, _, _ = _render_setup()
    cfg = t_config.Config(nerf=tc, eval=t_config.EvalConfig(fine_mode="grid",
                                                             rays_per_chunk=100))
    pose, K = _camera(12, 12)
    split = SplitData(np.full((1, 12, 12, 3), 255, np.uint8), pose[None], K[None],
                      np.full(1, 0.7, np.float32), 12, 12, ["a"])
    res = engine.demo(tp, split, cfg, device=CPU)
    assert res["count"] == 1 and np.isfinite(res["psnr"]) and np.isfinite(res["ssim"])
