"""The port's coarse-free modes, density PMF, bitpacked map and LPIPS
against the JAX package, on the CPU, at small widths.

* ``ops/occupancy.py``: the bitpacked map bit for bit (through
  ``numpy.view(np.int32)``) and its probes equal; ``density_rows`` exact;
  ``density_pmf`` at rtol 1e-4, atol 1e-6 (``tests/test_occupancy.py:302``);
  ``uniform_prior_map`` and ``proposal_pmf`` per ``occ_pmf``;
  ``mixture_samples`` on the JAX key's draws, depths within 1e-4 of
  (far - near) (measured: 2.7e-5; the PMF's sums round in another order,
  and a draw in a floor-only bin, whose CDF step is 1e-2 of an occupied
  one's, moves its depth by that rounding over the step).
* ``render_rays_train(coarse_free=True)`` by both routes (kernel route:
  the kernels' plain versions, against the Pallas kernels in interpret
  mode) and every gradient: rgb atol 2e-4, gradients 5e-3 * max|ref| per
  leaf (``tests/test_fused_render.py:131``), the coarse MLP's exactly zero
  (``make_loss_fn``'s coarse-free stages through the engine:
  ``tests/test_torch_coarse_free_engine.py``).
* ``render_rays_eval(coarse_free=True)`` by both routes (kernel route at
  ``tests/test_render_eval.py:131``'s 0.05) with no coarse launch, and
  ``make_render_fn`` with ``eval_coarse_free``.
* ``stage_mask(freeze_coarse=True)`` leaf by leaf, and the coarse slice of
  ``p_flat`` bit-stable over a coarse-free update with weight decay.
* The config methods, and each of the JAX engine's sampling-mode
  ValueErrors raised by the port's ``Engine`` for the same config.
* LPIPS against ``lpips_jax.lpips_distance`` on seeded random weights
  written through ``convert_torch_lpips`` (rtol 2e-4,
  ``tests/test_lpips.py:69-85``), found by argument and by
  ``$MC_NERF_LPIPS_WEIGHTS``, and None with no file.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_nerf_tpu import config as j_config
from mc_nerf_tpu.eval import lpips_jax
from mc_nerf_tpu.models.nerf import init_nerf_params as j_init_params
from mc_nerf_tpu.models.nerf import pack_eval_params as j_pack_eval
from mc_nerf_tpu.models.nerf import render_rays_eval as j_render_eval
from mc_nerf_tpu.models.nerf import render_rays_train as j_render_train
from mc_nerf_tpu.ops import occupancy as j_occ
from mc_nerf_tpu.train import engine as j_engine
from mc_nerf_tpu.train import optim as j_optim
from mc_nerf_tpu.train.steps import make_render_fn as j_make_render_fn

from mc_nerf_torch import config as t_config
from mc_nerf_torch.eval import lpips as t_lpips
from mc_nerf_torch.eval import metrics as t_metrics
from mc_nerf_torch.models import nerf as t_nerf
from mc_nerf_torch.models.nerf import (
    RenderDraws,
    nerf_params_from_numpy,
    pack_eval_params,
    render_rays_eval,
    render_rays_train,
)
from mc_nerf_torch.ops import occupancy as t_occ
from mc_nerf_torch.train import engine as t_engine
from mc_nerf_torch.train import optim as t_optim
from mc_nerf_torch.train.steps import make_render_fn

CPU = "cpu"
CFG_KW = dict(samples_coarse=32, emb_freqs_xyz=6, coarse_depth=2, coarse_width=32,
              coarse_skips=(1,), fine_depth=3, fine_width=64, fine_skips=(1,),
              occ_grid_size=32, occ_probes=32, occ_coarse_samples=24, cf_uniform_samples=4)
K = 16


def _cfgs(**kw):
    return j_config.NerfConfig(**{**CFG_KW, **kw}), t_config.NerfConfig(**{**CFG_KW, **kw})


def _t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x)).to(dtype)


def _rays(n, seed=1):
    rng = np.random.default_rng(seed)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    ro = (np.array([[0.0, 0.0, -4.0]]) + rng.normal(size=(n, 3)) * 0.2).astype(np.float32)
    return rd, ro


def _density(g=32, seed=2):
    """An EMA-like density grid: a dense ball (cells on both sides of the
    threshold, so every word of a bitpacked row has bits set, bit 31
    included) plus sparse spots."""
    rng = np.random.default_rng(seed)
    c = (np.arange(g) + 0.5) / g * 7.0 - 3.5
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    ball = np.where(x * x + y * y + z * z < 2.0 ** 2, rng.uniform(0.0, 8.0, x.shape), 0.0)
    spots = np.where(rng.random(x.shape) < 0.03, rng.uniform(0.0, 20.0, x.shape), 0.0)
    return (ball + spots).astype(np.float32)


def _maps(jc, tc, dens):
    jg, tg = j_occ.OccupancyGrid(jnp.asarray(dens)), t_occ.OccupancyGrid(torch.as_tensor(dens))
    return jg, tg


# ---------------------------------------------------------------- occupancy

@pytest.mark.parametrize("dilate", [True, False])
def test_bitpack_map_bit_exact_and_probes_equal(dilate):
    jc, tc = _cfgs(occ_map_dtype="bitpack", occ_dilate=dilate)
    jg, tg = _maps(jc, tc, _density())
    jmap = np.asarray(j_occ.binary_grid(jg, jc))
    tmap = t_occ.binary_grid(tg, tc)
    assert jmap.dtype == np.uint32 and tmap.dtype == torch.int32
    assert tuple(tmap.shape) == jmap.shape == (32 * 32, 1)
    np.testing.assert_array_equal(tmap.numpy(), jmap.view(np.int32))
    assert (tmap < 0).any() and (tmap > 0).any()      # bit 31 set in some words, not all
    # the bitpacked layout probes what the bf16 one does, and what JAX's does
    rng = np.random.default_rng(3)
    pts = rng.uniform(-4.2, 4.2, size=(4000, 3)).astype(np.float32)   # some outside the AABB
    want = np.asarray(j_occ.probe_occupancy(jnp.asarray(jmap), jc.bound_min, jc.bound_max,
                                            jnp.asarray(pts)))
    got = t_occ.probe_occupancy(tmap, tc.bound_min, tc.bound_max, torch.as_tensor(pts))
    np.testing.assert_array_equal(got.numpy(), want)
    bf16 = t_occ.binary_grid(tg, dataclasses.replace(tc, occ_map_dtype="bfloat16"))
    np.testing.assert_array_equal(
        t_occ.probe_occupancy(bf16, tc.bound_min, tc.bound_max, torch.as_tensor(pts)).numpy(),
        want)
    assert 0 < want.mean() < 1


def test_bitpack_needs_a_multiple_of_32():
    jc, tc = _cfgs(occ_map_dtype="bitpack", occ_grid_size=16)
    with pytest.raises(ValueError, match="bitpack needs occ_grid_size % 32 == 0, got 16"):
        j_occ.binary_grid(j_occ.init_grid(16), jc)
    with pytest.raises(ValueError, match="bitpack needs occ_grid_size % 32 == 0, got 16"):
        t_occ.binary_grid(t_occ.init_grid(16, CPU), tc)


@pytest.mark.parametrize("dilate", [True, False])
def test_density_rows_exact(dilate):
    jc, tc = _cfgs(occ_pmf="density", occ_dilate=dilate)
    jg, tg = _maps(jc, tc, _density())
    jrows = np.asarray(j_occ.density_rows(jg, jc).view(jnp.uint16))
    trows = t_occ.density_rows(tg, tc)
    assert trows.dtype == torch.bfloat16 and tuple(trows.shape) == jrows.shape
    np.testing.assert_array_equal(trows.view(torch.int16).numpy().view(np.uint16), jrows)
    # the sampler map dispatches on occ_pmf
    assert torch.equal(t_occ.sampler_map(tg, tc).view(torch.int16),
                       trows.view(torch.int16))


def test_density_pmf_matches_jax():
    jc, tc = _cfgs(occ_pmf="density")
    jg, tg = _maps(jc, tc, _density())
    rd, ro = _rays(256)
    jz, jp = j_occ.proposal_pmf(j_occ.density_rows(jg, jc), jnp.asarray(ro), jnp.asarray(rd), jc)
    tz, tp = t_occ.proposal_pmf(t_occ.density_rows(tg, tc), torch.as_tensor(ro),
                                torch.as_tensor(rd), tc)
    assert tuple(tp.shape) == np.asarray(jp).shape == (256, jc.occ_probes + 2)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=0, atol=1e-6)
    assert float(tp[:, 1:-1].max()) > 10 * jc.occ_floor / jc.occ_probes   # not only the floor


@pytest.mark.parametrize("pmf,dtype", [("binary", "bfloat16"), ("binary", "int8"),
                                       ("binary", "bitpack"), ("density", "bfloat16")])
def test_uniform_prior_map_per_pmf(pmf, dtype):
    """The warm-up map: all occupied for the binary PMF, all zero for the
    density PMF; either gives the JAX package's (flat) PMF."""
    jc, tc = _cfgs(occ_pmf=pmf, occ_map_dtype=dtype)
    jm = np.asarray(j_occ.uniform_prior_map(jc))
    tm = t_occ.uniform_prior_map(tc, CPU)
    if dtype == "bitpack":
        jm = jm.view(np.int32)
    np.testing.assert_array_equal(tm.float().numpy() if dtype != "bitpack" else tm.numpy(),
                                  jm.astype(np.float32) if dtype != "bitpack" else jm)
    if pmf == "density":
        assert tm.dtype == torch.bfloat16 and not bool(tm.any())
    rd, ro = _rays(32)
    _, jp = j_occ.proposal_pmf(jnp.asarray(j_occ.uniform_prior_map(jc)), jnp.asarray(ro),
                               jnp.asarray(rd), jc)
    _, tp = t_occ.proposal_pmf(tm, torch.as_tensor(ro), torch.as_tensor(rd), tc)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6, atol=0)


@pytest.mark.parametrize("n_uniform", [0, 4, K + 3])
def test_mixture_samples_match_jax(n_uniform):
    """K - ku PMF draws and ku stratified-uniform ones, sorted; ku clamps
    to [0, K - 1].  Both draws from the JAX keys."""
    jc, tc = _cfgs()
    jg, tg = _maps(jc, tc, _density())
    rd, ro = _rays(128)
    jz, jp = j_occ.proposal_pmf(j_occ.binary_grid(jg, jc), jnp.asarray(ro), jnp.asarray(rd), jc)
    kp, ku_key = jax.random.split(jax.random.PRNGKey(5))
    want = np.asarray(j_occ.mixture_samples(jz, jp, K, n_uniform, kp, ku_key, jc.near, jc.far))
    ku = t_occ.mixture_split(K, n_uniform)
    assert ku == min(max(n_uniform, 0), K - 1)
    pdf_u = _t(jax.random.uniform(kp, (128, K - ku), jnp.float32))
    mix_u = _t(jax.random.uniform(ku_key, (128, ku), jnp.float32)) if ku else None
    got = t_occ.mixture_samples(_t(jz), _t(jp), K, n_uniform, pdf_u, mix_u, tc.near, tc.far)
    assert tuple(got.shape) == want.shape == (128, K)
    assert bool((got[:, 1:] >= got[:, :-1]).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * (tc.far - tc.near))


# ------------------------------------------------------------------ renders

def _params(jc, tc):
    jp = j_init_params(jax.random.PRNGKey(0), jc)
    return jp, nerf_params_from_numpy(jax.tree.map(np.asarray, jp), tc, device=CPU)


def _occ_pair(jc, tc, dtype="bfloat16"):
    jc, tc = dataclasses.replace(jc, occ_map_dtype=dtype), dataclasses.replace(tc, occ_map_dtype=dtype)
    jg, tg = _maps(jc, tc, _density())
    return j_occ.binary_grid(jg, jc), t_occ.binary_grid(tg, tc)


def _cf_draws(key, n_rays, ku):
    """The coarse-free draws of JAX's render_rays_train from its key
    splits (models/nerf.py:188; ops/volume.py:231-234): the PMF draw's
    uniforms from kn_pdf, the mixture's from kn_sel, the noise from kn_f."""
    kj, kn_c, kn_sel, kn_pdf, kn_f = jax.random.split(key, 5)
    return RenderDraws(None, None, None, _t(jax.random.uniform(kn_pdf, (n_rays, K - ku))),
                       _t(jax.random.normal(kn_f, (n_rays, K))),
                       _t(jax.random.uniform(kn_sel, (n_rays, ku))) if ku else None)


def _mlp_leaves(tm, jm):
    """(port tensor, JAX array, is a Linear weight) of one MLP."""
    pairs = [(l.weight, w, True) for l, w in zip(tm.trunk, jm.trunk_w)]
    pairs += [(l.bias, b, False) for l, b in zip(tm.trunk, jm.trunk_b)]
    for mod, head, i in (("sigma0", "sigma", 0), ("sigma1", "sigma", 1),
                         ("sh0", "sh", 0), ("sh1", "sh", 1)):
        pairs += [(getattr(tm, mod).weight, getattr(jm, f"{head}_w{i}"), True),
                  (getattr(tm, mod).bias, getattr(jm, f"{head}_b{i}"), False)]
    return pairs


@pytest.mark.parametrize("route,dtype,remat,ku", [
    ("plain", "bfloat16", False, 4), ("plain", "bitpack", True, 4), ("plain", "bfloat16", False, 0),
    ("kernel", "bfloat16", False, 4), ("kernel", "bitpack", False, 0)])
def test_coarse_free_train_render_matches_jax(route, dtype, remat, ku):
    """The coarse-free train render and its gradients against JAX's
    ``render_rays_train(coarse_free=True)`` from the same params and key:
    rgb atol 2e-4; the gradients of the fine MLP and of the rays within
    5e-3 * max|ref|; the coarse MLP's gradient exactly zero (no gradient
    reaches it: its parameters get none at all)."""
    jc, tc = _cfgs(cf_uniform_samples=ku)
    jp, tp = _params(jc, tc)
    occ_j, occ_t = _occ_pair(jc, tc, dtype)
    rd, ro = _rays(96)
    key = jax.random.PRNGKey(7)
    window, step = (0.0, 1.0), 0.4
    w = np.random.default_rng(4).normal(size=(96, 3)).astype(np.float32)
    kernel = route == "kernel"

    def jloss(p, d, o):
        rgb_c, rgb_f = j_render_train(p, d, o, key, jnp.float32(step), jc, window, True,
                                      compute_dtype=jnp.float32, fine_mode="importance",
                                      importance_samples=K, use_pallas=kernel, interpret=True,
                                      occ=occ_j, remat_shade=remat, coarse_free=True)
        assert rgb_c is None
        return jnp.sum(rgb_f * w), rgb_f

    (_, j_rgb), (jg, jgd, jgo) = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jp, jnp.asarray(rd), jnp.asarray(ro))
    d, o = torch.tensor(rd, requires_grad=True), torch.tensor(ro, requires_grad=True)
    rgb_c, rgb_f = render_rays_train(tp, d, o, _cf_draws(key, 96, ku), torch.tensor(step), tc,
                                     window, True, torch.float32, "importance", K,
                                     use_kernels=kernel, occ=occ_t, remat_shade=remat,
                                     coarse_free=True)
    assert rgb_c is None
    np.testing.assert_allclose(rgb_f.detach().numpy(), np.asarray(j_rgb), rtol=0, atol=2e-4)
    (rgb_f * torch.as_tensor(w)).sum().backward()
    for k, (p, ref, is_w) in enumerate(_mlp_leaves(tp.fine, jg.fine)):
        ref = np.asarray(ref)
        got = p.grad.numpy().T if is_w else p.grad.numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=5e-3 * max(1e-3, np.abs(ref).max()),
                                   err_msg=f"fine leaf {k}")
    for got, ref in ((d.grad, jgd), (o.grad, jgo)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=5e-3 * np.abs(ref).max())
    assert all(p.grad is None for p in tp.coarse.parameters())
    assert all(not np.asarray(g).any() for g in jax.tree.leaves(jg.coarse))


@pytest.mark.parametrize("render", ["train", "eval"])
def test_coarse_free_refuses_without_occupancy_or_in_grid_mode(render):
    """The JAX renders' ValueError, with their wording."""
    jc, tc = _cfgs()
    jp, tp = _params(jc, tc)
    occ_j, occ_t = _occ_pair(jc, tc)
    rd, ro = _rays(8)
    msg = "coarse_free requires an occupancy map and fine_mode='importance'"
    for occ, mode in ((False, "importance"), (True, "grid")):
        if render == "train":
            with pytest.raises(ValueError, match=msg):
                j_render_train(jp, jnp.asarray(rd), jnp.asarray(ro), jax.random.PRNGKey(0),
                               jnp.float32(0), jc, (0.0, 1.0), False, fine_mode=mode,
                               occ=occ_j if occ else None, coarse_free=True)
            with pytest.raises(ValueError, match=msg):
                render_rays_train(tp, _t(rd), _t(ro), _cf_draws(jax.random.PRNGKey(0), 8, 4),
                                  0.0, tc, (0.0, 1.0), False, fine_mode=mode,
                                  occ=occ_t if occ else None, coarse_free=True)
        else:
            with pytest.raises(ValueError, match=msg):
                j_render_eval(jp, jnp.asarray(rd), jnp.asarray(ro), jc, fine_mode=mode,
                              occ=occ_j if occ else None, coarse_free=True)
            with pytest.raises(ValueError, match=msg):
                render_rays_eval(tp, _t(rd), _t(ro), tc, fine_mode=mode,
                                 occ=occ_t if occ else None, coarse_free=True)


@pytest.mark.parametrize("route,pmf", [("plain", "binary"), ("plain", "density"),
                                       ("kernel", "binary"), ("kernel", "density")])
def test_coarse_free_eval_render_matches_jax(route, pmf, monkeypatch):
    """Deterministic PMF depths, then the fine pass only: the plain route
    in fp32 against JAX's XLA path (rgb / opacity 1e-4, depth 1e-3), the
    kernel route against the Pallas kernels in interpret mode (max abs
    0.05, ``tests/test_render_eval.py:131``).  No coarse pass: the coarse
    kernel (``fused_mlp_apply_rays``, the eval route's K1) is never called."""
    jc, tc = _cfgs(occ_pmf=pmf)
    jp, tp = _params(jc, tc)
    jg, tg = _maps(jc, tc, _density())
    occ_j, occ_t = j_occ.sampler_map(jg, jc), t_occ.sampler_map(tg, tc)
    rd, ro = _rays(64)

    def no_coarse(*a, **kw):
        raise AssertionError("the coarse pass ran")

    monkeypatch.setattr(t_nerf, "fused_mlp_apply_rays", no_coarse)
    kernel = route == "kernel"
    ref = j_render_eval(jp, jnp.asarray(rd), jnp.asarray(ro), jc,
                        jnp.bfloat16 if kernel else jnp.float32, importance_samples=K,
                        packed=j_pack_eval(jp, jc) if kernel else None, interpret=True,
                        occ=occ_j, coarse_free=True)
    out = render_rays_eval(tp, _t(rd), _t(ro), tc, torch.bfloat16 if kernel else torch.float32,
                           importance_samples=K, packed=pack_eval_params(tp, tc) if kernel else None,
                           occ=occ_t, coarse_free=True)
    for a, b, atol in zip(out, ref, (0.05, 0.05 * (tc.far - tc.near), 0.05) if kernel
                          else (1e-4, 1e-3, 1e-4)):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=atol)


def test_make_render_fn_renders_coarse_free_as_jax():
    """A 24x24 frame in chunks of 128 rays, ``eval_coarse_free`` from
    ``nerf.coarse_free``, plain routes in fp32: 1e-4."""
    jc, tc = _cfgs(coarse_free=True)
    jp, tp = _params(jc, tc)
    occ_j, occ_t = _occ_pair(jc, tc)
    ev = dict(importance_samples=K, rays_per_chunk=128, use_pallas=False)
    jcfg = j_config.Config(nerf=jc, eval=j_config.EvalConfig(**ev), compute_dtype="float32")
    tcfg = t_config.Config(nerf=tc, eval=t_config.EvalConfig(**ev), compute_dtype="float32")
    assert tcfg.eval_coarse_free and jcfg.eval_coarse_free
    c2w_pose = np.array([[1, 0, 0, 0.3], [0, 1, 0, -0.2], [0, 0, 1, 4.0]], np.float32)
    K_ = np.array([[30.0, 0, 12], [0, 30.0, 12], [0, 0, 1]], np.float32)
    want = j_make_render_fn(jcfg, 24, 24)(jp, jnp.asarray(c2w_pose), jnp.asarray(K_), occ_j)
    got = make_render_fn(tcfg, 24, 24, device=CPU)(tp, c2w_pose, K_, occ_t)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-4)


# ---------------------------------------------------------------- optimizer

def _train_params(jc, tc, n_cams=3):
    from mc_nerf_tpu.models.camera_params import init_camera_params as j_init_cam

    from mc_nerf_torch.models.camera_params import camera_params_from_numpy

    jcam = j_init_cam(n_cams)
    jnerf, tnerf = _params(jc, tc)
    return (j_optim.Params(cam=jcam, nerf=jnerf),
            t_optim.Params(camera_params_from_numpy(jax.tree.map(np.asarray, jcam), CPU), tnerf))


def test_stage_mask_freeze_coarse_matches_jax():
    from jax.flatten_util import ravel_pytree

    jc, tc = _cfgs()
    jp, tp = _train_params(jc, tc)
    _, unravel = ravel_pytree(jp)
    for stage in range(3):
        for freeze in (False, True):
            jm = unravel(j_optim.stage_mask(jp, stage, freeze))
            tm = t_optim.stage_mask(tp, stage, freeze)
            named = dict(tp.named_parameters())
            off = 0
            for name, p in named.items():
                got = tm[off:off + p.numel()].view_as(p)
                off += p.numel()
                part, rest = name.split(".", 1)
                if part == "cam":
                    ref = getattr(jm.cam, rest)
                else:
                    which, leaf = rest.split(".", 1)
                    ref = _jax_leaf(getattr(jm.nerf, which), leaf)
                got = got.numpy()
                is_w = part == "nerf" and name.endswith("weight")
                np.testing.assert_array_equal(got.T if is_w else got, np.asarray(ref),
                                              err_msg=f"{stage} {freeze} {name}")
            assert off == tm.numel()


def _jax_leaf(mlp, leaf):
    """The JAX NerfMLPParams leaf of a port parameter name ("trunk.1.weight",
    "sigma0.bias", ...)."""
    parts = leaf.split(".")
    kind = "w" if parts[-1] == "weight" else "b"
    if parts[0] == "trunk":
        return getattr(mlp, f"trunk_{kind}")[int(parts[1])]
    head, i = parts[0][:-1], parts[0][-1]
    return getattr(mlp, f"{head}_{kind}{i}")


def test_build_optimizers_freeze_the_coarse_mlp_in_coarse_free_stages():
    """The hybrid schedule's FINE_TUNE optimizer freezes the coarse MLP,
    its GLOBAL_OPTIM one does not; one FINE_TUNE update with weight decay
    leaves the coarse slice of ``p_flat`` bit for bit, moves the fine MLP."""
    _, tc = _cfgs(coarse_free=True, coarse_free_from_stage=2)
    cfg = t_config.Config(nerf=tc, train=t_config.TrainConfig(weight_decay=4e-2))
    _, tp = _train_params(*_cfgs())
    p_flat = t_optim.flatten_params(tp)
    txs, states = t_optim.build_optimizers(cfg, tp, p_flat, steps_per_epoch=10)
    n_cam = sum(p.numel() for p in tp.cam.parameters())
    n_coarse = sum(p.numel() for p in tp.nerf.coarse.parameters())
    coarse = slice(n_cam, n_cam + n_coarse)
    assert bool(txs[1].mask[coarse].all()) and not bool(txs[2].mask[coarse].any())
    assert bool(txs[2].mask[n_cam + n_coarse:].all())
    before = p_flat.clone()
    g = torch.randn(p_flat.shape, generator=torch.Generator().manual_seed(0))
    g[coarse] = 0.0          # a coarse-free step's gradient there
    txs[2].update(g, states[2], p_flat)
    assert torch.equal(p_flat[coarse], before[coarse])
    assert not torch.equal(p_flat[n_cam + n_coarse:], before[n_cam + n_coarse:])
    # without the freeze, weight decay alone would move it
    txs[1].update(g, states[1], p_flat)
    assert not torch.equal(p_flat[coarse], before[coarse])


# ------------------------------------------------------------------- config

@pytest.mark.parametrize("cf,from_stage,source,ecf", [
    (False, 1, "auto", None), (True, 1, "auto", None), (True, 2, "auto", None),
    (True, 2, "fine", False), (True, 2, "coarse", True), (True, 1, "fine", True),
    (False, 2, "fine", True)])
def test_config_methods_match_jax(cf, from_stage, source, ecf):
    kw = dict(coarse_free=cf, coarse_free_from_stage=from_stage, occ_refresh_source=source)
    jcfg = j_config.Config(nerf=j_config.NerfConfig(**kw), eval=j_config.EvalConfig(coarse_free=ecf))
    tcfg = t_config.Config(nerf=t_config.NerfConfig(**kw), eval=t_config.EvalConfig(coarse_free=ecf))
    assert tcfg.eval_coarse_free == jcfg.eval_coarse_free
    for stage in range(3):
        assert tcfg.nerf.coarse_free_at(stage) == jcfg.nerf.coarse_free_at(stage)
        assert tcfg.nerf.refresh_source(stage) == jcfg.nerf.refresh_source(stage)


GUARD_CASES = {
    "coarse-free without a grid": (dict(coarse_free=True, coarse_free_from_stage=2,
                                        occ_grid_size=0), {}, {}, 0),
    "coarse-free in grid mode": (dict(coarse_free=True, coarse_free_from_stage=2),
                                 dict(fine_mode="grid"), {}, 0),
    "unknown occ_pmf": (dict(occ_pmf="soft"), {}, {}, 0),
    "from_stage 3": (dict(coarse_free=True, coarse_free_from_stage=3), {}, {}, 0),
    "density on int8": (dict(occ_pmf="density", occ_map_dtype="int8",
                             allow_measured_harmful=True), {}, {}, 0),
    "unknown refresh source": (dict(occ_refresh_source="both"), {}, {}, 0),
    "coarse source, never trained": (dict(coarse_free=True, occ_refresh_source="coarse",
                                          allow_measured_harmful=True), {}, {}, 0),
    "eval coarse-free, grid eval": ({}, {}, dict(coarse_free=True, fine_mode="grid"), 0),
    "coarse-free from stage 1": (dict(coarse_free=True), {}, {}, 0),
    "density training": (dict(occ_pmf="density"), {}, {}, 0),
    "two-pass eval of stage-1 coarse-free": (dict(coarse_free=True, occ_refresh_source="fine"),
                                             {}, dict(coarse_free=False), 1),
}


@pytest.mark.parametrize("case", sorted(GUARD_CASES))
def test_engine_refuses_what_the_jax_engine_refuses(case, tmp_path):
    """Each of the JAX engine's sampling-mode ValueErrors
    (``train/engine.py:94-177``) for the same config, the same wording
    (but for a parenthesized round tag in one JAX message)."""
    nerf, train, ev, mode = GUARD_CASES[case]
    kw = dict(data_root=str(tmp_path), data_name="none", mode=mode)

    def cfg(m):
        return m.Config(nerf=m.NerfConfig(**nerf), train=m.TrainConfig(**train),
                        eval=m.EvalConfig(**ev), **kw)

    with pytest.raises(ValueError) as j_err:
        j_engine.Engine(cfg(j_config))
    with pytest.raises(ValueError) as t_err:
        t_engine.Engine(cfg(t_config), device=CPU)
    assert str(t_err.value) == re.sub(r" \([a-z]+ r\d+\)", "", str(j_err.value))


@pytest.mark.parametrize("nerf", [dict(occ_pmf="density"), dict(coarse_free=True)])
def test_the_training_refusals_spare_the_demo_and_the_override(nerf, tmp_path):
    """Demo mode renders existing checkpoints: neither engine refuses
    there, nor with ``allow_measured_harmful`` (both then look for the
    scene, which is missing)."""
    for mode, allow in ((1, False), (0, True)):
        kw = dict(nerf, allow_measured_harmful=allow)
        for m, make in ((j_config, lambda c: j_engine.Engine(c)),
                        (t_config, lambda c: t_engine.Engine(c, device=CPU))):
            with pytest.raises(FileNotFoundError):
                make(m.Config(nerf=m.NerfConfig(**kw), data_root=str(tmp_path),
                              data_name="none", mode=mode))


# -------------------------------------------------------------------- LPIPS

_SPECS = ((64, 11), (192, 5), (384, 3), (256, 3), (256, 3))
_SLICE_IDX = {1: 0, 2: 3, 3: 6, 4: 8, 5: 10}


@pytest.fixture(scope="module")
def lpips_npz(tmp_path_factory):
    """Seeded random weights in the ``lpips`` package's state-dict layout,
    written to an .npz through the JAX package's ``convert_torch_lpips``."""
    rng = np.random.default_rng(0)
    sd, cin = {}, 3
    for i, (cout, k) in enumerate(_SPECS, start=1):
        sd[f"net.slice{i}.{_SLICE_IDX[i]}.weight"] = torch.tensor(
            rng.normal(scale=0.05, size=(cout, cin, k, k)).astype(np.float32))
        sd[f"net.slice{i}.{_SLICE_IDX[i]}.bias"] = torch.tensor(
            rng.normal(scale=0.05, size=(cout,)).astype(np.float32))
        sd[f"lin{i - 1}.model.1.weight"] = torch.tensor(
            np.abs(rng.normal(size=(1, cout, 1, 1))).astype(np.float32))
        cin = cout
    path = str(tmp_path_factory.mktemp("lpips") / "lpips_rand.npz")
    lpips_jax.convert_torch_lpips(sd, path)
    return path


def test_lpips_matches_jax(lpips_npz):
    rng = np.random.default_rng(1)
    pred = rng.uniform(0, 1, size=(64, 48, 3)).astype(np.float32)
    gt = np.clip(pred + rng.normal(0, 0.2, size=pred.shape), 0, 1).astype(np.float32)
    want = float(lpips_jax.lpips_distance(lpips_jax.load(lpips_npz), pred, gt))
    got = float(t_lpips.lpips_distance(t_lpips.load(lpips_npz), _t(pred), _t(gt)))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6)
    assert got > 0
    assert abs(float(t_lpips.lpips_distance(t_lpips.load(lpips_npz), _t(pred), _t(pred)))) < 1e-8
    # metrics.lpips: by argument, then by the environment variable
    np.testing.assert_allclose(t_metrics.lpips(pred, gt, lpips_npz), want, rtol=2e-4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(t_lpips.ENV_VAR, lpips_npz)
        np.testing.assert_allclose(t_metrics.lpips(_t(pred), _t(gt)), want, rtol=2e-4)


def test_lpips_is_none_without_a_file(tmp_path, monkeypatch):
    monkeypatch.delenv(t_lpips.ENV_VAR, raising=False)
    monkeypatch.chdir(tmp_path)
    img = np.zeros((16, 16, 3), np.float32)
    assert t_lpips.load_default() is None
    assert t_metrics.lpips(img, img) is None
    assert t_metrics.lpips(img, img, str(tmp_path / "missing.npz")) is None
