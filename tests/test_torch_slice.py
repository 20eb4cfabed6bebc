"""The port's render slice against the JAX package, end to end on the CPU.

``render_rays_eval`` by both routes (kernel route: the kernels' plain
versions on CPU tensors, against the JAX Pallas path in interpret mode;
plain route in fp32 against the JAX XLA path in fp32), ``make_render_fn``
over several chunks, and ``demo`` with its occupancy refresh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_nerf_tpu import config as j_config
from mc_nerf_tpu.models.nerf import init_nerf_params as j_init_params
from mc_nerf_tpu.models.nerf import pack_eval_params as j_pack_eval
from mc_nerf_tpu.models.nerf import render_rays_eval as j_render_eval
from mc_nerf_tpu.ops import occupancy as j_occ
from mc_nerf_tpu.train.steps import make_render_fn as j_make_render_fn

from mc_nerf_torch import config as t_config
from mc_nerf_torch.data.blender import SplitData
from mc_nerf_torch.models.nerf import (
    nerf_params_from_numpy,
    pack_eval_params,
    render_rays_eval,
)
from mc_nerf_torch.train.engine import demo
from mc_nerf_torch.train.steps import make_render_fn

CFG_KW = dict(
    samples_coarse=32, emb_freqs_xyz=6,
    coarse_depth=2, coarse_width=32, coarse_skips=(1,),
    fine_depth=3, fine_width=64, fine_skips=(1,),
    occ_grid_size=16, occ_probes=32, occ_coarse_samples=24,
)
CPU = "cpu"


def _setup(n_rays=64):
    jc, tc = j_config.NerfConfig(**CFG_KW), t_config.NerfConfig(**CFG_KW)
    jp = j_init_params(jax.random.PRNGKey(0), jc)
    tp = nerf_params_from_numpy(jax.tree.map(np.asarray, jp), tc, device=CPU)
    rng = np.random.default_rng(1)
    rd = rng.normal(size=(n_rays, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    ro = np.tile(np.array([[0.0, 0.0, -4.0]], np.float32), (n_rays, 1))
    # a sparse occupancy map shared by both packages (its parity is
    # tests/test_torch_ops.py's business)
    dens = np.where(rng.random((16, 16, 16)) < 0.02, 5.0, 0.0).astype(np.float32)
    occ = np.asarray(j_occ.binary_grid(j_occ.OccupancyGrid(jnp.asarray(dens)), jc),
                     np.float32)
    return jc, tc, jp, tp, rd, ro, occ


def _occ_pair(occ, culled):
    if not culled:
        return None, None
    return jnp.asarray(occ, jnp.bfloat16), torch.as_tensor(occ).bfloat16()


@pytest.mark.parametrize("culled", [True, False])
def test_render_rays_eval_kernel_route(culled):
    """Kernel route (plain kernel versions on CPU) vs the JAX Pallas path
    in interpret mode: max abs < 0.05, as tests/test_render_eval.py holds
    the JAX kernel path against its XLA path."""
    jc, tc, jp, tp, rd, ro, occ = _setup()
    occ_j, occ_t = _occ_pair(occ, culled)
    ref = j_render_eval(jp, jnp.asarray(rd), jnp.asarray(ro), jc, jnp.bfloat16,
                        importance_samples=16, packed=j_pack_eval(jp, jc),
                        interpret=True, occ=occ_j)
    out = render_rays_eval(tp, torch.as_tensor(rd), torch.as_tensor(ro), tc,
                           torch.bfloat16, importance_samples=16,
                           packed=pack_eval_params(tp, tc), occ=occ_t)
    for a, b, name in zip(out, ref, ("rgb", "depth", "opacity")):
        assert tuple(a.shape) == tuple(b.shape)
        err = float(np.abs(a.numpy() - np.asarray(b)).max())
        assert err < 0.05, f"{name}: {err}"


@pytest.mark.parametrize("culled", [True, False])
def test_render_rays_eval_plain_route_fp32(culled):
    """Plain route in fp32 vs the JAX XLA path in fp32: rgb/opacity 1e-4,
    depth 1e-3."""
    jc, tc, jp, tp, rd, ro, occ = _setup()
    occ_j, occ_t = _occ_pair(occ, culled)
    ref = j_render_eval(jp, jnp.asarray(rd), jnp.asarray(ro), jc, jnp.float32,
                        importance_samples=16, occ=occ_j)
    out = render_rays_eval(tp, torch.as_tensor(rd), torch.as_tensor(ro), tc,
                           torch.float32, importance_samples=16, occ=occ_t)
    for a, b, atol in zip(out, ref, (1e-4, 1e-3, 1e-4)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=atol)


def test_unported_render_modes_refuse():
    """Every render mode of the JAX package is ported: the config fields
    and the renderer switch of the coarse-free branch exist and select it
    (a coarse-free eval render runs no coarse pass, so it differs from the
    two-pass one on the same map); an unknown fine mode is still refused,
    as is the coarse-free branch without a map."""
    assert t_config.EvalConfig(fine_mode="grid").fine_mode == "grid"
    assert t_config.NerfConfig(coarse_free=True).coarse_free
    assert t_config.Config(eval=t_config.EvalConfig(coarse_free=True)).eval_coarse_free
    _, tc, _, tp, rd, ro, occ = _setup(4)
    args = (tp, torch.as_tensor(rd), torch.as_tensor(ro), tc, torch.float32)
    occ_t = torch.as_tensor(occ).bfloat16()
    cf = render_rays_eval(*args, importance_samples=8, occ=occ_t, coarse_free=True)
    two_pass = render_rays_eval(*args, importance_samples=8, occ=occ_t)
    assert all(bool(torch.isfinite(t).all()) for t in cf)
    assert not torch.equal(cf[1], two_pass[1])
    with pytest.raises(ValueError, match="coarse_free requires an occupancy map"):
        render_rays_eval(*args, coarse_free=True)
    with pytest.raises(ValueError):
        render_rays_eval(*args, fine_mode="dense")


def _camera(h, w):
    c2w = np.array([[1, 0, 0, 0.3], [0, 0, -1, -4.0], [0, 1, 0, 0.2], [0, 0, 0, 1]],
                   np.float32)    # Blender camera at y=-4 looking at +y
    from mc_nerf_torch.data.blender import _blender_pose_to_w2c_np

    pose = _blender_pose_to_w2c_np(c2w)
    f = (w / 2.0) / np.tan(0.35)
    K = np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1]], np.float32)
    return pose, K


@pytest.mark.parametrize("culled", [True, False])
def test_make_render_fn_matches_jax(culled):
    """A 24x24 frame in chunks of 128 rays (4.5 chunks: padding included)
    vs the JAX render function with use_pallas=False in fp32: 1e-4."""
    jc, tc, jp, tp, _, _, occ = _setup()
    ev = dict(importance_samples=16, rays_per_chunk=128, use_pallas=False)
    jcfg = j_config.Config(nerf=jc, eval=j_config.EvalConfig(**ev), compute_dtype="float32")
    tcfg = t_config.Config(nerf=tc, eval=t_config.EvalConfig(**ev), compute_dtype="float32")
    pose, K = _camera(24, 24)
    occ_j, occ_t = _occ_pair(occ, culled)
    ref = j_make_render_fn(jcfg, 24, 24)(jp, jnp.asarray(pose), jnp.asarray(K), occ_j)
    out = make_render_fn(tcfg, 24, 24, device=CPU)(tp, pose, K, occ_t)
    for a, b in zip(out, ref):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-4)


def test_make_render_fn_kernel_route_close_to_plain():
    """The default route (kernels; their plain versions on the CPU) and the
    bf16 plain route of the same frame: max abs < 0.05."""
    _, tc, _, tp, _, _, occ = _setup()
    ev = dict(importance_samples=16, rays_per_chunk=128)
    pose, K = _camera(16, 16)
    occ_t = torch.as_tensor(occ).bfloat16()
    ker = make_render_fn(t_config.Config(nerf=tc, eval=t_config.EvalConfig(**ev)), 16, 16,
                         device=CPU)(tp, pose, K, occ_t)
    pln = make_render_fn(t_config.Config(nerf=tc, eval=t_config.EvalConfig(
        use_pallas=False, **ev)), 16, 16, device=CPU)(tp, pose, K, occ_t)
    for a, b in zip(ker, pln):
        assert float((a - b).abs().max()) < 0.05


def test_demo_renders_and_scores(tmp_path):
    _, tc, _, tp, _, _, _ = _setup()
    cfg = t_config.Config(nerf=tc, eval=t_config.EvalConfig(importance_samples=16,
                                                             rays_per_chunk=200))
    pose, K = _camera(16, 16)
    split = SplitData(np.full((2, 16, 16, 3), 255, np.uint8), np.stack([pose, pose]),
                      np.stack([K, K]), np.full(2, 0.7, np.float32), 16, 16, ["a", "b"])
    res = demo(tp, split, cfg, device=CPU, out_dir=str(tmp_path))
    assert set(res) == {"psnr", "ssim", "lpips", "count"}
    assert res["count"] == 2 and res["lpips"] is None
    assert np.isfinite(res["psnr"]) and np.isfinite(res["ssim"])
    for sub, name in (("pred", "0001.png"), ("gt", "0001gt.png"), ("depth", "0001depth.png")):
        assert (tmp_path / sub / name).exists()
    unculled = demo(tp, split, cfg, device=CPU, cull=False)
    assert np.isfinite(unculled["psnr"])


def test_refresh_builds_a_binary_map():
    from mc_nerf_torch.train.engine import refresh_occupancy

    _, tc, _, tp, _, _, _ = _setup()
    occ = refresh_occupancy(tp, t_config.Config(nerf=tc), CPU, 0)
    assert tuple(occ.shape) == (16 * 16, 16) and occ.dtype == torch.bfloat16
    assert set(torch.unique(occ.float()).tolist()) <= {0.0, 1.0}
