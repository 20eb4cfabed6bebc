"""Parity of the PyTorch port's building blocks with the JAX package.

The same numpy inputs (random draws included) go through the JAX function
and its counterpart in ``mc_nerf_torch``; tolerances are stated per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_nerf_tpu.cameras import convention as j_conv
from mc_nerf_tpu.cameras import rays as j_rays
from mc_nerf_tpu.config import NerfConfig as JNerfConfig
from mc_nerf_tpu.eval import metrics as j_metrics
from mc_nerf_tpu.models import encoding as j_enc
from mc_nerf_tpu.models import sh as j_sh
from mc_nerf_tpu.models.mlp import apply_nerf_mlp as j_apply_mlp
from mc_nerf_tpu.models.nerf import init_nerf_params as j_init_params
from mc_nerf_tpu.ops import occupancy as j_occ
from mc_nerf_tpu.ops import volume as j_vol
from mc_nerf_tpu.ops.pallas.fused_mlp import encode_kernel_order as j_encode_ko

from mc_nerf_torch.cameras import convention as t_conv
from mc_nerf_torch.cameras import rays as t_rays
from mc_nerf_torch.config import NerfConfig
from mc_nerf_torch.eval import metrics as t_metrics
from mc_nerf_torch.models import encoding as t_enc
from mc_nerf_torch.models import sh as t_sh
from mc_nerf_torch.models.nerf import nerf_params_from_numpy
from mc_nerf_torch.ops import occupancy as t_occ
from mc_nerf_torch.ops import volume as t_vol
from mc_nerf_torch.ops.cuda.fused_mlp import encode_kernel_order as t_encode_ko

CPU = "cpu"


def _t(x):
    return torch.tensor(np.asarray(x))


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x,
                      np.float64)


def _close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol)


def _points_with_equal_base(rng, n):
    """Points whose fp32 sin and cos agree bit for bit between XLA and
    torch.  The two libraries' sin/cos differ by one ulp on ~5% of inputs,
    and the double-angle recurrence amplifies a base difference up to ~4x
    per octave; on these points the recurrence itself is compared."""
    x = rng.uniform(-4, 4, size=(8 * n, 3)).astype(np.float32)
    same = ((np.asarray(jnp.sin(x)) == torch.sin(_t(x)).numpy())
            & (np.asarray(jnp.cos(x)) == torch.cos(_t(x)).numpy())).all(axis=1)
    assert same.sum() >= n
    return x[same][:n]


@pytest.mark.parametrize("n_freqs,gated", [(4, False), (10, False), (10, True)])
def test_sincos_encode_and_kernel_order(rng, n_freqs, gated):
    x = _points_with_equal_base(rng, 50)
    fw = rng.uniform(0, 1, size=(n_freqs,)).astype(np.float32) if gated else None
    j_fw = None if fw is None else jnp.asarray(fw)
    t_fw = None if fw is None else _t(fw)
    # atol 1e-5: the same double-angle recurrence in fp32
    _close(t_enc.sincos_encode(_t(x), n_freqs, t_fw),
           j_enc.sincos_encode(jnp.asarray(x), n_freqs, j_fw), 1e-5)
    _close(t_encode_ko(_t(x), n_freqs, t_fw, dtype=torch.float32),
           j_encode_ko(jnp.asarray(x), n_freqs, j_fw, dtype=jnp.float32), 1e-5)


def test_sincos_encode_any_points_within_amplified_ulp(rng):
    """On arbitrary points a one-ulp base difference grows through 9
    doublings: bounded by 4^9 ulps of 1.0 (~3e-2) and in practice ~1e-3."""
    x = rng.uniform(-4, 4, size=(2000, 3)).astype(np.float32)
    diff = np.abs(_np(t_enc.sincos_encode(_t(x), 10))
                  - _np(j_enc.sincos_encode(jnp.asarray(x), 10)))
    assert diff.max() < 4.0 ** 9 * 2.0 ** -23
    assert np.mean(diff < 1e-5) > 0.95


def test_barf_weights():
    for step_r in (0.0, 0.3, 0.55, 1.0):
        _close(t_enc.barf_weights(10, step_r, 0.2, 0.8),
               j_enc.barf_weights(10, jnp.float32(step_r), 0.2, 0.8), 1e-6)


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_sh_basis(rng, deg):
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    _close(t_sh.sh_basis(deg, _t(d)), j_sh.sh_basis(deg, jnp.asarray(d)), 1e-5)


def _volume_inputs(rng, r=16, s=24):
    z = np.sort(rng.uniform(1, 8, size=(r, s)), axis=-1).astype(np.float32)
    sigma = rng.normal(0, 3, size=(r, s)).astype(np.float32)
    rgb = rng.uniform(0, 1, size=(r, s, 3)).astype(np.float32)
    return z, sigma, rgb


@pytest.mark.parametrize("last_inf,max_delta", [(True, None), (False, None), (False, 0.2)])
def test_compute_deltas(rng, last_inf, max_delta):
    z, _, _ = _volume_inputs(rng)
    _close(t_vol.compute_deltas(_t(z), last_inf, max_delta),
           j_vol.compute_deltas(jnp.asarray(z), last_inf, max_delta), 1e-5)


def test_sigma_to_weights_with_noise(rng):
    z, sigma, _ = _volume_inputs(rng)
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.normal(key, sigma.shape, jnp.float32))
    d = j_vol.compute_deltas(jnp.asarray(z))
    _close(t_vol.sigma_to_weights(_t(np.asarray(d)), _t(sigma), _t(noise)),
           j_vol.sigma_to_weights(d, jnp.asarray(sigma), key), 1e-5)
    _close(t_vol.sigma_to_weights(_t(np.asarray(d)), _t(sigma)),
           j_vol.sigma_to_weights(d, jnp.asarray(sigma)), 1e-5)


@pytest.mark.parametrize("noisy,white_back", [(False, True), (True, True), (False, False)])
def test_composite(rng, noisy, white_back):
    z, sigma, rgb = _volume_inputs(rng)
    key = jax.random.PRNGKey(5) if noisy else None
    noise = _t(np.asarray(jax.random.normal(key, sigma.shape, jnp.float32))) if noisy else None
    out_t = t_vol.composite(_t(z), _t(sigma), _t(rgb), noise, white_back)
    out_j = j_vol.composite(jnp.asarray(z), jnp.asarray(sigma), jnp.asarray(rgb), key,
                            white_back)
    for a, b in zip(out_t, out_j):
        _close(a, b, 1e-5)


@pytest.mark.parametrize("stratified", [False, True])
def test_sample_pdf(rng, stratified):
    z, _, _ = _volume_inputs(rng, r=32, s=40)
    # a PMF with no near-empty bin: inside a bin of mass ~eps a one-ulp
    # difference of the cumsum (summed in another order) moves a depth
    # across the bin, which says nothing about the sampler
    w = rng.uniform(0.05, 1.0, size=z.shape).astype(np.float32)
    key = jax.random.PRNGKey(9) if stratified else None
    # the JAX sampler draws uniform(key, [R, K]); hand the same draws over
    u = _t(np.asarray(jax.random.uniform(key, (32, 20), jnp.float32))) if stratified else None
    # atol 1e-4 on depths in [1, 8]: the cumsum runs in another order
    _close(t_vol.sample_pdf(_t(z), _t(w), 20, uniforms=u),
           j_vol.sample_pdf(jnp.asarray(z), jnp.asarray(w), 20, key=key), 1e-4)


def test_sample_pdf_generator_draws_strata():
    z = torch.linspace(1, 8, 32).expand(4, 32)
    w = torch.ones(4, 32)
    a = t_vol.sample_pdf(z, w, 16, generator=torch.Generator().manual_seed(0))
    b = t_vol.sample_pdf(z, w, 16, generator=torch.Generator().manual_seed(1))
    assert not torch.allclose(a, b)
    assert bool((a.diff(dim=-1) >= -1e-6).all())


def _camera(rng):
    c2w = np.eye(4, dtype=np.float32)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    c2w[:3, :3] = q.astype(np.float32)
    c2w[:3, 3] = rng.uniform(-4, 4, size=3)
    return c2w


def test_rays_for_pixels_and_conventions(rng):
    c2w = _camera(rng)
    w2c_t = t_conv.blender_pose_to_w2c(_t(c2w))
    w2c_j = j_conv.blender_pose_to_w2c(jnp.asarray(c2w))
    _close(w2c_t, w2c_j, 1e-5)
    K_t = t_conv.fov_to_K(0.7, 12, 16)
    K_j = j_conv.fov_to_K(jnp.float32(0.7), 12, 16)
    _close(K_t, K_j, 1e-5)
    pix_t = t_rays.pixel_grid(12, 16, device=CPU)
    pix_j = j_rays.pixel_grid(12, 16)
    _close(pix_t, pix_j, 0.0)
    pose = np.asarray(w2c_j)
    K = np.asarray(K_j)
    for a, b in zip(t_rays.rays_for_pixels(pix_t, _t(pose), _t(K)),
                    j_rays.rays_for_pixels(pix_j, jnp.asarray(pose), jnp.asarray(K))):
        _close(a, b, 1e-5)


# ---------------------------------------------------------------- occupancy

_OCC_CFG = dict(occ_grid_size=16, occ_probes=24, occ_coarse_samples=12)


def _density(rng, g=16):
    # sparse occupied cells so threshold and dilation both matter
    return np.where(rng.random((g, g, g)) < 0.005, rng.uniform(0.5, 5.0, (g, g, g)),
                    rng.uniform(0.0, 0.01, (g, g, g))).astype(np.float32)


def _rays(rng, n=48):
    o = rng.normal(size=(n, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o / 4.0 + rng.normal(0, 0.2, size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("map_dtype", ["bfloat16", "int8"])
def test_occupancy_maps_and_pmfs_exact(rng, map_dtype):
    """From one density array, every binary-map stage is exactly equal."""
    jc = JNerfConfig(occ_map_dtype=map_dtype, **_OCC_CFG)
    tc = NerfConfig(occ_map_dtype=map_dtype, **_OCC_CFG)
    dens = _density(rng)
    occ_j = j_occ.binary_grid(j_occ.OccupancyGrid(jnp.asarray(dens)), jc)
    occ_t = t_occ.binary_grid(t_occ.OccupancyGrid(_t(dens)), tc)
    assert str(occ_t.dtype).endswith(map_dtype)
    np.testing.assert_array_equal(_np(occ_t.float()), _np(np.asarray(occ_j, np.float32)))
    assert 0 < float(occ_t.float().mean()) < 1
    np.testing.assert_array_equal(
        _np(t_occ.sampler_map(t_occ.OccupancyGrid(_t(dens)), tc).float()), _np(occ_t.float()))

    o, d = _rays(rng)
    x = o[:, None] + d[:, None] * rng.uniform(0.5, 8.0, size=(48, 10, 1)).astype(np.float32)
    np.testing.assert_array_equal(
        _np(t_occ.probe_occupancy(occ_t, -3.5, 3.5, _t(x))),
        _np(j_occ.probe_occupancy(occ_j, -3.5, 3.5, jnp.asarray(x))))
    for t_fn, j_fn in ((t_occ.occupancy_pmf, j_occ.occupancy_pmf),
                       (t_occ.proposal_pmf, j_occ.proposal_pmf)):
        (z_t, pmf_t), (z_j, pmf_j) = (t_fn(occ_t, _t(o), _t(d), tc),
                                      j_fn(occ_j, jnp.asarray(o), jnp.asarray(d), jc))
        np.testing.assert_array_equal(_np(pmf_t), _np(pmf_j))
        # the probe ladder: XLA's fused linspace and torch's round the
        # same points differently in the last bit (one ulp at 8 is 4.8e-7)
        _close(z_t, z_j, 5e-7)
    np.testing.assert_array_equal(
        _np(t_occ.uniform_prior_map(tc, device=CPU).float()),
        _np(np.asarray(j_occ.uniform_prior_map(jc), np.float32)))


def test_update_grid_matches_jax_fp32():
    """Fresh refresh (key=None) from an fp32 MLP: rtol 1e-4."""
    cfg_kw = dict(emb_freqs_xyz=4, coarse_depth=2, coarse_width=32, coarse_skips=(1,),
                  fine_depth=2, fine_width=32, fine_skips=(1,), **_OCC_CFG)
    jc, tc = JNerfConfig(**cfg_kw), NerfConfig(**cfg_kw)
    jp = j_init_params(jax.random.PRNGKey(4), jc)
    tp = nerf_params_from_numpy(jax.tree.map(np.asarray, jp), tc, device=CPU)

    def j_act(pts):
        sigma, _ = j_apply_mlp(jp.coarse, j_enc.sincos_encode(pts, 4), (1,), jnp.float32,
                               sigma_only=True)
        return jax.nn.softplus(sigma.reshape(-1))

    def t_act(pts):
        sigma, _ = tp.coarse(t_enc.sincos_encode(pts, 4), torch.float32, sigma_only=True)
        return torch.nn.functional.softplus(sigma.reshape(-1))

    g_j = j_occ.update_grid(None, j_act, 16, -3.5, 3.5, chunk=1024)
    g_t = t_occ.update_grid(None, t_act, 16, -3.5, 3.5, chunk=1000, device=CPU)
    _close(g_t.density, g_j.density, 1e-7, rtol=1e-4)
    prev = g_t.density.clone()
    g_t2 = t_occ.update_grid(g_t, lambda p: torch.zeros(p.shape[0]), 16, -3.5, 3.5,
                             decay=0.5, device=CPU)
    torch.testing.assert_close(g_t2.density, 0.5 * prev)


def test_unported_occupancy_modes_refuse():
    """The density PMF and the bitpacked map are ported (the name stays
    from when they were refused): the all-occupied grid packs to words of
    32 set bits; an unknown layout is refused as the JAX package refuses it."""
    assert NerfConfig(occ_pmf="density").occ_pmf == "density"
    packed = t_occ.binary_grid(t_occ.init_grid(32, device=CPU),
                               NerfConfig(occ_map_dtype="bitpack"))
    assert packed.dtype == torch.int32 and tuple(packed.shape) == (32 * 32, 1)
    assert bool((packed == -1).all())
    with pytest.raises(ValueError, match="unknown occ_map_dtype: 'uint4'"):
        t_occ.binary_grid(t_occ.init_grid(8, device=CPU), NerfConfig(occ_map_dtype="uint4"))


# ---------------------------------------------------------------- metrics / data


def test_psnr_ssim(rng):
    a = rng.uniform(0, 1, size=(32, 40, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, size=a.shape), 0, 1).astype(np.float32)
    flat = np.full_like(a, 0.7)
    for x, y in ((a, b), (flat, flat + 1e-3)):
        # rtol 1e-6 on psnr: ~60 dB for the near-equal pair, from a mean
        # summed in another order
        _close(t_metrics.psnr(_t(x), _t(y)), j_metrics.psnr(jnp.asarray(x), jnp.asarray(y)),
               1e-5, rtol=1e-6)
        _close(t_metrics.ssim(_t(x), _t(y)), j_metrics.ssim(jnp.asarray(x), jnp.asarray(y)), 1e-5)
    assert t_metrics.lpips(a, b) is None


def test_load_split_exact(tmp_path):
    from mc_nerf_tpu.data.blender import load_split as j_load_split
    from mc_nerf_tpu.data.synthetic import make_dataset

    from mc_nerf_torch.data.blender import load_split as t_load_split

    scene = str(tmp_path / "scene")
    make_dataset(scene, n_train=2, n_val=1, n_test=2, img_h=16, img_w=16, seed=1,
                 with_calibration=False)
    for split in ("train", "test"):
        a, b = t_load_split(scene, split), j_load_split(scene, split)
        assert a.count == b.count == 2 and (a.img_h, a.img_w) == (b.img_h, b.img_w)
        assert a.paths == b.paths
        for name in ("images_u8", "poses_w2c", "K", "fov_x"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
