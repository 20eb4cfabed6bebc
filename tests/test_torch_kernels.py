"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version; the JAX
kernels run in Pallas interpret mode, as the JAX package's own tests run
them.  Weights cross over through ``nerf_params_from_numpy``.  The CUDA
kernels themselves are held against the plain versions on the card by
``tests/test_torch_gpu.py`` and by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_nerf_tpu.config import NerfConfig as JNerfConfig
from mc_nerf_tpu.models.nerf import init_nerf_params as j_init_params
from mc_nerf_tpu.models.sh import sh_basis as j_sh_basis
from mc_nerf_tpu.ops.pallas import fused_mlp as j_fm
from mc_nerf_tpu.ops.pallas.fused_render import fused_render as j_fused_render

from mc_nerf_torch.config import NerfConfig
from mc_nerf_torch.models.nerf import init_nerf_params, nerf_params_from_numpy, pack_eval_params
from mc_nerf_torch.ops.cuda import fused_mlp as t_fm
from mc_nerf_torch.ops.cuda.fused_render import fused_render

NFREQ, SH_DEG = 4, 2
NB = (SH_DEG + 1) ** 2
CFG_KW = dict(emb_freqs_xyz=NFREQ, sh_deg=SH_DEG, coarse_depth=2, coarse_width=32,
              coarse_skips=(1,), fine_depth=3, fine_width=32, fine_skips=(1,))


def _params(seed=0):
    jc, tc = JNerfConfig(**CFG_KW), NerfConfig(**CFG_KW)
    jp = j_init_params(jax.random.PRNGKey(seed), jc)
    tp = nerf_params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jp, tp


def _bf16_bits_np(x):
    return np.asarray(x).view(np.uint16)


def _bf16_bits_t(x):
    return x.contiguous().view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("sigma_only", [False, True])
def test_pack_leaves_bit_equal(sigma_only):
    jp, tp = _params()
    for jm, tm, skips in ((jp.coarse, tp.coarse, (1,)), (jp.fine, tp.fine, (1,))):
        pj = j_fm.pack_mlp_params(jm, NFREQ, skips, sigma_only=sigma_only)
        pt = t_fm.pack_mlp_params(tm, NFREQ, skips, sigma_only=sigma_only)
        lj = [*pj.trunk_w, *pj.trunk_b, *pj[2:]]
        lt = [*pt.trunk_w, *pt.trunk_b, *pt[2:]]
        assert len(lj) == len(lt)
        for a, b in zip(lj, lt):
            assert tuple(a.shape) == tuple(b.shape) and b.dtype == torch.bfloat16
            np.testing.assert_array_equal(_bf16_bits_np(a), _bf16_bits_t(b))


@pytest.mark.parametrize("sigma_only", [False, True])
def test_fused_mlp_plain_matches_pallas(rng, sigma_only):
    """P = 300, not a multiple of the 128-point block: atol 2e-2, as
    tests/test_fused_mlp.py holds the Pallas kernel."""
    jp, tp = _params(1)
    pj = j_fm.pack_mlp_params(jp.fine, NFREQ, (1,), sigma_only=sigma_only)
    pt = t_fm.pack_mlp_params(tp.fine, NFREQ, (1,), sigma_only=sigma_only)
    xyz = rng.uniform(-4, 4, size=(300, 3)).astype(np.float32)
    feat_j = j_fm.encode_kernel_order(jnp.asarray(xyz), NFREQ)
    feat_t = torch.as_tensor(np.asarray(feat_j, np.float32)).bfloat16()
    out_j = j_fm.fused_mlp_apply(pj, feat_j, 3, (1,), block=128, interpret=True)
    launches = t_fm.fused_mlp_apply.launches
    out_t = t_fm.fused_mlp_apply(pt, feat_t, 3, (1,))
    assert t_fm.fused_mlp_apply.launches == launches   # the CPU never launches
    assert out_t.shape == (300, 32) and out_t.dtype == torch.float32
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0, atol=2e-2)
    if sigma_only:
        assert float(out_t[:, 1:].abs().max()) == 0.0


def _render_inputs(rng, s, rays=40):
    d = rng.normal(size=(rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.tile(np.array([[0.0, 0.0, -3.0]], np.float32), (rays, 1))
    z = np.sort(rng.uniform(1.0, 8.0, size=(rays, s)), axis=-1).astype(np.float32)
    xyz = (o[:, None] + d[:, None] * z[..., None]).reshape(-1, 3)
    feat = np.asarray(j_fm.encode_kernel_order(jnp.asarray(xyz), NFREQ), np.float32)
    basis = np.asarray(j_sh_basis(SH_DEG, jnp.asarray(d)))
    basis16 = np.pad(basis, ((0, 0), (0, j_fm.BASIS_LANES - NB))).astype(np.float32)
    noise = rng.normal(size=(rays, s)).astype(np.float32)
    noise_sel = rng.normal(size=(rays, s)).astype(np.float32)
    return feat, basis16, z, noise, noise_sel


@pytest.mark.parametrize("s", [16, 48])
@pytest.mark.parametrize("with_noise,emit_wsel", [(False, False), (True, True), (True, False)])
def test_fused_render_plain_matches_pallas(rng, s, with_noise, emit_wsel):
    """rgb, opacity and wsel within atol 2e-4; depth rtol/atol 1e-3 (the
    JAX package's tests/test_fused_render.py tolerances)."""
    jp, tp = _params(2)
    pj = j_fm.pack_mlp_params(jp.fine, NFREQ, (1,), dtype=jnp.float32)
    pt = t_fm.pack_mlp_params(tp.fine, NFREQ, (1,))
    feat, basis16, z, noise, noise_sel = _render_inputs(rng, s)
    out_j, wsel_j = j_fused_render(
        pj, jnp.asarray(feat, jnp.bfloat16), jnp.asarray(basis16), jnp.asarray(z),
        jnp.asarray(noise) if with_noise else None,
        jnp.asarray(noise_sel) if with_noise and emit_wsel else None,
        3, (1,), s, NB, with_noise, emit_wsel, True, True)
    t = torch.as_tensor
    out_t, wsel_t = fused_render(
        pt, t(feat).bfloat16(), t(basis16), t(z), t(noise), t(noise_sel), 3, (1,), s, NB,
        with_noise, emit_wsel, True)
    out_j = np.asarray(out_j)
    assert out_t.shape == (40, 8)
    np.testing.assert_allclose(out_t[:, :3].numpy(), out_j[:, :3], rtol=0, atol=2e-4)
    np.testing.assert_allclose(out_t[:, 3].numpy(), out_j[:, 3], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(out_t[:, 4].numpy(), out_j[:, 4], rtol=0, atol=2e-4)
    np.testing.assert_array_equal(out_t[:, 5:].numpy(), 0.0)
    if emit_wsel:
        np.testing.assert_allclose(wsel_t.numpy(), np.asarray(wsel_j), rtol=0, atol=2e-4)
    else:
        assert wsel_t is None and wsel_j is None


def test_fused_render_refuses_bad_shapes(rng):
    _, tp = _params()
    pt = t_fm.pack_mlp_params(tp.fine, NFREQ, (1,))
    feat, basis16, z, noise, _ = _render_inputs(rng, 8, rays=4)
    t = torch.as_tensor
    with pytest.raises(ValueError):
        fused_render(pt, t(feat).bfloat16(), t(basis16), t(z[:, :7]), None, None, 3, (1,),
                     8, NB, False, False)
    with pytest.raises(ValueError):   # with_noise and no noise
        fused_render(pt, t(feat).bfloat16(), t(basis16), t(z), None, None, 3, (1,), 8, NB,
                     True, False)
    with pytest.raises(ValueError):   # a pack of another depth
        t_fm.fused_mlp_apply(pt, t(feat).bfloat16(), 4, (1,))


def test_fused_render_sample_ceiling(rng):
    """The forward kernel's shared-memory ceiling on samples per ray (1,952
    at the default fine pack on an H100; the backward has none) is the CUDA
    sources' and is held on the card (tests/test_torch_gpu.py); the plain
    versions on CPU tensors have none: a 1,953-sample ray at that pack
    renders and takes its gradients, and nothing launches."""
    nc = NerfConfig()
    params = init_nerf_params(nc, device="cpu")
    packed = t_fm.pack_mlp_params(params.fine, nc.emb_freqs_xyz, nc.fine_skips,
                                  dtype=torch.float32)
    s, rays, nb = 1953, 2, (nc.sh_deg + 1) ** 2
    t = torch.as_tensor
    z = np.sort(rng.uniform(1.0, 8.0, size=(rays, s)), axis=-1).astype(np.float32)
    feat = t_fm.encode_kernel_order(t(rng.uniform(-3, 3, size=(rays * s, 3)).astype(np.float32)),
                                    nc.emb_freqs_xyz).requires_grad_()
    basis16 = t(np.pad(np.full((rays, nb), 0.3, np.float32), ((0, 0), (0, 16 - nb))))
    launches = fused_render.launches
    out, _ = fused_render(packed, feat, basis16, t(z), t(rng.normal(size=(rays, s)).astype(
        np.float32)), None, nc.fine_depth, nc.fine_skips, s, nb, True, False, True)
    out[:, :5].sum().backward()
    assert fused_render.launches == launches
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(feat.grad.float()).all())
    assert float(params.fine.trunk[0].weight.grad.abs().max()) > 0
