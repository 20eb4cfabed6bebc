"""K2 (``fused_render``'s forward) and K1 (``fused_mlp_apply``) on the CPU:
the byte counts their designs rest on, and their plain versions (the
kernels' oracles on the card) against the JAX package's Pallas kernels in
interpret mode at the shapes where the card tests hold the kernels at
their edges.

``tools/bwd_check.render_forward_bytes`` and ``mlp_forward_bytes`` are the
floors of ``csrc/fused_render.cu`` and ``csrc/fused_mlp.cu``, both on the
forward ring of ``csrc/shaded_fwd.cuh``: the function's own inputs and
outputs once, the pack read and its weight images written and read once,
and K2's round trip through a [P, 8] buffer between its forward and its
composite.  The values below are summed by hand.  The edge shapes are the
card tests' (``tests/test_torch_gpu.py``): rays that straddle or fill the
forward's 128-point tiles, ragged ray and point counts.
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
from mc_nerf_torch.models.nerf import nerf_params_from_numpy
from mc_nerf_torch.ops.cuda import fused_mlp as t_fm
from mc_nerf_torch.ops.cuda.fused_render import fused_render_plain
from mc_nerf_torch.tools.bwd_check import mlp_forward_bytes, render_forward_bytes

# (enc, depth, width, skips, head0) of the default packs
PACKS = {"fine": (64, 8, 256, (4,), 512), "coarse": (64, 4, 128, (2,), 256),
         "coarse sigma-only": (64, 4, 128, (2,), 128)}
NFREQ, SH_DEG = 4, 2
NB = (SH_DEG + 1) ** 2
CFG_KW = dict(emb_freqs_xyz=NFREQ, sh_deg=SH_DEG, coarse_depth=2, coarse_width=32,
              coarse_skips=(1,), fine_depth=3, fine_width=64, fine_skips=(1,))


# K2's bytes.  The pack read once: fine 638,976 weights and 2,592 biases
# (bf16: 1,283,136 B), coarse 106,496 and 800 (214,592 B); its images
# written and read: fine 2 x 1,277,952, coarse 2 x 212,992 (as
# tests/test_torch_forward.py sums them).  The eval chunk, 16384 x 32 =
# 524,288 points: feat 128 a point (67,108,864), the basis 64 a ray
# (1,048,576), z 4 a point (2,097,152), ray_out 32 a ray (524,288), the
# round trip 64 a point (33,554,432), the pack and images (3,839,040):
# 108,172,352 B.  The fine train pass, 7000 x 32 = 224,000 points with
# noise: feat 28,672,000, basis 448,000, z and noise 1,792,000, ray_out
# 224,000, round trip 14,336,000, pack and images 3,839,040: 49,311,040 B.
# The coarse train pass, 7000 x 48 = 336,000 points with noise, noise_sel
# and wsel: feat 43,008,000, basis 448,000, z and both draws 4,032,000,
# ray_out 224,000, wsel 1,344,000, round trip 21,504,000, pack and images
# 640,576: 71,200,576 B.
@pytest.mark.parametrize("pack,rays,s,draws,wsel,want", [
    ("fine", 16384, 32, 0, False, 108172352), ("fine", 7000, 32, 1, False, 49311040),
    ("coarse", 7000, 48, 2, True, 71200576)])
def test_render_forward_bytes(pack, rays, s, draws, wsel, want):
    assert render_forward_bytes(*PACKS[pack], rays * s, s, draws, wsel) == want


# K1's bytes.  The sigma-only coarse pack: 86,016 weights (trunk 65,536,
# head 0 128 x 128, head 1 128 x 32) and 672 biases, read once (173,376 B);
# its images (trunk 65,536 elements, head 0 16,384, head 1's share 4,096)
# written and read, 2 x 172,032.  The grid eval chunk, 16384 x 128 =
# 2,097,152 points: feat 128 and the rows 128 a point (536,870,912), the
# pack and images 517,440: 537,388,352 B; the importance eval chunk, 16384
# x 48 = 786,432 points: 201,326,592 + 517,440 = 201,844,032 B.  The fine
# full pack as the fused_mlp VJP's forward, 7000 x 32 = 224,000 points:
# 57,344,000 + 3,839,040 = 61,183,040 B.
@pytest.mark.parametrize("pack,points,want", [
    ("coarse sigma-only", 16384 * 128, 537388352), ("coarse sigma-only", 16384 * 48, 201844032),
    ("fine", 7000 * 32, 61183040)])
def test_mlp_forward_bytes(pack, points, want):
    assert mlp_forward_bytes(*PACKS[pack], points) == want


def _params(seed):
    jc, tc = JNerfConfig(**CFG_KW), NerfConfig(**CFG_KW)
    jp = j_init_params(jax.random.PRNGKey(seed), jc)
    return jp, nerf_params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")


def _render_inputs(rng, rays, s):
    """Seeded rays from (0, 0, -3), sorted depths in [1, 8], their
    kernel-order features, SH basis padded to 16 lanes and two N(0, 1)
    draws, as numpy arrays for both sides."""
    d = rng.normal(size=(rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(1.0, 8.0, size=(rays, s)), axis=-1).astype(np.float32)
    xyz = (np.array([0.0, 0.0, -3.0], np.float32) + d[:, None] * z[..., None]).reshape(-1, 3)
    feat = np.asarray(j_fm.encode_kernel_order(jnp.asarray(xyz), NFREQ), np.float32)
    basis16 = np.pad(np.asarray(j_sh_basis(SH_DEG, jnp.asarray(d))),
                     ((0, 0), (0, j_fm.BASIS_LANES - NB))).astype(np.float32)
    noise, noise_sel = (rng.normal(size=(rays, s)).astype(np.float32) for _ in range(2))
    return feat, basis16, z, noise, noise_sel


@pytest.mark.parametrize("s,rays", [(2, 129), (31, 3), (33, 129), (48, 1), (65, 3), (2, 1),
                                    (31, 129), (65, 1)])
@pytest.mark.parametrize("with_noise,emit_wsel", [(False, False), (True, True), (True, False),
                                                  (False, True)])
def test_render_plain_matches_pallas_at_the_kernel_edges(s, rays, with_noise, emit_wsel):
    """``fused_render_plain`` against the Pallas kernel (interpret mode) on
    the narrow fine pack: rgb, opacity and wsel within atol 2e-4, depth
    rtol / atol 1e-3 (``tests/test_fused_render.py:86-94``), lanes 5..7
    zero."""
    jp, tp = _params(s + rays)
    feat, basis16, z, noise, noise_sel = _render_inputs(np.random.default_rng(s * rays), rays, s)
    out_j, wsel_j = j_fused_render(
        j_fm.pack_mlp_params(jp.fine, NFREQ, (1,), dtype=jnp.float32),
        jnp.asarray(feat, jnp.bfloat16), jnp.asarray(basis16), jnp.asarray(z),
        jnp.asarray(noise) if with_noise else None,
        jnp.asarray(noise_sel) if with_noise and emit_wsel else None,
        3, (1,), s, NB, with_noise, emit_wsel, True, True)
    t = torch.as_tensor
    out_t, wsel_t = fused_render_plain(
        t_fm.pack_mlp_params(tp.fine, NFREQ, (1,)), t(feat).bfloat16(), t(basis16), t(z),
        t(noise), t(noise_sel), 3, (1,), s, NB, with_noise, emit_wsel, True)
    out_j = np.asarray(out_j)
    assert out_t.shape == (rays, 8)
    np.testing.assert_allclose(out_t[:, [0, 1, 2, 4]].numpy(), out_j[:, [0, 1, 2, 4]], rtol=0,
                               atol=2e-4)
    np.testing.assert_allclose(out_t[:, 3].numpy(), out_j[:, 3], rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(out_t[:, 5:].numpy(), 0.0)
    if emit_wsel:
        assert wsel_t.shape == (rays, s)
        np.testing.assert_allclose(wsel_t.numpy(), np.asarray(wsel_j).reshape(rays, s), rtol=0,
                                   atol=2e-4)
    else:
        assert wsel_t is None


@pytest.mark.parametrize("sigma_only", [True, False], ids=["sigma-only", "full"])
@pytest.mark.parametrize("n_points", [1, 127, 129, 8193])
def test_mlp_plain_matches_pallas_at_the_kernel_edges(sigma_only, n_points):
    """``mlp_plain`` (K1's oracle) against the Pallas ``fused_mlp_apply``
    (interpret mode) on the narrow coarse and fine packs, sigma-only and
    full: one point, either side of a 128-point tile, one point past 64
    tiles; atol 2e-2 (``tests/test_fused_mlp.py``), zeros past column 0 of
    a sigma-only pack."""
    jp, tp = _params(n_points)
    xyz = np.random.default_rng(n_points).uniform(-4, 4, size=(n_points, 3)).astype(np.float32)
    feat_j = j_fm.encode_kernel_order(jnp.asarray(xyz), NFREQ)
    feat_t = torch.as_tensor(np.asarray(feat_j, np.float32)).bfloat16()
    for jm, tm, depth in ((jp.coarse, tp.coarse, 2), (jp.fine, tp.fine, 3)):
        out_j = j_fm.fused_mlp_apply(j_fm.pack_mlp_params(jm, NFREQ, (1,), sigma_only=sigma_only),
                                     feat_j, depth, (1,), block=128, interpret=True)
        out_t = t_fm.mlp_plain(t_fm.pack_mlp_params(tm, NFREQ, (1,), sigma_only=sigma_only),
                               feat_t, depth, (1,))
        assert out_t.shape == (n_points, 32) and out_t.dtype == torch.float32
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0, atol=2e-2)
        if sigma_only:
            assert float(out_t[:, 1:].abs().max()) == 0.0
