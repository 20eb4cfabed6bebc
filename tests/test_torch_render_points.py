"""K3's points stage as the port's kernels split it, against the JAX
package.

``render_bwd_points`` (``csrc/fused_render_bwd.cu``) runs the backward of
``fused_render`` as a forward (each point's raw sigma and sigmoid rgb), the
composite backward per ray (each point's cotangent dout8: d sigma, w * d
rgb_c, zeros) and then ``fused_shaded_mlp``'s points stage from that
dout8.  Here, on the CPU, the plain versions of the two steps
(``render_composite_bwd_plain``, then ``fused_shaded_mlp_bwd_plain``) are
held against ``fused_render_bwd_plain`` and against ``jax.grad`` of the
JAX package's ``fused_render`` (its Pallas kernels in interpret mode, as
the JAX package's own tests run them), at
``tests/test_fused_render.py:131``'s atol 5e-3 * max|ref| per leaf; and the
composite step alone against autograd of the composite.  Sizes: the
narrow MLP of ``tests/test_fused_render.py`` (depth 2, width 32, a skip at
1, 4 octaves), 20 rays, noise on and off, the white background on and
off, 2 to 130 samples per ray.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_nerf_tpu.models.mlp import init_nerf_mlp as j_init_mlp
from mc_nerf_tpu.models.sh import sh_basis as j_sh_basis
from mc_nerf_tpu.ops.pallas import fused_mlp as j_fm
from mc_nerf_tpu.ops.pallas.fused_render import fused_render as j_fused_render

from mc_nerf_torch.models.nerf import _mlp_from_numpy
from mc_nerf_torch.ops.cuda import fused_mlp as t_fm
from mc_nerf_torch.ops.cuda.fused_render import (
    _deltas_flat,
    _exclusive_cumsum,
    _softplus,
    fused_render_bwd_plain,
    render_composite_bwd_plain,
)

DEPTH, WIDTH, SKIPS = 2, 32, (1,)
NFREQ, SH_DEG = 4, 2
NB = (SH_DEG + 1) ** 2
RAYS = 20
SAMPLES = [2, 17, 48, 130]
FLAGS = [(True, True), (True, False), (False, True), (False, False)]
FLAG_IDS = ["noise-white", "noise-black", "clean-white", "clean-black"]


def _setup(seed, s):
    """The same MLP (JAX leaves copied into the port's module) and the same
    numpy inputs on both sides; coeff is the cotangent of the rays' rgb,
    depth and opacity."""
    jm = j_init_mlp(jax.random.PRNGKey(seed), 3 * (2 * NFREQ + 1), DEPTH, WIDTH, SKIPS,
                    3 * NB)
    tm = _mlp_from_numpy(jax.tree.map(np.asarray, jm), SKIPS, "cpu")
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(1.0, 8.0, size=(RAYS, s)), axis=-1).astype(np.float32)
    xyz = (np.array([0.0, 0.0, -3.0], np.float32) + d[:, None] * z[..., None]).reshape(-1, 3)
    feat = np.asarray(j_fm.encode_kernel_order(jnp.asarray(xyz), NFREQ), np.float32)
    basis = np.asarray(j_sh_basis(SH_DEG, jnp.asarray(d)))
    basis16 = np.pad(basis, ((0, 0), (0, 16 - NB))).astype(np.float32)
    noise = rng.normal(size=(RAYS, s)).astype(np.float32)
    coeff = rng.normal(size=(RAYS, 5)).astype(np.float32)
    return jm, tm, feat, basis16, z, noise, coeff


def _close(got, ref, name):
    """atol 5e-3 * max|ref|: tests/test_fused_render.py:131."""
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    scale = max(1e-3, float(np.abs(ref).max()))
    np.testing.assert_allclose(got.reshape(ref.shape), ref, rtol=0, atol=5e-3 * scale,
                               err_msg=name)


def _split_backward(ws, bs, feat, basis16, z, noise, dray, s, white_back):
    """The kernels' split in plain PyTorch: the forward's sigma and rgb, the
    composite's dout8, then the shaded MLP's backward from it."""
    out8 = t_fm._shaded_plain_flat(ws, bs, feat, basis16, DEPTH, SKIPS, s, NB)
    out8 = out8.reshape(RAYS, s, t_fm.SHADED_COLS)
    dout8 = render_composite_bwd_plain(out8[..., 0], out8[..., 1:4], z, noise, dray, white_back)
    return dout8, t_fm.fused_shaded_mlp_bwd_plain(ws, bs, feat, basis16, dout8, DEPTH, SKIPS,
                                                  s, NB)


@pytest.mark.parametrize("with_noise,white_back", FLAGS, ids=FLAG_IDS)
@pytest.mark.parametrize("s", SAMPLES)
def test_split_backward_matches_fused_render_vjp(s, with_noise, white_back):
    """render_composite_bwd_plain then fused_shaded_mlp_bwd_plain against
    fused_render_bwd_plain and the JAX fused_render VJP: every packed
    weight and bias, dfeat (rounded to feat's bf16, as the custom VJP
    hands it back) and dbasis, per leaf within atol 5e-3 * max|ref|."""
    jm, tm, feat, basis16, z, noise, coeff = _setup(s, s)
    jp = j_fm.pack_mlp_params(jm, NFREQ, SKIPS, dtype=jnp.float32)
    nz = jnp.asarray(noise) if with_noise else None

    def j_loss(packed, f, b):
        out, _ = j_fused_render(packed, f, b, jnp.asarray(z), nz, None, DEPTH, SKIPS, s, NB,
                                with_noise, False, white_back, True)
        return jnp.sum(out[:, :5] * jnp.asarray(coeff))

    j_grads = jax.grad(j_loss, argnums=(0, 1, 2))(jp, jnp.asarray(feat, jnp.bfloat16),
                                                  jnp.asarray(basis16))
    t = torch.as_tensor
    ws, bs = t_fm._flat_weights(t_fm.pack_mlp_params(tm, NFREQ, SKIPS, dtype=torch.float32))
    dray = torch.nn.functional.pad(t(coeff), (0, 3))
    t_noise = t(noise) if with_noise else None
    args = (ws, bs, t(feat).bfloat16(), t(basis16), t(z), t_noise, dray)
    dout8, split = _split_backward(*args, s, white_back)
    assert tuple(dout8.shape) == (RAYS * s, 8) and not bool(dout8[:, 4:].any())
    ref = fused_render_bwd_plain(*args, DEPTH, SKIPS, s, NB, with_noise, white_back)
    j_w = [*jax.tree.leaves(j_grads[0].trunk_w), j_grads[0].head_w0, j_grads[0].head_w1]
    j_b = [*jax.tree.leaves(j_grads[0].trunk_b), j_grads[0].head_b0, j_grads[0].head_b1]
    for i, (g, r, j) in enumerate(zip(split[0] + split[1], ref[0] + ref[1], j_w + j_b)):
        _close(g, r.numpy(), f"leaf {i} against the plain backward")
        _close(g, j, f"leaf {i} against JAX")
    _close(split[2], ref[2].numpy(), "dfeat against the plain backward")
    _close(split[2].bfloat16(), np.asarray(j_grads[1], np.float32), "dfeat against JAX")
    _close(split[3], ref[3].numpy(), "dbasis against the plain backward")
    _close(split[3], j_grads[2], "dbasis against JAX")


@pytest.mark.parametrize("with_noise,white_back", FLAGS, ids=FLAG_IDS)
@pytest.mark.parametrize("s", SAMPLES)
def test_composite_bwd_is_the_composite_vjp(s, with_noise, white_back):
    """dout8 against autograd of the composite (the forward's arithmetic in
    ``fused_render_plain``, float64): d sigma in column 0, d rgb in
    columns 1-3, within 1e-4 * max|ref|, zeros after."""
    rng = np.random.default_rng(100 + s)
    t = torch.as_tensor
    sigma = t(rng.normal(0.0, 3.0, size=(RAYS, s))).requires_grad_()
    rgb = t(rng.uniform(0.05, 0.95, size=(RAYS, s, 3))).requires_grad_()
    z = t(np.sort(rng.uniform(1.0, 8.0, size=(RAYS, s)), axis=-1))
    noise = t(rng.normal(size=(RAYS, s))) if with_noise else None
    dray = t(np.pad(rng.normal(size=(RAYS, 5)), ((0, 0), (0, 3))))
    d = _deltas_flat(z).reshape(RAYS, s)

    def weights(sig):
        sd = _softplus(sig) * d
        return (1.0 - torch.exp(-sd)) * torch.exp(-_exclusive_cumsum(sd))

    prob = weights(sigma)
    w = weights(sigma + noise) if with_noise else prob
    rgb_out = (w[..., None] * rgb).sum(1) + ((1.0 - w.sum(1, keepdim=True)) if white_back else 0)
    out = torch.cat([rgb_out, (z * prob).sum(1, keepdim=True), prob.sum(1, keepdim=True)], 1)
    d_sigma, d_rgb = torch.autograd.grad(out, (sigma, rgb), dray[:, :5])
    dout8 = render_composite_bwd_plain(sigma, rgb, z, noise, dray.float(), white_back)
    assert dout8.dtype == torch.float32 and tuple(dout8.shape) == (RAYS * s, 8)
    dout8 = render_composite_bwd_plain(sigma, rgb, z, noise, dray, white_back).reshape(RAYS, s, 8)
    for got, ref in ((dout8[..., 0], d_sigma), (dout8[..., 1:4], d_rgb)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=1e-4 * float(ref.abs().max()))
    assert not bool(dout8[..., 4:].any())
