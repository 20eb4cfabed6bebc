"""The port's backward of the fused render, the encode and the pack against
the JAX package.

On the CPU, the port's ``fused_render`` autograd runs the plain versions
of its kernels forward and backward (``fused_render_bwd_plain``); the JAX
side is ``jax.grad`` of the Pallas kernel in interpret mode, as the JAX
package's own tests run it.  Sizes are those of
``tests/test_fused_render.py``: depth 2, width 32, a skip at 1, 4 octaves,
40 rays (not a multiple of the Pallas ray block), 16 samples per ray.
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
    fused_render,
    fused_render_bwd,
    fused_render_bwd_plain,
)

DEPTH, WIDTH, SKIPS = 2, 32, (1,)
NFREQ, SH_DEG = 4, 2
NB = (SH_DEG + 1) ** 2
S, RAYS = 16, 40
FLAGS = [(True, True), (True, False), (False, False)]


def _setup(seed):
    """The same MLP (JAX leaves copied into the port's module) and the same
    numpy inputs on both sides."""
    jm = j_init_mlp(jax.random.PRNGKey(seed), 3 * (2 * NFREQ + 1), DEPTH, WIDTH, SKIPS,
                    3 * NB)
    tm = _mlp_from_numpy(jax.tree.map(np.asarray, jm), SKIPS, "cpu")
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(1.0, 8.0, size=(RAYS, S)), axis=-1).astype(np.float32)
    xyz = (np.array([0.0, 0.0, -3.0], np.float32) + d[:, None] * z[..., None]).reshape(-1, 3)
    feat = np.asarray(j_fm.encode_kernel_order(jnp.asarray(xyz), NFREQ), np.float32)
    basis = np.asarray(j_sh_basis(SH_DEG, jnp.asarray(d)))
    basis16 = np.pad(basis, ((0, 0), (0, 16 - NB))).astype(np.float32)
    noise = rng.normal(size=(RAYS, S)).astype(np.float32)
    noise_sel = rng.normal(size=(RAYS, S)).astype(np.float32)
    coeff = rng.normal(size=(RAYS, 5)).astype(np.float32)
    return jm, tm, feat, basis16, z, noise, noise_sel, coeff


def _leaves(p):
    return [*p.trunk_w, *p.trunk_b, p.head_w0, p.head_b0, p.head_w1, p.head_b1]


def _close_per_leaf(got, ref, name):
    """atol 5e-3 * max|ref| per leaf: tests/test_fused_render.py:131."""
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    scale = max(1e-3, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-3 * scale, err_msg=name)


@pytest.mark.parametrize("with_noise,emit_wsel", FLAGS)
def test_fused_render_grads_match_pallas(with_noise, emit_wsel):
    """Weight, feat and basis gradients through rgb, depth and opacity
    cotangents at once, per leaf within atol 5e-3 * max|ref|."""
    jm, tm, feat, basis16, z, noise, noise_sel, coeff = _setup(0)
    jp = j_fm.pack_mlp_params(jm, NFREQ, SKIPS, dtype=jnp.float32)
    nz = jnp.asarray(noise) if with_noise else None
    ns = jnp.asarray(noise_sel) if with_noise and emit_wsel else None

    def j_loss(packed, f, b):
        out, _ = j_fused_render(packed, f, b, jnp.asarray(z), nz, ns, DEPTH, SKIPS, S, NB,
                                with_noise, emit_wsel, True, True)
        return jnp.sum(out[:, :5] * jnp.asarray(coeff))

    j_feat = jnp.asarray(feat, jnp.bfloat16)
    j_val, j_grads = jax.value_and_grad(j_loss, argnums=(0, 1, 2))(
        jp, j_feat, jnp.asarray(basis16))

    tp = t_fm.pack_mlp_params(tm, NFREQ, SKIPS, dtype=torch.float32)
    for leaf in _leaves(tp):
        leaf.retain_grad()
    t_feat = torch.as_tensor(feat).bfloat16().requires_grad_()
    t_basis = torch.as_tensor(basis16).requires_grad_()
    t = torch.as_tensor
    out, wsel = fused_render(tp, t_feat, t_basis, t(z), t(noise), t(noise_sel), DEPTH, SKIPS,
                             S, NB, with_noise, emit_wsel, True)
    assert (wsel is not None) == emit_wsel and (wsel is None or not wsel.requires_grad)
    loss = (out[:, :5] * t(coeff)).sum()
    loss.backward()
    assert abs(float(loss.detach()) - float(j_val)) <= 2e-3 * max(1.0, abs(float(j_val)))
    for i, (a, b) in enumerate(zip(_leaves(tp), _leaves(j_grads[0]))):
        _close_per_leaf(a.grad, b, f"packed leaf {i}")
    assert t_feat.grad.dtype == torch.bfloat16
    _close_per_leaf(t_feat.grad, np.asarray(j_grads[1], np.float32), "dfeat")
    _close_per_leaf(t_basis.grad, j_grads[2], "dbasis")


def test_fused_render_module_grads_through_pack():
    """Gradients reach the module's own weights through the differentiable
    fp32 pack (the inverse permutation; nothing from the pad lane or the
    zero blocks of head_w1), against the JAX grads w.r.t. the unpacked
    leaves."""
    jm, tm, feat, basis16, z, noise, noise_sel, coeff = _setup(1)

    def j_loss(mlp):
        packed = j_fm.pack_mlp_params(mlp, NFREQ, SKIPS, dtype=jnp.float32)
        out, _ = j_fused_render(packed, jnp.asarray(feat, jnp.bfloat16), jnp.asarray(basis16),
                                jnp.asarray(z), jnp.asarray(noise), jnp.asarray(noise_sel),
                                DEPTH, SKIPS, S, NB, True, True, True, True)
        return jnp.sum(out[:, :5] * jnp.asarray(coeff))

    jg = jax.grad(j_loss)(jm)
    t = torch.as_tensor
    tp = t_fm.pack_mlp_params(tm, NFREQ, SKIPS, dtype=torch.float32)
    out, _ = fused_render(tp, t(feat).bfloat16(), t(basis16), t(z), t(noise), t(noise_sel),
                          DEPTH, SKIPS, S, NB, True, True, True)
    (out[:, :5] * t(coeff)).sum().backward()
    pairs = [(layer.weight.grad.t(), jw) for layer, jw in zip(tm.trunk, jg.trunk_w)]
    pairs += [(layer.bias.grad, jb) for layer, jb in zip(tm.trunk, jg.trunk_b)]
    for mod, head, i in (("sigma0", "sigma", 0), ("sigma1", "sigma", 1),
                         ("sh0", "sh", 0), ("sh1", "sh", 1)):
        m = getattr(tm, mod)
        pairs += [(m.weight.grad.t(), getattr(jg, f"{head}_w{i}")),
                  (m.bias.grad, getattr(jg, f"{head}_b{i}"))]
    for k, (a, b) in enumerate(pairs):
        assert tuple(a.shape) == tuple(np.shape(b)), k
        _close_per_leaf(a, b, f"module leaf {k}")


def test_bwd_plain_is_the_wrapper_on_cpu():
    """On CPU tensors ``fused_render_bwd`` is the plain backward, and it
    launches nothing; the plain backward sums in ``dray``'s dtype, and in
    float64 it agrees with float32 within relative L2 1e-3."""
    _, tm, feat, basis16, z, noise, _, _ = _setup(2)
    tp = t_fm.pack_mlp_params(tm, NFREQ, SKIPS)
    ws, bs = t_fm._flat_weights(tp)
    t = torch.as_tensor
    dray = t(np.random.default_rng(5).normal(size=(RAYS, 8)).astype(np.float32))
    args = (ws, bs, t(feat).bfloat16(), t(basis16), t(z), t(noise), dray, DEPTH, SKIPS, S,
            NB, True, True)
    a, b = fused_render_bwd(*args), fused_render_bwd_plain(*args)
    for x, y in zip([*a[0], *a[1], a[2], a[3]], [*b[0], *b[1], b[2], b[3]]):
        assert torch.equal(x, y)
    assert [tuple(g.shape) for g in a[0]] == [tuple(w.shape) for w in ws]
    assert [tuple(g.shape) for g in a[1]] == [tuple(w.shape) for w in bs]
    assert a[0][0].dtype == torch.float32
    # sums in dray's dtype: float64 gives the same rounding points' reference
    c = fused_render_bwd_plain(*args[:6], dray.double(), *args[7:])
    assert c[0][0].dtype == torch.float64
    for x, y in zip([*b[0], *b[1], b[2], b[3]], [*c[0], *c[1], c[2], c[3]]):
        assert float((x.double() - y).norm()) <= 1e-3 * float(y.norm())


def test_encode_vjp_matches_pallas_encode_bwd(rng):
    """The encode's analytic VJP (with a BARF gate) against
    ``_encode_core_bwd``: same bf16-rounded cotangent, rtol 1e-5 on the
    [P, 3] gradient (fp32 sums in another order)."""
    xyz = rng.uniform(-3, 3, size=(257, 3)).astype(np.float32)
    gate = np.array([1.0, 0.8, 0.25, 0.0], np.float32)
    cot = rng.normal(size=(257, 4 + 6 * NFREQ)).astype(np.float32)
    cot_b = np.asarray(jnp.asarray(cot, jnp.bfloat16), np.float32)

    def j_f(x):
        return jnp.sum(j_fm.encode_kernel_order(x, NFREQ, jnp.asarray(gate)).astype(jnp.float32)
                       * jnp.asarray(cot_b))

    jg = np.asarray(jax.grad(j_f)(jnp.asarray(xyz)))
    x = torch.as_tensor(xyz).requires_grad_()
    out = t_fm.encode_kernel_order(x, NFREQ, torch.as_tensor(gate))
    assert out.dtype == torch.bfloat16
    out.backward(torch.as_tensor(cot_b).bfloat16())
    np.testing.assert_allclose(x.grad.numpy(), jg, rtol=1e-5, atol=1e-5 * np.abs(jg).max())


@pytest.mark.parametrize("sigma_only", [False, True])
def test_pack_vjp_matches_jax(rng, sigma_only):
    """The differentiable fp32 pack's VJP against the JAX pack's: the same
    random cotangent on every packed leaf maps back to the module's leaves
    exactly (sums of at most one term per entry)."""
    jm, tm, *_ = _setup(3)
    jp, vjp = jax.vjp(lambda m: j_fm.pack_mlp_params(m, NFREQ, SKIPS, sigma_only=sigma_only,
                                                     dtype=jnp.float32), jm)
    cots = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), jp)
    (jg,) = vjp(jax.tree.map(jnp.asarray, cots))
    tp = t_fm.pack_mlp_params(tm, NFREQ, SKIPS, sigma_only=sigma_only, dtype=torch.float32)
    assert all(leaf.dtype == torch.float32 and leaf.requires_grad for leaf in _leaves(tp))
    torch.autograd.backward(_leaves(tp), [torch.as_tensor(c) for c in _leaves(cots)])
    np.testing.assert_array_equal(tm.trunk[0].weight.grad.t().numpy(), np.asarray(jg.trunk_w[0]))
    np.testing.assert_array_equal(tm.trunk[1].weight.grad.t().numpy(), np.asarray(jg.trunk_w[1]))
    np.testing.assert_array_equal(tm.sigma1.weight.grad.t().numpy(), np.asarray(jg.sigma_w1))
    np.testing.assert_array_equal(tm.sigma1.bias.grad.numpy(), np.asarray(jg.sigma_b1))
    if not sigma_only:
        np.testing.assert_array_equal(tm.sh1.weight.grad.t().numpy(), np.asarray(jg.sh_w1))
        np.testing.assert_array_equal(tm.sh0.bias.grad.numpy(), np.asarray(jg.sh_b0))
    else:
        assert tm.sh1.weight.grad is None
    # the bf16 eval pack stays out of autograd
    assert not any(leaf.requires_grad for leaf in _leaves(t_fm.pack_mlp_params(tm, NFREQ, SKIPS)))
