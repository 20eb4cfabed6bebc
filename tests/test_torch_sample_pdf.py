"""``ops/volume.py::sample_pdf``'s dispatch on the CPU: what runs where.

The kernel (``csrc/sample_pdf.cu``) runs only on a CUDA card, where
``tests/test_torch_gpu.py`` holds it against ``sample_pdf_plain``.  Here:
CPU inputs take ``sample_pdf_plain`` bit for bit and count one
``sample_pdf.plain``; inputs that require grad take it too and
differentiate; the wrapper's argument checks refuse what the kernel does
not take (on the card nothing else runs); ``draw_gap``, the measure the
kernel is held to, reads another order of the PMF's sums as rounding and
the planted faults as faults; and the renders' calls counted by the
tracer (the frame's two draws a chunk, the train step's two, the
coarse-free draw's one).  The parity of ``sample_pdf`` with the JAX
package is ``tests/test_torch_ops.py::test_sample_pdf``.
"""

import numpy as np
import pytest
import torch

from mc_nerf_torch.config import NerfConfig
from mc_nerf_torch.models.nerf import (
    draw_render,
    init_nerf_params,
    render_rays_eval,
    render_rays_train,
)
from mc_nerf_torch.ops.cuda.sample_pdf import check_args, draw_gap, sample_pdf_cuda
from mc_nerf_torch.ops.volume import sample_pdf, sample_pdf_plain
from mc_nerf_torch.utils import trace

NARROW = dict(emb_freqs_xyz=4, coarse_depth=2, coarse_width=32, coarse_skips=(1,),
              fine_depth=3, fine_width=64, fine_skips=(1,), occ_grid_size=8, occ_probes=16,
              occ_coarse_samples=12)


def _counts():
    c = trace.snapshot()["counters"]
    return (c.get("sample_pdf.kernel", 0), c.get("sample_pdf.plain", 0),
            sample_pdf_cuda.launches)


def _rows(rays, s, seed):
    rng = np.random.default_rng(seed)
    z = np.sort(rng.uniform(1.0, 8.0, (rays, s)), axis=-1)
    w = rng.uniform(0.0, 1.0, (rays, s)) * (rng.uniform(size=(rays, s)) < 0.5)
    return torch.as_tensor(z, dtype=torch.float32), torch.as_tensor(w, dtype=torch.float32)


@pytest.mark.parametrize("s,k", [(66, 48), (48, 32), (7, 3)])
@pytest.mark.parametrize("draws", ["midpoints", "uniforms", "generator"])
def test_cpu_inputs_take_the_plain_body_bit_for_bit(s, k, draws):
    z, w = _rows(37, s, s * k)
    u = torch.rand((37, k), generator=torch.Generator().manual_seed(1)) \
        if draws == "uniforms" else None

    def gen():
        return torch.Generator().manual_seed(2) if draws == "generator" else None

    before = _counts()
    out = sample_pdf(z, w, k, uniforms=u, generator=gen())
    assert _counts() == (before[0], before[1] + 1, before[2])
    assert torch.equal(out, sample_pdf_plain(z, w, k, uniforms=u, generator=gen()))


@pytest.mark.parametrize("needs_grad", ["weights", "z"])
def test_inputs_that_require_grad_take_the_plain_route_and_differentiate(needs_grad):
    z, w = _rows(9, 20, 3)
    leaf = (w if needs_grad == "weights" else z).requires_grad_()
    before = _counts()
    out = sample_pdf(z, w, 16)
    assert _counts() == (before[0], before[1] + 1, before[2])
    assert torch.equal(out.detach(), sample_pdf_plain(z.detach(), w.detach(), 16))
    out.sum().backward()
    assert leaf.grad is not None and bool(torch.isfinite(leaf.grad).all())
    assert float(leaf.grad.abs().sum()) > 0.0


def _refused(case):
    z, w = _rows(5, 12, 4)
    u = torch.rand(5, 8)
    return {"float64 weights": (z, w.double(), 8, None),
            "1-D weights": (z[0], w[0], 8, None),
            "3-D weights": (z[None], w[None], 8, None),
            "non-contiguous weights": (z, w.t().contiguous().t(), 8, None),
            "z of another shape": (z[:, :-1], w, 8, None),
            "uniforms of another shape": (z, w, 8, u[:, :-1]),
            "float64 uniforms": (z, w, 8, u.double()),
            "z with strided columns": (torch.cat([z, z], 1)[:, ::2], w, 8, None),
            "weights that require grad": (z, w.requires_grad_(), 8, None),
            "uniforms that require grad": (z, w, 8, u.requires_grad_()),
            "no samples": (z, w, 0, None),
            "CPU tensors": (z, w, 8, u)}[case]


@pytest.mark.parametrize("case", ["float64 weights", "1-D weights", "3-D weights",
                                  "non-contiguous weights", "z of another shape",
                                  "uniforms of another shape", "float64 uniforms",
                                  "z with strided columns", "weights that require grad",
                                  "uniforms that require grad", "no samples", "CPU tensors"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(case):
    """Each check raises before anything is built or launched; on the
    card ``sample_pdf`` calls the wrapper whatever it is given, so an
    input the kernel does not take raises there instead of running
    elsewhere."""
    before = sample_pdf_cuda.launches
    with pytest.raises(ValueError, match="sample_pdf_cuda"):
        check_args(*_refused(case))
    with pytest.raises(ValueError, match="sample_pdf_cuda"):
        sample_pdf_cuda(*_refused(case))
    assert sample_pdf_cuda.launches == before


def test_inputs_that_require_grad_pass_the_checks_under_no_grad():
    """Under ``torch.no_grad()`` nothing would flow back, so an input that
    requires grad (a parameter, say) passes the gradient check; on the CPU
    only the device check refuses it."""
    z, w = _rows(5, 12, 4)
    w.requires_grad_()
    with torch.no_grad(), pytest.raises(ValueError, match="unsupported device"):
        check_args(z, w, 8, None)


def test_a_zero_stride_z_passes_the_checks_until_the_device():
    """The eval's probe depths (one row expanded, row stride 0) pass every
    check the kernel makes of the layout; on the CPU only the device
    check refuses them."""
    z, w = _rows(5, 12, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        check_args(z[:1].expand(5, 12), w, 8, None)


def _two_surfaces(rays, s, seed):
    """Rows of two surfaces a ray, each a few bins wide, their mass split
    at random, a fifth of the rays empty: the CDF climbs twice with a
    plateau of floor-only bins between, where a draw lands now and then."""
    g = torch.Generator().manual_seed(seed)
    z = torch.sort(torch.rand(rays, s, generator=g) * 7 + 1, -1).values
    j = torch.arange(s, dtype=torch.float32)[None]
    c1 = torch.randint(1, max(2, s // 2 - 1), (rays, 1), generator=g).float()
    c2 = torch.randint(s // 2, s - 1, (rays, 1), generator=g).float()
    a = torch.rand(rays, 1, generator=g)
    width = 0.3 + 2 * torch.rand(rays, 1, generator=g)
    w = (a * torch.exp(-0.5 * ((j - c1) / width) ** 2)
         + (1 - a) * torch.exp(-0.5 * ((j - c2) / width) ** 2))
    return z, w * (torch.rand(rays, 1, generator=g) < 0.8)


def _tree_draws(z, w, k, u):
    """sample_pdf_plain with the PMF summed and scanned in the kernel's
    order (csrc/sample_pdf.cu: a lane's four slots, a butterfly; a scan of
    each slot's 32 lanes, the carry added after)."""
    rays, n = w.shape[0], w.shape[1] - 2
    pmf = torch.zeros(rays, 4, 32)
    pmf.view(rays, 128)[:, :n] = w[:, 1:-1] + 1e-5
    x = (pmf[:, 0] + pmf[:, 1]) + (pmf[:, 2] + pmf[:, 3])
    for off in (16, 8, 4, 2, 1):
        x = x + x[:, torch.arange(32) ^ off]
    p = pmf / x[:, :1, None]
    for off in (1, 2, 4, 8, 16):
        p = p + torch.nn.functional.pad(p[..., :-off], (off, 0))
    carry = torch.zeros(rays, 1)
    for slot in range(4):
        p[:, slot] = carry + p[:, slot]
        carry = p[:, slot, 31:]
    cdf = torch.cat([torch.zeros(rays, 1), p.reshape(rays, 128)[:, :n]], -1)
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    strata = torch.arange(k, dtype=torch.float32)
    u = torch.clamp((strata + 0.5) / k if u is None else (strata + u) / k, max=1.0 - 1e-6)
    u = u.expand(rays, k)
    mask = cdf[:, None, :] <= u[..., None]
    c_lo = torch.where(mask, cdf[:, None, :], -1e10).amax(-1)
    z_lo = torch.where(mask, mids[:, None, :], -1e10).amax(-1)
    c_hi = torch.where(mask, 1e10, cdf[:, None, :]).amin(-1)
    z_hi = torch.where(mask, 1e10, mids[:, None, :]).amin(-1)
    denom = torch.where(c_hi - c_lo < 1e-8, torch.ones_like(c_lo), c_hi - c_lo)
    return z_lo + (u - c_lo) / denom * (z_hi - z_lo)


@pytest.mark.parametrize("s,k", [(66, 48), (48, 32)])
@pytest.mark.parametrize("draws", ["midpoints", "uniforms"])
def test_draw_gap_reads_the_kernels_order_of_sums_as_rounding(s, k, draws):
    """The kernel's order of the PMF's sums moves draws on a plateau by
    far more than a depth's rounding (1e-4 and up), and draw_gap still
    reads 1 or less: each such draw moved within rounding of the CDF."""
    z, w = _two_surfaces(4096, s, s + k)
    u = torch.rand((4096, k), generator=torch.Generator().manual_seed(k)) \
        if draws == "uniforms" else None
    ref, alt = sample_pdf_plain(z, w, k, u), _tree_draws(z, w, k, u)
    assert float((alt - ref).abs().max()) > 1e-4
    assert draw_gap(alt, ref, z, w) <= 1.0


@pytest.mark.parametrize("plant", ["midpoints one bin late", "jitter added",
                                   "another ray's weights"])
def test_draw_gap_sees_the_planted_faults(plant):
    """Each planted fault reads 1000 or more: far past the tolerance."""
    z, w = _two_surfaces(512, 66, 7)
    ref = sample_pdf_plain(z, w, 48)
    bad = {"midpoints one bin late": lambda: sample_pdf_plain(z.roll(1, 1), w, 48),
           "jitter added": lambda: sample_pdf_plain(
               z, w, 48, torch.rand((512, 48), generator=torch.Generator().manual_seed(3))),
           "another ray's weights": lambda: sample_pdf_plain(z, w.roll(1, 0), 48)}[plant]()
    assert draw_gap(bad, ref, z, w) >= 1e3


def test_draw_gap_counts_nan_only_where_one_side_has_it():
    z, w = _two_surfaces(16, 20, 9)
    ref = sample_pdf_plain(z, w, 8)
    both, one = ref.clone(), ref.clone()
    both[3] = float("nan")
    one[5, 2] = float("nan")
    assert draw_gap(both, both.clone(), z, w) == 0.0
    assert draw_gap(one, ref, z, w) == float("inf")


def _occ(nc):
    g = nc.occ_grid_size
    occ = torch.zeros((g * g, g), dtype=torch.bfloat16)
    occ.view(g, g, g)[g // 4:3 * g // 4, g // 4:3 * g // 4, g // 4:3 * g // 4] = 1
    return occ


def _rays(n, seed=0):
    rng = np.random.default_rng(seed)
    d = torch.as_tensor(rng.normal(size=(n, 3)), dtype=torch.float32)
    d = d / d.norm(dim=-1, keepdim=True)
    return d, -4.0 * d


@pytest.mark.parametrize("mode,calls", [("culled", 2), ("unculled", 1), ("coarse-free", 1)])
def test_an_eval_render_counts_its_draws(mode, calls):
    """The culled frame's chunk draws twice (the coarse depths from the
    occupancy PMF, the fine from the coarse weights), the unculled once,
    the coarse-free once: all plain on the CPU."""
    nc = NerfConfig(**NARROW)
    params = init_nerf_params(nc, torch.Generator().manual_seed(0), "cpu")
    d, o = _rays(24)
    before = _counts()
    rgb, _, _ = render_rays_eval(params, d, o, nc, torch.float32, importance_samples=8,
                                 occ=None if mode == "unculled" else _occ(nc),
                                 coarse_free=mode == "coarse-free")
    assert _counts() == (before[0], before[1] + calls, before[2])
    assert bool(torch.isfinite(rgb).all())


def test_a_train_render_counts_its_two_draws():
    nc = NerfConfig(**NARROW)
    params = init_nerf_params(nc, torch.Generator().manual_seed(0), "cpu")
    d, o = _rays(24, 1)
    draws = draw_render(24, nc, 8, True, torch.Generator().manual_seed(1))
    before = _counts()
    rgb_c, rgb_f = render_rays_train(params, d, o, draws, torch.tensor(0.5), nc, (0.1, 0.5),
                                     True, torch.float32, "importance", 8, occ=_occ(nc))
    assert _counts() == (before[0], before[1] + 2, before[2])
    assert bool(torch.isfinite(rgb_f).all())
