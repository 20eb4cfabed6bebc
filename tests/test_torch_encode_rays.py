"""The eval kernels' rays entry points on the CPU: ``fused_mlp_apply_rays``,
``fused_render_rays`` and ``fused_shaded_mlp_rays`` take the plain route,
``encode_kernel_order`` of the points and the feat entry point's plain
body, bit for bit, and count ``encode.glue``; ``render_rays_eval``'s
kernel route calls them (the coarse pass, the fine pass, the coarse-free
branch); the training render still hands the feat entry points the
encode's features, whose VJP carries the cameras' gradients.  The card's
route (the encode inside the kernels) is ``tests/test_torch_encode_rays_gpu.py``.
"""

import pytest
import torch

from mc_nerf_torch.config import NerfConfig
from mc_nerf_torch.models import nerf as nerf_module
from mc_nerf_torch.models.nerf import (
    draw_render,
    init_nerf_params,
    pack_eval_params,
    render_rays_eval,
    render_rays_train,
)
from mc_nerf_torch.models.sh import sh_basis
from mc_nerf_torch.ops.cuda.fused_mlp import (
    BASIS_LANES,
    encode_kernel_order,
    fused_mlp_apply_rays,
    fused_shaded_mlp,
    fused_shaded_mlp_rays,
    mlp_plain,
    ray_points,
)
from mc_nerf_torch.ops.cuda.fused_render import fused_render, fused_render_plain, fused_render_rays
from mc_nerf_torch.utils import trace

NC = NerfConfig(emb_freqs_xyz=4, coarse_depth=2, coarse_width=32, coarse_skips=(1,),
                fine_depth=3, fine_width=32, fine_skips=(1,), samples_coarse=12, sample_scale=2,
                fine_bins_topk=3, occ_grid_size=8, occ_probes=8, occ_coarse_samples=6)
R, S = 7, 5


@pytest.fixture
def tracer():
    trace.reset()
    yield
    trace.reset()


def _inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    o = torch.randn(R, 3, generator=g) * 2.0
    d = torch.randn(R, 3, generator=g)
    z = 1.0 + 7.0 * torch.rand(R, S, generator=g).sort(-1).values
    basis16 = torch.nn.functional.pad(sh_basis(NC.sh_deg, d), (0, BASIS_LANES - 9))
    packs = pack_eval_params(init_nerf_params(NC, torch.Generator().manual_seed(seed), "cpu"), NC)
    feat = encode_kernel_order(ray_points(o, d, z).reshape(-1, 3), NC.emb_freqs_xyz)
    return packs, o, d, z, basis16, feat


@pytest.mark.parametrize("kernel", ["K1", "K2", "K4"])
def test_plain_route_is_encode_then_the_plain_body(tracer, kernel):
    """Each rays entry point on CPU tensors: the plain body on
    ``encode_kernel_order``'s features of ``o + d z``, the same bits, one
    ``encode.glue`` a call."""
    (pc, pf), o, d, z, basis16, feat = _inputs()
    if kernel == "K1":
        got = fused_mlp_apply_rays(pc, o, d, z, NC.coarse_depth, NC.coarse_skips)
        want = mlp_plain(pc, feat, NC.coarse_depth, NC.coarse_skips)
    elif kernel == "K2":
        got = fused_render_rays(pf, o, d, basis16, z, NC.fine_depth, NC.fine_skips, S, 9, True)
        want = fused_render_plain(pf, feat, basis16, z, None, None, NC.fine_depth, NC.fine_skips,
                                  S, 9, False, False, True)[0]
    else:
        got = fused_shaded_mlp_rays(pf, o, d, z, basis16, NC.fine_depth, NC.fine_skips, S, 9)
        want = fused_shaded_mlp(pf, feat, basis16, NC.fine_depth, NC.fine_skips, S, 9)
    assert torch.equal(got, want)
    assert trace.snapshot()["counters"] == {"encode.glue": 1}


def test_rays_entry_points_refuse_mismatched_shapes():
    """rays_o, rays_d [R, 3] and z [R, s], or a ValueError."""
    (pc, pf), o, d, z, basis16, _ = _inputs()
    with pytest.raises(ValueError, match="not \\[R, 3\\]"):
        fused_mlp_apply_rays(pc, o[:-1], d, z, NC.coarse_depth, NC.coarse_skips)
    with pytest.raises(ValueError, match="not \\[R, 3\\]"):
        fused_render_rays(pf, o, d, basis16, z, NC.fine_depth, NC.fine_skips, S + 1, 9)
    with pytest.raises(ValueError, match="not \\[R, 3\\]"):
        fused_shaded_mlp_rays(pf, o, d[:, :2], z, basis16, NC.fine_depth, NC.fine_skips, S, 9)


@pytest.mark.parametrize("mode,calls", [("importance", 2), ("culled", 2), ("grid", 2),
                                        ("coarse-free", 1)])
def test_eval_kernel_route_counts_the_glue_encode(tracer, mode, calls):
    """``render_rays_eval`` with a pack takes the rays entry points: on the
    CPU each is one ``encode.glue`` (the card's would be ``encode.kernel``)
    a pass, and the render is the plain-route render of the same
    kernels' arithmetic."""
    (packs, o, d, *_), fine_mode = _inputs(), "grid" if mode == "grid" else "importance"
    occ = (torch.ones(NC.occ_grid_size ** 2, NC.occ_grid_size, dtype=torch.bfloat16)
           if mode in ("culled", "coarse-free") else None)
    params = init_nerf_params(NC, torch.Generator().manual_seed(0), "cpu")
    out = render_rays_eval(params, d, o, NC, fine_mode=fine_mode, importance_samples=4,
                           packed=packs, occ=occ, coarse_free=mode == "coarse-free")
    assert all(torch.isfinite(t).all() for t in out)
    assert trace.snapshot()["counters"].get("encode.glue") == calls
    assert "encode.kernel" not in trace.snapshot()["counters"]


@pytest.mark.parametrize("fine_mode", ["importance", "grid"])
def test_training_render_still_passes_features(tracer, fine_mode, monkeypatch):
    """``render_rays_train`` on the kernel route hands ``fused_render`` /
    ``fused_shaded_mlp`` the encode's features, which carry the gradient to
    the rays; no rays entry point runs."""
    seen = []

    def spy(fn):
        def call(packed, feat, *a):
            seen.append((feat.shape[1], feat.requires_grad))
            return fn(packed, feat, *a)
        return call

    monkeypatch.setattr(nerf_module, "fused_render", spy(fused_render))
    monkeypatch.setattr(nerf_module, "fused_shaded_mlp", spy(fused_shaded_mlp))
    _, o, d, *_ = _inputs()
    o.requires_grad_(True)
    params = init_nerf_params(NC, torch.Generator().manual_seed(0), "cpu")
    draws = draw_render(R, NC, 4, False, torch.Generator().manual_seed(1), fine_mode)
    rgb_c, rgb_f = render_rays_train(params, d, o, draws, 0.5, NC, (0.0, 1.0), True,
                                     torch.float32, fine_mode, 4, use_kernels=True)
    (rgb_c.sum() + rgb_f.sum()).backward()
    assert seen == [(4 + 6 * NC.emb_freqs_xyz, True)] * 2
    assert o.grad is not None and bool(o.grad.abs().sum() > 0)
    assert "encode.glue" not in trace.snapshot()["counters"]
