"""The eval kernels' rays route on a CUDA card: K1 (``fused_mlp_apply_rays``),
K2 (``fused_render_rays``) and K4 (``fused_shaded_mlp_rays``) encode each
point in the forward kernel's prologue (``csrc/shaded_fwd.cuh``,
``encode_rows``) from the rays and depths, and must give the bits of their
feat entry points on ``encode_kernel_order``'s features of the same
points.  Planted faults of the encode (a row given its neighbour's ray,
an octave shifted, the pad lane set) change those bits; one 800x800 frame
through ``FrameRender``'s graph equals the same frame rendered chunk by
chunk through the feat entry points.

Every test is marked ``gpu`` and skips without a card.  The file imports
nothing of JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_encode_rays_gpu.py -q -s

The packs carry a live pad row (the first layer's and the skip layer's
weight row of lane 3 made non-zero), so that a pad lane the kernel did not
zero shows in the outputs: the packs ``pack_mlp_params`` makes give that
row zeros, which would hide it.
"""

import dataclasses

import pytest
import torch

from mc_nerf_torch.config import Config, NerfConfig
from mc_nerf_torch.models import nerf as nerf_module
from mc_nerf_torch.models.nerf import pack_eval_params
from mc_nerf_torch.models.sh import sh_basis
from mc_nerf_torch.ops.cuda.fused_mlp import (
    BASIS_LANES,
    ENC_PAD,
    PackedMLP,
    encode_kernel_order,
    fused_mlp_apply,
    fused_mlp_apply_rays,
    fused_shaded_mlp,
    fused_shaded_mlp_rays,
    pack_freqs,
    ray_points,
)
from mc_nerf_torch.ops.cuda.fused_render import fused_render, fused_render_rays
from mc_nerf_torch.tools.scene import orbit_views, scene_params
from mc_nerf_torch.utils import trace

NARROW = dict(emb_freqs_xyz=4, coarse_depth=2, coarse_width=32, coarse_skips=(1,),
              fine_depth=3, fine_width=64, fine_skips=(1,))
# the frame chunk less 3 rays: a partial last tile wherever s is not a
# multiple of 4
RAYS = 16381


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    return torch.device("cuda")


def _live_pad(packed: PackedMLP, skips) -> PackedMLP:
    """The pack with the pad lane's weight rows (layer 0's and each skip
    layer's feature block) set to seeded non-zero values."""
    g = torch.Generator(device=packed.head_w0.device).manual_seed(11)
    trunk = []
    for i, w in enumerate(packed.trunk_w):
        if i == 0 or i in skips:
            w = w.clone()
            w[ENC_PAD - 1] = (torch.rand(w.shape[1], generator=g, device=w.device) - 0.5).to(w.dtype)
        trunk.append(w)
    return packed._replace(trunk_w=tuple(trunk))


def _packs(nc: NerfConfig, dev):
    """(sigma-only coarse, full fine) packs of the seeded scene, pad rows live."""
    pc, pf = pack_eval_params(scene_params(nc, 0, device=dev), nc)
    return _live_pad(pc, nc.coarse_skips), _live_pad(pf, nc.fine_skips)


def _rays(rays: int, s: int, dev, seed: int = 0):
    """Seeded rays_o, rays_d [rays, 3] and sorted depths z [rays, s] in
    [1, 8]: origins about the scene's camera distance, an eighth of them
    300x farther out (octave 9 wraps ~10^5 times) and every 97th 10^5x
    (sinf's long-argument reduction)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    d = torch.randn(rays, 3, generator=g, device=dev)
    d = d / d.norm(dim=-1, keepdim=True)
    o = torch.tensor([0.0, 0.0, -4.0], device=dev) + 0.5 * torch.randn(rays, 3, generator=g,
                                                                       device=dev)
    o[::8] *= 300.0
    o[::97] *= 1e5 / 300.0
    z = 1.0 + 7.0 * torch.rand(rays, s, generator=g, device=dev).sort(-1).values
    return o.contiguous(), d.contiguous(), z.contiguous()


def _feat(packed, o, d, z):
    """The feat route's features: ``encode_kernel_order`` of the points."""
    return encode_kernel_order(ray_points(o, d, z).reshape(-1, 3), pack_freqs(packed))


def _basis16(nc, d):
    nb = (nc.sh_deg + 1) ** 2
    return torch.nn.functional.pad(sh_basis(nc.sh_deg, d), (0, BASIS_LANES - nb)).contiguous(), nb


def _same(label, a, b):
    """Bit equality, with where and how far the outputs differ if not."""
    if torch.equal(a, b):
        return
    diff = (a - b).abs().reshape(a.shape[0], -1).amax(1)
    rows = torch.nonzero(diff).flatten()
    pytest.fail(f"{label}: {rows.numel()} of {a.shape[0]} rows differ (first {rows[:8].tolist()}), "
                f"max abs {float(diff.max()):.3e}")


def _routes(kernel, nc, packs, rays, s, dev):
    """(the rays route's output, a function of features -> the feat
    route's output, the rays and depths) of one kernel at rays x s."""
    pc, pf = packs
    o, d, z = _rays(rays, s, dev)
    if kernel == "K1":
        return (fused_mlp_apply_rays(pc, o, d, z, nc.coarse_depth, nc.coarse_skips),
                lambda f: fused_mlp_apply(pc, f, nc.coarse_depth, nc.coarse_skips), pc, (o, d, z))
    basis16, nb = _basis16(nc, d)
    if kernel == "K2":
        return (fused_render_rays(pf, o, d, basis16, z, nc.fine_depth, nc.fine_skips, s, nb,
                                  nc.white_back),
                lambda f: fused_render(pf, f, basis16, z, None, None, nc.fine_depth,
                                       nc.fine_skips, s, nb, False, False, nc.white_back)[0],
                pf, (o, d, z))
    return (fused_shaded_mlp_rays(pf, o, d, z, basis16, nc.fine_depth, nc.fine_skips, s, nb),
            lambda f: fused_shaded_mlp(pf, f, basis16, nc.fine_depth, nc.fine_skips, s, nb),
            pf, (o, d, z))


# (kernel, rays, samples): the frame's eval chunks (K1 on the culled 48 and
# the grid's 128 coarse samples, K2 on 32 fine ones, K4 on the grid's 130)
# and a ragged one of each on the narrow widths (L = 4: lanes 28..31 pad)
CASES = [("K1", RAYS, 48, {}), ("K1", RAYS, 128, {}), ("K2", RAYS, 32, {}),
         ("K4", RAYS, 130, {}), ("K1", 53, 7, NARROW), ("K2", 53, 7, NARROW),
         ("K4", 53, 7, NARROW)]


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,rays,s,kw", CASES,
                         ids=[f"{k}-{r}x{s}-{'narrow' if kw else 'default'}"
                              for k, r, s, kw in CASES])
def test_rays_route_is_the_feat_route_bit_for_bit(cuda, kernel, rays, s, kw):
    """The kernel's own encode against ``encode_kernel_order`` + the feat
    entry point: the same bits, every row (a row of the last, partial tile
    included)."""
    nc = NerfConfig(**kw)
    with torch.no_grad():
        got, feat_route, packed, (o, d, z) = _routes(kernel, nc, _packs(nc, cuda), rays, s, cuda)
        want = feat_route(_feat(packed, o, d, z))
    torch.cuda.synchronize()
    print(f"measured {kernel} {rays} x {s}: rays route == feat route: {torch.equal(got, want)}")
    _same(f"{kernel} {rays} x {s}", got, want)


def _planted(packed, o, d, z):
    """Features of the encode with one fault each, from the plain encode."""
    s = z.shape[1]
    o_rows, d_rows = o.repeat_interleave(s, 0), d.repeat_interleave(s, 0)
    L = pack_freqs(packed)
    next_ray = encode_kernel_order(o_rows.roll(-1, 0) + d_rows.roll(-1, 0) * z.reshape(-1, 1), L)
    good = _feat(packed, o, d, z)
    shifted = good.clone()
    shifted[:, ENC_PAD + 6:] = good[:, ENC_PAD:-6]       # octave f's lanes hold f - 1's
    pad = good.clone()
    pad[:, ENC_PAD - 1] = 1.0
    return {"the ray index off by one row": next_ray, "an octave shifted": shifted,
            "the pad lane non-zero": pad}


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,s", [("K1", 48), ("K2", 32), ("K4", 130)])
def test_planted_encode_faults_break_the_bits(cuda, kernel, s):
    """Each planted fault of the encode, run through the feat route, moves
    the outputs away from the rays route's: the bit comparison catches
    it."""
    nc = NerfConfig()
    with torch.no_grad():
        got, feat_route, packed, (o, d, z) = _routes(kernel, nc, _packs(nc, cuda), RAYS, s, cuda)
        for name, feat in _planted(packed, o, d, z).items():
            bad = feat_route(feat)
            rows = int(((bad - got).abs().reshape(bad.shape[0], -1).amax(1) > 0).sum())
            print(f"measured {kernel} plant '{name}': {rows} of {bad.shape[0]} rows differ")
            assert rows > 0, f"{kernel}: the plant '{name}' left the outputs as they were"


def _feat_forms():
    """``models/nerf.py``'s rays entry points replaced by the feat route:
    ``encode_kernel_order`` of the points, then the feat entry point."""
    def mlp(packed, o, d, z, depth, skips):
        return fused_mlp_apply(packed, _feat(packed, o, d, z), depth, skips)

    def render(packed, o, d, basis16, z, depth, skips, s, nb, white_back=True):
        return fused_render(packed, _feat(packed, o, d, z), basis16, z, None, None, depth, skips,
                            s, nb, False, False, white_back)[0]

    def shaded(packed, o, d, z, basis16, depth, skips, s, nb):
        return fused_shaded_mlp(packed, _feat(packed, o, d, z), basis16, depth, skips, s, nb)

    return {"fused_mlp_apply_rays": mlp, "fused_render_rays": render,
            "fused_shaded_mlp_rays": shaded}


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["importance", "grid"])
def test_frame_graph_is_the_feat_frame(cuda, mode, monkeypatch):
    """One 800x800 frame of the seeded scene through ``FrameRender``'s
    graph (the rays route: a capture counts ``encode.kernel`` 80 and
    ``encode.glue`` 0, 2 more for the eager warm-up chunk, a replay none)
    equals, bit for bit, the frame rendered chunk by chunk with the feat
    entry points in their place.  Importance mode on a map refreshed from
    the scene (K1 on 48 culled samples, K2 on 32), and the grid (K1 on
    128, K4 on 130)."""
    from mc_nerf_torch.train.engine import refresh_occupancy
    from mc_nerf_torch.train.steps import make_render_fn

    cfg = Config()
    if mode == "grid":
        cfg = cfg.replace(eval=dataclasses.replace(cfg.eval, fine_mode="grid"))
    params = scene_params(cfg.nerf, 0, device=cuda)
    occ = refresh_occupancy(params, cfg, cuda, 0) if mode == "importance" else None
    poses, K = orbit_views((0.3,), 800, 800)
    pose = torch.as_tensor(poses[0], dtype=torch.float32, device=cuda)
    K = torch.as_tensor(K, dtype=torch.float32, device=cuda)
    graph = make_render_fn(cfg, 800, 800, device=cuda, graph=True)
    trace.reset()
    a = graph(params, pose, K, occ)
    first = dict(trace.snapshot()["counters"])
    b = graph(params, pose, K, occ)
    again = dict(trace.snapshot()["counters"])
    for name, fn in _feat_forms().items():
        monkeypatch.setattr(nerf_module, name, fn)
    loop = make_render_fn(cfg, 800, 800, device=cuda, graph=False)
    c = loop(params, pose, K, occ)
    graph.release()
    print(f"measured {mode} frame: encode counters {first}; rgb std {float(c[0].std()):.4f}")
    assert first.get("encode.kernel") == 82 and "encode.glue" not in first
    assert again.get("encode.kernel") == 82
    for x, y, z, name in zip(a, b, c, ("rgb", "depth", "opacity")):
        assert torch.equal(x, y), f"{mode}: the replay's {name} is not the capture's"
        _same(f"{mode} frame {name}", x.reshape(-1, 1), z.reshape(-1, 1))
    assert float(c[0].std()) > 0.01
