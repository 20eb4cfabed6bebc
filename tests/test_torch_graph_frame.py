"""The compiled frame's CPU side (``train/steps.py::FrameRender``), against
the JAX package where it has a counterpart.

The route rule (one CUDA graph of the frame on CUDA, the chunk loop on
the CPU or with ``graph=False``, ``graph=True`` on the CPU refused; the
world size does not enter), the graph key (one graph a map kind: none,
the bitpacked ``int32`` map, a ``[G*G, G]`` bf16 or int8 map), the frame
through the renderer against the JAX ``make_render_fn`` in the four eval
modes at a size whose pixels are not a multiple of the chunk (fp32 plain
routes, 1e-4), two frames in a row, ``Engine.demo`` through the engine's
own renderer and map against the JAX engine's demo, and ``Engine.close``
releasing the frame graphs.  The graph route against the loop, bit for
bit, is in ``tests/test_torch_gpu.py`` (marker ``gpu``).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_nerf_tpu import config as j_config
from mc_nerf_tpu.models.nerf import init_nerf_params as j_init_params
from mc_nerf_tpu.ops import occupancy as j_occ
from mc_nerf_tpu.train import engine as j_engine
from mc_nerf_tpu.train.steps import make_render_fn as j_make_render_fn

from mc_nerf_torch import config as t_config
from mc_nerf_torch.data.blender import _blender_pose_to_w2c_np
from mc_nerf_torch.data.synthetic import make_dataset
from mc_nerf_torch.models.nerf import nerf_params_from_numpy
from mc_nerf_torch.ops import occupancy as t_occ
from mc_nerf_torch.train import engine as t_engine
from mc_nerf_torch.train import steps as t_steps

CPU = "cpu"
NERF_KW = dict(samples_coarse=24, sample_scale=4, fine_bins_topk=6, emb_freqs_xyz=4,
               coarse_depth=2, coarse_width=16, coarse_skips=(1,), fine_depth=2,
               fine_width=32, fine_skips=(1,), occ_grid_size=32, occ_probes=32,
               occ_coarse_samples=16)
# 20 x 20 = 400 pixels in chunks of 128 rays: the fourth chunk is 112 rays of padding
HW, CHUNK = 20, 128


# --------------------------------------------------------------- the route

OVER_GRAPH = ("one CUDA graph of the frame (4 chunks of 128 rays), captured once a map kind "
              "and replayed once a frame")
ROUTES = {
    ("cuda", None): OVER_GRAPH,
    ("cuda", True): OVER_GRAPH,
    ("cuda", False): "the chunk loop (graph=False; 4 chunks of 128 rays)",
    ("cpu", None): "the chunk loop (CPU tensors; 4 chunks of 128 rays)",
    ("cpu", False): "the chunk loop (CPU tensors; 4 chunks of 128 rays)",
    ("cpu", True): ValueError("a CUDA graph needs CUDA tensors"),
}


@pytest.mark.parametrize("world,backend", [(1, None), (2, "gloo"), (2, "nccl")])
@pytest.mark.parametrize("case", list(ROUTES), ids=lambda c: "-".join(map(str, c)))
def test_the_route_by_device_and_graph(monkeypatch, case, world, backend):
    """The route a frame takes, by device and ``graph``: one graph on
    CUDA, the loop on the CPU or with ``graph=False``; ``graph=True`` on
    the CPU raises.  The frame has no collective: the world size and the
    backend (faked here) leave the rule as it is.  No card is touched:
    only the rule is under test."""
    device, graph = case
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(t_steps, "world_size", lambda: world)
    monkeypatch.setattr(t_steps, "collectives_capturable", lambda: backend == "nccl")
    cfg = t_config.Config(eval=t_config.EvalConfig(rays_per_chunk=CHUNK))
    want = ROUTES[case]
    if isinstance(want, ValueError):
        with pytest.raises(ValueError, match=str(want)):
            t_steps.make_render_fn(cfg, HW, HW, device=device, graph=graph)
        return
    render = t_steps.make_render_fn(cfg, HW, HW, device=device, graph=graph)
    assert render.route() == want
    assert render.uses_graph() == want.startswith("one CUDA graph")


# ----------------------------------------------------------- the graph key

def _map(kind, g=32):
    nc = t_config.NerfConfig(occ_grid_size=g, occ_map_dtype=kind if kind == "bitpack"
                             else "bfloat16")
    if kind == "int8":
        return torch.zeros((g * g, g), dtype=torch.int8)
    return t_occ.uniform_prior_map(nc, CPU)


KEYS = {
    "none": (None, ("none",)),
    "bitpack": (lambda: _map("bitpack"), ("torch.int32", (32 * 32, 1))),
    "bfloat16": (lambda: _map("bfloat16"), ("torch.bfloat16", (32 * 32, 32))),
    "bfloat16 G=16": (lambda: _map("bfloat16", 16), ("torch.bfloat16", (16 * 16, 16))),
    "int8": (lambda: _map("int8"), ("torch.int8", (32 * 32, 32))),
}


@pytest.mark.parametrize("kind", list(KEYS))
def test_one_graph_a_map_kind(kind):
    """The key a frame's graph is captured under: whether a map is given,
    and its dtype and shape (the JAX jit recompiles on the same); the
    map's values are not in it."""
    make, want = KEYS[kind]
    occ = None if make is None else make()
    assert t_steps.FrameRender.graph_key(occ) == want
    if occ is not None:
        assert t_steps.FrameRender.graph_key(occ + 1) == want
    others = [k for n, (_, k) in KEYS.items() if n != kind]
    assert want not in others


# ------------------------------------------------ the frame against JAX's

def _camera(h, w):
    c2w = np.array([[1, 0, 0, 0.3], [0, 0, -1, -4.0], [0, 1, 0, 0.2], [0, 0, 0, 1]],
                   np.float32)    # a Blender camera at y=-4 looking at +y
    f = (w / 2.0) / np.tan(0.35)
    return _blender_pose_to_w2c_np(c2w), np.array([[f, 0, w / 2.0], [0, f, h / 2.0],
                                                   [0, 0, 1]], np.float32)


def _density(g=32, seed=2):
    """A dense ball of random density plus sparse spots: both sides of the
    threshold, bit 31 of some bitpacked words set."""
    rng = np.random.default_rng(seed)
    c = (np.arange(g) + 0.5) / g * 7.0 - 3.5
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    ball = np.where(x * x + y * y + z * z < 2.0 ** 2, rng.uniform(0.0, 8.0, x.shape), 0.0)
    spots = np.where(rng.random(x.shape) < 0.03, rng.uniform(0.0, 20.0, x.shape), 0.0)
    return (ball + spots).astype(np.float32)


# mode -> (eval config changes, NeRF config changes, culled)
MODES = {
    "importance culled": ({}, {}, True),
    "importance unculled": ({}, {}, False),
    "grid": ({"fine_mode": "grid"}, {}, False),
    "coarse-free bitpack": ({}, {"coarse_free": True, "occ_map_dtype": "bitpack"}, True),
}


def _frame_cfgs(mode):
    ev_kw, nerf_kw, culled = MODES[mode]
    ev = dict(importance_samples=8, rays_per_chunk=CHUNK, use_pallas=False, **ev_kw)
    return [m.Config(nerf=m.NerfConfig(**NERF_KW, **nerf_kw), eval=m.EvalConfig(**ev),
                     compute_dtype="float32") for m in (j_config, t_config)] + [culled]


@pytest.mark.parametrize("mode", list(MODES))
def test_the_frame_matches_the_jax_render_fn(mode):
    """A 20x20 frame in chunks of 128 rays (the last chunk padded) through
    the renderer against the JAX ``make_render_fn``, plain routes in fp32:
    1e-4 on rgb, depth and opacity, the map the same bits on both sides."""
    jcfg, tcfg, culled = _frame_cfgs(mode)
    jp = j_init_params(jax.random.PRNGKey(0), jcfg.nerf)
    tp = nerf_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg.nerf, device=CPU)
    occ_j = occ_t = None
    if culled:
        dens = _density()
        occ_j = j_occ.binary_grid(j_occ.OccupancyGrid(jnp.asarray(dens)), jcfg.nerf)
        occ_t = t_occ.binary_grid(t_occ.OccupancyGrid(torch.as_tensor(dens)), tcfg.nerf)
        np.testing.assert_array_equal(np.asarray(occ_j).view(np.uint8),
                                      occ_t.view(torch.uint8).numpy())
    pose, K = _camera(HW, HW)
    want = j_make_render_fn(jcfg, HW, HW)(jp, jnp.asarray(pose), jnp.asarray(K), occ_j)
    render = t_steps.make_render_fn(tcfg, HW, HW, device=CPU)
    got = render(tp, pose, K, occ_t)
    assert render.counts == {"captured": 0, "replayed": 0, "looped": 1}
    for a, b in zip(got, want):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-4)


def test_a_second_frame_leaves_the_first_as_it_was():
    """Two frames in a row from one renderer, other poses and weights: the
    tensors of the first hold what they held, and equal a frame rendered
    alone; the second differs from the first."""
    _, tcfg, _ = _frame_cfgs("importance culled")
    tp = nerf_params_from_numpy(jax.tree.map(np.asarray, j_init_params(
        jax.random.PRNGKey(0), j_config.NerfConfig(**NERF_KW))), tcfg.nerf, device=CPU)
    occ = t_occ.binary_grid(t_occ.OccupancyGrid(torch.as_tensor(_density())), tcfg.nerf)
    pose, K = _camera(HW, HW)
    pose2 = pose.copy()
    pose2[:, 3] += np.float32(0.3)
    render = t_steps.make_render_fn(tcfg, HW, HW, device=CPU)
    first = render(tp, pose, K, occ)
    kept = [t.clone() for t in first]
    tp2 = nerf_params_from_numpy(jax.tree.map(np.asarray, j_init_params(
        jax.random.PRNGKey(1), j_config.NerfConfig(**NERF_KW))), tcfg.nerf, device=CPU)
    second = render(tp2, pose2, K, occ)
    alone = t_steps.make_render_fn(tcfg, HW, HW, device=CPU)(tp, pose, K, occ)
    for a, b, c in zip(first, kept, alone):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert not torch.equal(first[0], second[0])


# -------------------------------------------------------------- the engine

def _engine_cfgs(root, out):
    """The JAX engine test's tiny protocol on both sides (1 + 1 + 1 epochs,
    no warm-up: an epoch-0 demo culls), plain routes in fp32."""
    kw = dict(data_root=root, data_name="Tiny", compute_dtype="float32")

    def make(m, side, **extra):
        return m.Config(
            stages=m.StageConfig(1, 1, 1),
            train=m.TrainConfig(rays_per_batch=64, steps_per_image_epoch=2, use_pallas=False),
            nerf=m.NerfConfig(**{**NERF_KW, "occ_grid_size": 16}, occ_warmup_steps=0),
            eval=m.EvalConfig(res_h=HW, res_w=HW, rays_per_chunk=CHUNK, importance_samples=8,
                              use_pallas=False),
            paths=m.PathsConfig(root_weights=os.path.join(out, side, "weights"),
                                root_out=os.path.join(out, side, "results"),
                                log_path=os.path.join(out, side, "log"),
                                tb_path=os.path.join(out, side, "tb")),
            mode=1, **kw, **extra)

    return (make(j_config, "jax", parallel=j_config.ParallelConfig(data_parallel=1)),
            make(t_config, "port"))


def test_engine_demo_renders_through_its_own_renderer_and_map(tmp_path, monkeypatch):
    """``Engine.demo`` of one checkpoint on both sides (the port's state
    from the JAX engine's, the refresh's jitter from the JAX key): the
    port's views go through the engine's own renderer of their size, kept
    for the next frame, and its own map, refreshed fresh into
    ``Engine._occ_map`` (the JAX demo's ``self.occ_grid = None;
    self._refresh_occupancy(epoch)``); the scores are the JAX engine's
    within 1e-4 relative.  ``demo`` alone makes its own renderer."""
    root = str(tmp_path / "data")
    make_dataset(os.path.join(root, "Tiny"), n_train=3, n_val=1, n_test=2, img_h=HW, img_w=HW,
                 seed=7)
    jcfg, tcfg = _engine_cfgs(root, str(tmp_path / "out"))
    jeng = j_engine.Engine(jcfg)
    jeng.ckpt.save(0, jeng.state)
    jeng.ckpt.wait()
    want = jeng.demo(ckpt_epoch=0)

    def jitter(cfg, epoch, device):
        key = jax.random.fold_in(jax.random.PRNGKey(cfg.train.seed ^ 0x0CC), epoch)
        return torch.tensor(np.asarray(jax.random.uniform(key, (cfg.nerf.occ_grid_size ** 3,
                                                                 3))))

    monkeypatch.setattr(t_engine, "refresh_jitter", jitter)
    teng = t_engine.Engine(tcfg, device=CPU)
    init = jax.tree.map(np.asarray, (jeng.state.params, jeng.state.opt_states))
    teng.state = t_steps.train_state_from_numpy(*init, 0, tcfg, CPU)
    teng.ckpt.save(0, teng.state)
    renders, maps = [], []
    render_fn = teng._render_fn

    def spied(h, w):
        fn = render_fn(h, w)
        renders.append(fn)
        return fn

    demo = t_engine.demo
    monkeypatch.setattr(teng, "_render_fn", spied)
    monkeypatch.setattr(t_engine, "demo",
                        lambda *a, **kw: maps.append(kw["occ"]) or demo(*a, **kw))
    got = teng.demo(ckpt_epoch=0)
    assert got["count"] == want["count"] == 2
    for k in ("psnr", "ssim"):
        assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k]), (k, got[k], want[k])
    (render,) = renders
    assert teng._render_fns == {(HW, HW): render} and render.counts["looped"] == 2
    assert len(maps) == 1 and maps[0] is teng._occ_map and teng.occ_grid is not None
    assert torch.equal(teng._occ_map, t_engine.refresh_occupancy(
        teng.state.params.nerf, tcfg, CPU, 0))
    teng.demo(ckpt_epoch=0)         # the next demo: the same renderer again
    assert renders == [render, render] and render.counts["looped"] == 4
    made = []
    make = t_engine.make_render_fn
    monkeypatch.setattr(t_engine, "make_render_fn", lambda *a, **kw: made.append(a[1:3])
                        or make(*a, **kw))
    demo(teng.state.params.nerf, teng.scene.test, tcfg, CPU)
    assert made == [(HW, HW)]


class _Graph:
    def __init__(self):
        self.resets = 0

    def reset(self):
        self.resets += 1


def test_engine_close_releases_the_frame_graphs(tmp_path, capfd):
    """``Engine.close`` resets each renderer's frame graphs (stand-ins for
    the card's captures) and forgets the renderers; the next frame makes
    a renderer anew.  The frames' route is logged once, at the first."""
    root = str(tmp_path / "data")
    make_dataset(os.path.join(root, "Tiny"), n_train=3, n_val=1, n_test=1, img_h=HW, img_w=HW,
                 seed=7)
    _, tcfg = _engine_cfgs(root, str(tmp_path / "out"))
    eng = t_engine.Engine(dataclasses.replace(tcfg, mode=0), device=CPU)
    render = eng._render_fn(HW, HW)
    assert eng._render_fn(HW, HW) is render and eng._render_fn(8, 8) is not render
    graphs = {("none",): _Graph(), ("torch.bfloat16", (256, 16)): _Graph()}
    render._graphs = {k: (g, None, ()) for k, g in graphs.items()}
    render.pool = object()
    eng.close()
    assert eng._render_fns == {} and render._graphs == {} and render.pool is None
    assert [g.resets for g in graphs.values()] == [1, 1]
    eng.close()                      # nothing left: a second close does nothing
    assert [g.resets for g in graphs.values()] == [1, 1]
    assert eng._render_fn(HW, HW) is not render
    routes = [line.split("] ", 1)[1] for line in capfd.readouterr().err.splitlines()
              if "] frames:" in line]
    assert routes == ["frames: the chunk loop (CPU tensors; 4 chunks of 128 rays)"]
