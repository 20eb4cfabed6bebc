"""One frame split over the ranks (``train/steps.py::FrameRender`` with
``world`` > 1) against the JAX package's ``make_render_fn(mesh=...)``,
whose ``shard_map`` splits each chunk's rays over the devices of a mesh.

The chunk rule (pure arithmetic, no ranks): the chunk rounded up to a
multiple of the world size, as the JAX package rounds it
(``mc_nerf_tpu/train/steps.py:313-315``), each rank's rays of every chunk
the block ``P("data")`` gives its device, and the gathered frame put back
in pixel order, for worlds 1-8 and three chunk sizes.

The frames, on gloo CPU ranks (subprocesses with torchrun's environment,
one launch a world size; a file store under the test's tmp directory),
fp32 plain routes at tiny widths:
  * on 2 ranks, four eval modes (importance unculled and culled by a map,
    coarse-free on a bitpacked map, grid) against the JAX mesh render on
    2 devices: rgb and opacity 1e-4, depth 1e-3
    (``tests/test_torch_slice.py``'s bounds); both ranks' frames the same
    bits, and the bits of the port's one-process frame in chunks of half
    the size;
  * the grid cutoff planted: one chunk whose first block looks into
    empty space (its coarse weights all below ``weight_thresh``) and whose
    second looks into a dense half-space; each block selects against its
    own max, as under ``shard_map``, and a one-process frame at the full
    chunk (one cutoff for the chunk, what an all-rank max would give too)
    differs there, on both sides;
  * on 3 ranks, a chunk of 64 rays rounded to 66, against a 3-device mesh;
  * the engine on 2 ranks: both ranks render every validation frame and
    rank 0 alone scores and writes it; the demo of a checkpoint made from
    the JAX engine's state renders every view on both ranks, each view
    scored and written once, the same dict on both ranks, the scores of
    the JAX ``Engine(data_parallel=2)`` demo (its render mesh of 2 devices)
    within 1e-4 relative.
"""

import os
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from mc_nerf_tpu import config as j_config
from mc_nerf_tpu.models.nerf import init_nerf_params as j_init_params
from mc_nerf_tpu.ops import occupancy as j_occ
from mc_nerf_tpu.parallel.mesh import make_mesh
from mc_nerf_tpu.train import engine as j_engine
from mc_nerf_tpu.train.steps import make_render_fn as j_make_render_fn

from mc_nerf_torch import config as t_config
from mc_nerf_torch.data.blender import _blender_pose_to_w2c_np
from mc_nerf_torch.data.synthetic import make_dataset
from mc_nerf_torch.models.nerf import nerf_params_from_numpy
from mc_nerf_torch.ops import occupancy as t_occ
from mc_nerf_torch.parallel.dryrun import spawn_ranks
from mc_nerf_torch.train import engine as t_engine
from mc_nerf_torch.train import steps as t_steps

CPU = "cpu"
NERF_KW = dict(samples_coarse=24, sample_scale=4, fine_bins_topk=6, emb_freqs_xyz=4,
               coarse_depth=2, coarse_width=16, coarse_skips=(1,), fine_depth=2,
               fine_width=32, fine_skips=(1,), occ_grid_size=32, occ_probes=32,
               occ_coarse_samples=16)
# 20 x 20 = 400 pixels in chunks of 128 rays, 64 a rank: the fourth chunk's
# first block holds 16 pixels and 48 padding rays, its second only padding
HW, CHUNK, WORLD = 20, 128, 2
ATOL = {"rgb": 1e-4, "depth": 1e-3, "opacity": 1e-4}
# mode -> (eval config changes, NeRF config changes, culled)
MODES = {
    "importance unculled": ({}, {}, False),
    "importance culled": ({}, {}, True),
    "coarse-free bitpack": ({}, {"coarse_free": True, "occ_map_dtype": "bitpack"}, True),
    "grid": ({"fine_mode": "grid"}, {}, False),
}
# the grid plant: a 16 x 8 image, one chunk of 128 rays; its top half (rank
# 0's block) looks away from the dense half-space y > 0.6, its bottom half
# (rank 1's) into it
PLANT_H, PLANT_W = 8, 16
THREE = {"rays_per_chunk": 64, "world": 3}


# ------------------------------------------------------------ the chunk rule

def _jax_chunk(chunk: int, n: int) -> int:
    """The JAX package's rule (``mc_nerf_tpu/train/steps.py:313-315``)."""
    if chunk % n != 0:
        chunk = -(-chunk // n) * n
    return chunk


@pytest.mark.parametrize("rays_per_chunk", (64, 100, 16384))
@pytest.mark.parametrize("world", range(1, 9))
def test_the_chunk_rule_and_blocks_match_the_jax_mesh(monkeypatch, world, rays_per_chunk):
    """Each rank's renderer in a (faked) group of ``world``: the chunk, the
    chunk count and the padding the JAX render has on a ``world``-device
    mesh; the rays each rank renders of every chunk the rows ``P("data")``
    gives its device (the rays stand in by their index); the gathered
    frame every pixel in its place."""
    cfg = t_config.Config(eval=t_config.EvalConfig(use_pallas=False))
    chunk = _jax_chunk(rays_per_chunk, world)
    n_chunks = -(-HW * HW // chunk)
    mesh = make_mesh(world)
    blocks = NamedSharding(mesh, P("data")).devices_indices_map((chunk, 3))
    monkeypatch.setattr(t_steps, "world_size", lambda: world)
    monkeypatch.setattr(t_steps, "rays_for_pixels", lambda pix, pose, K: (
        torch.arange(pix.shape[0], dtype=torch.float32)[:, None].expand(-1, 3),) * 2)
    seen = []
    monkeypatch.setattr(t_steps, "render_rays_eval", lambda p, rd, ro, *a, **kw: (
        seen.append(rd[:, 0].long()) or (rd, rd[:, :1], rd[:, :1] + 1)))
    parts = []
    for r, dev in enumerate(mesh.devices):
        monkeypatch.setattr(t_steps, "rank", lambda r=r: r)
        render = t_steps.make_render_fn(cfg, HW, HW, rays_per_chunk, CPU, world=world)
        assert (render.chunk, render.n_chunks, render.padded, render.block) == (
            chunk, n_chunks, n_chunks * chunk, chunk // world)
        assert render.chunk == t_steps.split_chunk(rays_per_chunk, world)
        seen.clear()
        part = render._frame(None, None, None, None)
        rows = range(chunk)[blocks[dev][0]]
        assert [s.tolist() for s in seen] == [list(range(i + rows.start, i + rows.stop))
                                              for i in range(0, n_chunks * chunk, chunk)]
        parts.append(part)
    assert all(p.shape == (n_chunks * chunk // world, 5) for p in parts)
    monkeypatch.setattr(t_steps, "all_gather_blocks", lambda t: torch.cat(parts))
    frame = render._whole(parts[-1])
    pixels = torch.arange(HW * HW, dtype=torch.float32).reshape(HW, HW)
    assert torch.equal(frame[0], pixels[..., None].expand(HW, HW, 3))
    assert torch.equal(frame[1], pixels) and torch.equal(frame[2], pixels + 1)


@pytest.mark.parametrize("world,group", [(2, 3), (3, 2), (4, 1)])
def test_a_world_other_than_the_groups_is_refused(monkeypatch, world, group):
    """``world`` is 1 or the group's size: a frame cannot be split over
    more or fewer ranks than were launched; 1 renders whole frames."""
    monkeypatch.setattr(t_steps, "world_size", lambda: group)
    cfg = t_config.Config(eval=t_config.EvalConfig(rays_per_chunk=CHUNK))
    with pytest.raises(ValueError, match=f"split over {world} ranks in a group of {group}"):
        t_steps.make_render_fn(cfg, HW, HW, device=CPU, world=world)
    assert t_steps.make_render_fn(cfg, HW, HW, device=CPU).route() == (
        "the chunk loop (CPU tensors; 4 chunks of 128 rays)")


# ------------------------------------------------------------ the cases

def _camera(h, w):
    c2w = np.array([[1, 0, 0, 0.3], [0, 0, -1, -4.0], [0, 1, 0, 0.2], [0, 0, 0, 1]],
                   np.float32)    # a Blender camera at y=-4 looking at +y
    f = (w / 2.0) / np.tan(0.35)
    return _blender_pose_to_w2c_np(c2w), np.array([[f, 0, w / 2.0], [0, f, h / 2.0],
                                                   [0, 0, 1]], np.float32)


def _density(g=32, seed=2):
    """A dense ball of random density plus sparse spots."""
    rng = np.random.default_rng(seed)
    c = (np.arange(g) + 0.5) / g * 7.0 - 3.5
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    ball = np.where(x * x + y * y + z * z < 2.0 ** 2, rng.uniform(0.0, 8.0, x.shape), 0.0)
    spots = np.where(rng.random(x.shape) < 0.03, rng.uniform(0.0, 20.0, x.shape), 0.0)
    return (ball + spots).astype(np.float32)


def _dense_lower_half(mlp, in_dim):
    """The coarse MLP rebuilt so that its raw density is 100 relu(y) - 60:
    dense where y > 0.6, empty (weights below 1e-10 even with the last
    sample's 1e10 delta) where y < 0 (``tests/test_torch_parallel.py``'s
    half-space, on the y lane)."""
    w0 = np.zeros_like(mlp.trunk_w[0])
    w0[1, 0] = 1.0                              # relu(y), y the second encoded lane
    w1 = np.zeros_like(mlp.trunk_w[1])
    w1[in_dim, 0] = 1.0                         # the skip input is [enc | h]
    s0 = np.zeros_like(mlp.sigma_w0)
    s0[0, 0] = 1.0
    s1 = np.zeros_like(mlp.sigma_w1)
    s1[0, 0] = 100.0
    return mlp._replace(trunk_w=(w0, w1), trunk_b=tuple(np.zeros_like(b) for b in mlp.trunk_b),
                        sigma_w0=s0, sigma_b0=np.zeros_like(mlp.sigma_b0), sigma_w1=s1,
                        sigma_b1=np.full_like(mlp.sigma_b1, -60.0))


def _cfgs(ev_kw=None, nerf_kw=None, chunk=CHUNK):
    ev = dict(importance_samples=8, rays_per_chunk=chunk, use_pallas=False, **(ev_kw or {}))
    return [m.Config(nerf=m.NerfConfig(**NERF_KW, **(nerf_kw or {})), eval=m.EvalConfig(**ev),
                     compute_dtype="float32") for m in (j_config, t_config)]


def _case(jcfg, tcfg, h, w, culled, pose_K, plant=False):
    """(the JAX side: its config, size and render arguments; the port's
    case for the ranks)."""
    nerf = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0), jcfg.nerf))
    if plant:
        nerf = nerf._replace(coarse=_dense_lower_half(nerf.coarse, jcfg.nerf.embed_dim))
    occ_j = occ_t = None
    if culled:
        dens = _density()
        occ_j = j_occ.binary_grid(j_occ.OccupancyGrid(jnp.asarray(dens)), jcfg.nerf)
        occ_t = t_occ.binary_grid(t_occ.OccupancyGrid(torch.as_tensor(dens)), tcfg.nerf)
    pose, K = pose_K
    port = {"cfg": tcfg, "h": h, "w": w, "params": nerf_params_from_numpy(nerf, tcfg.nerf, CPU),
            "pose": pose, "K": K, "occ": occ_t}
    args = (jax.tree.map(jnp.asarray, nerf), jnp.asarray(pose), jnp.asarray(K), occ_j)
    return {"cfg": jcfg, "h": h, "w": w, "args": args}, port


def _plant_case():
    jcfg, tcfg = _cfgs({"fine_mode": "grid"})
    # w2c = [I | (0, 0, 4)]: the camera at z = -4 looking at +z, image rows
    # along y; the top half's rays go to y < 0, the bottom half's to y > 0
    pose = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 4.0]], np.float32)
    K = np.array([[4, 0, PLANT_W / 2], [0, 4, PLANT_H / 2], [0, 0, 1]], np.float32)
    return _case(jcfg, tcfg, PLANT_H, PLANT_W, False, (pose, K), plant=True)


_RANK = textwrap.dedent("""
    import json, os, sys
    import torch
    from mc_nerf_torch.models import nerf as nerf_module
    from mc_nerf_torch.parallel.distributed import initialize_distributed
    from mc_nerf_torch.train import engine as E
    from mc_nerf_torch.train.steps import make_render_fn

    work = sys.argv[1]
    topo = initialize_distributed(device="cpu", init_method=f"file://{work}/store")
    maxima, select = [], nerf_module.select_fine_bins

    def spy(weights, *a):
        maxima.append(float(weights.max()))
        return select(weights, *a)

    nerf_module.select_fine_bins = spy
    out = {}
    for name, c in torch.load(f"{work}/cases.pt", weights_only=False).items():
        split = make_render_fn(c["cfg"], c["h"], c["w"], device="cpu", world=topo.world)
        maxima.clear()
        frame = split(c["params"], c["pose"], c["K"], c["occ"])
        block_max = list(maxima)
        # the one-process frame in chunks of a block, under the group
        one = make_render_fn(c["cfg"], c["h"], c["w"], rays_per_chunk=split.block, device="cpu")
        out[name] = {"frame": frame, "one": one(c["params"], c["pose"], c["K"], c["occ"]),
                     "route": split.route(), "counts": dict(split.counts),
                     "chunk": split.chunk, "block_max": block_max}
    nerf_module.select_fine_bins = select

    engine = os.path.join(work, "engine.pt")
    if os.path.exists(engine):
        cfgs = torch.load(engine, weights_only=False)
        scored, written = [], []
        score = E.Engine._score_validation

        def scored_once(self, epoch, *a):
            scored.append(epoch)
            return score(self, epoch, *a)

        E.Engine._score_validation = scored_once
        eng = E.Engine(cfgs["train"], "cpu")
        eng.train()
        out["validation"] = {
            "scored": scored, "renders": {k: dict(r.counts) for k, r in eng._render_fns.items()},
            "routes": [r.route() for r in eng._render_fns.values()],
            "scores": [sorted(k for k in h if k.startswith("val_")) for h in eng.history]}
        jitter = torch.load(os.path.join(work, "jitter.pt"))
        E.refresh_jitter = lambda cfg, epoch, device: jitter[epoch]
        write = E._write_pngs
        E._write_pngs = lambda dirs, i, *a: (written.append(i), write(dirs, i, *a))[1]
        eng = E.Engine(cfgs["demo"], "cpu")
        out["demo"] = eng.demo(ckpt_epoch=0)
        out["demo_written"] = written
        out["demo_renders"] = {k: dict(r.counts) for k, r in eng._render_fns.items()}
    torch.save(out, f"{work}/rank{topo.rank}.pt")
    torch.distributed.destroy_process_group()
    print(json.dumps({"rank": topo.rank, "backend": topo.backend}))
""")


def _spawn(work, world, cases):
    torch.save(cases, work / "cases.pt")
    spawn_ranks(world, ["-c", _RANK, str(work)], str(work), env={"OMP_NUM_THREADS": "1"},
                timeout=300)
    return [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _engine_cfgs(root, out):
    """The tiny protocol of ``tests/test_torch_graph_frame.py`` (1 + 1 + 1
    epochs, no warm-up: an epoch-0 demo culls), plain routes in fp32."""
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
            data_root=root, data_name="Tiny", compute_dtype="float32", mode=1, **extra)

    return (make(j_config, "jax", parallel=j_config.ParallelConfig(data_parallel=WORLD)),
            make(t_config, "port"), make(t_config, "train").replace(mode=0))


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    """Every 2-rank case in one launch: the four modes, the grid plant and
    the engine; and the JAX side of each."""
    work = tmp_path_factory.mktemp("two")
    jax_side, cases = {}, {}
    for mode, (ev_kw, nerf_kw, culled) in MODES.items():
        jcfg, tcfg = _cfgs(ev_kw, nerf_kw)
        jax_side[mode], cases[mode] = _case(jcfg, tcfg, HW, HW, culled, _camera(HW, HW))
    jax_side["plant"], cases["plant"] = _plant_case()

    root = str(tmp_path_factory.mktemp("data"))
    make_dataset(os.path.join(root, "Tiny"), n_train=3, n_val=1, n_test=3, img_h=HW, img_w=HW,
                 seed=7)
    jcfg, tcfg, train_cfg = _engine_cfgs(root, str(work / "out"))
    jeng = j_engine.Engine(jcfg)
    jeng.ckpt.save(0, jeng.state)
    jeng.ckpt.wait()
    want_demo = jeng.demo(ckpt_epoch=0)
    key = jax.random.fold_in(jax.random.PRNGKey(tcfg.train.seed ^ 0x0CC), 0)
    torch.save({0: torch.tensor(np.asarray(jax.random.uniform(
        key, (tcfg.nerf.occ_grid_size ** 3, 3))))}, work / "jitter.pt")
    teng = t_engine.Engine(tcfg, device=CPU)
    teng.state = t_steps.train_state_from_numpy(*jax.tree.map(np.asarray, (
        jeng.state.params, jeng.state.opt_states)), 0, tcfg, CPU)
    teng.ckpt.save(0, teng.state)
    torch.save({"train": train_cfg, "demo": tcfg}, work / "engine.pt")
    ranks = _spawn(work, WORLD, cases)
    return {"jax": jax_side, "cases": cases, "ranks": ranks, "want_demo": want_demo,
            "train_cfg": train_cfg, "demo_cfg": tcfg}


def _jax_frame(side, n_devices=None):
    """The JAX render of a case, on an ``n_devices`` mesh or on one device."""
    mesh = make_mesh(n_devices) if n_devices else None
    return j_make_render_fn(side["cfg"], side["h"], side["w"], mesh=mesh)(*side["args"])


def _close(got, want):
    for g, w, name in zip(got, want, ATOL):
        assert tuple(g.shape) == tuple(w.shape), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL[name],
                                   err_msg=name)


@pytest.mark.parametrize("mode", list(MODES) + ["plant"])
def test_the_split_frame_matches_the_jax_mesh_render(two, mode):
    """Each rank's frame against the JAX ``make_render_fn`` on a 2-device
    mesh, fp32 plain routes (the plant: the grid mode whose blocks select
    against cutoffs on either side of ``weight_thresh``)."""
    want = _jax_frame(two["jax"][mode], WORLD)
    for r in two["ranks"]:
        _close(r[mode]["frame"], want)


@pytest.mark.parametrize("mode", list(MODES) + ["plant"])
def test_the_ranks_render_the_one_process_frame_in_chunks_of_a_block(two, mode):
    """Both ranks' frames the same bits, and the bits of the port's
    one-process frame (no collective, under the group) in chunks of half
    the size: the split puts the same rays in the same groups.  The loop
    ran once a frame, split over the 2 ranks."""
    r0, r1 = (r[mode] for r in two["ranks"])
    for a, b, c in zip(r0["frame"], r1["frame"], r0["one"]):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert all(torch.equal(a, b) for a, b in zip(r0["one"], r1["one"]))
    n_chunks = 4 if mode != "plant" else 1
    assert r0["route"] == r1["route"] == (
        f"the chunk loop (CPU tensors; {n_chunks} chunks of {CHUNK} rays); split over 2 ranks, "
        "one all-gather a frame")
    assert r0["counts"] == r1["counts"] == {"captured": 0, "replayed": 0, "looped": 1}


def test_the_grid_cutoff_is_each_blocks_own(two):
    """The plant: rank 0's block's coarse maximum lies below
    ``weight_thresh`` and rank 1's above it, so each block selects
    against its own max, as ``shard_map``'s blocks do; a frame with one
    cutoff for the whole chunk (one process at the full chunk, on both
    sides) differs from the split frame."""
    r0, r1 = (r["plant"] for r in two["ranks"])
    thresh = two["cases"]["plant"]["cfg"].nerf.weight_thresh
    (m0,), (m1,) = r0["block_max"], r1["block_max"]
    assert m0 < thresh <= m1, (m0, m1)
    c = two["cases"]["plant"]
    whole = t_steps.make_render_fn(c["cfg"], PLANT_H, PLANT_W, device=CPU)(
        c["params"], c["pose"], c["K"], None)
    assert not all(torch.equal(a, b) for a, b in zip(whole, r0["frame"]))
    gap = [float((a - b).abs().max()) for a, b in zip(whole, r0["frame"])]
    assert max(gap) > 1e-2, gap
    # the same on the JAX side: the mesh's blocks against one device's chunk
    mesh, one = _jax_frame(two["jax"]["plant"], WORLD), _jax_frame(two["jax"]["plant"])
    assert max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
               for a, b in zip(mesh, one)) > 1e-2
    _close(whole, one)


def test_a_world_of_three_matches_a_three_device_mesh(tmp_path):
    """3 ranks, 64 rays a chunk rounded to 66 (7 chunks of 22-ray blocks),
    importance unculled: the JAX render on a 3-device mesh; the ranks'
    frames the same bits, those of one process in chunks of 22."""
    jcfg, tcfg = _cfgs(chunk=THREE["rays_per_chunk"])
    side, case = _case(jcfg, tcfg, HW, HW, False, _camera(HW, HW))
    ranks = _spawn(tmp_path, THREE["world"], {"three": case})
    want = _jax_frame(side, THREE["world"])
    for r in ranks:
        x = r["three"]
        assert x["chunk"] == 66
        _close(x["frame"], want)
        for a, b, c in zip(x["frame"], ranks[0]["three"]["frame"], ranks[0]["three"]["one"]):
            assert torch.equal(a, b) and torch.equal(a, c)
    assert ranks[0]["three"]["route"] == (
        "the chunk loop (CPU tensors; 7 chunks of 66 rays); split over 3 ranks, one all-gather "
        "a frame")


# -------------------------------------------------------------- the engine

def test_every_rank_renders_validation_and_rank_0_scores_it_once(two):
    """The engine on 2 ranks (1 + 1 + 1 epochs): both ranks render the
    validation frame of each NeRF epoch through the engine's renderer,
    split over them; rank 0 alone scores it, writes its PNGs and keeps
    its scores in the history."""
    r0, r1 = (r["validation"] for r in two["ranks"])
    assert r0["scored"] == [1, 2] and r1["scored"] == []
    assert r0["renders"] == r1["renders"] == {
        (HW, HW): {"captured": 0, "replayed": 0, "looped": 2}}
    assert r0["routes"] == r1["routes"] == [
        "the chunk loop (CPU tensors; 4 chunks of 128 rays); split over 2 ranks, one all-gather "
        "a frame"]
    assert r0["scores"] == [[], ["val_lpips", "val_psnr", "val_ssim"],
                            ["val_lpips", "val_psnr", "val_ssim"]]
    assert r1["scores"] == [[], [], []]
    out = os.path.join(two["train_cfg"].paths.render_dir, "Tiny")
    assert sorted(n for n in os.listdir(out) if n.startswith("epoch_")) == [
        f"epoch_{e}{s}.png" for e in (1, 2) for s in ("", "_depth", "_gt")]


def test_the_split_demo_matches_the_jax_mesh_demo(two):
    """``Engine.demo`` of one checkpoint (the JAX engine's state) on 2
    ranks: every view rendered on both ranks through the engine's split
    renderer, rank ``i % 2`` alone scoring and writing view ``i``, the
    same dict on both ranks, the JAX ``Engine(data_parallel=2)`` demo's
    scores (its frames split over a 2-device render mesh) within 1e-4
    relative."""
    r0, r1 = two["ranks"]
    want = two["want_demo"]
    assert r0["demo"] == r1["demo"]
    assert r0["demo_written"] == [0, 2] and r1["demo_written"] == [1]
    assert r0["demo_renders"] == r1["demo_renders"] == {
        (HW, HW): {"captured": 0, "replayed": 0, "looped": 3}}
    got = r0["demo"]
    assert got["count"] == want["count"] == 3
    for k in ("psnr", "ssim"):
        assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k]), (k, got[k], want[k])
    pngs = sorted(os.listdir(os.path.join(got["out_dir"], "pred")))
    assert pngs == ["0000.png", "0001.png", "0002.png"]
