"""The compiled epoch's CPU side, against the JAX package where it has a
counterpart: the RAdam update with its scalars on the device, the
progress clock from the device step counter, the epoch's loop against
steps taken by hand, and the buffers a captured step keeps reading: the
engine's occupancy map across a refresh, a checkpoint restore, and the
guard that refuses a rebound buffer.  On the CPU the epoch runs its step body as a loop; the graph
route against that loop, bit for bit, is in ``tests/test_torch_gpu.py``
(marker ``gpu``).  The route rule (one graph on one rank or over NCCL
ranks, the loop over gloo ranks) and ``Engine.close``, which releases
the step graphs before a group is destroyed, are held here too.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_nerf_tpu.train import optim as j_optim

from mc_nerf_torch.config import Config, NerfConfig, PathsConfig, StageConfig, TrainConfig
from mc_nerf_torch.data.synthetic import make_dataset
from mc_nerf_torch.models.camera_params import init_camera_params
from mc_nerf_torch.models.nerf import init_nerf_params
from mc_nerf_torch.ops.occupancy import sampler_map
from mc_nerf_torch.tools.scene import train_workload
from mc_nerf_torch.train import engine as t_engine
from mc_nerf_torch.train import optim as t_optim
from mc_nerf_torch.train import steps as t_steps
from mc_nerf_torch.train.checkpoint import Checkpointer

NERF_KW = dict(emb_freqs_xyz=4, coarse_depth=2, coarse_width=16, coarse_skips=(1,),
               fine_depth=2, fine_width=16, fine_skips=(1,), occ_grid_size=16,
               occ_coarse_samples=8, samples_coarse=16, sample_scale=2, fine_bins_topk=4)
H = W = 24


# ---------------------------------------------------------------- optimizer

def test_device_scalar_radam_matches_jax(rng):
    """Ten masked, clipped updates with the stage-1 schedule
    (``exponential_decay`` against the JAX ``lr1``), through the SGD
    fallback and across rho's threshold (first reached at count 6): the
    parameters after every update, and the moments and count after the
    last, within test_torch_train.py's 1e-6.  The count is a 0-d int32
    tensor, and the moments keep their buffers."""
    n = 301
    p0 = rng.normal(size=n).astype(np.float32)
    mask = (rng.random(n) < 0.7).astype(np.float32)
    init, floor, s1 = 0.1, 0.005, 40
    gamma = (floor / init) ** (1.0 / s1)
    jtx = j_optim.FlatRAdam(jnp.asarray(mask), lambda c: init * gamma ** c, 4e-4, clip=10.0)
    ttx = t_optim.FlatRAdam(torch.tensor(mask), t_optim.exponential_decay(init, gamma), 4e-4,
                            clip=10.0)
    jp, js = jnp.asarray(p0), jtx.init(jnp.asarray(p0))
    tp = torch.tensor(p0)
    ts = ttx.init(tp)
    bufs = (ts.mu.data_ptr(), ts.nu.data_ptr(), ts.count.data_ptr(), tp.data_ptr())
    b2 = j_optim.FlatRAdam.b2
    ro_inf = 2.0 / (1.0 - b2) - 1.0
    ro = [ro_inf - 2.0 * t * b2 ** t / (1.0 - b2 ** t) for t in range(1, 11)]
    assert [r >= 5.0 for r in ro] == [False] * 5 + [True] * 5
    for i in range(10):
        g = (rng.normal(size=n) * (30 if i == 0 else 1)).astype(np.float32)
        jp, js = jtx.update(jnp.asarray(g), js, jp)
        assert ttx.update(torch.tensor(g), ts, tp) is ts
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts.mu.numpy(), np.asarray(js.mu), atol=1e-6)
    np.testing.assert_allclose(ts.nu.numpy(), np.asarray(js.nu), atol=1e-6)
    assert ts.count.dtype == torch.int32 and ts.count.shape == () and int(ts.count) == 10
    assert (ts.mu.data_ptr(), ts.nu.data_ptr(), ts.count.data_ptr(), tp.data_ptr()) == bufs


def test_exponential_decay_matches_the_jax_schedule():
    """The device LR schedule against the JAX ``lr1`` at every count of a
    200-step stage, within 2 float32 ulps (rtol 2.4e-7): XLA's and
    torch's float32 ``pow`` round apart by one ulp at a few counts
    (measured: 1 of 201)."""
    init, gamma = 0.1, (0.005 / 0.1) ** (1.0 / 200)
    lr = t_optim.exponential_decay(init, gamma)
    counts = np.arange(201, dtype=np.float32)
    want = np.asarray(init * gamma ** jnp.asarray(counts))
    got = lr(torch.tensor(counts)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=0)


# ------------------------------------------------------------------ progress

@pytest.mark.parametrize("total", [40, 286000])
def test_progress_from_the_device_counter_matches_jax(total):
    """``progress`` of the int32 step counter, bit for bit the JAX
    ``step.astype(float32) / total_steps``, at every step of a 40-step
    schedule and at 2,001 steps across the protocol's 286,000."""
    steps = np.arange(total + 1) if total <= 40 else np.linspace(0, total, 2001).astype(np.int64)
    want = np.asarray(jnp.asarray(steps, jnp.int32).astype(jnp.float32) / total)
    got = np.array([float(t_steps.progress(torch.tensor(int(k), dtype=torch.int32), total))
                    for k in steps], np.float32)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------- epochs

def _workload(stage_cfg=None, **train):
    cfg = Config(stages=stage_cfg or StageConfig(),
                 train=TrainConfig(rays_per_batch=64, importance_samples=8, **train),
                 nerf=NerfConfig(**NERF_KW), compute_dtype="float32")
    params, data = train_workload(cfg, 0, "cpu", n_images=3, img_h=H, img_w=W)
    p_flat = t_optim.flatten_params(params)
    txs, states = t_optim.build_optimizers(cfg, params, p_flat, 10)
    return cfg, t_steps.TrainState(params, p_flat, states, t_optim.counter(5, "cpu")), data, txs


def _state_tensors(state, stage):
    o = state.opt_states[stage]
    return {"p_flat": state.p_flat, "mu": o.mu, "nu": o.nu, "count": o.count, "step": state.step}


@pytest.mark.parametrize("stage", [0, 1])
def test_epoch_loop_matches_steps_taken_by_hand(stage):
    """An epoch of 10 steps on CPU tensors (the loop route) ends on the
    p_flat, moments, count and step of 10 ``make_stage_step`` calls on
    ``draw_step``'s draws from the same seed, bit for bit, and its means
    (float64 sums read once, at the end) are those steps' metric means."""
    out = {}
    for by_hand in (False, True):
        cfg, state, data, txs = _workload()
        gen = torch.Generator().manual_seed(3)
        if by_hand:
            step = t_steps.make_stage_step(cfg, stage, txs[stage], H, W, 100)
            ms = [step(state, data, t_steps.draw_step(cfg, stage, data.images_u8.shape[0], H, W,
                                                        data.occ is not None, gen))
                  for _ in range(10)]
            means = {k: np.mean([float(m[k]) for m in ms]) for k in t_steps.METRICS}
        else:
            ep = t_steps.make_stage_epoch(cfg, stage, txs[stage], H, W, 100, 10)
            means = ep(state, data, gen)
            assert ep.counts == {"warmup": 0, "captured": 0, "replayed": 0, "looped": 10}
            assert not ep.uses_graph(state.p_flat.device)
        out[by_hand] = {k: v.clone() for k, v in _state_tensors(state, stage).items()}, means
    (a, ma), (b, mb) = out[False], out[True]
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert int(a["step"]) == 15 and int(a["count"]) == 10
    for k in t_steps.METRICS:
        np.testing.assert_allclose(float(ma[k]), mb[k], rtol=1e-6)


def test_epoch_graph_route_needs_cuda():
    """``graph=True`` on CPU tensors raises, and so does ``graph=True``
    over more than one rank whose collectives run on the host (no NCCL
    group here)."""
    cfg, state, data, txs = _workload()
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_steps.make_stage_epoch(cfg, 1, txs[1], H, W, 100, 2, graph=True)(
            state, data, torch.Generator())
    with pytest.raises(ValueError, match="collectives on the host"):
        t_steps.make_stage_epoch(cfg, 1, txs[1], H, W, 100, 2, world=2, graph=True)


ONE = "one CUDA graph of the step, captured once and replayed once a step"
OVER_NCCL = ("one CUDA graph of the step over 2 ranks, its collectives captured in it, "
             "captured once and replayed once a step")
ROUTES = {  # (world, backend, device, graph) -> the route, or the ValueError's words
    (1, None, "cuda", None): ONE,
    (1, None, "cpu", None): "the step as a loop (CPU tensors)",
    (1, None, "cuda", False): "the step as a loop (graph=False)",
    (2, "gloo", "cuda", None): "the step as a loop (2 gloo ranks: their collectives run on "
                               "the host)",
    (2, "gloo", "cuda", False): "the step as a loop (graph=False)",
    (2, "gloo", "cuda", True): ValueError("collectives on the host"),
    (2, "nccl", "cuda", None): OVER_NCCL,
    (2, "nccl", "cuda", True): OVER_NCCL,
    (2, "nccl", "cpu", None): "the step as a loop (CPU tensors)",
    (2, "nccl", "cpu", True): ValueError("CUDA tensors"),
}


@pytest.mark.parametrize("case", list(ROUTES), ids=lambda c: "-".join(map(str, c)))
def test_the_route_by_ranks_backend_and_device(monkeypatch, case):
    """The route an epoch takes, by world, backend, device and ``graph``:
    one graph on one rank or over NCCL ranks (their collectives captured
    in it), the loop on CPU tensors, over gloo ranks or with
    ``graph=False``; ``graph=True`` where no graph can hold the step
    raises.  The group is faked: only the rule is under test here."""
    world, backend, device, graph = case
    monkeypatch.setattr(t_steps, "world_size", lambda: world)
    monkeypatch.setattr(t_steps, "rank", lambda: 0)
    monkeypatch.setattr(t_steps, "collectives_capturable", lambda: backend == "nccl")
    cfg, state, data, txs = _workload()
    want, dev = ROUTES[case], torch.device(device)
    if isinstance(want, ValueError):
        with pytest.raises(ValueError, match=str(want)):
            t_steps.make_stage_epoch(cfg, 1, txs[1], H, W, 100, 2, world, graph).route(dev)
        return
    ep = t_steps.make_stage_epoch(cfg, 1, txs[1], H, W, 100, 2, world, graph)
    assert ep.route(dev) == want
    assert ep.uses_graph(dev) == want.startswith("one CUDA graph")


class _Graph:
    def __init__(self):
        self.resets = 0

    def reset(self):
        self.resets += 1


REBOUND = {
    "occ": lambda st, d, g: (st, d._replace(occ=d.occ.clone()), g),
    "generator": lambda st, d, g: (st, d, torch.Generator().manual_seed(3)),
    "p_flat": lambda st, d, g: (dataclasses.replace(st, p_flat=st.p_flat.clone()), d, g),
    "mu": lambda st, d, g: (dataclasses.replace(st, opt_states=tuple(
        dataclasses.replace(o, mu=o.mu.clone()) for o in st.opt_states)), d, g),
    "step": lambda st, d, g: (dataclasses.replace(st, step=st.step.clone()), d, g),
    "images_u8": lambda st, d, g: (st, d._replace(images_u8=d.images_u8.clone()), g),
}


@pytest.mark.parametrize("name", sorted(REBOUND))
def test_the_guard_refuses_a_rebound_buffer(name):
    """Bound to the buffers of a capture, the guard passes the same
    buffers and raises ``StaleGraphBuffer`` naming the one rebound (the
    map as ``data._replace(occ=...)`` once rebound it)."""
    cfg, state, data, txs = _workload()
    gen = torch.Generator().manual_seed(3)
    ep = t_steps.make_stage_epoch(cfg, 1, txs[1], H, W, 100, 2)
    ep.bind(state, data, gen)
    ep.check_buffers(state, data, gen)
    with pytest.raises(t_steps.StaleGraphBuffer, match=name):
        ep.check_buffers(*REBOUND[name](state, data, gen))


def test_checkpoint_restore_keeps_every_buffer(tmp_path):
    """A restore writes p_flat, every stage's moments and count and the
    step into the buffers the state holds (data_ptr unchanged), with the
    saved values exactly."""
    nc = NerfConfig(**NERF_KW)
    params = t_optim.Params(init_camera_params(3, "cpu"),
                            init_nerf_params(nc, torch.Generator().manual_seed(0), "cpu"))
    p_flat = t_optim.flatten_params(params)
    _, opts = t_optim.build_optimizers(Config(nerf=nc), params, p_flat, 10)
    state = t_steps.TrainState(params, p_flat, opts, t_optim.counter(7, "cpu"))
    gen = torch.Generator().manual_seed(1)
    tensors = [state.p_flat, state.step] + [t for o in opts for t in (o.mu, o.nu, o.count)]
    with torch.no_grad():
        for t in tensors:
            t.copy_(torch.randint(0, 1000, t.shape, generator=gen).to(t.dtype))
    saved = [t.clone() for t in tensors]
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(4, state)
    ptrs = [t.data_ptr() for t in tensors] + [p.data_ptr() for p in params.parameters()]
    with torch.no_grad():
        for t in tensors:
            t.zero_()
    _, epoch = ck.restore(state)
    assert epoch == 4
    assert [t.data_ptr() for t in tensors] + [p.data_ptr() for p in params.parameters()] == ptrs
    for t, s in zip(tensors, saved):
        assert torch.equal(t, s)


def _engine(tmp_path, stages: StageConfig) -> t_engine.Engine:
    """A CPU engine on a 2-view scene under ``tmp_path``, refreshing its
    map before every epoch."""
    d = str(tmp_path / "data" / "Tiny")
    make_dataset(d, n_train=2, n_val=1, n_test=1, img_h=H, img_w=W, seed=5)
    out = str(tmp_path / "out")
    cfg = Config(data_root=str(tmp_path / "data"), data_name="Tiny", stages=stages,
                 train=TrainConfig(rays_per_batch=64, importance_samples=8,
                                   steps_per_image_epoch=2, use_pallas=False),
                 nerf=NerfConfig(**NERF_KW, occ_warmup_steps=0, occ_update_every=1),
                 compute_dtype="float32", tensorboard=False,
                 paths=PathsConfig(root_weights=os.path.join(out, "w"),
                                   root_out=os.path.join(out, "r"),
                                   log_path=os.path.join(out, "log"),
                                   tb_path=os.path.join(out, "tb")))
    return t_engine.Engine(cfg, "cpu")


def test_engine_close_releases_every_step_graph(tmp_path):
    """``Engine.close`` releases each stage's step graph (``reset``, then
    dropped with its binding) and forgets the stages' epochs: none is
    left to hold a group's communicator.  Training again afterwards
    builds them anew."""
    eng = _engine(tmp_path, StageConfig(1, 1, 0))
    eng.train()
    eps = dict(eng._epoch_fns)
    assert sorted(eps) == [0, 1]
    graphs = {}
    for stage, ep in eps.items():      # stand-ins for the captures the card makes
        graphs[stage] = ep._cuda_graph = _Graph()
        ep.bind(eng.state, eng._data, eng._gen)
    eng.close()
    assert eng._epoch_fns == {}
    for stage, ep in eps.items():
        assert graphs[stage].resets == 1
        assert ep._cuda_graph is None and ep._captured == {} and ep._generator is None
    eng.close()                        # nothing left: a second close does nothing
    eng.train()
    assert sorted(eng._epoch_fns) == [0, 1]
    assert all(ep is not eps[s] for s, ep in eng._epoch_fns.items())


def test_engine_keeps_its_map_and_generator_across_refreshes(tmp_path, capfd):
    """Through ``Engine.train`` (0 + 3 + 0 epochs, no warm-up: a refresh
    before the first and after each): every epoch's step reads the one
    map buffer the first map was written into, and the one generator;
    each later refresh writes its map into that buffer; the route is
    logged once."""
    eng = _engine(tmp_path, StageConfig(0, 3, 0))
    cfg = eng.cfg
    seen, refreshed = [], []
    epoch_fn, refresh = eng._epoch_fn, eng._refresh_occupancy

    def spied_epoch_fn(stage):
        fn = epoch_fn(stage)

        def run(state, data, gen):
            seen.append((data.occ.data_ptr(), id(gen)))
            return fn(state, data, gen)
        return run

    def spied_refresh(epoch):
        refresh(epoch)
        refreshed.append((eng._occ_map.data_ptr(),
                          torch.equal(eng._occ_map, sampler_map(eng.occ_grid, cfg.nerf))))

    eng._epoch_fn, eng._refresh_occupancy = spied_epoch_fn, spied_refresh
    eng.train()
    assert len(seen) == 3 and len(refreshed) == 4
    assert len({p for p, _ in seen} | {p for p, _ in refreshed}) == 1
    assert len({g for _, g in seen}) == 1 and all(same for _, same in refreshed)
    routes = [line.split("] ", 1)[1] for line in capfd.readouterr().err.splitlines()
              if "] train steps:" in line]
    assert routes == ["train steps: the step as a loop (CPU tensors)"]
