"""The port's tracer (``mc_nerf_torch/utils/trace.py``) and what reads it.

On the CPU: spans' parents, self time, units, tags and descendants;
counters; medians over a bounded window; ``reset``; device intervals
resolved lazily from their events (fake events here); no
``record_function`` range without a profiler, and under a CPU
``torch.profiler`` the ``mcn.*`` ranges inside the range opened around
them; the loop route's ``frame.loop`` and ``epoch.loop``; the engine's
spans and its ``history`` fields; the benchmark's five readers of the
spans over a seeded snapshot, and None where their span is absent or the
program loaded no tracer.

Marked ``gpu`` (the card): a graph-route frame and epoch under the
benchmark's profiler, with no device operation named ``mcn.``, and the
``frame.caller`` interval resolving without a synchronize.  The file
imports nothing of JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_trace.py -q
"""

import os
import sys

import numpy as np
import pytest
import torch

from mc_nerf_torch.config import (
    Config,
    EvalConfig,
    NerfConfig,
    PathsConfig,
    StageConfig,
    TrainConfig,
)
from mc_nerf_torch.data.synthetic import make_dataset
from mc_nerf_torch.models.nerf import init_nerf_params
from mc_nerf_torch.tools.scene import train_workload
from mc_nerf_torch.train import engine as t_engine
from mc_nerf_torch.train import optim as t_optim
from mc_nerf_torch.train import steps as t_steps
from mc_nerf_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.metrics import _spans  # noqa: E402
from portbench.run import read_metric  # noqa: E402

NERF_KW = dict(emb_freqs_xyz=4, coarse_depth=2, coarse_width=16, coarse_skips=(1,),
               fine_depth=2, fine_width=16, fine_skips=(1,), occ_grid_size=16,
               occ_coarse_samples=8, samples_coarse=16, sample_scale=2, fine_bins_topk=4)
H = W = 24


class Clock:
    """A stand-in for ``time.perf_counter``: each call returns the next
    of the times given."""

    def __init__(self, *times):
        self.times = list(times)

    def __call__(self):
        return self.times.pop(0)


@pytest.fixture
def tracer():
    """A global tracer emptied before and after the test."""
    trace.reset()
    yield trace.TRACER
    trace.reset()


# ------------------------------------------------------------------ spans

def test_spans_record_parents_self_time_units_and_tags(monkeypatch):
    """An outer span of 10 s holding two children of 2 and 3 s, one of
    which holds a grandchild of 1 s: the outer's self time is 5 s, the
    first child's 1 s; each span names its parent; units add up; the
    newest occurrence's tags are kept; ``within`` sums the descendants by
    name."""
    tr = trace.Tracer()
    # opened and closed: outer, a, g, g, a, a again, a, outer
    monkeypatch.setattr(trace.time, "perf_counter", Clock(0.0, 1.0, 1.5, 2.5, 3.0, 4.0, 7.0,
                                                          10.0))
    with tr.span("outer", stage=1) as outer:
        with tr.span("a", units=4, frame=3) as a:
            with tr.span("g"):
                pass
        with tr.span("a", units=2, frame=4):
            pass
    snap = tr.snapshot()["spans"]
    assert (outer.seconds, outer.self_seconds) == (10.0, 5.0)
    assert (a.seconds, a.self_seconds) == (2.0, 1.0)
    assert snap["outer"] == {"count": 1, "total_s": 10.0, "self_s": 5.0, "units": 0,
                             "median_s": 10.0, "median_unprofiled_s": 10.0, "parents": [""],
                             "last": {"stage": 1}}
    assert snap["a"]["count"] == 2 and snap["a"]["total_s"] == 5.0
    assert snap["a"]["self_s"] == 4.0 and snap["a"]["units"] == 6
    assert snap["a"]["parents"] == ["outer"] and snap["a"]["last"] == {"frame": 4}
    assert snap["g"]["parents"] == ["a"] and snap["g"]["self_s"] == 1.0
    assert outer.within == {"a": 5.0, "g": 1.0} and a.within == {"g": 1.0}


def test_a_span_closes_on_an_exception():
    """A span left by an exception records, and the next span has no
    stale parent."""
    tr = trace.Tracer()
    with pytest.raises(ValueError):
        with tr.span("failing"):
            raise ValueError("inside")
    with tr.span("next"):
        pass
    snap = tr.snapshot()["spans"]
    assert snap["failing"]["count"] == 1 and snap["next"]["parents"] == [""]


def test_counters_medians_bounded_memory_and_reset():
    """Counters add; a name's median is over its newest ``WINDOW``
    durations and memory holds no more; ``reset`` forgets everything."""
    tr = trace.Tracer()
    tr.count("graph.captures")
    tr.count("graph.captures")
    tr.count("kernels.built", 5)
    n = trace.WINDOW + 100
    for i in range(n):
        tr._add_interval("x", float(i))
    st = tr._intervals["x"]
    assert st.count == n and len(st.recent) == trace.WINDOW
    snap = tr.snapshot()
    assert snap["counters"] == {"graph.captures": 2, "kernels.built": 5}
    assert snap["intervals"]["x"]["median_s"] == float(np.median(np.arange(100, n)))
    assert snap["intervals"]["x"]["total_s"] == sum(range(n))
    tr.reset()
    assert tr.snapshot() == {"spans": {}, "counters": {}, "intervals": {}}


class FakeEvent:
    """A timing event that completes when the test says so."""

    def __init__(self):
        self.t, self.done = None, False

    def record(self, stream=None):
        self.t, self.done = FakeEvent.now, False

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert end.done           # the start precedes the end on the stream
        return (end.t - self.t) * 1e3

    def synchronize(self):
        self.done = True


def test_device_intervals_resolve_lazily_and_reuse_their_events(monkeypatch):
    """An interval closed before its end event has completed stays
    pending (nothing waits for it); it resolves at a later close or a
    snapshot once ``query()`` says so; ``snapshot(sync=True)`` waits for
    the rest.  Resolved events go back to the pool; a close with no open
    interval records nothing."""
    made = []

    def event():
        made.append(FakeEvent())
        return made[-1]

    tr = trace.Tracer()
    monkeypatch.setattr(trace.torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(trace.torch.cuda, "Event", lambda enable_timing: event())
    tr.interval_end("frame.caller", "cuda")           # the first frame: none open
    assert made == [] and tr.snapshot()["intervals"] == {}
    for k, (t0, t1) in enumerate(((1.0, 1.002), (2.0, 2.005), (3.0, 3.001))):
        FakeEvent.now = t0
        tr.interval_start("frame.caller", "cuda")
        FakeEvent.now = t1
        tr.interval_end("frame.caller", "cuda")
        if k == 0:
            assert len(tr._pending) == 1 and tr.snapshot()["intervals"] == {}
        for ev in made:
            ev.done = True
    tr.interval_start("frame.caller", "cuda")         # an open one: not an interval yet
    snap = tr.snapshot()["intervals"]["frame.caller"]
    assert snap["count"] == 3 and snap["median_s"] == pytest.approx(0.002)
    assert len(made) <= 5                             # 7 records, events reused
    FakeEvent.now = 4.0
    tr.interval_end("frame.caller", "cuda")
    assert tr._pending and tr.snapshot(sync=True)["intervals"]["frame.caller"]["count"] == 4


def test_no_range_without_a_profiler(monkeypatch):
    """With no profiler recording, a span opens no ``record_function``
    range."""
    opened = []
    monkeypatch.setattr(trace._autograd_profiler, "record_function",
                        lambda *a: opened.append(a))
    tr = trace.Tracer()
    with tr.span("frame.launch", frame=0):
        pass
    assert opened == [] and not trace._autograd_profiler._is_profiler_enabled


def test_spans_lie_inside_the_enclosing_range_on_the_profilers_clock():
    """Under a CPU ``torch.profiler``, each span is a ``mcn.<name>`` range
    (tags as its args) lying inside the range opened around it, and a
    child's range inside its parent's."""
    from torch.profiler import ProfilerActivity, profile, record_function

    tr = trace.Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outside"):
            with tr.span("epoch.launch", stage=1):
                with tr.span("kernels.load"):
                    torch.ones(8).sum()
    ranges = {e.name: e.time_range for e in prof.events()
              if e.name in ("outside", "mcn.epoch.launch", "mcn.kernels.load")}
    assert len(ranges) == 3
    for inner, outer in (("mcn.epoch.launch", "outside"),
                         ("mcn.kernels.load", "mcn.epoch.launch")):
        assert ranges[outer].start <= ranges[inner].start <= ranges[inner].end \
            <= ranges[outer].end, (inner, outer)
    assert tr.snapshot()["spans"]["kernels.load"]["parents"] == ["epoch.launch"]


def test_durations_after_a_profiler_are_kept_apart():
    """Once a span has opened under a profiler, later durations count in
    the median but not in the median before any profiler, through a
    ``reset`` too (the process's launches stay slower)."""
    from torch.profiler import ProfilerActivity, profile

    tr = trace.Tracer()
    with tr.span("frame.launch"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with tr.span("frame.launch"):
            pass
    assert tr.profiled
    tr.reset()
    with tr.span("frame.launch"):
        pass
    s = tr.snapshot()["spans"]["frame.launch"]
    assert s["count"] == 1 and s["median_s"] > 0 and s["median_unprofiled_s"] is None


def test_the_table_names_spans_counters_and_intervals():
    tr = trace.Tracer()
    with tr.span("engine.epoch"):
        with tr.span("engine.steps"):
            pass
    tr.count("graph.captures")
    tr._add_interval("frame.caller", 0.003)
    text = tr.table()
    for name in ("engine.epoch", "engine.steps", "graph.captures", "frame.caller"):
        assert name in text
    assert "engine.epoch" in text.splitlines()[2]       # the child's row, its parent named


# --------------------------------------------------------- the loop route

def test_the_loop_routes_frame_and_epoch_spans(tracer):
    """On the CPU a frame is one ``frame.loop`` span (a frame a unit,
    tagged with the renderer's frame number) and an epoch one
    ``epoch.loop`` (a step a unit, tagged with the stage); the graph
    route's spans, captures and intervals do not occur, nor a kernel
    build: the one counter is ``sample_pdf.plain``, the inverse-CDF
    draws taking the plain body on CPU tensors."""
    cfg = Config(nerf=NerfConfig(**NERF_KW), eval=EvalConfig(rays_per_chunk=128,
                 importance_samples=8, use_pallas=False), compute_dtype="float32",
                 train=TrainConfig(rays_per_batch=64, importance_samples=8))
    params = init_nerf_params(cfg.nerf, torch.Generator().manual_seed(0), "cpu")
    render = t_steps.make_render_fn(cfg, 12, 12, device="cpu")
    pose = torch.tensor([[1.0, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 4.0]])
    K = torch.tensor([[10.0, 0, 6], [0, 10.0, 6], [0, 0, 1]])
    for _ in range(2):
        render(params, pose, K)
    tparams, data = train_workload(cfg, 0, "cpu", n_images=2, img_h=H, img_w=W)
    p_flat = t_optim.flatten_params(tparams)
    txs, opt = t_optim.build_optimizers(cfg, tparams, p_flat, 10)
    state = t_steps.TrainState(tparams, p_flat, opt, t_optim.counter(0, "cpu"))
    t_steps.make_stage_epoch(cfg, 1, txs[1], H, W, 100, 3)(state, data,
                                                           torch.Generator().manual_seed(1))
    snap = trace.snapshot()
    assert snap["spans"]["frame.loop"]["count"] == 2 and snap["spans"]["frame.loop"]["units"] == 2
    assert snap["spans"]["frame.loop"]["last"] == {"frame": 1}
    assert snap["spans"]["epoch.loop"]["units"] == 3
    assert snap["spans"]["epoch.loop"]["last"] == {"stage": 1}
    assert set(snap["spans"]) == {"frame.loop", "epoch.loop"}
    assert set(snap["counters"]) == {"sample_pdf.plain"} and snap["intervals"] == {}
    assert snap["counters"]["sample_pdf.plain"] > 0


def _engine(tmp_path) -> t_engine.Engine:
    """A CPU engine on a 2-view scene: 2 CAM_PARAM epochs (a camera
    restart between them) and 1 GLOBAL_OPTIM epoch, its map refreshed."""
    d = str(tmp_path / "data" / "Tiny")
    make_dataset(d, n_train=2, n_val=1, n_test=1, img_h=H, img_w=W, seed=5)
    out = str(tmp_path / "out")
    cfg = Config(data_root=str(tmp_path / "data"), data_name="Tiny", stages=StageConfig(2, 1, 0),
                 train=TrainConfig(rays_per_batch=64, importance_samples=8,
                                   steps_per_image_epoch=2, use_pallas=False),
                 nerf=NerfConfig(**NERF_KW, occ_warmup_steps=0, occ_update_every=1),
                 compute_dtype="float32", tensorboard=False,
                 paths=PathsConfig(root_weights=os.path.join(out, "w"),
                                   root_out=os.path.join(out, "r"),
                                   log_path=os.path.join(out, "log"),
                                   tb_path=os.path.join(out, "tb")))
    return t_engine.Engine(cfg, "cpu")


def test_the_engine_spans_and_history(tmp_path, tracer, capfd):
    """``Engine.train`` records one ``engine.epoch`` an epoch, holding its
    ``engine.steps`` (the epoch's ``epoch.loop`` inside), the camera
    restart, the refresh, the checkpoint and the validation; ``history``
    takes ``seconds``, ``ckpt_seconds``, ``refresh_seconds`` and
    ``validate_seconds`` from those spans, ``capture_seconds`` 0 on the
    loop route; the table is logged at the end."""
    eng = _engine(tmp_path)
    eng.train()
    snap = trace.snapshot()["spans"]
    assert snap["engine.epoch"]["count"] == 3 and snap["engine.epoch"]["parents"] == [""]
    for name in ("engine.steps", "engine.checkpoint", "engine.validate",
                 "engine.restart_cameras"):
        assert snap[name]["parents"] == ["engine.epoch"], name
    assert snap["epoch.loop"]["parents"] == ["engine.steps"]
    assert snap["engine.restart_cameras"]["count"] == 1 and snap["engine.validate"]["count"] == 1
    assert snap["engine.refresh"]["count"] == 1 and snap["engine.refresh"]["last"] == {"epoch": 2}
    assert snap["engine.epoch"]["last"] == {"epoch": 2, "stage": 1}
    h = eng.history
    assert [r["stage"] for r in h] == [0, 0, 1]
    assert sum(r["seconds"] for r in h) == pytest.approx(snap["engine.steps"]["total_s"])
    assert sum(r["ckpt_seconds"] for r in h) == pytest.approx(
        snap["engine.checkpoint"]["total_s"])
    assert [r["capture_seconds"] for r in h] == [0.0, 0.0, 0.0]
    assert [r["refresh_seconds"] > 0 for r in h] == [False, False, True]
    assert h[2]["refresh_seconds"] == pytest.approx(snap["engine.refresh"]["total_s"])
    assert [r["validate_seconds"] > 0 for r in h] == [False, False, True]
    assert h[2]["validate_seconds"] == pytest.approx(snap["engine.validate"]["total_s"])
    assert h[0]["rays_per_s"] == 0.0
    assert h[2]["rays_per_s"] == pytest.approx(eng.steps_per_epoch * 64 / h[2]["seconds"])
    err = capfd.readouterr().err
    assert "trace (spans, counters, device intervals):" in err and "engine.validate" in err
    assert "rays/s without the capture's 0.0s" in err


# ------------------------------------------------------------- the readers

def _seeded():
    """A snapshot of spans whose readings are worked out by hand: frame
    launches of 1, 2, 3 and 100 ms (median 2.5) and epoch launches of 0.5,
    0.7 and 0.6 ms (0.6) before a profiler, then three more of each of
    50 ms (which the launch readers leave out), caller intervals of 1, 2
    and 4 ms (2), and the
    captures: ``epoch.capture`` 10 s holding ``epoch.warmup`` 4 s, which
    holds a 1 s ``kernels.load``; ``frame.warmup`` 3 s holding a 2 s
    ``kernels.load``; ``frame.capture`` 1 s.  Kernel loads 3 s; captures
    less their loads 6 + 3 + 1 + 1 = 11 s."""
    tr = trace.Tracer()
    times = []
    for ms in (1, 2, 3, 100):
        times += [0.0, ms / 1e3]
    for ms in (0.5, 0.7, 0.6):
        times += [0.0, ms / 1e3]
    times += [0.0, 0.05] * 6
    #         capture   warmup   load      load end  warmup end capture end
    times += [0.0,      1.0,     2.0,      3.0,      5.0,       10.0]
    times += [20.0, 20.5, 22.5, 23.0]      # frame.warmup holding a load
    times += [30.0, 31.0]                  # frame.capture
    clock = Clock(*times)
    real = trace.time.perf_counter
    trace.time.perf_counter = clock
    try:
        for _ in range(4):
            with tr.span("frame.launch"):
                pass
        for _ in range(3):
            with tr.span("epoch.launch"):
                pass
        tr.profiled = True           # as a span opened under a profiler leaves it
        for name in ("frame.launch", "epoch.launch") * 3:
            with tr.span(name):
                pass
        with tr.span("epoch.capture"):
            with tr.span("epoch.warmup"):
                with tr.span("kernels.load"):
                    pass
        with tr.span("frame.warmup"):
            with tr.span("kernels.load"):
                pass
        with tr.span("frame.capture"):
            pass
    finally:
        trace.time.perf_counter = real
    for ms in (1, 2, 4):
        tr._add_interval("frame.caller", ms / 1e3)
    return tr.snapshot()


READINGS = {"launch_ms.frame": 2.5, "caller_ms.frame": 2.0, "launch_ms.train": 0.6,
            "setup_kernels_s": 3.0, "setup_capture_s": 11.0}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_the_readers_over_a_seeded_snapshot(monkeypatch, name):
    snap = _seeded()
    monkeypatch.setattr(_spans, "snapshot", lambda: snap)
    assert read_metric(name, {"trace": None}) == pytest.approx(READINGS[name])


@pytest.mark.parametrize("name", sorted(READINGS))
def test_the_readers_read_nothing_where_their_span_is_absent(monkeypatch, name):
    """No reading from an empty tracer (the CPU, the loop route), nor from
    a program that loaded no tracer (the snapshot is None)."""
    monkeypatch.setattr(_spans, "snapshot", trace.Tracer().snapshot)
    assert read_metric(name, {}) is None
    monkeypatch.undo()
    monkeypatch.delitem(sys.modules, _spans.TRACER)
    assert _spans.snapshot() is None
    assert read_metric(name, {}) is None


def test_the_readers_take_the_ports_own_tracer(tracer):
    """The helper's snapshot is the tracer the port loaded."""
    with trace.span("frame.launch"):
        pass
    assert _spans.snapshot()["spans"]["frame.launch"]["count"] == 1


# ------------------------------------------------------------------ the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph route captures CUDA graphs")
    return torch.device("cuda")


@pytest.mark.gpu
def test_graph_route_spans_under_the_profiler(cuda, tracer, monkeypatch):
    """A graph-route frame and epoch (plain routes, small) under
    ``portbench.profiling.record``: their ``mcn.`` ranges are on the
    host's side of the trace and no device operation bears the name; and
    ``frame.caller`` resolves with no synchronize, the caller copying
    each frame to the host as a viewer does."""
    from portbench import profiling

    cfg = Config(nerf=NerfConfig(**NERF_KW), eval=EvalConfig(rays_per_chunk=256,
                 importance_samples=8, use_pallas=False), compute_dtype="float32",
                 train=TrainConfig(rays_per_batch=64, importance_samples=8, use_pallas=False))
    params = init_nerf_params(cfg.nerf, torch.Generator(device=cuda).manual_seed(0), cuda)
    render = t_steps.make_render_fn(cfg, 32, 32, device=cuda)
    pose = torch.tensor([[1.0, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 4.0]])
    K = torch.tensor([[30.0, 0, 16], [0, 30.0, 16], [0, 0, 1]])
    render(params, pose, K)[0].cpu()                  # the capture
    tparams, data = train_workload(cfg, 0, cuda, n_images=2, img_h=H, img_w=W)
    p_flat = t_optim.flatten_params(tparams)
    txs, opt = t_optim.build_optimizers(cfg, tparams, p_flat, 10)
    state = t_steps.TrainState(tparams, p_flat, opt, t_optim.counter(0, cuda))
    epoch = t_steps.make_stage_epoch(cfg, 1, txs[1], H, W, 100, 4)
    gen = torch.Generator(device=cuda).manual_seed(1)
    float(epoch(state, data, gen)["loss"])           # the capture

    def body():
        for _ in range(3):
            render(params, pose, K)[0].cpu()
        float(epoch(state, data, gen)["loss"])

    tr = profiling.record(body, lambda: torch.cuda.synchronize(cuda))
    assert not [op.name for op in tr.device if op.name.startswith("mcn.")]
    host = {op.name for op in tr.host}
    assert {"mcn.frame.launch", "mcn.frame.gather", "mcn.frame.inputs", "mcn.epoch.launch",
            "mcn.epoch.replay", "mcn.epoch.check_buffers"} <= host

    def refuse(*a, **k):
        raise AssertionError("the tracer synchronized")
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.cuda.Event, "synchronize", refuse)
    for _ in range(3):
        render(params, pose, K)[0].cpu()
    snap = trace.snapshot()
    caller = snap["intervals"]["frame.caller"]
    assert caller["count"] >= 4 and 0.0 <= caller["median_s"] < 1.0
    spans = snap["spans"]
    assert spans["frame.launch"]["count"] == 7 and spans["frame.capture"]["count"] == 1
    assert spans["epoch.launch"]["count"] == 2 and spans["epoch.replay"]["units"] == 6
    assert snap["counters"]["graph.captures"] == 2
    assert spans["epoch.warmup"]["parents"] == ["epoch.capture"]
