"""Run one cell of the port's benchmark once and print its result.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout of the repository.  The cell
(``portbench/workloads/<name>.json``) names its configuration
(``configs/``), its traffic mix (``traffic/``, whose ``runner`` picks
``runners/<runner>.py``), the chips it takes and the limits of its check.
A run makes its inputs and weights from ``--seed``, sets up and warms the
port (``mc_nerf_torch``), measures for ``--seconds``, checks what the timed
path produced against the plain reference (``reference/``), and prints
one JSON object as its last line: ``correct``, ``attempted``, ``failed``,
``metrics`` (``--trace 0``: the cell's end-to-end metrics of
``BENCHMARK.json``; ``--trace 1``: its per-layer metrics, each read by
``metrics/<name>.py`` from a profiled part of the window), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number compared
with its limit, which also close standard error.  A cell on more than one
chip starts one rank a card (torchrun's environment, NCCL); rank 0
prints.  No card, or fewer than the cell takes: exit 2, no result.
"""

from __future__ import annotations

import time

T0 = time.time()     # set-up is timed from here (a rank: from its launcher's start)

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mc_nerf_tpu")
# build and kernel caches at fixed places inside the checkout
CACHES = {"TRITON_CACHE_DIR": ROOT / "build" / "triton_cache",
          "TORCH_EXTENSIONS_DIR": ROOT / "build" / "torch_extensions"}


def load(kind: str, name: str) -> dict:
    """``portbench/<kind>/<name>.json``."""
    return json.loads((HERE / kind / f"{name}.json").read_text())


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_metrics(man: dict, cell: str) -> tuple:
    """(the cell's end-to-end metrics, its per-layer metrics) of the
    manifest: those whose ``workloads`` list it, or that have none; a
    per-layer metric without one is the cell's where its ``moves`` is."""
    e2e = [m for m in man["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in man["per_layer"]
             if cell in m.get("workloads", [cell] if m["moves"] in names else [])]
    return e2e, layer


def read_metric(name: str, ctx: dict) -> Optional[float]:
    """``metrics/<name>.py``'s ``read(ctx)``."""
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def power_limit(index: int) -> Optional[float]:
    """The card's power limit in W (``nvidia-smi``), None where unread."""
    try:
        out = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True, text=True,
                             timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


class Run:
    """One run's settings, handed to the runner."""

    def __init__(self, workload: str, seed: int, seconds: float, trace: bool, device,
                 t0: float, rank: int = 0, overrides: Optional[dict] = None):
        self.workload, self.seed, self.seconds, self.trace = workload, seed, seconds, trace
        self.cell = load("workloads", workload)
        self.config = load("configs", self.cell["config"])
        self.traffic = load("traffic", self.cell["traffic"])
        for part, values in (overrides or {}).items():       # the CPU tests' small sizes
            target = {"traffic": self.traffic, "config": self.config}.get(part)
            target = self.config[part] if target is None else target
            for k, v in values.items():
                if isinstance(v, dict):
                    target[k].update(v)
                else:
                    target[k] = v
        self.device, self.t0, self.rank = device, t0, rank
        from portbench import profiling
        self.layer_maps = profiling.load_layer_maps()

    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def run_cell(b: Run, man: dict) -> Optional[dict]:
    """Drive the cell's run; rank 0 returns the result, other ranks None."""
    runner = importlib.import_module(f"portbench.runners.{b.traffic['runner']}")
    out = runner.run(b)
    if b.rank != 0:
        return None
    from portbench import checks
    e2e, layer = cell_metrics(man, b.workload)
    readings = out["readings"]
    limits = b.cell["limits"]
    correct, table = checks.judge(readings, limits)
    correct = correct and out["failed"] == 0
    metrics = {}
    if b.trace:
        ctx = {"trace": out.get("trace"), "world": b.traffic.get("world", 1)}
        for m in layer:
            v = read_metric(m["name"], ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in e2e:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]], "unit": m["unit"]}
    import torch
    dev = b.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": b.traffic.get("world", 1), "memory_peak_bytes": int(out["peak"])}
    if dev.type == "cuda":
        device["power_limit_w"] = power_limit(dev.index or 0)
    result = {"correct": bool(correct), "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    if b.trace and out.get("trace"):
        rs = out["trace"]
        device["busy_s"] = sum(r["busy_s"] for r in rs) / len(rs)
        device["window_s"] = sum(r["window_s"] for r in rs) / len(rs)
        result["breakdown"] = rs[0]["breakdown"]
    result["notes"] = {"setup_s": out["setup_s"], "world": b.traffic.get("world", 1),
                       "readings": {k: v for k, v in readings.items()
                                    if isinstance(v, (int, float))},
                       "left_out_leaves": readings.get("left_out"),
                       "worst_leaves": [readings.get("grad_leaf"), readings.get("change_leaf")]}
    result["checks"] = table
    return result


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_ranks(module: str, argv: list, world: int) -> tuple:
    """Start ``world`` ranks of ``python3 -m <module> <argv>`` with
    torchrun's environment, one a card, their output on standard error;
    wait for every rank (stop them all when one fails).  Returns (the
    first failing rank's exit code or 0, rank 0's standard output)."""
    import tempfile
    env = {**os.environ, "WORLD_SIZE": str(world), "LOCAL_WORLD_SIZE": str(world),
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()), "PORTBENCH_T0": repr(T0)}
    procs = []
    with tempfile.TemporaryFile("w+") as out0:
        try:
            for r in range(world):
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", module, *argv], cwd=str(ROOT),
                    env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                    stdout=out0 if r == 0 else sys.stderr))
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs):
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        out0.seek(0)
        text = out0.read()
    return next((p.returncode for p in procs if p.returncode), 0), text


def join_ranks(need: int):
    """This process's card, and the group when the cell takes ``need`` > 1
    cards (the environment :func:`launch_ranks` gives)."""
    import torch
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    torch.cuda.set_device(dev)
    if need > 1:
        from mc_nerf_torch.parallel.distributed import initialize_distributed
        initialize_distributed()
    return dev, int(os.environ.get("RANK", 0))


def leave_ranks(need: int) -> None:
    if need > 1:
        import torch.distributed as dist
        dist.barrier()
        dist.destroy_process_group()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for k, v in CACHES.items():
        v.mkdir(parents=True, exist_ok=True)
        os.environ[k] = str(v)
    cell = load("workloads", args.workload)
    man = manifest()

    import torch
    need = cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} takes {need} CUDA card(s); this machine has {have}",
              file=sys.stderr)
        return 2
    if need > 1 and "RANK" not in os.environ:
        rc, text = launch_ranks("portbench.run", argv, need)
        return rc or report(json.loads(text.strip().splitlines()[-1]))

    t0 = float(os.environ.get("PORTBENCH_T0", T0))
    dev, rank = join_ranks(need)
    b = Run(args.workload, args.seed, args.seconds, bool(args.trace), dev, t0, rank)
    try:
        result = run_cell(b, man)
    finally:
        leave_ranks(need)
    if rank != 0:
        return 0
    if need > 1:            # the launcher reports; a rank only refuses
        if forbidden_modules():
            print(f"portbench: rank 0 loaded {forbidden_modules()}", file=sys.stderr)
            return 3
        print(json.dumps(result), flush=True)
        return 0
    return report(result)


def report(result: dict) -> int:
    """Print the checks on standard error and the result line last on
    standard output, unless a forbidden module was loaded."""
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}: refusing to report", file=sys.stderr)
        return 3
    for name, row in result["checks"].items():
        print(f"check {name}: {row['value']} (limit {row['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
