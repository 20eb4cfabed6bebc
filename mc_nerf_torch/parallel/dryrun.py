"""One data-parallel GLOBAL_OPTIM step over spawned ranks (counterpart of
``__graft_entry__.dryrun_multichip``), and the small launcher that starts
ranks the way ``torchrun`` does.

    python -c "from mc_nerf_torch.parallel.dryrun import dryrun_multichip; dryrun_multichip(2)"

:func:`dryrun_multichip` starts ``n`` ranks that rendezvous through a
file store under a temporary directory; each takes one full step at
``Config()``'s widths (4x128 coarse, 8x256 fine, 48 occupancy-culled
coarse and 32 fine samples, float32) with ``7000 // n`` rays on a seeded
16-view 64x64 scene, and the step is checked: the loss is finite on
every rank and the updated ``p_flat`` holds the same bits on every rank.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(n: int, argv: Sequence[str], workdir: str, env: Optional[Dict[str, str]] = None,
                timeout: float = 600.0) -> List[str]:
    """Run ``python <argv>`` as ``n`` ranks with ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, and
    ``MASTER_ADDR`` / ``MASTER_PORT`` on a free local port), ``env`` on
    top, each rank's output in ``<workdir>/rank<r>.log``.  Returns each
    rank's output once all have exited 0; when one fails or ``timeout``
    seconds pass, stops every rank and raises with that rank's output."""
    port = str(free_port())
    procs, logs = [], []
    try:
        for r in range(n):
            rank_env = {**os.environ, **(env or {}), "RANK": str(r), "WORLD_SIZE": str(n),
                        "LOCAL_RANK": str(r), "LOCAL_WORLD_SIZE": str(n),
                        "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port}
            logs.append(os.path.join(workdir, f"rank{r}.log"))
            with open(logs[-1], "w") as out:
                procs.append(subprocess.Popen([sys.executable, *argv], stdout=out,
                                              stderr=subprocess.STDOUT, env=rank_env))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad or time.monotonic() > deadline:
                r = bad[0] if bad else next(r for r, p in enumerate(procs) if p.poll() is None)
                why = f"exited {procs[r].returncode}" if bad else f"ran past {timeout:.0f} s"
                raise RuntimeError(f"rank {r} of {n} {why}:\n" + _tail(logs[r]))
            time.sleep(0.05)
        for r, p in enumerate(procs):
            if p.returncode:
                raise RuntimeError(f"rank {r} of {n} exited {p.returncode}:\n" + _tail(logs[r]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = []
    for path in logs:
        with open(path) as f:
            outs.append(f.read())
    return outs


def _tail(path: str, n: int = 6000) -> str:
    with open(path) as f:
        return f.read()[-n:]


def last_json(output: str) -> dict:
    """The JSON object on the last line of a rank's output."""
    return json.loads(output.strip().splitlines()[-1])


def dryrun_multichip(n: int, device: str = "cpu", rays_per_rank: Optional[int] = None,
                     timeout: float = 600.0) -> dict:
    """One GLOBAL_OPTIM step on ``n`` ranks (``device``: "cpu", or "cuda"
    for each rank's card by ``rank_device``), ``rays_per_rank`` (default
    ``7000 // n``; only the rays may be cut, the widths are ``Config()``'s)
    rays a rank.  Raises unless every rank's loss is finite and every
    rank's ``p_flat`` the same bits.  Returns {"loss": the mean over the
    ranks, "backend", "digest"}."""
    spec = {"device": device, "rays": rays_per_rank or 7000 // n}
    with tempfile.TemporaryDirectory() as work:
        spec["store"] = "file://" + os.path.join(work, "store")
        results = [last_json(o) for o in spawn_ranks(
            n, ["-m", "mc_nerf_torch.parallel.dryrun", json.dumps(spec)], work, timeout=timeout)]
    losses = [r["loss"] for r in results]
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"dryrun_multichip({n}): a rank's loss is not finite: {losses}")
    if len({r["digest"] for r in results}) != 1 or len({r["global_loss"] for r in results}) != 1:
        raise RuntimeError(f"dryrun_multichip({n}): the ranks disagree after the step: {results}")
    out = {"loss": results[0]["global_loss"], "backend": results[0]["backend"],
           "digest": results[0]["digest"]}
    print(f"dryrun_multichip({n}): OK, loss={out['loss']:.5f} over {n} ranks "
          f"({out['backend']}, {spec['rays']} rays a rank)")
    return out


def _rank_step(spec: dict) -> dict:
    """One rank of :func:`dryrun_multichip`."""
    import torch.distributed as dist

    from mc_nerf_torch.config import Config, StageConfig, TrainConfig
    from mc_nerf_torch.data.calibration import calibration_from_numpy
    from mc_nerf_torch.models.camera_params import init_camera_params
    from mc_nerf_torch.models.nerf import init_nerf_params
    from mc_nerf_torch.ops.occupancy import uniform_prior_map
    from mc_nerf_torch.parallel.distributed import initialize_distributed
    from mc_nerf_torch.parallel.mesh import all_reduce_mean_
    from mc_nerf_torch.train.optim import Params, build_optimizers, counter, flatten_params
    from mc_nerf_torch.train.steps import (
        TrainData,
        TrainState,
        draw_step,
        make_stage_step,
        rank_block,
    )

    topo = initialize_distributed(device=spec["device"], init_method=spec["store"])
    try:
        dev, img_h, img_w, n_images = topo.device, 64, 64, 16
        cfg = Config(stages=StageConfig(1, 1, 1),
                     train=dataclasses.replace(TrainConfig(), rays_per_batch=spec["rays"],
                                               steps_per_image_epoch=1),
                     compute_dtype="float32")
        params = Params(init_camera_params(n_images, dev),
                        init_nerf_params(cfg.nerf, torch.Generator(device=dev).manual_seed(0),
                                         dev))
        p_flat = flatten_params(params)
        txs, opt_states = build_optimizers(cfg, params, p_flat, steps_per_epoch=4)
        rng = np.random.default_rng(0)
        images = rng.integers(0, 256, size=(n_images, img_h * img_w, 3), dtype=np.uint8)
        pts = rng.uniform(2, 14, size=(n_images, 6, 5, 2)).astype(np.float32)
        valid = np.ones((n_images, 6), bool)
        data = TrainData(torch.as_tensor(images, device=dev),
                         calibration_from_numpy(pts, valid, pts, valid, device=dev),
                         uniform_prior_map(cfg.nerf, dev))     # all occupied
        state = TrainState(params, p_flat, opt_states, counter(0, dev))
        step = make_stage_step(cfg, 1, txs[1], img_h, img_w, 12, topo.world)
        # the global batch (one image a rank) from one seed on every rank
        draw_cfg = cfg.replace(train=dataclasses.replace(cfg.train, images_per_batch=topo.world))
        draws = draw_step(draw_cfg, 1, n_images, img_h, img_w, True,
                          torch.Generator(device=dev).manual_seed(1))
        metrics = step(state, data, rank_block(draws, topo.rank, topo.world))
        loss = float(metrics["loss"])
        global_loss = float(all_reduce_mean_(metrics["loss"].clone()))
        digest = hashlib.sha256(state.p_flat.cpu().numpy().tobytes()).hexdigest()
        return {"rank": topo.rank, "backend": topo.backend, "device": str(dev), "loss": loss,
                "global_loss": global_loss, "digest": digest}
    finally:
        if topo.created:
            dist.destroy_process_group()


if __name__ == "__main__":
    print(json.dumps(_rank_step(json.loads(sys.argv[1]))), flush=True)
