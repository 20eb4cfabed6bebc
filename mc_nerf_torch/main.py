"""The port's command-line entry, with the reference's flags
(``main.py:244-281``; the JAX package's root ``main.py``):

  python -m mc_nerf_torch --train --root_data <dir> --data_name <scene> [--config ./config]
  python -m mc_nerf_torch --demo  --root_data <dir> --data_name <scene> [--config ./config]

plus ``--log`` / ``--tensorboard`` / ``--start_device``.  ``--train``
trains the three stages, resuming after the latest checkpoint;
``--demo`` scores a checkpoint on the test views.  The run is on the
card ``cuda:<start_device>`` (the reference's meaning of the flag); a
caller may name another device instead.  Single process only: under a
launcher with ``WORLD_SIZE`` > 1 it raises, since data parallelism is not
ported.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Sequence

import torch

from mc_nerf_torch import resolve_device
from mc_nerf_torch.config import build_argparser, from_args


def main(argv: Optional[Sequence[str]] = None, device=None):
    """Parse ``argv`` (default ``sys.argv[1:]``), build the config and run
    ``--train`` or ``--demo`` on ``device`` (default ``cuda:<start_device>``).
    Returns the train state, or the demo's scores."""
    args = build_argparser().parse_args(argv)
    cfg = from_args(args)
    logging.info("config: %s", cfg)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        raise RuntimeError(
            f"WORLD_SIZE={world}: multi-process runs need data parallelism, which the port "
            "does not have yet (ROADMAP Queue 1 item 5); run one process")
    dev = resolve_device(f"cuda:{cfg.start_device}" if device is None else device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)   # the kernels launch on the current device

    from mc_nerf_torch.train.engine import Engine

    engine = Engine(cfg, dev)
    if cfg.mode == 0:
        return engine.train(resume=True)
    return engine.demo()
