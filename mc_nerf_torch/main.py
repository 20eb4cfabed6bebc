"""The port's command-line entry, with the reference's flags
(``main.py:244-281``; the JAX package's root ``main.py``):

  python -m mc_nerf_torch --train --root_data <dir> --data_name <scene> [--config ./config]
  python -m mc_nerf_torch --demo  --root_data <dir> --data_name <scene> [--config ./config]
  torchrun --nproc_per_node N -m mc_nerf_torch --train | --demo ...

plus ``--log`` / ``--tensorboard`` / ``--start_device``.  ``--train``
trains the three stages, resuming after the latest checkpoint;
``--demo`` scores a checkpoint on the test views.  The run is on the
card ``cuda:<start_device>`` (the reference's meaning of the flag), or
under ``torchrun`` one process per card from it
(``parallel/distributed.py``); a caller may name another device instead.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import torch.distributed as dist

from mc_nerf_torch.config import build_argparser, from_args
from mc_nerf_torch.parallel.distributed import initialize_distributed


def main(argv: Optional[Sequence[str]] = None, device=None):
    """Parse ``argv`` (default ``sys.argv[1:]``), build the config and run
    ``--train`` or ``--demo`` on ``device`` (default ``cuda:<start_device>``,
    under ``torchrun`` the rank's card).  Returns the train state, or the
    demo's scores.  A process group this call creates is destroyed on the
    way out, after the engine's step graphs are released (``Engine.close``);
    one that already exists is used and left."""
    args = build_argparser().parse_args(argv)
    cfg = from_args(args)
    logging.info("config: %s", cfg)
    topo = initialize_distributed(cfg.start_device, device)
    engine = None
    try:
        from mc_nerf_torch.train.engine import Engine

        engine = Engine(cfg, topo.device)
        if cfg.mode == 0:
            return engine.train(resume=True)
        return engine.demo()
    finally:
        if topo.created:
            if engine is not None:
                engine.close()     # over NCCL its step graphs hold the group's communicator
            dist.destroy_process_group()
