"""Logging setup: console and an optional timestamped file log (own copy
of ``mc_nerf_tpu/utils/logging.py``).

Fixes the reference's path bug as the JAX package does: the directory
created is the one written to (``utils/log_init.py:15-21``).  Under
``torch.distributed`` only rank 0 logs below WARNING.
"""

from __future__ import annotations

import logging
import os
import time


def is_main_process() -> bool:
    """Rank 0 of an initialized ``torch.distributed`` group, else True."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def setup_logging(log_dir: str | None = None, to_file: bool = False) -> None:
    """Configure the root logger; optionally tee to <log_dir>/<time>.log."""
    handlers = [logging.StreamHandler()]
    if to_file and log_dir and is_main_process():
        os.makedirs(log_dir, exist_ok=True)
        stamp = time.strftime("%Y-%m-%d-%H-%M-%S")
        handlers.append(logging.FileHandler(os.path.join(log_dir, f"{stamp}.log")))
    logging.basicConfig(level=logging.INFO, format="[%(asctime)s %(levelname).1s] %(message)s",
                        datefmt="%H:%M:%S", handlers=handlers, force=True)
    if not is_main_process():
        logging.getLogger().setLevel(logging.WARNING)


def format_table(headers, rows) -> str:
    """Minimal aligned text table (the reference uses prettytable for its
    per-epoch camera-error report, ``model/mc_nerf.py:51, 399-407``)."""
    cols = [[str(h)] + [str(r[i]) for r in rows] for i, h in enumerate(headers)]
    widths = [max(len(c) for c in col) for col in cols]

    def fmt_row(cells):
        return "| " + " | ".join(str(c).rjust(w) for c, w in zip(cells, widths)) + " |"

    sep = "+-" + "-+-".join("-" * w for w in widths) + "-+"
    return "\n".join([sep, fmt_row(headers), sep, *(fmt_row(r) for r in rows), sep])
