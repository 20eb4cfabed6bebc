"""Checkpoint save, restore and retention for the port's train state
(counterpart of ``mc_nerf_tpu/train/checkpoint.py``, which uses orbax).

One file per epoch, ``<ckpt_dir>/<epoch>/state.pt``: ``torch.save`` of
the flat parameter buffer, each stage's RAdam (mu, nu, count), the
global step (the device values, read back to the host) and the epoch,
read back with ``torch.load(weights_only=True)``.  A save writes a
temporary file named for the process and publishes it with
``os.replace``, so a reader never sees half a file and two writers never
share a temporary name.  Saves are synchronous: the JAX package saves
asynchronously, but ~2.5 MB of flat state (the default model) is not
worth a thread.  Retention follows the JAX package's ``Checkpointer``:
the newest ``max_keep`` epochs plus ``keep_epochs`` (the engine passes
its stage boundaries); ``max_keep`` 0 keeps every epoch.
"""

from __future__ import annotations

import os
import shutil
from typing import Iterable, List, Optional, Tuple

import torch

from mc_nerf_torch.train.steps import TrainState

STATE_FILE = "state.pt"


class Checkpointer:
    """Per-epoch checkpoints of a :class:`TrainState` under one directory."""

    def __init__(self, ckpt_dir: str, max_keep: int = 0, keep_epochs: Iterable[int] = ()):
        self.dir = ckpt_dir
        self.max_keep = max(0, max_keep)
        self.keep_epochs = frozenset(keep_epochs)

    def epochs(self) -> List[int]:
        """The epochs with a published checkpoint, ascending."""
        if not os.path.isdir(self.dir):
            return []
        return sorted(int(n) for n in os.listdir(self.dir)
                      if n.isdigit() and os.path.isfile(os.path.join(self.dir, n, STATE_FILE)))

    def latest_epoch(self) -> Optional[int]:
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    def save(self, epoch: int, state: TrainState) -> None:
        """Write ``state`` as ``epoch``'s checkpoint, then prune."""
        payload = {
            "p_flat": state.p_flat.detach().cpu(),
            "opt": [{"mu": o.mu.detach().cpu(), "nu": o.nu.detach().cpu(), "count": int(o.count)}
                    for o in state.opt_states],
            "step": int(state.step),
            "epoch": int(epoch),
        }
        d = os.path.join(self.dir, str(epoch))
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, f"{STATE_FILE}.tmp-{os.getpid()}")
        torch.save(payload, tmp)
        os.replace(tmp, os.path.join(d, STATE_FILE))
        self._prune()

    def _prune(self) -> None:
        if not self.max_keep:
            return
        epochs = self.epochs()
        for e in epochs[:-self.max_keep]:
            if e not in self.keep_epochs:
                shutil.rmtree(os.path.join(self.dir, str(e)), ignore_errors=True)

    def restore(self, state: TrainState, epoch: Optional[int] = None) -> Tuple[TrainState, int]:
        """Load ``epoch``'s checkpoint (the latest when None) into ``state``
        in place: the flat buffer, every stage's moments and count and the
        step are copied into the buffers ``state`` already holds (the
        parameters stay views of the flat buffer, and a captured step
        graph keeps reading the buffers it was captured with).  Returns
        (state, the epoch restored)."""
        if epoch is None:
            epoch = self.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        path = os.path.join(self.dir, str(epoch), STATE_FILE)
        raw = torch.load(path, map_location="cpu", weights_only=True)
        if raw["p_flat"].shape != state.p_flat.shape or len(raw["opt"]) != len(state.opt_states):
            raise ValueError(f"{path} holds {tuple(raw['p_flat'].shape)} parameters in "
                             f"{len(raw['opt'])} optimizer states; the model has "
                             f"{tuple(state.p_flat.shape)} in {len(state.opt_states)}")
        with torch.no_grad():
            state.p_flat.copy_(raw["p_flat"])
            for o, saved in zip(state.opt_states, raw["opt"]):
                o.mu.copy_(saved["mu"])
                o.nu.copy_(saved["nu"])
                o.count.fill_(int(saved["count"]))
            state.step.fill_(int(raw["step"]))
        return state, int(raw["epoch"])
