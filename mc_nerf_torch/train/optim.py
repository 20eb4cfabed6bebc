"""Per-stage optimizers: flat-buffer RAdam + decoupled weight decay + masks
(counterpart of ``mc_nerf_tpu/train/optim.py:38-193``).

The parameters, the first and the second moments each live in ONE flat
fp32 buffer: :func:`flatten_params` moves every parameter of a
:class:`Params` into a buffer and leaves each parameter a view of it, so
an update writes the buffer in place and the module sees it.  Per-stage
trainable subsets are 0/1 masks (ref ``main.py:182-205``):
  1. camera parameters only (NeRF frozen);
  2. everything;
  3. everything except the camera poses (``pose_se3``).
The leaf order is the module's parameter order (cameras, then the coarse
and fine MLPs), not the JAX package's ``ravel_pytree`` order; the update
is elementwise, so only the leaf-by-leaf values have to agree.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple, Union

import numpy as np
import torch
from torch import nn

from mc_nerf_torch.config import Config
from mc_nerf_torch.models.camera_params import CameraParams
from mc_nerf_torch.models.nerf import NerfParams


class Params(nn.Module):
    """The full trainable state: camera block + NeRF block."""

    def __init__(self, cam: CameraParams, nerf: NerfParams):
        super().__init__()
        self.cam = cam
        self.nerf = nerf


def flatten_params(params: nn.Module) -> torch.Tensor:
    """Copy every parameter into one flat fp32 buffer and make each
    parameter a view of it (in place, so the module's identity is kept).
    Returns the buffer."""
    ps = list(params.parameters())
    flat = torch.cat([p.detach().reshape(-1).float() for p in ps])
    off = 0
    for p in ps:
        n = p.numel()
        p.data = flat[off:off + n].view_as(p)
        off += n
    return flat


def flat_grads(params: nn.Module) -> torch.Tensor:
    """The parameters' gradients as one flat fp32 vector (zeros where a
    parameter has none)."""
    return torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in params.parameters()])


@dataclasses.dataclass
class FlatOptState:
    """RAdam moments over the flat parameter vector."""

    mu: torch.Tensor     # [N] f32 first moment
    nu: torch.Tensor     # [N] f32 second moment
    count: int = 0       # update count


class FlatRAdam:
    """Rectified Adam (threshold 5, SGD fallback) over one flat buffer:
    ``clip_by_global_norm(clip)`` -> ``scale_by_radam`` ->
    ``add_decayed_weights(wd)`` -> ``scale_by_learning_rate(lr)``, as the
    JAX package's.  Frozen entries (mask 0) see zero gradient and zero
    update (weight decay included); the clip norm is taken over trainable
    entries only.  The step's scalars are computed in float32, as there."""

    b1, b2, eps, threshold = 0.9, 0.999, 1e-8, 5.0

    def __init__(self, mask: torch.Tensor, lr: Union[float, Callable[[float], float]],
                 weight_decay: float, clip: float = 0.0):
        self.mask = mask
        self.lr = lr
        self.weight_decay = weight_decay
        self.clip = clip

    def init(self, p_flat: torch.Tensor) -> FlatOptState:
        return FlatOptState(torch.zeros_like(p_flat), torch.zeros_like(p_flat), 0)

    @torch.no_grad()
    def update(self, g_flat: torch.Tensor, state: FlatOptState,
               p_flat: torch.Tensor) -> FlatOptState:
        """One step: updates ``p_flat`` in place, returns the new state."""
        # the scalars round where the JAX package's do: Python constants in
        # double, cast to float32 where they meet the float32 count
        f32 = np.float32
        b1, b2 = self.b1, self.b2
        m = self.mask
        g = g_flat * m
        if self.clip > 0:
            gn = torch.sqrt(torch.sum(g * g))
            g = g * (self.clip / torch.clamp(gn, min=self.clip))
        mu = b1 * state.mu + (1.0 - b1) * g
        nu = b2 * state.nu + (1.0 - b2) * g * g
        count = state.count + 1
        t = f32(count)
        b1t, b2t = f32(b1) ** t, f32(b2) ** t
        mu_hat = mu / float(f32(1.0) - b1t)
        nu_hat = nu / float(f32(1.0) - b2t)
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        ro = f32(ro_inf) - f32(2.0) * t * b2t / (f32(1.0) - b2t)
        if ro >= self.threshold:
            r = np.sqrt((ro - f32(4.0)) * (ro - f32(2.0)) * f32(ro_inf)
                        / (f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro))
            upd = float(r) * mu_hat / (torch.sqrt(nu_hat) + self.eps)
        else:
            upd = mu_hat
        upd = (upd + self.weight_decay * p_flat) * m
        # optax.scale_by_schedule evaluates at the PRE-increment count
        lr = self.lr(t - f32(1.0)) if callable(self.lr) else self.lr
        p_flat.sub_(float(lr) * upd)
        return FlatOptState(mu, nu, count)


def stage_mask(params: Params, stage: int) -> torch.Tensor:
    """[N] f32 0/1 trainable mask in :func:`flatten_params` order."""
    if stage not in (0, 1, 2):
        raise ValueError(stage)
    parts: List[torch.Tensor] = []
    for name, p in params.named_parameters():
        if name.startswith("cam."):
            on = not (stage == 2 and name == "cam.pose_se3")
        else:
            on = stage != 0
        parts.append(torch.full((p.numel(),), 1.0 if on else 0.0, dtype=torch.float32,
                                device=p.device))
    return torch.cat(parts)


def build_optimizers(cfg: Config, params: Params, p_flat: torch.Tensor,
                     steps_per_epoch: int) -> Tuple[Tuple[FlatRAdam, ...],
                                                    Tuple[FlatOptState, ...]]:
    """The three stage optimizers and their initial states.  The stage-1
    LR decays exponentially from ``stage1_lr`` to ``stage1_lr_floor`` over
    the stage (ref ``main.py:188-189``); stages 2/3 are constant."""
    tc = cfg.train
    s1_steps = max(1, steps_per_epoch * cfg.stages.cam_param_epochs)
    gamma1 = np.float32((tc.stage1_lr_floor / tc.stage1_lr) ** (1.0 / s1_steps))

    def lr1(count):
        return np.float32(tc.stage1_lr) * gamma1 ** np.float32(count)

    lrs = (lr1, tc.stage2_lr, tc.stage3_lr)
    opts = tuple(FlatRAdam(stage_mask(params, stage), lrs[stage], tc.weight_decay,
                           tc.grad_clip) for stage in range(3))
    return opts, tuple(tx.init(p_flat) for tx in opts)
