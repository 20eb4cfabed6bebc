"""Per-stage optimizers: flat-buffer RAdam + decoupled weight decay + masks
(counterpart of ``mc_nerf_tpu/train/optim.py:38-193``).

The parameters, the first and the second moments each live in ONE flat
fp32 buffer: :func:`flatten_params` moves every parameter of a
:class:`Params` into a buffer and leaves each parameter a view of it, so
an update writes the buffer in place and the module sees it.  Per-stage
trainable subsets are 0/1 masks (ref ``main.py:182-205``):
  1. camera parameters only (NeRF frozen);
  2. everything;
  3. everything except the camera poses (``pose_se3``);
in coarse-free stages the coarse MLP is frozen too.
The leaf order is the module's parameter order (cameras, then the coarse
and fine MLPs, or the hash-grid field's table and MLPs: ~0.73 M and
~12.2 M entries at the published widths), not the JAX package's
``ravel_pytree`` order; the update
is elementwise, so only the leaf-by-leaf values have to agree.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple, Union

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
    """RAdam moments over the flat parameter vector and the update count,
    all on the parameters' device.  :meth:`FlatRAdam.update` writes all
    three in place, so a captured step keeps reading and writing the same
    buffers."""

    mu: torch.Tensor     # [N] f32 first moment
    nu: torch.Tensor     # [N] f32 second moment
    count: torch.Tensor  # 0-d int32 update count (:func:`counter`)


def counter(value: int, device) -> torch.Tensor:
    """A step or update count: a 0-d int32 tensor on ``device``."""
    return torch.tensor(int(value), dtype=torch.int32, device=device)


class FlatRAdam:
    """Rectified Adam (threshold 5, SGD fallback) over one flat buffer:
    ``clip_by_global_norm(clip)`` -> ``scale_by_radam`` ->
    ``add_decayed_weights(wd)`` -> ``scale_by_learning_rate(lr)``, as the
    JAX package's.  Frozen entries (mask 0) see zero gradient and zero
    update (weight decay included); the clip norm is taken over trainable
    entries only.  The step's scalars (``b1^t``, ``b2^t``, rho, its
    threshold branch, a scheduled LR) are float32 tensors computed on the
    device from the device count, as optax computes them: nothing in an
    update is a host value that a CUDA graph would freeze."""

    b1, b2, eps, threshold = 0.9, 0.999, 1e-8, 5.0

    def __init__(self, mask: torch.Tensor,
                 lr: Union[float, Callable[[torch.Tensor], torch.Tensor]],
                 weight_decay: float, clip: float = 0.0):
        self.mask = mask
        self.lr = lr
        self.weight_decay = weight_decay
        self.clip = clip

    def init(self, p_flat: torch.Tensor) -> FlatOptState:
        return FlatOptState(torch.zeros_like(p_flat), torch.zeros_like(p_flat),
                            counter(0, p_flat.device))

    @torch.no_grad()
    def update(self, g_flat: torch.Tensor, state: FlatOptState,
               p_flat: torch.Tensor) -> FlatOptState:
        """One step: updates ``p_flat`` and ``state`` (mu, nu, count) in
        place and returns ``state``."""
        # Python constants meet float32 tensors as JAX's weak types do:
        # cast to float32 where they meet them
        b1, b2 = self.b1, self.b2
        m = self.mask
        g = g_flat * m
        if self.clip > 0:
            gn = torch.sqrt(torch.sum(g * g))
            g = g * (self.clip / torch.clamp(gn, min=self.clip))
        mu, nu = state.mu, state.nu
        mu.mul_(b1).add_((1.0 - b1) * g)
        nu.mul_(b2).add_((1.0 - b2) * g * g)
        state.count.add_(1)
        t = state.count.float()
        b1t, b2t = torch.pow(b1, t), torch.pow(b2, t)
        mu_hat = mu / (1.0 - b1t)
        nu_hat = nu / (1.0 - b2t)
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        ro = ro_inf - 2.0 * t * b2t / (1.0 - b2t)
        r = torch.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
        rect = r * mu_hat / (torch.sqrt(nu_hat) + self.eps)
        upd = torch.where(ro >= self.threshold, rect, mu_hat)
        upd = (upd + self.weight_decay * p_flat) * m
        # optax.scale_by_schedule evaluates at the PRE-increment count
        lr = self.lr(t - 1.0) if callable(self.lr) else self.lr
        p_flat.sub_(upd * lr)
        return state


def exponential_decay(init: float, gamma: float) -> Callable[[torch.Tensor], torch.Tensor]:
    """``optax.exponential_decay(init, transition_steps=1, decay_rate=gamma)``
    on a float32 device count: ``init * gamma ** count`` in float32."""
    def lr(count: torch.Tensor) -> torch.Tensor:
        return init * torch.pow(gamma, count)
    return lr


def stage_mask(params: Params, stage: int, freeze_coarse: bool = False) -> torch.Tensor:
    """[N] f32 0/1 trainable mask in :func:`flatten_params` order.
    ``freeze_coarse`` (a coarse-free stage) freezes the coarse MLP: it gets
    no gradient there, but decoupled weight decay would still shrink it,
    and the refresh may probe it."""
    if stage not in (0, 1, 2):
        raise ValueError(stage)
    parts: List[torch.Tensor] = []
    for name, p in params.named_parameters():
        if name.startswith("cam."):
            on = not (stage == 2 and name == "cam.pose_se3")
        else:
            on = stage != 0 and not (freeze_coarse and name.startswith("nerf.coarse."))
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
    gamma1 = (tc.stage1_lr_floor / tc.stage1_lr) ** (1.0 / s1_steps)
    lrs = (exponential_decay(tc.stage1_lr, gamma1), tc.stage2_lr, tc.stage3_lr)
    opts = tuple(FlatRAdam(stage_mask(params, stage, cfg.nerf.coarse_free_at(stage)), lrs[stage],
                           tc.weight_decay, tc.grad_clip) for stage in range(3))
    return opts, tuple(tx.init(p_flat) for tx in opts)
