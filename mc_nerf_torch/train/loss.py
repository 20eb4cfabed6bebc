"""Training losses (counterpart of ``mc_nerf_tpu/train/loss.py``, ref
``model/loss.py``)."""

from __future__ import annotations

import torch


def reprojection_loss(pred_pix: torch.Tensor, gt_pix: torch.Tensor, img_h: int,
                      img_w: int) -> torch.Tensor:
    """Mean squared pixel error, axes normalized by image size
    (``loss.py:45-58``)."""
    dx = (pred_pix[..., 0] - gt_pix[..., 0]) / img_w
    dy = (pred_pix[..., 1] - gt_pix[..., 1]) / img_h
    return torch.mean(dx * dx) + torch.mean(dy * dy)


def rgb_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - gt) ** 2)


def self_normalized(loss: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """L / (detach(L) + eps): value ~1, gradient grad(L) / (L + eps).
    eps is 1e-6 (~(0.8 px / 800)^2), not the reference's 1e-8
    (``loss.py:23``): the JAX package's reason, that a converged
    calibration would otherwise be kicked by single steps."""
    return loss / (loss.detach() + eps)
