"""Image quality metrics (counterpart of ``mc_nerf_tpu/eval/metrics.py``).

* PSNR: -10*log10(MSE) over [0, 1] images (ref ``main.py:220-228``).
* SSIM: 11x11 Gaussian window (sigma 1.5), C1=0.01^2, C2=0.03^2 — the
  reference's ``pytorch_ssim`` algorithm, as a depthwise convolution.
* LPIPS(alex) (:mod:`mc_nerf_torch.eval.lpips`) where a weights file is
  found, else None, as the JAX package does without weights.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """-10 log10(mean squared error); inputs in [0, 1], any matching shape."""
    return -10.0 * torch.log10(torch.mean((pred - gt) ** 2))


def _gaussian_window(size: int = 11, sigma: float = 1.5, device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    g = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    g = g / torch.sum(g)
    return torch.outer(g, g)


def _depthwise_blur(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """[H, W, C] depthwise 2-D convolution, SAME (zero) padding, summed in
    float64 and returned in the input's dtype."""
    c = img.shape[-1]
    k = window.shape[0]
    x = img.permute(2, 0, 1)[None]                          # [1, C, H, W]
    weight = window[None, None].expand(c, 1, k, k).contiguous()
    out = F.conv2d(x.double(), weight.double(), padding=k // 2, groups=c)
    return out[0].permute(1, 2, 0).to(img.dtype)


def ssim(pred: torch.Tensor, gt: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over an [H, W, C] image pair in [0, 1].

    The blurs accumulate in float64 and round once to fp32: anything below
    full fp32 (TF32 in cuDNN's default, or fp32 sums whose error grows
    with the 121 taps) breaks the ``blur(x^2) - mu^2`` cancellation on
    near-constant images and gives SSIM "scores" above 1.
    """
    w = _gaussian_window(window_size, sigma, device=pred.device)
    mu_p = _depthwise_blur(pred, w)
    mu_g = _depthwise_blur(gt, w)
    mu_pp, mu_gg, mu_pg = mu_p * mu_p, mu_g * mu_g, mu_p * mu_g
    sig_p = _depthwise_blur(pred * pred, w) - mu_pp
    sig_g = _depthwise_blur(gt * gt, w) - mu_gg
    sig_pg = _depthwise_blur(pred * gt, w) - mu_pg
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu_pg + c1) * (2 * sig_pg + c2)) / (
        (mu_pp + mu_gg + c1) * (sig_p + sig_g + c2)
    )
    return torch.mean(ssim_map)


@functools.lru_cache(maxsize=2)
def _lpips_model(path: str, device: str):
    from mc_nerf_torch.eval import lpips as lpips_net

    return lpips_net.load(path, device)


def lpips(pred, gt, weights_path: Optional[str] = None) -> Optional[float]:
    """LPIPS(alex) between two [H, W, 3] images in [0, 1] (tensors or
    arrays; computed on ``pred``'s device) if a weights file is found (see
    :mod:`mc_nerf_torch.eval.lpips`), else None.  The model loads once per
    file and device (cached), not once per image as the reference's
    ``lpips.LPIPS(net="alex")`` at ``main.py:239`` does."""
    from mc_nerf_torch.eval import lpips as lpips_net

    path = lpips_net.weights_file(weights_path)
    if path is None:
        return None
    pred = torch.as_tensor(pred)
    gt = torch.as_tensor(gt, device=pred.device)
    return float(lpips_net.lpips_distance(_lpips_model(path, str(pred.device)), pred, gt))
