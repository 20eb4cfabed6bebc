"""Coarse/fine NeRF MLP as an ``nn.Module``.

Counterpart of ``mc_nerf_tpu/models/mlp.py`` (ref ``CorseFine_NeRF``,
``model/net_block.py:37-78``): ``depth`` ReLU layers with a skip-concat of
the encoded input at ``skips`` (the skip input is ``[enc | h]``), then two
2-layer heads emitting raw density and SH colour coefficients.

The JAX package stores weights ``[in, out]``; ``nn.Linear`` holds
``[out, in]``.  :func:`mc_nerf_torch.models.nerf.nerf_params_from_numpy`
does the transposes when weights are carried across.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from mc_nerf_torch import resolve_device


class NerfMLP(nn.Module):
    """Weights of one (coarse or fine) NeRF MLP.

    ``trunk[i]``: Linear(in_i, width); ``sigma0/sigma1``: the density head
    (width -> width -> 1); ``sh0/sh1``: the SH head (width -> width ->
    3*(deg+1)**2).
    """

    def __init__(self, in_dim: int, depth: int, width: int,
                 skips: Sequence[int], sh_dim: int, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.skips = tuple(skips)
        fans = [in_dim if i == 0 else (width + in_dim if i in self.skips else width)
                for i in range(depth)]
        self.trunk = nn.ModuleList(nn.Linear(f, width, device=dev) for f in fans)
        self.sigma0 = nn.Linear(width, width, device=dev)
        self.sigma1 = nn.Linear(width, 1, device=dev)
        self.sh0 = nn.Linear(width, width, device=dev)
        self.sh1 = nn.Linear(width, sh_dim, device=dev)

    def forward(self, x_enc: torch.Tensor, compute_dtype=torch.bfloat16,
                sigma_only: bool = False):
        return apply_nerf_mlp(self, x_enc, self.skips, compute_dtype, sigma_only)


def _linear_init(layer: nn.Linear, generator: Optional[torch.Generator]) -> None:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for both W and b (torch's own
    ``nn.Linear`` default bounds, drawn from ``generator``)."""
    bound = 1.0 / (layer.in_features ** 0.5)
    with torch.no_grad():
        for p in (layer.weight, layer.bias):
            u = torch.rand(p.shape, generator=generator, dtype=torch.float32,
                           device=generator.device if generator is not None else p.device)
            p.copy_((u * 2.0 - 1.0) * bound)


def init_nerf_mlp(in_dim: int, depth: int, width: int, skips: Sequence[int],
                  sh_dim: int, generator: Optional[torch.Generator] = None,
                  device=None) -> NerfMLP:
    """Initialize one NeRF MLP (coarse: 4x128 skip@2; fine: 8x256 skip@4)."""
    mlp = NerfMLP(in_dim, depth, width, skips, sh_dim, device=device)
    for layer in (*mlp.trunk, mlp.sigma0, mlp.sigma1, mlp.sh0, mlp.sh1):
        _linear_init(layer, generator)
    return mlp


def _dense(x: torch.Tensor, layer: nn.Linear, dt: torch.dtype) -> torch.Tensor:
    return x @ layer.weight.to(dt).t() + layer.bias.to(dt)


def apply_nerf_mlp(
    mlp: NerfMLP,
    x_enc: torch.Tensor,
    skips: Sequence[int],
    compute_dtype=torch.bfloat16,
    sigma_only: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Trunk + heads over ``x_enc`` [..., in_dim] in ``compute_dtype``.

    Returns (sigma_raw [..., 1], sh [..., sh_dim] or None) in float32.
    """
    x0 = x_enc.to(compute_dtype)
    h = x0
    for i, layer in enumerate(mlp.trunk):
        if i in skips:
            h = torch.cat([x0, h], dim=-1)
        h = torch.relu(_dense(h, layer, compute_dtype))
    s = torch.relu(_dense(h, mlp.sigma0, compute_dtype))
    sigma = _dense(s, mlp.sigma1, compute_dtype)
    if sigma_only:
        return sigma.float(), None
    c = torch.relu(_dense(h, mlp.sh0, compute_dtype))
    sh = _dense(c, mlp.sh1, compute_dtype)
    return sigma.float(), sh.float()
