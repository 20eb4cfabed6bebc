"""The ``field: hashgrid`` radiance field: Instant-NGP's NeRF network
(Mueller et al. 2022, arXiv:2201.05989, section 5.4; the MLPs of
NVlabs/instant-ngp ``configs/nerf/base.json``) over the hash encoding of
:mod:`mc_nerf_torch.models.hashgrid`.

* density MLP: the L F features -> ``ngp_width`` (ReLU) x
  ``ngp_density_hidden`` -> ``ngp_geo_features`` outputs h, no
  activation; density ``sigma = exp(h_0)`` (``ops/volume.py::trunc_exp``:
  its gradient clamps h_0 at 15, as instant-ngp's does);
* colour MLP: ``[h | SH basis of the unit view direction]`` (degree
  ``ngp_dir_degree`` in tiny-cuda-nn's count: 16 values at 4) ->
  ``ngp_width`` (ReLU) x ``ngp_color_hidden`` -> 3, then a sigmoid.

No layer has a bias (tiny-cuda-nn's fully fused MLPs have none).  The
products run in the compute dtype (bf16 operands, fp32 accumulation) as
``torch`` products; the table and its gradient stay float32.  The field
is coarse-free: its samples come from the occupancy PMF
(``models/nerf.py``).  The eager calls are the tracer's span
``ngp.field`` (``utils/trace.py``; a CUDA graph's capture records one).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from mc_nerf_torch import resolve_device
from mc_nerf_torch.config import NerfConfig
from mc_nerf_torch.models.hashgrid import hash_encode, hash_grid
from mc_nerf_torch.models.sh import sh_basis
from mc_nerf_torch.utils import trace


def _mlp(dims, device) -> nn.ModuleList:
    return nn.ModuleList(nn.Linear(i, o, bias=False, device=device)
                         for i, o in zip(dims[:-1], dims[1:]))


class NgpField(nn.Module):
    """The hash table ``table`` [E, F] (the levels' blocks in order) and
    the density and colour MLPs (``density.<i>``, ``color.<i>``: weights
    [out, in]).  The table is the first parameter, so that in the flat
    buffer it starts where the cameras end (an even float count: the
    kernels read its rows as 8-byte pairs)."""

    def __init__(self, cfg: NerfConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        grid = hash_grid(cfg)
        w = cfg.ngp_width
        self.table = nn.Parameter(torch.zeros((grid.entries, grid.features), device=dev))
        self.density = _mlp([grid.out_dim] + [w] * cfg.ngp_density_hidden
                            + [cfg.ngp_geo_features], dev)
        self.color = _mlp([cfg.ngp_geo_features + cfg.ngp_dir_degree ** 2]
                          + [w] * cfg.ngp_color_hidden + [3], dev)


def init_ngp_field(cfg: NerfConfig, generator: Optional[torch.Generator] = None,
                   device=None) -> NgpField:
    """A fresh field: the table U(+-1e-4) (instant-ngp's init), the
    weights U(+-1 / sqrt(fan_in)) (``nn.Linear``'s bounds), drawn from
    ``generator``."""
    field = NgpField(cfg, device)
    dev = generator.device if generator is not None else field.table.device
    with torch.no_grad():
        for name, p in field.named_parameters():
            u = torch.rand(p.shape, generator=generator, dtype=torch.float32, device=dev)
            bound = 1e-4 if name == "table" else p.shape[1] ** -0.5
            p.copy_((u * 2.0 - 1.0) * bound)
    return field


def _dense(x: torch.Tensor, layer: nn.Linear, dt: torch.dtype) -> torch.Tensor:
    return x.to(dt) @ layer.weight.to(dt).t()


def _run(layers: nn.ModuleList, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """The MLP: ReLU after every layer but the last."""
    for i, layer in enumerate(layers):
        x = _dense(x, layer, dt)
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def ngp_density(field: NgpField, xyz: torch.Tensor, cfg: NerfConfig,
                gate: Optional[torch.Tensor], compute_dtype
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Points [P, 3] -> (raw density h_0 [P] float32, h [P, geo] in the
    compute dtype); the density is ``trunc_exp(h_0)``."""
    feat = hash_encode(xyz, field.table, gate, hash_grid(cfg), cfg.bound_min, cfg.bound_max)
    h = _run(field.density, feat, compute_dtype)
    return h[:, 0].float(), h


def ngp_shade(field: NgpField, xyz: torch.Tensor, dirs: torch.Tensor, cfg: NerfConfig,
              gate: Optional[torch.Tensor], compute_dtype
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Points [R, S, 3] along rays of unit directions ``dirs`` [R, 3] ->
    (raw density [R, S], rgb [R, S, 3]), float32: composite with
    ``density="exp"``."""
    r, s = xyz.shape[0], xyz.shape[1]
    with trace.span("ngp.field", units=r * s):
        sigma, h = ngp_density(field, xyz.reshape(r * s, 3), cfg, gate, compute_dtype)
        basis = sh_basis(cfg.ngp_dir_degree - 1, dirs).to(h.dtype)          # [R, d^2]
        basis = basis[:, None, :].expand(r, s, basis.shape[-1]).reshape(r * s, -1)
        rgb = torch.sigmoid(_run(field.color, torch.cat([h, basis], -1), compute_dtype).float())
    return sigma.reshape(r, s), rgb.reshape(r, s, 3)
