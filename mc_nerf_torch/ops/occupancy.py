"""Occupancy-grid sample culling (counterpart of ``mc_nerf_tpu/ops/occupancy.py``).

A dense ``[G, G, G]`` grid of activated (softplus) coarse-MLP density over
the scene AABB, rebuilt by one lattice evaluation; thresholded and dilated
into a binary ``[G*G, G]`` map (row = ix*G + iy, column = iz) whose per-ray
probes give the coarse-sampling PMF.  An all-occupied grid gives a uniform
PMF, i.e. stratified-uniform coarse sampling.

Ported: the binary PMF with the bf16 and int8 map layouts.  The density
PMF, the bitpacked layout and the coarse-free mixture sampler wait for
the slice that needs them.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from mc_nerf_torch import resolve_device
from mc_nerf_torch.config import NerfConfig

_MAP_DTYPES = {"bfloat16": torch.bfloat16, "int8": torch.int8}


class OccupancyGrid(NamedTuple):
    """``density[i, j, k]`` = activated density at cell (i, j, k), x-major.
    Derived state: rebuilt from the coarse MLP, never checkpointed."""

    density: torch.Tensor  # [G, G, G] float32


def init_grid(g: int, device=None) -> OccupancyGrid:
    """All-occupied grid: the sampling PMF starts uniform (= no culling)."""
    return OccupancyGrid(torch.full((g, g, g), 1e4, dtype=torch.float32,
                                    device=resolve_device(device)))


def _lattice(g: int, lo: float, hi: float, uniforms: Optional[torch.Tensor] = None,
             device=None) -> torch.Tensor:
    """[G^3, 3] points, one per cell: centers, or jittered uniformly within
    the cell by ``uniforms`` ([G^3, 3] U[0, 1) draws)."""
    dev = resolve_device(device)
    cell = (hi - lo) / g
    axis = lo + (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) * cell
    x, y, z = torch.meshgrid(axis, axis, axis, indexing="ij")
    pts = torch.stack([x, y, z], dim=-1).reshape(-1, 3)
    if uniforms is not None:
        pts = pts + (uniforms * cell - 0.5 * cell)
    return pts


def update_grid(
    grid: Optional[OccupancyGrid],
    sigma_act_fn: Callable[[torch.Tensor], torch.Tensor],
    g: int,
    lo: float,
    hi: float,
    uniforms: Optional[torch.Tensor] = None,
    decay: float = 0.95,
    chunk: int = 262144,
    device=None,
) -> OccupancyGrid:
    """Refresh the grid from the coarse MLP: one dense lattice evaluation.

    ``sigma_act_fn`` maps [P, 3] points to [P] activated density; it runs
    over the lattice in chunks of ``chunk`` points.  ``grid=None`` rebuilds
    from scratch; otherwise the EMA-max ``max(decay * old, new)``.
    """
    pts = _lattice(g, lo, hi, uniforms, device)
    act = torch.cat([sigma_act_fn(c).reshape(-1) for c in torch.split(pts, chunk)])
    act = act.reshape(g, g, g)
    if grid is not None:
        act = torch.maximum(decay * grid.density, act)
    return OccupancyGrid(act)


def binary_grid(grid: OccupancyGrid, cfg: NerfConfig) -> torch.Tensor:
    """Threshold + 3^3 max-pool dilation -> [G*G, G] map in
    ``cfg.occ_map_dtype`` (values {0, 1}; a cell is occupied iff
    ``softplus(sigma) * coarse_step > occ_thresh``)."""
    if cfg.occ_map_dtype not in _MAP_DTYPES:
        raise NotImplementedError(
            f"occ_map_dtype={cfg.occ_map_dtype!r} is not ported yet "
            f"(ported: {sorted(_MAP_DTYPES)})"
        )
    g = grid.density.shape[0]
    step_c = (cfg.far - cfg.near) / cfg.occ_coarse_samples
    occ = (grid.density * step_c > cfg.occ_thresh).float()
    if cfg.occ_dilate:
        # stride-1 max-pool with SAME padding (padding reads -inf)
        occ = F.max_pool3d(occ[None, None], 3, stride=1, padding=1)[0, 0]
    return occ.reshape(g * g, g).to(_MAP_DTYPES[cfg.occ_map_dtype])


def uniform_prior_map(cfg: NerfConfig, device=None) -> torch.Tensor:
    """The sampler map that yields uniform sampling (all occupied)."""
    return binary_grid(init_grid(cfg.occ_grid_size, device), cfg)


def sampler_map(grid: OccupancyGrid, cfg: NerfConfig) -> torch.Tensor:
    """The map :func:`proposal_pmf` consumes."""
    return binary_grid(grid, cfg)


def probe_occupancy(occ2d: torch.Tensor, lo: float, hi: float,
                    x: torch.Tensor) -> torch.Tensor:
    """Occupancy at world points [..., 3] -> [...] float32 in {0, 1};
    points outside the AABB read 0."""
    g = occ2d.shape[-1]
    u = (x - lo) / (hi - lo) * g
    idx = torch.floor(u).to(torch.int64)
    inb = ((idx >= 0) & (idx < g)).all(dim=-1)
    idx = idx.clamp(0, g - 1)
    val = occ2d[idx[..., 0] * g + idx[..., 1], idx[..., 2]]
    return val.float() * inb.float()


def occupancy_pmf(occ2d: torch.Tensor, rays_o: torch.Tensor,
                  rays_d: torch.Tensor,
                  cfg: NerfConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-ray coarse-sampling PMF: ``occ_probes`` uniform probes across
    [near, far] plus one phantom probe beyond each end (zero weight; see
    the JAX docstring), floored by ``occ_floor``.

    Returns (z_probe [R, P+2], pmf [R, P+2])."""
    p = cfg.occ_probes
    h = (cfg.far - cfg.near) / (p - 1)
    z = torch.linspace(cfg.near - h, cfg.far + h, p + 2, dtype=torch.float32,
                       device=rays_o.device)
    z = z[None, :].expand(rays_o.shape[0], p + 2)
    x = rays_o[:, None, :] + rays_d[:, None, :] * z[..., 1:-1, None]
    occ = probe_occupancy(occ2d, cfg.bound_min, cfg.bound_max, x)
    pmf = F.pad(occ + cfg.occ_floor, (1, 1))
    return z, pmf


# The JAX package's proposal_pmf dispatches on ``occ_pmf``; the port has
# only the binary PMF so far (the density PMF waits for its slice).
proposal_pmf = occupancy_pmf
