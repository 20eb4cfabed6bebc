"""Occupancy-grid sample culling (counterpart of ``mc_nerf_tpu/ops/occupancy.py``).

A dense ``[G, G, G]`` grid of activated (softplus) coarse-MLP density over
the scene AABB, rebuilt by one lattice evaluation; thresholded and dilated
into a binary ``[G*G, G]`` map (row = ix*G + iy, column = iz) whose per-ray
probes give the coarse-sampling PMF.  An all-occupied grid gives a uniform
PMF, i.e. stratified-uniform coarse sampling.

Two PMFs (``NerfConfig.occ_pmf``): "binary", occupancy plus a floor, on a
bf16, int8 or bitpacked map; "density", the compositing weights of the
probed EMA density (:func:`density_rows`, :func:`density_pmf`).  The
coarse-free renders draw their fine depths from either
(:func:`mixture_samples` in training).

The bitpacked map holds 32 z cells in each 32-bit word as ``torch.int32``
(shifts and masks on ``torch.uint32`` are not implemented on every
backend): the same bits as the JAX package's uint32 map, which
``numpy.view(np.int32)`` turns into this one.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from mc_nerf_torch import resolve_device
from mc_nerf_torch.config import NerfConfig
from mc_nerf_torch.ops.volume import sample_pdf

_MAP_DTYPES = {"bfloat16": torch.bfloat16, "int8": torch.int8}
# the bitpacked layout's dtype: what probe_occupancy recognizes it by
BITPACK_DTYPE = torch.int32


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


def _dilate(x: torch.Tensor) -> torch.Tensor:
    """3^3 stride-1 max-pool with SAME padding (the padding reads -inf)."""
    return F.max_pool3d(x[None, None], 3, stride=1, padding=1)[0, 0]


def binary_grid(grid: OccupancyGrid, cfg: NerfConfig) -> torch.Tensor:
    """Threshold + 3^3 max-pool dilation -> the sampler's binary map (a
    cell is occupied iff ``softplus(sigma) * coarse_step > occ_thresh``),
    row = ix * G + iy in every layout of ``cfg.occ_map_dtype``:

    * "bfloat16" / "int8": [G*G, G], column = iz;
    * "bitpack": [G*G, G / 32] int32, z cell iz in word iz >> 5 at bit
      iz & 31 (G must be a multiple of 32).
    """
    g = grid.density.shape[0]
    step_c = (cfg.far - cfg.near) / cfg.occ_coarse_samples
    occ = (grid.density * step_c > cfg.occ_thresh).float()
    if cfg.occ_dilate:
        occ = _dilate(occ)
    dt = cfg.occ_map_dtype
    if dt in _MAP_DTYPES:
        return occ.reshape(g * g, g).to(_MAP_DTYPES[dt])
    if dt == "bitpack":
        if g % 32:
            raise ValueError(f"bitpack needs occ_grid_size % 32 == 0, got {g}")
        bits = occ.reshape(g * g, g // 32, 32).to(torch.int64)
        words = (bits << torch.arange(32, device=bits.device)).sum(-1)     # [0, 2^32)
        return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(BITPACK_DTYPE)
    raise ValueError(f"unknown occ_map_dtype: {dt!r}")


def density_rows(grid: OccupancyGrid, cfg: NerfConfig) -> torch.Tensor:
    """The ``occ_pmf="density"`` sampler map: the EMA density itself,
    dilated as :func:`binary_grid` dilates, as bf16 [G*G, G] rows, so
    that :func:`density_pmf` can composite it."""
    g = grid.density.shape[0]
    d = _dilate(grid.density) if cfg.occ_dilate else grid.density
    return d.reshape(g * g, g).to(torch.bfloat16)


def uniform_prior_map(cfg: NerfConfig, device=None) -> torch.Tensor:
    """The warm-up sampler map, which gives uniform sampling: all occupied
    for the binary PMF; all zero for the density PMF (alpha 0 everywhere
    leaves the pure floor; an all-occupied density would put every
    sample at the near plane through the transmittance)."""
    if cfg.occ_pmf == "density":
        g = cfg.occ_grid_size
        return torch.zeros((g * g, g), dtype=torch.bfloat16, device=resolve_device(device))
    return binary_grid(init_grid(cfg.occ_grid_size, device), cfg)


def sampler_map(grid: OccupancyGrid, cfg: NerfConfig) -> torch.Tensor:
    """The map :func:`proposal_pmf` consumes, per ``cfg.occ_pmf``."""
    if cfg.occ_pmf == "density":
        return density_rows(grid, cfg)
    return binary_grid(grid, cfg)


def probe_occupancy(occ2d: torch.Tensor, lo: float, hi: float,
                    x: torch.Tensor) -> torch.Tensor:
    """The map's value at world points [..., 3] -> [...] float32 ({0, 1}
    for a binary map, the density for :func:`density_rows`' map); points
    outside the AABB read 0.  The bitpacked layout is recognized by its
    dtype (``BITPACK_DTYPE``)."""
    bitpacked = occ2d.dtype == BITPACK_DTYPE
    g = occ2d.shape[-1] * 32 if bitpacked else occ2d.shape[-1]
    u = (x - lo) / (hi - lo) * g
    idx = torch.floor(u).to(torch.int64)
    inb = ((idx >= 0) & (idx < g)).all(dim=-1)
    idx = idx.clamp(0, g - 1)
    row, iz = idx[..., 0] * g + idx[..., 1], idx[..., 2]
    if bitpacked:
        # the word as its unsigned 32 bits in int64, so that bit 31 reads right
        word = occ2d[row, iz >> 5].to(torch.int64) & 0xFFFFFFFF
        val = (word >> (iz & 31)) & 1
    else:
        val = occ2d[row, iz]
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


def density_pmf(dens2d: torch.Tensor, rays_o: torch.Tensor, rays_d: torch.Tensor,
                cfg: NerfConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``occ_pmf="density"`` PMF: at the probes of
    :func:`occupancy_pmf`, the compositing weights of the probed density
    ``w_i = T_i * (1 - exp(-d_i * h))``, ``T_i = exp(-h * sum_{j<i} d_j)``,
    floored by ``occ_floor / occ_probes``, with the same phantom end bins.
    An all-zero map (the warm-up prior) gives the pure floor: uniform.

    Returns (z_probe [R, P+2], pmf [R, P+2])."""
    p = cfg.occ_probes
    h = (cfg.far - cfg.near) / (p - 1)
    z = torch.linspace(cfg.near - h, cfg.far + h, p + 2, dtype=torch.float32,
                       device=rays_o.device)
    z = z[None, :].expand(rays_o.shape[0], p + 2)
    x = rays_o[:, None, :] + rays_d[:, None, :] * z[..., 1:-1, None]
    dh = probe_occupancy(dens2d, cfg.bound_min, cfg.bound_max, x) * h        # [R, P]
    alpha = 1.0 - torch.exp(-dh)
    trans = torch.exp(-torch.cumsum(dh, dim=-1) + dh)   # the exclusive prefix sum
    pmf = F.pad(trans * alpha + cfg.occ_floor / p, (1, 1))
    return z, pmf


def proposal_pmf(occ2d: torch.Tensor, rays_o: torch.Tensor, rays_d: torch.Tensor,
                 cfg: NerfConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sampling PMF of ``cfg.occ_pmf`` on its map: :func:`density_pmf`
    or :func:`occupancy_pmf`."""
    if cfg.occ_pmf == "density":
        return density_pmf(occ2d, rays_o, rays_d, cfg)
    return occupancy_pmf(occ2d, rays_o, rays_d, cfg)


def mixture_samples(z_probe: torch.Tensor, pmf: torch.Tensor, n_samples: int, n_uniform: int,
                    pdf_u: torch.Tensor, mix_u: torch.Tensor, near: float,
                    far: float) -> torch.Tensor:
    """Coarse-free training depths: K - ku stratified inverse-CDF draws
    from the PMF (``pdf_u`` [R, K - ku] U[0, 1)) clipped to [near, far],
    plus ku stratified-uniform draws over [near, far] (``mix_u`` [R, ku]
    U[0, 1)), sorted per ray.  ``n_uniform`` clamps to [0, K - 1] (see
    :func:`mixture_split`); with ku = 0 it is the pure PMF draw and
    ``mix_u`` is not read.  The uniform share keeps empty space
    supervised, as the two-pass coarse pass does."""
    ku = mixture_split(n_samples, n_uniform)
    z = torch.clamp(sample_pdf(z_probe, pmf, n_samples - ku, uniforms=pdf_u), near, far)
    if ku == 0:
        return z
    u = (torch.arange(ku, dtype=torch.float32, device=z.device)[None, :] + mix_u) / ku
    return torch.sort(torch.cat([z, near + (far - near) * u], dim=-1), dim=-1).values


def mixture_split(n_samples: int, n_uniform: int) -> int:
    """The uniform share ku of :func:`mixture_samples`: ``n_uniform``
    clamped to [0, K - 1]."""
    return min(max(n_uniform, 0), n_samples - 1)
