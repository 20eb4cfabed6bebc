"""Instant-NGP's multiresolution hash encoding (Mueller et al. 2022,
arXiv:2201.05989, section 3), the encode of the ``field: hashgrid``
radiance field (:mod:`mc_nerf_torch.models.ngp`).

L levels of F = 2 features.  Level l has resolution ``N_l = floor(N_min *
b^l)``, ``b = (N_max / N_min)^(1 / (L - 1))`` (:func:`level_resolutions`,
N_{L-1} exactly N_max) and a table of ``min((N_l + 1)^3, T)`` entries: a
level whose lattice fits is dense (index ``i + j (N + 1) + k (N + 1)^2``),
the others hashed (``(i * 1 ^ j * 2654435761 ^ k * 805459861) mod T`` in
32-bit arithmetic).  Every level's table is one block of one ``[E, F]``
float32 parameter, in level order (:class:`HashGrid` gives the offsets).

A point is mapped from ``[bound_min, bound_max]^3`` into ``[0, 1]^3`` and
clamped there; level l interpolates trilinearly over the 8 corners of the
cell at ``x N_l`` (cell index clamped to ``N_l - 1``, so a point on the
box's upper face takes the last cell's far corner); the levels'
features, each scaled by its gate (:func:`level_gate`), are concatenated
level by level into ``[P, L F]``.

:func:`hash_encode` computes it: on CUDA tensors the hand-written kernels
of ``ops/cuda/hashgrid.py`` (forward and backward), on the CPU
:func:`hash_encode_plain`, plain PyTorch whose autograd gives the
table's gradient (a scatter-add) and the points' (for the cameras).
Each call adds one to the tracer's counter ``hashgrid.kernel`` or
``hashgrid.plain`` and its points to ``hashgrid.points`` (under a CUDA
graph, at the capture).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from mc_nerf_torch.config import NerfConfig
from mc_nerf_torch.models.encoding import barf_weights
from mc_nerf_torch.utils import trace

# the spatial hash's primes, one an axis (section 3 of the paper)
PRIMES = (1, 2654435761, 805459861)
# F, the features a level (the paper's Table 1): the kernels read an
# entry as one float2
FEATURES = 2


class HashGrid(NamedTuple):
    """The level geometry: each level's resolution, its table's first row
    in the parameter, its number of rows, and whether it is hashed."""

    res: Tuple[int, ...]
    offsets: Tuple[int, ...]
    sizes: Tuple[int, ...]
    hashed: Tuple[bool, ...]
    table_size: int           # T

    @property
    def features(self) -> int:
        return FEATURES

    @property
    def levels(self) -> int:
        return len(self.res)

    @property
    def entries(self) -> int:
        return self.offsets[-1] + self.sizes[-1]

    @property
    def out_dim(self) -> int:
        return self.levels * self.features


def level_resolutions(levels: int, base: int, finest: int) -> Tuple[int, ...]:
    """``floor(base * b^l)``, ``b = (finest / base)^(1 / (levels - 1))``,
    in float64; the last level is ``finest`` exactly (its product can fall
    a rounding below it)."""
    if levels == 1:
        return (base,)
    growth = math.log(finest / base) / (levels - 1)
    res = [int(math.floor(base * math.exp(l * growth) + 1e-9)) for l in range(levels)]
    res[-1] = finest
    return tuple(res)


def hash_grid(cfg: NerfConfig) -> HashGrid:
    """The level geometry of ``cfg``'s hash keys."""
    t = 1 << cfg.hash_log2_size
    res = level_resolutions(cfg.hash_levels, cfg.hash_base_res, cfg.hash_max_res)
    sizes = [min((n + 1) ** 3, t) for n in res]
    hashed = [(n + 1) ** 3 > t for n in res]
    offsets = [0]
    for n in sizes[:-1]:
        offsets.append(offsets[-1] + n)
    return HashGrid(res, tuple(offsets), tuple(sizes), tuple(hashed), t)


def level_gate(cfg: NerfConfig, step_r, barf_window: Tuple[float, float]) -> torch.Tensor:
    """[L] float32: level l weighted as the BARF gate weights octave l
    (``barf_weights`` with n = L), a departure from Instant-NGP, which has
    no coarse-to-fine gate: MC-NeRF's joint camera stage needs one."""
    return barf_weights(cfg.hash_levels, step_r, *barf_window)


def corner_index(grid: HashGrid, level: int, cell: torch.Tensor) -> torch.Tensor:
    """The table rows (offset included) of integer lattice corners
    ``cell`` [..., 3] (int64) at ``level``."""
    i, j, k = cell.unbind(-1)
    if grid.hashed[level]:
        h = (i * PRIMES[0]) ^ (j * PRIMES[1]) ^ (k * PRIMES[2])
        idx = h & (grid.table_size - 1)
    else:
        n1 = grid.res[level] + 1
        idx = i + j * n1 + k * n1 * n1
    return idx + grid.offsets[level]


def unit_coords(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """World points [..., 3] -> the box's [0, 1]^3, clamped (a point outside
    the box reads the face's features and passes no gradient on).  The
    scale is a product with the float32 ``1 / (hi - lo)``, which the
    kernels and the card's own division by a scalar compute alike: a
    point's cell, where d/dx jumps, is then the same on every route."""
    return torch.clamp((x - lo) * (1.0 / (hi - lo)), 0.0, 1.0)


def hash_encode_plain(x: torch.Tensor, table: torch.Tensor, gate: Optional[torch.Tensor],
                      grid: HashGrid, lo: float, hi: float) -> torch.Tensor:
    """The encode in plain PyTorch, float32: points [P, 3], the table
    [E, F], the level gate [L] or None (all levels on) -> features
    [P, L F].  Differentiable in ``x`` and ``table``.  The CPU route and
    the kernels' oracle."""
    u = unit_coords(x.float(), lo, hi)
    bits = torch.tensor([[(c >> d) & 1 for d in range(3)] for c in range(8)],
                        device=x.device)                                  # [8, 3]
    out = []
    for level, n in enumerate(grid.res):
        pos = u * n
        cell = torch.clamp(torch.floor(pos.detach()), max=n - 1)
        frac = pos - cell                                                 # [P, 3]
        corners = cell.long()[:, None, :] + bits                          # [P, 8, 3]
        w = torch.where(bits.bool(), frac[:, None, :], 1.0 - frac[:, None, :])
        w = w[..., 0] * w[..., 1] * w[..., 2]                             # [P, 8]
        vals = table[corner_index(grid, level, corners)]                  # [P, 8, F]
        f = (w[..., None] * vals).sum(1)
        out.append(f if gate is None else f * gate[level])
    return torch.cat(out, dim=-1)


def hash_encode(x: torch.Tensor, table: torch.Tensor, gate: Optional[torch.Tensor],
                grid: HashGrid, lo: float, hi: float) -> torch.Tensor:
    """:func:`hash_encode_plain`'s features within rounding: on CUDA
    tensors the hand-written kernels (``ops/cuda/hashgrid.py``; bf16
    features for the MLPs, the table's gradient by fp32 atomics, the
    points' gradient), on the CPU the plain body (float32).  Counted in
    the tracer (see the module)."""
    trace.count("hashgrid.points", x.shape[0])
    if x.is_cuda:
        from mc_nerf_torch.ops.cuda.hashgrid import hash_encode_cuda

        trace.count("hashgrid.kernel")
        return hash_encode_cuda(x, table, gate, grid, lo, hi)
    trace.count("hashgrid.plain")
    return hash_encode_plain(x, table, gate, grid, lo, hi)
