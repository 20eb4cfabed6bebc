"""Configuration for the PyTorch port: the fields the render path reads.

An own copy of ``mc_nerf_tpu/config.py``'s ``NerfConfig`` and ``EvalConfig``
with the same defaults, cut to the fields the ported code reads, and a
``Config`` holding the fields the demo render reads.  Later slices add
their fields with their code: ``fine_mode`` with the grid fine mode,
``occ_pmf`` with the density PMF, ``coarse_free`` with the coarse-free
branch, and the training and yaml-loader fields.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class NerfConfig:
    """NeRF model/rendering parameters (ref ``config/config.yaml:62-82``)."""

    near: float = 1.0
    far: float = 8.0
    samples_coarse: int = 128        # uniform coarse samples/ray (no culling)
    bound_min: float = -3.5
    bound_max: float = 3.5
    white_back: bool = True
    emb_freqs_xyz: int = 10
    coarse_depth: int = 4
    coarse_width: int = 128
    coarse_skips: Tuple[int, ...] = (2,)
    fine_depth: int = 8
    fine_width: int = 256
    fine_skips: Tuple[int, ...] = (4,)
    sh_deg: int = 2

    # occupancy-grid sample culling (ops/occupancy.py)
    occ_grid_size: int = 64          # lattice resolution G (0 disables culling)
    occ_thresh: float = 0.01         # occupied iff softplus(sigma)*coarse_step > this
    occ_decay: float = 0.95          # EMA-max decay per refresh
    occ_floor: float = 0.01          # exploration floor in the sampling PMF
    occ_probes: int = 64             # per-ray occupancy probes across [near, far]
    occ_coarse_samples: int = 48     # coarse samples/ray under culling
    occ_dilate: bool = True          # 3^3 max-pool safety margin
    occ_map_dtype: str = "bfloat16"  # "bfloat16" | "int8" ("bitpack" not ported yet)

    @property
    def sh_dim(self) -> int:
        return 3 * (self.sh_deg + 1) ** 2

    @property
    def embed_dim(self) -> int:
        return 3 * (2 * self.emb_freqs_xyz + 1)


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Demo/eval parameters (ref ``config/config.yaml:31-36``)."""

    rays_per_chunk: int = 16384      # rays per render chunk
    importance_samples: int = 32     # fine samples/ray
    use_pallas: Optional[bool] = None  # kernel route; None = the kernel route


@dataclasses.dataclass(frozen=True)
class Config:
    data_name: str = "Ball_Computer"
    # seeds the occupancy lattice jitter of the demo's grid refresh
    # (``TrainConfig.seed`` in the JAX package)
    seed: int = 42
    nerf: NerfConfig = dataclasses.field(default_factory=NerfConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
    # numeric policy of the plain route: params fp32, activations in this dtype
    compute_dtype: str = "bfloat16"
