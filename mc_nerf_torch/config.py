"""Configuration for the PyTorch port: the fields the ported code reads.

An own copy of ``mc_nerf_tpu/config.py``'s ``StageConfig``, ``TrainConfig``,
``BarfConfig``, ``NerfConfig`` and ``EvalConfig`` with the same defaults,
cut to the fields the ported code reads (the render, the training step
and both fine modes).  Later slices add their fields with their code:
``occ_pmf`` with the density PMF, ``coarse_free`` with the coarse-free
branch, the engine's schedule fields and the yaml loader.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class StageConfig:
    """Three-stage training sequence (ref ``config/config.yaml:13-19``)."""

    cam_param_epochs: int = 20      # stage 1: camera parameter initialization
    global_opt_epochs: int = 16     # stage 2: joint camera + NeRF optimization
    fine_tune_epochs: int = 16      # stage 3: NeRF fine-tune, poses frozen

    @property
    def total_epochs(self) -> int:
        return self.cam_param_epochs + self.global_opt_epochs + self.fine_tune_epochs


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization hyper-parameters (ref ``config/config.yaml:20-30``)."""

    stage1_lr: float = 0.1
    stage2_lr: float = 5e-4
    stage3_lr: float = 2.5e-4
    # stage-1 LR decays exponentially to this floor over the stage
    # (ref ``main.py:188-189``)
    stage1_lr_floor: float = 0.005
    weight_decay: float = 4e-4
    # global gradient-norm clip in every stage (0 disables: the reference
    # never clips)
    grad_clip: float = 10.0
    rays_per_batch: int = 7000       # rays sampled from one image per step (ref yaml `batch`)
    seed: int = 42
    # "importance": stratified inverse-CDF fine sampling; "grid": the
    # reference-faithful threshold / top-k bins of the fine grid
    fine_mode: str = "importance"
    importance_samples: int = 32     # fine samples/ray for fine_mode="importance"
    # recompute the encode -> MLP -> shade passes in the backward instead of
    # keeping their activations (torch.utils.checkpoint)
    remat_shade: bool = False
    # the render route of the train step: None or True = the hand-written
    # kernels (fused_render, or fused_shaded_mlp in grid mode, forward and
    # backward), False = plain PyTorch
    use_pallas: Optional[bool] = None


@dataclasses.dataclass(frozen=True)
class BarfConfig:
    """BARF coarse-to-fine frequency schedule (ref ``config/config.yaml:56-61``);
    ``start``/``end`` parameterize the ramp within stage 2."""

    start: float = 0.0
    end: float = 1.0

    def global_window(self, stages: StageConfig) -> Tuple[float, float]:
        """(start, end) in global training progress (ref
        ``data/data_read.py:338-351``): the ramp begins where stage 2
        begins and spans ``end`` of stage 2's extent."""
        total = float(stages.total_epochs)
        g_start = stages.cam_param_epochs / total + self.start
        g_end_raw = (stages.cam_param_epochs + stages.global_opt_epochs) / total
        return g_start, g_start + (g_end_raw - g_start) * self.end


@dataclasses.dataclass(frozen=True)
class NerfConfig:
    """NeRF model/rendering parameters (ref ``config/config.yaml:62-82``)."""

    near: float = 1.0
    far: float = 8.0
    samples_coarse: int = 128        # uniform coarse samples/ray (no culling)
    sample_scale: int = 5            # fine grid = samples_coarse * sample_scale
    sigma_default: float = -20.0     # raw sigma assigned to unselected fine samples
    weight_thresh: float = 1e-3      # coarse-weight threshold for fine selection
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
    # grid fine mode: a static per-ray budget of fine_bins_topk coarse bins
    # x sample_scale fine samples (the reference caps the total at rays*128)
    fine_bins_topk: int = 26

    # occupancy-grid sample culling (ops/occupancy.py; importance mode only)
    occ_grid_size: int = 64          # lattice resolution G (0 disables culling)
    occ_thresh: float = 0.01         # occupied iff softplus(sigma)*coarse_step > this
    occ_decay: float = 0.95          # EMA-max decay per refresh
    occ_floor: float = 0.01          # exploration floor in the sampling PMF
    occ_probes: int = 64             # per-ray occupancy probes across [near, far]
    occ_coarse_samples: int = 48     # coarse samples/ray under culling
    occ_dilate: bool = True          # 3^3 max-pool safety margin
    occ_map_dtype: str = "bfloat16"  # "bfloat16" | "int8" ("bitpack" not ported yet)

    @property
    def samples_fine_grid(self) -> int:
        return self.samples_coarse * self.sample_scale

    @property
    def samples_fine(self) -> int:
        """Static number of fine samples evaluated per ray in grid mode."""
        return self.fine_bins_topk * self.sample_scale

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
    fine_mode: str = "importance"    # "importance" | "grid" (reference-faithful)
    importance_samples: int = 32     # fine samples/ray for fine_mode="importance"
    use_pallas: Optional[bool] = None  # kernel route; None = the kernel route


@dataclasses.dataclass(frozen=True)
class Config:
    data_name: str = "Ball_Computer"
    stages: StageConfig = dataclasses.field(default_factory=StageConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    barf: BarfConfig = dataclasses.field(default_factory=BarfConfig)
    nerf: NerfConfig = dataclasses.field(default_factory=NerfConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
    # numeric policy of the plain route: params fp32, activations in this dtype
    compute_dtype: str = "bfloat16"
