"""Configuration for the PyTorch port and its yaml loader (own copy of
``mc_nerf_tpu/config.py``).

The dataclasses carry the JAX config's fields with the same defaults, cut
to the fields the ported code reads or the loader sets (``barf_mask``,
``grid_nerf`` and ``sigma_init``, which the JAX package accepts and never
reads, are not carried).  :func:`load_yaml`
reads the reference's ``config.yaml`` schema with the port's own reader
(:mod:`mc_nerf_torch.yaml_subset`, no PyYAML), and :func:`build_argparser`
/ :func:`from_args` give the reference's CLI flags.  Every key the JAX
loader reads is applied but ``max_steps_per_program`` and ``prng_impl``
(XLA's program size, JAX's PRNG), which are logged and not applied.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
from pathlib import Path
from typing import Optional, Tuple

from mc_nerf_torch.yaml_subset import loads as _yaml_loads


@dataclasses.dataclass(frozen=True)
class StageConfig:
    """Three-stage training sequence (ref ``config/config.yaml:13-19``)."""

    cam_param_epochs: int = 20      # stage 1: camera parameter initialization
    global_opt_epochs: int = 16     # stage 2: joint camera + NeRF optimization
    fine_tune_epochs: int = 16      # stage 3: NeRF fine-tune, poses frozen

    @property
    def total_epochs(self) -> int:
        return self.cam_param_epochs + self.global_opt_epochs + self.fine_tune_epochs

    @property
    def boundaries(self) -> Tuple[int, int, int]:
        """Cumulative epoch boundaries of the three stages."""
        s1 = self.cam_param_epochs
        s2 = s1 + self.global_opt_epochs
        return (s1, s2, s2 + self.fine_tune_epochs)

    def stage_of_epoch(self, epoch: int) -> int:
        """0-based stage of a 0-based epoch (ref ``main.py:210-217``)."""
        b1, b2, b3 = self.boundaries
        if epoch < b1:
            return 0
        if epoch < b2:
            return 1
        if epoch < b3:
            return 2
        raise ValueError(f"epoch {epoch} beyond training schedule ({b3} epochs)")


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
    # checkpoint retention: the newest N epochs plus the three stage
    # boundaries; 0 keeps every epoch (the reference's behaviour)
    ckpt_max_keep: int = 5
    warmup_epoch: int = 100          # carried from the reference yaml (unused there too)
    rays_per_batch: int = 7000       # rays sampled from one image per step (ref yaml `batch`)
    images_per_batch: int = 1        # images per step (ref: 1 via BatchSampler)
    steps_per_image_epoch: int = 50  # ref expands the dataset 50x (data_read.py:286-297)
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
    occ_update_every: int = 1        # epochs between grid refreshes (stages 2-3)
    # NeRF-stage steps before the first refresh; until then the
    # all-occupied prior (uniform sampling): a grid from a barely trained
    # coarse MLP mislocalizes the culling
    occ_warmup_steps: int = 3000
    occ_floor: float = 0.01          # exploration floor in the sampling PMF
    occ_probes: int = 64             # per-ray occupancy probes across [near, far]
    occ_coarse_samples: int = 48     # coarse samples/ray under culling
    occ_dilate: bool = True          # 3^3 max-pool safety margin
    # layout of the binary map: "bfloat16" / "int8" (one cell a lane) or
    # "bitpack" (32 z cells a 32-bit word)
    occ_map_dtype: str = "bfloat16"
    # coarse-free rendering: the fine depths come straight from the
    # occupancy PMF and the coarse pass is skipped (train and eval); the
    # coarse MLP stops training and the rgb_c loss term drops.  Needs
    # occ_grid_size > 0 and fine_mode="importance"
    coarse_free: bool = False
    # first NeRF stage that runs coarse-free: 1 = GLOBAL_OPTIM (all NeRF
    # training), 2 = FINE_TUNE only (the hybrid schedule)
    coarse_free_from_stage: int = 1
    # sampling PMF: "binary" (occupancy + floor) or "density" (T * alpha
    # of the probed EMA density; needs occ_map_dtype="bfloat16"; refused
    # for training unless allow_measured_harmful)
    occ_pmf: str = "binary"
    # the MLP the refresh probes in coarse-free stages: "coarse", "fine",
    # or "auto" (coarse when a trained coarse exists, i.e. the hybrid)
    occ_refresh_source: str = "auto"
    # coarse-free training: this many of the K fine samples are stratified
    # uniform over [near, far] instead of PMF draws (0 disables)
    cf_uniform_samples: int = 0
    # lifts the engine's refusal of the training configurations measured
    # to collapse (coarse-free from stage 1, the density PMF)
    allow_measured_harmful: bool = False

    def coarse_free_at(self, stage: int) -> bool:
        """Is the renderer coarse-free at this engine stage (0 = CAM_PARAM,
        1 = GLOBAL_OPTIM, 2 = FINE_TUNE)?  Eval follows
        :attr:`Config.eval_coarse_free`."""
        return self.coarse_free and stage >= self.coarse_free_from_stage

    def refresh_source(self, stage: int) -> str:
        """The MLP ("coarse" / "fine") the occupancy refresh probes at this
        stage: the coarse in two-pass stages, ``occ_refresh_source`` in
        coarse-free ones ("auto": the coarse under the hybrid schedule,
        else the fine, the only one that trains)."""
        if not self.coarse_free_at(stage):
            return "coarse"
        if self.occ_refresh_source != "auto":
            return self.occ_refresh_source
        return "fine" if self.coarse_free_from_stage == 1 else "coarse"

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

    res_h: int = 800
    res_w: int = 800
    demo_ckpt: str = ""              # epoch number or ``...-EPOCH-<n>-...`` name; "" = latest
    rays_per_chunk: int = 16384      # rays per render chunk
    fine_mode: str = "importance"    # "importance" | "grid" (reference-faithful)
    importance_samples: int = 32     # fine samples/ray for fine_mode="importance"
    use_pallas: Optional[bool] = None  # kernel route; None = the kernel route
    # coarse-free eval override: None follows nerf.coarse_free; False
    # renders a coarse-free-trained model two-pass; True renders from the
    # occupancy PMF alone (needs occupancy culling)
    coarse_free: Optional[bool] = None


@dataclasses.dataclass(frozen=True)
class PathsConfig:
    """Output directory layout (ref ``config/config.yaml:37-49``)."""

    root_weights: str = "./weights"
    root_out: str = "./results"
    render_subdir: str = "./img_rendered"
    log_path: str = "./log"
    tb_path: str = "./tensorboard"
    tb_delete_old: bool = False

    @property
    def render_dir(self) -> str:
        return os.path.join(self.root_out, self.render_subdir)


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Data parallelism over the ranks ``torchrun`` starts (replaces the
    JAX package's device mesh; ref ``utils/distributed_init.py``)."""

    # ranks on the data axis; 0 = the world size.  A torch process group
    # cannot use fewer ranks than were launched, so any other value must
    # equal it (``parallel/mesh.py::check_data_parallel``)
    data_parallel: int = 0
    mesh_axis: str = "data"


@dataclasses.dataclass(frozen=True)
class Config:
    data_root: str = "./data/dataset_Ball"
    data_name: str = "Ball_Computer"
    mode: int = 0                    # 0 = train, 1 = demo (ref config_read.py:78-81)
    log_to_file: bool = False
    tensorboard: bool = False
    start_device: int = 0            # CUDA index of the card (ref --start_device)
    apriltag_size: float = 1.0
    stages: StageConfig = dataclasses.field(default_factory=StageConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    barf: BarfConfig = dataclasses.field(default_factory=BarfConfig)
    nerf: NerfConfig = dataclasses.field(default_factory=NerfConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
    paths: PathsConfig = dataclasses.field(default_factory=PathsConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)
    # numeric policy of the plain route: params fp32, activations in this dtype
    compute_dtype: str = "bfloat16"

    @property
    def scene_dir(self) -> str:
        """<data_root>/<data_name>, the directory holding transforms_*.json."""
        return os.path.join(self.data_root, self.data_name)

    @property
    def eval_coarse_free(self) -> bool:
        """Whether eval and demo renders are coarse-free (``eval.coarse_free``
        if set, else ``nerf.coarse_free``)."""
        ecf = self.eval.coarse_free
        return self.nerf.coarse_free if ecf is None else ecf

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


# yaml keys of the JAX package's XLA program size and PRNG: read, not
# applied (the port's compiled step is one CUDA graph of one step,
# replayed once a step: there is no program of many steps to bound)
_NOT_APPLIED = (("system", "train_params", "max_steps_per_program"),
                ("system", "train_params", "prng_impl"))


def _get(d, *keys, default=None):
    for k in keys:
        if not isinstance(d, dict) or k not in d:
            return default
        d = d[k]
    return d


def _log_not_applied(raw: dict) -> None:
    """Log each key that is read and not applied."""
    for path in _NOT_APPLIED:
        if _get(raw, *path) is not None:
            logging.warning("config key %s is not applied: it sizes the JAX package's XLA "
                            "programs or picks its PRNG, which the port does not have",
                            ".".join(path))


def load_yaml(path: str, base: Optional[Config] = None) -> Config:
    """A :class:`Config` from a reference-format ``config.yaml`` (the
    reference's schema plus the JAX package's extension keys); missing keys
    keep ``base``'s values (the defaults)."""
    cfg = base or Config()
    with open(path, "r", encoding="utf-8") as f:
        raw = _yaml_loads(f.read()) or {}
    _log_not_applied(raw)
    sys_info = raw.get("system", {})
    model = raw.get("model", {})
    get = _get

    stages = StageConfig(
        cam_param_epochs=get(sys_info, "epoch", "cam_param_stage", default=cfg.stages.cam_param_epochs),
        global_opt_epochs=get(sys_info, "epoch", "global_opt_stage", default=cfg.stages.global_opt_epochs),
        fine_tune_epochs=get(sys_info, "epoch", "fine_tune_stage", default=cfg.stages.fine_tune_epochs),
    )
    tp = lambda key, default: get(sys_info, "train_params", key, default=default)
    train = dataclasses.replace(
        cfg.train,
        stage1_lr=tp("stage_1_lr", cfg.train.stage1_lr),
        stage2_lr=tp("stage_2_lr", cfg.train.stage2_lr),
        stage3_lr=tp("stage_3_lr", cfg.train.stage3_lr),
        weight_decay=tp("weight_decay", cfg.train.weight_decay),
        warmup_epoch=tp("warmup_epoch", cfg.train.warmup_epoch),
        rays_per_batch=tp("batch", cfg.train.rays_per_batch),
        seed=get(sys_info, "data", "seed", default=cfg.train.seed),
        # extension keys (not in the reference schema)
        fine_mode=tp("fine_mode", cfg.train.fine_mode),
        importance_samples=tp("importance_samples", cfg.train.importance_samples),
        remat_shade=tp("remat_shade", cfg.train.remat_shade),
        use_pallas=tp("use_pallas", cfg.train.use_pallas),
        grad_clip=tp("grad_clip", cfg.train.grad_clip),
        ckpt_max_keep=tp("ckpt_max_keep", cfg.train.ckpt_max_keep),
    )
    barf = BarfConfig(
        start=get(model, "barf", "barf_start", default=cfg.barf.start),
        end=get(model, "barf", "barf_end", default=cfg.barf.end),
    )
    nf = lambda key, default: get(model, "nerf", key, default=default)
    n = cfg.nerf
    nerf = dataclasses.replace(
        n,
        near=nf("near", n.near),
        far=nf("far", n.far),
        samples_coarse=nf("samples", n.samples_coarse),
        sample_scale=nf("sample_scale", n.sample_scale),
        sigma_default=nf("sigma_default", n.sigma_default),
        weight_thresh=nf("weight_thresh", n.weight_thresh),
        bound_min=nf("global_boader_min", n.bound_min),
        bound_max=nf("global_boader_max", n.bound_max),
        white_back=nf("white_back", n.white_back),
        emb_freqs_xyz=nf("emb_freqs_xyz", n.emb_freqs_xyz),
        coarse_depth=nf("coarse_MLP_depth", n.coarse_depth),
        coarse_width=nf("coarse_MLP_width", n.coarse_width),
        coarse_skips=tuple(nf("coarse_MLP_skip", list(n.coarse_skips))),
        fine_depth=nf("fine_MLP_depth", n.fine_depth),
        fine_width=nf("fine_MLP_width", n.fine_width),
        fine_skips=tuple(nf("fine_MLP_skip", list(n.fine_skips))),
        sh_deg=nf("MLP_deg", n.sh_deg),
        # extension keys (not in the reference schema): occupancy culling
        occ_grid_size=nf("occ_grid_size", n.occ_grid_size),
        occ_thresh=nf("occ_thresh", n.occ_thresh),
        occ_decay=nf("occ_decay", n.occ_decay),
        occ_update_every=nf("occ_update_every", n.occ_update_every),
        occ_warmup_steps=nf("occ_warmup_steps", n.occ_warmup_steps),
        occ_floor=nf("occ_floor", n.occ_floor),
        occ_probes=nf("occ_probes", n.occ_probes),
        occ_coarse_samples=nf("occ_coarse_samples", n.occ_coarse_samples),
        occ_dilate=nf("occ_dilate", n.occ_dilate),
        occ_map_dtype=nf("occ_map_dtype", n.occ_map_dtype),
        coarse_free=nf("coarse_free", n.coarse_free),
        occ_pmf=nf("occ_pmf", n.occ_pmf),
        coarse_free_from_stage=nf("coarse_free_from_stage", n.coarse_free_from_stage),
        occ_refresh_source=nf("occ_refresh_source", n.occ_refresh_source),
        cf_uniform_samples=nf("cf_uniform_samples", n.cf_uniform_samples),
        allow_measured_harmful=nf("allow_measured_harmful", n.allow_measured_harmful),
    )
    tst = lambda key, default: get(sys_info, "test_params", key, default=default)
    evalc = dataclasses.replace(
        cfg.eval,
        res_h=tst("resolution_h", cfg.eval.res_h),
        res_w=tst("resolution_w", cfg.eval.res_w),
        demo_ckpt=tst("nerf_model_name", cfg.eval.demo_ckpt),
        # extension keys (not in the reference schema)
        fine_mode=tst("fine_mode", cfg.eval.fine_mode),
        importance_samples=tst("importance_samples", cfg.eval.importance_samples),
        rays_per_chunk=tst("rays_per_chunk", cfg.eval.rays_per_chunk),
        use_pallas=tst("use_pallas", cfg.eval.use_pallas),
        coarse_free=tst("coarse_free", cfg.eval.coarse_free),
    )
    paths = dataclasses.replace(
        cfg.paths,
        root_weights=get(sys_info, "weights_params", "root_weights", default=cfg.paths.root_weights),
        root_out=get(sys_info, "out_params", "root_out", default=cfg.paths.root_out),
        render_subdir=get(sys_info, "out_params", "test_enerf_pth", default=cfg.paths.render_subdir),
        log_path=get(sys_info, "log_params", "logpath", default=cfg.paths.log_path),
        tb_path=get(sys_info, "tensorboard_params", "tb_pth", default=cfg.paths.tb_path),
        tb_delete_old=get(sys_info, "tensorboard_params", "del_mode", default=cfg.paths.tb_delete_old),
    )
    return dataclasses.replace(
        cfg,
        apriltag_size=get(sys_info, "apriltag", "tag_size", default=cfg.apriltag_size),
        stages=stages, train=train, barf=barf, nerf=nerf, eval=evalc, paths=paths,
    )


def build_argparser() -> argparse.ArgumentParser:
    """The reference's CLI flags (ref ``main.py:245-268``), as the JAX
    package gives them."""
    p = argparse.ArgumentParser(description="MC-NeRF-TPU")
    p.add_argument("--config", type=str, default="./config",
                   help="root path of config file (directory containing config.yaml)")
    p.add_argument("--root_data", type=str, default="./data/dataset_Ball",
                   help="root path of data")
    p.add_argument("--data_name", type=str, default="Ball_Computer",
                   help="name of data")
    p.add_argument("--demo", action="store_true",
                   help="nerf rendering forward with test mode")
    p.add_argument("--train", action="store_true", help="train mode")
    p.add_argument("--log", action="store_true",
                   help="save log information to a log file")
    p.add_argument("--start_device", type=int, default=0,
                   help="start device index (CLI parity with the reference; no-op on TPU)")
    p.add_argument("--tensorboard", action="store_true",
                   help="write tensorboard scalars during training")
    return p


def from_args(args: argparse.Namespace) -> Config:
    """Merge CLI args with ``<args.config>/config.yaml``, or with
    ``Config()`` where there is none (ref ``config/config_read.py:8-93``)."""
    yaml_path = os.path.join(Path(args.config), Path("config.yaml"))
    cfg = load_yaml(yaml_path) if os.path.exists(yaml_path) else Config()
    return cfg.replace(
        data_root=args.root_data,
        data_name=args.data_name,
        mode=1 if args.demo and not args.train else 0,
        log_to_file=args.log,
        tensorboard=args.tensorboard,
        start_device=args.start_device,
    )
