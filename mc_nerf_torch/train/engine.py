"""The training and eval engine: host-level orchestration (counterpart of
``mc_nerf_tpu/train/engine.py``).

:class:`Engine` runs the reference's three-stage protocol (``main.py:27-241``):
CAM_PARAM epochs with camera restarts between them, then GLOBAL_OPTIM and
FINE_TUNE epochs with the occupancy grid refreshed from the coarse MLP,
or in coarse-free stages from the MLP ``NerfConfig.refresh_source`` names
(the first refresh after ``occ_warmup_steps`` of NeRF training, EMA-max
after it); a checkpoint, a camera-error report and (stages 1-2) one
validation view every epoch; and the demo, which restores a checkpoint
and scores every test view through :func:`demo` (PSNR, SSIM, and LPIPS
where a weights file is found).  The coarse-free modes and the density
PMF are checked as the JAX engine checks them, training configurations
measured to collapse refused unless ``allow_measured_harmful``.  An
epoch is ``train/steps.py``'s :class:`StageEpoch` of its stage: on the
card, with one process or over NCCL ranks, each stage's step captured
once as a CUDA graph (over NCCL its collectives in it) and replayed once
a step; on the CPU or over gloo ranks, the same step as a loop.  Its
draws come from the engine's one generator on the device, reseeded from
``(train.seed, epoch)`` every epoch, so a resumed run draws what an
uninterrupted one does.  What a captured step reads stays in its
buffers: the train data is made once, the occupancy map is refreshed,
the cameras restarted and a checkpoint restored in place.  A frame
(validation, the demo) goes through ``train/steps.py``'s
:class:`FrameRender` of its size, which the engine keeps: on the card one
CUDA graph a map kind, replayed once a frame; on the CPU the chunk loop
(:meth:`Engine.close` drops the step and frame graphs).

A scene without a detection cache (a reference-format scene: calib and
coord images only) gets one from the tag36h11 detector before training.
Each camera table also writes the GT-vs-estimated pose plot.  As in the
JAX package, and unlike the reference: each demo view is scored against
its own ground truth, means divide by the view count, training resumes
from any checkpoint, scalars are written.

Under ``torchrun`` (``parallel/``), with one process per card: each rank
trains on its block of the global batch (``images_per_batch`` x the world
size; steps per epoch and rays/s count it), rank 0 builds the detection
cache while the others wait, writes every checkpoint and prunes them, and
alone reports cameras, scores validation and writes TensorBoard; every
rank refreshes the occupancy map from the same parameters, restores a
resume and ends ``train`` at a barrier, so a demo or resume launched
after it sees the last checkpoint.  Every frame (validation, the demo) is
split over the ranks, as the JAX engine splits it over its render mesh:
each rank renders its block of every chunk and the frame is gathered on
every rank (``FrameRender`` with the engine's world size), so every rank
renders every validation and demo view; one rank scores and writes each
(:func:`demo`).
"""

from __future__ import annotations

import logging
import os
import re
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from mc_nerf_torch import compute_dtype as _dtype
from mc_nerf_torch import resolve_device
from mc_nerf_torch.cameras.convention import w2c_to_blender_pose
from mc_nerf_torch.config import Config
from mc_nerf_torch.data.blender import SplitData, load_scene, load_split
from mc_nerf_torch.data.calibration import build_calibration_cache, load_calibration
from mc_nerf_torch.eval.metrics import lpips, psnr, ssim
from mc_nerf_torch.models.camera_params import camera_poses, init_camera_params, intrinsics
from mc_nerf_torch.models.encoding import sincos_encode
from mc_nerf_torch.models.nerf import NerfParams, init_nerf_params
from mc_nerf_torch.ops.occupancy import (
    OccupancyGrid,
    sampler_map,
    uniform_prior_map,
    update_grid,
)
from mc_nerf_torch.parallel.mesh import (
    all_reduce_sum_,
    barrier,
    broadcast_,
    check_data_parallel,
    rank,
    world_size,
)
from mc_nerf_torch.train.checkpoint import Checkpointer
from mc_nerf_torch.train.optim import Params, build_optimizers, counter, flatten_params
from mc_nerf_torch.train.restarts import improve_cameras
from mc_nerf_torch.train.steps import (
    FrameRender,
    StageEpoch,
    TrainData,
    TrainState,
    make_render_fn,
    make_stage_epoch,
)
from mc_nerf_torch.utils.logging import is_main_process, setup_logging
from mc_nerf_torch.utils.tensorboard import ScalarWriter
from mc_nerf_torch.utils.visualization import (
    CAMERA_TABLE_HEADERS,
    apply_depth_colormap,
    camera_error_row,
    camera_error_table,
    save_pose_plot,
)

STAGE_NAMES = ("CAM_PARAM_EPOCH", "GLOBAL_OPTIM_EPOCH", "FINE_TUNE_EPOCH")


def fold_seed(*words: int) -> int:
    """One 63-bit generator seed from several integers (the counterpart of
    ``jax.random.fold_in``)."""
    state = np.random.SeedSequence([w & 0xFFFFFFFFFFFFFFFF for w in words])
    return int(state.generate_state(1, np.uint64)[0]) & 0x7FFFFFFFFFFFFFFF


def refresh_jitter(cfg: Config, epoch: int, device) -> torch.Tensor:
    """[G^3, 3] U[0, 1) jitter of the lattice points within their cells
    for ``epoch``'s refresh, drawn from a generator seeded by
    ``(train.seed ^ 0x0CC, epoch)``: successive refreshes see other points
    of each cell, so the EMA-max sweeps each cell's volume."""
    g = cfg.nerf.occ_grid_size
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(fold_seed(cfg.train.seed ^ 0x0CC, epoch))
    return torch.rand((g ** 3, 3), generator=gen, device=dev)


def refresh_grid(nerf_params: NerfParams, cfg: Config, device, epoch: int,
                 grid: Optional[OccupancyGrid] = None, source: str = "coarse") -> OccupancyGrid:
    """The occupancy grid from the ``source`` ("coarse" / "fine") MLP: one
    jittered lattice evaluation (:func:`refresh_jitter`), fresh when
    ``grid`` is None, else the EMA-max into it.  Plain PyTorch in
    ``cfg.compute_dtype`` (the JAX package leaves it to XLA)."""
    nc = cfg.nerf
    cd = _dtype(cfg.compute_dtype)
    mlp = {"coarse": nerf_params.coarse, "fine": nerf_params.fine}[source]

    @torch.no_grad()
    def act(pts):
        sigma, _ = mlp(sincos_encode(pts, nc.emb_freqs_xyz, None), cd, sigma_only=True)
        return F.softplus(sigma.reshape(-1))

    return update_grid(grid, act, nc.occ_grid_size, nc.bound_min, nc.bound_max,
                       uniforms=refresh_jitter(cfg, epoch, device), decay=nc.occ_decay,
                       device=device)


def refresh_occupancy(nerf_params: NerfParams, cfg: Config, device, epoch: int,
                      source: str = "coarse") -> torch.Tensor:
    """A fresh sampler map (``sampler_map``) of :func:`refresh_grid`."""
    return sampler_map(refresh_grid(nerf_params, cfg, device, epoch, None, source), cfg.nerf)


def demo(nerf_params: NerfParams, test_split: SplitData, cfg: Config,
         device=None, cull: bool = True, out_dir: Optional[str] = None, epoch: int = 0,
         render: Optional[FrameRender] = None, occ: Optional[torch.Tensor] = None) -> dict:
    """Render every test view with its camera and score it.

    ``occ``, where given, is the sampler map the views render with.
    Otherwise, with ``cull`` (and occupancy enabled in ``cfg``, in the
    importance fine mode: the grid mode stays unculled, as
    ``Engine._occ_eval`` has it) the sampler map is rebuilt fresh first,
    with ``epoch``'s jitter, from the MLP ``cfg.nerf.refresh_source`` names
    for ``epoch``'s stage, and the samples follow it; else the views render
    unculled, or, when the renders are coarse-free
    (``cfg.eval_coarse_free``: the map is the only proposal), from the
    uniform prior.  ``render`` is the renderer of the views' size (an
    engine passes its own, whose graphs its validation shares); None makes
    one (``make_render_fn``).  With ``out_dir`` the pred, depth and gt PNGs
    are written under it.

    Under a process group every rank renders every view, in the same
    order (a frame split over the ranks gathers once; ``render`` None
    splits it over the group, ``world=world_size()``), and the views are
    sharded round robin over the ranks for scoring (the JAX demo's
    ``range(rank, count, world)``): rank ``i % world`` alone scores and
    writes view ``i``, per-view rows ``[psnr, ssim, lpips, lpips_valid]``
    (zeros for the views of other ranks) are summed with one all-reduce,
    so every rank returns the same result and each PNG is written once;
    rank 0 prints it.

    Returns {"psnr", "ssim", "lpips", "count"}: the means over the views;
    LPIPS over the views it scored, None without a weights file.
    """
    dev = resolve_device(device)
    test = test_split
    if render is None:
        render = make_render_fn(cfg, test.img_h, test.img_w, device=dev, world=world_size())
    if occ is None and cfg.nerf.occ_grid_size > 0 and cfg.eval.fine_mode == "importance":
        if cull:
            occ = refresh_occupancy(nerf_params, cfg, dev, epoch,
                                    cfg.nerf.refresh_source(cfg.stages.stage_of_epoch(epoch)))
        elif cfg.eval_coarse_free:
            occ = uniform_prior_map(cfg.nerf, dev)
    dirs = None
    if out_dir is not None:
        dirs = {k: os.path.join(out_dir, k) for k in ("pred", "depth", "gt")}
        for d in dirs.values():
            os.makedirs(d, exist_ok=True)

    per_view = np.zeros((test.count, 4), np.float64)
    for i in range(test.count):
        rgb, depth, opacity = render(nerf_params, test.poses_w2c[i], test.K[i], occ)
        if i % world_size() != rank():
            continue
        gt = torch.as_tensor(test.images_u8[i], device=dev).float() / 255.0
        per_view[i, :2] = float(psnr(rgb, gt)), float(ssim(rgb, gt))
        lp = lpips(rgb, gt)
        if lp is not None:
            per_view[i, 2:] = lp, 1.0
        if dirs is not None:
            _write_pngs(dirs, i, rgb, depth, opacity, gt)
    if world_size() > 1:
        per_view = all_reduce_sum_(torch.as_tensor(per_view, device=dev)).cpu().numpy()
    n_lpips = per_view[:, 3].sum()
    lp = float(per_view[:, 2].sum() / n_lpips) if n_lpips else None
    result = {"psnr": float(per_view[:, 0].mean()), "ssim": float(per_view[:, 1].mean()),
              "lpips": lp, "count": test.count}
    if is_main_process():
        print(f"Results ({cfg.data_name})")
        print(f"PSNR: {result['psnr']}")
        print(f"SSIM: {result['ssim']}")
        print(f"LPIP: {lp if lp is not None else 'n/a (no weights)'}")
    return result


def _to_u8(x: np.ndarray) -> np.ndarray:
    return (np.clip(x, 0, 1) * 255).astype(np.uint8)


def _write_pngs(dirs, i, rgb, depth, opacity, gt) -> None:
    from PIL import Image

    name = str(i).zfill(4)
    Image.fromarray(_to_u8(rgb.cpu().numpy())).save(os.path.join(dirs["pred"], name + ".png"))
    Image.fromarray(_to_u8(gt.cpu().numpy())).save(os.path.join(dirs["gt"], name + "gt.png"))
    # inverse-depth colormap (ref main.py:117-118)
    d, o = depth.cpu().numpy(), opacity.cpu().numpy()
    inv = 1.0 / (d / np.clip(o, 1e-10, None) + 1e-10) * 2
    Image.fromarray((apply_depth_colormap(inv) * 255).astype(np.uint8)).save(
        os.path.join(dirs["depth"], name + "depth.png"))


def _parse_demo_ckpt(name: str) -> Optional[int]:
    """Epoch selector from ``eval.demo_ckpt``: a bare epoch number or a
    reference-style name with an ``EPOCH-<n>`` segment (``config/config.yaml:33``,
    e.g. ``Ball_Computer-EPOCH-51-<ts>.ckpt``); empty or unparseable means
    the latest checkpoint."""
    name = (name or "").strip()
    if not name:
        return None
    if name.isdigit():
        return int(name)
    m = re.search(r"EPOCH-(\d+)", name)
    if m:
        return int(m.group(1))
    logging.warning("demo_ckpt %r has no epoch; using the latest checkpoint", name)
    return None


def check_sampling_modes(cfg: Config) -> None:
    """The JAX engine's checks of the coarse-free modes and the sampling
    PMF (``mc_nerf_tpu/train/engine.py:94-177``), each a ValueError with
    its wording.  The training configurations measured to collapse
    (coarse-free from stage 1, the density PMF) are refused in train mode
    (``cfg.mode == 0``) unless ``nerf.allow_measured_harmful``; the demo
    renders existing checkpoints and is exempt."""
    nc = cfg.nerf
    if nc.coarse_free and (nc.occ_grid_size <= 0 or cfg.train.fine_mode != "importance"
                           or cfg.eval.fine_mode != "importance"):
        raise ValueError(
            "nerf.coarse_free requires occ_grid_size > 0 and fine_mode='importance' for "
            "both train and eval — the occupancy grid is the sole sampling proposal in "
            "this mode")
    if nc.occ_pmf not in ("binary", "density"):
        raise ValueError(f"unknown nerf.occ_pmf: {nc.occ_pmf!r}")
    if nc.coarse_free_from_stage not in (1, 2):
        raise ValueError(
            "nerf.coarse_free_from_stage must be 1 (GLOBAL_OPTIM, all NeRF training) or 2 "
            "(FINE_TUNE only — the hybrid schedule)")
    if nc.occ_pmf == "density" and nc.occ_map_dtype != "bfloat16":
        raise ValueError(
            "nerf.occ_pmf='density' requires occ_map_dtype='bfloat16' — the sampler map "
            "carries density magnitudes, not {0,1}")
    if nc.occ_refresh_source not in ("auto", "coarse", "fine"):
        raise ValueError(f"unknown nerf.occ_refresh_source: {nc.occ_refresh_source!r} "
                         "(auto | coarse | fine)")
    if nc.occ_refresh_source == "coarse" and nc.coarse_free and nc.coarse_free_from_stage == 1:
        raise ValueError(
            "occ_refresh_source='coarse' needs a trained coarse MLP, but "
            "coarse_free_from_stage=1 never trains one — use the hybrid schedule "
            "(coarse_free_from_stage=2) or source 'fine'")
    if cfg.eval.coarse_free and (nc.occ_grid_size <= 0 or cfg.eval.fine_mode != "importance"):
        raise ValueError(
            "eval.coarse_free=True requires occ_grid_size > 0 and eval.fine_mode='importance' "
            "— the occupancy grid is the sampling proposal")
    if cfg.mode == 0 and not nc.allow_measured_harmful:
        if nc.coarse_free and nc.coarse_free_from_stage == 1:
            raise ValueError(
                "nerf.coarse_free with coarse_free_from_stage=1 trains the field from scratch "
                "on the grid PMF alone and collapsed to ~6 PSNR in all five measured takes "
                "(BASELINE.md round 4).  Use the hybrid schedule (coarse_free_from_stage=2), "
                "or set nerf.allow_measured_harmful=True to re-run the experiment anyway")
        if nc.occ_pmf == "density":
            raise ValueError(
                "nerf.occ_pmf='density' is measured HARMFUL for training in every schedule — "
                "concentrated-PMF sampling starves the field of spread empty-space supervision "
                "(FINE_TUNE collapses 12.0 -> 8.1 PSNR, BASELINE.md round 4).  Keep 'binary' "
                "for training, or set nerf.allow_measured_harmful=True to re-run the "
                "experiment anyway")
    if (nc.coarse_free and nc.coarse_free_from_stage == 1 and cfg.eval.coarse_free is False
            and not nc.allow_measured_harmful):
        raise ValueError(
            "eval.coarse_free=False forces two-pass eval, but coarse_free_from_stage=1 never "
            "trains a coarse MLP to propose from — that override silently renders garbage.  "
            "Drop the override or use the hybrid schedule (coarse_free_from_stage=2)")


class Engine:
    """Trains the three stages (:meth:`train`) and scores a checkpoint on
    the test views (:meth:`demo`), on ``device`` (CUDA unless named)."""

    def __init__(self, cfg: Config, device=None):
        for where, mode in (("train", cfg.train.fine_mode), ("eval", cfg.eval.fine_mode)):
            if mode not in ("importance", "grid"):
                raise ValueError(f"unknown {where}.fine_mode: {mode!r} (importance | grid)")
        check_sampling_modes(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        setup_logging(cfg.paths.log_path, cfg.log_to_file)
        logging.info("Loading scene: %s", cfg.scene_dir)
        self.scene = load_scene(cfg.scene_dir, load_test_images=(cfg.mode == 1))
        self.img_h, self.img_w = self.scene.img_h, self.scene.img_w
        self.n_train = self.scene.train.count

        # the reference expands the dataset 50x and walks it once an epoch
        # (data_read.py:286-297): N * 50 / B steps with B images a step
        # over all ranks
        self.world = check_data_parallel(cfg.parallel, world_size())
        self.images_per_batch = cfg.train.images_per_batch * self.world
        self.steps_per_epoch = max(
            1, (self.n_train * cfg.train.steps_per_image_epoch) // self.images_per_batch)
        self.total_steps = self.steps_per_epoch * cfg.stages.total_epochs

        gen = torch.Generator(device=self.device).manual_seed(cfg.train.seed)
        params = Params(init_camera_params(self.n_train, self.device),
                        init_nerf_params(cfg.nerf, gen, self.device))
        p_flat = flatten_params(params)
        self.txs, opt_states = build_optimizers(cfg, params, p_flat, self.steps_per_epoch)
        self.state = TrainState(params, p_flat, opt_states, counter(0, self.device))

        st = cfg.stages
        self.ckpt_dir = os.path.join(cfg.paths.root_weights, "train", cfg.data_name)
        # retention: the newest ckpt_max_keep epochs plus the stage boundaries
        self.ckpt = Checkpointer(self.ckpt_dir, max_keep=cfg.train.ckpt_max_keep,
                                 keep_epochs=(st.cam_param_epochs - 1,
                                              st.cam_param_epochs + st.global_opt_epochs - 1,
                                              st.total_epochs - 1))
        self.writer = ScalarWriter(os.path.join(cfg.paths.tb_path, cfg.data_name),
                                   delete_old=cfg.paths.tb_delete_old,
                                   enabled=cfg.tensorboard and is_main_process())
        self._epoch_fns: Dict[int, StageEpoch] = {}
        self._render_fns: Dict[tuple, FrameRender] = {}
        # one generator, reseeded every epoch, and one memory pool for the
        # stages' step graphs: a captured step keeps reading both
        self._gen = torch.Generator(device=self.device)
        self._graph_pool = (torch.cuda.graph_pool_handle() if self.device.type == "cuda"
                            else None)
        self._data: Optional[TrainData] = None
        self._frame_route_logged = False
        self._table_rows = []
        # per trained epoch: epoch, stage, the mean metrics, seconds, rays/s,
        # checkpoint seconds and (stages 1-2) the validation scores
        self.history = []
        # occupancy state: derived from the coarse MLP, never checkpointed;
        # resume and demo rebuild it in one lattice evaluation
        self.occ_grid: Optional[OccupancyGrid] = None
        self._occ_map: Optional[torch.Tensor] = None

    # -------------------------------------------------------------- occupancy

    @property
    def _occ_train(self) -> bool:
        return self.cfg.nerf.occ_grid_size > 0 and self.cfg.train.fine_mode == "importance"

    @property
    def _occ_eval(self) -> bool:
        return self.cfg.nerf.occ_grid_size > 0 and self.cfg.eval.fine_mode == "importance"

    def _refresh_occupancy(self, epoch: int) -> None:
        """Refresh the grid and the sampler map from the MLP
        ``nerf.refresh_source`` names for ``epoch``'s stage (the coarse in
        two-pass stages): fresh the first time, EMA-max after."""
        source = self.cfg.nerf.refresh_source(self.cfg.stages.stage_of_epoch(epoch))
        self.occ_grid = refresh_grid(self.state.params.nerf, self.cfg, self.device, epoch,
                                     self.occ_grid, source)
        self._set_occ_map(sampler_map(self.occ_grid, self.cfg.nerf))

    def _set_occ_map(self, occ: torch.Tensor) -> None:
        """The sampler map, written into the one buffer the train data
        holds from the first map on (a step graph keeps sampling it)."""
        if self._occ_map is None:
            self._occ_map = occ
        else:
            self._occ_map.copy_(occ)

    # ------------------------------------------------------------------ train

    def _train_data(self) -> TrainData:
        """The train images and the calibration detections, copied to the
        device once (no step copies a host tensor there).  A scene without a
        detection cache gets one from the tag36h11 detector over its calib
        and coord images (the reference runs libapriltag at start-up,
        ``data/data_read.py:171-214``): rank 0 builds it, the other ranks
        wait (concurrent builds would race on the file)."""
        if is_main_process():
            build_calibration_cache(self.cfg.scene_dir)
        barrier()
        imgs = self.scene.train.images_u8.reshape(self.n_train, -1, 3)
        return TrainData(torch.as_tensor(imgs, device=self.device),
                         load_calibration(self.cfg.scene_dir, self.cfg.apriltag_size,
                                          self.device))

    def _epoch_fn(self, stage: int) -> StageEpoch:
        if stage not in self._epoch_fns:
            self._epoch_fns[stage] = make_stage_epoch(
                self.cfg, stage, self.txs[stage], self.img_h, self.img_w,
                self.total_steps, self.steps_per_epoch, self.world, pool=self._graph_pool)
            if not self._epoch_fns.keys() - {stage}:     # the first: say which route, once
                logging.info("train steps: %s", self._epoch_fns[stage].route(self.device))
        return self._epoch_fns[stage]

    def close(self) -> None:
        """Release every stage's step graph (``StageEpoch.release``) and
        every frame graph (``FrameRender.release``); a later epoch or frame
        captures anew, in a new pool.  Over NCCL a step graph holds the
        group's communicator: close the engine before the group is
        destroyed."""
        for ep in self._epoch_fns.values():
            ep.release()
        self._epoch_fns.clear()
        for render in self._render_fns.values():
            render.release()
        self._render_fns.clear()
        if self.device.type == "cuda":
            self._graph_pool = torch.cuda.graph_pool_handle()

    def _render_fn(self, img_h: int, img_w: int) -> FrameRender:
        """The renderer of ``img_h`` x ``img_w`` frames, made once and kept:
        validation and the demo share its graphs (the JAX engine's one
        compiled program per image size); its frames are split over the
        engine's ranks."""
        if (img_h, img_w) not in self._render_fns:
            self._render_fns[(img_h, img_w)] = render = make_render_fn(
                self.cfg, img_h, img_w, device=self.device, world=self.world)
            if not self._frame_route_logged:     # say which route, once
                logging.info("frames: %s", render.route())
                self._frame_route_logged = True
        return self._render_fns[(img_h, img_w)]

    def train(self, resume: bool = False) -> TrainState:
        """Run the protocol's epochs from the start, or with ``resume`` from
        the epoch after the latest checkpoint.  Returns the train state."""
        cfg, spe = self.cfg, self.steps_per_epoch
        if self._data is None:
            self._data = self._train_data()
        data = self._data
        start_epoch = 0
        if resume:
            last = self.ckpt.latest_epoch()
            if last is not None:
                _, last = self.ckpt.restore(self.state, last)
                start_epoch = last + 1
                logging.info("Resumed from epoch %d", last)

        if self._occ_train:
            if (start_epoch - cfg.stages.cam_param_epochs) * spe >= cfg.nerf.occ_warmup_steps:
                # resumed mid or past NeRF training: the grid is derived
                # state, rebuilt fresh from the restored coarse MLP
                self._refresh_occupancy(start_epoch - 1)
            else:
                # uniform sampling until the first refresh (all occupied,
                # or an all-zero density)
                self._set_occ_map(uniform_prior_map(cfg.nerf, self.device))
            data = self._data = data._replace(occ=self._occ_map)

        for epoch in range(start_epoch, cfg.stages.total_epochs):
            stage = cfg.stages.stage_of_epoch(epoch)
            t0 = time.perf_counter()
            self._gen.manual_seed(fold_seed(cfg.train.seed, epoch))
            metrics = {k: float(v)
                       for k, v in self._epoch_fn(stage)(self.state, data, self._gen).items()}
            dt = time.perf_counter() - t0
            rays_per_s = 0.0 if stage == 0 else (
                spe * self.images_per_batch * cfg.train.rays_per_batch / dt)
            logging.info("%s %d | loss %.6f | intr %.6f | extr %.6f | rgb_c %.5f rgb_f %.5f"
                         " | %.1fs (%.0f rays/s)", STAGE_NAMES[stage], epoch, metrics["loss"],
                         metrics["loss_intr"], metrics["loss_extr"], metrics["loss_rgb_c"],
                         metrics["loss_rgb_f"], dt, rays_per_s)
            for k, v in metrics.items():
                self.writer.scalar(f"train/{k}", v, epoch)
            record = {"epoch": epoch, "stage": stage, **metrics, "seconds": dt,
                      "rays_per_s": rays_per_s}
            self.history.append(record)

            # rescue cameras stuck in reflection minima, while the
            # calibration stage still has epochs left to re-converge
            if stage == 0 and epoch < cfg.stages.cam_param_epochs - 1:
                self._maybe_restart_cameras(data, epoch)

            # the refresh (from the coarse MLP in two-pass stages) once the
            # NeRF stages train it, gated on occ_warmup_steps of NeRF
            # training: a grid from a barely trained field mislocalizes the
            # culling
            nerf_epochs_done = epoch + 1 - cfg.stages.cam_param_epochs
            if (self._occ_train and stage >= 1
                    and nerf_epochs_done % cfg.nerf.occ_update_every == 0
                    and nerf_epochs_done * spe >= cfg.nerf.occ_warmup_steps):
                self._refresh_occupancy(epoch)

            if is_main_process():     # one writer; the ranks hold the same bits
                t0 = time.perf_counter()
                self.ckpt.save(epoch, self.state)
                record["ckpt_seconds"] = time.perf_counter() - t0
                self._report_cameras(epoch)
            if stage > 0:             # every rank renders its part of the frame
                record.update(self._validate(epoch))
        # a demo or resume started after train() sees the last checkpoint
        barrier()
        self.writer.close()
        return self.state

    @torch.no_grad()
    def _maybe_restart_cameras(self, data: TrainData, epoch: int) -> None:
        """Monotone camera-pose improvement between stage-0 epochs (see
        ``train/restarts.py``): adopted values are written into the
        parameters in place; the optimizer state is left as it is."""
        cam = self.state.params.cam
        new, adopt_pose, adopt_cube = improve_cameras(cam, data.calib, self.img_h, self.img_w)
        ap, ac = adopt_pose.cpu().numpy(), adopt_cube.cpu().numpy()
        n_adopt = int(ap.sum() + ac.sum())
        if n_adopt:
            logging.info("adopted better camera solutions for %d twists (pose: %s, cube: %s)",
                         n_adopt, np.flatnonzero(ap).tolist(), np.flatnonzero(ac).tolist())
            for name, value in new.items():
                getattr(cam, name).copy_(value)

    # ----------------------------------------------------------- observability

    @torch.no_grad()
    def _report_cameras(self, epoch: int) -> None:
        """The camera-error table, its scalars and the pose plot
        ``<render_dir>/<data_name>/cam_pose/epoch_<n>.png`` (ref
        mc_nerf.py:388-534)."""
        cam = self.state.params.cam
        train = self.scene.train
        K_est = intrinsics(cam, self.img_h, self.img_w).cpu().numpy()
        pose_est = camera_poses(cam).cpu()
        row = camera_error_row(epoch, train.K, K_est, train.poses_w2c, pose_est.numpy())
        self._table_rows.append(row)
        print(camera_error_table(self._table_rows[-12:]))
        for name, val in zip(CAMERA_TABLE_HEADERS[1:], row[1:]):
            self.writer.scalar(f"camera/{name}", val, epoch)
        path = os.path.join(self.cfg.paths.render_dir, self.cfg.data_name, "cam_pose",
                            f"epoch_{epoch}.png")
        try:
            save_pose_plot(path, w2c_to_blender_pose(torch.as_tensor(train.poses_w2c)).numpy(),
                           w2c_to_blender_pose(pose_est).numpy(), train.K, K_est, self.img_w)
        except Exception:     # a plot must never stop training
            logging.exception("pose plot %s failed", path)

    def _validate(self, epoch: int) -> dict:
        """Render one validation view with its ground-truth camera, on every
        rank (the frame is split over them), and on rank 0 score it (ref
        mc_nerf.py:754-813; :meth:`_score_validation`).  Returns the scores,
        or {} on the other ranks."""
        val = self.scene.val
        idx = epoch % val.count
        occ = self._occ_map if self._occ_eval else None
        rgb, depth, _ = self._render_fn(val.img_h, val.img_w)(
            self.state.params.nerf, val.poses_w2c[idx], val.K[idx], occ)
        return self._score_validation(epoch, idx, rgb, depth) if is_main_process() else {}

    def _score_validation(self, epoch: int, idx: int, rgb: torch.Tensor,
                          depth: torch.Tensor) -> dict:
        """Score validation view ``idx``'s frame, log the scores, write them
        to TensorBoard and write the pred, gt and depth PNGs."""
        from PIL import Image

        val = self.scene.val
        gt = torch.as_tensor(val.images_u8[idx], device=self.device).float() / 255.0
        p, s = float(psnr(rgb, gt)), float(ssim(rgb, gt))
        lp = lpips(rgb, gt)
        logging.info("VALID epoch %d | PSNR %.3f | SSIM %.4f | LPIPS %s", epoch, p, s,
                     f"{lp:.4f}" if lp is not None else "n/a")
        self.writer.scalar("val/psnr", p, epoch)
        self.writer.scalar("val/ssim", s, epoch)
        if lp is not None:
            self.writer.scalar("val/lpips", lp, epoch)

        out_dir = os.path.join(self.cfg.paths.render_dir, self.cfg.data_name)
        os.makedirs(out_dir, exist_ok=True)
        Image.fromarray(_to_u8(rgb.cpu().numpy())).save(os.path.join(out_dir, f"epoch_{epoch}.png"))
        Image.fromarray(_to_u8(gt.cpu().numpy())).save(
            os.path.join(out_dir, f"epoch_{epoch}_gt.png"))
        d01 = np.clip(depth.cpu().numpy() / (self.cfg.nerf.far + 1e-9), 0, 1)
        Image.fromarray((d01 * 255).astype(np.uint8)).save(
            os.path.join(out_dir, f"epoch_{epoch}_depth.png"))
        return {"val_psnr": p, "val_ssim": s, "val_lpips": lp}

    # ------------------------------------------------------------------- demo

    def demo(self, ckpt_epoch: Optional[int] = None) -> dict:
        """Restore a checkpoint (``ckpt_epoch``, else ``eval.demo_ckpt``, else
        the latest) and score every test view with its camera (the
        reference's demo, ``main.py:98-173``, with its two scoring faults
        fixed).  The PNGs go to ``<paths.render_dir>_<time stamp>``, rank 0's
        stamp on every rank.  The views render through the engine's own
        renderer of their size (``_render_fn``: on the card, the frame
        graphs validation captured) and, culled, on the engine's own map,
        refreshed fresh from the restored MLP, as the JAX demo does
        (``mc_nerf_tpu/train/engine.py:648-663``)."""
        cfg = self.cfg
        if ckpt_epoch is None:
            ckpt_epoch = _parse_demo_ckpt(cfg.eval.demo_ckpt)
        _, epoch = self.ckpt.restore(self.state, ckpt_epoch)
        logging.info("Loaded checkpoint epoch %d", epoch)
        test = self.scene.test
        if test.images_u8 is None:
            # a train-mode engine skipped the test images at load
            test = load_split(cfg.scene_dir, "test", load_images=True)
            self.scene.test = test
        # the warm-up guard of train(): a checkpoint with fewer than
        # occ_warmup_steps of NeRF training (stage 0: an untrained coarse
        # field) would mislocalize the culling, so it renders unculled, or
        # coarse-free from the uniform prior (the map is the proposal there)
        nerf_steps = (epoch + 1 - cfg.stages.cam_param_epochs) * self.steps_per_epoch
        cull = self._occ_eval and nerf_steps >= cfg.nerf.occ_warmup_steps
        if self._occ_eval and not cull:
            logging.info("demo checkpoint (epoch %d) predates occ_warmup_steps=%d (%d NeRF steps "
                         "trained): rendering without occupancy culling%s", epoch,
                         cfg.nerf.occ_warmup_steps, max(0, nerf_steps),
                         " (coarse-free: from the uniform prior)" if cfg.eval_coarse_free
                         else "")
        if cull:
            # the engine's own grid and map, rebuilt fresh from the restored
            # MLP (the grid is never checkpointed), as the JAX demo does
            self.occ_grid = None
            self._refresh_occupancy(epoch)
        now = broadcast_(torch.tensor([int(time.time())], dtype=torch.int64,
                                      device=self.device))
        base = cfg.paths.render_dir + "_" + time.strftime("%Y-%m-%d-%H-%M-%S",
                                                          time.localtime(int(now[0])))
        result = demo(self.state.params.nerf, test, cfg, self.device, cull=cull, out_dir=base,
                      epoch=epoch, render=self._render_fn(test.img_h, test.img_w),
                      occ=self._occ_map if cull else None)
        return {**result, "out_dir": base}
