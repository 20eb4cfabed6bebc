"""The training and eval engine: host-level orchestration (counterpart of
``mc_nerf_tpu/train/engine.py``).

:class:`Engine` runs the reference's three-stage protocol (``main.py:27-241``):
CAM_PARAM epochs with camera restarts between them, then GLOBAL_OPTIM and
FINE_TUNE epochs with the occupancy grid refreshed from the coarse MLP
(the first refresh after ``occ_warmup_steps`` of NeRF training, EMA-max
after it); a checkpoint, a camera-error report and (stages 1-2) one
validation view every epoch; and the demo, which restores a checkpoint
and scores every test view through :func:`demo`.  An epoch is a Python
loop of train steps (``train/steps.py``) whose draws come from a
generator on the device seeded from ``(train.seed, epoch)``, so a resumed
run draws what an uninterrupted one does.

As in the JAX package, and unlike the reference: each demo view is scored
against its own ground truth, means divide by the view count, training
resumes from any checkpoint, scalars are written.  Not ported: the pose
plot (matplotlib), building the detection cache (the tag36h11 detector),
multi-process runs.
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
from mc_nerf_torch.config import Config
from mc_nerf_torch.data.blender import SplitData, load_scene, load_split
from mc_nerf_torch.data.calibration import CACHE_NAME, load_calibration
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
from mc_nerf_torch.train.checkpoint import Checkpointer
from mc_nerf_torch.train.optim import Params, build_optimizers, flatten_params
from mc_nerf_torch.train.restarts import improve_cameras
from mc_nerf_torch.train.steps import TrainData, TrainState, make_render_fn, make_stage_epoch
from mc_nerf_torch.utils.logging import is_main_process, setup_logging
from mc_nerf_torch.utils.tensorboard import ScalarWriter
from mc_nerf_torch.utils.visualization import (
    CAMERA_TABLE_HEADERS,
    apply_depth_colormap,
    camera_error_row,
    camera_error_table,
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
                 grid: Optional[OccupancyGrid] = None) -> OccupancyGrid:
    """The occupancy grid from the coarse MLP: one jittered lattice
    evaluation (:func:`refresh_jitter`), fresh when ``grid`` is None, else
    the EMA-max into it.  Plain PyTorch in ``cfg.compute_dtype`` (the JAX
    package leaves it to XLA)."""
    nc = cfg.nerf
    cd = _dtype(cfg.compute_dtype)

    @torch.no_grad()
    def act(pts):
        sigma, _ = nerf_params.coarse(sincos_encode(pts, nc.emb_freqs_xyz, None), cd,
                                      sigma_only=True)
        return F.softplus(sigma.reshape(-1))

    return update_grid(grid, act, nc.occ_grid_size, nc.bound_min, nc.bound_max,
                       uniforms=refresh_jitter(cfg, epoch, device), decay=nc.occ_decay,
                       device=device)


def refresh_occupancy(nerf_params: NerfParams, cfg: Config, device, epoch: int) -> torch.Tensor:
    """A fresh occupancy map (``sampler_map``) of :func:`refresh_grid`."""
    return sampler_map(refresh_grid(nerf_params, cfg, device, epoch), cfg.nerf)


def demo(nerf_params: NerfParams, test_split: SplitData, cfg: Config,
         device=None, cull: bool = True, out_dir: Optional[str] = None, epoch: int = 0) -> dict:
    """Render every test view with its camera and score it.

    With ``cull`` (and occupancy enabled in ``cfg``, in the importance fine
    mode: the grid mode stays unculled, as ``Engine._occ_eval`` has it) the
    occupancy map is rebuilt fresh from the coarse MLP first, with
    ``epoch``'s jitter, and the coarse samples follow it; otherwise the
    views render unculled.  With ``out_dir`` the pred, depth and gt PNGs
    are written under it.

    Returns {"psnr", "ssim", "lpips": None, "count"}, the means over views.
    """
    dev = resolve_device(device)
    test = test_split
    render = make_render_fn(cfg, test.img_h, test.img_w, device=dev)
    occ = None
    if cull and cfg.nerf.occ_grid_size > 0 and cfg.eval.fine_mode == "importance":
        occ = refresh_occupancy(nerf_params, cfg, dev, epoch)
    dirs = None
    if out_dir is not None:
        dirs = {k: os.path.join(out_dir, k) for k in ("pred", "depth", "gt")}
        for d in dirs.values():
            os.makedirs(d, exist_ok=True)

    scores = np.zeros((test.count, 2), np.float64)
    for i in range(test.count):
        rgb, depth, opacity = render(nerf_params, test.poses_w2c[i], test.K[i], occ)
        gt = torch.as_tensor(test.images_u8[i], device=dev).float() / 255.0
        scores[i] = float(psnr(rgb, gt)), float(ssim(rgb, gt))
        if dirs is not None:
            _write_pngs(dirs, i, rgb, depth, opacity, gt)
    lp = lpips(None, None)
    result = {"psnr": float(scores[:, 0].mean()), "ssim": float(scores[:, 1].mean()),
              "lpips": lp, "count": test.count}
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


class Engine:
    """Trains the three stages (:meth:`train`) and scores a checkpoint on
    the test views (:meth:`demo`), on ``device`` (CUDA unless named)."""

    def __init__(self, cfg: Config, device=None):
        for where, mode in (("train", cfg.train.fine_mode), ("eval", cfg.eval.fine_mode)):
            if mode not in ("importance", "grid"):
                raise ValueError(f"unknown {where}.fine_mode: {mode!r} (importance | grid)")
        self.cfg = cfg
        self.device = resolve_device(device)
        setup_logging(cfg.paths.log_path, cfg.log_to_file)
        logging.info("Loading scene: %s", cfg.scene_dir)
        self.scene = load_scene(cfg.scene_dir, load_test_images=(cfg.mode == 1))
        self.img_h, self.img_w = self.scene.img_h, self.scene.img_w
        self.n_train = self.scene.train.count

        # the reference expands the dataset 50x and walks it once an epoch
        # (data_read.py:286-297): N * 50 / B steps with B images a step
        self.images_per_batch = cfg.train.images_per_batch
        self.steps_per_epoch = max(
            1, (self.n_train * cfg.train.steps_per_image_epoch) // self.images_per_batch)
        self.total_steps = self.steps_per_epoch * cfg.stages.total_epochs

        gen = torch.Generator(device=self.device).manual_seed(cfg.train.seed)
        params = Params(init_camera_params(self.n_train, self.device),
                        init_nerf_params(cfg.nerf, gen, self.device))
        p_flat = flatten_params(params)
        self.txs, opt_states = build_optimizers(cfg, params, p_flat, self.steps_per_epoch)
        self.state = TrainState(params, p_flat, opt_states, 0)

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
        self._epoch_fns: Dict[int, object] = {}
        self._render_fns: Dict[tuple, object] = {}
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
        """Refresh the grid and the sampler map from the coarse MLP: fresh
        the first time, EMA-max after."""
        self.occ_grid = refresh_grid(self.state.params.nerf, self.cfg, self.device, epoch,
                                     self.occ_grid)
        self._occ_map = sampler_map(self.occ_grid, self.cfg.nerf)

    # ------------------------------------------------------------------ train

    def _train_data(self) -> TrainData:
        """The train images and the calibration detections, copied to the
        device once (no step copies a host tensor there)."""
        if not os.path.exists(os.path.join(self.cfg.scene_dir, CACHE_NAME)):
            raise FileNotFoundError(
                f"{self.cfg.scene_dir} has no {CACHE_NAME}: building it runs the tag36h11 "
                "detector over the calib/coord images, which is not ported yet (ROADMAP.md, "
                "Queue 1 item 2); write scenes with mc_nerf_torch.data.synthetic.make_dataset")
        imgs = self.scene.train.images_u8.reshape(self.n_train, -1, 3)
        return TrainData(torch.as_tensor(imgs, device=self.device),
                         load_calibration(self.cfg.scene_dir, self.cfg.apriltag_size,
                                          self.device))

    def _epoch_fn(self, stage: int):
        if stage not in self._epoch_fns:
            self._epoch_fns[stage] = make_stage_epoch(
                self.cfg, stage, self.txs[stage], self.img_h, self.img_w,
                self.total_steps, self.steps_per_epoch)
        return self._epoch_fns[stage]

    def _render_fn(self, img_h: int, img_w: int):
        if (img_h, img_w) not in self._render_fns:
            self._render_fns[(img_h, img_w)] = make_render_fn(self.cfg, img_h, img_w,
                                                              device=self.device)
        return self._render_fns[(img_h, img_w)]

    def train(self, resume: bool = False) -> TrainState:
        """Run the protocol's epochs from the start, or with ``resume`` from
        the epoch after the latest checkpoint.  Returns the train state."""
        cfg, spe = self.cfg, self.steps_per_epoch
        data = self._train_data()
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
                # uniform sampling until the first refresh
                self._occ_map = uniform_prior_map(cfg.nerf, self.device)
            data = data._replace(occ=self._occ_map)

        for epoch in range(start_epoch, cfg.stages.total_epochs):
            stage = cfg.stages.stage_of_epoch(epoch)
            t0 = time.perf_counter()
            gen = torch.Generator(device=self.device).manual_seed(
                fold_seed(cfg.train.seed, epoch))
            metrics = {k: float(v) for k, v in self._epoch_fn(stage)(self.state, data, gen).items()}
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

            # the refresh from the coarse MLP once the NeRF stages train it,
            # gated on occ_warmup_steps of NeRF training: a grid from a
            # barely trained coarse field mislocalizes the culling
            nerf_epochs_done = epoch + 1 - cfg.stages.cam_param_epochs
            if (self._occ_train and stage >= 1
                    and nerf_epochs_done % cfg.nerf.occ_update_every == 0
                    and nerf_epochs_done * spe >= cfg.nerf.occ_warmup_steps):
                self._refresh_occupancy(epoch)
                data = data._replace(occ=self._occ_map)

            t0 = time.perf_counter()
            self.ckpt.save(epoch, self.state)
            record["ckpt_seconds"] = time.perf_counter() - t0
            if is_main_process():
                self._report_cameras(epoch)
                if stage > 0:
                    record.update(self._validate(epoch))
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
        """The camera-error table and its scalars (ref mc_nerf.py:388-407;
        the pose plot is not ported)."""
        cam = self.state.params.cam
        row = camera_error_row(epoch, self.scene.train.K,
                               intrinsics(cam, self.img_h, self.img_w).cpu().numpy(),
                               self.scene.train.poses_w2c, camera_poses(cam).cpu().numpy())
        self._table_rows.append(row)
        print(camera_error_table(self._table_rows[-12:]))
        for name, val in zip(CAMERA_TABLE_HEADERS[1:], row[1:]):
            self.writer.scalar(f"camera/{name}", val, epoch)

    def _validate(self, epoch: int) -> dict:
        """Render one validation view with its ground-truth camera and score
        it (ref mc_nerf.py:754-813); writes the pred, gt and depth PNGs."""
        from PIL import Image

        val = self.scene.val
        idx = epoch % val.count
        occ = self._occ_map if self._occ_eval else None
        rgb, depth, _ = self._render_fn(val.img_h, val.img_w)(
            self.state.params.nerf, val.poses_w2c[idx], val.K[idx], occ)
        gt = torch.as_tensor(val.images_u8[idx], device=self.device).float() / 255.0
        p, s = float(psnr(rgb, gt)), float(ssim(rgb, gt))
        lp = lpips(None, None)
        logging.info("VALID epoch %d | PSNR %.3f | SSIM %.4f | LPIPS %s", epoch, p, s,
                     f"{lp:.4f}" if lp is not None else "n/a")
        self.writer.scalar("val/psnr", p, epoch)
        self.writer.scalar("val/ssim", s, epoch)

        out_dir = os.path.join(self.cfg.paths.render_dir, self.cfg.data_name)
        os.makedirs(out_dir, exist_ok=True)
        Image.fromarray(_to_u8(rgb.cpu().numpy())).save(os.path.join(out_dir, f"epoch_{epoch}.png"))
        Image.fromarray(_to_u8(gt.cpu().numpy())).save(
            os.path.join(out_dir, f"epoch_{epoch}_gt.png"))
        d01 = np.clip(depth.cpu().numpy() / (self.cfg.nerf.far + 1e-9), 0, 1)
        Image.fromarray((d01 * 255).astype(np.uint8)).save(
            os.path.join(out_dir, f"epoch_{epoch}_depth.png"))
        return {"val_psnr": p, "val_ssim": s}

    # ------------------------------------------------------------------- demo

    def demo(self, ckpt_epoch: Optional[int] = None) -> dict:
        """Restore a checkpoint (``ckpt_epoch``, else ``eval.demo_ckpt``, else
        the latest) and score every test view with its camera (the
        reference's demo, ``main.py:98-173``, with its two scoring faults
        fixed).  The PNGs go to ``<paths.render_dir>_<time stamp>``."""
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
        # field) would mislocalize the culling, so it renders unculled
        nerf_steps = (epoch + 1 - cfg.stages.cam_param_epochs) * self.steps_per_epoch
        cull = self._occ_eval and nerf_steps >= cfg.nerf.occ_warmup_steps
        if self._occ_eval and not cull:
            logging.info("demo checkpoint (epoch %d) predates occ_warmup_steps=%d (%d NeRF steps "
                         "trained): rendering without occupancy culling", epoch,
                         cfg.nerf.occ_warmup_steps, max(0, nerf_steps))
        base = cfg.paths.render_dir + "_" + time.strftime("%Y-%m-%d-%H-%M-%S")
        result = demo(self.state.params.nerf, test, cfg, self.device, cull=cull, out_dir=base,
                      epoch=epoch)
        return {**result, "out_dir": base}
