"""The system under test: ``mc_nerf_torch``, built from the benchmark's
configuration file and handed the benchmark's inputs.  The only module
of the benchmark, with the runners, that imports the port."""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from mc_nerf_torch.config import (
    BarfConfig,
    Config,
    EvalConfig,
    NerfConfig,
    StageConfig,
    TrainConfig,
)
from mc_nerf_torch.data.calibration import calibration_from_numpy
from mc_nerf_torch.models.camera_params import FIELDS, CameraParams
from mc_nerf_torch.models.nerf import NerfParams, init_nerf_params
from mc_nerf_torch.ops.occupancy import uniform_prior_map
from mc_nerf_torch.train.engine import refresh_occupancy
from mc_nerf_torch.train.optim import Params, build_optimizers, counter, flatten_params
from mc_nerf_torch.train.steps import TrainData, TrainState, make_render_fn, make_stage_epoch

__all__ = ["port_config", "nerf_params", "train_setup", "refresh_occupancy", "make_render_fn",
           "make_stage_epoch"]


def _section(cls, values: dict):
    """A config dataclass from the file's section; every key must apply."""
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(values) - names
    if unknown:
        raise ValueError(f"{cls.__name__} has no field {sorted(unknown)}")
    return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in values.items()})


def port_config(cfg: dict, images_per_batch: int = 1) -> Config:
    """The port's :class:`Config` of a configuration file, with
    ``images_per_batch`` images a rank."""
    train = dict(cfg["train"], images_per_batch=images_per_batch)
    return Config(compute_dtype=cfg["compute_dtype"],
                  stages=_section(StageConfig, cfg["stages"]),
                  barf=_section(BarfConfig, cfg["barf"]),
                  train=_section(TrainConfig, train),
                  nerf=_section(NerfConfig, cfg["nerf"]),
                  eval=_section(EvalConfig, cfg["eval"]))


def nerf_params(raw: Dict[str, torch.Tensor], cfg: Config, device) -> NerfParams:
    """The port's MLPs holding copies of the benchmark's weights."""
    params = init_nerf_params(cfg.nerf, torch.Generator(device=device).manual_seed(0),
                              device=device)
    with torch.no_grad():
        for name, p in params.named_parameters():
            p.copy_(raw["nerf." + name])
    return params


def train_setup(raw: Dict[str, torch.Tensor], images_u8: torch.Tensor, detections: np.ndarray,
                cfg: Config, traffic: dict, device):
    """The port's train state (cameras and MLPs holding copies of the
    benchmark's parameters, flattened, one RAdam state a stage, the step
    counter at ``start_step``) and its data (the benchmark's images, its
    detections as every tag seen in both sets, the all-occupied map in the
    importance mode).  Returns (state, data, the stage's optimizer)."""
    cam = CameraParams(*(raw[f"cam.{f}"].clone() for f in FIELDS))
    params = Params(cam, nerf_params(raw, cfg, device))
    p_flat = flatten_params(params)
    txs, opt_states = build_optimizers(cfg, params, p_flat, traffic["lr_steps_per_epoch"])
    state = TrainState(params, p_flat, opt_states, counter(traffic["start_step"], device))
    valid = np.ones(detections.shape[:2], bool)
    calib = calibration_from_numpy(detections, valid, detections, valid, device=device)
    occ = (uniform_prior_map(cfg.nerf, device)
           if cfg.train.fine_mode == "importance" and traffic["map"] == "uniform_prior" else None)
    return state, TrainData(images_u8, calib, occ), txs[traffic["stage"]]
