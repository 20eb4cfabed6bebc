"""The demo: render every test view and score it.

Counterpart of the render-and-score core of ``Engine.demo`` in
``mc_nerf_tpu/train/engine.py`` (``:630-764``) and of the fresh occupancy
refresh it triggers (``:306-354``).  Checkpoint restore and multi-process
sharding come with later slices; the caller passes the parameters.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from mc_nerf_torch import compute_dtype as _dtype
from mc_nerf_torch import resolve_device
from mc_nerf_torch.config import Config
from mc_nerf_torch.data.blender import SplitData
from mc_nerf_torch.eval.metrics import lpips, psnr, ssim
from mc_nerf_torch.models.encoding import sincos_encode
from mc_nerf_torch.models.nerf import NerfParams
from mc_nerf_torch.ops.occupancy import sampler_map, update_grid
from mc_nerf_torch.train.steps import make_render_fn

# inferno at 17 evenly spaced points, linearly interpolated (within 0.026
# of the 256-entry table) for the inverse-depth PNGs
_INFERNO = np.array([
    (0.0015, 0.0005, 0.0139), (0.0423, 0.0281, 0.1411), (0.1293, 0.0473, 0.2908),
    (0.2383, 0.0366, 0.3964), (0.3415, 0.0623, 0.4294), (0.4412, 0.0993, 0.4316),
    (0.5409, 0.1347, 0.4151), (0.6401, 0.1714, 0.3811), (0.7357, 0.2159, 0.3302),
    (0.8224, 0.2752, 0.2661), (0.8943, 0.3534, 0.1936), (0.9470, 0.4492, 0.1153),
    (0.9784, 0.5579, 0.0349), (0.9879, 0.6753, 0.0653), (0.9746, 0.7977, 0.2063),
    (0.9476, 0.9174, 0.4107), (0.9884, 0.9984, 0.6449),
])


def apply_depth_colormap(depth01: np.ndarray) -> np.ndarray:
    """[H, W] values in [0, 1] -> [H, W, 3] inferno colours, with the
    reference's clip of the index to [63, 255] (net_utils.py:219-231)."""
    idx = np.clip((np.clip(depth01, 0.0, 1.0) * 255).astype(np.int64), 63, 255)
    xs = np.linspace(0.0, 1.0, len(_INFERNO))
    t = np.arange(256) / 255.0
    table = np.stack([np.interp(t, xs, _INFERNO[:, c]) for c in range(3)], -1)
    return table[idx]


def refresh_occupancy(nerf_params: NerfParams, cfg: Config, device) -> torch.Tensor:
    """A fresh occupancy map from the coarse MLP: one lattice evaluation
    (``update_grid(None, ...)``) thresholded by ``sampler_map``.  The
    lattice is jittered from a generator seeded by ``cfg.seed``.  Plain
    PyTorch in ``cfg.compute_dtype`` (the JAX package leaves it to XLA)."""
    nc = cfg.nerf
    cd = _dtype(cfg.compute_dtype)

    @torch.no_grad()
    def act(pts):
        enc = sincos_encode(pts, nc.emb_freqs_xyz, None)
        sigma, _ = nerf_params.coarse(enc, cd, sigma_only=True)
        return F.softplus(sigma.reshape(-1))

    gen = torch.Generator().manual_seed(cfg.seed ^ 0x0CC)
    grid = update_grid(None, act, nc.occ_grid_size, nc.bound_min, nc.bound_max,
                       generator=gen, decay=nc.occ_decay, device=device)
    return sampler_map(grid, nc)


def demo(nerf_params: NerfParams, test_split: SplitData, cfg: Config,
         device=None, cull: bool = True, out_dir: Optional[str] = None) -> dict:
    """Render every test view with its camera and score it.

    With ``cull`` (and occupancy enabled in ``cfg``) the occupancy map is
    rebuilt from the coarse MLP first and the coarse samples follow it;
    otherwise the views render unculled.  With ``out_dir`` the pred, depth
    and gt PNGs are written under it.

    Returns {"psnr", "ssim", "lpips": None, "count"}, the means over views.
    """
    dev = resolve_device(device)
    test = test_split
    render = make_render_fn(cfg, test.img_h, test.img_w, device=dev)
    occ = None
    if cull and cfg.nerf.occ_grid_size > 0:
        occ = refresh_occupancy(nerf_params, cfg, dev)
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


def _write_pngs(dirs, i, rgb, depth, opacity, gt) -> None:
    from PIL import Image

    name = str(i).zfill(4)
    to_u8 = lambda x: (np.clip(x, 0, 1) * 255).astype(np.uint8)
    Image.fromarray(to_u8(rgb.cpu().numpy())).save(os.path.join(dirs["pred"], name + ".png"))
    Image.fromarray(to_u8(gt.cpu().numpy())).save(os.path.join(dirs["gt"], name + "gt.png"))
    # inverse-depth colormap (ref main.py:117-118)
    d, o = depth.cpu().numpy(), opacity.cpu().numpy()
    inv = 1.0 / (d / np.clip(o, 1e-10, None) + 1e-10) * 2
    Image.fromarray((apply_depth_colormap(inv) * 255).astype(np.uint8)).save(
        os.path.join(dirs["depth"], name + "depth.png"))
