"""The benchmark's inputs, made from ``--seed`` on the device: the scene
(seeded uint8 images, detections, cameras on an orbit), the test views,
and the weights, raw tensors that both the program and the plain
reference are handed.

Frozen copies of ``mc_nerf_torch/tools/scene.py`` (``orbit_views``,
``train_workload``, ``scene_params``' He-scaled init) and of the draw rule
of ``mc_nerf_torch/train/steps.py::draw_step`` /
``models/nerf.py::draw_render``, so that a later change to the port's
tools cannot move the yardstick.  Nothing here imports the port.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

LEGO_FOV = 0.6911112070083618   # camera_angle_x of the NeRF-synthetic scenes


def _blender_to_w2c(c2w: np.ndarray) -> np.ndarray:
    """Blender c2w -> OpenCV w2c [3, 4] (ref ``data_read.py:246-257``)."""
    R_cv = c2w[:3, :3] * np.array([1.0, -1.0, -1.0])
    return np.concatenate([R_cv.T, (-R_cv.T @ c2w[:3, 3])[:, None]], -1)


def orbit_views(n: int, h: int, w: int, radius: float = 4.0, elevation: float = 0.5,
                fov: float = LEGO_FOV) -> Tuple[np.ndarray, np.ndarray]:
    """OpenCV w2c poses [n, 3, 4] (float64) of ``n`` cameras evenly spaced in
    azimuth on a circle of ``radius`` at ``elevation`` (radians), looking at
    the origin, and their K [3, 3] for an h x w image of horizontal FOV
    ``fov``."""
    poses = []
    for a in np.linspace(0.0, 2 * math.pi, n, endpoint=False):
        eye = radius * np.array([math.cos(a) * math.cos(elevation),
                                 math.sin(a) * math.cos(elevation), math.sin(elevation)])
        fwd = -eye / radius
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, np.cross(right, fwd), -fwd, eye
        poses.append(_blender_to_w2c(c2w))
    focal = (w / 2.0) / math.tan(fov / 2.0)
    return np.stack(poses), np.array([[focal, 0, w / 2.0], [0, focal, h / 2.0], [0, 0, 1]])


def se3_log(Rt: np.ndarray) -> np.ndarray:
    """w2c poses [n, 3, 4] -> twists [n, 6] (rotation | translation), the
    inverse of the exponential the step applies (float64)."""
    out = []
    for P in Rt:
        R, t = P[:, :3], P[:, 3]
        cos = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
        th = math.acos(cos)
        if th < 1e-8:
            w = np.zeros(3)
        else:
            w = th / (2 * math.sin(th)) * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                                                    R[1, 0] - R[0, 1]])
        wx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        if th < 1e-8:
            V = np.eye(3)
        else:
            V = (np.eye(3) + (1 - math.cos(th)) / th ** 2 * wx
                 + (th - math.sin(th)) / th ** 3 * (wx @ wx))
        out.append(np.concatenate([w, np.linalg.solve(V, t)]))
    return np.stack(out)


def cube_detections(seed: int, n: int, side: int) -> np.ndarray:
    """[n, 6, 5, 2] float32 seeded keypoints, uniform in [10, side - 10] px;
    every tag counts as detected."""
    rng = np.random.default_rng(seed)
    return rng.uniform(10, side - 10, size=(n, 6, 5, 2)).astype(np.float32)


def camera_params(n: int, h: int, w: int, radius: float, elevation: float,
                  device) -> Dict[str, torch.Tensor]:
    """The cameras' learnable parameters at the orbit's ground truth, keyed
    as the port names them: twists, the cube's twists (all ones, the
    reference's init) and the multiplicative intrinsics."""
    poses, K = orbit_views(n, h, w, radius, elevation)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return {"cam.pose_se3": t(se3_log(poses)), "cam.calib_pose_se3": t(np.ones((n, 6))),
            "cam.fx": t(np.full(n, K[0, 0] / w)), "cam.fy": t(np.full(n, K[1, 1] / w)),
            "cam.ux": t(np.full(n, K[0, 2] / (w / 2.0))),
            "cam.uy": t(np.full(n, K[1, 2] / (h / 2.0)))}


def mlp_shapes(nc: dict, which: str):
    """[(name, shape)] of one MLP's weights and biases, in the port's
    parameter order (trunk, sigma0, sigma1, sh0, sh1; weight then bias)."""
    depth, width, skips = nc[f"{which}_depth"], nc[f"{which}_width"], nc[f"{which}_skips"]
    emb = 3 * (2 * nc["emb_freqs_xyz"] + 1)
    sh = 3 * (nc["sh_deg"] + 1) ** 2
    layers = [(f"trunk.{i}", width, emb if i == 0 else width + emb if i in skips else width)
              for i in range(depth)]
    layers += [("sigma0", width, width), ("sigma1", 1, width), ("sh0", width, width),
               ("sh1", sh, width)]
    out = []
    for name, o, i in layers:
        out += [(f"nerf.{which}.{name}.weight", (o, i)), (f"nerf.{which}.{name}.bias", (o,))]
    return out


def octave_scale(nc: dict, device) -> torch.Tensor:
    """[3 (2L + 1)] scale of each encoded input lane: 1 for x, 2^-f for the
    sin and cos of octave f.  A field whose weights read every octave at
    full strength varies at the finest octave's scale everywhere: a shift
    of a sample by a rounding-level amount changes what it reads, and a
    frame of it is noise.  A trained field's spectrum falls off; this is
    its 1/f prior (each octave adds the same slope)."""
    L = nc["emb_freqs_xyz"]
    per_axis = torch.cat([0.5 ** torch.arange(L, dtype=torch.float32)] * 2)
    return torch.cat([torch.ones(3), per_axis.repeat(3)]).to(device)


def nerf_weights(nc: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Seeded MLP weights in fp32, made on the device in one draw: weights
    U(+-sqrt(6 / fan_in)) (He's ReLU gain, so that density and colour vary
    with the point), biases U(+-1 / sqrt(fan_in)) (``tools/scene.py``'s
    ``scene_params``); the columns that read the encoded input (the first
    layer's, the skip layer's first ones) scaled by :func:`octave_scale`."""
    shapes = mlp_shapes(nc, "coarse") + mlp_shapes(nc, "fine")
    sizes = [int(np.prod(s)) for _, s in shapes]
    gen = torch.Generator(device=device).manual_seed(_fold(seed, 1))
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    out = {}
    for (name, shape), part in zip(shapes, torch.split(flat, sizes)):
        fan_in = shape[-1] if name.endswith("weight") else None
        if fan_in is None:      # a bias: the fan-in of its weight
            fan_in = out[name[:-4] + "weight"].shape[-1]
            bound = 1.0 / math.sqrt(fan_in)
        else:
            bound = math.sqrt(6.0 / fan_in)
        out[name] = (part * bound).reshape(shape)
    emb = 3 * (2 * nc["emb_freqs_xyz"] + 1)
    scale = octave_scale(nc, device)
    for which in ("coarse", "fine"):
        for i in [0, *nc[f"{which}_skips"]]:
            out[f"nerf.{which}.trunk.{i}.weight"][:, :emb] *= scale
    return out


def _fold(seed: int, stream: int) -> int:
    """A 63-bit generator seed from the run's seed and a stream number."""
    state = np.random.SeedSequence([seed & 0xFFFFFFFFFFFFFFFF, stream])
    return int(state.generate_state(1, np.uint64)[0]) & 0x7FFFFFFFFFFFFFFF


class Scene(NamedTuple):
    images_u8: torch.Tensor        # [N, H*W, 3] uint8
    detections: np.ndarray         # [N, 6, 5, 2] float32, every tag visible
    params: Dict[str, torch.Tensor]  # cameras and MLPs, fp32, keyed as the port's


def make_scene(nc: dict, scene: dict, seed: int, device) -> Scene:
    """The train cells' scene: ``scene["n_images"]`` seeded uint8 images of
    ``img_h`` x ``img_w`` on the device, seeded detections, cameras on the
    orbit, seeded weights."""
    n, h, w = scene["n_images"], scene["img_h"], scene["img_w"]
    gen = torch.Generator(device=device).manual_seed(_fold(seed, 2))
    images = torch.randint(0, 256, (n, h * w, 3), generator=gen, dtype=torch.uint8,
                           device=device)
    params = camera_params(n, h, w, scene["radius"], scene["elevation"], device)
    params.update(nerf_weights(nc, seed, device))
    return Scene(images, cube_detections(_fold(seed, 3), n, min(h, w)), params)


def step_generator(seed: int, device) -> torch.Generator:
    """The generator the steps' draws come from."""
    return torch.Generator(device=device).manual_seed(_fold(seed, 4))


# --- the draw rule of one step ------------------------------------------------------

class RenderDraws(NamedTuple):
    z_u: torch.Tensor
    noise_c: torch.Tensor
    noise_sel: torch.Tensor
    pdf_u: Optional[torch.Tensor]
    noise_f: torch.Tensor


class StepDraws(NamedTuple):
    u_int: torch.Tensor
    u_ext: torch.Tensor
    img_ids: torch.Tensor
    pix_idx: torch.Tensor
    render: RenderDraws


def draw_step(nc: dict, tc: dict, n_images: int, h: int, w: int, culled: bool,
              images_per_batch: int, gen: torch.Generator) -> StepDraws:
    """One GLOBAL_OPTIM step's draws, in the order and shapes the port
    draws them (``draw_step`` + ``draw_render``, two-pass renders)."""
    dev = gen.device
    u = lambda *s: torch.rand(s, generator=gen, device=dev)
    nrm = lambda *s: torch.randn(s, generator=gen, device=dev)
    u_int, u_ext = u(n_images), u(n_images)
    r, hw, b = tc["rays_per_batch"], h * w, images_per_batch
    img_ids = torch.randint(0, n_images, (b,), generator=gen, device=dev)
    if hw > 8 * r:
        pix = torch.randint(0, hw, (b, r), generator=gen, device=dev)
    else:
        pix = torch.stack([torch.randperm(hw, generator=gen, device=dev)[:r] for _ in range(b)])
    n, k = b * r, tc["importance_samples"]
    sc = nc["occ_coarse_samples"] if culled else nc["samples_coarse"]
    z_u = u(n, sc) if culled else u(n, 1) * ((nc["far"] - nc["near"]) / sc)
    noise_c, noise_sel = nrm(n, sc), nrm(n, sc)
    if tc["fine_mode"] == "grid":
        render = RenderDraws(z_u, noise_c, noise_sel, None,
                             nrm(n, nc["fine_bins_topk"] * nc["sample_scale"]))
    else:
        render = RenderDraws(z_u, noise_c, noise_sel, u(n, k), nrm(n, k))
    return StepDraws(u_int, u_ext, img_ids, pix, render)
