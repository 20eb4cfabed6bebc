"""The hash-grid cells' inputs, made from ``--seed`` on the device: the
scene of ``scene.py`` (seeded uint8 images, detections, cameras on an
orbit) with the hash-grid field's seeded weights in place of the MLP
pair's, and the draw rule of its coarse-free GLOBAL_OPTIM step.  Nothing
here imports the port.

The seeded table: level l's entries U(+-2^(-l/4)).  Instant-NGP draws
U(+-1e-4), a flat field that moves no check (every sample reads ~0); at
this scale every level moves rgb and density (the finest by ~0.07 of the
coarsest's amplitude), falling off with the level as a trained field's
spectrum does, the hash grid's counterpart of ``scene.py``'s octave
scale.  The MLPs: U(+-sqrt(6 / fan_in)) (He's ReLU gain, as ``scene.py``),
no biases; the density MLP's first output row (the raw density h_0)
scaled by ``DENSITY_SCALE``, so that a ray's opacity spreads over
several samples."""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch

from portbench.reference import ngp as ref_ngp
from portbench.scene import Scene, _fold, camera_params, cube_detections

# the raw density's scale in the seeded density MLP: exp(h_0) of a few
# tenths to a few units, so 32 samples over [near, far] composite several
DENSITY_SCALE = 0.5


def ngp_shapes(nc: dict):
    """[(name, shape)] of the field's parameters in the port's order: the
    table, the density MLP's weights, the colour MLP's."""
    grid_out = nc["hash_levels"] * ref_ngp.FEATURES
    w, geo = nc["ngp_width"], nc["ngp_geo_features"]
    dens = [grid_out] + [w] * nc["ngp_density_hidden"] + [geo]
    col = [geo + nc["ngp_dir_degree"] ** 2] + [w] * nc["ngp_color_hidden"] + [3]
    out = [("nerf.table", (ref_ngp.table_rows(nc), ref_ngp.FEATURES))]
    for name, dims in (("density", dens), ("color", col)):
        out += [(f"nerf.{name}.{i}.weight", (o, k)) for i, (k, o) in
                enumerate(zip(dims[:-1], dims[1:]))]
    return out


def ngp_weights(nc: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The field's seeded parameters, fp32 on the device (see the module)."""
    shapes = ngp_shapes(nc)
    sizes = [math.prod(s) for _, s in shapes]
    gen = torch.Generator(device=device).manual_seed(_fold(seed, 6))
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    out = {}
    for (name, shape), part in zip(shapes, torch.split(flat, sizes)):
        out[name] = part.reshape(shape).clone()
    scale = torch.cat([torch.full((lv["rows"],), 2.0 ** (-l / 4), device=device)
                       for l, lv in enumerate(ref_ngp.levels(nc))])
    out["nerf.table"] *= scale[:, None]
    for name, shape in shapes[1:]:
        out[name] *= math.sqrt(6.0 / shape[1])
    out["nerf.density.%d.weight" % nc["ngp_density_hidden"]][0] *= DENSITY_SCALE
    return out


def make_scene(nc: dict, scene: dict, seed: int, device) -> Scene:
    """``scene.make_scene``'s images, detections and cameras, and the
    field's seeded weights."""
    n, h, w = scene["n_images"], scene["img_h"], scene["img_w"]
    gen = torch.Generator(device=device).manual_seed(_fold(seed, 2))
    images = torch.randint(0, 256, (n, h * w, 3), generator=gen, dtype=torch.uint8,
                           device=device)
    params = camera_params(n, h, w, scene["radius"], scene["elevation"], device)
    params.update(ngp_weights(nc, seed, device))
    return Scene(images, cube_detections(_fold(seed, 3), n, min(h, w)), params)


# --- the draw rule of one coarse-free step ---------------------------------------------

class RenderDraws(NamedTuple):
    pdf_u: torch.Tensor
    noise_f: torch.Tensor
    mix_u: Optional[torch.Tensor]


class StepDraws(NamedTuple):
    u_int: torch.Tensor
    u_ext: torch.Tensor
    img_ids: torch.Tensor
    pix_idx: torch.Tensor
    render: RenderDraws


def draw_step(nc: dict, tc: dict, n_images: int, h: int, w: int, images_per_batch: int,
              gen: torch.Generator) -> StepDraws:
    """One coarse-free GLOBAL_OPTIM step's draws, in the order and shapes
    the port draws them (``draw_step`` + ``draw_render(coarse_free=True)``):
    the PMF's uniforms [n, K - ku], the noise [n, K] (drawn; the exp field
    reads none), the uniform share's [n, ku]."""
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
    ku = min(max(nc["cf_uniform_samples"], 0), k - 1)
    pdf_u, noise_f = u(n, k - ku), nrm(n, k)
    return StepDraws(u_int, u_ext, img_ids, pix,
                     RenderDraws(pdf_u, noise_f, u(n, ku) if ku else None))
