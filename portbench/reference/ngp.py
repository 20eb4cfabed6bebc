"""The plain reference of the Instant-NGP hash-grid field (Mueller et al.
2022, arXiv:2201.05989, section 3, Table 1 and section 5.4; NVlabs/instant-ngp
``configs/nerf/base.json`` and ``src/testbed_nerf.cu``) in MC-NeRF's
GLOBAL_OPTIM step and its eval frame: float32 PyTorch, TF32 off, importing
nothing of the port.  L = 16 levels of F = 2 features are the paper's
Table 1 (base.json now ships 8 x 4, the same 32 features); T = 2^19,
N_min = 16, the MLPs and the SH degree base.json's; N_max = 2048 the
testbed's finest NeRF resolution.

The field, as the configuration fixes it:
* L levels of F = 2 features; level l at resolution ``N_l = floor(N_min
  b^l)``, ``b = (N_max / N_min)^(1 / (L - 1))``, N_{L-1} = N_max; a table
  of ``min((N_l + 1)^3, T)`` rows, dense (``i + j (N + 1) + k (N + 1)^2``)
  where the lattice fits, else hashed (``(i ^ j 2654435761 ^ k 805459861)
  mod T``, 32-bit);
* a point mapped from the box into [0, 1]^3 (a product with the float32
  ``1 / (hi - lo)``, as the card divides by a scalar) and clamped, each level
  interpolated trilinearly over the cell at ``x N_l`` (cell index at most
  N_l - 1), the levels concatenated;
* the density MLP (L F -> 64 -> 16, ReLU, no biases), density
  ``exp(h_0)``; the colour MLP ([h | SH of the view direction, 16]
  -> 64 -> 64 -> 3, ReLU, then a sigmoid);
* alpha ``1 - exp(-sigma delta)``, the last delta 1e10, over white.

Departures from Instant-NGP, each the configuration's too:
1. the BARF gate over the levels: level l weighted as MC-NeRF's gate
   weights octave l (n = L), in the GLOBAL_OPTIM step;
2. the encode's input gradient, for the cameras (NGP trains on known
   poses);
3. MC-NeRF's trainer: its loss (the self-normalized intrinsic
   reprojection loss plus the RGB loss; there is no coarse pass) and the
   masked RAdam of ``reference/train.py``, not NGP's Huber loss and Adam;
   no sigma noise.  The samples are drawn from the occupancy PMF
   (coarse-free), not by NGP's ray marcher.

The products go through :func:`dense` of ``reference/nerf.py``: "fp32",
or "fp8" (e4m3, one scale a tensor: the control).  Parameters are a flat
dict keyed as the port's ``Params.named_parameters()`` ("nerf.table",
"nerf.density.0.weight", ..., weights ``[out, in]``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import nerf as R
from portbench.reference.train import RAdam, barf_window

EXP_CLAMP = 15.0
PRIMES = (1, 2654435761, 805459861)
FEATURES = 2                 # F, the features a level (the paper's Table 1)


# --- the hash grid ------------------------------------------------------------------

def levels(nc: dict) -> List[dict]:
    """Each level's resolution, first row, rows and kind."""
    n_lv, base, finest = nc["hash_levels"], nc["hash_base_res"], nc["hash_max_res"]
    t = 2 ** nc["hash_log2_size"]
    b = (finest / base) ** (1.0 / max(n_lv - 1, 1))
    out, off = [], 0
    for l in range(n_lv):
        n = finest if l == n_lv - 1 else int(math.floor(base * b ** l + 1e-9))
        rows = min((n + 1) ** 3, t)
        out.append({"res": n, "offset": off, "rows": rows, "hashed": (n + 1) ** 3 > t})
        off += rows
    return out


def table_rows(nc: dict) -> int:
    lv = levels(nc)
    return lv[-1]["offset"] + lv[-1]["rows"]


def _row(lv: dict, c: torch.Tensor, t: int) -> torch.Tensor:
    i, j, k = c[..., 0], c[..., 1], c[..., 2]
    if lv["hashed"]:
        h = ((i * PRIMES[0]) ^ (j * PRIMES[1]) ^ (k * PRIMES[2])) % (2 ** 32)
        return lv["offset"] + h % t
    n1 = lv["res"] + 1
    return lv["offset"] + i + n1 * (j + n1 * k)


def encode(x: torch.Tensor, table: torch.Tensor, nc: dict,
           gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Points [P, 3] -> features [P, L F], differentiable in both."""
    lo, hi = nc["bound_min"], nc["bound_max"]
    u = torch.clamp((x - lo) * (1.0 / (hi - lo)), 0.0, 1.0)
    t = 2 ** nc["hash_log2_size"]
    feats = []
    for l, lv in enumerate(levels(nc)):
        n = lv["res"]
        pos = u * n
        base = torch.clamp(torch.floor(pos.detach()), max=n - 1)
        frac = pos - base
        acc = 0.0
        for dz in (0, 1):
            for dy in (0, 1):
                for dx in (0, 1):
                    off = torch.tensor([dx, dy, dz], device=x.device)
                    w = torch.ones_like(frac[:, 0])
                    for d, bit in enumerate((dx, dy, dz)):
                        w = w * (frac[:, d] if bit else 1.0 - frac[:, d])
                    acc = acc + w[:, None] * table[_row(lv, base.long() + off, t)]
        feats.append(acc if gate is None else acc * gate[l])
    return torch.cat(feats, -1)


def level_gate(nc: dict, progress: torch.Tensor, window) -> torch.Tensor:
    """Departure 1: [L] weights, level l as the BARF gate's octave l."""
    return R.barf_weights(nc["hash_levels"], progress, *window)


# --- the MLPs and compositing ------------------------------------------------------

def _mlp(p, prefix: str, x: torch.Tensor, n: int, prec: str) -> torch.Tensor:
    for i in range(n):
        w = p[f"{prefix}.{i}.weight"]
        x = R.dense(x, w, torch.zeros(w.shape[0], device=x.device), prec)
        if i < n - 1:
            x = torch.relu(x)
    return x


def density_mlp(p, feat: torch.Tensor, nc: dict, prec: str) -> torch.Tensor:
    """features -> h [P, geo]; the density is exp(h_0)."""
    return _mlp(p, "nerf.density", feat, nc["ngp_density_hidden"] + 1, prec)


def sh16(d: torch.Tensor, degree: int) -> torch.Tensor:
    """The real SH basis of unit directions [R, 3] -> [R, degree^2],
    ``degree`` in tiny-cuda-nn's count (bands 0 to degree - 1, at most 4),
    in tiny-cuda-nn's forms for unit vectors (its SphericalHarmonics
    encoding)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    bands = [[torch.full_like(x, 0.28209479177387814)],
             [-0.48860251190291987 * y, 0.48860251190291987 * z, -0.48860251190291987 * x],
             [1.0925484305920792 * x * y, -1.0925484305920792 * y * z,
              0.94617469575755997 * zz - 0.31539156525252005, -1.0925484305920792 * x * z,
              0.54627421529603959 * (xx - yy)],
             [0.59004358992664352 * y * (-3.0 * xx + yy), 2.8906114426405538 * x * y * z,
              0.45704579946446572 * y * (1.0 - 5.0 * zz), 0.3731763325901154 * z * (5.0 * zz - 3.0),
              0.45704579946446572 * x * (1.0 - 5.0 * zz), 1.4453057213202769 * z * (xx - yy),
              0.59004358992664352 * x * (-xx + 3.0 * yy)]]
    if not 1 <= degree <= len(bands):
        raise ValueError(f"the reference carries SH degrees 1-4 (tiny-cuda-nn's count), "
                         f"not {degree}")
    return torch.stack([v for band in bands[:degree] for v in band], -1)


def field(p, xyz: torch.Tensor, dirs: torch.Tensor, nc: dict, gate, prec: str):
    """Points [R, S, 3] on rays of unit directions [R, 3] -> (raw density
    [R, S], rgb [R, S, 3])."""
    r, s = xyz.shape[:2]
    h = density_mlp(p, encode(xyz.reshape(-1, 3), p["nerf.table"], nc, gate), nc, prec)
    basis = sh16(dirs, nc["ngp_dir_degree"])
    basis = basis[:, None, :].expand(r, s, basis.shape[-1]).reshape(r * s, -1)
    rgb = torch.sigmoid(_mlp(p, "nerf.color", torch.cat([h, basis], -1),
                             nc["ngp_color_hidden"] + 1, prec))
    return h[:, 0].reshape(r, s), rgb.reshape(r, s, 3)


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h):
        ctx.save_for_backward(h)
        return torch.exp(h)

    @staticmethod
    def backward(ctx, g):
        (h,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(h, max=EXP_CLAMP))


def composite(z, h0, rgb, white_back: bool = True):
    """(rgb [R, 3], depth [R], opacity [R]) of density exp(h_0) (its
    gradient clamped at h_0 = 15, as instant-ngp's)."""
    sd = R.deltas(z) * _TruncExp.apply(h0)
    w = (1.0 - torch.exp(-sd)) * R._transmittance(sd)
    out = (w[..., None] * rgb).sum(-2)
    if white_back:
        out = out + (1.0 - w.sum(-1, keepdim=True))
    return out, (z * w).sum(-1), w.sum(-1)


# --- the occupancy map and the samples -----------------------------------------------

def occupancy_map(p, nc: dict, jitter: torch.Tensor, prec: str = "fp32") -> torch.Tensor:
    """The binary sampler map [G*G, G] of the field's density at one
    jittered point a cell, all levels on (as ``reference/nerf.py``'s of
    the coarse MLP)."""
    g, lo, hi = nc["occ_grid_size"], nc["bound_min"], nc["bound_max"]
    cell = (hi - lo) / g
    axis = lo + (torch.arange(g, dtype=torch.float32, device=jitter.device) + 0.5) * cell
    pts = torch.stack(torch.meshgrid(axis, axis, axis, indexing="ij"), -1).reshape(-1, 3)
    pts = pts + (jitter * cell - 0.5 * cell)
    act = []
    with torch.no_grad():
        for c in torch.split(pts, 65536):
            act.append(torch.exp(density_mlp(p, encode(c, p["nerf.table"], nc), nc, prec)[:, 0]))
    step = (nc["far"] - nc["near"]) / nc["occ_coarse_samples"]
    occ = (torch.cat(act).reshape(g, g, g) * step > nc["occ_thresh"]).float()
    if nc["occ_dilate"]:
        occ = F.max_pool3d(occ[None, None], 3, stride=1, padding=1)[0, 0]
    return occ.reshape(g * g, g)


def samples(occ, rays_o, rays_d, nc: dict, k: int, pdf_u=None, mix_u=None):
    """[R, k] depths: the PMF's stratified draws (``pdf_u`` [R, k - ku]; at
    the strata's midpoints when None) clipped to [near, far], and ``mix_u``'s
    ku stratified-uniform draws over [near, far], sorted."""
    z_probe, pmf = R.occupancy_pmf(occ, rays_o, rays_d, nc)
    ku = 0 if mix_u is None else mix_u.shape[-1]
    z = torch.clamp(R.sample_pdf(z_probe, pmf, k - ku, pdf_u), nc["near"], nc["far"])
    if ku:
        near, far = nc["near"], nc["far"]
        u = (torch.arange(ku, dtype=torch.float32, device=z.device)[None] + mix_u) / ku
        z = torch.sort(torch.cat([z, near + (far - near) * u], -1), -1).values
    return z


# --- the GLOBAL_OPTIM step -------------------------------------------------------------

def loss_fn(p: Dict[str, torch.Tensor], cfg: dict, scene: dict, images_u8, det, cube, draws,
            step: int, total_steps: int, occ: torch.Tensor, prec: str,
            fault: Optional[str] = None):
    """The stage-1 loss of one step: (total, {name: value}); the coarse RGB
    term is 0 (no coarse pass)."""
    nc, tc = cfg["nerf"], cfg["train"]
    h, w = scene["img_h"], scene["img_w"]
    K = R.intrinsics(p, h, w)
    slot = torch.minimum((draws.u_int * 6).long(), torch.full_like(draws.u_int, 5).long())
    rows = torch.arange(det.shape[0], device=det.device)
    pred = R.reproject(cube[slot], K, R.se3_exp(p["cam.calib_pose_se3"]))
    d = pred - det[rows, slot]
    loss_int = torch.mean((d[..., 0] / w) ** 2) + torch.mean((d[..., 1] / h) ** 2)

    idx, ids = draws.pix_idx, draws.img_ids
    pix = torch.stack([(idx % w).float() + 0.5, torch.div(idx, w, rounding_mode="floor").float()
                       + 0.5], -1)
    rays_d, rays_o = R.rays(pix, R.se3_exp(p["cam.pose_se3"])[ids], K[ids])
    rays_d, rays_o = rays_d.reshape(-1, 3), rays_o.reshape(-1, 3)
    gt = (images_u8[ids[:, None], idx].float() / 255.0).reshape(-1, 3)

    progress = torch.tensor(step, dtype=torch.int32, device=rays_d.device).float() / total_steps
    gate = level_gate(nc, progress, barf_window(cfg["stages"], cfg["barf"]))
    rd = draws.render
    z = samples(occ, rays_o, rays_d, nc, tc["importance_samples"], rd.pdf_u, rd.mix_u).detach()
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    h0, rgb = field(p, pts, rays_d, nc, gate, prec)
    out = composite(z, h0, rgb, nc["white_back"])[0]
    keep = slice(None) if fault != "half_batch" else slice(0, out.shape[0] // 2)
    loss_f = torch.mean((out[keep] - gt[keep]) ** 2)
    total = loss_int / (loss_int.detach() + 1e-6) + loss_f
    return total, {"loss": total, "loss_intr": loss_int,
                   "loss_rgb_c": torch.zeros_like(loss_f), "loss_rgb_f": loss_f}


def follow(params0: Dict[str, torch.Tensor], cfg: dict, scene: dict, images_u8, det,
           draws: List, start_step: int, total_steps: int, occ, prec: str = "fp32",
           fault: Optional[str] = None) -> dict:
    """The reference run over ``draws`` (one entry a step) from ``params0``
    (left untouched): {"loss": [each step's {term: value}], "grad": {leaf:
    the first step's clipped gradient}, "params": {leaf: after the last
    step}}, as ``reference/train.py``'s ``follow``."""
    R.no_tf32()
    tc = cfg["train"]
    p = {k: v.detach().clone() for k, v in params0.items()}
    opt = RAdam(tc["stage2_lr"], tc["weight_decay"], tc["grad_clip"])
    cube = torch.as_tensor(R.tag_points(), device=images_u8.device)
    det = torch.as_tensor(np.asarray(det), device=images_u8.device)
    losses, first_grad = [], None
    for i, d in enumerate(draws):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        total, terms = loss_fn(leaves, cfg, scene, images_u8, det, cube, d, start_step + i,
                               total_steps, occ, prec, fault)
        total.backward()
        g = {k: leaves[k].grad if leaves[k].grad is not None else torch.zeros_like(v)
             for k, v in p.items()}
        with torch.no_grad():
            opt.update(p, g)
        if first_grad is None:
            first_grad = {k: opt.mu[k] / (1.0 - 0.9) for k in p}
        losses.append({k: float(v.detach()) for k, v in terms.items()})
    return {"loss": losses, "grad": first_grad, "params": p}


# --- the eval frame --------------------------------------------------------------------

@torch.no_grad()
def render(p: Dict[str, torch.Tensor], cfg: dict, pose: torch.Tensor, K: torch.Tensor, h: int,
           w: int, occ: torch.Tensor, prec: str = "fp32", block: int = 16384):
    """(rgb [h, w, 3], depth [h, w]) of the view w2c ``pose`` with
    intrinsics ``K``: ``eval.importance_samples`` depths at the PMF's
    strata midpoints, all levels on, no noise.  Rendered in blocks of
    rays, which changes nothing: no quantity mixes rays."""
    R.no_tf32()
    nc, ev = cfg["nerf"], cfg["eval"]
    dev = pose.device
    y, x = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev) + 0.5,
                          torch.arange(w, dtype=torch.float32, device=dev) + 0.5, indexing="ij")
    pix = torch.stack([x, y], -1).reshape(1, -1, 2)
    rays_d, rays_o = R.rays(pix, pose[None].float(), K[None].float())
    rgb, depth = [], []
    for d, o in zip(torch.split(rays_d[0], block), torch.split(rays_o[0], block)):
        z = samples(occ, o, d, nc, ev["importance_samples"])
        h0, c = field(p, o[:, None, :] + d[:, None, :] * z[..., None], d, nc, None, prec)
        out, dep, _ = composite(z, h0, c, nc["white_back"])
        rgb.append(out)
        depth.append(dep)
    return torch.cat(rgb).reshape(h, w, 3), torch.cat(depth).reshape(h, w)
