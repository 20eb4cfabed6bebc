"""The plain reference of MC-NeRF's GLOBAL_OPTIM train step and of its
800x800 frame, in PyTorch, float32 by default.

A frozen copy of the semantics of the reference (SkylerGao/MC_NeRF,
``model/mc_nerf.py``, ``model/net_block.py``, ``model/loss.py``) as the
port's plain route writes them (``mc_nerf_torch/models``, ``ops/volume.py``,
``ops/occupancy.py``, ``cameras/``, ``train/loss.py``, ``train/optim.py``),
with no kernel, cache or batching, and importing nothing of the port.
Every matrix product goes through :func:`dense`, whose ``prec`` picks the
operand precision: "fp32" (the reference; TF32 off) or "fp8" (e4m3 with
one scale a tensor, the forward's and the backward's products: the
control).  Parameters are a flat dict
keyed as the port's ``Params.named_parameters()`` ("cam.pose_se3",
"nerf.coarse.trunk.0.weight", ...), weights ``[out, in]``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0     # the largest finite float8_e4m3fn


def no_tf32() -> None:
    """Full float32 matrix products: an H100 otherwise may run them in TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# --- precision of the products ---------------------------------------------

def _round(x: torch.Tensor, prec: str) -> torch.Tensor:
    """``x`` rounded to ``prec`` and back to fp32: fp8 e4m3 under one scale
    a tensor (its largest magnitude to 448)."""
    if prec == "fp8":
        scale = FP8_MAX / x.abs().amax().clamp(min=1e-30)
        return (x * scale).to(torch.float8_e4m3fn).float() / scale
    raise ValueError(f"unknown precision {prec!r}")


class _Dense(torch.autograd.Function):
    """x @ w.T + b with every product's operands rounded to ``prec``, the
    forward's and the backward's (dx = dy w, dw = dy^T x), accumulated in
    fp32."""

    @staticmethod
    def forward(ctx, x, w, b, prec):
        xq, wq = _round(x, prec), _round(w, prec)
        ctx.save_for_backward(xq, wq)
        ctx.prec = prec
        return xq @ wq.t() + b

    @staticmethod
    def backward(ctx, dy):
        xq, wq = ctx.saved_tensors
        dq = _round(dy, ctx.prec)
        return dq @ wq, dq.t() @ xq, dy.sum(0), None


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, prec: str = "fp32") -> torch.Tensor:
    """x @ w.T + b with both operands in ``prec`` (the backward's too),
    accumulated in fp32."""
    if prec == "fp32":
        return x @ w.t() + b
    return _Dense.apply(x, w, b, prec)


# --- the field: encode, MLP, SH shading --------------------------------------

def barf_weights(n_freqs: int, progress: torch.Tensor, start: float, end: float) -> torch.Tensor:
    """[L] BARF gate: octave k ramps with a half cosine as
    ``(progress - start) / (end - start) * L`` crosses [k, k + 1]."""
    alpha = (progress - start) / (end - start) * n_freqs
    k = torch.arange(n_freqs, dtype=torch.float32, device=progress.device)
    return (1.0 - torch.cos(torch.clamp(alpha - k, 0.0, 1.0) * math.pi)) / 2.0


def encode(x: torch.Tensor, n_freqs: int, gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[P, 3] -> [P, 3 (2L + 1)]: ``[x | per axis sin(2^f x) for f < L,
    cos(2^f x) for f < L]``, the octaves by the double-angle recurrence
    (``net_block.py:6-35``)."""
    s, c = [torch.sin(x)], [torch.cos(x)]
    for _ in range(n_freqs - 1):
        s.append(2.0 * s[-1] * c[-1])
        c.append(1.0 - 2.0 * s[-2] * s[-2])
    sin, cos = torch.stack(s, -1), torch.stack(c, -1)           # [P, 3, L]
    if gate is not None:
        sin, cos = sin * gate, cos * gate
    return torch.cat([x, torch.stack([sin, cos], -2).reshape(x.shape[0], 6 * n_freqs)], -1)


def mlp(p: Dict[str, torch.Tensor], prefix: str, x0: torch.Tensor, depth: int, skips,
        prec: str, sigma_only: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Trunk of ``depth`` ReLU layers (the encoded input concatenated in
    front at each skip), then the density head and the SH head, each two
    layers: (sigma [P], sh [P, 3 nb] or None)."""
    h = x0
    for i in range(depth):
        if i in skips:
            h = torch.cat([x0, h], -1)
        h = torch.relu(dense(h, p[f"{prefix}.trunk.{i}.weight"], p[f"{prefix}.trunk.{i}.bias"],
                             prec))
    s = torch.relu(dense(h, p[f"{prefix}.sigma0.weight"], p[f"{prefix}.sigma0.bias"], prec))
    sigma = dense(s, p[f"{prefix}.sigma1.weight"], p[f"{prefix}.sigma1.bias"], prec)[:, 0]
    if sigma_only:
        return sigma, None
    c = torch.relu(dense(h, p[f"{prefix}.sh0.weight"], p[f"{prefix}.sh0.bias"], prec))
    return sigma, dense(c, p[f"{prefix}.sh1.weight"], p[f"{prefix}.sh1.bias"], prec)


def sh_basis(deg: int, d: torch.Tensor) -> torch.Tensor:
    """Real SH basis of degree 0-2 at unit directions [R, 3] -> [R, (deg+1)^2]
    (``net_utils.py:103-191``)."""
    if not 0 <= deg <= 2:
        raise ValueError(f"the reference carries SH degrees 0-2, not {deg}")
    out = [torch.full(d.shape[:-1], 0.28209479177387814, dtype=d.dtype, device=d.device)]
    if deg > 0:
        x, y, z = d[..., 0], d[..., 1], d[..., 2]
        c1 = 0.4886025119029199
        out += [-c1 * y, c1 * z, -c1 * x]
        if deg > 1:
            out += [1.0925484305920792 * x * y, -1.0925484305920792 * y * z,
                    0.31539156525252005 * (2.0 * z * z - x * x - y * y),
                    -1.0925484305920792 * x * z, 0.5462742152960396 * (x * x - y * y)]
    return torch.stack(out, -1)


def shade(p, prefix: str, depth: int, skips, xyz: torch.Tensor, basis: torch.Tensor,
          nc: dict, gate, prec: str, sigma_only: bool = False):
    """Points [R, S, 3] -> (sigma [R, S], rgb [R, S, 3] or None): encode,
    MLP, rgb = sigmoid(sum over the basis of sh * basis)."""
    r, s = xyz.shape[:2]
    sigma, sh = mlp(p, prefix, encode(xyz.reshape(r * s, 3), nc["emb_freqs_xyz"], gate),
                    depth, skips, prec, sigma_only)
    if sigma_only:
        return sigma.reshape(r, s), None
    nb = basis.shape[-1]
    rgb = torch.sigmoid((sh.reshape(r, s, 3, nb) * basis[:, None, None, :]).sum(-1))
    return sigma.reshape(r, s), rgb


# --- volume rendering and sampling -------------------------------------------

def deltas(z: torch.Tensor, last_inf: bool = True, max_delta: Optional[float] = None):
    d = z[..., 1:] - z[..., :-1]
    if max_delta is not None:
        d = torch.clamp(d, max=max_delta)
    last = torch.full_like(d[..., :1], 1e10) if last_inf else d[..., -1:]
    return torch.cat([d, last], -1)


def _transmittance(sd: torch.Tensor) -> torch.Tensor:
    return torch.exp(-torch.cumsum(torch.cat([torch.zeros_like(sd[..., :1]), sd[..., :-1]], -1),
                                   -1))


def weights(dl: torch.Tensor, sigma: torch.Tensor, noise: Optional[torch.Tensor] = None):
    """alpha_i T_i of softplus(sigma + noise) (``sigma2weights``)."""
    sd = dl * F.softplus(sigma if noise is None else sigma + noise)
    return (1.0 - torch.exp(-sd)) * _transmittance(sd)


def composite(z, sigma, rgb, noise=None, white_back=True, last_inf=True, max_delta=None):
    """(rgb [R, 3], depth [R], opacity [R]): the colour from the (noisy)
    weights over a white background, depth and opacity noise-free
    (``mc_nerf.py:705-727``)."""
    dl = deltas(z, last_inf, max_delta)
    prob = weights(dl, sigma)
    w = prob if noise is None else weights(dl, sigma, noise)
    out = (w[..., None] * rgb).sum(-2)
    if white_back:
        out = out + (1.0 - w.sum(-1, keepdim=True))
    return out, (z * prob).sum(-1), prob.sum(-1)


def sample_pdf(z: torch.Tensor, w: torch.Tensor, n: int, u: Optional[torch.Tensor] = None,
               eps: float = 1e-5) -> torch.Tensor:
    """Inverse-CDF depths [R, n] from weights at sorted depths [R, S]:
    bins between the midpoints, the end weights dropped, stratified by
    ``u`` (or at the strata's midpoints)."""
    mids = 0.5 * (z[..., 1:] + z[..., :-1])
    pw = w[..., 1:-1] + eps
    cdf = torch.cumsum(pw / pw.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)            # [R, S-1]
    strata = torch.arange(n, dtype=torch.float32, device=z.device)
    uu = ((strata + 0.5) / n).expand(*cdf.shape[:-1], n) if u is None else (strata + u) / n
    uu = torch.clamp(uu, max=1.0 - 1e-6).contiguous()
    hi = torch.searchsorted(cdf.contiguous(), uu, right=True)             # first cdf > u
    lo = hi - 1
    hi = hi.clamp(max=cdf.shape[-1] - 1)
    c_lo, c_hi = torch.gather(cdf, -1, lo), torch.gather(cdf, -1, hi)
    z_lo, z_hi = torch.gather(mids, -1, lo), torch.gather(mids, -1, hi)
    span = c_hi - c_lo
    t = (uu - c_lo) / torch.where(span < 1e-8, torch.ones_like(span), span)
    # a u past the last cdf has no upper bracket: the interpolation is then moot
    top = uu >= cdf[..., -1:]
    return torch.where(top, z_lo, z_lo + t * (z_hi - z_lo))


def select_bins(w: torch.Tensor, k: int, thresh: float, batch_max=None):
    """The first k bins in depth order whose weight reaches
    ``min(thresh, max weight of the batch)``: (bin index [R, k] ascending,
    valid [R, k]); an unused slot holds the last bin."""
    cut = torch.clamp(w.max() if batch_max is None else batch_max, max=thresh)
    keep = w >= cut
    s = w.shape[-1]
    idx = torch.arange(s, device=w.device)
    order = torch.where(keep, idx, s + idx)
    idx = torch.sort(order, -1).values[:, :k]
    valid = idx < s
    return torch.where(valid, idx, torch.full_like(idx, s - 1)), valid


# --- occupancy ------------------------------------------------------------------

def occupancy_map(p, nc: dict, jitter: torch.Tensor, prec: str) -> torch.Tensor:
    """The binary sampler map [G*G, G] (row ix*G + iy, column iz) of the
    coarse field: softplus(sigma) at one jittered point a cell, occupied
    where times the culled coarse step it passes ``occ_thresh``, dilated by
    a 3^3 max (``ops/occupancy.py``)."""
    g, lo, hi = nc["occ_grid_size"], nc["bound_min"], nc["bound_max"]
    cell = (hi - lo) / g
    axis = lo + (torch.arange(g, dtype=torch.float32, device=jitter.device) + 0.5) * cell
    pts = torch.stack(torch.meshgrid(axis, axis, axis, indexing="ij"), -1).reshape(-1, 3)
    pts = pts + (jitter * cell - 0.5 * cell)
    act = []
    with torch.no_grad():
        for c in torch.split(pts, 65536):
            sigma, _ = mlp(p, "nerf.coarse", encode(c, nc["emb_freqs_xyz"]), nc["coarse_depth"],
                           nc["coarse_skips"], prec, sigma_only=True)
            act.append(F.softplus(sigma))
    step = (nc["far"] - nc["near"]) / nc["occ_coarse_samples"]
    occ = (torch.cat(act).reshape(g, g, g) * step > nc["occ_thresh"]).float()
    if nc["occ_dilate"]:
        occ = F.max_pool3d(occ[None, None], 3, stride=1, padding=1)[0, 0]
    return occ.reshape(g * g, g)


def occupancy_pmf(occ: torch.Tensor, rays_o, rays_d, nc: dict):
    """(probe depths [R, P+2], PMF [R, P+2]): the map at ``occ_probes``
    depths over [near, far], floored, one zero bin beyond each end."""
    p = nc["occ_probes"]
    h = (nc["far"] - nc["near"]) / (p - 1)
    z = torch.linspace(nc["near"] - h, nc["far"] + h, p + 2, dtype=torch.float32,
                       device=rays_o.device).expand(rays_o.shape[0], p + 2)
    x = rays_o[:, None, :] + rays_d[:, None, :] * z[:, 1:-1, None]
    g = occ.shape[-1]
    lo, hi = nc["bound_min"], nc["bound_max"]
    i = torch.floor((x - lo) / (hi - lo) * g).long()
    inside = ((i >= 0) & (i < g)).all(-1)
    i = i.clamp(0, g - 1)
    val = occ[i[..., 0] * g + i[..., 1], i[..., 2]].float() * inside.float()
    return z, F.pad(val + nc["occ_floor"], (1, 1))


# --- cameras ------------------------------------------------------------------------

def _skew(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def se3_exp(wu: torch.Tensor) -> torch.Tensor:
    """Twists [N, 6] (rotation | translation) -> [N, 3, 4] w2c poses."""
    w, u = wu[..., :3], wu[..., 3:]
    wx = _skew(w)
    wx2 = (wx[..., :, :, None] * wx[..., None, :, :]).sum(-2)
    t2 = (w * w).sum(-1)
    small = t2 < 1e-8
    t = torch.sqrt(torch.where(small, torch.ones_like(t2), t2))
    a = torch.where(small, 1 - t2 / 6 + t2 * t2 / 120, torch.sin(t) / t)
    b = torch.where(small, 0.5 - t2 / 24 + t2 * t2 / 720, (1 - torch.cos(t)) / (t * t))
    c = torch.where(small, 1 / 6 - t2 / 120 + t2 * t2 / 5040, (t - torch.sin(t)) / (t * t * t))
    eye = torch.eye(3, dtype=wu.dtype, device=wu.device).expand(wx.shape)
    R = eye + a[..., None, None] * wx + b[..., None, None] * wx2
    V = eye + b[..., None, None] * wx + c[..., None, None] * wx2
    return torch.cat([R, (V * u[..., None, :]).sum(-1)[..., None]], -1)


def intrinsics(p, h: int, w: int) -> torch.Tensor:
    """[N, 3, 3]: |multiplier x init| with init fx = fy = W, cx = W/2, cy = H/2."""
    fx, fy = torch.abs(p["cam.fx"] * w), torch.abs(p["cam.fy"] * w)
    cx, cy = torch.abs(p["cam.ux"] * (w / 2.0)), torch.abs(p["cam.uy"] * (h / 2.0))
    z, o = torch.zeros_like(fx), torch.ones_like(fx)
    return torch.stack([torch.stack([fx, z, cx], -1), torch.stack([z, fy, cy], -1),
                        torch.stack([z, z, o], -1)], -2)


def rays(pix_xy: torch.Tensor, pose: torch.Tensor, K: torch.Tensor):
    """Pixel centres [B, P, 2], w2c poses [B, 3, 4], K [B, 3, 3] -> (unit
    world directions, origins), each [B, P, 3]."""
    dx = (pix_xy[..., 0] - K[:, None, 0, 2]) / K[:, None, 0, 0]
    dy = (pix_xy[..., 1] - K[:, None, 1, 2]) / K[:, None, 1, 1]
    d = torch.stack([dx, dy, torch.ones_like(dx)], -1)
    R, t = pose[..., :3], pose[..., 3]
    dw = (R[:, None, :, :] * d[..., :, None]).sum(-2)
    o = -(R * t[..., :, None]).sum(-2)
    dw = dw / torch.linalg.norm(dw, dim=-1, keepdim=True)
    return dw, o[:, None, :].expand(dw.shape)


def reproject(world: torch.Tensor, K: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """World points [N, P, 3] -> pixels [N, P, 2] through w2c poses and K."""
    R, t = pose[..., :3], pose[..., 3]
    cam = (R[:, None, :, :] * world[..., None, :]).sum(-1) + t[:, None, :]
    proj = (K[:, None, :, :] * cam[..., None, :]).sum(-1)
    z = proj[..., 2:3]
    z = torch.where(torch.abs(z) < 1e-6, torch.where(z < 0, -1e-6, 1e-6) + 0 * z, z)
    return proj[..., :2] / z


def tag_points(tag_size: float = 1.0) -> np.ndarray:
    """[6, 5, 3] keypoints (centre, lt, rt, rb, lb) of the six cube tags,
    each 0.8 of the edge (``data_read.py:300-336``)."""
    faces = (((0, -1, 0), (1, 0, 0), (0, 0, 1)), ((1, 0, 0), (0, 1, 0), (0, 0, 1)),
             ((0, 1, 0), (-1, 0, 0), (0, 0, 1)), ((-1, 0, 0), (0, -1, 0), (0, 0, 1)),
             ((0, 0, 1), (1, 0, 0), (0, 1, 0)), ((0, 0, -1), (1, 0, 0), (0, -1, 0)))
    out = np.zeros((6, 5, 3), np.float32)
    for i, (n, u, v) in enumerate(faces):
        n, u, v = (np.array(a, np.float64) for a in (n, u, v))
        c, hh = n * tag_size / 2.0, tag_size * 0.4
        out[i] = [c, c + (-u + v) * hh, c + (u + v) * hh, c + (u - v) * hh, c + (-u - v) * hh]
    return out
