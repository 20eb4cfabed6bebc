"""The plain reference of the GLOBAL_OPTIM step (stage 1): the loss of
``model/mc_nerf.py:58-105`` (the self-normalized intrinsic reprojection
loss plus the coarse and fine RGB losses, the BARF gate on), its gradient
by autograd, the global-norm clip and the masked RAdam update with
decoupled weight decay (``train/optim.py``'s rule, optax's order).

:func:`follow` takes the benchmark's initial parameters and each step's
draws and returns what the benchmark compares: each step's loss, the
first step's gradient as the optimizer gets it, and the parameters after
the steps.  ``fault`` plants one of the faults the check must catch:
"half_batch" (the RGB means over the first half of the rays alone).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from portbench.reference import nerf as R

B1, B2, EPS, RHO_MIN = 0.9, 0.999, 1e-8, 5.0


def barf_window(stages: dict, barf: dict):
    """(start, end) of the BARF ramp in global progress (``data_read.py:338-351``)."""
    total = float(stages["cam_param_epochs"] + stages["global_opt_epochs"]
                  + stages["fine_tune_epochs"])
    g0 = stages["cam_param_epochs"] / total + barf["start"]
    g1 = (stages["cam_param_epochs"] + stages["global_opt_epochs"]) / total
    return g0, g0 + (g1 - g0) * barf["end"]


def loss_fn(p: Dict[str, torch.Tensor], cfg: dict, scene: dict, images_u8, det, cube, draws,
            step: int, total_steps: int, occ: Optional[torch.Tensor], prec: str,
            fault: Optional[str] = None):
    """The stage-1 loss of one step: (total, {name: value})."""
    nc, tc = cfg["nerf"], cfg["train"]
    h, w = scene["img_h"], scene["img_w"]
    K = R.intrinsics(p, h, w)
    # one visible tag a calibration image (every tag is visible here)
    slot = torch.minimum((draws.u_int * 6).long(), torch.full_like(draws.u_int, 5).long())
    rows = torch.arange(det.shape[0], device=det.device)
    pred = R.reproject(cube[slot], K, R.se3_exp(p["cam.calib_pose_se3"]))
    d = pred - det[rows, slot]
    loss_int = torch.mean((d[..., 0] / w) ** 2) + torch.mean((d[..., 1] / h) ** 2)

    idx = draws.pix_idx
    pix = torch.stack([(idx % w).float() + 0.5, torch.div(idx, w, rounding_mode="floor").float()
                       + 0.5], -1)
    ids = draws.img_ids
    rays_d, rays_o = R.rays(pix, R.se3_exp(p["cam.pose_se3"])[ids], K[ids])
    rays_d, rays_o = rays_d.reshape(-1, 3), rays_o.reshape(-1, 3)
    gt = (images_u8[ids[:, None], idx].float() / 255.0).reshape(-1, 3)

    progress = torch.tensor(step, dtype=torch.int32, device=rays_d.device).float() / total_steps
    gate = R.barf_weights(nc["emb_freqs_xyz"], progress, *barf_window(cfg["stages"], cfg["barf"]))
    basis = R.sh_basis(nc["sh_deg"], rays_d)
    pts = lambda z: rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    rd = draws.render
    near, far = nc["near"], nc["far"]
    if occ is not None:
        z_probe, pmf = R.occupancy_pmf(occ, rays_o, rays_d, nc)
        z_c = torch.clamp(R.sample_pdf(z_probe, pmf, nc["occ_coarse_samples"], rd.z_u), near, far)
    else:
        sc = nc["samples_coarse"]
        z_c = torch.linspace(near, far, sc, dtype=torch.float32, device=rays_d.device)[None]
        z_c = z_c + rd.z_u
    z_c = z_c.detach()
    sig_c, rgb_c = R.shade(p, "nerf.coarse", nc["coarse_depth"], nc["coarse_skips"], pts(z_c),
                           basis, nc, gate, prec)
    out_c = R.composite(z_c, sig_c, rgb_c, rd.noise_c, nc["white_back"])[0]
    w_sel = R.weights(R.deltas(z_c), sig_c.detach(), rd.noise_sel)
    if tc["fine_mode"] == "importance":
        z_f = R.sample_pdf(z_c, w_sel, tc["importance_samples"], rd.pdf_u).detach()
        sig_f, rgb_f = R.shade(p, "nerf.fine", nc["fine_depth"], nc["fine_skips"], pts(z_f),
                               basis, nc, gate, prec)
        out_f = R.composite(z_f, sig_f, rgb_f, rd.noise_f, nc["white_back"])[0]
    else:
        bins, valid = R.select_bins(w_sel, nc["fine_bins_topk"], nc["weight_thresh"])
        scale = nc["sample_scale"]
        sidx = (bins[..., None] * scale + torch.arange(scale, device=bins.device)).flatten(1)
        svalid = valid[..., None].expand(*valid.shape, scale).flatten(1)
        step_f = (far - near) / (nc["samples_coarse"] * scale - 1)
        z_f = (near + sidx.float() * step_f) + rd.z_u
        sig_f, rgb_f = R.shade(p, "nerf.fine", nc["fine_depth"], nc["fine_skips"], pts(z_f),
                               basis, nc, gate, prec)
        sig_f = torch.where(svalid, sig_f, nc["sigma_default"])
        rgb_f = torch.where(svalid[..., None], rgb_f, 1.0)
        out_f = R.composite(z_f, sig_f, rgb_f, rd.noise_f, nc["white_back"], last_inf=False,
                            max_delta=step_f)[0]
    keep = slice(None) if fault != "half_batch" else slice(0, out_f.shape[0] // 2)
    loss_c = torch.mean((out_c[keep] - gt[keep]) ** 2)
    loss_f = torch.mean((out_f[keep] - gt[keep]) ** 2)
    total = loss_int / (loss_int.detach() + 1e-6) + loss_c + loss_f
    return total, {"loss": total, "loss_intr": loss_int, "loss_rgb_c": loss_c,
                   "loss_rgb_f": loss_f}


class RAdam:
    """Clip by global norm -> RAdam (threshold 5, the unrectified moment
    below it) -> decoupled weight decay -> the learning rate, over the
    leaves in order, every leaf trainable (stage 1)."""

    def __init__(self, lr: float, weight_decay: float, clip: float):
        self.lr, self.wd, self.clip = lr, weight_decay, clip
        self.mu = self.nu = None
        self.t = 0

    def update(self, p: Dict[str, torch.Tensor], g: Dict[str, torch.Tensor]) -> None:
        keys = list(p)
        if self.mu is None:
            self.mu = {k: torch.zeros_like(p[k]) for k in keys}
            self.nu = {k: torch.zeros_like(p[k]) for k in keys}
        if self.clip > 0:
            gn = torch.sqrt(sum((g[k] * g[k]).sum() for k in keys))
            g = {k: g[k] * (self.clip / torch.clamp(gn, min=self.clip)) for k in keys}
        self.t += 1
        t = torch.tensor(float(self.t), device=p[keys[0]].device)
        b1t, b2t = B1 ** t, B2 ** t
        ro_inf = 2.0 / (1.0 - B2) - 1.0
        ro = ro_inf - 2.0 * t * b2t / (1.0 - b2t)
        for k in keys:
            self.mu[k].mul_(B1).add_((1.0 - B1) * g[k])
            self.nu[k].mul_(B2).add_((1.0 - B2) * g[k] * g[k])
            mu_hat, nu_hat = self.mu[k] / (1.0 - b1t), self.nu[k] / (1.0 - b2t)
            if ro >= RHO_MIN:
                r = torch.sqrt((ro - 4) * (ro - 2) * ro_inf / ((ro_inf - 4) * (ro_inf - 2) * ro))
                upd = r * mu_hat / (torch.sqrt(nu_hat) + EPS)
            else:
                upd = mu_hat
            p[k].sub_((upd + self.wd * p[k]) * self.lr)


def follow(params0: Dict[str, torch.Tensor], cfg: dict, scene: dict, images_u8, det, draws: List,
           start_step: int, total_steps: int, occ, prec: str = "fp32",
           fault: Optional[str] = None) -> dict:
    """The reference run over ``draws`` (one entry a step) from
    ``params0`` (left untouched): {"loss": [each step's {term: value}],
    "grad": {leaf: the first step's clipped gradient}, "params": {leaf:
    after the last step}}."""
    R.no_tf32()
    tc = cfg["train"]
    p = {k: v.detach().clone() for k, v in params0.items()}
    opt = RAdam(tc["stage2_lr"], tc["weight_decay"], tc["grad_clip"])
    cube = torch.as_tensor(R.tag_points(), device=images_u8.device)
    det = torch.as_tensor(det, device=images_u8.device)
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
            first_grad = {k: opt.mu[k] / (1.0 - B1) for k in p}
        losses.append({k: float(v.detach()) for k, v in terms.items()})
    return {"loss": losses, "grad": first_grad, "params": p}
