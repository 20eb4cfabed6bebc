"""The plain reference of an eval frame (``render_rays_test``, importance
fine mode): the rays of every pixel, the coarse depths drawn at the
strata's midpoints from the occupancy PMF (or the uniform grid without a
map), the sigma-only coarse pass, the fine depths by inverse CDF of its
weights, the fine pass with SH shading, the composite over white.  No
noise, no jitter.  Rendered in blocks of rays, which changes nothing: no
quantity mixes rays."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from portbench.reference import nerf as R


@torch.no_grad()
def render(p: Dict[str, torch.Tensor], cfg: dict, pose: torch.Tensor, K: torch.Tensor, h: int,
           w: int, occ: Optional[torch.Tensor], prec: str = "fp32", block: int = 32768):
    """rgb [h, w, 3] of the view w2c ``pose`` [3, 4] with intrinsics ``K``."""
    R.no_tf32()
    nc, ev = cfg["nerf"], cfg["eval"]
    dev = pose.device
    y, x = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev) + 0.5,
                          torch.arange(w, dtype=torch.float32, device=dev) + 0.5, indexing="ij")
    pix = torch.stack([x, y], -1).reshape(1, -1, 2)
    rays_d, rays_o = R.rays(pix, pose[None].float(), K[None].float())
    rays_d, rays_o = rays_d[0], rays_o[0]
    out = []
    for d, o in zip(torch.split(rays_d, block), torch.split(rays_o, block)):
        basis = R.sh_basis(nc["sh_deg"], d)
        pts = lambda z: o[:, None, :] + d[:, None, :] * z[..., None]
        if occ is not None:
            z_probe, pmf = R.occupancy_pmf(occ, o, d, nc)
            z_c = torch.clamp(R.sample_pdf(z_probe, pmf, nc["occ_coarse_samples"]), nc["near"],
                              nc["far"])
        else:
            z_c = torch.linspace(nc["near"], nc["far"], nc["samples_coarse"], device=dev)
            z_c = z_c[None].expand(d.shape[0], -1)
        sig_c, _ = R.shade(p, "nerf.coarse", nc["coarse_depth"], nc["coarse_skips"], pts(z_c),
                           basis, nc, None, prec, sigma_only=True)
        z_f = R.sample_pdf(z_c, R.weights(R.deltas(z_c), sig_c), ev["importance_samples"])
        sig_f, rgb_f = R.shade(p, "nerf.fine", nc["fine_depth"], nc["fine_skips"], pts(z_f),
                               basis, nc, None, prec)
        out.append(R.composite(z_f, sig_f, rgb_f, None, nc["white_back"])[0])
    return torch.cat(out).reshape(h, w, 3)
