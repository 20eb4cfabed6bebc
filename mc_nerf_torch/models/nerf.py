"""The coarse/fine NeRF renderer: encode -> MLP -> SH shade -> composite.

Counterpart of ``mc_nerf_tpu/models/nerf.py`` (ref ``NeRF_Model``,
``model/mc_nerf.py:543-736``).  Ported: the parameters, the weight
carry-over from the JAX package, and the eval render in its uniform and
occupancy-culled importance branches, by two routes:

* the plain route (``packed=None``): ``_shade`` + ``composite`` in the
  configured compute dtype;
* the kernel route (``packed`` from :func:`pack_eval_params`): the
  sigma-only coarse pass through ``fused_mlp_apply`` and the fine pass
  through ``fused_render``, the hand-written Hopper kernels.

The grid fine mode, the coarse-free branch and the training render wait
for later slices.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mc_nerf_torch import resolve_device
from mc_nerf_torch.config import NerfConfig
from mc_nerf_torch.models.encoding import sincos_encode
from mc_nerf_torch.models.mlp import NerfMLP, apply_nerf_mlp, init_nerf_mlp
from mc_nerf_torch.models.sh import sh_basis
from mc_nerf_torch.ops.cuda.fused_mlp import (
    BASIS_LANES,
    PackedMLP,
    encode_kernel_order,
    fused_mlp_apply,
    pack_mlp_params,
)
from mc_nerf_torch.ops.cuda.fused_render import fused_render
from mc_nerf_torch.ops.occupancy import proposal_pmf
from mc_nerf_torch.ops.volume import (
    composite,
    compute_deltas,
    sample_pdf,
    sigma_to_weights,
)


class NerfParams(nn.Module):
    """The coarse and fine MLPs."""

    def __init__(self, coarse: NerfMLP, fine: NerfMLP):
        super().__init__()
        self.coarse = coarse
        self.fine = fine


def init_nerf_params(cfg: NerfConfig, generator: Optional[torch.Generator] = None,
                     device=None) -> NerfParams:
    """Fresh coarse (4x128 skip@2) and fine (8x256 skip@4) MLPs, drawn from
    ``generator``."""
    dev = resolve_device(device)
    coarse = init_nerf_mlp(cfg.embed_dim, cfg.coarse_depth, cfg.coarse_width,
                           cfg.coarse_skips, cfg.sh_dim, generator, dev)
    fine = init_nerf_mlp(cfg.embed_dim, cfg.fine_depth, cfg.fine_width,
                         cfg.fine_skips, cfg.sh_dim, generator, dev)
    return NerfParams(coarse, fine)


def _mlp_from_numpy(tree, skips: Sequence[int], device) -> NerfMLP:
    """One JAX ``NerfMLPParams`` (weights [in, out]) -> :class:`NerfMLP`."""
    trunk_w = [np.asarray(w, np.float32) for w in tree.trunk_w]
    trunk_b = [np.asarray(b, np.float32) for b in tree.trunk_b]
    sh_w1 = np.asarray(tree.sh_w1, np.float32)
    mlp = NerfMLP(trunk_w[0].shape[0], len(trunk_w), trunk_w[0].shape[1], skips,
                  sh_w1.shape[1], device=device)
    layers = list(zip(mlp.trunk, trunk_w, trunk_b)) + [
        (getattr(mlp, mod), getattr(tree, f"{head}_w{i}"), getattr(tree, f"{head}_b{i}"))
        for mod, head, i in (("sigma0", "sigma", 0), ("sigma1", "sigma", 1),
                             ("sh0", "sh", 0), ("sh1", "sh", 1))
    ]
    with torch.no_grad():
        for layer, w, b in layers:
            w = torch.tensor(np.asarray(w, np.float32))
            b = torch.tensor(np.asarray(b, np.float32))
            if tuple(layer.weight.shape) != tuple(w.T.shape):
                raise ValueError(f"weight {tuple(w.shape)} does not fit "
                                 f"Linear{tuple(layer.weight.shape[::-1])}")
            layer.weight.copy_(w.T)
            layer.bias.copy_(b)
    return mlp


def nerf_params_from_numpy(tree, cfg: NerfConfig, device=None) -> NerfParams:
    """The JAX package's ``NerfParams`` as nested numpy arrays (e.g.
    ``jax.tree.map(np.asarray, params)``) -> the
    port's :class:`NerfParams`, with the [in, out] -> [out, in] transposes
    done."""
    dev = resolve_device(device)
    return NerfParams(_mlp_from_numpy(tree.coarse, cfg.coarse_skips, dev),
                      _mlp_from_numpy(tree.fine, cfg.fine_skips, dev))


def _shade(mlp: NerfMLP, skips, xyz: torch.Tensor, basis: torch.Tensor,
           cfg: NerfConfig, freq_w: Optional[torch.Tensor], compute_dtype,
           sigma_only: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Encode points [R, S, 3], run the MLP, shade SH ->
    (sigma [R, S], rgb [R, S, 3] or None).  The SH basis is per ray and
    reused across the sample axis."""
    r, s = xyz.shape[0], xyz.shape[1]
    x_enc = sincos_encode(xyz.reshape(r * s, 3), cfg.emb_freqs_xyz, freq_w)
    sigma, sh = apply_nerf_mlp(mlp, x_enc, skips, compute_dtype, sigma_only=sigma_only)
    sigma = sigma.reshape(r, s)
    if sigma_only:
        return sigma, None
    # product in the compute dtype, sum in fp32 (as the JAX package does)
    nb = (cfg.sh_deg + 1) ** 2
    sh3 = sh.to(compute_dtype).reshape(r, s, 3, nb)
    prod = sh3 * basis.to(compute_dtype)[:, None, None, :]
    return sigma, torch.sigmoid(prod.float().sum(-1))


def pack_eval_params(params: NerfParams,
                     cfg: NerfConfig) -> Tuple[PackedMLP, PackedMLP]:
    """Kernel-layout weights for the kernel route: (coarse sigma-only, fine
    full).  Pack once per render, outside the per-chunk loop."""
    return (
        pack_mlp_params(params.coarse, cfg.emb_freqs_xyz, cfg.coarse_skips,
                        sigma_only=True),
        pack_mlp_params(params.fine, cfg.emb_freqs_xyz, cfg.fine_skips),
    )


def _shade_pallas(packed: PackedMLP, depth: int, skips, xyz: torch.Tensor,
                  cfg: NerfConfig) -> Tuple[torch.Tensor, None]:
    """Density-only kernel shading: encode -> ``fused_mlp_apply`` ->
    (sigma [R, S], None).  (The shaded variant with a basis belongs to the
    grid fine mode, not ported yet.)"""
    r, s = xyz.shape[0], xyz.shape[1]
    feat = encode_kernel_order(xyz.reshape(r * s, 3), cfg.emb_freqs_xyz, None)
    out = fused_mlp_apply(packed, feat, depth, tuple(skips))
    return out[:, 0].reshape(r, s), None


@torch.no_grad()
def render_rays_eval(
    params: NerfParams,
    rays_d: torch.Tensor,
    rays_o: torch.Tensor,
    cfg: NerfConfig,
    compute_dtype=torch.bfloat16,
    importance_samples: int = 64,
    packed: Optional[Tuple[PackedMLP, PackedMLP]] = None,
    occ: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Eval render: no jitter, no sigma noise (ref ``render_rays_test``).

    The importance fine mode (the grid fine mode and the coarse-free
    branch wait for later slices).  The coarse pass is density-only; the
    fine pass draws
    ``importance_samples`` depths per ray by deterministic inverse-CDF
    sampling of the coarse weights.  With ``occ`` (a ``[G*G, G]`` binary
    map) the coarse samples come from the occupancy PMF instead of the
    uniform grid.

    Returns (rgb [R, 3], depth [R, 1], opacity [R, 1]) from the fine pass.
    """
    n_rays = rays_d.shape[0]
    if occ is not None:
        sc = cfg.occ_coarse_samples
        z_probe, pmf = proposal_pmf(occ, rays_o, rays_d, cfg)
        # deterministic midpoint strata; clip the phantom-end-bin overhang
        z_c = torch.clamp(sample_pdf(z_probe, pmf, sc), cfg.near, cfg.far)
    else:
        sc = cfg.samples_coarse
        z_c = torch.linspace(cfg.near, cfg.far, sc, dtype=torch.float32,
                             device=rays_d.device)
        z_c = z_c[None, :].expand(n_rays, sc)
    basis = sh_basis(cfg.sh_deg, rays_d)

    xyz_c = rays_o[:, None, :] + rays_d[:, None, :] * z_c[..., None]
    if packed is not None:
        sigma_c, _ = _shade_pallas(packed[0], cfg.coarse_depth, cfg.coarse_skips,
                                   xyz_c, cfg)
    else:
        sigma_c, _ = _shade(params.coarse, cfg.coarse_skips, xyz_c, basis, cfg,
                            None, compute_dtype, sigma_only=True)
    w_sel = sigma_to_weights(compute_deltas(z_c, last_inf=True), sigma_c)

    z_f = sample_pdf(z_c, w_sel, importance_samples)                # [R, K]
    xyz_f = rays_o[:, None, :] + rays_d[:, None, :] * z_f[..., None]
    if packed is not None:
        nb = (cfg.sh_deg + 1) ** 2
        basis16 = F.pad(basis, (0, BASIS_LANES - nb)).contiguous()
        feat_f = encode_kernel_order(xyz_f.reshape(-1, 3), cfg.emb_freqs_xyz, None)
        ray_f, _ = fused_render(
            packed[1], feat_f, basis16, z_f.contiguous(), None, None,
            cfg.fine_depth, tuple(cfg.fine_skips), importance_samples, nb,
            False, False, cfg.white_back,
        )
        return ray_f[:, :3], ray_f[:, 3:4], ray_f[:, 4:5]
    sigma_f, rgb_f = _shade(params.fine, cfg.fine_skips, xyz_f, basis, cfg, None,
                            compute_dtype)
    out = composite(z_f, sigma_f, rgb_f, noise=None, white_back=cfg.white_back,
                    last_inf=True)
    return out.rgb, out.depth, out.opacity
