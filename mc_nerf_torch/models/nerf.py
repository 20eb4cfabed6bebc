"""The coarse/fine NeRF renderer: encode -> MLP -> SH shade -> composite.

Counterpart of ``mc_nerf_tpu/models/nerf.py`` (ref ``NeRF_Model``,
``model/mc_nerf.py:543-736``).  Ported: the parameters, the weight
carry-over from the JAX package, and the eval and training renders in
both fine modes: importance (uniform or occupancy-culled coarse samples,
inverse-CDF fine samples) and the reference-faithful grid (threshold /
top-k bins of the fine grid), by two routes:

* the plain route: ``_shade`` + ``composite`` in the configured compute
  dtype (autograd for training);
* the kernel route: for eval the sigma-only coarse pass through
  ``fused_mlp_apply``, the fine pass through ``fused_render``
  (importance) or ``fused_shaded_mlp`` + ``composite`` (grid); for
  training both passes through the differentiable ``fused_render``
  (importance) or ``fused_shaded_mlp`` (grid), hand-written forward and
  backward kernels, on an fp32 pack.

Both renders also have the coarse-free branch (``coarse_free=True``,
importance mode with an occupancy map): the fine depths come straight
from the occupancy PMF (``proposal_pmf``; in training the mixture of
:func:`mixture_samples`), no coarse pass runs, and the fine pass is the
two-pass renders' own.  The ``field: hashgrid`` field
(:mod:`mc_nerf_torch.models.ngp`, :class:`NgpField` in place of
:class:`NerfParams`) renders on that branch alone, its exp density
composited with no sigma noise.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mc_nerf_torch import resolve_device
from mc_nerf_torch.config import NerfConfig
from mc_nerf_torch.models.encoding import barf_weights, sincos_encode
from mc_nerf_torch.models.hashgrid import level_gate
from mc_nerf_torch.models.mlp import NerfMLP, apply_nerf_mlp, init_nerf_mlp
from mc_nerf_torch.models.ngp import NgpField, init_ngp_field, ngp_shade
from mc_nerf_torch.models.sh import sh_basis
from mc_nerf_torch.ops.cuda.fused_mlp import (
    BASIS_LANES,
    PackedMLP,
    encode_kernel_order,
    fused_mlp_apply,
    fused_shaded_mlp,
    pack_mlp_params,
)
from mc_nerf_torch.ops.cuda.fused_render import fused_render
from mc_nerf_torch.ops.occupancy import mixture_samples, mixture_split, proposal_pmf
from mc_nerf_torch.ops.volume import (
    CompositeResult,
    composite,
    compute_deltas,
    expand_bins_to_samples,
    sample_pdf,
    select_fine_bins,
    sigma_to_weights,
)


class NerfParams(nn.Module):
    """The coarse and fine MLPs."""

    def __init__(self, coarse: NerfMLP, fine: NerfMLP):
        super().__init__()
        self.coarse = coarse
        self.fine = fine


def init_nerf_params(cfg: NerfConfig, generator: Optional[torch.Generator] = None,
                     device=None):
    """Fresh coarse (4x128 skip@2) and fine (8x256 skip@4) MLPs, drawn from
    ``generator``; for ``cfg.field == "hashgrid"`` a fresh
    :class:`NgpField` instead."""
    dev = resolve_device(device)
    if cfg.field == "hashgrid":
        return init_ngp_field(cfg, generator, dev)
    if cfg.field != "mlp":
        raise ValueError(f"unknown nerf.field: {cfg.field!r} (mlp | hashgrid)")
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


def _basis16(basis: torch.Tensor, cfg: NerfConfig) -> Tuple[torch.Tensor, int]:
    """[R, nb] SH basis -> ([R, 16] padded, nb)."""
    nb = (cfg.sh_deg + 1) ** 2
    return F.pad(basis, (0, BASIS_LANES - nb)).contiguous(), nb


def _shade_pallas(packed: PackedMLP, depth: int, skips, xyz: torch.Tensor,
                  basis: Optional[torch.Tensor], cfg: NerfConfig
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Kernel shading: encode -> ``fused_mlp_apply`` (``basis=None``: the
    density-only coarse pass, returns (sigma [R, S], None)) or
    ``fused_shaded_mlp`` with the SH shading in the kernel (returns
    (sigma [R, S], rgb [R, S, 3]))."""
    r, s = xyz.shape[0], xyz.shape[1]
    feat = encode_kernel_order(xyz.reshape(r * s, 3), cfg.emb_freqs_xyz, None)
    if basis is None:
        out = fused_mlp_apply(packed, feat, depth, tuple(skips))
        return out[:, 0].reshape(r, s), None
    basis16, nb = _basis16(basis, cfg)
    out = fused_shaded_mlp(packed, feat, basis16, depth, tuple(skips), s, nb)
    return out[:, 0].reshape(r, s), out[:, 1:4].reshape(r, s, 3)


def _shade_train_kernel(mlp: NerfMLP, depth: int, skips, xyz: torch.Tensor,
                        basis: torch.Tensor, cfg: NerfConfig,
                        freq_w: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training shade through the differentiable ``fused_shaded_mlp`` on an
    fp32 pack (the kernels cast to bf16 once per call): gradients reach the
    weights through the pack, the cameras through dfeat -> encode -> xyz
    and dbasis -> sh_basis -> ray directions.  (sigma [R, S], rgb
    [R, S, 3])."""
    r, s = xyz.shape[0], xyz.shape[1]
    packed = pack_mlp_params(mlp, cfg.emb_freqs_xyz, skips, dtype=torch.float32)
    feat = encode_kernel_order(xyz.reshape(r * s, 3), cfg.emb_freqs_xyz, freq_w)
    basis16, nb = _basis16(basis, cfg)
    out = fused_shaded_mlp(packed, feat, basis16, depth, tuple(skips), s, nb)
    return out[:, 0].reshape(r, s), out[:, 1:4].reshape(r, s, 3)


def _grid_fine_depths(w_sel: torch.Tensor, cfg: NerfConfig,
                      batch_max: Optional[torch.Tensor] = None):
    """Grid fine mode: the selected bins' fine-grid sample indices ->
    (depths [R, k * scale] on the fine grid, validity, the grid step).
    linspace is affine in the index, so depths come from the index
    directly (JAX ``models/nerf.py:366-374``).  ``batch_max``: the
    selection cutoff's batch max (``select_fine_bins``)."""
    bin_idx, valid = select_fine_bins(w_sel, cfg.fine_bins_topk, cfg.weight_thresh, batch_max)
    sample_idx, sample_valid = expand_bins_to_samples(bin_idx, valid, cfg.sample_scale)
    step_f = (cfg.far - cfg.near) / (cfg.samples_fine_grid - 1)
    return cfg.near + sample_idx.float() * step_f, sample_valid, step_f


def _grid_composite(z_f, sigma_f, rgb_f, sample_valid, step_f, cfg: NerfConfig,
                    noise: Optional[torch.Tensor]):
    """Unselected fine samples behave as sigma_default / white (ref
    mc_nerf.py:692-694); the gathered subset of the uniform fine grid
    composites with each delta capped at the grid step and no 1e10 last
    delta (the reference composites the full grid)."""
    sigma_f = torch.where(sample_valid, sigma_f, cfg.sigma_default)
    rgb_f = torch.where(sample_valid[..., None], rgb_f, 1.0)
    return composite(z_f, sigma_f, rgb_f, noise=noise, white_back=cfg.white_back,
                     last_inf=False, max_delta=step_f)


@torch.no_grad()
def render_rays_eval(
    params: NerfParams,
    rays_d: torch.Tensor,
    rays_o: torch.Tensor,
    cfg: NerfConfig,
    compute_dtype=torch.bfloat16,
    fine_mode: str = "importance",
    importance_samples: int = 64,
    packed: Optional[Tuple[PackedMLP, PackedMLP]] = None,
    occ: Optional[torch.Tensor] = None,
    coarse_free: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Eval render: no jitter, no sigma noise (ref ``render_rays_test``).

    The coarse pass is density-only.  Two fine modes:

    * ``"importance"``: ``importance_samples`` depths per ray by
      deterministic inverse-CDF sampling of the coarse weights; with
      ``occ`` (a ``[G*G, G]`` sampler map) the coarse samples come from the
      occupancy PMF instead of the uniform grid.  ``coarse_free`` (needs
      ``occ``) draws the fine depths from the occupancy PMF itself and
      runs no coarse pass.
    * ``"grid"`` (reference-faithful): threshold + top-k bins on the
      ``sample_scale``-times-finer grid, unselected slots defaulting to
      sigma_default / white (mc_nerf.py:692-694).  The threshold's cutoff
      is a max over all rays given (one eval chunk).  No occupancy map.

    Returns (rgb [R, 3], depth [R, 1], opacity [R, 1]) from the fine pass.
    """
    if fine_mode not in ("importance", "grid"):
        raise ValueError(f"unknown eval fine_mode: {fine_mode!r}")
    if coarse_free and (occ is None or fine_mode != "importance"):
        raise ValueError("coarse_free requires an occupancy map and fine_mode='importance'")
    if occ is not None and fine_mode != "importance":
        raise ValueError("occupancy culling requires fine_mode='importance'")
    if isinstance(params, NgpField) and not coarse_free:
        raise ValueError("the hashgrid field renders coarse-free only: it has no coarse MLP")
    if isinstance(params, NgpField):
        # the strata's midpoints of the PMF, all levels on
        z_probe, pmf = proposal_pmf(occ, rays_o, rays_d, cfg)
        z = torch.clamp(sample_pdf(z_probe, pmf, importance_samples), cfg.near, cfg.far)
        out = _ngp_composite(params, rays_d, rays_o, z, cfg, None, compute_dtype)
        return out.rgb, out.depth, out.opacity
    n_rays = rays_d.shape[0]
    basis = sh_basis(cfg.sh_deg, rays_d)

    def points(z):
        return rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]

    def shade_fine(z_f):
        if packed is not None:
            return _shade_pallas(packed[1], cfg.fine_depth, cfg.fine_skips, points(z_f),
                                 basis, cfg)
        return _shade(params.fine, cfg.fine_skips, points(z_f), basis, cfg, None,
                      compute_dtype)

    def importance_fine(z_f):
        if packed is not None:
            basis16, nb = _basis16(basis, cfg)
            feat_f = encode_kernel_order(points(z_f).reshape(-1, 3), cfg.emb_freqs_xyz, None)
            ray_f, _ = fused_render(
                packed[1], feat_f, basis16, z_f.contiguous(), None, None,
                cfg.fine_depth, tuple(cfg.fine_skips), importance_samples, nb,
                False, False, cfg.white_back,
            )
            return ray_f[:, :3], ray_f[:, 3:4], ray_f[:, 4:5]
        sigma_f, rgb_f = shade_fine(z_f)
        out = composite(z_f, sigma_f, rgb_f, noise=None, white_back=cfg.white_back,
                        last_inf=True)
        return out.rgb, out.depth, out.opacity

    if occ is not None:
        z_probe, pmf = proposal_pmf(occ, rays_o, rays_d, cfg)
        # deterministic midpoint strata; clip the phantom-end-bin overhang
        if coarse_free:
            return importance_fine(torch.clamp(sample_pdf(z_probe, pmf, importance_samples),
                                               cfg.near, cfg.far))
        sc = cfg.occ_coarse_samples
        z_c = torch.clamp(sample_pdf(z_probe, pmf, sc), cfg.near, cfg.far)
    else:
        sc = cfg.samples_coarse
        z_c = torch.linspace(cfg.near, cfg.far, sc, dtype=torch.float32,
                             device=rays_d.device)
        z_c = z_c[None, :].expand(n_rays, sc)

    if packed is not None:
        sigma_c, _ = _shade_pallas(packed[0], cfg.coarse_depth, cfg.coarse_skips,
                                   points(z_c), None, cfg)
    else:
        sigma_c, _ = _shade(params.coarse, cfg.coarse_skips, points(z_c), basis, cfg,
                            None, compute_dtype, sigma_only=True)
    w_sel = sigma_to_weights(compute_deltas(z_c, last_inf=True), sigma_c)

    if fine_mode == "grid":
        z_f, sample_valid, step_f = _grid_fine_depths(w_sel, cfg)
        sigma_f, rgb_f = shade_fine(z_f)
        out = _grid_composite(z_f, sigma_f, rgb_f, sample_valid, step_f, cfg, None)
        return out.rgb, out.depth, out.opacity
    return importance_fine(sample_pdf(z_c, w_sel, importance_samples))       # [R, K]


def _ngp_composite(field: NgpField, rays_d, rays_o, z, cfg: NerfConfig,
                   gate: Optional[torch.Tensor], compute_dtype) -> CompositeResult:
    """The hash-grid field at depths ``z`` [R, K] (which the occupancy PMF
    gave: it has no coarse MLP): its exp density composited over white,
    with no sigma noise (instant-ngp has none)."""
    xyz = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    sigma, rgb = ngp_shade(field, xyz, rays_d, cfg, gate, compute_dtype)
    return composite(z, sigma, rgb, noise=None, white_back=cfg.white_back, last_inf=True,
                     density="exp")


class RenderDraws(NamedTuple):
    """The random draws of one training render, passed in so that the same
    numbers can be handed to the JAX package (``models/nerf.py:188`` splits
    its key into kj, kn_c, kn_sel, kn_pdf, kn_f for them).  A coarse-free
    render draws no coarse pass (``z_u``, ``noise_c``, ``noise_sel`` None):
    its PMF draw takes ``pdf_u`` from kn_pdf, its uniform share ``mix_u``
    from kn_sel, its noise ``noise_f`` from kn_f."""

    z_u: Optional[torch.Tensor]        # kj: [R, Sc] U[0,1) strata jitter of the occupancy
    #                          PMF draw, or [R, 1] U[0, (far-near)/Sc) grid jitter
    noise_c: Optional[torch.Tensor]    # kn_c: [R, Sc] N(0,1), the coarse composite's noise
    noise_sel: Optional[torch.Tensor]  # kn_sel: [R, Sc] N(0,1), the selection weights' noise
    pdf_u: Optional[torch.Tensor]  # kn_pdf: [R, K] U[0,1), fine inverse-CDF jitter
    #                          (coarse-free: [R, K - ku]; None in grid mode, which
    #                          draws no fine depths)
    noise_f: torch.Tensor    # kn_f: [R, K] N(0,1) (grid mode: [R, topk * scale]),
    #                          the fine composite's sigma noise
    mix_u: Optional[torch.Tensor] = None  # kn_sel, coarse-free: [R, ku] U[0,1), the
    #                          mixture's uniform strata (None when ku = 0)


def draw_render(n_rays: int, cfg: NerfConfig, importance_samples: int, culled: bool,
                generator: torch.Generator, fine_mode: str = "importance",
                coarse_free: bool = False) -> RenderDraws:
    """Draw :class:`RenderDraws` from ``generator`` on its device.  In grid
    mode the fine noise covers ``cfg.samples_fine`` samples and ``pdf_u``
    is None; ``coarse_free`` draws the coarse-free render's draws, with
    ku = ``cfg.cf_uniform_samples`` clamped to [0, K - 1]."""
    dev = generator.device
    u = lambda *shape: torch.rand(shape, generator=generator, device=dev)
    n = lambda *shape: torch.randn(shape, generator=generator, device=dev)
    k = importance_samples
    if coarse_free:
        ku = mixture_split(k, cfg.cf_uniform_samples)
        return RenderDraws(None, None, None, u(n_rays, k - ku), n(n_rays, k),
                           u(n_rays, ku) if ku else None)
    sc = cfg.occ_coarse_samples if culled else cfg.samples_coarse
    z_u = u(n_rays, sc) if culled else u(n_rays, 1) * ((cfg.far - cfg.near) / sc)
    noise_c, noise_sel = n(n_rays, sc), n(n_rays, sc)
    if fine_mode == "grid":
        return RenderDraws(z_u, noise_c, noise_sel, None, n(n_rays, cfg.samples_fine))
    return RenderDraws(z_u, noise_c, noise_sel, u(n_rays, k), n(n_rays, k))


def render_rays_train(
    params: NerfParams,
    rays_d: torch.Tensor,
    rays_o: torch.Tensor,
    draws: RenderDraws,
    step_r,
    cfg: NerfConfig,
    barf_window: Tuple[float, float],
    barf_on: bool,
    compute_dtype=torch.bfloat16,
    fine_mode: str = "grid",
    importance_samples: int = 64,
    use_kernels: bool = False,
    occ: Optional[torch.Tensor] = None,
    remat_shade: bool = False,
    coarse_free: bool = False,
    reduce_max: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Training render: coarse + fine pass with sigma noise (ref
    ``render_rays_train``, mc_nerf.py:598-646).

    Coarse depths: ``cfg.occ_coarse_samples`` stratified draws from the
    per-ray occupancy PMF when ``occ`` is given (importance mode only),
    else the uniform grid of ``cfg.samples_coarse`` plus a per-ray jitter.
    The coarse weights with a fresh noise draw (no gradient) select the
    fine samples: ``importance_samples`` depths by stratified inverse-CDF
    sampling (``fine_mode="importance"``), or the first
    ``cfg.fine_bins_topk`` above-threshold coarse bins on the
    ``sample_scale``-times-finer grid with the same jitter, unselected
    samples as sigma_default / white (``"grid"``, the reference's scheme).
    ``coarse_free`` (needs ``occ`` and the importance mode) runs no coarse
    pass: the fine depths are :func:`mixture_samples` of the occupancy
    PMF (``cfg.cf_uniform_samples`` of them stratified uniform).
    ``barf_on`` gates the encode's octaves at progress ``step_r`` within
    ``barf_window``.  ``use_kernels`` shades both passes through the
    hand-written kernels (their plain versions on CPU tensors):
    ``fused_render`` in importance mode, ``fused_shaded_mlp`` with the
    composite in PyTorch in grid mode; otherwise ``_shade`` +
    ``composite`` in ``compute_dtype``.  ``remat_shade`` recomputes the
    shading passes (all but the fused importance kernels, as in the JAX
    package) in the backward (``torch.utils.checkpoint``) instead of
    keeping their activations.  ``reduce_max`` (grid mode) takes the
    selection cutoff's max over the rays of this call to the max over the
    whole batch: a data-parallel step's all-reduce over the ranks.

    The hash-grid field (``params`` an :class:`NgpField`) renders
    coarse-free only: the PMF's draws, the level gate where ``barf_on``,
    its exp density composited without sigma noise.

    Returns (rgb_coarse [R, 3], or None when coarse-free, rgb_fine [R, 3]).
    """
    if fine_mode not in ("importance", "grid"):
        raise ValueError(f"unknown fine_mode: {fine_mode!r}")
    if coarse_free and (occ is None or fine_mode != "importance"):
        raise ValueError("coarse_free requires an occupancy map and fine_mode='importance'")
    if occ is not None and fine_mode != "importance":
        raise ValueError("occupancy culling requires fine_mode='importance'")
    if isinstance(params, NgpField) and not coarse_free:
        raise ValueError("the hashgrid field renders coarse-free only: it has no coarse MLP")
    if isinstance(params, NgpField):
        # the PMF's stratified draws (and the uniform share), sorted; the
        # level gate where BARF is on
        z = mixture_samples(*proposal_pmf(occ, rays_o, rays_d, cfg), importance_samples,
                            cfg.cf_uniform_samples, draws.pdf_u, draws.mix_u, cfg.near,
                            cfg.far).detach().contiguous()
        gate = level_gate(cfg, step_r, barf_window) if barf_on else None
        return None, _ngp_composite(params, rays_d, rays_o, z, cfg, gate, compute_dtype).rgb
    freq_w = barf_weights(cfg.emb_freqs_xyz, step_r, *barf_window) if barf_on else None
    basis = sh_basis(cfg.sh_deg, rays_d)
    k = importance_samples
    kernel_fine = use_kernels and fine_mode == "importance"
    if kernel_fine:
        basis16, nb = _basis16(basis, cfg)

    def points(z):
        return rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]

    def shade_c(z):
        if use_kernels:
            return _shade_train_kernel(params.coarse, cfg.coarse_depth, cfg.coarse_skips,
                                       points(z), basis, cfg, freq_w)
        return _shade(params.coarse, cfg.coarse_skips, points(z), basis, cfg, freq_w,
                      compute_dtype)

    def shade_f(z):
        if use_kernels:
            return _shade_train_kernel(params.fine, cfg.fine_depth, cfg.fine_skips,
                                       points(z), basis, cfg, freq_w)
        return _shade(params.fine, cfg.fine_skips, points(z), basis, cfg, freq_w,
                      compute_dtype)

    if remat_shade:
        # recompute encode -> MLP -> shade in the backward instead of keeping
        # the per-layer activations; the closed-over parameters and rays
        # still get their gradients.  The shading draws nothing, so no RNG
        # state is kept for the recompute (reading the CUDA RNG state
        # breaks a graph capture of the step)
        shade_c = lambda z, fn=shade_c: checkpoint(fn, z, use_reentrant=False,
                                                   preserve_rng_state=False)
        shade_f = lambda z, fn=shade_f: checkpoint(fn, z, use_reentrant=False,
                                                   preserve_rng_state=False)

    def importance_fine(z_f):
        """The importance fine pass at depths ``z_f``: its rgb [R, 3]."""
        if kernel_fine:
            packed_f = pack_mlp_params(params.fine, cfg.emb_freqs_xyz, cfg.fine_skips,
                                       dtype=torch.float32)
            feat_f = encode_kernel_order(points(z_f).reshape(-1, 3), cfg.emb_freqs_xyz, freq_w)
            ray_f, _ = fused_render(packed_f, feat_f, basis16, z_f, draws.noise_f, None,
                                    cfg.fine_depth, tuple(cfg.fine_skips), k, nb, True, False,
                                    cfg.white_back)
            return ray_f[:, :3]
        sigma_f, rgb_f = shade_f(z_f)
        return composite(z_f, sigma_f, rgb_f, noise=draws.noise_f, white_back=cfg.white_back,
                         last_inf=True).rgb

    if occ is not None:
        z_probe, pmf = proposal_pmf(occ, rays_o, rays_d, cfg)
        if coarse_free:
            # the PMF's stratified draws and the uniform share, sorted
            z_f = mixture_samples(z_probe, pmf, k, cfg.cf_uniform_samples, draws.pdf_u,
                                  draws.mix_u, cfg.near, cfg.far)
            return None, importance_fine(z_f.detach().contiguous())
        sc = cfg.occ_coarse_samples
        # probe ladder carries phantom end bins; clip the draws into range
        z_c = torch.clamp(sample_pdf(z_probe, pmf, sc, uniforms=draws.z_u), cfg.near, cfg.far)
    else:
        sc = cfg.samples_coarse
        z_c = torch.linspace(cfg.near, cfg.far, sc, dtype=torch.float32,
                             device=rays_d.device)[None, :] + draws.z_u
    z_c = z_c.detach().contiguous()

    if kernel_fine:
        packed_c = pack_mlp_params(params.coarse, cfg.emb_freqs_xyz, cfg.coarse_skips,
                                   dtype=torch.float32)
        feat_c = encode_kernel_order(points(z_c).reshape(-1, 3), cfg.emb_freqs_xyz, freq_w)
        ray_c, wsel = fused_render(packed_c, feat_c, basis16, z_c, draws.noise_c,
                                   draws.noise_sel, cfg.coarse_depth, tuple(cfg.coarse_skips),
                                   sc, nb, True, True, cfg.white_back)
        z_f = sample_pdf(z_c, wsel.detach(), k, uniforms=draws.pdf_u).contiguous()
        return ray_c[:, :3], importance_fine(z_f)

    sigma_c, rgb_c = shade_c(z_c)
    out_c = composite(z_c, sigma_c, rgb_c, noise=draws.noise_c, white_back=cfg.white_back)
    # fine-bin selection: no gradient, fresh noise (ref mc_nerf.py:613-621)
    w_sel = sigma_to_weights(compute_deltas(z_c, last_inf=True), sigma_c.detach(),
                             draws.noise_sel)
    if fine_mode == "importance":
        return out_c.rgb, importance_fine(sample_pdf(z_c, w_sel, k, uniforms=draws.pdf_u))

    # the fine grid shares the coarse jitter (ref mc_nerf.py:633-634)
    batch_max = None if reduce_max is None else reduce_max(w_sel.max())
    z_f, sample_valid, step_f = _grid_fine_depths(w_sel, cfg, batch_max)
    z_f = z_f + draws.z_u
    sigma_f, rgb_f = shade_f(z_f)
    out_f = _grid_composite(z_f, sigma_f, rgb_f, sample_valid, step_f, cfg, draws.noise_f)
    return out_c.rgb, out_f.rgb
