"""Operations and bytes of the work a step or a frame needs, from the
configuration's published widths and the pass shapes, never from a
kernel's workspace: the same work reads the same whatever kernel does it.

MACs a point (``PERF.md`` section 6): the 63 real encode lanes
(3 (2L + 1)) into the trunk, the skip's concatenation, and the heads'
live outputs (1 density, 3 (deg + 1)^2 SH coefficients).  At the
defaults: 81,792 coarse sigma-only, 101,632 coarse full, 629,248 fine.
"""

from __future__ import annotations

from typing import List

PEAK_BF16 = 989e12      # dense bf16 FLOP/s of one H100 SXM (data sheet)
PEAK_FP32 = 67e12       # float32 FLOP/s outside the tensor cores
PEAK_HBM = 3.35e12      # bytes/s of HBM3


def embed_dim(nc: dict) -> int:
    return 3 * (2 * nc["emb_freqs_xyz"] + 1)


def n_basis(nc: dict) -> int:
    return (nc["sh_deg"] + 1) ** 2


def mlp_params(nc: dict, which: str) -> int:
    """Weights and biases of the ``which`` ("coarse" / "fine") MLP."""
    return sum(o * i + o for o, i in _layers(nc, which, False))


def _layers(nc: dict, which: str, sigma_only: bool):
    """[(out, in)] of every product one point goes through."""
    depth, width, skips = nc[f"{which}_depth"], nc[f"{which}_width"], nc[f"{which}_skips"]
    e = embed_dim(nc)
    out = [(width, e if i == 0 else width + e if i in skips else width) for i in range(depth)]
    out += [(width, width), (1, width)]
    if not sigma_only:
        out += [(width, width), (3 * n_basis(nc), width)]
    return out


def mlp_macs(nc: dict, which: str, sigma_only: bool = False) -> int:
    """Multiply-accumulates of one point through the MLP."""
    return sum(o * i for o, i in _layers(nc, which, sigma_only))


def samples(cfg: dict, culled: bool, train: bool) -> tuple:
    """(coarse, fine) samples a ray: culled importance 48 + 32, unculled
    importance 128 + 32, grid 128 + 26 x 5."""
    nc = cfg["nerf"]
    mode = cfg["train" if train else "eval"]
    sc = nc["occ_coarse_samples"] if culled else nc["samples_coarse"]
    if mode["fine_mode"] == "grid":
        return sc, nc["fine_bins_topk"] * nc["sample_scale"]
    return sc, mode["importance_samples"]


def train_step_flops(cfg: dict, rays: int, culled: bool) -> float:
    """Model FLOPs of one train step over ``rays`` rays: 3x the forward
    (forward, and the backward's two products), 2 FLOPs a MAC; a
    recomputation does not count."""
    nc = cfg["nerf"]
    sc, sf = samples(cfg, culled, True)
    return 3 * 2 * rays * (sc * mlp_macs(nc, "coarse") + sf * mlp_macs(nc, "fine"))


def frame_flops(cfg: dict, pixels: int, culled: bool) -> float:
    """Model FLOPs of one eval frame of ``pixels`` rays (padding rays do not
    count): the sigma-only coarse pass and the full fine pass."""
    nc = cfg["nerf"]
    sc, sf = samples(cfg, culled, False)
    return 2 * pixels * (sc * mlp_macs(nc, "coarse", True) + sf * mlp_macs(nc, "fine"))


def _pass(name: str, nc: dict, which: str, rays: int, s: int, backward: bool, shaded: bool,
          sigma_only: bool, n_noise: int, ray_out: bool, extra_out: int = 0) -> dict:
    """One MLP pass over rays x s points: its bf16 MLP FLOPs, its fp32 SH
    shading FLOPs, and the bytes of its inputs read once (encoded points
    in bf16, depths, noise, the rays' SH basis, the weights in bf16) and
    its outputs written once (per ray rgb, depth, opacity, or per point
    density and rgb; a backward: the points' and the basis' cotangents
    and the weights' gradient in fp32)."""
    p = rays * s
    macs = mlp_macs(nc, which, sigma_only)
    nb, e = n_basis(nc), embed_dim(nc)
    sh = 2 * 3 * nb * p if shaded else 0
    w_in = mlp_params(nc, which) * 2
    read = p * e * 2 + p * 4 * (1 + n_noise) + (rays * nb * 4 if shaded else 0) + w_in
    per_out = (rays * 5 * 4) if ray_out else p * (1 if sigma_only else 4) * 4
    if not backward:
        return {"name": name, "mlp_flops": 2 * macs * p, "sh_flops": sh,
                "bytes": read + per_out + extra_out}
    cot_in = rays * 3 * 4 if ray_out else p * 4 * 4
    written = p * e * 2 + mlp_params(nc, which) * 4 + (rays * nb * 4 if shaded else 0)
    return {"name": name, "mlp_flops": 4 * macs * p, "sh_flops": 2 * sh,
            "bytes": read + cot_in + written}


def train_kernel_passes(cfg: dict, rays: int, culled: bool) -> List[dict]:
    """The passes the hand-written kernels do in one train step: importance
    K2 forward and K3 backward of both passes (the renders' composites in
    them, the coarse one with its selection weights); grid K4 forward and
    K5 backward of both (the composites in PyTorch)."""
    nc = cfg["nerf"]
    sc, sf = samples(cfg, culled, True)
    if cfg["train"]["fine_mode"] == "grid":
        return [_pass(f"K{k} {w}", nc, w, rays, s, k == 5, True, False, 0, False)
                for k in (4, 5) for w, s in (("coarse", sc), ("fine", sf))]
    return [_pass("K2 coarse", nc, "coarse", rays, sc, False, True, False, 2, True, rays * sc * 4),
            _pass("K2 fine", nc, "fine", rays, sf, False, True, False, 1, True),
            _pass("K3 coarse", nc, "coarse", rays, sc, True, True, False, 2, True),
            _pass("K3 fine", nc, "fine", rays, sf, True, True, False, 1, True)]


def frame_kernel_passes(cfg: dict, pixels: int, culled: bool) -> List[dict]:
    """The passes the hand-written kernels do in one eval frame: K1's
    sigma-only coarse pass and the fine pass (K2 in importance mode, K4 in
    grid mode, its composite in PyTorch)."""
    nc = cfg["nerf"]
    sc, sf = samples(cfg, culled, False)
    coarse = _pass("K1 coarse", nc, "coarse", pixels, sc, False, False, True, 0, False)
    if cfg["eval"]["fine_mode"] == "grid":
        return [coarse, _pass("K4 fine", nc, "fine", pixels, sf, False, True, False, 0, False)]
    return [coarse, _pass("K2 fine", nc, "fine", pixels, sf, False, True, False, 0, True)]


def least_time(passes: List[dict]) -> float:
    """Seconds the passes take at least, one after another: for each, the
    larger of its FLOPs over the peaks (bf16 products, fp32 shading) and
    its bytes over the HBM's rate."""
    return sum(max(p["mlp_flops"] / PEAK_BF16 + p["sh_flops"] / PEAK_FP32, p["bytes"] / PEAK_HBM)
               for p in passes)
