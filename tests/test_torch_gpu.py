"""The CUDA kernels against their plain PyTorch versions, on a CUDA card.

Every test here is marked ``gpu`` and skips without a card (the kernels
have no CPU build).  The file imports nothing of JAX, so it runs on a
machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Shapes go beyond the main path's: narrow widths, an encode width that is
not a multiple of 16, ragged point counts, and sample counts from 2 to
300 (several tiles per ray, several 32-sample scan chunks).
"""

import numpy as np
import pytest
import torch

from mc_nerf_torch.config import NerfConfig
from mc_nerf_torch.models.nerf import init_nerf_params, pack_eval_params
from mc_nerf_torch.models.sh import sh_basis
from mc_nerf_torch.ops.cuda.fused_mlp import (
    BASIS_LANES,
    encode_kernel_order,
    fused_mlp_apply,
    mlp_plain,
)
from mc_nerf_torch.ops.cuda.fused_render import fused_render, fused_render_plain, max_samples

NARROW = dict(emb_freqs_xyz=4, coarse_depth=2, coarse_width=32, coarse_skips=(1,),
              fine_depth=3, fine_width=64, fine_skips=(1,))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _packs(cfg_kw, seed=0):
    nc = NerfConfig(**cfg_kw)
    params = init_nerf_params(nc, torch.Generator().manual_seed(seed), device="cuda")
    return nc, pack_eval_params(params, nc)


@pytest.mark.gpu
@pytest.mark.parametrize("cfg_kw", [NARROW, {}], ids=["narrow", "default"])
@pytest.mark.parametrize("n_points", [1, 1000, 4099])
def test_fused_mlp_kernel_matches_plain(cuda, cfg_kw, n_points):
    """Both packs (coarse sigma-only, fine full): atol 2e-2, the Pallas
    kernel's own bound (tests/test_fused_mlp.py)."""
    nc, (packed_c, packed_f) = _packs(cfg_kw)
    rng = np.random.default_rng(n_points)
    xyz = torch.as_tensor(rng.uniform(-3.5, 3.5, (n_points, 3)), dtype=torch.float32,
                          device=cuda)
    feat = encode_kernel_order(xyz, nc.emb_freqs_xyz)
    for packed, depth, skips in ((packed_c, nc.coarse_depth, nc.coarse_skips),
                                 (packed_f, nc.fine_depth, nc.fine_skips)):
        before = fused_mlp_apply.launches
        ker = fused_mlp_apply(packed, feat, depth, skips)
        assert fused_mlp_apply.launches == before + 1
        torch.testing.assert_close(ker, mlp_plain(packed, feat, depth, skips),
                                   rtol=0, atol=2e-2)


def _render_args(nc, packed_f, s, rays, with_noise, emit_wsel, device):
    nb = (nc.sh_deg + 1) ** 2
    rng = np.random.default_rng(s)
    d = torch.as_tensor(rng.normal(size=(rays, 3)), dtype=torch.float32, device=device)
    d = d / d.norm(dim=-1, keepdim=True)
    z = torch.sort(torch.as_tensor(rng.uniform(1.0, 8.0, (rays, s)), dtype=torch.float32,
                                   device=device), dim=-1).values.contiguous()
    xyz = torch.tensor([0.0, 0.0, -4.0], device=device) + d[:, None] * z[..., None]
    feat = encode_kernel_order(xyz.reshape(-1, 3), nc.emb_freqs_xyz)
    basis16 = torch.nn.functional.pad(sh_basis(nc.sh_deg, d), (0, BASIS_LANES - nb)).contiguous()
    noise = torch.as_tensor(rng.normal(size=(rays, s)), dtype=torch.float32, device=device)
    noise_sel = torch.as_tensor(rng.normal(size=(rays, s)), dtype=torch.float32, device=device)
    return (packed_f, feat, basis16, z, noise, noise_sel, nc.fine_depth, nc.fine_skips,
            s, nb, with_noise, emit_wsel, nc.white_back)


@pytest.mark.gpu
@pytest.mark.parametrize("cfg_kw", [NARROW, {}], ids=["narrow", "default"])
@pytest.mark.parametrize("s", [2, 17, 48, 300])
@pytest.mark.parametrize("with_noise,emit_wsel",
                         [(False, False), (True, True), (True, False), (False, True)])
def test_fused_render_kernel_matches_plain(cuda, cfg_kw, s, with_noise, emit_wsel):
    """rgb/opacity/wsel atol 2e-3, depth 2e-2 (same rounding points, sums
    in another order)."""
    nc, (_, packed_f) = _packs(cfg_kw, seed=s)
    args = _render_args(nc, packed_f, s, 53, with_noise, emit_wsel, cuda)
    before = fused_render.launches
    (ko, kw), (po, pw) = fused_render(*args), fused_render_plain(*args)
    assert fused_render.launches == before + 1
    torch.testing.assert_close(ko[:, [0, 1, 2, 4]], po[:, [0, 1, 2, 4]], rtol=0, atol=2e-3)
    torch.testing.assert_close(ko[:, 3], po[:, 3], rtol=0, atol=2e-2)
    assert float(ko[:, 5:].abs().max()) == 0.0
    if emit_wsel:
        torch.testing.assert_close(kw, pw, rtol=0, atol=2e-3)
    else:
        assert kw is None


@pytest.mark.gpu
def test_fused_render_sample_ceiling(cuda):
    """At the default fine pack the kernel takes rays of max_samples
    samples (1,952) and refuses a longer one before launch."""
    nc, (_, packed_f) = _packs({})
    s_max = max_samples(packed_f)
    assert s_max == 1952
    ko, _ = fused_render(*_render_args(nc, packed_f, s_max, 3, False, False, cuda))
    po, _ = fused_render_plain(*_render_args(nc, packed_f, s_max, 3, False, False, cuda))
    torch.testing.assert_close(ko[:, [0, 1, 2, 4]], po[:, [0, 1, 2, 4]], rtol=0, atol=2e-3)
    with pytest.raises(ValueError):
        fused_render(*_render_args(nc, packed_f, s_max + 1, 3, False, False, cuda))
