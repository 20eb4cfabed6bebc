"""K4, ``fused_shaded_mlp``'s forward, on the CPU: the byte counts its
design rests on, and its plain version (the kernel's oracle on the card)
against the JAX package's Pallas kernel in interpret mode at the shapes
where the card tests hold the kernel at its edges.

``tools/bwd_check.forward_l2_bytes_per_point`` is the L2 reckoning of
``csrc/fused_shaded.cu``: every read of the weight images (the recompute's
products of the points stage's schedule) serves one 128-row tile, or two
when a 2-CTA cluster multicasts each ring slot into both blocks.  The
counts below are summed by hand from that schedule.  The edge shapes are
the card tests' (``tests/test_torch_gpu.py::K4_SHAPES``) on the narrow
packs: one point, 301 points in 3 tiles, and rays of 130 samples that
straddle tiles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_nerf_tpu.models.mlp import init_nerf_mlp as j_init_mlp
from mc_nerf_tpu.models.sh import sh_basis as j_sh_basis
from mc_nerf_tpu.ops.pallas import fused_mlp as j_fm

from mc_nerf_torch.models.nerf import _mlp_from_numpy
from mc_nerf_torch.ops.cuda import fused_mlp as t_fm
from mc_nerf_torch.tools.bwd_check import forward_l2_bytes_per_point, shaded_forward_bytes

# (enc, depth, width, skips, head0) of the default packs
PACKS = {"fine": (64, 8, 256, (4,), 512), "coarse": (64, 4, 128, (2,), 256)}
NFREQ, SH_DEG = 4, 2
NB = (SH_DEG + 1) ** 2
# (depth, width, skips) of the card tests' narrow packs
NARROW = {"coarse": (2, 32, (1,)), "fine": (3, 64, (1,))}


# The recompute's images, by hand: fine, layer 0 64 x 256 (32,768 B), five
# hidden 256 x 256 (131,072 each), the skip 320 x 256 (163,840), head 0
# four passes 256 x 128 (65,536 each), four head-1 shares 128 x 32 (8,192
# each) = 1,277,952 B; coarse, 64 x 128 (16,384), two hidden 128 x 128
# (32,768 each), the skip 192 x 128 (49,152), head 0 two passes 128 x 128
# (32,768 each), two head-1 shares 128 x 32 (8,192 each) = 212,992 B.  Per
# point: over 128 rows 9,984 and 1,664; over 256 rows 4,992 and 832.
@pytest.mark.parametrize("pack,rows,want", [("fine", 128, 9984), ("coarse", 128, 1664),
                                            ("fine", 256, 4992), ("coarse", 256, 832)])
def test_forward_l2_bytes_per_point(pack, rows, want):
    assert forward_l2_bytes_per_point(*PACKS[pack], rows) == want


# K4's own bytes at the grid step's fine pass (7000 x 130 points): feat 128
# and out 32 a point, the basis 64 a ray, the pack read once (638,976
# weights and 2,592 biases, bf16: 1,283,136 B), the images written and read
# (2 x 1,277,952): 149,887,040 B; the coarse pass (7000 x 128): 143,360,000
# + 448,000 + the pack 2 x (106,496 + 800) + the images 2 x 212,992 =
# 144,448,576 B.
@pytest.mark.parametrize("pack,s,want", [("fine", 130, 149887040), ("coarse", 128, 144448576)])
def test_shaded_forward_bytes(pack, s, want):
    assert shaded_forward_bytes(*PACKS[pack], 7000 * s, s) == want


def _setup(pack, rays, s, seed):
    """The narrow pack on both sides (JAX leaves into the port's module),
    kernel-order features of points on seeded rays from (0, 0, -3) and the
    rays' SH basis padded to 16 lanes."""
    depth, width, skips = NARROW[pack]
    jm = j_init_mlp(jax.random.PRNGKey(seed), 3 * (2 * NFREQ + 1), depth, width, skips, 3 * NB)
    tm = _mlp_from_numpy(jax.tree.map(np.asarray, jm), skips, "cpu")
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    z = rng.uniform(1.0, 6.0, size=(rays, s)).astype(np.float32)
    xyz = (np.array([0.0, 0.0, -3.0], np.float32) + d[:, None] * z[..., None]).reshape(-1, 3)
    feat = np.asarray(j_fm.encode_kernel_order(jnp.asarray(xyz), NFREQ), np.float32)
    basis16 = np.pad(np.asarray(j_sh_basis(SH_DEG, jnp.asarray(d))),
                     ((0, 0), (0, 16 - NB))).astype(np.float32)
    return jm, tm, feat, basis16, depth, skips


@pytest.mark.parametrize("pack", ["coarse", "fine"])
@pytest.mark.parametrize("rays,s", [(3, 130), (7, 43), (1, 1)])
def test_shaded_plain_matches_pallas_at_the_kernel_edges(pack, rays, s):
    """``fused_shaded_mlp_plain`` against the Pallas kernel (interpret
    mode) on the narrow packs: sigma's max abs error over the largest
    within 2e-2, rgb atol 2e-2 (tests/test_fused_mlp.py:75-114), lanes 4..7
    zero."""
    jm, tm, feat, basis16, depth, skips = _setup(pack, rays, s, rays + s)
    ref = np.asarray(j_fm.fused_shaded_mlp(j_fm.pack_mlp_params(jm, NFREQ, skips),
                                           jnp.asarray(feat, jnp.bfloat16), jnp.asarray(basis16),
                                           depth, skips, s, NB, True))
    out = t_fm.fused_shaded_mlp_plain(t_fm.pack_mlp_params(tm, NFREQ, skips),
                                      torch.as_tensor(feat).bfloat16(), torch.as_tensor(basis16),
                                      depth, skips, s, NB).numpy()
    assert out.shape == ref.shape == (rays * s, 8)
    assert np.abs(out[:, 0] - ref[:, 0]).max() <= 2e-2 * np.abs(ref[:, 0]).max()
    np.testing.assert_allclose(out[:, 1:4], ref[:, 1:4], rtol=0, atol=2e-2)
    assert np.abs(out[:, 4:]).max() == 0.0
