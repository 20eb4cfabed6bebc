"""The weight-gradient stage's byte count and its planted fault, on the CPU.

``tools/bwd_check.weight_stage_bytes`` follows the job list of
``launch_weight_grads`` (``weight_jobs`` in ``csrc/mlp_bwd.cuh``);
``tools/weight_stage_time.py`` divides it by the card's memory rate for
the stage's ``floor_ms``.  The counts below are summed by hand from that
job list.  ``planted_last_tile`` is the fault
the card tests hold the weight kernels against: dW without the points of
the last 64-point tile.
"""

import numpy as np
import pytest
import torch

from mc_nerf_torch.config import NerfConfig
from mc_nerf_torch.ops.cuda.fused_mlp import (
    _flat_weights,
    encode_kernel_order,
    fused_mlp_bwd_plain,
    mlp_plain,
    pack_mlp_params,
)
from mc_nerf_torch.tools.bwd_check import (
    WEIGHT_TILE,
    bwd_errs,
    mlp_cotangent,
    planted_last_tile,
    weight_stage_bytes,
)
from mc_nerf_torch.tools.scene import scene_params


def _per_point(*pack) -> int:
    return weight_stage_bytes(*pack, 2) - weight_stage_bytes(*pack, 1)


# (enc, depth, width, skips, head0), bytes of X and D per point, by hand:
#   fine 8x256 skip@4, 64-lane encode, head0 512: layer 0 feat 128 + d 512;
#   layers 1-3, 5-7 h 512 + d 512 each; layer 4 (feat 128 + d 512) +
#   (h 512 + d 512); head 0 h 512 + d_h1 1024; head 1 h1 1024 + dout 64
#   = 640 + 6 * 1024 + 1664 + 1536 + 1088 = 11,072
#   coarse 4x128 skip@2, head0 256: 384 + 512 + (384 + 512) + 512 + (256 +
#   512) + (512 + 64) = 3,648
#   narrow coarse 2x32 skip@1, 28-lane encode, head0 64: (56 + 64) + (56 +
#   64) + (64 + 64) + (64 + 128) + (128 + 64) = 752
#   narrow fine 3x64 skip@1, head0 128: (56 + 128) + (56 + 128) + (128 +
#   128) + (128 + 128) + (128 + 256) + (256 + 64) = 1,584
@pytest.mark.parametrize("pack,want", [
    ((64, 8, 256, (4,), 512), 11072),
    ((64, 4, 128, (2,), 256), 3648),
    ((28, 2, 32, (1,), 64), 752),
    ((28, 3, 64, (1,), 128), 1584),
], ids=["fine", "coarse", "narrow-coarse", "narrow-fine"])
def test_weight_stage_bytes_per_point(pack, want):
    assert _per_point(*pack) == want


@pytest.mark.parametrize("cfg_kw", [{}, dict(emb_freqs_xyz=4, coarse_depth=2, coarse_width=32,
                                               coarse_skips=(1,), fine_depth=3, fine_width=64,
                                               fine_skips=(1,))],
                         ids=["default", "narrow"])
def test_weight_stage_bytes_dw_written(cfg_kw):
    """At zero points the count is the fp32 dW written once: 4 bytes per
    weight of the pack the kernels take, both passes."""
    nc = NerfConfig(**cfg_kw)
    params = scene_params(nc, 0, device="cpu")
    for mlp, depth, width, skips in (
            (params.coarse, nc.coarse_depth, nc.coarse_width, nc.coarse_skips),
            (params.fine, nc.fine_depth, nc.fine_width, nc.fine_skips)):
        packed = pack_mlp_params(mlp, nc.emb_freqs_xyz, skips)
        ws, _ = _flat_weights(packed)
        enc, head0 = ws[0].shape[0], ws[-2].shape[1]
        assert weight_stage_bytes(enc, depth, width, skips, head0, 0) == \
            4 * sum(w.numel() for w in ws)


@pytest.mark.parametrize("points", [1000, 2 * WEIGHT_TILE * 5])
def test_planted_last_tile_drops_exactly_the_last_tile(points):
    """The plant changes dW alone, by exactly the last tile's points: its
    dW equals the plain backward's over the points before that tile (a
    ragged tail of 40 at 1000 points, a whole tile at a multiple of 64),
    and it lands above a relative error of 1e-3 on every layer."""
    nc = NerfConfig(emb_freqs_xyz=4, fine_depth=3, fine_width=64, fine_skips=(1,))
    packed = pack_mlp_params(scene_params(nc, 0, device="cpu").fine, nc.emb_freqs_xyz,
                             nc.fine_skips)
    ws, bs = _flat_weights(packed)
    rng = np.random.default_rng(points)
    feat = encode_kernel_order(torch.as_tensor(rng.uniform(-1, 1, (points, 3)),
                                               dtype=torch.float32), nc.emb_freqs_xyz)
    dout = mlp_cotangent(mlp_plain(packed, feat, nc.fine_depth, nc.fine_skips))
    args = (ws, bs, feat, dout, nc.fine_depth, nc.fine_skips)
    ref = fused_mlp_bwd_plain(*args)
    errs = planted_last_tile(fused_mlp_bwd_plain, args, ref)
    assert errs["db"] == 0.0 and errs["dfeat"] == 0.0
    assert errs["dW"] > 1e-3 and errs["last layer"] > 1e-3
    keep = (points - 1) // WEIGHT_TILE * WEIGHT_TILE
    assert keep == (960 if points == 1000 else points - WEIGHT_TILE)
    # K6's points are independent: the kept points' own backward is the plant's dW
    head = fused_mlp_bwd_plain(ws, bs, feat[:keep], dout[:keep], nc.fine_depth, nc.fine_skips)
    kept = bwd_errs((head[0], ref[1], ref[2]), ref)
    assert kept["dW"] == pytest.approx(errs["dW"], rel=1e-3)
    assert kept["last layer"] == pytest.approx(errs["last layer"], rel=1e-3)
