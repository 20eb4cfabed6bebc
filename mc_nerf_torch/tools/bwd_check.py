"""What the checks of the backward kernels share (``chip_smoke.py``,
``tests/test_torch_gpu.py``): a loss-shaped cotangent, the relative L2
error of each output, and planted faults of the plain backward, each of
which a check must see.

The plants that sit inside the plain backward (the composite's suffix sums
taken one sample late, the skip layers' share of dfeat dropped) swap one
of its helpers for the length of one call; the package's functions carry
no fault switch.
"""

from __future__ import annotations

from typing import Dict
from unittest import mock

import torch

from mc_nerf_torch.ops.cuda import fused_render as _fr

_SUFFIX, _SPLIT = _fr._exclusive_suffix_sum, _fr._split_skip_grad


def mse_cotangent(ray_out: torch.Tensor, far: float) -> torch.Tensor:
    """d loss / d ray_out [rays, 8] of an MSE of the rendered rays against a
    white image, the far plane's depth and full opacity (depth scaled by
    1 / far), averaged over rays and the 5 columns.  Every residual is <= 0
    (rgb <= 1 under the white background, depth <= far, opacity <= 1), so
    the sums over points that make the weight gradients add up the way a
    real rgb loss's do instead of cancelling, as N(0, 1) cotangents would."""
    rays = ray_out.shape[0]
    out = ray_out[:, :5].detach().float()
    scale = torch.ones(5, device=out.device)
    scale[3] = 1.0 / far
    target = torch.ones(5, device=out.device)
    target[3] = far
    dray = torch.zeros((rays, 8), dtype=torch.float32, device=out.device)
    dray[:, :5] = 2.0 * (out - target) * scale * scale / (5 * rays)
    return dray


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b||, in float64."""
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-300))


def bwd_errs(k, ref) -> Dict[str, float]:
    """Relative L2 error of each output of the backward against a
    reference: the worst weight and the worst bias of every layer but the
    last, the last layer's (the worse of its weight and bias), dfeat and
    dbasis.  L2, not max: a ReLU mask or a bf16 rounding that falls the
    other way moves a few entries a lot, and fp32 sums in another order
    alone do that; in a deep trunk each such flip moves the layers below
    it.  The last layer's gradients (h1^T dout and the fp32 sum of dout)
    sit before that cascade: they see the composite and shading backward
    at the fp32 noise of their own sums."""
    dws, dbs, dfeat, dbasis = k
    if not all(bool(torch.isfinite(t).all()) for t in (*dws, *dbs, dfeat, dbasis)):
        raise AssertionError("the backward's output is not finite")
    return {"dW": max(rel_l2(a, b) for a, b in zip(dws[:-1], ref[0][:-1])),
            "db": max(rel_l2(a, b) for a, b in zip(dbs[:-1], ref[1][:-1])),
            "last layer": max(rel_l2(dws[-1], ref[0][-1]), rel_l2(dbs[-1], ref[1][-1])),
            "dfeat": rel_l2(dfeat, ref[2]), "dbasis": rel_l2(dbasis, ref[3])}


def _suffix_late(x: torch.Tensor) -> torch.Tensor:
    s = _SUFFIX(x)
    return torch.cat([s[:, 1:], torch.zeros_like(s[:, :1])], 1)


def _skip_share_dropped(d_xin: torch.Tensor, e_lanes: int):
    share, d_h = _SPLIT(d_xin, e_lanes)
    return torch.zeros_like(share), d_h


def planted_errs(args, ref) -> Dict[str, Dict[str, float]]:
    """For ``args`` of ``fused_render_bwd_plain`` and ``ref`` its result:
    :func:`bwd_errs` of each planted fault against ``ref``: the last trunk
    layer's dW written transposed, layer 1's dW zeroed, the skip layers'
    share of dfeat dropped, another ray's SH basis, the composite's suffix
    sums one sample late."""
    dws, dbs, dfeat, dbasis = ref
    depth = args[7]
    last = depth - 1
    dws_t = list(dws)
    dws_t[last] = dws[last].t().reshape(dws[last].shape)
    dws_z = list(dws)
    dws_z[1] = torch.zeros_like(dws[1])
    other = list(args)
    other[3] = args[3].roll(1, 0)
    with mock.patch.object(_fr, "_split_skip_grad", _skip_share_dropped):
        skip = _fr.fused_render_bwd_plain(*args)
    with mock.patch.object(_fr, "_exclusive_suffix_sum", _suffix_late):
        late = _fr.fused_render_bwd_plain(*args)
    return {"a layer's dW transposed": bwd_errs((dws_t, dbs, dfeat, dbasis), ref),
            "a layer's dW zeroed": bwd_errs((dws_z, dbs, dfeat, dbasis), ref),
            "the skip's dfeat share dropped": bwd_errs(skip, ref),
            "another ray's basis": bwd_errs(_fr.fused_render_bwd_plain(*other), ref),
            "suffix scan shifted by one": bwd_errs(late, ref)}
