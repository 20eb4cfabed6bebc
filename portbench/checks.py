"""The numbers that decide ``correct``: what the timed path produced
against the plain reference, each beside its limit.

Training (the first steps of the window's own epoch object, through its
own call and feed): each step's loss, term by term; the first step's
gradient as the optimizer got it, read back from its first moment; the
parameters' change over the steps.  The gradient and the change are taken leaf by
leaf, by the gap between the program's norm and the reference's, over
the larger of the reference leaf's norm and the median leaf's; leaves
whose reference gradient is under a thousandth of the median leaf's move
by round-off alone and are left out.  Frames: the rgb of frames of the
window drawn from the seed, against the reference's frame of the same
view, by the widest and the mean gap over their pixels.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

import torch

NEGLIGIBLE = 1e-3       # a leaf whose reference gradient is under this x the median's
# the loss's terms, read one by one: the intrinsic reprojection loss
# (before its self-normalization) and the coarse and fine RGB losses
LOSS_TERMS = ("loss", "loss_intr", "loss_rgb_c", "loss_rgb_f")
# the terms whose gap is compared: the fine RGB loss moves with the fine
# samples' placement, which bf16 products shift, as much as a batch of
# half the rays moves it (PERF.md); the coarse one does not
COMPARED_TERMS = ("loss_intr", "loss_rgb_c")


def leaves(flat: torch.Tensor, shapes: List[Tuple[str, torch.Size]]) -> Dict[str, torch.Tensor]:
    """The flat vector cut into named leaves of the given shapes, in order."""
    out, off = {}, 0
    for name, shape in shapes:
        n = int(torch.Size(shape).numel())
        out[name] = flat[off:off + n].reshape(shape)
        off += n
    if off != flat.numel():
        raise ValueError(f"{flat.numel()} values for leaves of {off}")
    return out


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              counted: List[str]) -> Dict[str, float]:
    """{leaf: | |prog| - |ref| | / max(|ref|, median |ref|)} over the
    ``counted`` leaves."""
    norms = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in counted}
    med = statistics.median(norms.values())
    return {k: abs(float(torch.linalg.vector_norm(prog[k].double())) - norms[k])
            / max(norms[k], med) for k in counted}


def counted_leaves(ref_grad: Dict[str, torch.Tensor]) -> Tuple[List[str], List[str]]:
    """(leaves compared, leaves left out): a leaf is left out where its
    reference gradient's norm is under ``NEGLIGIBLE`` x the median leaf's."""
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref_grad.items()}
    med = statistics.median(norms.values())
    keep = [k for k, n in norms.items() if n >= NEGLIGIBLE * med]
    return keep, [k for k in norms if k not in keep]


def train_readings(prog: dict, ref: dict, params0: Dict[str, torch.Tensor]) -> dict:
    """A program's first steps against the reference's (each {"loss":
    [each step's {term: value}], "grad": {leaf}, "params": {leaf}}):
    ``loss_gap`` (the compared terms' worst relative gap over the steps),
    ``grad_gap`` and ``change_gap`` (the worst leaf's), and beside them,
    read and not compared, each term's gap, the total loss's and the
    median leaf's; the leaves each worst gap came from."""
    rel = lambda t: max(abs(p[t] - r[t]) / abs(r[t]) for p, r in zip(prog["loss"], ref["loss"]))
    loss_gap = max(rel(t) for t in COMPARED_TERMS)
    keep, left_out = counted_leaves(ref["grad"])
    dev = next(iter(ref["grad"].values())).device
    grad = leaf_gaps({k: v.to(dev) for k, v in prog["grad"].items()}, ref["grad"], keep)
    change = leaf_gaps({k: prog["params"][k].to(dev) - params0[k] for k in keep},
                       {k: ref["params"][k] - params0[k] for k in keep}, keep)
    g_leaf, c_leaf = max(grad, key=grad.get), max(change, key=change.get)
    return {"loss_gap": loss_gap, "loss_total_gap": rel("loss"),
            **{f"{t}_gap": rel(t) for t in LOSS_TERMS[1:]},
            "grad_gap": grad[g_leaf], "change_gap": change[c_leaf],
            "grad_gap_median": statistics.median(grad.values()),
            "change_gap_median": statistics.median(change.values()),
            "grad_leaf": g_leaf, "change_leaf": c_leaf, "left_out": left_out}


def frame_readings(frames: List[Tuple[torch.Tensor, torch.Tensor]]) -> dict:
    """The widest and the mean gap of (program rgb, reference rgb) pairs
    over every pixel and channel."""
    gaps = torch.cat([(p.float() - r.float()).abs().flatten() for p, r in frames])
    return {"rgb_max_gap": float(gaps.max()), "rgb_mean_gap": float(gaps.double().mean())}


def judge(readings: dict, limits: dict) -> Tuple[bool, Dict[str, dict]]:
    """(every reading within its limit, {name: {"value", "limit"}}); a
    reading that is not a number fails."""
    table, ok = {}, True
    for name, limit in limits.items():
        v = readings.get(name)
        good = isinstance(v, (int, float)) and v == v and v <= limit
        ok = ok and good
        table[name] = {"value": v, "limit": limit}
    return ok, table
