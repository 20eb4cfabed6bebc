"""Operations and bytes of the hash-grid field's train step, from the
configuration's published widths and the pass shapes (as ``flops.py``
for the MLP pair): the same work reads the same whatever implements it.

MACs a point: the density MLP (L F -> 64 -> 16) and the colour MLP
(16 + 16 -> 64 -> 64 -> 3), no biases: 3,072 + 6,336 = 9,408 at the
published widths.  A train step's model FLOPs: 3x the forward's (the
backward's two products), 2 a MAC.

The encode's logical bytes a point, every level on (the train cell's
window has every level's gate above 0.9), each input read once and each
output written once:
* forward: the point (12 B), the 8 corners of each level (L 8 F 4 B of
  table), the features out (L F bf16);
* backward: the features' cotangent in (L F bf16), the table's
  read-modify-write at the corners (2 L 8 F 4 B), the point (12 B), its
  gradient out (12 B).
Their least time is the bytes over 3.35 TB/s (no arithmetic bound comes
near).  Random 8-byte reads fetch whole 32-byte sectors, so a kernel that
moves only what it needs still reads ~4x these bytes: a roofline share
near 25% is what a gather at the sectors' rate reads.
"""

from __future__ import annotations

from typing import List

from portbench.flops import PEAK_HBM
from portbench.reference.ngp import FEATURES


def mlp_macs(nc: dict) -> int:
    """Multiply-accumulates of one point through both MLPs."""
    w, geo = nc["ngp_width"], nc["ngp_geo_features"]
    dens = [nc["hash_levels"] * FEATURES] + [w] * nc["ngp_density_hidden"] + [geo]
    col = [geo + nc["ngp_dir_degree"] ** 2] + [w] * nc["ngp_color_hidden"] + [3]
    return sum(a * b for dims in (dens, col) for a, b in zip(dims[:-1], dims[1:]))


def train_step_flops(cfg: dict, rays: int) -> float:
    """Model FLOPs of one train step over ``rays`` rays of
    ``importance_samples`` points each."""
    return 3 * 2 * rays * cfg["train"]["importance_samples"] * mlp_macs(cfg["nerf"])


def encode_passes(cfg: dict, rays: int) -> List[dict]:
    """The encode's forward and backward over one step's points: name and
    logical bytes."""
    nc = cfg["nerf"]
    p = rays * cfg["train"]["importance_samples"]
    lf = nc["hash_levels"] * FEATURES
    corners = nc["hash_levels"] * 8 * FEATURES * 4
    return [{"name": "hash encode fwd", "bytes": p * (12 + corners + lf * 2)},
            {"name": "hash encode bwd", "bytes": p * (lf * 2 + 2 * corners + 12 + 12)}]


def least_time(passes: List[dict]) -> float:
    """Seconds the passes take at least: their bytes over the HBM's rate."""
    return sum(p["bytes"] / PEAK_HBM for p in passes)
