"""`hashgrid_ms.train`: device ms a step in the hash encode's kernels
(``kernels/hashgrid.json``), averaged over the ranks; nothing where none
ran."""

from portbench.metrics._common import ranks


def read(ctx):
    rs = ranks(ctx, "train")
    if rs is None:
        return None
    spent = sum(r["layer_s"].get("hashgrid", 0.0) / r["units"] for r in rs) / len(rs)
    return 1e3 * spent if spent > 0 else None
