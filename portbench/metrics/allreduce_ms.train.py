"""`allreduce_ms.train`: device ms a step in NCCL's kernels (the flat
gradient's all-reduce captured in the step graph), the largest over the
ranks; nothing on one rank."""

from portbench.metrics._common import ranks


def read(ctx):
    rs = ranks(ctx, "train")
    if rs is None or len(rs) < 2:
        return None
    spent = [r["layer_s"].get("allreduce", 0.0) / r["units"] for r in rs]
    return 1e3 * max(spent) if max(spent) > 0 else None
