"""`roofline_share.hashgrid`: the hash encode's least time (its logical
bytes over 3.35 TB/s, ``flops_ngp.py``, in the runner's
``hashgrid_bound_s_per_unit``) over its kernels' device time, %; nothing
where the kernels did not run or the runner counted no bytes."""

from portbench.metrics._common import ranks


def read(ctx):
    rs = ranks(ctx, "train")
    if rs is None:
        return None
    spent = sum(r["layer_s"].get("hashgrid", 0.0) for r in rs)
    bound = sum(r.get("hashgrid_bound_s_per_unit", 0.0) * r["units"] for r in rs)
    if spent <= 0 or bound <= 0:
        return None
    return 100.0 * bound / spent
