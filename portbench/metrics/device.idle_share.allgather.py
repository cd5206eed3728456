"""The share of rank 0's traced window in which its card ran nothing:
1 - (device busy time / wall time)."""

UNIT = "%"


def read(ctx):
    a = ctx.get("allgather")
    if not a or not a["window_s"]:
        return None
    return 100.0 * (1.0 - a["busy_s"] / a["window_s"])
