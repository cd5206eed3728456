"""Device time a compressed all-gather call spends in kernels whose names
start with nccl, the mean over the ranks."""

UNIT = "ms"


def read(ctx):
    a = ctx.get("allgather")
    if not a or not a["nccl_s"]:
        return None
    return 1e3 * a["nccl_s"] / (a["ranks"] * a["calls"])
