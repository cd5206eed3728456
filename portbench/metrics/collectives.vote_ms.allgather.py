"""Host ms a compressed all-gather call spends in its vote on rank 0 (the
run's own process): the mean length of the `collective.vote` spans
recorded while the profiler ran, one a call."""

from portbench import spans

UNIT = "ms"


def read(ctx):
    a = ctx.get("allgather")
    got = spans.recorded() if a else None
    if not got:
        return None
    votes = [s for s in got if s["name"] == "collective.vote"]
    if len(votes) != a["calls"]:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in votes) / len(votes) / 1e6
