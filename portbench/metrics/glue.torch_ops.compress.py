"""Top-level aten ops a compress call launches, a count that repeats
exactly; nothing where the calls ran no stage range (a replayed graph
launches no op)."""

UNIT = "ops/call"


def read(ctx):
    h = ctx.get("halves", {}).get("api_compress")
    if not h or not h["stage_ranges"]:
        return None
    return h["top_level_aten_ops"] / h["calls"]
