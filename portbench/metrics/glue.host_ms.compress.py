"""Host time a compress call spends inside the program's dietgpu.float.*
and dietgpu.ans.* stage ranges; nothing where the calls ran no range (a
replayed graph runs none)."""

UNIT = "ms"


def read(ctx):
    h = ctx.get("halves", {}).get("api_compress")
    if not h or not h["stage_ranges"]:
        return None
    return 1e3 * h["glue_s"] / h["calls"]
