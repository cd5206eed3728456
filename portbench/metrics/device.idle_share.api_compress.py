"""The share of the traced half of front-end compress calls in which the
card ran nothing: 1 - (device busy time / wall time)."""

UNIT = "%"


def read(ctx):
    h = ctx.get("halves", {}).get("api_compress")
    if not h or not h["window_s"]:
        return None
    return 100.0 * (1.0 - h["busy_s"] / h["window_s"])
