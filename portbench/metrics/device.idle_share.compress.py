"""The share of the traced compress half in which the card ran nothing:
1 - (device busy time / wall time), as tools/profile_port.py reads it,
with busy the union of the device's operations."""

UNIT = "%"


def read(ctx):
    h = ctx.get("halves", {}).get("compress")
    if not h or not h["window_s"]:
        return None
    return 100.0 * (1.0 - h["busy_s"] / h["window_s"])
