"""The compress calls' share of their bytes roofline: the least time the
card's memory takes to read the raw words and write the archives they
made, over the summed device time of every operation the calls ran."""

UNIT = "%"


def read(ctx):
    h = ctx.get("halves", {}).get("compress")
    if not h or not h["device_s"]:
        return None
    return 100.0 * h["least_s"] / h["device_s"]
