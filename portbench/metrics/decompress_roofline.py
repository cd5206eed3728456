"""The decompress calls' share of their bytes roofline: the least time
to read the archives and write the raw words, over the summed device time
of every operation the calls ran."""

UNIT = "%"


def read(ctx):
    h = ctx.get("halves", {}).get("decompress")
    if not h or not h["device_s"]:
        return None
    return 100.0 * h["least_s"] / h["device_s"]
