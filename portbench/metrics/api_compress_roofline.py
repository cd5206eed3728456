"""The front end's compress calls' (`torch_api.compress_data`) share of
their bytes roofline: the least time to read the raw words and write the
archives they made, over the summed device time of every operation the
calls ran, the front end's copies included."""

UNIT = "%"


def read(ctx):
    h = ctx.get("halves", {}).get("api_compress")
    if not h or not h["device_s"]:
        return None
    return 100.0 * h["least_s"] / h["device_s"]
