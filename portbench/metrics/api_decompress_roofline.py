"""The front end's decompress calls' (`torch_api.decompress_data`, in
place) share of their bytes roofline: the least time to read the archives
and write the raw words, over the summed device time of every operation
the calls ran, the front end's copies included."""

UNIT = "%"


def read(ctx):
    h = ctx.get("halves", {}).get("api_decompress")
    if not h or not h["device_s"]:
        return None
    return 100.0 * h["least_s"] / h["device_s"]
