"""The codec's share of its bytes roofline in the compressed all-gather:
the least time, on every rank, to read its shard and write its archive,
then read every rank's archive and write the gathered words, over the
device time of every operation but the NCCL kernels."""

UNIT = "%"


def read(ctx):
    a = ctx.get("allgather")
    if not a or not a["codec_device_s"]:
        return None
    return 100.0 * a["least_s"] / a["codec_device_s"]
