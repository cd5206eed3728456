"""The raw decode kernel's share of its bytes roofline in the front end's
byte decompress calls: the least time to read the archives and write the
raw bytes, over the summed device time of the decode kernel's raw-byte
configuration (``csrc/decode.cu``'s ``decode_kernel<kRaw>``, which the
trace names ``decode_kernel<2>``) in the traced half; nothing where the cell
counts no raw decode."""

UNIT = "%"
KERNEL = "decode_kernel<2>"


def read(ctx):
    h = ctx.get("halves", {}).get("api_decompress")
    if not h or not h.get("decode_raw_least_s"):
        return None
    t = sum(v for k, v in h["device_ops"].items() if KERNEL in k)
    return 100.0 * h["decode_raw_least_s"] / t if t else None
