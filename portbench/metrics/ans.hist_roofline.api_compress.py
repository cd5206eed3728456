"""The histogram kernel's share of its bytes roofline in the front end's
byte compress calls: the least time to read the calls' raw bytes once, over
the summed device time of the histogram kernel (``csrc/hist.cu``'s
``hist_kernel``, by the name the trace gives it) in the traced half;
nothing where the cell counts no histogram pass."""

UNIT = "%"
KERNEL = "hist_kernel"


def read(ctx):
    h = ctx.get("halves", {}).get("api_compress")
    if not h or not h.get("hist_least_s"):
        return None
    t = sum(v for k, v in h["device_ops"].items() if KERNEL in k)
    return 100.0 * h["hist_least_s"] / t if t else None
