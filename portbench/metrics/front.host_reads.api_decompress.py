"""Device-to-host reads a front-end decompress call makes: the program's
`host_reads` counter summed over the spans of each traced
`front.decompress` call, a call."""

from portbench import spans

UNIT = "reads/call"


def read(ctx):
    h = spans.half(ctx, "api_decompress")
    got = h and spans.calls("front.decompress", h["calls"])
    if not got:
        return None
    reads = sum((s["counts"] or {}).get("host_reads", 0) for _, c in got for s in c)
    return reads / len(got)
