"""Members a front-end decompress call decodes straight into their
destinations: the program's ``direct_members`` counter summed over the
spans of each traced ``front.decompress`` call, a call; nothing where the
program has no such counter."""

from portbench import spans

UNIT = "members/call"


def read(ctx):
    try:
        from dietgpu_tpu_torch import profiling
    except ImportError:
        return None
    name = getattr(profiling, "DIRECT_MEMBERS", None)
    h = spans.half(ctx, "api_decompress")
    got = name and h and spans.calls("front.decompress", h["calls"])
    if not got:
        return None
    return sum((s["counts"] or {}).get(name, 0) for _, c in got for s in c) / len(got)
