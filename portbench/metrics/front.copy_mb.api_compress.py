"""Device MB (1e6 bytes) the front end's copies write a compress call: the
program's ``copy_bytes`` counter (the stack, or the zero fill and copy, of
``api._rows``, and ``api.copy_bits_``) summed over the spans of each traced
``front.compress`` call, a call; nothing where the program has no such
counter."""

from portbench import spans

UNIT = "MB/call"


def read(ctx):
    try:
        from dietgpu_tpu_torch import profiling
    except ImportError:
        return None
    name = getattr(profiling, "COPY_BYTES", None)
    h = spans.half(ctx, "api_compress")
    got = name and h and spans.calls("front.compress", h["calls"])
    if not got:
        return None
    return sum((s["counts"] or {}).get(name, 0) for _, c in got for s in c) / len(got) / 1e6
