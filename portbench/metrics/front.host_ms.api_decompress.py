"""Host time a front-end decompress call spends outside the codec glue:
the mean over the traced half's `front.decompress` root spans of their
length less the union of the `float.*` / `ans.*` spans of their call."""

from portbench import spans

UNIT = "ms"


def read(ctx):
    h = spans.half(ctx, "api_decompress")
    got = h and spans.calls("front.decompress", h["calls"])
    if not got:
        return None
    return sum(spans.front_ns(r, c) for r, c in got) / len(got) / 1e6
