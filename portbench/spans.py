"""The program's own spans, for the per-layer readers.

``dietgpu_tpu_torch.profiling`` records a span for each of its ranges
while a profiler runs, in the process that ran them: each front-end call is
a root span (``front.compress`` or ``front.decompress``) whose call id the
spans inside it share. A reader takes the roots recorded while the
profiler ran, one per traced call of its half; where the program records
no spans, or the roots are not one per call, there is nothing to read.
"""

GLUE = ("float.", "ans.")  # the codec glue's spans, inside a front-end call


def recorded():
    """The spans the program recorded while a profiler ran, or None where
    it records none."""
    try:
        from dietgpu_tpu_torch import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    return [s for s in read() if s["profiler"]]


def calls(root: str, n: int):
    """[(root span, every span of its call)] for the profiled root spans
    named `root`, or None unless there are exactly `n` of them."""
    got = recorded()
    if got is None:
        return None
    roots = [s for s in got if s["parent"] is None and s["name"] == root]
    if not n or len(roots) != n:
        return None
    of = {}
    for s in got:
        of.setdefault(s["call"], []).append(s)
    return [(r, of[r["call"]]) for r in roots]


def union_ns(spans) -> int:
    """The time the spans cover, overlaps counted once."""
    total, end = 0, None
    for s in sorted(spans, key=lambda s: s["start_ns"]):
        a, b = s["start_ns"], s["end_ns"]
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def front_ns(root, spans) -> int:
    """A call's host time outside the codec glue: its root span's length
    less the union of the glue spans of its call."""
    glue = [s for s in spans if s["name"].startswith(GLUE)]
    return root["end_ns"] - root["start_ns"] - union_ns(glue)


def half(ctx, name):
    """The traced half `name` of a codec cell, or None."""
    return ctx.get("halves", {}).get(name)


def idle_ms(ctx, name, root, prefixes):
    """Idle device ms a call of half `name`, in gaps whose innermost range
    starts with one of `prefixes`; None unless the program recorded the
    half's `root` spans, one a call."""
    h = half(ctx, name)
    if not h or calls(root, h["calls"]) is None:
        return None
    gaps = h["idle_gaps"]
    return 1e3 * sum(v for k, v in gaps.items() if k.startswith(prefixes)) / h["calls"]
