"""Idle device ms a front-end decompress call while the host is in the
codec glue: the traced half's idle gaps whose innermost range is
`dietgpu.float.*` or `dietgpu.ans.*`, over its calls."""

from portbench import spans

UNIT = "ms"


def read(ctx):
    return spans.idle_ms(ctx, "api_decompress", "front.decompress",
                         ("dietgpu.float.", "dietgpu.ans."))
