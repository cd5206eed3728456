"""Idle device ms a front-end decompress call while the host is in the
front end: the traced half's idle gaps whose innermost range is
`dietgpu.front.*`, over its calls."""

from portbench import spans

UNIT = "ms"


def read(ctx):
    return spans.idle_ms(ctx, "api_decompress", "front.decompress", ("dietgpu.front.",))
