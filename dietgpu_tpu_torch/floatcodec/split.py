"""Elementwise float word split/join transforms (torch).

Bit-exact with FloatTypeInfo<FT>::split/join (GpuFloatUtils.cuh:111-203)
and ``dietgpu_tpu.floatcodec.split``:

  f16 : comp = word >> 8;   nonComp = word & 0xff
  bf16: r = rotl16(word,1); comp = r >> 8; nonComp = r & 0xff
  f32 : v = rotl32(word,1); comp = v >> 24; lo = v & 0xffff;
        hi = (v >> 16) & 0xff

f16/bf16 words are int16 or uint16 tensors, f32 words int32 tensors (the
u32 bit patterns). Planes are uint8, except the f32 low plane, which is
int16 holding the u16 values.
"""

import torch

from .. import constants as C
from ..ans import layout

HALF_TYPES = (C.FLOAT_TYPE_FLOAT16, C.FLOAT_TYPE_BFLOAT16)


def split_words(words: torch.Tensor, float_type: int):
    """Split raw float words into (comp uint8, nonComp planes tuple)."""
    if float_type == C.FLOAT_TYPE_FLOAT32:
        assert words.dtype == torch.int32
        w = layout.to_u32(words)
        v = ((w << 1) | (w >> 31)) & layout.U32_MASK
        lo = (v & 0xFFFF).to(torch.int32).to(torch.int16)
        return (v >> 24).to(torch.uint8), (lo, ((v >> 16) & 0xFF).to(torch.uint8))
    assert float_type in HALF_TYPES, f"bad float type {float_type}"
    assert words.dtype in (torch.int16, torch.uint16)
    w = words.view(torch.int16).to(torch.int32) & 0xFFFF
    if float_type == C.FLOAT_TYPE_BFLOAT16:
        w = ((w << 1) | (w >> 15)) & 0xFFFF
    return (w >> 8).to(torch.uint8), ((w & 0xFF).to(torch.uint8),)


def join_words(comp: torch.Tensor, noncomp, float_type: int) -> torch.Tensor:
    """Inverse of split_words: planes -> int16 (f16/bf16) or int32 (f32)
    words."""
    if float_type == C.FLOAT_TYPE_FLOAT32:
        lo, hi = noncomp
        v = (
            (comp.to(torch.int64) << 24)
            | (hi.to(torch.int64) << 16)
            | (lo.to(torch.int64) & 0xFFFF)
        )
        return layout.to_i32((v >> 1) | (v << 31))
    assert float_type in HALF_TYPES, f"bad float type {float_type}"
    (nc,) = noncomp
    w = (comp.to(torch.int32) << 8) | nc.to(torch.int32)
    if float_type == C.FLOAT_TYPE_BFLOAT16:
        w = ((w >> 1) | (w << 15)) & 0xFFFF
    return w.to(torch.int16)
