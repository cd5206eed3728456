"""DeepSeek-V3's FP8 weight format, in plain torch: float8 e4m3 values with
one float32 scale a 128x128 block.

The published checkpoint (``config.json``'s ``quantization_config``: ``fmt``
e4m3, ``weight_block_size`` [128, 128]) stores each routed expert's matrix
W as q = W / s in float8 e4m3, s = max|B| / 448 for each block B, and the
float32 ``weight_scale_inv`` s beside it; ``inference/kernel.py``'s
``weight_dequant`` reads W back as q * s, block by block. This file makes
the benchmark's inputs that way and reads them back; it imports nothing of
the program.
"""

import torch

E4M3_MAX = 448.0  # the largest finite float8 e4m3fn value
BLOCK = (128, 128)


def _blocks(w: torch.Tensor, block):
    """`w` as (rows, cols) padded with zeros to whole blocks, viewed as
    (row blocks, br, col blocks, bc); a 1-D tensor is one row."""
    w2 = w.reshape(1, -1) if w.dim() == 1 else w
    if w2.dim() != 2:
        raise ValueError(f"a weight is 1-D or 2-D, got {tuple(w.shape)}")
    br, bc = block
    R, C = w2.shape
    pad = torch.zeros((-(-R // br) * br, -(-C // bc) * bc), dtype=torch.float32,
                      device=w.device)
    pad[:R, :C] = w2
    return pad.view(pad.shape[0] // br, br, pad.shape[1] // bc, bc), (R, C)


def quantize(w: torch.Tensor, block=BLOCK, dtype=torch.float8_e4m3fn):
    """(q, scale_inv) of a float weight: q in `dtype`, shaped as `w`;
    scale_inv float32 of (row blocks, col blocks), s = max|B| / 448 for each
    block B (partial at the edges), 1 where the block is all zero."""
    v, (R, C) = _blocks(w.float(), block)
    amax = v.abs().amax(dim=(1, 3))
    s = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    q = (v / s[:, None, :, None]).to(dtype)
    q = q.view(v.shape[0] * v.shape[1], -1)[:R, :C]
    return q.reshape(w.shape).contiguous(), s


def dequantize(q: torch.Tensor, scale_inv: torch.Tensor, block=BLOCK) -> torch.Tensor:
    """float32 q * s, each block by its own scale, as ``weight_dequant``."""
    v, (R, C) = _blocks(q.float(), block)
    y = v * scale_inv[:, None, :, None]
    return y.view(v.shape[0] * v.shape[1], -1)[:R, :C].reshape(q.shape)
