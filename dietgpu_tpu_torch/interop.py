"""Hand state between the JAX package and the port, through numpy.

The JAX package's arrays go to numpy with ``np.asarray``; these helpers
turn such numpy arrays into the port's tensors and back, so an archive
written by either package decodes in the other:

- float words: uint16 words or uint32 word pairs <-> int16 / int32;
- archives: uint8 bytes (the XLA codecs) or uint32 words (the Pallas
  codecs) <-> the port's int32 u32 buffers;
- a quantized pdf (256 u32) <-> int64;
- batches: B archives, each at the start of its own row, <-> one (B, R)
  int32 buffer (the port's batched layout, R u32 per member), so the
  same archives can be laid out at each package's member stride.

The word helpers take a (B, ...) batch as they take one tensor.
"""

import numpy as np
import torch

from .ans import layout


def words_from_numpy(a: np.ndarray, device="cpu") -> torch.Tensor:
    """uint16 words -> int16 tensor; uint32 word pairs -> int32 tensor."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16).copy()).to(device)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32).copy()).to(device)
    raise ValueError(f"words_from_numpy: unsupported dtype {a.dtype}")


def words_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int16/uint16 words -> uint16; int32 word pairs -> uint32."""
    t = t.detach().cpu().contiguous()
    if t.dtype in (torch.int16, torch.uint16):
        return t.view(torch.int16).numpy().view(np.uint16)
    if t.dtype == torch.int32:
        return t.numpy().view(np.uint32)
    raise ValueError(f"words_to_numpy: unsupported dtype {t.dtype}")


def archive_from_numpy(a: np.ndarray, device="cpu") -> torch.Tensor:
    """uint8 archive bytes (zero-padded to 4) or uint32 words -> int32."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint8:
        a = np.concatenate([a, np.zeros((-a.size) % 4, np.uint8)])
        a = a.view("<u4")
    if a.dtype != np.uint32:
        raise ValueError(f"archive_from_numpy: unsupported dtype {a.dtype}")
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def archive_to_numpy(arc32: torch.Tensor, size=None, dtype=np.uint8) -> np.ndarray:
    """int32 archive -> uint8 bytes (the first `size`, if given) or uint32
    words (the first size/4)."""
    b = layout.u32_to_u8le(arc32.detach().cpu().contiguous()).numpy()
    if size is not None:
        b = b[: int(size)]
    if dtype == np.uint8:
        return b.copy()
    if dtype == np.uint32:
        return b[: b.size & ~3].view("<u4").copy()
    raise ValueError(f"archive_to_numpy: unsupported dtype {dtype}")


def pdf_from_numpy(pdf: np.ndarray, device="cpu") -> torch.Tensor:
    """(256,) quantized pdf -> int64 tensor."""
    return torch.from_numpy(np.asarray(pdf).astype(np.int64)).to(device)


def pdf_to_numpy(pdf: torch.Tensor) -> np.ndarray:
    """(256,) pdf tensor -> uint32 numpy array."""
    return (layout.to_u32(pdf.detach().cpu())).numpy().astype(np.uint32)


def archives_batch_from_numpy(arcs, stride32=None, device="cpu") -> torch.Tensor:
    """B archives (a sequence of 1-D uint8 or uint32 arrays, or the rows of
    a 2-D one) -> (B, stride32) int32, archive m at the start of row m and
    zeros after it. `stride32` defaults to the longest archive in u32,
    rounded up to a multiple of 4 (16 bytes, the batched kernels' row
    alignment)."""
    rows = [archive_from_numpy(a).numpy() for a in arcs]
    if stride32 is None:
        stride32 = -(-max(r.size for r in rows) // 4) * 4
    out = np.zeros((len(rows), stride32), np.int32)
    for m, r in enumerate(rows):
        if r.size > stride32:
            raise ValueError(f"archives_batch_from_numpy: archive {m} is longer than the stride")
        out[m, : r.size] = r
    return torch.from_numpy(out).to(device)


def archives_batch_to_numpy(arcs32: torch.Tensor, sizes) -> list:
    """(B, R) int32 rows -> B uint8 arrays, row m's first sizes[m] bytes."""
    arcs32 = arcs32.detach().cpu().contiguous()
    return [archive_to_numpy(a, int(s)) for a, s in zip(arcs32, sizes)]
