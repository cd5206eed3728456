"""Archive header parsers on the host: the 32 header bytes of an ANS
archive and the 16 of a float container, as numpy uint8 arrays, into dicts
of Python ints.

Copies of ``dietgpu_tpu.ref.ans_ref.parse_header`` and
``dietgpu_tpu.ref.float_ref.parse_float_header``, with the same keys, for
the API's ``get_compressed_info``. Layouts: GpuANSUtils.cuh:67-229 and
GpuFloatUtils.cuh:181-203.
"""

import numpy as np

from . import constants as C


def parse_header(archive: np.ndarray) -> dict:
    """Parse an ANS archive's coalesced header (its first 32 bytes)."""
    assert archive.dtype == np.uint8
    h = archive[:32].view("<u4")
    magic_ver = int(h[0])
    if (magic_ver >> 16) != C.ANS_MAGIC or (magic_ver & 0xFFFF) != C.ANS_VERSION:
        raise ValueError(f"bad ANS archive magic/version 0x{magic_ver:08x}")
    nb = int(h[1])
    options = int(h[4])
    return {
        "num_blocks": nb,
        "total_uncompressed_words": int(h[2]),
        "total_compressed_words": int(h[3]),
        "prob_bits": options & 0xF,
        "use_checksum": bool(options & 0x10),
        "checksum": int(h[5]),
        "data_start": C.compressed_overhead(nb),
        "total_compressed_size": C.compressed_overhead(nb) + 2 * int(h[3]),
    }


def parse_float_header(archive: np.ndarray) -> dict:
    """Parse a float container's header (its first 16 bytes)."""
    assert archive.dtype == np.uint8
    h = archive[:16].view("<u4")
    magic_ver = int(h[0])
    if (magic_ver >> 16) != C.FLOAT_MAGIC or (magic_ver & 0xFFFF) != C.FLOAT_VERSION:
        raise ValueError(f"bad float archive magic/version 0x{magic_ver:08x}")
    n = int(h[1])
    options = int(h[2])
    ft = options & 0xF
    return {
        "size": n,
        "float_type": ft,
        "use_checksum": bool(options & 0x10),
        "checksum": int(h[3]),
        "ans_start": C.FLOAT_HEADER_BYTES + C.float_noncomp_bytes(ft, n),
    }
