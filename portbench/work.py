"""The work a call does, counted from the cell's shapes and the archive
sizes the run produced, and the peaks it is held against.

The count does not depend on which kernels ran: a call reads its input
once and writes its output once, as ``chip_smoke.py`` counts its bytes
bounds. A later change that fuses or removes kernels is judged on the same
bytes.
"""

# Published peaks, NVIDIA's H100 SXM data sheet, at the card's full power
# limit of 700 W (a run records the card's own limit beside its numbers).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}
HBM_BYTES_PER_S = PEAKS["NVIDIA H100 80GB HBM3"]["hbm_bytes_per_s"]


def compress_bytes(raw: int, archive: int) -> int:
    """A compress reads the raw words and writes the archive."""
    return raw + archive


def decompress_bytes(raw: int, archive: int) -> int:
    """A decompress reads the archive and writes the raw words."""
    return archive + raw


def allgather_codec_bytes(shard_raw: int, own_archive: int, archives: list) -> int:
    """The codec's part of a compressed all-gather on one rank: its shard
    read and its archive written, then every rank's archive read and the
    gathered words written."""
    return shard_raw + own_archive + sum(archives) + len(archives) * shard_raw


def least_seconds(nbytes: int) -> float:
    """The least time the card's memory moves `nbytes` in."""
    return nbytes / HBM_BYTES_PER_S
