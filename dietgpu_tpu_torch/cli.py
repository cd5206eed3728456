"""File-level CLI over the port's codec, on the card or the CPU.

Counterpart of ``dietgpu_tpu.cli``: the same subcommands, options, stderr
lines and exit codes, and archive files equal to its own byte for byte,
so each CLI decompresses the other's files. Where the JAX CLI runs the
native host codec, this one runs the port's kernels on the card, or their
plain versions with ``--device cpu``; it never falls back to the CPU on
its own.

Usage:
  python -m dietgpu_tpu_torch.cli compress   [--float {f16,bf16,f32}]
                                             [--prob-bits {9,10,11}]
                                             [--no-checksum]
                                             [--device {cuda,cpu}] IN OUT
  python -m dietgpu_tpu_torch.cli decompress [--device {cuda,cpu}] IN OUT
  python -m dietgpu_tpu_torch.cli info       IN

`compress --float T` treats IN as raw little-endian T words (its size
must be a multiple of the word size); without --float IN is arbitrary
bytes through the raw ANS codec. `decompress` detects the archive kind
from its magic and verifies the checksum where the archive has one.
`info` reads the header on the host and prints the JSON the JAX CLI
prints. `--device` defaults to the card: without one, compress and
decompress exit 2 unless given `--device cpu`. IN and OUT may be `-`
(stdin, stdout).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import api, headers
from . import constants as C
from .profiling import host_read

_FT = {
    "f16": C.FLOAT_TYPE_FLOAT16,
    "bf16": C.FLOAT_TYPE_BFLOAT16,
    "f32": C.FLOAT_TYPE_FLOAT32,
}
_FT_NAME = {v: k for k, v in _FT.items()}
_DTYPE = {"f16": torch.float16, "bf16": torch.bfloat16, "f32": torch.float32}
_SIGNED_WORD = {2: np.int16, 4: np.int32}


def _read(path: str) -> np.ndarray:
    if path == "-":
        return np.frombuffer(bytearray(sys.stdin.buffer.read()), dtype=np.uint8)
    return np.fromfile(path, dtype=np.uint8)


def _write(path: str, data: np.ndarray) -> None:
    if path == "-":
        sys.stdout.buffer.write(data.tobytes())
    else:
        data.tofile(path)


def _magic(archive: np.ndarray) -> int:
    if archive.size < 4:
        return 0
    return int(archive[2]) | (int(archive[3]) << 8)


def _info(archive: np.ndarray) -> dict:
    """The JAX CLI's info dict (``hostcodec.float_info`` / ``ans_info``
    plus its kind): the same keys in the same order, and
    total_compressed_size the same archive bytes (header, tables and
    payload: ``compressed_overhead(blocks) + 2 * compressed words``). The
    checksum is an 8-bit value; the native parser keeps the low byte of
    its header word (``uint8_t``), and so does this one, so that a forged
    header reads the same in both."""
    if _magic(archive) == C.FLOAT_MAGIC:
        if archive.size < C.FLOAT_HEADER_BYTES:
            raise ValueError("float_info: bad archive format")
        h = headers.parse_float_header(archive)
        if h["float_type"] not in _FT_NAME:
            raise ValueError("float_info: bad archive format")
        return {"size": h["size"], "float_type": h["float_type"],
                "use_checksum": h["use_checksum"], "checksum": h["checksum"] & 0xFF,
                "kind": "float", "float_type_name": _FT_NAME[h["float_type"]]}
    if archive.size < C.COALESCED_HEADER_BYTES:
        raise ValueError("ans_info: bad archive format")
    h = headers.parse_header(archive)
    if h["prob_bits"] not in C.SUPPORTED_PROB_BITS:
        raise ValueError("ans_info: bad archive format")
    return {"total_uncompressed_words": h["total_uncompressed_words"],
            "total_compressed_size": h["total_compressed_size"],
            "prob_bits": h["prob_bits"], "use_checksum": h["use_checksum"],
            "checksum": h["checksum"] & 0xFF, "kind": "ans"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dietgpu_tpu_torch.cli", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    on_device = argparse.ArgumentParser(add_help=False)
    on_device.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                           help="where the codec runs (default: the card)")

    pc = sub.add_parser("compress", help="bytes/floats -> archive", parents=[on_device])
    pc.add_argument("--float", choices=sorted(_FT), default=None)
    pc.add_argument("--prob-bits", type=int, default=C.DEFAULT_PROB_BITS,
                    choices=sorted(C.SUPPORTED_PROB_BITS))
    pc.add_argument("--no-checksum", action="store_true")
    pc.add_argument("infile")
    pc.add_argument("outfile")

    pd = sub.add_parser("decompress", help="archive -> original bytes", parents=[on_device])
    pd.add_argument("infile")
    pd.add_argument("outfile")

    pi = sub.add_parser("info", help="print archive header as JSON")
    pi.add_argument("infile")

    a = p.parse_args(argv)
    if a.cmd != "info" and a.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu to run on the CPU", file=sys.stderr)
        return 2

    if a.cmd == "compress":
        data = _read(a.infile)
        checksum = not a.no_checksum
        if a.float is not None:
            ws = C.float_word_size(_FT[a.float])
            if data.size % ws:
                print(f"input size {data.size} is not a multiple of the "
                      f"{a.float} word size {ws}", file=sys.stderr)
                return 2
            t = torch.from_numpy(data.view(_SIGNED_WORD[ws])).to(a.device)
            t = t.view(_DTYPE[a.float])
        else:
            t = torch.from_numpy(data).to(a.device)
        arc = api.compress_data_simple(a.float is not None, [t], checksum, a.prob_bits)[0]
        arc = host_read(arc).numpy()
        _write(a.outfile, arc)
        ratio = arc.size / max(data.size, 1)
        print(f"{data.size} -> {arc.size} bytes ({ratio:.4f}x)", file=sys.stderr)
        return 0

    arc = _read(a.infile)
    magic = _magic(arc)
    if magic not in (C.FLOAT_MAGIC, C.ANS_MAGIC):
        print("not a dietgpu archive (bad magic)", file=sys.stderr)
        return 2
    if a.cmd == "info":
        print(json.dumps(_info(arc), indent=1))
        return 0

    # decompress
    is_float = magic == C.FLOAT_MAGIC
    out = api.decompress_data_simple(is_float, [torch.from_numpy(arc).to(a.device)], True)[0]
    if out.dtype == torch.bfloat16:
        out = out.view(torch.int16)
    out = host_read(out.view(torch.uint8)).numpy()
    _write(a.outfile, out)
    print(f"{arc.size} -> {out.size} bytes", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
