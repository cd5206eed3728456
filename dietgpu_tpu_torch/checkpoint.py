"""Compressed checkpoints of many named tensors, on the card or the CPU.

Counterpart of ``dietgpu_tpu.checkpoint``: the same single-file container,
byte for byte, so each package reads the other's files. Layout
(little-endian):

    u32 magic 0xD1E77D17, u32 version 1, u32 n_entries, u32 reserved
    per entry: u32 name_len, name bytes (utf-8),
               u8 kind (1=float archive, 2=ans archive), u8 dtype_code,
               u16 ndim, u64 shape[ndim], u64 archive_bytes, archive

f16/bf16/f32 entries are float archives; every other dtype is a raw-ANS
archive of its bytes (C order).

The JAX package codes one entry at a time on the host. Here the entries
are coded in groups through the ten-op API (:mod:`.api`): one group holds
the entries of one kind and float type (and, on load, ``prob_bits``)
whose word or byte counts fall in one power-of-two class, so that
``api.compress_data``, which pads every member to the widest, pads a group
at most 2x. A GPT-2 XL state dict (582 entries) takes nine groups. Each
group is one batched compress, one fused copy that packs its archives on
the device and one device-to-host copy; on load, one host-to-device copy,
one batched decode with outputs sized from each archive's header, and one
fused copy into exact tensors.

``device=None`` means the card, and raises if there is none;
``device="cpu"`` runs the kernels' plain versions. The checksum, on by
default, is verified on load: a mismatch or a failed decode raises
ValueError naming the entry.
"""

from __future__ import annotations

import math
import os
import struct
import warnings

import numpy as np
import torch

from . import api, headers
from . import constants as C
from .floatcodec.codec import _device
from .profiling import host_read

_MAGIC = 0xD1E77D17
_VERSION = 1

# dtype codes persisted in the container (the JAX package's table)
_DTYPE_CODES = {
    "float16": 1,
    "bfloat16": 2,
    "float32": 3,
    "uint8": 4,
    "int8": 5,
    "int16": 6,
    "uint16": 7,
    "int32": 8,
    "uint32": 9,
    "int64": 10,
    "uint64": 11,
    "float64": 12,
    "bool": 13,
}
_DTYPE_BY_CODE = {v: k for k, v in _DTYPE_CODES.items()}
_FLOAT_TYPES = {"float16": 1, "bfloat16": 2, "float32": 3}
_KIND_FLOAT, _KIND_ANS = 1, 2
_TORCH_DTYPES = {name: getattr(torch, name) for name in _DTYPE_CODES}


def _size_class(count: int) -> int:
    """ceil(log2(count)): counts in (2^(k-1), 2^k] share class k."""
    return max(count - 1, 0).bit_length()


def _entry(name: str, a):
    """(dtype name, shape, the entry's elements flat in C order as a torch
    tensor on the entry's device): a float tensor for f16/bf16/f32, its
    bytes as uint8 otherwise."""
    if isinstance(a, torch.Tensor):
        t = a.detach()
        dtname = str(t.dtype).removeprefix("torch.")
        if dtname not in _DTYPE_CODES:
            raise TypeError(f"unsupported dtype {dtname} for entry {name}")
        shape = tuple(t.shape)
        if not t.is_contiguous():  # C order through the bits: a float copy may rewrite NaNs
            t = api.as_bits(t).contiguous().view(t.dtype)
        t = t.reshape(-1)
    else:
        a = np.asarray(a)
        dtname = a.dtype.name
        if dtname not in _DTYPE_CODES:
            raise TypeError(f"unsupported dtype {dtname} for entry {name}")
        shape = a.shape
        flat = np.ascontiguousarray(a).reshape(-1)
        if dtname == "bfloat16":  # ml_dtypes' type, read without importing it
            flat = flat.view(np.int16)
        elif dtname == "bool":
            flat = flat.view(np.uint8)
        with warnings.catch_warnings():  # read-only arrays: the codec never writes its input
            warnings.simplefilter("ignore", UserWarning)
            t = torch.from_numpy(flat)
        if dtname == "bfloat16":
            t = t.view(torch.bfloat16)
    if dtname not in _FLOAT_TYPES:
        t = t.view(torch.uint8)
    return dtname, shape, t


def _open(path_or_file, mode):
    """(file, whether to close it): a path is opened, a file used as is."""
    if isinstance(path_or_file, (str, bytes, os.PathLike)):
        return open(path_or_file, mode), True
    return path_or_file, False


def save_arrays(
    path_or_file,
    arrays: dict,
    prob_bits: int = C.DEFAULT_PROB_BITS,
    use_checksum: bool = True,
    device=None,
) -> dict:
    """Write a compressed checkpoint; returns per-entry stats
    {name: {raw_bytes, stored_bytes, ratio}}.

    `arrays` maps names to torch tensors or numpy arrays (a
    ``state_dict``); non-contiguous ones are stored in C order. The file
    equals what ``dietgpu_tpu.checkpoint.save_arrays`` writes for the same
    arrays, `prob_bits` and `use_checksum`. Raises TypeError for a dtype
    the container has no code for, and OverflowError naming the entries
    whose archive overflowed a block's payload bound.
    """
    dev = _device(device)
    names, metas, flats = [], [], []
    groups = {}
    for name, a in arrays.items():
        dtname, shape, flat = _entry(name, a)
        flat = flat.to(dev)
        kind = _KIND_FLOAT if dtname in _FLOAT_TYPES else _KIND_ANS
        key = (kind, dtname if kind == _KIND_FLOAT else "", _size_class(flat.numel()))
        groups.setdefault(key, []).append(len(names))
        names.append(name)
        metas.append((kind, dtname, shape))
        flats.append(flat)
    archives = [None] * len(names)
    for (kind, _, _), members in groups.items():
        comp, sizes, _ = api.compress_data(
            kind == _KIND_FLOAT, [flats[i] for i in members], use_checksum, prob_bits)
        sizes = host_read(sizes).tolist()
        bad = [names[i] for i, s in zip(members, sizes) if s < 0]
        if bad:
            raise OverflowError(f"compressed block payload overflow in entries {bad}")
        host = host_read(torch.cat([comp[m, :s] for m, s in enumerate(sizes)])).numpy()
        off = 0
        for i, s in zip(members, sizes):
            archives[i] = host[off : off + s]
            off += s
    del flats
    out, close = _open(path_or_file, "wb")
    stats = {}
    try:
        out.write(struct.pack("<IIII", _MAGIC, _VERSION, len(names), 0))
        for name, (kind, dtname, shape), arc in zip(names, metas, archives):
            nb = name.encode("utf-8")
            out.write(struct.pack("<I", len(nb)))
            out.write(nb)
            out.write(struct.pack("<BBH", kind, _DTYPE_CODES[dtname], len(shape)))
            out.write(struct.pack(f"<{len(shape)}Q", *shape))
            out.write(struct.pack("<Q", arc.size))
            out.write(arc.data)
            raw = math.prod(shape) * _TORCH_DTYPES[dtname].itemsize
            stats[name] = {
                "raw_bytes": raw,
                "stored_bytes": int(arc.size),
                "ratio": float(arc.size) / max(raw, 1),
            }
        return stats
    finally:
        if close:
            out.close()


def _archive_info(name, kind, dtname, shape, arc) -> tuple:
    """(output elements: words of a float archive or bytes of a raw one,
    prob_bits), from the archive's headers on the host; ValueError naming
    the entry where they are malformed or disagree with its shape."""
    try:
        if kind == _KIND_FLOAT:
            if dtname not in _FLOAT_TYPES:
                raise ValueError(f"a float archive for dtype {dtname}")
            if arc.size < C.FLOAT_HEADER_BYTES:
                raise ValueError("archive shorter than its header")
            info = headers.parse_float_header(arc)
            if info["float_type"] != _FLOAT_TYPES[dtname]:
                raise ValueError(f"float type {info['float_type']} for dtype {dtname}")
            count, start, want = info["size"], info["ans_start"], math.prod(shape)
        elif kind == _KIND_ANS:
            count, start = None, 0
            want = math.prod(shape) * _TORCH_DTYPES[dtname].itemsize
        else:
            raise ValueError(f"unknown entry kind {kind}")
        if arc.size < start + 32:
            raise ValueError("archive shorter than its ANS header")
        ans = headers.parse_header(arc[start : start + 32])
        count = ans["total_uncompressed_words"] if count is None else count
        if count != want:
            raise ValueError(f"archive holds {count} elements, shape {shape} needs {want}")
        return count, ans["prob_bits"]
    except ValueError as e:
        raise ValueError(f"checkpoint entry {name!r}: {e}") from None


def load_arrays(path_or_file, device=None) -> dict:
    """Read a checkpoint back into {name: tensor on `device`}, with the
    stored dtype and shape; reads the files of
    ``dietgpu_tpu.checkpoint.save_arrays`` too. Raises ValueError naming
    the entry whose archive fails to decode or to match its checksum, and
    ValueError mentioning "checkpoint" for a file that is not one."""
    dev = _device(device)
    f, close = _open(path_or_file, "rb")
    try:
        magic, version, n, _ = struct.unpack("<IIII", f.read(16))
        if magic != _MAGIC:
            raise ValueError(f"not a dietTPU checkpoint (magic 0x{magic:08x})")
        if version != _VERSION:
            raise ValueError(f"unsupported checkpoint version {version}")
        entries = []
        for _ in range(n):
            (name_len,) = struct.unpack("<I", f.read(4))
            name = f.read(name_len).decode("utf-8")
            kind, dtcode, ndim = struct.unpack("<BBH", f.read(4))
            shape = struct.unpack(f"<{ndim}Q", f.read(8 * ndim))
            (arc_len,) = struct.unpack("<Q", f.read(8))
            arc = np.frombuffer(f.read(arc_len), dtype=np.uint8)
            if dtcode not in _DTYPE_BY_CODE:
                raise ValueError(f"checkpoint entry {name!r}: unknown dtype code {dtcode}")
            entries.append((name, kind, _DTYPE_BY_CODE[dtcode], shape, arc))
    finally:
        if close:
            f.close()

    groups = {}
    counts = []
    for i, (name, kind, dtname, shape, arc) in enumerate(entries):
        count, prob_bits = _archive_info(name, kind, dtname, shape, arc)
        counts.append(count)
        key = (kind, dtname if kind == _KIND_FLOAT else "", prob_bits, _size_class(count))
        groups.setdefault(key, []).append(i)
    out = [None] * len(entries)
    for (kind, dtname, prob_bits, _), members in groups.items():
        arcs = [entries[i][4] for i in members]
        dev_arcs = torch.from_numpy(np.concatenate(arcs)).to(dev)
        ins = list(torch.split(dev_arcs, [a.size for a in arcs]))
        dtype = _TORCH_DTYPES[dtname] if kind == _KIND_FLOAT else torch.uint8
        exact = [torch.empty(counts[i], dtype=dtype, device=dev) for i in members]
        outs, ok, _, checksum_ok = api.decompress_members(
            kind == _KIND_FLOAT, ins, exact, True, prob_bits, bits=True)
        ok, checksum_ok = host_read(torch.stack([ok, checksum_ok])).tolist()
        for i, good, ck in zip(members, ok, checksum_ok):
            if not good:
                raise ValueError(f"checkpoint entry {entries[i][0]!r}: archive failed to decode")
            if not ck:
                raise ValueError(f"checkpoint entry {entries[i][0]!r}: checksum mismatch")
        api.copy_bits_(exact, outs)
        for i, t in zip(members, exact):
            out[i] = t
    result = {}
    for (name, _, dtname, shape, _), t in zip(entries, out):
        result[name] = t.view(_TORCH_DTYPES[dtname]).reshape(shape)
    return result
