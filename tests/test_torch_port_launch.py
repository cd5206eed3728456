"""The port's one launch path (CPU): the CUDA sources ask the runtime for a
launch shape only through ``csrc/launch.cuh``, every decode entry point
checks its arguments through one check with the same messages, and the
stored-checksum comparison of every decompress is the one in
``ans/checksum.py``. No JAX: the archives come from the port's own
compress on the CPU.
"""

import re

import pytest
import torch

import dietgpu_tpu_torch as port
from dietgpu_tpu_torch import _build
from dietgpu_tpu_torch import constants as C
from dietgpu_tpu_torch.ans import cuda_decode
from dietgpu_tpu_torch.floatcodec import codec

BF16 = C.FLOAT_TYPE_BFLOAT16
L = C.DEFAULT_BLOCK_SIZE


@pytest.mark.parametrize("query", ["cudaOccupancyMaxActiveBlocksPerMultiprocessor",
                                   "cudaDevAttrMultiProcessorCount",
                                   "cudaFuncGetAttributes", "cudaFuncSetAttribute"])
def test_only_the_launch_header_asks_the_runtime_for_a_launch_shape(query):
    """Each runtime query of a launch shape is in ``launch.cuh`` and in no
    source, and every source includes the header."""
    assert query in (_build.CSRC / "launch.cuh").read_text()
    for source in _build.SOURCES:
        text = (_build.CSRC / f"{source}.cu").read_text()
        assert query not in text, source
        assert re.search(r'^#include "launch\.cuh"$', text, re.M), source


def _rows(a32):
    return torch.zeros((2, a32), dtype=torch.int32)


def _members(a32):
    return list(_rows(a32).unbind(0))


def _outs():
    return [torch.zeros(L, dtype=torch.bfloat16) for _ in range(2)]


# entry point -> (takes a float type, call(prob_bits, capacity, float type, row words))
_ENTRIES = {
    "decode_float_batched": (True, lambda pb, cap, ft, a32: cuda_decode.decode_float_batched(
        _rows(a32), ft, cap, pb)),
    "float_decompress_batched": (True, lambda pb, cap, ft, a32: codec.float_decompress_batched(
        _rows(a32), ft, cap, pb)),
    "decode_members": (True, lambda pb, cap, ft, a32: cuda_decode.decode_members(
        _members(a32), a32, cap, pb, ft)),
    "decode_members_outs": (True, lambda pb, cap, ft, a32: cuda_decode.decode_members(
        _members(a32), a32, cap, pb, ft, _outs())),
    "ans_decode_batched": (False, lambda pb, cap, ft, a32: port.ans_decode_batched(
        _rows(a32), pb, cap)),
    "ans_decode_padded": (False, lambda pb, cap, ft, a32: port.ans_decode_padded(
        _rows(a32)[0], pb, cap)),
}
# bad argument -> (the call's arguments, the message every entry point gives)
_BAD = {
    "prob_bits": ((8, L, BF16, 64), r"prob_bits 8 not in"),
    "capacity": ((10, 1000, BF16, 64), r"capacity 1000 is not a positive multiple of 4096"),
    "float_type": ((10, L, 7, 64), r"float type 7 is not f16/bf16/f32"),
    "container": ((10, L, BF16, 3), r"a float container has at least 4 words"),
}


@pytest.mark.parametrize("entry,bad", [
    (e, b) for e, (floats, _) in _ENTRIES.items() for b in _BAD
    if floats or b in ("prob_bits", "capacity")])
def test_every_decode_entry_point_rejects_a_bad_argument_alike(entry, bad):
    """The one argument check: the same bad prob_bits, capacity, float type
    or container length raises the same ValueError through every decode
    entry point (the raw ones take no float type and no container)."""
    args, message = _BAD[bad]
    with pytest.raises(ValueError, match=message):
        _ENTRIES[entry][1](*args)


def _float_archives():
    """Two bf16 containers with a checksum, as (2, A/4) int32 rows."""
    g = torch.Generator().manual_seed(0)
    words = (torch.randn((2, L), generator=g) * 3).to(torch.bfloat16).view(torch.int16)
    arcs, _ = codec.float_compress_batched(words, [L, L - 5], BF16, 10, use_checksum=True)
    return arcs


def _raw_archives():
    """Two raw ANS archives with a checksum, as (2, A/4) int32 rows."""
    g = torch.Generator().manual_seed(1)
    data = (torch.randn((2, L), generator=g).abs() * 20).clamp(max=255).to(torch.uint8)
    arcs, _ = port.ans_encode_batched(data, [L, 3000], prob_bits=10, use_checksum=True)
    return arcs


# former copy of the comparison -> (archives, the stored checksum's word,
# checksum_ok of member 0 after a call on the archives)
_SITES = {
    "float_decompress_padded": (_float_archives, 3, lambda a: codec.float_decompress_padded(
        a[0], BF16, L, 10, verify_checksum=True)["checksum_ok"]),
    "float_decompress_batched": (_float_archives, 3, lambda a: codec.float_decompress_batched(
        a, BF16, L, 10, verify_checksum=True)["checksum_ok"][0]),
    "ans_decode_padded": (_raw_archives, 5, lambda a: port.ans_decode_padded(
        a[0], 10, L, verify_checksum=True)["checksum_ok"]),
    "ans_decode_batched": (_raw_archives, 5, lambda a: port.ans_decode_batched(
        a, 10, L, verify_checksum=True)["checksum_ok"][0]),
}


@pytest.mark.parametrize("corrupt", [False, True], ids=["untouched", "corrupted"])
@pytest.mark.parametrize("site", list(_SITES))
def test_a_corrupted_stored_checksum_fails_through_every_decompress(site, corrupt):
    """``checksum.verified`` through each decompress that compared the
    stored checksum itself: an untouched archive passes, one whose stored
    checksum word has a bit flipped fails."""
    make, word, call = _SITES[site]
    arcs = make()
    if corrupt:
        arcs[0, word] ^= 1
    assert bool(call(arcs)) is not corrupt
