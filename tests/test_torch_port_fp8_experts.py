"""Float8 weights through the port's byte codec, against the plain
reference: DeepSeek-V3's FP8 expert format (``portbench/reference/
fp8_blocks.py``: e4m3 values, one float32 scale a 128x128 block) sent as
one ``torch_api`` batch with ``compress_as_float=False``.

Each archive must equal the plain reference's (``portbench/reference/
floatref.ans_archive``) byte for byte and every decoded byte its input's,
on the CPU here and on the card in the case marked ``gpu``. The block
quantization reads back within e4m3's rounding; float8 tensors go through
the front end's fused copy as their bytes, NaNs kept; the byte path's
histogram pass and raw decode record their spans, and the front end counts
the bytes its copies write.
"""

import numpy as np
import pytest
import torch

from dietgpu_tpu_torch import api, profiling, torch_api
from dietgpu_tpu_torch import constants as C
from dietgpu_tpu_torch.ans import encode as ans_encode
from portbench.reference import floatref, fp8_blocks
from torch_port_helpers import cuda_device  # noqa: F401

FLOAT8 = [torch.float8_e4m3fn, torch.float8_e5m2, torch.float8_e4m3fnuz,
          torch.float8_e5m2fnuz]
# two experts' gate, up and down matrices; the second group with partial
# edge blocks, the third 1-D (one row)
EXPERTS = {
    "whole blocks": [(256, 384), (256, 384), (384, 256)] * 2,
    "edge blocks": [(200, 300), (200, 300), (300, 130)] * 2,
    "1-D": [(1000,), (129,), (64,)] * 2,
}


def _weights(shapes, seed, dev):
    g = torch.Generator().manual_seed(seed)
    ws = [torch.randn(s, generator=g) * 0.006 for s in shapes]
    if ws[0].dim() == 2:  # an all-zero block
        ws[0][:128, :128] = 0.0
    else:
        ws[0][:128] = 0.0
    return [w.to(dev) for w in ws]


def _as_bytes(t):
    return t.reshape(-1).view(torch.uint8)


def _round_trip(members, dev):
    """Each member's archive against the reference's and its decode
    against its bytes, through torch_api in place."""
    comp, sizes, _ = torch_api.compress_data(False, members, False, 10)
    sizes = sizes.tolist()
    for m, x in enumerate(members):
        ref = floatref.ans_archive(_as_bytes(x), 10)
        assert sizes[m] == ref.numel()
        assert torch.equal(comp[m, : sizes[m]], ref)
    outs = [torch.empty_like(x) for x in members]
    for o in outs:
        _as_bytes(o).fill_(0xA5)
    status, out_sizes, _ = torch_api.decompress_data(False, list(comp.unbind(0)), outs, False, 10)
    assert status.tolist() == [1] * len(members)
    assert out_sizes.tolist() == [x.numel() for x in members]
    for o, x in zip(outs, members):
        assert o.dtype == x.dtype and o.shape == x.shape
        assert torch.equal(_as_bytes(o), _as_bytes(x))


@pytest.mark.parametrize("dtype", [torch.float8_e4m3fn, torch.float8_e5m2])
@pytest.mark.parametrize("group", list(EXPERTS))
def test_block_quantized_experts_round_trip_as_the_reference(group, dtype):
    dev = torch.device("cpu")
    ws = _weights(EXPERTS[group], 7 + len(group), dev)
    members = [fp8_blocks.quantize(w, dtype=dtype)[0] for w in ws]
    assert not _as_bytes(members[0])[:128].any()  # the zero block's bytes are 0
    _round_trip(members, dev)


@pytest.mark.parametrize("dtype", FLOAT8)
def test_every_byte_value_round_trips(dtype):
    """A member holding all 256 byte values (e4m3's NaNs 0x7F and 0xFF among
    them), beside a quantized one, comes back bit for bit."""
    every = torch.arange(256, dtype=torch.int64).repeat(37).to(torch.uint8)
    w = fp8_blocks.quantize(torch.randn(130, 70, generator=torch.Generator().manual_seed(3)),
                            dtype=torch.float8_e4m3fn)[0].view(dtype)
    _round_trip([every.view(dtype), w], torch.device("cpu"))


@pytest.mark.parametrize("shape", [(256, 384), (384, 256), (200, 300), (1000,), (3, 5)])
def test_dequantize_reads_back_within_e4m3s_rounding(shape):
    """|dequantize(quantize(w)) - w| <= max(2^-4 |w|, 2^-10 s): half a unit
    in the last place of e4m3's 3 mantissa bits, or of its smallest
    subnormal step 2^-9, times the block's scale s."""
    g = torch.Generator().manual_seed(11)
    w = torch.randn(shape, generator=g) * 0.006
    w.view(-1)[::97] *= 1e-3  # some values deep in the subnormals
    q, s = fp8_blocks.quantize(w)
    assert q.dtype == torch.float8_e4m3fn and q.shape == w.shape
    y = fp8_blocks.dequantize(q, s)
    rows = 1 if w.dim() == 1 else w.shape[0]
    s_el = s.repeat_interleave(128, 0).repeat_interleave(128, 1)[:rows, : w.reshape(rows, -1)
                                                                 .shape[1]].reshape(w.shape)
    bound = torch.maximum(w.abs() * 2.0**-4, s_el * 2.0**-10)
    assert bool(((y - w).abs() <= bound).all())
    assert float(q.float().abs().max()) <= fp8_blocks.E4M3_MAX
    zero = torch.zeros(shape)
    qz, sz = fp8_blocks.quantize(zero)
    assert torch.equal(sz, torch.ones_like(sz)) and not _as_bytes(qz).any()


@pytest.mark.parametrize("dtype", FLOAT8)
def test_float8_goes_through_the_fused_copy_as_its_bytes(dtype):
    src = torch.arange(256, dtype=torch.int64).to(torch.uint8).view(dtype)
    dst = torch.zeros(256, dtype=torch.uint8).view(dtype)
    assert api.as_bits(src).dtype == torch.uint8
    api.copy_bits_([dst, dst[:10]], [src, src[:10]])
    assert torch.equal(dst.view(torch.uint8), torch.arange(256).to(torch.uint8))


def _copy_bytes(fn):
    before = profiling.counter(profiling.COPY_BYTES)
    with profiling.record_spans() as rec:
        out = fn()
    return out, profiling.counter(profiling.COPY_BYTES) - before, rec.spans()


def test_the_byte_path_records_its_spans_and_counts_the_front_ends_copies():
    members = [fp8_blocks.quantize(torch.randn(s, generator=torch.Generator().manual_seed(5)))[0]
               for s in [(130, 200), (64, 64), (300,)]]
    lens = [x.numel() for x in members]
    (comp, _, _), n, spans = _copy_bytes(lambda: torch_api.compress_data(False, members))
    width = api._padded_width(max(lens))  # the zero fill, then each member's copy
    assert n == len(lens) * width + sum(lens)
    names = [s["name"] for s in spans]
    assert names.count("ans.hist") == 1 and "ans.decode" not in names
    root = [s for s in spans if s["parent"] is None]
    assert sum((s["counts"] or {}).get(profiling.COPY_BYTES, 0) for s in spans) == n
    assert [r["name"] for r in root] == ["front.compress"]

    outs = [torch.empty_like(x) for x in members]
    _, n, spans = _copy_bytes(
        lambda: torch_api.decompress_data(False, list(comp.unbind(0)), outs))
    arc_width = ans_encode.archive_buffer_bytes(api._bucket_words(max(lens)))
    assert comp.shape[1] != arc_width  # each archive is read where it lies, not widened
    assert n == 0  # and decoded straight into its output
    names = [s["name"] for s in spans]
    assert names.count("ans.decode") == 1 and "ans.hist" not in names
    assert all(torch.equal(_as_bytes(o), _as_bytes(x)) for o, x in zip(outs, members))


def test_equal_members_are_stacked_and_counted_once():
    x = torch.arange(3 * C.DEFAULT_BLOCK_SIZE, dtype=torch.int64).to(torch.uint8)
    members = [x.view(torch.float8_e4m3fn), x.flip(0).view(torch.float8_e4m3fn)]
    _, n, _ = _copy_bytes(lambda: torch_api.compress_data(False, members))
    assert n == 2 * x.numel()


@pytest.mark.gpu
def test_block_quantized_experts_on_the_card(cuda_device):
    """One expert's three matrices at DeepSeek-V3's widths, quantized on the
    card, through the kernels: archives equal the reference's on the card."""
    g = torch.Generator(device=cuda_device).manual_seed(19)
    ws = [torch.randn(s, generator=g, device=cuda_device) * 0.006
          for s in [(2048, 7168), (2048, 7168), (7168, 2048)]]
    _round_trip([fp8_blocks.quantize(w)[0] for w in ws], cuda_device)
    assert np.isfinite(fp8_blocks.dequantize(*fp8_blocks.quantize(ws[0])).cpu().numpy()).all()


@pytest.mark.gpu
@pytest.mark.parametrize("shapes", [[(4096,), (4096,)], [(4096,), (70, 30)]])
def test_the_byte_decompress_reads_back_only_its_status(cuda_device, shapes):
    """Equal and ragged outputs: ``decompress_members`` makes no host sync
    (the capacities are a scalar or a device constant), so that the card
    decodes while the host goes on; ``torch_api`` then reads the status
    once."""
    members = [torch.randint(0, 256, s, dtype=torch.uint8, device=cuda_device)
               .view(torch.float8_e4m3fn) for s in shapes]
    comp, _, _ = torch_api.compress_data(False, members)
    outs = [torch.empty_like(x) for x in members]
    api.decompress_members(False, list(comp.unbind(0)), outs, bits=True)  # makes the constants
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res, ok, _, _ = api.decompress_members(False, list(comp.unbind(0)), outs, bits=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ok.all() and all(torch.equal(r.view(torch.uint8), x.view(torch.uint8))
                            for r, x in zip(res, members))
