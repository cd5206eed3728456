"""The PyTorch port's tensor front-end (``dietgpu_tpu_torch.torch_api``)
against the JAX package's (``dietgpu_tpu.torch_api``).

Every scenario of ``tests/test_torch_api.py`` hands the same torch tensors
to both front-ends: the archives ``comp[b, :sizes[b]]`` byte for byte,
sizes, status, temp_mem, the in-place writes into the outputs and the
exceptions must be equal. Tolerance 0. The test marked `gpu` runs the
front-end on tensors on the card, where every tensor stays.
"""

import pytest
import torch

from dietgpu_tpu import torch_api as jtapi

from dietgpu_tpu_torch import _build
from dietgpu_tpu_torch import torch_api as ptapi
from torch_port_helpers import cuda_device  # noqa: F401


def _gaussian(n, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.normal(0.0, 1.0, (n,), generator=g).to(dtype)


def same_compress(jres, pres):
    (jc, js, jtm), (pc, ps, ptm) = jres, pres
    assert pc.dtype == torch.uint8 and ps.dtype == torch.int32 and ptm == jtm
    assert ps.tolist() == js.tolist()
    for b, s in enumerate(ps.tolist()):
        assert torch.equal(pc[b, :s], jc[b, :s]), f"row {b}"


def rows(comp, sizes):
    return [comp[i, : int(sizes[i])] for i in range(len(sizes))]


def sentinel_like(t):
    """An output buffer whose bytes are known, so an in-place write (or its
    absence) is seen."""
    return torch.full_like(t.view(torch.int16) if t.dtype == torch.bfloat16 else t, 7).view(
        t.dtype)


def decompress_both(compress_as_float, jrows, prows, like, **kw):
    """decompress_data of both front-ends into identical sentinel outputs;
    the returned status, sizes and temp_mem and the outputs must agree."""
    jouts = [sentinel_like(t) for t in like]
    pouts = [sentinel_like(t) for t in like]
    jst, jsz, jtm = jtapi.decompress_data(compress_as_float, jrows, jouts, **kw)
    pst, psz, ptm = ptapi.decompress_data(compress_as_float, prows, pouts, **kw)
    assert pst.dtype == torch.uint8 and psz.dtype == torch.int32
    assert pst.tolist() == jst.tolist() and psz.tolist() == jsz.tolist() and ptm == jtm
    for j, p in zip(jouts, pouts):
        assert torch.equal(p, j)
    return pst, psz, pouts


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("checksum", [False, True])
def test_float_roundtrip_truncated(dtype, checksum):
    ts = [_gaussian(n, dtype, seed=n) for n in (10_000, 4096, 77)]
    jres = jtapi.compress_data(True, ts, checksum=checksum)
    pres = ptapi.compress_data(True, ts, checksum=checksum)
    same_compress(jres, pres)
    st, sizes, outs = decompress_both(True, rows(*jres[:2]), rows(*pres[:2]), ts,
                                      checksum=checksum)
    assert st.tolist() == [1, 1, 1]
    for t, o, s in zip(ts, outs, sizes.tolist()):
        assert s == t.numel() * t.element_size() and torch.equal(t, o)


def test_ans_roundtrip_bytes():
    g = torch.Generator().manual_seed(3)
    ts = [
        (torch.randn(5000, generator=g) * 8 + 128).clamp(0, 255).to(torch.uint8),
        torch.zeros(4096, dtype=torch.uint8),
        torch.arange(256, dtype=torch.int32).repeat(16).to(torch.uint8),
    ]
    jres = jtapi.compress_data(False, ts, checksum=True)
    pres = ptapi.compress_data(False, ts, checksum=True)
    same_compress(jres, pres)
    st, _, outs = decompress_both(False, rows(*jres[:2]), rows(*pres[:2]), ts, checksum=True)
    assert st.tolist() == [1, 1, 1] and all(torch.equal(t, o) for t, o in zip(ts, outs))


def test_simple_tier_and_compression_gain():
    ts = [_gaussian(100_000, torch.bfloat16, seed=7)]
    ja, pa = jtapi.compress_data_simple(True, ts), ptapi.compress_data_simple(True, ts)
    assert torch.equal(pa[0], ja[0])
    assert pa[0].numel() < 0.75 * ts[0].numel() * ts[0].element_size()
    jo, po = jtapi.decompress_data_simple(True, ja), ptapi.decompress_data_simple(True, pa)
    assert torch.equal(po[0], jo[0]) and torch.equal(po[0], ts[0])


def test_split_size_roundtrip():
    t = _gaussian(12_000, torch.float16, seed=1)
    splits = [4096, 4096, 3808]  # interior starts stay 4-byte aligned
    jres = jtapi.compress_data_split_size(True, t, splits)
    pres = ptapi.compress_data_split_size(True, t, torch.tensor(splits))
    same_compress(jres, pres)
    jo, po = sentinel_like(t), sentinel_like(t)
    jst, jsz, jtm = jtapi.decompress_data_split_size(True, rows(*jres[:2]), jo, splits)
    pst, psz, ptm = ptapi.decompress_data_split_size(True, rows(*pres[:2]), po, splits)
    assert pst.tolist() == jst.tolist() == [1, 1, 1]
    assert psz.tolist() == jsz.tolist() and ptm == jtm
    assert torch.equal(po, jo) and torch.equal(po, t)


def test_split_size_misaligned_rejected():
    t = torch.zeros(100, dtype=torch.uint8)
    for api in (jtapi, ptapi):
        with pytest.raises(ValueError, match="aligned"):
            api.compress_data_split_size(False, t, [3, 97])
    for api in (jtapi, ptapi):
        with pytest.raises(ValueError, match="4-byte aligned"):
            api.decompress_data_split_size(False, [torch.zeros(64, dtype=torch.uint8)],
                                           torch.zeros(100, dtype=torch.uint8), [33, 67])


def test_capacity_failure_reports_required_size():
    ts = [_gaussian(10_000, torch.bfloat16, seed=2)]
    ja, pa = jtapi.compress_data_simple(True, ts), ptapi.compress_data_simple(True, ts)
    assert torch.equal(pa[0], ja[0])
    small = [torch.empty(16, dtype=torch.bfloat16)]
    st, sizes, outs = decompress_both(True, ja, pa, small)
    assert st.tolist() == [0] and sizes.tolist() == [10_000 * 2]
    assert torch.equal(outs[0], sentinel_like(small[0]))  # left as it was


def test_checksum_corruption_raises():
    ts = [_gaussian(8192, torch.float16, seed=4)]
    ja = jtapi.compress_data_simple(True, ts, checksum=True)
    pa = ptapi.compress_data_simple(True, ts, checksum=True)
    assert torch.equal(pa[0], ja[0])
    bad = pa[0].clone()
    bad[20] ^= 0xFF  # nonComp plane byte
    msgs = []
    for api in (jtapi, ptapi):
        with pytest.raises(ValueError, match="checksum") as e:
            api.decompress_data(True, [bad], [torch.empty_like(ts[0])], checksum=True)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_max_size_queries():
    ts = [torch.zeros(1000, dtype=torch.bfloat16), torch.zeros(300, dtype=torch.bfloat16)]
    assert ptapi.max_float_compressed_output_size(ts) == jtapi.max_float_compressed_output_size(ts)
    assert ptapi.max_any_compressed_output_size(ts) == jtapi.max_any_compressed_output_size(ts)
    sz, b = ptapi.max_float_compressed_output_size(ts)
    assert b == 2 and sz >= 1000 * 2
    for n in (0, 1, 2000, 123457):
        assert ptapi.max_any_compressed_size(n) == jtapi.max_any_compressed_size(n)
        for dt in (torch.float16, torch.bfloat16, torch.float32):
            assert ptapi.max_float_compressed_size(dt, n) == jtapi.max_float_compressed_size(dt, n)


def test_empty_tensor_archive():
    ts = [torch.zeros(0, dtype=torch.uint8)]
    ja, pa = jtapi.compress_data_simple(False, ts), ptapi.compress_data_simple(False, ts)
    assert torch.equal(pa[0], ja[0]) and pa[0].numel() == 544  # header + probs, zero blocks
    jo, po = jtapi.decompress_data_simple(False, ja), ptapi.decompress_data_simple(False, pa)
    assert po[0].numel() == jo[0].numel() == 0


def _split_failing_member():
    """12000 f16 words in splits [4096, 4096, 3808], archive 1 swapped for
    a 5000-word archive: split 1 fails (status 0, its required size)."""
    t = _gaussian(12_000, torch.float16, seed=5)
    splits = [4096, 4096, 3808]
    comp, sizes, _ = jtapi.compress_data_split_size(True, t, splits)
    arcs = rows(comp, sizes)
    arcs[1] = jtapi.compress_data_simple(True, [_gaussian(5000, torch.float16, seed=6)])[0]
    return arcs, lambda: sentinel_like(t), splits, t


def _split_strided_t_out():
    """The words of a (120, 100) f16 view that is not contiguous, in splits
    [4000, 8000], into ``torch.zeros(100, 120).half().t()``."""
    t = _gaussian(12_000, torch.float16, seed=1).view(100, 120).t()
    comp, sizes, _ = jtapi.compress_data_split_size(True, t, [4000, 8000])
    return rows(comp, sizes), lambda: torch.zeros(100, 120).half().t(), [4000, 8000], t


def split_in_place_both(arcs, make_out, splits, device="cpu"):
    """decompress_data_split_size of the JAX front-end (on the CPU) and the
    port's (its tensors on `device`) into two fresh outputs: status, sizes
    and temp_mem must agree, and the outputs bit for bit."""
    jo, po = make_out(), make_out().to(device)
    jst, jsz, jtm = jtapi.decompress_data_split_size(True, arcs, jo, splits)
    pst, psz, ptm = ptapi.decompress_data_split_size(
        True, [a.to(device) for a in arcs], po, splits)
    assert pst.device == po.device and po.is_contiguous() == jo.is_contiguous()
    assert pst.tolist() == jst.tolist() and psz.tolist() == jsz.tolist() and ptm == jtm
    assert torch.equal(po.cpu().view(torch.int16), jo.view(torch.int16))
    return pst.tolist(), psz.tolist(), po.cpu()


def test_split_writes_only_members_that_decode():
    """One split's archive is swapped for a larger one: that split fails
    (status 0, its required size), and, as in the JAX front-end, no split
    is written: t_out keeps every byte it had."""
    arcs, make_out, splits, t = _split_failing_member()
    st, sz, out = split_in_place_both(arcs, make_out, splits)
    assert st == [1, 0, 1] and sz == [8192, 10000, 7616]
    assert torch.equal(out, make_out())


def test_split_into_non_contiguous_t_out():
    """A t_out that is not contiguous is decoded into, as the JAX front-end
    copies into it, in its logical order."""
    arcs, make_out, splits, t = _split_strided_t_out()
    st, sz, out = split_in_place_both(arcs, make_out, splits)
    assert st == [1, 1] and sz == [8000, 16000] and torch.equal(out, t)


@pytest.mark.gpu
@pytest.mark.parametrize("inputs", [_split_failing_member, _split_strided_t_out],
                         ids=["failing_member", "non_contiguous_t_out"])
def test_split_in_place_on_card_matches_cpu(cuda_device, inputs):
    """Both split inputs with the port's tensors on the card: status, sizes,
    temp_mem and t_out as the JAX front-end's and the port's CPU route's,
    one decode launch."""
    arcs, make_out, splits, _ = inputs()
    _build.reset_kernel_launches()
    card = split_in_place_both(arcs, make_out, splits, cuda_device)
    assert _build.kernel_launches()["decode"] == 1
    cpu = split_in_place_both(arcs, make_out, splits)
    assert card[:2] == cpu[:2] and torch.equal(card[2].view(torch.int16), cpu[2].view(torch.int16))


@pytest.mark.gpu
def test_front_end_on_card(cuda_device):
    """The 128-way float batch scenario at a small width: archives equal to
    the CPU route's, decompress in place on the card, each kernel once per
    call."""
    ts = [_gaussian(4096 + 512 * (i % 3), torch.bfloat16, seed=i) for i in range(16)]
    tc = [t.to(cuda_device) for t in ts]
    _build.reset_kernel_launches()
    kc, ks, ktm = ptapi.compress_data(True, tc)
    assert [_build.kernel_launches()[k] for k in ("split", "encode", "assembly")] == [1] * 3
    pc, ps, ptm = ptapi.compress_data(True, ts)
    assert ks.tolist() == ps.tolist() and ktm == ptm
    for b, s in enumerate(ps.tolist()):
        assert torch.equal(kc[b, :s].cpu(), pc[b, :s])
    outs = [torch.empty_like(t) for t in tc]
    _build.reset_kernel_launches()
    st, _, _ = ptapi.decompress_data(True, rows(kc, ks), outs)
    assert _build.kernel_launches()["decode"] == 1
    assert st.is_cuda and st.tolist() == [1] * len(ts)
    assert all(torch.equal(o.cpu(), t) for o, t in zip(outs, ts))


# NaN payloads that a float round trip would rewrite (CUDA's conversions
# give 0x7FFF for every f16/bf16 NaN): each must come back bit for bit.
NAN_BITS = {
    torch.float16: [0x7E00, 0x7E01, -0x0200, 0x7C01, 0x7FFF],
    torch.bfloat16: [0x7FC0, 0x7FC1, -0x0040, 0x7F81, 0x7FFF],
    torch.float32: [0x7FC00000, 0x7FC00001, -0x00400000, 0x7F800001],
}


def _nan_payloads(dtype, n, device="cpu"):
    word = torch.int32 if dtype == torch.float32 else torch.int16
    x = _gaussian(n, dtype).view(word).clone()
    bits = torch.tensor(NAN_BITS[dtype], dtype=word)
    x[: len(bits)] = bits
    x[-len(bits):] = bits
    return x.view(dtype).to(device)


def _bits(t):
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def _nan_payload_round_trips(dev):
    """torch_api's in-place decompress, api's stride decompress (equal and
    ragged rows) and the checkpoint's load, for f16/bf16/f32 tensors with
    NaN payloads; returns nothing, asserts every output bit."""
    import io

    from dietgpu_tpu_torch import api, checkpoint

    for dtype in NAN_BITS:
        ts = [_nan_payloads(dtype, n, dev) for n in (5000, 4096, 77)]
        comp, sizes, _ = ptapi.compress_data(True, ts)
        outs = [torch.zeros_like(t) for t in ts]
        status, _, _ = ptapi.decompress_data(True, rows(comp, sizes), outs)
        assert status.tolist() == [1, 1, 1]
        assert all(torch.equal(_bits(o), _bits(t)) for o, t in zip(outs, ts)), dtype
        for lens in ([5000, 4096, 77], [5000] * 3):
            stride_in = [t[:n] if t.numel() >= n else torch.cat([t, t[: n - t.numel()]])
                         for t, n in zip([ts[0]] * 3, lens)]
            c, s, _ = api.compress_data(True, stride_in)
            out2d, st, _, _ = api.decompress_data_stride(True, rows(c, s), 3, 5000, dtype, lens)
            assert st.tolist() == [1, 1, 1]
            for b, n in enumerate(lens):
                assert torch.equal(_bits(out2d[b, :n]), _bits(stride_in[b])), (dtype, lens)
        buf = io.BytesIO()
        checkpoint.save_arrays(buf, {f"t{i}": t for i, t in enumerate(ts)}, device=dev)
        buf.seek(0)
        back = checkpoint.load_arrays(buf, device=dev)
        assert all(torch.equal(_bits(back[f"t{i}"]), _bits(t)) for i, t in enumerate(ts))


def test_decoded_copies_keep_nan_payloads(monkeypatch):
    """The fused copies that write decoded f16/bf16 tensors run on int16
    views: on the card a fused copy of f16/bf16 goes through float and
    rewrites NaN payloads. On the CPU the bits survive either way, so the
    copies' dtypes are checked too."""
    seen = []
    copy = torch._foreach_copy_

    def recording(dsts, srcs, *a, **k):
        seen.extend(t.dtype for t in (*dsts, *srcs))
        return copy(dsts, srcs, *a, **k)

    monkeypatch.setattr(torch, "_foreach_copy_", recording)
    _nan_payload_round_trips("cpu")
    assert torch.float32 in seen
    assert not {torch.float16, torch.bfloat16} & set(seen), set(seen)


@pytest.mark.gpu
def test_decoded_copies_keep_nan_payloads_on_card(cuda_device):
    _nan_payload_round_trips(cuda_device)
