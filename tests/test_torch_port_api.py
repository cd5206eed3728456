"""The PyTorch port's ten-op API (``dietgpu_tpu_torch.api``) against the
JAX package's (``dietgpu_tpu.api``, its XLA route on the CPU).

Every scenario of ``tests/test_api.py`` runs the same numpy-seeded inputs
through both APIs: every archive ``comp[b, :sizes[b]]`` byte for byte,
sizes, status, temp_mem, header info and decoded tensors must be equal,
and the same exceptions raised with the same messages. Tolerance 0: the
codec is lossless and its archive format fixed. The test marked `gpu`
runs the same calls on the card against the CPU route.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dietgpu_tpu import api as japi

from dietgpu_tpu_torch import _build
from dietgpu_tpu_torch import api as papi
from dietgpu_tpu_torch import constants as C
from torch_port_helpers import cuda_device  # noqa: F401

_TORCH = {"float16": torch.float16, "bfloat16": torch.bfloat16, "float32": torch.float32,
          "uint8": torch.uint8}


def to_torch(a) -> torch.Tensor:
    """A JAX (or numpy) array as a CPU tensor with the same bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def bits(x) -> np.ndarray:
    """The bytes of a tensor or array, flat."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().reshape(-1).view(np.uint8)
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def normal_arrays(rng, dtype, sizes):
    """JAX arrays as tests/test_api.py makes them, and the same bits for the
    port."""
    js = [jnp.asarray(rng.standard_normal(n).astype(np.float32)).astype(dtype) for n in sizes]
    return js, [to_torch(j) for j in js]


def same_compress(jres, pres):
    """(comp, sizes, temp_mem) of both APIs: equal sizes and temp_mem, and
    every row's archive byte for byte."""
    jcomp, jsizes, jtm = jres
    pcomp, psizes, ptm = pres
    assert pcomp.dtype == torch.uint8 and psizes.dtype == torch.int32
    assert psizes.tolist() == np.asarray(jsizes).tolist()
    assert ptm == jtm
    jcomp = np.asarray(jcomp)
    for b, s in enumerate(psizes.tolist()):
        np.testing.assert_array_equal(bits(pcomp[b, :s]), jcomp[b, :s], err_msg=f"row {b}")


def same_decompress(jres, pres):
    """(outs, status, sizes, temp_mem) of both APIs: all equal, the outputs
    of the members that decoded byte for byte, with the same dtype and
    shape."""
    jouts, jstatus, jsizes, jtm = jres
    pouts, pstatus, psizes, ptm = pres
    assert pstatus.dtype == torch.uint8 and psizes.dtype == torch.int32
    assert pstatus.tolist() == np.asarray(jstatus).tolist()
    assert psizes.tolist() == np.asarray(jsizes).tolist()
    assert ptm == jtm
    for b, (j, p) in enumerate(zip(jouts, pouts)):
        assert tuple(p.shape) == tuple(j.shape) and p.dtype == _TORCH[j.dtype.name]
        if pstatus[b]:
            np.testing.assert_array_equal(bits(p), bits(j), err_msg=f"member {b}")


def rows(comp, sizes):
    return [comp[i, : int(sizes[i])] for i in range(len(sizes))]


def same_raise(exc, match, jfn, pfn):
    with pytest.raises(exc, match=match) as je:
        jfn()
    with pytest.raises(exc, match=match) as pe:
        pfn()
    assert str(pe.value) == str(je.value)


@pytest.mark.parametrize("checksum", [False, True])
def test_ans_roundtrip_with_truncation(rng, checksum):
    js, ps = normal_arrays(rng, jnp.float32, [10000, 30000, 100])
    jres = japi.compress_data(False, js, checksum)
    pres = papi.compress_data(False, ps, checksum)
    same_compress(jres, pres)
    same_decompress(japi.decompress_data(False, rows(*jres[:2]), js, checksum),
                    papi.decompress_data(False, rows(*pres[:2]), ps, checksum))


@pytest.mark.parametrize("dtype", [jnp.float16, jnp.bfloat16, jnp.float32])
def test_float_roundtrip(rng, dtype):
    js, ps = normal_arrays(rng, dtype, [10000, 4096, 55555])
    jres = japi.compress_data(True, js, checksum=True)
    pres = papi.compress_data(True, ps, checksum=True)
    same_compress(jres, pres)
    jd = japi.decompress_data(True, rows(*jres[:2]), js, checksum=True)
    pd = papi.decompress_data(True, rows(*pres[:2]), ps, checksum=True)
    same_decompress(jd, pd)
    assert pd[1].tolist() == [1, 1, 1]
    for t, o in zip(ps, pd[0]):
        np.testing.assert_array_equal(bits(o), bits(t))


def test_float_compression_gain_and_simple_tier(rng):
    """The gain scenario (bf16 N(0,1) under 0.70x) and the simple tier
    (f16, two members), through both APIs' _simple ops."""
    js, ps = normal_arrays(rng, jnp.bfloat16, [100000])
    jc, pc = japi.compress_data_simple(True, js), papi.compress_data_simple(True, ps)
    np.testing.assert_array_equal(bits(pc[0]), bits(jc[0]))
    assert pc[0].numel() / (ps[0].numel() * 2) < 0.70
    js, ps = normal_arrays(rng, jnp.float16, [5000, 20000])
    jc, pc = japi.compress_data_simple(True, js), papi.compress_data_simple(True, ps)
    for j, p in zip(jc, pc):
        np.testing.assert_array_equal(bits(p), bits(j))
    jo, po = japi.decompress_data_simple(True, jc), papi.decompress_data_simple(True, pc)
    for j, p, t in zip(jo, po, ps):
        assert p.dtype == torch.float16 and p.shape == t.shape
        np.testing.assert_array_equal(bits(p), bits(j))
        np.testing.assert_array_equal(bits(p), bits(t))


def test_simple_tier_ans(rng):
    a = rng.integers(0, 40, size=9000, dtype=np.uint8)
    jc, pc = japi.compress_data_simple(False, [jnp.asarray(a)]), papi.compress_data_simple(
        False, [torch.from_numpy(a)])
    np.testing.assert_array_equal(bits(pc[0]), bits(jc[0]))
    jo, po = japi.decompress_data_simple(False, jc), papi.decompress_data_simple(False, pc)
    np.testing.assert_array_equal(po[0].numpy(), np.asarray(jo[0]))
    np.testing.assert_array_equal(po[0].numpy(), a)


def test_empty_tensor_archive(rng):
    a = rng.integers(0, 9, 100, dtype=np.uint8)
    js = [jnp.zeros(0, jnp.uint8), jnp.asarray(a)]
    ps = [torch.zeros(0, dtype=torch.uint8), torch.from_numpy(a)]
    jres, pres = japi.compress_data(False, js), papi.compress_data(False, ps)
    same_compress(jres, pres)
    assert int(pres[1][0]) == C.compressed_overhead(0)
    same_decompress(japi.decompress_data(False, rows(*jres[:2]), js),
                    papi.decompress_data(False, rows(*pres[:2]), ps))


def test_split_size_roundtrip(rng):
    flat = rng.integers(0, 30, size=16384, dtype=np.uint8)
    splits = [4096, 8192, 2048, 2048]
    jres = japi.compress_data_split_size(False, jnp.asarray(flat), splits)
    pres = papi.compress_data_split_size(False, torch.from_numpy(flat), splits)
    same_compress(jres, pres)
    jd = japi.decompress_data_split_size(False, rows(*jres[:2]), jnp.zeros(16384, jnp.uint8),
                                         splits)
    pd = papi.decompress_data_split_size(False, rows(*pres[:2]),
                                         torch.zeros(16384, dtype=torch.uint8), splits)
    assert pd[1].tolist() == np.asarray(jd[1]).tolist() == [1] * 4
    assert pd[2].tolist() == np.asarray(jd[2]).tolist() and pd[3] == jd[3]
    np.testing.assert_array_equal(pd[0].numpy(), np.asarray(jd[0]))
    np.testing.assert_array_equal(pd[0].numpy(), flat)


def test_split_size_alignment_checks():
    same_raise(ValueError, "aligned",
               lambda: japi.compress_data_split_size(False, jnp.zeros(100, jnp.uint8), [3, 97]),
               lambda: papi.compress_data_split_size(False, torch.zeros(100, dtype=torch.uint8),
                                                     [3, 97]))
    same_raise(ValueError, "4-byte aligned",
               lambda: japi.decompress_data_split_size(
                   False, [jnp.zeros(64, jnp.uint8)], jnp.zeros(100, jnp.uint8), [33, 67]),
               lambda: papi.decompress_data_split_size(
                   False, [torch.zeros(64, dtype=torch.uint8)],
                   torch.zeros(100, dtype=torch.uint8), [33, 67]))
    same_raise(ValueError, "sum",
               lambda: japi.compress_data_split_size(False, jnp.zeros(100, jnp.uint8), [4, 97]),
               lambda: papi.compress_data_split_size(False, torch.zeros(100, dtype=torch.uint8),
                                                     [4, 97]))


def test_capacity_failure_reports_size(rng):
    """40000 bytes into a 10-byte output: status 0 and the required size;
    the archive is cut to the (small) member stride on both sides."""
    js, ps = normal_arrays(rng, jnp.float32, [10000])
    jres, pres = japi.compress_data(False, js), papi.compress_data(False, ps)
    same_compress(jres, pres)
    jd = japi.decompress_data(False, rows(*jres[:2]), [jnp.zeros(10, jnp.uint8)])
    pd = papi.decompress_data(False, rows(*pres[:2]), [torch.zeros(10, dtype=torch.uint8)])
    same_decompress(jd, pd)
    assert pd[1].tolist() == [0] and pd[2].tolist() == [40000]


def test_checksum_mismatch_raises(rng):
    js, ps = normal_arrays(rng, jnp.bfloat16, [8192])
    jres, pres = japi.compress_data(True, js, checksum=True), papi.compress_data(
        True, ps, checksum=True)
    same_compress(jres, pres)
    arc = np.asarray(jres[0][0, : int(jres[1][0])]).copy()
    arc[17] ^= 0xA5  # corrupt a nonComp plane byte
    same_raise(ValueError, "checksum",
               lambda: japi.decompress_data(True, [jnp.asarray(arc)], js, checksum=True),
               lambda: papi.decompress_data(True, [torch.from_numpy(arc)], ps, checksum=True))


def test_get_compressed_info(rng):
    js, ps = normal_arrays(rng, jnp.float16, [12345])
    jc, pc = japi.compress_data_simple(True, js), papi.compress_data_simple(True, ps)
    info = papi.get_compressed_info(True, pc)
    assert info == japi.get_compressed_info(True, jc)
    assert info[0]["size"] == 12345 and info[0]["float_type"] == C.FLOAT_TYPE_FLOAT16
    assert papi.get_compressed_info(False, [pc[0][info[0]["ans_start"]:]]) == \
        japi.get_compressed_info(False, [jc[0][info[0]["ans_start"]:]])
    same_raise(ValueError, "too small",
               lambda: japi.get_compressed_info(True, [jnp.zeros(16, jnp.uint8)]),
               lambda: papi.get_compressed_info(True, [torch.zeros(16, dtype=torch.uint8)]))
    same_raise(ValueError, "magic",
               lambda: japi.get_compressed_info(False, [jnp.zeros(64, jnp.uint8)]),
               lambda: papi.get_compressed_info(False, [torch.zeros(64, dtype=torch.uint8)]))


def test_max_size_queries():
    for n in (0, 1, 4095, 4096, 123457):
        assert papi.max_any_compressed_size(n) == japi.max_any_compressed_size(n)
        for jd, pd in ((jnp.float16, torch.float16), (jnp.bfloat16, torch.bfloat16),
                       (jnp.float32, torch.float32)):
            assert papi.max_float_compressed_size(pd, n) == japi.max_float_compressed_size(jd, n)
    js = [jnp.zeros(1000, jnp.bfloat16), jnp.zeros(500, jnp.bfloat16)]
    ps = [torch.zeros(1000, dtype=torch.bfloat16), torch.zeros(500, dtype=torch.bfloat16)]
    assert papi.max_float_compressed_output_size(ps) == japi.max_float_compressed_output_size(js)
    assert papi.max_any_compressed_output_size(ps) == japi.max_any_compressed_output_size(js)
    same_raise(ValueError, "unsupported float dtype",
               lambda: japi.max_float_compressed_size(jnp.int32, 4),
               lambda: papi.max_float_compressed_size(torch.int32, 4))


def test_mixed_sizes_batch(rng):
    arrs = [rng.integers(0, 50, size=n, dtype=np.uint8) for n in (1, 4096, 10001, 37)]
    js, ps = [jnp.asarray(a) for a in arrs], [torch.from_numpy(a) for a in arrs]
    jres, pres = japi.compress_data(False, js), papi.compress_data(False, ps)
    same_compress(jres, pres)
    same_decompress(japi.decompress_data(False, rows(*jres[:2]), js),
                    papi.decompress_data(False, rows(*pres[:2]), ps))


def test_stride_batch_roundtrip(rng):
    B, stride = 4, 6000
    sizes = [6000, 4096, 1024, 5000]
    x = jnp.asarray(rng.standard_normal((B, stride)).astype(np.float32)).astype(jnp.bfloat16)
    jres = japi.compress_data_stride(True, x, sizes)
    pres = papi.compress_data_stride(True, to_torch(x), sizes)
    same_compress(jres, pres)
    jd = japi.decompress_data_stride(True, rows(*jres[:2]), B, stride, jnp.bfloat16, sizes)
    pd = papi.decompress_data_stride(True, rows(*pres[:2]), B, stride, torch.bfloat16, sizes)
    assert pd[0].shape == (B, stride) and pd[0].dtype == torch.bfloat16
    np.testing.assert_array_equal(bits(pd[0]), bits(jd[0]))
    assert pd[1].tolist() == np.asarray(jd[1]).tolist() == [1] * B
    assert pd[2].tolist() == np.asarray(jd[2]).tolist() and pd[3] == jd[3]


def test_float_simple_self_describing_prob_bits(rng):
    js, ps = normal_arrays(rng, jnp.bfloat16, [3000])
    for pb in (9, 11):
        jc = japi.compress_data_simple(True, js, prob_bits=pb)
        pc = papi.compress_data_simple(True, ps, prob_bits=pb)
        np.testing.assert_array_equal(bits(pc[0]), bits(jc[0]))
        info = papi.get_compressed_info(True, pc)
        assert info == japi.get_compressed_info(True, jc) and info[0]["prob_bits"] == pb
        po = papi.decompress_data_simple(True, pc)
        np.testing.assert_array_equal(bits(po[0]), bits(japi.decompress_data_simple(True, jc)[0]))
        np.testing.assert_array_equal(bits(po[0]), bits(ps[0]))


def test_get_compressed_info_device(rng):
    js, ps = normal_arrays(rng, jnp.bfloat16, [2000])
    jres = japi.compress_data(True, [js[0], js[0]], checksum=True)
    pres = papi.compress_data(True, [ps[0], ps[0]], checksum=True)
    same_compress(jres, pres)
    jd = japi.get_compressed_info_device(True, jres[0])
    pd = papi.get_compressed_info_device(True, pres[0])
    assert sorted(pd) == sorted(jd)
    for k in pd:
        assert pd[k].tolist() == np.asarray(jd[k]).tolist(), k
    b = rng.integers(0, 40, 5000).astype(np.uint8)
    jres = japi.compress_data(False, [jnp.asarray(b)], prob_bits=11, checksum=True)
    pres = papi.compress_data(False, [torch.from_numpy(b)], prob_bits=11, checksum=True)
    same_compress(jres, pres)
    jd = japi.get_compressed_info_device(False, jres[0])
    pd = papi.get_compressed_info_device(False, pres[0])
    for k in pd:
        assert pd[k].tolist() == np.asarray(jd[k]).tolist(), k
    assert pd["prob_bits"].tolist() == [11] and pd["valid"].tolist() == [True]
    same_raise(ValueError, "u8 archive matrix",
               lambda: japi.get_compressed_info_device(True, jnp.zeros(64, jnp.uint8)),
               lambda: papi.get_compressed_info_device(True, torch.zeros(64, dtype=torch.uint8)))


def test_batch_rules():
    """An empty batch, mixed dtypes and mixed devices are refused."""
    same_raise(ValueError, "empty batch", lambda: japi.compress_data(True, []),
               lambda: papi.compress_data(True, []))
    same_raise(ValueError, "share a dtype",
               lambda: japi.compress_data(True, [jnp.zeros(4, jnp.float16),
                                                 jnp.zeros(4, jnp.bfloat16)]),
               lambda: papi.compress_data(True, [torch.zeros(4, dtype=torch.float16),
                                                 torch.zeros(4, dtype=torch.bfloat16)]))
    with pytest.raises(ValueError, match="one device"):
        papi.compress_data(False, [torch.zeros(4, dtype=torch.uint8),
                                   torch.zeros(4, dtype=torch.uint8, device="meta")])


@pytest.mark.gpu
def test_api_on_card_matches_cpu(cuda_device, rng):
    """Ragged float and raw batches through the API on the card: the same
    archives, status and outputs as the CPU route, each kernel launched
    once per call, every tensor on the card."""
    xs = [rng.standard_normal(n).astype(np.float32) for n in (0, 1, 4097, 70000, 12305)]
    for dtype in (torch.float16, torch.bfloat16, torch.float32):
        ts = [torch.from_numpy(x).to(dtype) for x in xs]
        tc = [t.to(cuda_device) for t in ts]
        for ck in (False, True):
            _build.reset_kernel_launches()
            kres = papi.compress_data(True, tc, ck)
            split_k = "split_f32" if dtype == torch.float32 else "split"
            assert [_build.kernel_launches()[k] for k in (split_k, "encode", "assembly")] == [1] * 3
            assert kres[0].is_cuda and kres[1].is_cuda
            pres = papi.compress_data(True, ts, ck)
            assert kres[1].tolist() == pres[1].tolist() and kres[2] == pres[2]
            for b, s in enumerate(pres[1].tolist()):
                assert torch.equal(kres[0][b, :s].cpu(), pres[0][b, :s])
            _build.reset_kernel_launches()
            kd = papi.decompress_data(True, rows(*kres[:2]), tc, ck)
            assert _build.kernel_launches()["decode_f32" if dtype == torch.float32 else "decode"] == 1
            assert kd[1].tolist() == [1] * len(ts)
            for o, t in zip(kd[0], ts):
                assert o.is_cuda and torch.equal(o.cpu(), t)
    arrs = [rng.integers(0, 50, size=n, dtype=np.uint8) for n in (0, 1, 4096, 10001, 37)]
    ts = [torch.from_numpy(a) for a in arrs]
    tc = [t.to(cuda_device) for t in ts]
    _build.reset_kernel_launches()
    kres = papi.compress_data(False, tc)
    assert [_build.kernel_launches()[k] for k in ("hist", "encode", "assembly")] == [1] * 3
    pres = papi.compress_data(False, ts)
    for b, s in enumerate(pres[1].tolist()):
        assert torch.equal(kres[0][b, :s].cpu(), pres[0][b, :s])
    _build.reset_kernel_launches()
    kd = papi.decompress_data(False, rows(*kres[:2]), tc)
    assert _build.kernel_launches()["decode_raw"] == 1
    assert all(torch.equal(o.cpu(), t) for o, t in zip(kd[0], ts))
    arcs = papi.compress_data_simple(True, [t.to(cuda_device).to(torch.bfloat16)
                                            for t in map(torch.from_numpy, xs[2:])])
    outs = papi.decompress_data_simple(True, arcs)
    assert all(o.is_cuda for o in outs)


# ---------------------------------------------------------------------------
# decode width and block geometry: inputs whose result depends on them
# ---------------------------------------------------------------------------


def _front_ends(front):
    """decompress_data and decompress_data_simple of both packages through
    `front`: "api" (functional) or "torch_api" (in place, into outputs that
    start as a known sentinel)."""
    from dietgpu_tpu import torch_api as jtapi

    from dietgpu_tpu_torch import torch_api as ptapi

    if front == "api":
        def jdec(ca, arcs, like, ck):
            outs, st, sz, tm = japi.decompress_data(
                ca, [jnp.asarray(a.numpy()) for a in arcs],
                [jnp.zeros(t.shape, _JNP[t.dtype]) for t in like], ck)
            return [to_torch(o) for o in outs], st, sz, tm

        def pdec(ca, arcs, like, ck):
            return papi.decompress_data(ca, arcs, [torch.empty_like(t) for t in like], ck)

        def jsimple(ca, arcs):
            return [to_torch(o) for o in
                    japi.decompress_data_simple(ca, [jnp.asarray(a.numpy()) for a in arcs])]

        return jdec, pdec, jsimple, papi.decompress_data_simple

    def in_place(fn):
        def dec(ca, arcs, like, ck):
            outs = [torch.full_like(t.view(torch.uint8), 7).view(t.dtype) for t in like]
            st, sz, tm = fn(ca, arcs, outs, checksum=ck)
            return outs, st, sz, tm
        return dec

    return (in_place(jtapi.decompress_data), in_place(ptapi.decompress_data),
            jtapi.decompress_data_simple, ptapi.decompress_data_simple)


_JNP = {torch.uint8: jnp.uint8, torch.bfloat16: jnp.bfloat16}


def _archive(rng, kind, n, checksum):
    """One archive of n random bytes (raw) or words (bf16) through the JAX
    API, as a CPU tensor of its exact size, and the input."""
    if kind == "raw":
        x = jnp.asarray(rng.integers(0, 50, size=n, dtype=np.uint8))
    else:
        x = jnp.asarray(rng.standard_normal(n).astype(np.float32)).astype(jnp.bfloat16)
    comp, sizes, _ = japi.compress_data(kind != "raw", [x], checksum)
    return to_torch(np.asarray(comp)[0, : int(sizes[0])]), to_torch(x)


def _lie_block_count(arc, kind, nb):
    """A copy of the archive whose ANS header (the one embedded after the
    float header, for a float archive) claims `nb` blocks."""
    arc = arc.clone()
    start = 0
    if kind != "raw":
        start = papi.get_compressed_info(True, [arc])[0]["ans_start"]
    arc[start + 4 : start + 8] = torch.tensor([nb], dtype=torch.int32).view(torch.uint8)
    return arc


def _same_outcome(jfn, pfn):
    """Both calls raise the same exception, or return equal outputs."""
    try:
        jres = jfn()
    except ValueError as e:
        with pytest.raises(ValueError) as pe:
            pfn()
        assert str(pe.value) == str(e)
        return None
    pres = pfn()
    for j, p in zip(jres, pres):
        assert tuple(p.shape) == tuple(j.shape) and p.dtype == j.dtype
        np.testing.assert_array_equal(bits(p), bits(j))
    return pres


@pytest.mark.parametrize("front", ["api", "torch_api"])
@pytest.mark.parametrize("kind", ["raw", "bf16"])
def test_too_small_output_with_checksum_matches_jax(rng, front, kind):
    """12289 bytes or words, checksummed, into an output of 8193: the JAX
    API decodes at 4 blocks (its power-of-two width), so the whole archive
    decodes, the checksum holds and the member reports status 0 with its
    size; at 3 blocks the archive would be cut and the checksum fail."""
    jdec, pdec, _, _ = _front_ends(front)
    arc, x = _archive(rng, kind, 12289, True)
    like = [x[:8193]]
    jouts, jst, jsz, jtm = jdec(kind != "raw", [arc], like, True)
    pouts, pst, psz, ptm = pdec(kind != "raw", [arc], like, True)
    assert np.asarray(pst).tolist() == np.asarray(jst).tolist() == [0]
    assert np.asarray(psz).tolist() == np.asarray(jsz).tolist() == [12289 * x.element_size()]
    assert ptm == jtm
    if front == "torch_api":  # a member with status 0 is left as it was
        np.testing.assert_array_equal(bits(pouts[0]), bits(jouts[0]))


@pytest.mark.parametrize("front", ["api", "torch_api"])
@pytest.mark.parametrize("nb", [4, 5, 100])
def test_lying_block_count_decodes_at_jax_width(rng, front, nb):
    """A 9000-byte raw archive whose header claims 4, 5 or 100 blocks (3
    are true), into 9000 bytes: the count is clamped to the decode width's
    blocks, so the bytes decoded past the true blocks follow the width. The
    JAX API's is 4 blocks; status, sizes and bytes must be its."""
    jdec, pdec, _, _ = _front_ends(front)
    arc, x = _archive(rng, "raw", 9000, False)
    arc = _lie_block_count(arc, "raw", nb)
    jouts, jst, jsz, jtm = jdec(False, [arc], [x], False)
    pouts, pst, psz, ptm = pdec(False, [arc], [x], False)
    assert np.asarray(pst).tolist() == np.asarray(jst).tolist()
    assert np.asarray(psz).tolist() == np.asarray(jsz).tolist() and ptm == jtm
    np.testing.assert_array_equal(bits(pouts[0]), bits(jouts[0]))


@pytest.mark.parametrize("front", ["api", "torch_api"])
@pytest.mark.parametrize("kind", ["raw", "bf16"])
@pytest.mark.parametrize("nb", [2, 4])
@pytest.mark.parametrize("batch", [1, 2])
def test_simple_tier_lying_block_count_matches_jax(rng, front, kind, nb, batch):
    """decompress_data_simple on a 9000-byte (raw) or 9000-word (bf16)
    archive whose ANS header claims 2 or 4 blocks (3 are true). The JAX
    API takes the block geometry from the header on its CPU route, at B = 1
    and at B > 1 (only its TPU one-grid route takes it from the sizes), and
    so does the port: the same outputs, or the same exception."""
    _, _, jsimple, psimple = _front_ends(front)
    arcs = []
    for m in range(batch):
        arc, _ = _archive(rng, kind, 9000, False)
        arcs.append(_lie_block_count(arc, kind, nb) if m == 0 else arc)
    _same_outcome(lambda: jsimple(kind != "raw", arcs), lambda: psimple(kind != "raw", arcs))
