"""The PyTorch port's ragged float batches and standalone join against the
JAX package (CPU).

``float_compress_batched`` with one length per member (the plain versions
of the split kernels reading per-member lengths, each member's ANS archive
at its own base) is held member by member against the JAX package's
single-tensor ``float_compress_padded``, for f16, bf16 and f32 at pb
9/10/11, with members of 0, 1, 4095, 4097 and 12305 words in one batch.
The join's plain version is held against ``join_words_pallas`` /
``join_words_pallas_f32`` in interpret mode, aligned and unaligned. The
tests marked `gpu` hold the join and ragged split kernels against their
plain versions on the card. Tolerance 0 throughout: the codec is lossless.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dietgpu_tpu.floatcodec import codec as jcodec
from dietgpu_tpu.floatcodec import split as jsplit

import dietgpu_tpu_torch as port
from dietgpu_tpu_torch import _build, interop
from dietgpu_tpu_torch import constants as C
from dietgpu_tpu_torch.floatcodec import codec, cuda_float
from torch_port_helpers import cuda_device, interpret_pallas  # noqa: F401

F16, BF16, F32 = C.FLOAT_TYPE_FLOAT16, C.FLOAT_TYPE_BFLOAT16, C.FLOAT_TYPE_FLOAT32
LENGTHS = [0, 1, 4095, 4097, 12305]
LW = 4 * C.DEFAULT_BLOCK_SIZE  # one padded shape keeps JAX's compiles few

_jcomp = jax.jit(jcodec.float_compress_padded, static_argnums=(2, 3, 4))
_jjoin = jax.jit(jsplit.join_words, static_argnums=(2,))


def _words(seed, ft, lengths, lw=LW):
    """(B, lw) words of standard-normal values of scale m + 1 for member m,
    zero past each member's length: uint16 for f16/bf16, uint32 for f32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((len(lengths), lw)).astype(np.float32)
    x *= np.arange(1, len(lengths) + 1, dtype=np.float32)[:, None]
    if ft == BF16:
        w = (x.view(np.uint32) >> 16).astype(np.uint16)
    elif ft == F16:
        w = x.astype(np.float16).view(np.uint16)
    else:
        w = x.view(np.uint32).copy()
    for m, n in enumerate(lengths):
        w[m, n:] = 0
    return w


@pytest.mark.parametrize("pb,ck", [(9, False), (10, True), (11, False)])
@pytest.mark.parametrize("ft", [F16, BF16, F32])
def test_ragged_batch_matches_jax_per_member(ft, pb, ck):
    """Each member's archive equals JAX's single-tensor archive, and the
    batch decodes exactly, each size from its own header."""
    w = _words(10 * ft + pb, ft, LENGTHS)
    arcs, sizes = port.float_compress_batched(interop.words_from_numpy(w), LENGTHS, ft, pb, ck)
    assert arcs.shape == (len(LENGTHS), codec.float_archive_buffer_bytes(ft, LW) // 4)
    got = interop.archives_batch_to_numpy(arcs, sizes)
    for m, n in enumerate(LENGTHS):
        jarc, jsize = _jcomp(jnp.asarray(w[m]), n, ft, pb, ck)
        np.testing.assert_array_equal(got[m], np.asarray(jarc)[: int(jsize)],
                                      err_msg=f"member {m} (n = {n})")
    res = port.float_decompress_batched(arcs, ft, LW, pb, ck)
    assert res["success"].all() and res["checksum_ok"].all()
    assert res["size"].tolist() == LENGTHS
    out = interop.words_to_numpy(res["out32"])
    np.testing.assert_array_equal(out if ft == F32 else out.view(np.uint16), w)


@pytest.mark.parametrize("ft", [BF16, F32])
def test_ragged_batch_equals_uniform_and_single(ft):
    """A ragged batch whose lengths happen to be equal takes the uniform
    path; both equal the single-tensor path member by member, and every
    member's archive starts its ANS section at its own base."""
    w = _words(3, ft, [LW] * 3)
    t = interop.words_from_numpy(w)
    a, s = port.float_compress_batched(t, [LW - 5] * 3, ft)
    b, r = port.float_compress_batched(t, LW - 5, ft)
    assert torch.equal(s, r)
    lens = [LW - 5, 7, 4096]
    c, q = port.float_compress_batched(t, lens, ft)
    for m in range(3):
        assert torch.equal(a[m, : int(s[m]) // 4], b[m, : int(r[m]) // 4])
        one, size = codec.float_compress_padded(t[m], lens[m], ft)
        assert int(size) == int(q[m])
        assert torch.equal(c[m, : int(q[m]) // 4], one[: int(size) // 4])


def test_ragged_batch_rejects_bad_lengths():
    w = torch.zeros((2, LW), dtype=torch.int16)
    with pytest.raises(ValueError):
        port.float_compress_batched(w, [LW], BF16)
    with pytest.raises(ValueError):
        port.float_compress_batched(w, [LW, LW + 1], BF16)
    with pytest.raises(ValueError):
        port.float_compress_batched(w, [-1, 3], BF16)


def _planes(seed, n4, f32):
    rng = np.random.default_rng(seed)
    widths = (1, 2, 1) if f32 else (1, 1)
    return [rng.integers(0, 2**32, w * n4, dtype=np.uint64).astype(np.uint32) for w in widths]


@pytest.mark.parametrize("n4", [1000, 65536])
@pytest.mark.parametrize("ft", [F16, BF16])
def test_join_matches_pallas_interpret(interpret_pallas, ft, n4):
    """join_words_packed against join_words_pallas, unaligned and aligned to
    its tile, and the batched plain join row by row against the XLA join."""
    from dietgpu_tpu.floatcodec import pallas_float

    e, c = _planes(n4 + ft, n4, False)
    got = port.join_words_packed(torch.from_numpy(e.view(np.int32)),
                                 torch.from_numpy(c.view(np.int32)), ft)
    want = np.asarray(pallas_float.join_words_pallas(jnp.asarray(e), jnp.asarray(c), ft))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    jw = np.asarray(_jjoin(jnp.asarray(e.view(np.uint8)), (jnp.asarray(c.view(np.uint8)),), ft))
    np.testing.assert_array_equal(got.numpy().view(np.uint16), jw)


@pytest.mark.parametrize("n4", [1000, 32768])
def test_join_f32_matches_pallas_interpret(interpret_pallas, n4):
    from dietgpu_tpu.floatcodec import pallas_float

    e, lo, hi = _planes(n4, n4, True)
    got = port.join_words_packed_f32(*(torch.from_numpy(p.view(np.int32)) for p in (e, lo, hi)))
    want = np.asarray(pallas_float.join_words_pallas_f32(
        jnp.asarray(e), jnp.asarray(lo), jnp.asarray(hi)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("ft", [F16, BF16, F32])
def test_join_inverts_split(ft):
    """The batched plain join of the split's planes gives the words back,
    at ragged lengths (zero past each), one row per member."""
    lens = [LW, LW - 5, 3]
    w = _words(7 + ft, ft, lens)
    t = interop.words_from_numpy(w)
    if ft == F32:
        exp32, lo32, hi32, _, _ = cuda_float.split_words_f32_batched_plain(t, lens)
        out = cuda_float.join_words_f32_plain(exp32, lo32, hi32)
        single = port.join_words_packed_f32(exp32[1], lo32[1], hi32[1])
    else:
        exp32, nc32, _, _ = cuda_float.split_words_batched_plain(t.view(torch.int32), lens, ft)
        out = cuda_float.join_words_plain(exp32, nc32, ft)
        single = port.join_words_packed(exp32[1], nc32[1], ft)
    assert torch.equal(out.view(torch.int32), t.view(len(lens), -1).view(torch.int32))
    assert torch.equal(single, out[1])


def test_join_rejects_bad_planes():
    e = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        port.join_words_packed(e, e[:, :4], BF16)
    with pytest.raises(ValueError):
        port.join_words_packed(e, e, F32)
    with pytest.raises(ValueError):
        port.join_words_packed_f32(e, e, e)
    with pytest.raises(ValueError):
        port.join_words_packed(e.to(torch.int64), e, BF16)


@pytest.mark.gpu
def test_join_kernels_on_card_match_plain(cuda_device):
    """join and join_f32 against their plain versions: aligned and
    unaligned n4, 16-byte aligned rows and rows that are not, B = 1 and 3,
    each launched once per call."""
    g = torch.Generator(device=cuda_device).manual_seed(5)

    def rand(*shape):
        return torch.randint(-(2**31), 2**31, shape, dtype=torch.int32, device=cuda_device,
                             generator=g)

    for B, n4 in ((1, 1 << 16), (3, 1000), (3, 4097), (1, 1)):
        e, c, h = rand(B, n4 + 1), rand(B, n4 + 1), rand(B, n4 + 1)
        lo = rand(B, 2 * n4 + 2)
        for off in (0, 1):  # row starts 16-byte aligned or not
            ev, cv, hv = e[:, off : off + n4], c[:, off : off + n4], h[:, off : off + n4]
            lv = lo[:, 2 * off : 2 * off + 2 * n4]
            for ft in (F16, BF16):
                _build.reset_kernel_launches()
                got = cuda_float.join_words_cuda(ev, cv, ft)
                assert _build.kernel_launches()["join"] == 1
                assert torch.equal(got, cuda_float.join_words_plain(ev, cv, ft))
            _build.reset_kernel_launches()
            got = cuda_float.join_words_f32_cuda(ev, lv, hv)
            assert _build.kernel_launches()["join_f32"] == 1
            assert torch.equal(got, cuda_float.join_words_f32_plain(ev, lv, hv))


@pytest.mark.gpu
@pytest.mark.parametrize("ft", [F16, BF16, F32])
def test_ragged_kernels_on_card_match_plain(cuda_device, ft):
    """The split kernels with per-member lengths (f32 in its container
    mode too), and the whole ragged compress, against their plain
    versions; the decode gives every member back."""
    lens = [LW, 0, 1, 4095, 4097]
    w = interop.words_from_numpy(_words(11 + ft, ft, lens)).to(cuda_device)
    B = len(lens)
    for ck in (False, True):
        if ft == F32:
            got = cuda_float.split_words_f32_batched_cuda(w, lens, ck)
            want = cuda_float.split_words_f32_batched_plain(w, lens, ck)
            R = codec.float_archive_buffer_bytes(ft, LW) // 4
            pk, pp = (torch.zeros((B, R), dtype=torch.int32, device=cuda_device) for _ in range(2))
            got = (*got, *cuda_float.split_words_f32_batched_cuda(w, lens, ck, planes_out=pk[:, 4:]))
            want = (*want, *cuda_float.split_words_f32_batched_plain(w, lens, ck,
                                                                     planes_out=pp[:, 4:]))
        else:
            pairs = w.view(torch.int32)
            got = cuda_float.split_words_batched_cuda(pairs, lens, ft, ck)
            want = cuda_float.split_words_batched_plain(pairs, lens, ft, ck)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        _build.reset_kernel_launches()
        ka, ks = codec.float_compress_batched(w, lens, ft, 10, ck)
        counts = _build.kernel_launches()
        assert [counts[k] for k in ("split_f32" if ft == F32 else "split", "encode",
                                    "assembly")] == [1, 1, 1]
        pa, ps = codec.float_compress_batched_plain(w, lens, ft, 10, ck)
        assert torch.equal(ks, ps)
        for m in range(B):
            assert torch.equal(ka[m, : int(ks[m]) // 4], pa[m, : int(ks[m]) // 4])
        res = codec.float_decompress_batched(ka, ft, LW, 10, ck)
        assert res["success"].all() and res["checksum_ok"].all()
        assert torch.equal(res["out32"].reshape(B, -1).view(torch.int32).cpu(),
                           w.reshape(B, -1).view(torch.int32).cpu())
