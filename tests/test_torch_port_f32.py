"""The PyTorch port's f32 float codec against the JAX package (CPU).

float_compress_padded / float_decompress_padded with FLOAT_TYPE_FLOAT32 on
the CPU (the plain versions of the f32 split, encode, assembly and f32
decode kernels) must write the JAX XLA codec's archive byte for byte,
decode the JAX archives and the golden fixture, and be decoded by the JAX
codec; once, the split and the archive are also held against the Pallas
path in interpret mode. Tolerance 0 throughout: the codec is lossless and
its archive format fixed.

The f32 split's plain version is also held against the JAX split on the
inputs the split kernel's design is at risk on: constant words (one
exponent), alternating exponents and uniformly random words (every
exponent byte) at the member lengths around a quad, a 16-word group and a
block, alone, as one ragged batch, and into strided container rows whose
words past the archived plane ends must keep their contents; and against
``split_words_pallas_f32`` in interpret mode on uniform and alternating
words. The tests marked `gpu` hold the kernel against the plain version
on the card on the same inputs.
"""

import os

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
from dietgpu_tpu_torch.ans import cuda_decode, layout
from dietgpu_tpu_torch.floatcodec import codec, cuda_float, split
from torch_port_helpers import cuda_device, interpret_pallas  # noqa: F401

LW = 16384  # one padded shape keeps JAX's compiles few
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
F32 = C.FLOAT_TYPE_FLOAT32

_jcomp = jax.jit(jcodec.float_compress_padded, static_argnums=(2, 3, 4))
_jdec = jax.jit(jcodec.float_decompress_padded, static_argnums=(1, 2, 3, 4))
_jsplit = jax.jit(jsplit.split_words, static_argnums=(1,))


def _words(rng, n, lw=LW):
    """(lw,) uint32 f32 words, zero past n."""
    w = (rng.standard_normal(lw).astype(np.float32) * 3.0).view(np.uint32)
    w[n:] = 0
    return w


def _decode_port(arc32, lw=LW, verify=False, static_length=None):
    res = codec.float_decompress_padded(arc32, F32, lw, 10, verify, static_length)
    return res, interop.words_to_numpy(res["out32"])


@pytest.mark.parametrize("ck", [False, True])
@pytest.mark.parametrize("n", [0, 1, 4095, 4096, 4097, 3 * 4096 + 17, LW])
def test_f32_codec_matches_jax_both_ways(n, ck):
    w = _words(np.random.default_rng(n + ck), n)
    arc32, size = codec.float_compress_padded(interop.words_from_numpy(w), n, F32, 10, ck)
    size = int(size)
    jarc, jsize = _jcomp(jnp.asarray(w), n, F32, 10, ck)
    jarc = np.asarray(jarc)
    assert size == int(jsize)
    np.testing.assert_array_equal(interop.archive_to_numpy(arc32, size), jarc[:size])

    # roundtrip through the port
    res, got = _decode_port(arc32, verify=ck, static_length=n)
    assert bool(res["success"]) and bool(res["checksum_ok"]) and int(res["size"]) == n
    np.testing.assert_array_equal(got, w)
    # JAX archive -> port decoder
    res, got = _decode_port(interop.archive_from_numpy(jarc[:size]), verify=ck)
    assert bool(res["success"]) and bool(res["checksum_ok"])
    np.testing.assert_array_equal(got, w)
    # port archive -> JAX decoder
    jres = _jdec(jnp.asarray(interop.archive_to_numpy(arc32)), F32, LW, 10, ck)
    assert bool(jres["success"]) and bool(jres["checksum_ok"])
    np.testing.assert_array_equal(np.asarray(jres["out"]), w)


def test_golden_f32_fixture():
    """Decode the golden archive and re-encode it to the same bytes."""
    gold = np.fromfile(os.path.join(FIXTURES, "float_f32.bin"), np.uint8)
    w = np.random.default_rng(0x60D).standard_normal(3000).astype(np.float32).view(np.uint32)
    res, got = _decode_port(interop.archive_from_numpy(gold), 4096, verify=True)
    assert bool(res["success"]) and bool(res["checksum_ok"])
    np.testing.assert_array_equal(got[:3000], w)
    assert not got[3000:].any()

    padded = np.zeros(4096, np.uint32)
    padded[:3000] = w
    arc32, size = codec.float_compress_padded(interop.words_from_numpy(padded), 3000, F32)
    assert int(size) == gold.size
    np.testing.assert_array_equal(interop.archive_to_numpy(arc32, int(size)), gold)


@pytest.mark.parametrize("n", [4096, 4095, 3001, 0])
def test_f32_split_plain_matches_jax(n):
    """The f32 split kernel's plain version: planes, histogram, checksum."""
    Lw = 4096
    rng = np.random.default_rng(n)
    w = rng.integers(0, 2**32, Lw, dtype=np.uint64).astype(np.uint32)
    words = torch.from_numpy(w.view(np.int32).copy())
    exp32, lo32, hi32, hist, cks = cuda_float.split_words_f32_plain(words, n, True)

    wz = w.copy()
    wz[n:] = 0
    comp, (lo, hi) = _jsplit(jnp.asarray(wz), F32)
    comp = np.asarray(comp)
    np.testing.assert_array_equal(layout.u32_to_u8le(exp32).numpy(), comp)
    np.testing.assert_array_equal(lo32.numpy().view(np.uint16), np.asarray(lo))
    np.testing.assert_array_equal(layout.u32_to_u8le(hi32).numpy(), np.asarray(hi))
    np.testing.assert_array_equal(hist.numpy(), np.bincount(comp[:n], minlength=256))
    x = np.bitwise_xor.reduce(wz.view(np.uint8)) if n else 0
    assert int(cks) == int(x)

    # join inverts split, as the JAX join does
    joined = split.join_words(
        layout.u32_to_u8le(exp32), (lo32.view(torch.int16), layout.u32_to_u8le(hi32)), F32
    )
    np.testing.assert_array_equal(joined.numpy().view(np.uint32), wz)


def test_f32_split_plain_writes_only_archived_plane_lengths():
    """Into the container, each plane stops at its archived length (the
    next section follows at once)."""
    Lw, n = 4096, 1001
    words = torch.from_numpy(_words(np.random.default_rng(1), n, Lw).view(np.int32).copy())
    lo_out = torch.full((Lw // 2,), -7, dtype=torch.int32)
    hi_out = torch.full((Lw // 4,), -7, dtype=torch.int32)
    _, lo_full, hi_full, _, _ = cuda_float.split_words_f32_plain(words, n)
    cuda_float.split_words_f32_plain(words, n, lo_out=lo_out, hi_out=hi_out)
    lo_keep, hi_keep = C.round_up(n, 8) // 2, C.round_up(n, 16) // 4
    assert torch.equal(lo_out[:lo_keep], lo_full[:lo_keep])
    assert torch.equal(hi_out[:hi_keep], hi_full[:hi_keep])
    assert (lo_out[lo_keep:] == -7).all() and (hi_out[hi_keep:] == -7).all()
    with pytest.raises(ValueError):
        cuda_float.split_words_f32_plain(words, Lw + 1)
    with pytest.raises(ValueError):
        cuda_float.split_words_f32_plain(words.view(torch.int16), 10)


def test_f32_failures_static_length_header_and_payload():
    n = 5000
    w = _words(np.random.default_rng(4), n)
    arc32, size = codec.float_compress_padded(interop.words_from_numpy(w), n, F32, 10, True)
    assert bool(_decode_port(arc32, static_length=n)[0]["success"])
    for sl in (n - 1, n + 1, LW):
        assert not bool(_decode_port(arc32, static_length=sl)[0]["success"])
    # wrong float type, wrong magic, word count beyond capacity or
    # disagreeing with the embedded ANS header: all fail, none indexes out
    # of bounds
    for idx, val in ((2, C.FLOAT_TYPE_BFLOAT16 | 0x10), (0, 0x12345678), (1, LW + 1),
                     (1, n + 16), (1, 2**31 + 5), (1, 0)):
        bad = arc32.clone()
        bad[idx] = int(np.int32(np.uint32(val)))
        assert not bool(_decode_port(bad)[0]["success"]), (idx, val)
    assert not bool(_decode_port(arc32[:40].clone())[0]["success"])
    # a corrupted low-plane and high-plane byte decode, and fail the checksum
    for word in (4 + 7, 4 + C.round_up(n, 8) // 2 + 3):
        bad = arc32.clone()
        bad[word] ^= 0x00010000
        res, _ = _decode_port(bad, verify=True)
        assert bool(res["success"]) and not bool(res["checksum_ok"])
        jres = _jdec(jnp.asarray(interop.archive_to_numpy(bad)), F32, LW, 10, True)
        assert not bool(jres["checksum_ok"])


def test_f32_entry_points_cpu():
    x = torch.randn(7001, generator=torch.Generator().manual_seed(3))
    for ck in (False, True):
        arc = port.float_compress(x, use_checksum=ck, device="cpu")
        assert torch.equal(port.float_decompress(arc, device="cpu"), x)
    # float32 values and their int32 bits give the same archive
    w = _words(np.random.default_rng(5), 5000, 8192)
    a1, s1 = codec.float_compress_padded(torch.from_numpy(w.view(np.float32)), 5000, F32)
    a2, s2 = codec.float_compress_padded(interop.words_from_numpy(w), 5000, F32)
    assert int(s1) == int(s2) and torch.equal(a1[: int(s1) // 4], a2[: int(s2) // 4])


def test_f32_decode_plain_digest_equals_stored_checksum():
    w = _words(np.random.default_rng(8), 12345)
    arc32, _ = codec.float_compress_padded(interop.words_from_numpy(w), 12345, F32, 10, True)
    out32, ok, n, digest = cuda_decode.decode_float_plain(arc32, F32, LW, 10, 12345, True)
    assert bool(ok) and int(n) == 12345
    assert int(digest) == int(arc32[3])  # the stored word checksum


def test_f32_split_and_archive_match_pallas_interpret(interpret_pallas):
    """The one place the Pallas f32 path itself is the reference (compress
    only: the JAX suite keeps the f32 fused decode in its slow tier)."""
    from dietgpu_tpu.floatcodec import pallas_codec as pfc
    from dietgpu_tpu.floatcodec import pallas_float as pf

    Lw, n = 4096, 4000
    w = _words(np.random.default_rng(0), n, Lw)
    pexp, plo, phi, phist, pcks = pf.split_words_pallas_f32(jnp.asarray(w), with_cksum=True)
    exp32, lo32, hi32, hist, cks = cuda_float.split_words_f32_plain(
        interop.words_from_numpy(w), Lw, True
    )
    for got, want, k in ((exp32, pexp, Lw // 4), (lo32, plo, Lw // 2), (hi32, phi, Lw // 4)):
        np.testing.assert_array_equal(
            interop.words_to_numpy(got), np.asarray(want)[:k].view(np.uint32)
        )
    # the Pallas histogram counts its zero-padded tile into bin 0
    want = np.asarray(phist).astype(np.int64)
    want[0] -= pf.split_total_words_f32(Lw) - Lw
    np.testing.assert_array_equal(hist.numpy(), want)
    assert int(cks) == int(pcks)

    arc_p, size_p = pfc.float_compress_padded_pallas(jnp.asarray(w), n, F32, 10, False)
    arc32, size = codec.float_compress_padded(interop.words_from_numpy(w), n, F32)
    assert int(size) == int(size_p)
    want = interop.archive_to_numpy(interop.archive_from_numpy(np.asarray(arc_p)), int(size))
    np.testing.assert_array_equal(interop.archive_to_numpy(arc32, int(size)), want)
    # the port decodes the Pallas container as it is
    res, got = _decode_port(interop.archive_from_numpy(np.asarray(arc_p)), Lw, static_length=n)
    assert bool(res["success"])
    np.testing.assert_array_equal(got, w)


@pytest.mark.gpu
def test_f32_split_kernel_matches_plain(cuda_device):
    Lw = 1 << 16
    g = torch.Generator(device=cuda_device).manual_seed(3)
    words = torch.randint(-(2**31), 2**31, (Lw,), dtype=torch.int32,
                          device=cuda_device, generator=g)
    for n in (Lw, Lw - 5, 17):
        for ck in (False, True):
            got = [x[0] for x in cuda_float.split_words_f32_batched_cuda(words[None], n, ck)]
            want = cuda_float.split_words_f32_plain(words, n, ck)
            for a, b in zip(got, want):
                assert torch.equal(a, b)


@pytest.mark.gpu
def test_f32_codec_on_card_matches_cpu(cuda_device):
    n = 3 * 4096 + 17
    w = interop.words_from_numpy(_words(np.random.default_rng(31), n))
    for ck in (False, True):
        ka, ks = codec.float_compress_padded(w.to(cuda_device), n, F32, 10, ck)
        pa, ps = codec.float_compress_padded(w, n, F32, 10, ck)
        assert int(ks) == int(ps)
        assert torch.equal(ka[: int(ks) // 4].cpu(), pa[: int(ps) // 4])
        for digest in (False, True):
            got = cuda_decode.decode_float(ka, F32, LW, 10, n, digest)
            want = cuda_decode.decode_float_plain(ka, F32, LW, 10, n, digest)
            for a, b in zip(got, want):
                assert torch.equal(a.cpu().to(torch.int64), b.cpu().to(torch.int64))
    x = torch.randn(7001, generator=torch.Generator().manual_seed(3))
    arc = port.float_compress(x, use_checksum=True)
    assert arc.is_cuda
    assert torch.equal(arc.cpu(), port.float_compress(x, use_checksum=True, device="cpu"))
    assert torch.equal(port.float_decompress(arc).cpu(), x)


# ---- the f32 split on the inputs its kernel's design is at risk on ----

SPLIT_LW = 4 * C.DEFAULT_BLOCK_SIZE
SPLIT_EDGES = [0, 1, 3, 4, 5, 7, 8, 9, 15, 16, 17, 4095, 4096, 4097, SPLIT_LW]
FILLS = ("constant", "alternating", "uniform")


def _fill(kind, rows, seed, lw=SPLIT_LW):
    """(rows, lw) uint32 f32 words: all 1.0, 1.0 and 65536.0 alternating
    (two exponents), or uniformly random (every exponent byte)."""
    if kind == "constant":
        return np.full((rows, lw), 0x3F800000, np.uint32)
    if kind == "alternating":
        return np.tile(np.array([0x3F800000, 0x47800000], np.uint32), (rows, lw // 2))
    return np.random.default_rng(seed).integers(0, 1 << 32, (rows, lw), dtype=np.uint64).astype(
        np.uint32)


def _jax_split_f32(w, n):
    """The JAX package's f32 split of the first n words of w: exponent,
    low-u16 and high bytes (zero past n), the exponent histogram of the
    first n words and their folded XOR checksum, as numpy."""
    wz = w.copy()
    wz[n:] = 0
    comp, (lo, hi) = _jsplit(jnp.asarray(wz), F32)
    comp = np.asarray(comp)
    cks = int(np.bitwise_xor.reduce(wz[:n].view(np.uint8))) if n else 0
    return comp, np.asarray(lo), np.asarray(hi), np.bincount(comp[:n], minlength=256), cks


def _check_member(out, m, w, n, ck):
    """Member m of split_words_f32_batched_plain's output against the JAX
    split of w at length n (the checksum 0 without `ck`)."""
    exp32, lo32, hi32, hist, cks = out
    comp, lo, hi, jhist, jcks = _jax_split_f32(w, n)
    msg = f"member {m} (n = {n})"
    np.testing.assert_array_equal(exp32[m].numpy().view(np.uint8), comp, err_msg=msg)
    np.testing.assert_array_equal(lo32[m].numpy().view(np.uint16), lo, err_msg=msg)
    np.testing.assert_array_equal(hi32[m].numpy().view(np.uint8), hi, err_msg=msg)
    np.testing.assert_array_equal(hist[m].numpy(), jhist, err_msg=msg)
    assert int(np.uint32(int(cks[m]) & 0xFFFFFFFF)) == (jcks if ck else 0), msg


@pytest.mark.parametrize("ck", [False, True])
@pytest.mark.parametrize("n", SPLIT_EDGES)
@pytest.mark.parametrize("kind", FILLS)
def test_f32_split_plain_matches_jax_at_edge_lengths(kind, n, ck):
    """One member at each edge length, with and without the checksum."""
    w = _fill(kind, 1, 200 + n)
    out = cuda_float.split_words_f32_batched_plain(interop.words_from_numpy(w), n, ck)
    _check_member(out, 0, w[0], n, ck)


@pytest.mark.parametrize("kind", FILLS)
def test_f32_split_plain_ragged_batch_matches_jax(kind):
    """The edge lengths as one ragged batch."""
    w = _fill(kind, len(SPLIT_EDGES), 300)
    out = cuda_float.split_words_f32_batched_plain(interop.words_from_numpy(w), SPLIT_EDGES, True)
    for m, n in enumerate(SPLIT_EDGES):
        _check_member(out, m, w[m], n, True)


@pytest.mark.parametrize("kind", FILLS)
def test_f32_split_plain_into_strided_container_rows(kind):
    """Container mode into rows that start 8 bytes past a 16-byte boundary,
    prefilled with -1: each member's archived low plane, then its archived
    high plane, equal the JAX split's; every word past them, and before
    the row's start, keeps its -1."""
    B = len(SPLIT_EDGES)
    w = _fill(kind, B, 400)
    wide = torch.full((B, 3 * SPLIT_LW // 4 + 8), -1, dtype=torch.int32)
    exp32, lo32, hi32, hist, cks = cuda_float.split_words_f32_batched_plain(
        interop.words_from_numpy(w), SPLIT_EDGES, True, wide[:, 2 : 2 + 3 * SPLIT_LW // 4])
    assert lo32.data_ptr() == hi32.data_ptr() == wide[:, 2:].data_ptr()
    for m, n in enumerate(SPLIT_EDGES):
        comp, lo, hi, jhist, jcks = _jax_split_f32(w[m], n)
        k, h = C.round_up(n, 8) // 2, C.round_up(n, 16) // 4
        row = wide[m].numpy()
        np.testing.assert_array_equal(row[2 : 2 + k].view(np.uint16), lo[: 2 * k])
        np.testing.assert_array_equal(row[2 + k : 2 + k + h].view(np.uint8), hi[: 4 * h])
        assert (row[:2] == -1).all() and (row[2 + k + h :] == -1).all(), f"n = {n}"
        np.testing.assert_array_equal(exp32[m].numpy().view(np.uint8), comp)
        np.testing.assert_array_equal(hist[m].numpy(), jhist)
        assert int(np.uint32(int(cks[m]) & 0xFFFFFFFF)) == jcks


@pytest.mark.parametrize("kind", ["uniform", "alternating"])
def test_f32_split_plain_matches_pallas_interpret_at_risky_words(interpret_pallas, kind):
    """split_words_pallas_f32 on the same words, zero past n, with its
    padded tile and the words past n taken out of bin 0."""
    from dietgpu_tpu.floatcodec import pallas_float as pf

    Lw, n = 4096, 4093
    w = _fill(kind, 1, 500, Lw)[0]
    w[n:] = 0
    pexp, plo, phi, phist, pcks = pf.split_words_pallas_f32(jnp.asarray(w), with_cksum=True)
    exp32, lo32, hi32, hist, cks = cuda_float.split_words_f32_plain(
        interop.words_from_numpy(w), n, True)
    for got, want, k in ((exp32, pexp, Lw // 4), (lo32, plo, Lw // 2), (hi32, phi, Lw // 4)):
        np.testing.assert_array_equal(
            interop.words_to_numpy(got), np.asarray(want)[:k].view(np.uint32)
        )
    want = np.asarray(phist).astype(np.int64)
    want[0] -= pf.split_total_words_f32(Lw) - n
    np.testing.assert_array_equal(hist.numpy(), want)
    assert int(cks) == int(pcks)


def _same(got, want):
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _container_same(words, lengths, ck):
    """The kernel and the plain version into strided rows prefilled with -1:
    the same outputs and the same rows, words past the archived ends
    included."""
    B, W = words.shape
    wide = torch.full((B, 3 * W // 4 + 8), -1, dtype=torch.int32, device=words.device)
    plain = wide.clone()
    rows = slice(2, 2 + 3 * W // 4)
    got = cuda_float.split_words_f32_batched_cuda(words, lengths, ck, wide[:, rows])
    want = cuda_float.split_words_f32_batched_plain(words, lengths, ck, plain[:, rows])
    _same([got[i] for i in (0, 3, 4)], [want[i] for i in (0, 3, 4)])
    assert torch.equal(wide, plain)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", FILLS)
def test_f32_split_kernel_on_card_at_risky_words(cuda_device, kind):
    """Constant, alternating and uniform words at each edge length alone
    and as one ragged batch, with and without the checksum, one launch a
    call, and in container mode into strided rows."""
    w = interop.words_from_numpy(_fill(kind, len(SPLIT_EDGES), 600), cuda_device)
    for ck in (False, True):
        for n in SPLIT_EDGES:
            _same(cuda_float.split_words_f32_batched_cuda(w[:1], n, ck),
                  cuda_float.split_words_f32_batched_plain(w[:1], n, ck))
        _build.reset_kernel_launches()
        got = cuda_float.split_words_f32_batched_cuda(w, SPLIT_EDGES, ck)
        assert _build.kernel_launches()["split_f32"] == 1
        _same(got, cuda_float.split_words_f32_batched_plain(w, SPLIT_EDGES, ck))
        _container_same(w, SPLIT_EDGES, ck)


@pytest.mark.gpu
def test_f32_split_kernel_on_card_many_members(cuda_device):
    """513 ragged members (more than one round of the kernel's member
    scan), many empty or short, and 37 members of up to 64 blocks whose
    quads cross the CTAs' shares; plain rows and container rows."""
    rng = np.random.default_rng(14)
    for B, blocks in ((513, 2), (37, 64)):
        lw = blocks * C.DEFAULT_BLOCK_SIZE
        lens = rng.integers(0, lw + 1, B)
        lens[rng.random(B) < 0.2] = 0
        lens = lens.tolist()
        w = interop.words_from_numpy(_fill("uniform", B, B, lw), cuda_device)
        _same(cuda_float.split_words_f32_batched_cuda(w, lens, True),
              cuda_float.split_words_f32_batched_plain(w, lens, True))
        _container_same(w, lens, True)
