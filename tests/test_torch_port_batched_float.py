"""The PyTorch port's batched float codec against the JAX package (CPU).

``float_compress_batched`` (the plain versions of the batched split and
split_f32, the per-member-table encode and the batched assembly) and
``float_decompress_batched`` (the plain version of the per-member-table
fused decode) are held member by member against the JAX package's
single-tensor XLA codec (``dietgpu_tpu.floatcodec.codec``) and the NumPy
oracle (``dietgpu_tpu.ref.float_ref``), for f16, bf16 and f32 at pb
9/10/11, and once against the JAX batched Pallas codec in interpret mode.
Member sizes may be ragged on decode; a lying header or a corrupted plane
in one member fails only that member. Tolerance 0 throughout.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dietgpu_tpu.floatcodec import codec as jcodec
from dietgpu_tpu.ref import float_ref

import dietgpu_tpu_torch as port
from dietgpu_tpu_torch import _build, interop
from dietgpu_tpu_torch import constants as C
from dietgpu_tpu_torch.ans import cuda_decode
from dietgpu_tpu_torch.floatcodec import codec, cuda_float
from torch_port_helpers import cuda_device, interpret_pallas  # noqa: F401

LW = 2 * C.DEFAULT_BLOCK_SIZE  # one padded shape keeps JAX's compiles few
F16, BF16, F32 = C.FLOAT_TYPE_FLOAT16, C.FLOAT_TYPE_BFLOAT16, C.FLOAT_TYPE_FLOAT32
TYPES = [F16, BF16, F32]

_jcomp = jax.jit(jcodec.float_compress_padded, static_argnums=(2, 3, 4))
_jdec = jax.jit(jcodec.float_decompress_padded, static_argnums=(1, 2, 3, 4))


def _words(seed, ft, lengths, lw=LW):
    """(B, lw) words, member m of scale m + 1 (its own exponent table), zero
    past its length: uint16 for f16/bf16, uint32 for f32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((len(lengths), lw)).astype(np.float32)
    x *= np.arange(1, len(lengths) + 1, dtype=np.float32)[:, None] ** 3
    if ft == BF16:
        w = (x.view(np.uint32) >> 16).astype(np.uint16)
    elif ft == F16:
        w = x.astype(np.float16).view(np.uint16)
    else:
        w = x.view(np.uint32).copy()
    for m, n in enumerate(lengths):
        w[m, n:] = 0
    return w


def _out_words(res, ft):
    """The decoded (B, Lw) words as numpy, uint16 or uint32."""
    out = interop.words_to_numpy(res["out32"])
    return out if ft == F32 else out.view(np.uint16)


def _container_stride(ft, lw=LW):
    return codec.float_archive_buffer_bytes(ft, lw) // 4


@pytest.mark.parametrize("ft", TYPES)
def test_split_batched_matches_oracle(ft):
    """The batched split's planes, histograms and checksums, row by row
    against the oracle's split and the port's single split."""
    n = LW - 1237
    w = _words(1, ft, [n] * 3)
    t = interop.words_from_numpy(w if ft == F32 else w.view(np.uint32))
    if ft == F32:
        exp32, lo32, hi32, hist, cks = cuda_float.split_words_f32_batched_plain(t, n, True)
    else:
        exp32, nc32, hist, cks = cuda_float.split_words_batched_plain(t, n, ft, True)
    for m in range(3):
        comp, plane = float_ref.float_split(w[m, :n], ft)
        np.testing.assert_array_equal(exp32[m].view(torch.uint8).numpy()[:n], comp)
        np.testing.assert_array_equal(hist[m].numpy(), np.bincount(comp, minlength=256))
        if ft == F32:
            single = cuda_float.split_words_f32_plain(t[m], n, True)
            got = (exp32[m], lo32[m], hi32[m], hist[m], cks[m])
        else:
            single = cuda_float.split_words_plain(t[m], n, ft, True)
            got = (exp32[m], nc32[m], hist[m], cks[m])
        for a, b in zip(got, single):
            assert torch.equal(a, b)


@pytest.mark.parametrize("pb", C.SUPPORTED_PROB_BITS)
@pytest.mark.parametrize("ft", TYPES)
def test_float_compress_batched_matches_jax_per_member(ft, pb):
    """Each member's container equals the JAX XLA codec's and the oracle's
    archive; the batch decodes in the port and each row in JAX."""
    for n in (LW - 1237, LW):
        w = _words(10 * ft + pb, ft, [n] * 3)
        t = interop.words_from_numpy(w)
        for ck in (False, True):
            arcs, sizes = port.float_compress_batched(t, n, ft, pb, ck)
            assert arcs.shape == (3, _container_stride(ft))
            got = interop.archives_batch_to_numpy(arcs, sizes)
            for m in range(3):
                jarc, jsize = _jcomp(jnp.asarray(w[m]), n, ft, pb, ck)
                np.testing.assert_array_equal(got[m], np.asarray(jarc)[: int(jsize)],
                                              err_msg=f"member {m}")
                np.testing.assert_array_equal(
                    got[m], float_ref.float_compress(w[m, :n], ft, pb, ck), err_msg=f"member {m}"
                )
                jres = _jdec(jnp.asarray(interop.archive_to_numpy(arcs[m])), ft, LW, pb, ck)
                assert bool(jres["success"]) and bool(jres["checksum_ok"])
                np.testing.assert_array_equal(np.asarray(jres["out"]), w[m])
            res = port.float_decompress_batched(arcs, ft, LW, pb, ck, static_length=n)
            assert res["success"].all() and res["checksum_ok"].all()
            assert res["size"].tolist() == [n] * 3
            np.testing.assert_array_equal(_out_words(res, ft), w)


@pytest.mark.parametrize("ft", TYPES)
def test_compress_batched_input_layouts_agree(ft):
    """Word pairs and 16-bit words (f16/bf16), int32 words and float32
    values (f32): the same archives; a length of 0 too."""
    w = _words(2, ft, [LW] * 2)
    if ft == F32:
        layouts = [torch.from_numpy(w.view(np.int32)), torch.from_numpy(w.view(np.float32))]
    else:
        layouts = [torch.from_numpy(w.view(np.int16)), torch.from_numpy(w.view(np.int32))]
    for n in (0, 4097):
        (a, s), (b, t) = (port.float_compress_batched(x, n, ft) for x in layouts)
        assert torch.equal(s, t)
        for x, y in zip(interop.archives_batch_to_numpy(a, s), interop.archives_batch_to_numpy(b, t)):
            np.testing.assert_array_equal(x, y)
        jarc, jsize = _jcomp(jnp.asarray(np.where(np.arange(LW) < n, w[0], 0).astype(w.dtype)),
                             n, ft, 10, False)
        np.testing.assert_array_equal(interop.archives_batch_to_numpy(a, s)[0],
                                      np.asarray(jarc)[: int(jsize)])


@pytest.mark.parametrize("ft", TYPES)
def test_decompress_batched_ragged_jax_archives(ft):
    """JAX containers of ragged word counts, laid out at the port's member
    stride, decode in one batch; each member is exact and zero past its
    count, and each size comes from its own header."""
    lengths = [LW, LW - 1237, 17]
    w = _words(3 + ft, ft, lengths)
    jarcs = []
    for m, n in enumerate(lengths):
        jarc, jsize = _jcomp(jnp.asarray(w[m]), n, ft, 10, True)
        jarcs.append(np.asarray(jarc)[: int(jsize)])
    arcs = interop.archives_batch_from_numpy(jarcs, _container_stride(ft))
    res = port.float_decompress_batched(arcs, ft, LW, 10, verify_checksum=True)
    assert res["success"].all() and res["checksum_ok"].all()
    assert res["size"].tolist() == lengths
    np.testing.assert_array_equal(_out_words(res, ft), w)
    # a static length every member must hold: only member 1 does
    res = port.float_decompress_batched(arcs, ft, LW, 10, static_length=lengths[1])
    assert res["success"].tolist() == [False, True, False]
    np.testing.assert_array_equal(_out_words(res, ft)[1], w[1])


@pytest.mark.parametrize("ft", [BF16, F32])
def test_decompress_batched_member_faults_stay_in_their_member(ft):
    n = LW - 100
    w = _words(4, ft, [n] * 3)
    arcs, _ = port.float_compress_batched(interop.words_from_numpy(w), n, ft, 10, True)

    def decode(a):
        return port.float_decompress_batched(a, ft, LW, 10, verify_checksum=True)

    # member 0's header claims another word count: only it fails
    bad = arcs.clone()
    bad[0, 1] += 4096
    res = decode(bad)
    assert res["success"].tolist() == [False, True, True]
    np.testing.assert_array_equal(_out_words(res, ft)[1:], w[1:])
    # member 0's header claims more words than the capacity
    bad = arcs.clone()
    bad[0, 1] = LW + 1
    assert decode(bad)["success"].tolist() == [False, True, True]
    # a corrupted raw-plane byte of member 1 decodes and fails only its
    # checksum
    bad = arcs.clone()
    bad[1, 4 + 100] ^= 0x01000000
    res = decode(bad)
    assert res["success"].all()
    assert res["checksum_ok"].tolist() == [True, False, True]
    np.testing.assert_array_equal(_out_words(res, ft)[[0, 2]], w[[0, 2]])
    # the JAX decoder agrees on that member
    jres = _jdec(jnp.asarray(interop.archive_to_numpy(bad[1])), ft, LW, 10, True)
    assert bool(jres["success"]) and not bool(jres["checksum_ok"])


def test_batched_float_entry_points_reject_bad_input():
    w = torch.zeros((2, LW), dtype=torch.int16)
    with pytest.raises(ValueError):
        port.float_compress_batched(w, [LW], BF16)  # one length per member
    with pytest.raises(ValueError):
        port.float_compress_batched(w, LW + 1, BF16)
    with pytest.raises(ValueError):
        port.float_compress_batched(w[0], LW, BF16)
    with pytest.raises(ValueError):
        port.float_compress_batched(w, LW, 7)
    with pytest.raises(ValueError):
        port.float_decompress_batched(torch.zeros(64, dtype=torch.int32), BF16, LW)


def test_batched_matches_pallas_interpret(interpret_pallas):
    """The JAX batched Pallas codec in interpret mode, at the smallest shape
    that crosses a member boundary: two bf16 members of one block."""
    from dietgpu_tpu.floatcodec import pallas_codec as pfc

    lw = C.DEFAULT_BLOCK_SIZE
    n = lw - 5
    w = _words(5, BF16, [n] * 2, lw)
    pairs = w.view(np.uint32)
    jarcs, jsizes = pfc.float_compress_batched_pallas(jnp.asarray(pairs), n, BF16, 10)
    arcs, sizes = port.float_compress_batched(interop.words_from_numpy(pairs), n, BF16)
    assert sizes.tolist() == np.asarray(jsizes).tolist()
    jarcs = np.asarray(jarcs)
    for m, a in enumerate(interop.archives_batch_to_numpy(arcs, sizes)):
        np.testing.assert_array_equal(a, jarcs[m].view(np.uint8)[: a.size], err_msg=f"member {m}")
    # JAX's batched decode on its own stride, the port's on its own
    jres = pfc.float_decompress_batched_pallas(jnp.asarray(jarcs), BF16, lw, 10, static_length=n)
    res = port.float_decompress_batched(arcs, BF16, lw, 10, static_length=n)
    assert np.asarray(jres["success"]).all() and res["success"].all()
    jout = np.asarray(jres["out32"]).view(np.uint16)
    np.testing.assert_array_equal(_out_words(res, BF16)[:, :n], jout[:, :n])
    np.testing.assert_array_equal(_out_words(res, BF16), w)


@pytest.mark.gpu
@pytest.mark.parametrize("ft", TYPES)
def test_batched_float_kernels_on_card_match_plain(cuda_device, ft):
    """The split (or split_f32), encode, assembly and decode (or decode_f32)
    kernels on batches against their plain versions, at B = 1, a one-block
    batch and a ragged length, each launched once per call."""
    split_k = "split_f32" if ft == F32 else "split"
    dec_k = "decode_f32" if ft == F32 else "decode"
    for B, lw, n in ((1, LW, LW), (3, C.DEFAULT_BLOCK_SIZE, 17), (5, 4 * LW, 4 * LW - 12345)):
        w = interop.words_from_numpy(_words(B + ft, ft, [n] * B, lw)).to(cuda_device)
        for ck in (False, True):
            _build.reset_kernel_launches()
            ka, ks = port.float_compress_batched(w, n, ft, 10, ck)
            counts = _build.kernel_launches()
            assert [counts[k] for k in (split_k, "encode", "assembly")] == [1, 1, 1]
            pa, ps = codec.float_compress_batched_plain(w, n, ft, 10, ck)
            assert torch.equal(ks, ps)
            for m in range(B):
                n32 = int(ks[m]) // 4
                assert torch.equal(ka[m, :n32], pa[m, :n32])
            for digest in (False, True):
                snb = cuda_decode.static_block_count(n, lw)
                got = cuda_decode.decode_float_batched_cuda(ka, ft, lw, 10, n, digest, snb)
                want = cuda_decode.decode_float_batched_plain(ka, ft, lw, 10, n, digest, snb)
                for a, b in zip(got, want):
                    assert torch.equal(a.to(torch.int64), b.to(torch.int64))
            _build.reset_kernel_launches()
            res = port.float_decompress_batched(ka, ft, lw, 10, ck, static_length=n)
            assert _build.kernel_launches()[dec_k] == 1
            assert res["success"].all() and res["checksum_ok"].all()
            assert torch.equal(res["out32"].reshape(B, -1).view(torch.int32).cpu(),
                               w.reshape(B, -1).view(torch.int32).cpu())
