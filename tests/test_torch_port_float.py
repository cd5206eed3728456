"""The PyTorch port's f16/bf16 float codec against the JAX package (CPU).

The slice as a whole: float_compress_padded / float_decompress_padded on
the CPU (the plain versions of the four kernels) must write the JAX XLA
codec's archive byte for byte, decode the JAX archives and the golden
fixtures, and be decoded by the JAX codec; once, the archive is also held
against the Pallas codec in interpret mode. Tolerance 0 throughout.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dietgpu_tpu.floatcodec import codec as jcodec

import dietgpu_tpu_torch as port
from dietgpu_tpu_torch import constants as C
from dietgpu_tpu_torch import interop
from dietgpu_tpu_torch.ans import cuda_decode
from dietgpu_tpu_torch.floatcodec import codec
from torch_port_helpers import cuda_device, interpret_pallas  # noqa: F401

LW = 16384  # one padded shape keeps JAX's compiles few
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
F16, BF16 = C.FLOAT_TYPE_FLOAT16, C.FLOAT_TYPE_BFLOAT16

_jcomp = jax.jit(jcodec.float_compress_padded, static_argnums=(2, 3, 4))
_jdec = jax.jit(jcodec.float_decompress_padded, static_argnums=(1, 2, 3, 4))


def _words(rng, n, ft, lw=LW):
    x = rng.standard_normal(lw).astype(np.float32) * 3.0
    if ft == BF16:
        w = (x.view(np.uint32) >> 16).astype(np.uint16)
    else:
        w = x.astype(np.float16).view(np.uint16)
    w[n:] = 0
    return w


def _decode_port(arc32, ft, lw=LW, verify=False, static_length=None):
    res = codec.float_decompress_padded(arc32, ft, lw, 10, verify, static_length)
    words = interop.words_to_numpy(res["out32"]).view(np.uint16)
    return res, words


@pytest.mark.parametrize("ck", [False, True])
@pytest.mark.parametrize("ft", [F16, BF16])
@pytest.mark.parametrize("n", [0, 1, 3000, 4096, 5000, 3 * 4096 + 17, LW])
def test_float_codec_matches_jax_both_ways(ft, ck, n):
    rng = np.random.default_rng(n + 10 * ft + ck)
    w = _words(rng, n, ft)
    arc32, size = codec.float_compress_padded(interop.words_from_numpy(w), n, ft, 10, ck)
    size = int(size)
    jarc, jsize = _jcomp(jnp.asarray(w), n, ft, 10, ck)
    jarc = np.asarray(jarc)
    assert size == int(jsize)
    np.testing.assert_array_equal(interop.archive_to_numpy(arc32, size), jarc[:size])

    # roundtrip through the port
    res, got = _decode_port(arc32, ft, verify=ck, static_length=n)
    assert bool(res["success"]) and bool(res["checksum_ok"]) and int(res["size"]) == n
    np.testing.assert_array_equal(got, w)
    # JAX archive -> port decoder
    res, got = _decode_port(interop.archive_from_numpy(jarc[:size]), ft, verify=ck)
    assert bool(res["success"]) and bool(res["checksum_ok"])
    np.testing.assert_array_equal(got, w)
    # port archive -> JAX decoder
    pbytes = interop.archive_to_numpy(arc32)
    jres = _jdec(jnp.asarray(pbytes), ft, LW, 10, ck)
    assert bool(jres["success"]) and bool(jres["checksum_ok"])
    np.testing.assert_array_equal(np.asarray(jres["out"]), w)


@pytest.mark.parametrize(
    "name,ft,ck",
    [("float_bf16.bin", BF16, False), ("float_bf16_checksum.bin", BF16, True),
     ("float_f16.bin", F16, False)],
)
def test_golden_float_fixtures(name, ft, ck):
    """Decode the golden archives and re-encode them to the same bytes."""
    gold = np.fromfile(os.path.join(FIXTURES, name), np.uint8)
    f = np.random.default_rng(0x60D).standard_normal(3000).astype(np.float32)
    if ft == BF16:
        w = (f.view(np.uint32) >> 16).astype(np.uint16)
    else:
        w = f.astype(np.float16).view(np.uint16)
    res, got = _decode_port(interop.archive_from_numpy(gold), ft, 4096, verify=True)
    assert bool(res["success"]) and bool(res["checksum_ok"])
    np.testing.assert_array_equal(got[:3000], w)
    assert not got[3000:].any()

    padded = np.zeros(4096, np.uint16)
    padded[:3000] = w
    arc32, size = codec.float_compress_padded(interop.words_from_numpy(padded), 3000, ft, 10, ck)
    assert int(size) == gold.size
    np.testing.assert_array_equal(interop.archive_to_numpy(arc32, int(size)), gold)


def test_word_pair_and_u16_inputs_agree():
    rng = np.random.default_rng(21)
    w = _words(rng, 5000, BF16)
    a16, s16 = codec.float_compress_padded(interop.words_from_numpy(w), 5000, BF16)
    a32, s32 = codec.float_compress_padded(
        interop.words_from_numpy(w.view(np.uint32)), 5000, BF16
    )
    assert int(s16) == int(s32)
    assert torch.equal(a16[: int(s16) // 4], a32[: int(s32) // 4])


def test_failures_static_length_header_and_payload():
    rng = np.random.default_rng(4)
    n = 5000
    w = _words(rng, n, BF16)
    arc32, size = codec.float_compress_padded(interop.words_from_numpy(w), n, BF16, 10, True)
    assert bool(_decode_port(arc32, BF16, static_length=n)[0]["success"])
    # static_length is a contract: any other length fails
    for sl in (n - 1, n + 1, LW):
        assert not bool(_decode_port(arc32, BF16, static_length=sl)[0]["success"])
    # wrong float type, wrong magic, word count beyond capacity or disagreeing
    # with the embedded ANS header: all fail, none indexes out of bounds
    for idx, val in ((2, F16 | 0x10), (0, 0x12345678), (1, LW + 1), (1, n + 16),
                     (1, 2**31 + 5), (1, 0)):
        bad = arc32.clone()
        bad[idx] = int(np.int32(np.uint32(val)))
        assert not bool(_decode_port(bad, BF16)[0]["success"]), (idx, val)
    # a truncated archive fails too
    assert not bool(_decode_port(arc32[:40].clone(), BF16)[0]["success"])
    # a corrupted nonComp byte decodes, and fails the checksum
    bad = arc32.clone()
    bad[4 + 7] ^= 0x00010000
    res, _ = _decode_port(bad, BF16, verify=True)
    assert bool(res["success"]) and not bool(res["checksum_ok"])
    jres = _jdec(jnp.asarray(interop.archive_to_numpy(bad)), BF16, LW, 10, True)
    assert not bool(jres["checksum_ok"])


def test_convenience_entry_points_cpu(monkeypatch):
    x = torch.randn(7001, generator=torch.Generator().manual_seed(2))
    for dtype in (torch.float16, torch.bfloat16):
        arc = port.float_compress(x.to(dtype), use_checksum=True, device="cpu")
        assert torch.equal(port.float_decompress(arc, device="cpu"), x.to(dtype))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        port.float_compress(x.to(torch.bfloat16))
    with pytest.raises(RuntimeError):
        port.float_decompress(arc)
    assert set(port.kernel_launches()) == {
        "split", "split_f32", "hist", "tables", "encode", "sections", "assembly", "decode",
        "decode_f32", "decode_raw", "join", "join_f32",
    }


def test_decode_plain_digest_equals_stored_checksum():
    rng = np.random.default_rng(8)
    w = _words(rng, 12345, F16)
    arc32, size = codec.float_compress_padded(interop.words_from_numpy(w), 12345, F16, 10, True)
    out32, ok, n, digest = cuda_decode.decode_float_plain(arc32, F16, LW, 10, 12345, True)
    assert bool(ok) and int(n) == 12345
    assert int(digest) == int(arc32[3])  # the stored word checksum


def test_archive_matches_pallas_codec_interpret(interpret_pallas):
    """The one place the Pallas path itself is the reference."""
    from dietgpu_tpu.floatcodec import pallas_codec as pfc

    n = 5000
    lw = C.round_up(n, C.DEFAULT_BLOCK_SIZE)
    w = _words(np.random.default_rng(0), n, BF16, lw)
    arc_p, size_p = pfc.float_compress_padded_pallas(jnp.asarray(w), n, BF16, 10, False)
    arc32, size = codec.float_compress_padded(interop.words_from_numpy(w), n, BF16)
    assert int(size) == int(size_p)
    want = interop.archive_to_numpy(interop.archive_from_numpy(np.asarray(arc_p)), int(size))
    np.testing.assert_array_equal(interop.archive_to_numpy(arc32, int(size)), want)
    # the port decodes the Pallas container as it is
    res, got = _decode_port(interop.archive_from_numpy(np.asarray(arc_p)), BF16, lw,
                            static_length=n)
    assert bool(res["success"])
    np.testing.assert_array_equal(got, w)


@pytest.mark.gpu
@pytest.mark.parametrize("ft", [F16, BF16])
def test_float_codec_on_card_matches_cpu(cuda_device, ft):
    rng = np.random.default_rng(30 + ft)
    n = 3 * 4096 + 17
    w = interop.words_from_numpy(_words(rng, n, ft))
    for ck in (False, True):
        ka, ks = codec.float_compress_padded(w.to(cuda_device), n, ft, 10, ck)
        pa, ps = codec.float_compress_padded(w, n, ft, 10, ck)
        assert int(ks) == int(ps)
        assert torch.equal(ka[: int(ks) // 4].cpu(), pa[: int(ps) // 4])
        for digest in (False, True):
            got = cuda_decode.decode_float(ka, ft, LW, 10, n, digest)
            want = cuda_decode.decode_float_plain(ka, ft, LW, 10, n, digest)
            for a, b in zip(got, want):
                assert torch.equal(a.cpu().to(torch.int64), b.cpu().to(torch.int64))
