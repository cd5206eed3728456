"""The PyTorch port's raw-ANS byte codec against the JAX package (CPU).

The port's ``histogram_u8`` (the plain version of the histogram kernel,
with its fused checksum) against ``dietgpu_tpu.ans.stats`` and the Pallas
histogram in interpret mode; ``ans_encode_padded`` computing its own
histogram, with and without the checksum, against the JAX XLA encoder; and
``ans_decode_padded`` (the plain version of the decode kernel's raw-byte
configuration) on JAX archives and the golden fixtures, both ways, with
its status flags. Tolerance 0 throughout.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dietgpu_tpu.ans import checksum as jchecksum
from dietgpu_tpu.ans import decode as jdecode
from dietgpu_tpu.ans import encode as jencode
from dietgpu_tpu.ans import stats as jstats

import dietgpu_tpu_torch as port
from dietgpu_tpu_torch import constants as C
from dietgpu_tpu_torch import interop
from dietgpu_tpu_torch.ans import cuda_decode, cuda_hist, layout
from torch_port_helpers import cuda_device, interpret_pallas  # noqa: F401

L = 16384  # one padded shape keeps JAX's compiles few
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")

_enc_jit = jax.jit(jencode.ans_encode_padded, static_argnums=(2, 3))
_dec_jit = jax.jit(jdecode.ans_decode_padded, static_argnums=(1, 2, 3))
_hist_jit = jax.jit(jstats.histogram_u8)
_cks_jit = jax.jit(jchecksum.checksum_u8)


def _data(rng, n, lam=12.0, size=L):
    d = np.zeros(size, np.uint8)
    d[:n] = np.minimum(rng.exponential(lam, n), 255).astype(np.uint8)
    return d


def _decode(arc_u8, pb, out_max=L, verify=False):
    return port.ans_decode_padded(interop.archive_from_numpy(arc_u8), pb, out_max, verify)


@pytest.mark.parametrize("n", [0, 1, 1001, 4099, L - 1, L])
def test_histogram_matches_jax(n):
    """Counts and checksum of lengths that end inside a u32 word, over a
    tail of other bytes the histogram must not count."""
    d = np.random.default_rng(n).integers(0, 256, L, dtype=np.uint8)
    d[: n // 2] = 7  # a long run of one value
    want_h = np.asarray(_hist_jit(jnp.asarray(d), n))
    want_c = int(_cks_jit(jnp.asarray(d), n))
    for data in (torch.from_numpy(d), torch.from_numpy(d.view(np.int32).copy())):
        hist, cks = port.histogram_u8(data, n, with_checksum=True)
        assert hist.dtype == torch.int32
        np.testing.assert_array_equal(hist.numpy(), want_h)
        assert int(cks) == want_c
        assert torch.equal(port.histogram_u8(data, n), hist)
    # a byte count that is not a multiple of 16
    hist, cks = port.histogram_u8(torch.from_numpy(d[: L - 3]), min(n, L - 3), True)
    np.testing.assert_array_equal(hist.numpy(), np.bincount(d[: min(n, L - 3)], minlength=256))


def _adversarial_bytes(name):
    """Inputs a per-thread 8-bit counter or a replicated histogram gets
    wrong: one value in every byte (a bin past 2^16 counts), two values
    alternating, and every byte value exactly once."""
    if name == "all_00":
        return np.zeros(70001, np.uint8)
    if name == "all_ff":
        return np.full(70001, 0xFF, np.uint8)
    if name == "alternating":
        return np.tile(np.array([0x3C, 0xC3], np.uint8), 40000)
    return np.random.default_rng(55).permutation(256).astype(np.uint8)


@pytest.mark.parametrize("name", ["all_00", "all_ff", "alternating", "each_once"])
def test_histogram_adversarial_matches_jax(name):
    d = _adversarial_bytes(name)
    for n in (d.size, d.size - 5):
        want_h = np.asarray(_hist_jit(jnp.asarray(d), n))
        want_c = int(_cks_jit(jnp.asarray(d), n))
        hist, cks = port.histogram_u8(torch.from_numpy(d), n, with_checksum=True)
        np.testing.assert_array_equal(hist.numpy(), want_h)
        assert int(cks) == want_c
    if name.startswith("all_"):
        assert want_h.max() > 1 << 16
    if name == "each_once":
        assert (np.asarray(_hist_jit(jnp.asarray(d), d.size)) == 1).all()


def test_histogram_rejects_bad_input():
    d = torch.zeros(64, dtype=torch.uint8)
    with pytest.raises(ValueError):
        port.histogram_u8(d, 65)
    with pytest.raises(ValueError):
        port.histogram_u8(d.view(torch.int16), 4)
    with pytest.raises(ValueError):  # past the bytes, though inside the padding
        port.histogram_u8(d[:12].view(torch.int32), 13)
    with pytest.raises(ValueError):
        cuda_hist.histogram_u8_plain(d.view(torch.int32), 65)


@pytest.mark.parametrize("n", [1, 1000, 530000])
def test_histogram_matches_pallas_interpret(interpret_pallas, n):
    """As tests/test_pallas.py runs the Pallas histogram: a garbage tail."""
    from dietgpu_tpu.ans import pallas_hist as ph

    buf = C.round_up(n, 4)
    data = np.zeros(buf, np.uint8)
    data[:n] = np.minimum(np.random.default_rng(n).exponential(20, n), 255)
    data[n:] = 0xAB
    h, c = ph.histogram_u8_pallas(jnp.asarray(data.view("<u4")), n, with_checksum=True)
    hist, cks = port.histogram_u8(torch.from_numpy(data), n, with_checksum=True)
    np.testing.assert_array_equal(hist.numpy(), np.asarray(h))
    assert int(cks) == int(c)


@pytest.mark.parametrize("ck", [False, True])
@pytest.mark.parametrize("pb", C.SUPPORTED_PROB_BITS)
def test_encode_own_histogram_matches_jax_both_ways(pb, ck):
    n = 3 * 4096 + 17
    data = _data(np.random.default_rng(10 * pb + ck), n)
    arc32, size = port.ans_encode_padded(torch.from_numpy(data), n, pb, ck)
    size = int(size)
    arc = interop.archive_to_numpy(arc32)
    jarc, jsize = _enc_jit(jnp.asarray(data), n, pb, ck)
    jarc = np.asarray(jarc)
    assert size == int(jsize)
    np.testing.assert_array_equal(arc[:size], jarc[:size])
    # packed int32 input gives the same archive
    a32, s32 = port.ans_encode_padded(torch.from_numpy(data.view(np.int32).copy()), n, pb, ck)
    assert int(s32) == size and torch.equal(a32[: size // 4], arc32[: size // 4])

    # JAX archive -> port decoder, as bytes and as u32 words
    for a in (jarc[:size], jarc[:size].view("<u4")):
        res = port.ans_decode_padded(
            interop.archive_from_numpy(a) if a.dtype == np.uint32 else torch.from_numpy(a.copy()),
            pb, L, ck,
        )
        assert bool(res["success"]) and bool(res["checksum_ok"]) and int(res["size"]) == n
        np.testing.assert_array_equal(res["out"].numpy(), data)
    # port archive -> JAX decoder
    jres = _dec_jit(jnp.asarray(arc), pb, L, ck)
    assert bool(jres["success"]) and bool(jres["checksum_ok"]) and int(jres["size"]) == n
    np.testing.assert_array_equal(np.asarray(jres["out"]), data)


def test_precomputed_histogram_matches_jax():
    rng = np.random.default_rng(6)
    n = 7000
    data = _data(rng, n)
    other = _data(rng, L, 30.0)  # the table comes from other data
    h = np.bincount(other, minlength=256).astype(np.uint32)
    jarc, jsize = jax.jit(jencode.ans_encode_padded, static_argnums=(2, 3))(
        jnp.asarray(data), n, 10, True, jnp.asarray(h)
    )
    arc32, size = port.ans_encode_padded(
        torch.from_numpy(data), n, 10, True, precomputed_histogram=torch.from_numpy(h.astype(np.int64))
    )
    assert int(size) == int(jsize)
    np.testing.assert_array_equal(
        interop.archive_to_numpy(arc32, int(size)), np.asarray(jarc)[: int(size)]
    )


@pytest.mark.parametrize(
    "name,n,pb,ck",
    [
        ("ans_empty.bin", 0, 10, False),
        ("ans_1byte.bin", 1, 10, False),
        ("ans_4096.bin", 4096, 10, False),
        ("ans_4097.bin", 4097, 10, False),
        ("ans_pb9.bin", 10000, 9, False),
        ("ans_pb11.bin", 10000, 11, False),
        ("ans_checksum.bin", 5000, 10, True),
    ],
)
def test_golden_ans_fixtures_through_entry_points(name, n, pb, ck):
    """Decode the golden archives with the raw-ANS entry point and encode
    their inputs back to the same bytes, the histogram computed by the
    port."""
    gold = np.fromfile(os.path.join(FIXTURES, name), np.uint8)
    if name == "ans_1byte.bin":
        data = np.array([0xA5], np.uint8)
    else:
        rng = np.random.default_rng(0x60D)
        data = np.minimum(rng.exponential(20.0, n), 255).astype(np.uint8)
    res = _decode(gold, pb, verify=True)
    assert bool(res["success"]) and bool(res["checksum_ok"]) and int(res["size"]) == n
    np.testing.assert_array_equal(res["out"].numpy()[:n], data)
    assert not res["out"].numpy()[n:].any()
    padded = np.zeros(L, np.uint8)
    padded[:n] = data
    arc32, size = port.ans_encode_padded(torch.from_numpy(padded), n, pb, ck)
    assert int(size) == gold.size
    np.testing.assert_array_equal(interop.archive_to_numpy(arc32, int(size)), gold)


def test_checksum_mismatch_and_lying_header():
    rng = np.random.default_rng(9)
    n = 9000
    data = _data(rng, n, 15.0)
    arc32, size = port.ans_encode_padded(torch.from_numpy(data), n, 10, True)
    arc = interop.archive_to_numpy(arc32, int(size))
    # a lane's final state: decodes, to other bytes, and fails the checksum
    bad = arc.copy()
    bad[32 + 512 + 4 * 5 + 1] ^= 0x10
    res = _decode(bad, 10, verify=True)
    jres = _dec_jit(jnp.asarray(bad), 10, L, True)
    assert bool(res["success"]) and bool(jres["success"])
    assert bool(res["checksum_ok"]) == bool(jres["checksum_ok"]) is False
    # without verify_checksum the flag stays true
    assert bool(_decode(bad, 10)["checksum_ok"])
    # capacity, prob_bits and magic failures agree with JAX
    for a, pb, out_max in ((arc, 10, C.DEFAULT_BLOCK_SIZE), (arc, 9, L)):
        res = _decode(a, pb, out_max)
        jres = _dec_jit(jnp.asarray(a), pb, out_max, False)
        assert not bool(res["success"]) and not bool(jres["success"])
        assert int(res["size"]) == int(jres["size"]) == n
    bad = arc.copy()
    bad[0] ^= 1
    assert not bool(_decode(bad, 10)["success"])
    # a header that claims more blocks than the buffer holds: no IndexError,
    # and the output agrees with the JAX decoder's
    bad = arc.copy()
    bad[4:8] = np.frombuffer(np.uint32(0xFFFF).tobytes(), np.uint8)
    res = _decode(bad, 10)
    jres = _dec_jit(jnp.asarray(bad), 10, L, False)
    assert bool(res["success"]) == bool(jres["success"])
    np.testing.assert_array_equal(res["out"].numpy(), np.asarray(jres["out"]))
    # a truncated archive fails
    assert not bool(_decode(arc[:16], 10)["success"])


def test_decode_raw_plain_digest_equals_stored_checksum():
    n = 12345
    data = _data(np.random.default_rng(8), n)
    arc32, _ = port.ans_encode_padded(torch.from_numpy(data), n, 10, True)
    out32, ok, size, digest = cuda_decode.decode_raw_plain(arc32, 10, L, True)
    assert bool(ok) and int(size) == n
    assert int(digest) == int(layout.to_u32(arc32[5]))
    assert torch.equal(layout.u32_to_u8le(out32), torch.from_numpy(data))


@pytest.mark.gpu
def test_hist_kernel_matches_plain(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(5)
    data32 = torch.randint(-(2**31), 2**31, (1 << 16,), dtype=torch.int32,
                           device=cuda_device, generator=g)
    for n in (4 << 16, (4 << 16) - 3, 1001, 1, 0):
        for ck in (False, True):
            got = [x[0] for x in cuda_hist.histogram_u8_batched_cuda(data32[None], [n], ck)]
            want = cuda_hist.histogram_u8_plain(data32, n, ck)
            for a, b in zip(got, want):
                assert torch.equal(a, b)


@pytest.mark.gpu
def test_hist_kernel_adversarial_on_card(cuda_device):
    """The inputs of test_histogram_adversarial_matches_jax, at 2^24 bytes
    for the constant ones, kernel against plain version, tolerance 0."""
    n = 1 << 24
    inputs = [torch.zeros(n, dtype=torch.uint8), torch.full((n,), 0xFF, dtype=torch.uint8)]
    inputs += [torch.from_numpy(_adversarial_bytes(k)) for k in ("alternating", "each_once")]
    for d in inputs:
        pad = (-d.numel()) % 16
        d32 = layout.u8_to_u32le(torch.cat([d, d.new_zeros(pad)]))
        for length in (d.numel(), d.numel() - 5):
            want = cuda_hist.histogram_u8_plain(d32, length, True)
            got = [x[0] for x in cuda_hist.histogram_u8_batched_cuda(
                d32.to(cuda_device)[None], [length], True)]
            for a, b in zip(got, want):
                assert torch.equal(a.cpu(), b)


@pytest.mark.gpu
def test_raw_ans_on_card_matches_cpu(cuda_device):
    n = 3 * 4096 + 17
    data = torch.from_numpy(_data(np.random.default_rng(12), n))
    for pb in C.SUPPORTED_PROB_BITS:
        for ck in (False, True):
            ka, ks = port.ans_encode_padded(data.to(cuda_device), n, pb, ck)
            pa, ps = port.ans_encode_padded(data, n, pb, ck)
            assert int(ks) == int(ps)
            assert torch.equal(ka[: int(ks) // 4].cpu(), pa[: int(ps) // 4])
            for digest in (False, True):
                got = [x[0] for x in cuda_decode.decode_raw_batched_cuda(ka[None], pb, L, None,
                                                                        digest)]
                want = cuda_decode.decode_raw_plain(ka, pb, L, digest)
                for a, b in zip(got, want):
                    assert torch.equal(a.cpu().to(torch.int64), b.cpu().to(torch.int64))
            res = port.ans_decode_padded(ka, pb, L, ck)
            assert bool(res["success"]) and bool(res["checksum_ok"])
            assert torch.equal(res["out"].cpu(), data)
