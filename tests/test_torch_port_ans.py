"""The PyTorch port's rANS encoder and decoder against the JAX package (CPU).

The port's plain encode (the plain versions of the encode and assembly
kernels, with the section prefill between them) must give the JAX XLA
encoder's archive byte for byte, and each decoder must decode the other's
archives. Tolerance 0 throughout.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dietgpu_tpu import constants as JC
from dietgpu_tpu.ans import decode as jdecode
from dietgpu_tpu.ans import encode as jencode
from dietgpu_tpu.ref import ans_ref

from dietgpu_tpu_torch import constants as C
from dietgpu_tpu_torch import interop
from dietgpu_tpu_torch.ans import cuda_encode, layout, stats
from dietgpu_tpu_torch.ans import decode as pdecode
from dietgpu_tpu_torch.ans import encode as pencode
from torch_port_helpers import cuda_device  # noqa: F401

L = 16384  # one padded shape keeps JAX's compiles few
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")

_enc_jit = jax.jit(jencode.ans_encode_padded, static_argnums=(2, 3))
_dec_jit = jax.jit(jdecode.ans_decode_padded, static_argnums=(1, 2, 3))


def _data(rng, n, lam=12.0):
    d = np.zeros(L, np.uint8)
    d[:n] = np.minimum(rng.exponential(lam, n), 255).astype(np.uint8)
    return d


def _port_encode(data, n, pb, ck=False, pdf=None):
    arc32, size = cuda_encode.ans_encode_padded(
        torch.from_numpy(data), n, pb, ck,
        precomputed_pdf=None if pdf is None else interop.pdf_from_numpy(pdf),
    )
    return interop.archive_to_numpy(arc32), int(size)


def _port_decode(arc_u8, pb, out_max=L, verify=False):
    return pdecode.ans_decode_padded(
        interop.archive_from_numpy(arc_u8), pb, out_max, verify
    )


@pytest.mark.parametrize("pb", C.SUPPORTED_PROB_BITS)
@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 3 * 4096 + 17])
def test_plain_encode_matches_jax_and_decodes_both_ways(pb, n):
    rng = np.random.default_rng(n * 31 + pb)
    data = _data(rng, n)
    arc, size = _port_encode(data, n, pb)
    jarc, jsize = _enc_jit(jnp.asarray(data), n, pb, False)
    jarc = np.asarray(jarc)
    assert size == int(jsize)
    np.testing.assert_array_equal(arc[:size], jarc[:size])

    # JAX archive -> port decoder
    res = _port_decode(jarc[:size], pb)
    assert bool(res["success"]) and int(res["size"]) == n
    np.testing.assert_array_equal(res["out"].numpy()[:n], data[:n])
    assert not res["out"].numpy()[n:].any()
    # port archive -> JAX decoder
    jres = _dec_jit(jnp.asarray(arc), pb, L, False)
    assert bool(jres["success"]) and int(jres["size"]) == n
    np.testing.assert_array_equal(np.asarray(jres["out"]), res["out"].numpy())


def test_precomputed_pdf_crosses_both_ways():
    """A pdf shared across encoders (as the distributed layer shares one):
    quantized by the port and handed to JAX through interop, and back."""
    rng = np.random.default_rng(6)
    n = 7000
    data = _data(rng, n)
    other = _data(rng, L, 30.0)  # the pdf comes from other data
    hist = stats.histogram_u8(torch.from_numpy(other), L)
    pdf = stats.normalize_probs(hist, L, 10)
    pdf_np = interop.pdf_to_numpy(pdf)
    assert pdf_np.dtype == np.uint32
    jarc, jsize = jax.jit(jencode.ans_encode_padded_with_pdf, static_argnums=(2,))(
        jnp.asarray(data), n, 10, jnp.asarray(pdf_np)
    )
    arc, size = _port_encode(data, n, 10, pdf=np.asarray(pdf_np))
    assert size == int(jsize)
    np.testing.assert_array_equal(arc[:size], np.asarray(jarc)[:size])


def test_checksum_archive_matches_jax():
    rng = np.random.default_rng(5)
    n = 5000
    data = _data(rng, n)
    arc, size = _port_encode(data, n, 10, ck=True)
    jarc, jsize = _enc_jit(jnp.asarray(data), n, 10, True)
    assert size == int(jsize)
    np.testing.assert_array_equal(arc[:size], np.asarray(jarc)[:size])
    assert bool(_port_decode(arc, 10, verify=True)["checksum_ok"])
    bad = arc.copy()
    bad[32 + 512 + 4 * 5 + 1] ^= 0x10  # a lane's final state: decodes, to other bytes
    res = _port_decode(bad, 10, verify=True)
    jres = _dec_jit(jnp.asarray(bad), 10, L, True)
    assert bool(res["checksum_ok"]) == bool(jres["checksum_ok"]) is False


def _overflow_input():
    """64 KiB of zeros + one 4 KiB block of weight-1 symbols: at prob_bits
    11 the block needs ~2816 > 2560 words."""
    zeros = np.zeros(16 * C.DEFAULT_BLOCK_SIZE, np.uint8)
    rare = np.tile(np.arange(1, 256, dtype=np.uint8), 17)[: C.DEFAULT_BLOCK_SIZE]
    return np.concatenate([zeros, rare])


def test_size_overflow_bit_matches_jax():
    data = _overflow_input()
    n = data.size
    arc, size = cuda_encode.ans_encode_padded(torch.from_numpy(data), n, 11)
    jarc, jsize = jax.jit(jencode.ans_encode_padded, static_argnums=(2, 3))(
        jnp.asarray(data), n, 11, False
    )
    assert int(size) & C.SIZE_OVERFLOW_BIT
    assert int(size) == int(jsize)
    # at prob_bits 9 the same data fits, and the port decodes it
    arc, size = cuda_encode.ans_encode_padded(torch.from_numpy(data), n, 9)
    assert not int(size) & C.SIZE_OVERFLOW_BIT
    res = pdecode.ans_decode_padded(arc, 9, n)
    assert bool(res["success"])
    np.testing.assert_array_equal(res["out"].numpy(), data)


def test_capacity_failure_and_lying_header():
    rng = np.random.default_rng(9)
    data = _data(rng, 9000, 15.0)
    arc, size = _port_encode(data, 9000, 10)
    res = _port_decode(arc[:size], 10, out_max=C.DEFAULT_BLOCK_SIZE)
    jres = _dec_jit(jnp.asarray(arc[:size]), 10, C.DEFAULT_BLOCK_SIZE, False)
    assert not bool(res["success"]) and not bool(jres["success"])
    assert int(res["size"]) == int(jres["size"]) == 9000
    # prob_bits disagreeing with the archive
    assert not bool(_port_decode(arc, 9)["success"])
    # a header that claims more blocks than the buffer holds: fails, no IndexError
    bad = arc.copy()
    bad[4:8] = np.frombuffer(np.uint32(0xFFFF).tobytes(), np.uint8)
    bad[8:12] = np.frombuffer(np.uint32(10**9).tobytes(), np.uint8)
    assert not bool(_port_decode(bad[:size], 10)["success"])


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
def test_golden_ans_fixtures(name, n, pb, ck):
    """Decode the golden archives and re-encode them to the same bytes."""
    gold = np.fromfile(os.path.join(FIXTURES, name), np.uint8)
    if name == "ans_1byte.bin":
        data = np.array([0xA5], np.uint8)
    else:
        rng = np.random.default_rng(0x60D)
        data = np.minimum(rng.exponential(20.0, n), 255).astype(np.uint8)
    res = _port_decode(gold, pb, verify=True)
    assert bool(res["success"]) and bool(res["checksum_ok"])
    np.testing.assert_array_equal(res["out"].numpy()[:n], data)
    arc, size = _port_encode(_pad(data), n, pb, ck)
    assert size == gold.size
    np.testing.assert_array_equal(arc[:size], gold)


def _pad(data):
    out = np.zeros(L, np.uint8)
    out[: data.size] = data
    return out


def test_decode_lut_matches_oracle():
    for pb in C.SUPPORTED_PROB_BITS:
        rng = np.random.default_rng(pb)
        h = np.bincount(np.minimum(rng.exponential(9, 5000), 255).astype(int), minlength=256)
        pdf = stats.normalize_probs(torch.from_numpy(h), int(h.sum()), pb)
        got = pdecode.build_decode_lut(pdf, pb).numpy()
        want = np.asarray(jax.jit(jdecode.build_decode_lut, static_argnums=(1,))(
            jnp.asarray(pdf.numpy().astype(np.uint32)), pb))
        np.testing.assert_array_equal(got, want)


def _encode_kernel_matches_plain(dev, data, lengths, pb):
    """The encode kernel against its plain version on a (B, Lb) uint8
    batch on the card, each member with the table of its own first
    lengths[m] bytes (`lengths` an int for every member, or B ints, passed
    on the card): staged words up to each block's count, counts and states
    equal. Returns the counts."""
    lens = [lengths] * data.shape[0] if isinstance(lengths, int) else list(lengths)
    hist = torch.stack([torch.bincount(data[m, :n].long(), minlength=256)
                        for m, n in enumerate(lens)])
    totals = torch.tensor(lens, dtype=torch.int64, device=dev)
    tables = pencode.encode_table(stats.normalize_probs(hist, totals, pb))
    n = lengths if isinstance(lengths, int) else totals
    d32 = data.view(torch.int32)
    staged, counts, states = cuda_encode.encode_blocks_batched_cuda(d32, n, pb, tables)
    pst, pco, pss = pencode.encode_blocks_batched(d32, n, pb, tables)
    assert torch.equal(counts, pco) and torch.equal(states, pss)
    keep = torch.arange(staged.shape[1], device=dev)[None, :] < counts.long()[:, None]
    assert torch.equal(torch.where(keep, staged, 0), torch.where(keep, pst, 0))
    return counts


def _encode_kernel_on_risky_inputs(dev):
    """The encode kernel on the inputs its design is at risk on, as
    chip_smoke.py's slice-6 phase holds it: constant bytes (no emission),
    alternating and uniform random bytes (the most emission) at prob_bits
    9-11, an overflowing block at 11, lengths at every edge of a block,
    one-block members, a ragged batch whose members cross the persistent
    CTAs' shares, B = 1 and B = 513 (past one round of the member scan)."""
    g = torch.Generator(device=dev).manual_seed(6)
    Lb = 1 << 20
    fills = {
        "constant": torch.zeros((1, Lb), dtype=torch.uint8, device=dev),
        "alternating": torch.tensor([1, 254], dtype=torch.uint8, device=dev).repeat(Lb // 2)[None],
        "uniform": torch.randint(0, 256, (1, Lb), dtype=torch.uint8, device=dev, generator=g),
    }
    for name, d in fills.items():
        for pb in C.SUPPORTED_PROB_BITS:
            counts = _encode_kernel_matches_plain(dev, d, Lb, pb)
            assert name != "constant" or int(counts.max()) == 0
    rare = torch.arange(1, 256, dtype=torch.uint8, device=dev).repeat(17)[:4096]
    ovf = torch.cat([torch.zeros(16 * 4096, dtype=torch.uint8, device=dev), rare])[None]
    assert int(_encode_kernel_matches_plain(dev, ovf, ovf.shape[1], 11).max()) > 2560
    short = [1, 31, 33, 4095, 4096, 4097]
    d = torch.randint(0, 256, (len(short), 8192), dtype=torch.uint8, device=dev, generator=g)
    for n in short:
        _encode_kernel_matches_plain(dev, d[:1], n, 10)
    _encode_kernel_matches_plain(dev, d, short, 10)
    rng = np.random.default_rng(6)
    for B, nb, empty in ((64, 1, 0.0), (37, 64, 0.2), (513, 2, 0.3), (1, 3, 0.0)):
        lens = rng.integers(1, nb * 4096 + 1, B)
        lens[rng.random(B) < empty] = 0
        data = np.minimum(rng.exponential(20, (B, nb * 4096)), 255).astype(np.uint8)
        data = torch.from_numpy(data).to(dev)
        for pb in C.SUPPORTED_PROB_BITS:
            _encode_kernel_matches_plain(dev, data, lens.tolist(), pb)
    _encode_kernel_matches_plain(dev, data[:1].expand(513, -1).contiguous(), 5000, 10)


@pytest.mark.gpu
def test_encode_and_assembly_kernels_match_plain(cuda_device):
    rng = np.random.default_rng(11)
    n = 3 * 4096 + 17
    data = torch.from_numpy(_data(rng, n)).to(cuda_device)
    h = torch.bincount(data[:n].long(), minlength=256)
    pdf = stats.normalize_probs(h, n, 10)
    table = pencode.encode_table(pdf)
    d32 = layout.u8_to_u32le(data)
    staged, counts, states = cuda_encode.encode_blocks_batched_cuda(d32[None], n, 10, table[None])
    pst, pco, pss = pencode.encode_blocks_batched(d32[None], n, 10, table[None])
    assert torch.equal(counts, pco) and torch.equal(states, pss)
    keep = torch.arange(staged.shape[1], device=cuda_device)[None, :] < counts.long()[:, None]
    assert torch.equal(torch.where(keep, staged, 0), pst)

    arc_k = torch.zeros((1, pencode.archive_buffer_bytes(L) // 4), dtype=torch.int32,
                        device=cuda_device)
    prefix, ds32, _, size = pencode.write_sections_batched(
        arc_k, 0, pdf[None], states, counts, [n], 10)
    arc_p = arc_k.clone()
    cuda_encode.assemble_payload_batched_cuda(arc_k, ds32[0], staged, counts, prefix)
    pencode.assemble_payload_batched(arc_p, ds32[0], staged, counts, prefix)
    assert torch.equal(arc_k, arc_p)
    jarc, jsize = _enc_jit(jnp.asarray(data.cpu().numpy()), n, 10, False)
    assert int(size[0]) == int(jsize)
    np.testing.assert_array_equal(
        interop.archive_to_numpy(arc_k[0], int(size[0])), np.asarray(jarc)[: int(size[0])]
    )
    _encode_kernel_on_risky_inputs(cuda_device)
