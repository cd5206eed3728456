"""The port's f16/bf16 split (``csrc/split.cu`` and its plain version) on
the inputs the split kernel's design is at risk on, against the JAX
package (CPU).

Uniformly random 16-bit words give every exponent byte, NaN and Inf
patterns included. The plain split is held against
``split_words_pallas`` in interpret mode (whose histogram counts its
zero-padded tile into bin 0) and against the XLA ``split_words`` with a
numpy histogram and checksum at the member lengths around a word octet
and a block: 0, 1, 7, 8, 9, 4095, 4096, 4097 and Lw, alone and as one
ragged batch. ``float_compress_batched`` on that batch is held against
the JAX API's archives member by member. The tests marked `gpu` hold the
split kernel against its plain version on the card on the same inputs,
and run batches of 65537 members (one more than a launch's grid y takes)
through the kernels whose launches took a member a grid row: split_f32,
assembly and both joins. Tolerance 0 throughout: the codec is lossless.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dietgpu_tpu import api as japi
from dietgpu_tpu.floatcodec import split as jsplit

import dietgpu_tpu_torch as port
from dietgpu_tpu_torch import _build, interop
from dietgpu_tpu_torch import constants as C
from dietgpu_tpu_torch.floatcodec import codec, cuda_float
from torch_port_helpers import cuda_device, interpret_pallas  # noqa: F401

F16, BF16, F32 = C.FLOAT_TYPE_FLOAT16, C.FLOAT_TYPE_BFLOAT16, C.FLOAT_TYPE_FLOAT32
LW = 4 * C.DEFAULT_BLOCK_SIZE
EDGES = [0, 1, 7, 8, 9, 4095, 4096, 4097, LW]
BIG_BATCH = 65537  # one member more than a launch's grid y holds

_jsplit = jax.jit(jsplit.split_words, static_argnums=(1,))


def _uniform(seed, rows, lw=LW):
    """(rows, lw) uniformly random uint16 words."""
    return np.random.default_rng(seed).integers(0, 1 << 16, (rows, lw), dtype=np.uint16)


def _masked(w, lengths):
    w = w.copy()
    for m, n in enumerate(lengths):
        w[m, n:] = 0
    return w


def _jax_split(w, n, ft):
    """The JAX package's split of the first n words of w (uint16): the
    exponent and nonComp bytes (zero past n), the exponent histogram of the
    first n words and their folded XOR checksum, as numpy."""
    w = _masked(w[None], [n])[0]
    comp, (nc,) = _jsplit(jnp.asarray(w), ft)
    comp, nc = np.asarray(comp), np.asarray(nc)
    hist = np.bincount(comp[:n], minlength=256)
    cks = int(np.bitwise_xor.reduce(w[:n].view(np.uint8))) if n else 0
    return comp, nc, hist, cks


def _port_member(out, m):
    """Member m of split_words_batched_plain's output as numpy bytes."""
    exp32, nc32, hist, cks = out
    return (exp32[m].numpy().view(np.uint8), nc32[m].numpy().view(np.uint8),
            hist[m].numpy(), int(cks[m]))


@pytest.mark.parametrize("n", EDGES)
@pytest.mark.parametrize("ft", [F16, BF16])
def test_plain_split_matches_jax_at_edge_lengths(ft, n):
    """One member of uniformly random words at each edge length."""
    w = _uniform(100 + n, 1)
    pairs = interop.words_from_numpy(w).view(torch.int32)
    got = _port_member(cuda_float.split_words_batched_plain(pairs, n, ft, True), 0)
    want = _jax_split(w[0], n, ft)
    for g, j in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, j)
    assert got[3] == want[3]


@pytest.mark.parametrize("ft", [F16, BF16])
def test_plain_split_ragged_batch_matches_jax(ft):
    """The edge lengths as one ragged batch of uniformly random words."""
    w = _uniform(7 + ft, len(EDGES))
    pairs = interop.words_from_numpy(w).view(torch.int32)
    out = cuda_float.split_words_batched_plain(pairs, EDGES, ft, True)
    for m, n in enumerate(EDGES):
        got, want = _port_member(out, m), _jax_split(w[m], n, ft)
        for g, j in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g, j, err_msg=f"member {m} (n = {n})")
        assert got[3] == want[3], f"member {m} (n = {n})"


@pytest.mark.parametrize("n", [LW, 4097])
@pytest.mark.parametrize("ft", [F16, BF16])
def test_plain_split_matches_pallas_interpret(interpret_pallas, ft, n):
    """split_words_pallas on the same words, zero past n, with its padded
    tile and the words past n taken out of bin 0."""
    from dietgpu_tpu.floatcodec import pallas_float as pf

    w = _masked(_uniform(30 + ft, 1), [n])[0]
    pexp, pnc, phist, pcks = pf.split_words_pallas(jnp.asarray(w.view(np.uint32)), ft, True)
    exp32, nc32, hist, cks = cuda_float.split_words_plain(
        interop.words_from_numpy(w).view(torch.int32), n, ft, True)
    for got, want in ((exp32, pexp), (nc32, pnc)):  # the Pallas planes cover its tile
        np.testing.assert_array_equal(interop.words_to_numpy(got),
                                      np.asarray(want)[: LW // 4].view(np.uint32))
    want = np.asarray(phist).astype(np.int64)
    want[0] -= pf.split_total_words(LW) - n
    np.testing.assert_array_equal(hist.numpy(), want)
    assert int(cks) == int(pcks)


@pytest.mark.parametrize("ft", [F16, BF16])
def test_ragged_uniform_words_compress_matches_jax_api(ft):
    """float_compress_batched on the edge-length batch of uniformly random
    words: each member's archive equals the JAX API's, and the batch
    decodes to its words."""
    dtype = jnp.float16 if ft == F16 else jnp.bfloat16
    w = _masked(_uniform(50 + ft, len(EDGES)), EDGES)
    js = [jnp.asarray(w[m, :n]).view(dtype) for m, n in enumerate(EDGES)]
    jcomp, jsizes, _ = japi.compress_data(True, js)
    arcs, sizes = port.float_compress_batched(interop.words_from_numpy(w), EDGES, ft)
    assert sizes.tolist() == np.asarray(jsizes).tolist()
    got = interop.archives_batch_to_numpy(arcs, sizes)
    jcomp = np.asarray(jcomp)
    for m, s in enumerate(sizes.tolist()):
        np.testing.assert_array_equal(got[m], jcomp[m, :s], err_msg=f"member {m}")
    res = port.float_decompress_batched(arcs, ft, LW)
    assert res["success"].all() and res["size"].tolist() == EDGES
    np.testing.assert_array_equal(interop.words_to_numpy(res["out32"]).view(np.uint16), w)


def _card_inputs(dev, ft):
    """(name, (B, LW) int16 words on the card) that the split kernel's
    design is at risk on."""
    g = torch.Generator(device=dev).manual_seed(ft)
    B = len(EDGES)
    one = 0x3F80 if ft == BF16 else 0x3C00  # 1.0
    alt = torch.tensor([one, 0x4780 if ft == BF16 else 0x7800], dtype=torch.int32, device=dev)
    return {
        "constant": torch.full((B, LW), one, dtype=torch.int16, device=dev),
        "alternating exponents": alt.repeat(B * LW // 2).view(B, LW).to(torch.int16),
        "uniform": torch.randint(-(1 << 15), 1 << 15, (B, LW), dtype=torch.int16, device=dev,
                                 generator=g),
    }


def _same(got, want):
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("ft", [F16, BF16])
def test_split_kernel_on_card_matches_plain(cuda_device, ft):
    """Constant, alternating and uniform words at each edge length alone
    and as one ragged batch, with and without the checksum, one launch a
    call; the nonComp plane also into rows 8 bytes past a 16-byte
    boundary."""
    for name, w in _card_inputs(cuda_device, ft).items():
        pairs = w.view(torch.int32).view(len(EDGES), -1)
        for ck in (False, True):
            for n in EDGES:
                _same(cuda_float.split_words_batched_cuda(pairs[:1], n, ft, ck),
                      cuda_float.split_words_batched_plain(pairs[:1], n, ft, ck))
            _build.reset_kernel_launches()
            got = cuda_float.split_words_batched_cuda(pairs, EDGES, ft, ck)
            assert _build.kernel_launches()["split"] == 1, name
            _same(got, cuda_float.split_words_batched_plain(pairs, EDGES, ft, ck))
        wide = torch.full((len(EDGES), LW // 4 + 4), -1, dtype=torch.int32, device=cuda_device)
        nk, np_ = wide[:, 2 : 2 + LW // 4], wide.clone()[:, 2 : 2 + LW // 4]
        _same(cuda_float.split_words_batched_cuda(pairs, EDGES, ft, True, nc_out=nk),
              cuda_float.split_words_batched_plain(pairs, EDGES, ft, True, nc_out=np_))


@pytest.mark.gpu
def test_split_kernel_on_card_many_members(cuda_device):
    """513 ragged members (more than one round of the kernel's member
    scan), many empty or short, and 37 members of up to 64 blocks whose
    items cross the persistent CTAs' shares."""
    rng = np.random.default_rng(13)
    for B, blocks in ((513, 2), (37, 64)):
        lw = blocks * C.DEFAULT_BLOCK_SIZE
        lens = rng.integers(0, lw + 1, B)
        lens[rng.random(B) < 0.2] = 0
        lens = lens.tolist()
        w = interop.words_from_numpy(_uniform(B, B, lw), cuda_device).view(torch.int32)
        for ft in (F16, BF16):
            _same(cuda_float.split_words_batched_cuda(w, lens, ft, True),
                  cuda_float.split_words_batched_plain(w, lens, ft, True))


@pytest.mark.gpu
@pytest.mark.parametrize("ft", [BF16, F32])
def test_batch_of_65537_members_round_trips_on_card(cuda_device, ft):
    """65537 members of 4096 words compress and decompress exactly; the
    archives of members 0, 65535 and 65536 equal their single-tensor
    archives (split or split_f32, encode, assembly, decode)."""
    g = torch.Generator(device=cuda_device).manual_seed(65537)
    n = C.DEFAULT_BLOCK_SIZE
    x = torch.randn((BIG_BATCH, n), generator=g, device=cuda_device)
    w = x.view(torch.int32) if ft == F32 else (x.view(torch.int32) >> 16).to(torch.int16)
    del x
    arcs, sizes = port.float_compress_batched(w, n, ft, 10, False)
    res = port.float_decompress_batched(arcs, ft, n, 10, False, static_length=n)
    assert bool(res["success"].all())
    assert torch.equal(res["out32"], w.view(BIG_BATCH, -1).view(torch.int32))
    for m in (0, BIG_BATCH - 2, BIG_BATCH - 1):
        a, s = codec.float_compress_padded(w[m], n, ft, 10, False)
        assert int(s) == int(sizes[m])
        assert torch.equal(arcs[m, : int(s) // 4], a[: int(s) // 4])


@pytest.mark.gpu
def test_joins_of_65537_members_on_card(cuda_device):
    """join and join_f32 at B = 65537: members 0 and 65536 equal their
    plain joins."""
    g = torch.Generator(device=cuda_device).manual_seed(5)

    def rand(width):
        return torch.randint(-(1 << 31), 1 << 31, (BIG_BATCH, width), dtype=torch.int32,
                             device=cuda_device, generator=g)

    n4 = 1024
    e, c, lo, hi = rand(n4), rand(n4), rand(2 * n4), rand(n4)
    rows = [0, BIG_BATCH - 1]
    got = port.join_words_packed(e, c, BF16)
    assert torch.equal(got[rows], cuda_float.join_words_plain(e[rows], c[rows], BF16))
    got = port.join_words_packed_f32(e, lo, hi)
    assert torch.equal(got[rows], cuda_float.join_words_f32_plain(e[rows], lo[rows], hi[rows]))
