"""The PyTorch port's batched raw-ANS path against the JAX package (CPU).

``ans_encode_batched`` (per-member histograms, ``normalize_probs`` on a
(B, 256) batch, the plain versions of the per-member-table encode and the
batched assembly) and ``ans_decode_batched`` (the plain version of the
per-member-table raw decode) are held member by member against the JAX
package's single-archive XLA codec (``dietgpu_tpu.ans.encode`` and
``.decode``) and the NumPy oracle (``dietgpu_tpu.ref.ans_ref``), at pb
9/10/11, with ragged and equal lengths, and once against the JAX batched
Pallas codec in interpret mode. A lying header or a corrupted payload in
one member fails only that member. Tolerance 0 throughout.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dietgpu_tpu.ans import checksum as jchecksum
from dietgpu_tpu.ans import decode as jdecode
from dietgpu_tpu.ans import encode as jencode
from dietgpu_tpu.ans import stats as jstats
from dietgpu_tpu.ref import ans_ref

import dietgpu_tpu_torch as port
from dietgpu_tpu_torch import _build, interop
from dietgpu_tpu_torch import constants as C
from dietgpu_tpu_torch.ans import cuda_decode, cuda_encode, cuda_hist
from dietgpu_tpu_torch.ans import encode as pencode
from dietgpu_tpu_torch.ans import stats as pstats
from test_torch_port_core import _adversarial_hists
from torch_port_helpers import cuda_device, interpret_pallas  # noqa: F401

L = 3 * C.DEFAULT_BLOCK_SIZE  # one padded shape keeps JAX's compiles few
RAGGED = [8192, 5000, 1]
EQUAL = [L, L, L]

_enc_jit = jax.jit(jencode.ans_encode_padded, static_argnums=(2, 3))
_enc_pdf_jit = jax.jit(jencode.ans_encode_padded_with_pdf, static_argnums=(2, 4))
_dec_jit = jax.jit(jdecode.ans_decode_padded, static_argnums=(1, 2, 3))
_normalize_jit = jax.jit(jstats.normalize_probs, static_argnums=2)
_hist_jit = jax.jit(jstats.histogram_u8)
_cks_jit = jax.jit(jchecksum.checksum_u8)


def _batch(seed, lengths, size=L):
    """One member per length, each of its own exponential distribution (so
    each gets its own table), zero past its length."""
    rng = np.random.default_rng(seed)
    d = np.zeros((len(lengths), size), np.uint8)
    for m, n in enumerate(lengths):
        d[m, :n] = np.minimum(rng.exponential(3 + 9 * m, n), 255)
    return d


def _jax_archive(data, n, pb, ck):
    arc, size = _enc_jit(jnp.asarray(data), n, pb, ck)
    return np.asarray(arc)[: int(size)]


@pytest.mark.parametrize("pb", C.SUPPORTED_PROB_BITS)
def test_normalize_probs_batched_matches_jax(pb):
    """A (B, 256) batch of adversarial histograms, each row against JAX, the
    oracle, and the port's own one-row call."""
    hists = _adversarial_hists(np.random.default_rng(100 + pb))
    names = list(hists)
    h = np.stack([hists[k] for k in names]).astype(np.int64)
    totals = h.sum(1)
    got = pstats.normalize_probs(torch.from_numpy(h), torch.from_numpy(totals), pb)
    assert got.shape == h.shape
    for m, name in enumerate(names):
        want = np.asarray(_normalize_jit(jnp.asarray(h[m].astype(np.uint32)),
                                         np.uint32(totals[m]), pb))
        np.testing.assert_array_equal(got[m].numpy(), want, err_msg=name)
        np.testing.assert_array_equal(
            got[m].numpy(), ans_ref.normalize_probs(h[m].astype(np.uint32), int(totals[m]), pb),
            err_msg=name,
        )
        one = pstats.normalize_probs(torch.from_numpy(h[m]), int(totals[m]), pb)
        assert torch.equal(one, got[m]), name


@pytest.mark.parametrize("lengths", [RAGGED, [L, L - 3, 0]], ids=["ragged", "partial_word"])
def test_histogram_batched_matches_jax(lengths):
    d = np.random.default_rng(1).integers(0, 256, (3, L), dtype=np.uint8)
    d[0, :1000] = 9  # a long run of one value
    hist, cks = cuda_hist.histogram_u8_batched_plain(
        torch.from_numpy(d).view(torch.int32), lengths, True
    )
    assert hist.shape == (3, 256) and cks.shape == (3,)
    for m, n in enumerate(lengths):
        np.testing.assert_array_equal(hist[m].numpy(), np.asarray(_hist_jit(jnp.asarray(d[m]), n)))
        assert int(cks[m]) == int(_cks_jit(jnp.asarray(d[m]), n))
    with pytest.raises(ValueError):
        cuda_hist.histogram_u8_batched_plain(torch.from_numpy(d).view(torch.int32), [1, 2])
    with pytest.raises(ValueError):
        cuda_hist.histogram_u8_batched_plain(torch.from_numpy(d).view(torch.int32), [1, 2, L + 1])


@pytest.mark.parametrize("fill", ["random", "all_00", "all_ff", "alternating"])
def test_histogram_batched_empty_and_one_byte_members(fill):
    """Ragged batches with empty and 1-byte members beside a long one, each
    row against JAX, with the same bytes in every row (one bin holds most of
    the long member's counts)."""
    lengths = [0, 1, L, 0, 1, L - 7]
    B = len(lengths)
    rng = np.random.default_rng(21)
    if fill == "random":
        d = rng.integers(0, 256, (B, L), dtype=np.uint8)
    elif fill == "alternating":
        d = np.tile(np.array([0x01, 0xFE], np.uint8), (B, L // 2))
    else:
        d = np.full((B, L), 0 if fill == "all_00" else 0xFF, np.uint8)
    hist, cks = cuda_hist.histogram_u8_batched_plain(
        torch.from_numpy(d).view(torch.int32), lengths, True)
    for m, n in enumerate(lengths):
        np.testing.assert_array_equal(hist[m].numpy(), np.asarray(_hist_jit(jnp.asarray(d[m]), n)))
        assert int(cks[m]) == int(_cks_jit(jnp.asarray(d[m]), n))
    assert hist[[0, 3]].sum() == 0 and hist[[1, 4]].sum(1).tolist() == [1, 1]


def test_decode_odd_stream_starts_match_jax():
    """Block streams whose start word is odd: the format reads a block's
    stream from u32 ds32 + (start >> 1), so the JAX decoder and the port
    give the member's bytes; a second member of the batch is untouched."""
    lengths = [L, 9000]
    d = _batch(31, lengths)
    arcs, _ = port.ans_encode_batched(torch.from_numpy(d), lengths, None, 10, False)
    bad = arcs.clone()
    nb = int(bad[0, 1])
    bw = 136 + 32 * nb
    bad[0, bw + 1 : bw + 2 * nb : 2] |= 1
    assert (bad[0, bw + 1 : bw + 2 * nb : 2] & 1).all() and nb == 3
    res = port.ans_decode_batched(bad, 10, L)
    jres = _dec_jit(jnp.asarray(interop.archive_to_numpy(bad[0])), 10, L, False)
    assert res["success"].all() and bool(jres["success"])
    np.testing.assert_array_equal(np.asarray(jres["out"]), d[0])
    np.testing.assert_array_equal(res["out"].numpy(), d)


# the lengths that end a block's steps or the block itself at every edge
SHORT = [1, 31, 33, 4095, 4096, 4097]
OVERFLOW_LEN = 17 * C.DEFAULT_BLOCK_SIZE


def _overflow_batch():
    """16 blocks of zeros, then a block of the 255 other byte values: at
    prob_bits 11 each of those has weight 1 and the block emits more than
    2560 words; at 10 and 9 it emits at most 2560."""
    rare = np.tile(np.arange(1, 256, dtype=np.uint8), 17)[: C.DEFAULT_BLOCK_SIZE]
    return np.concatenate([np.zeros(OVERFLOW_LEN - rare.size, np.uint8), rare])[None]


def _encode_stage_matches_jax(d, n, pb, pdf):
    """The plain encode of one member against the JAX XLA encoder's
    interleaved stage (``_encode_core``): final states, each block's word
    count and its first 2560 emitted words in (step, lane) order."""
    tables = pencode.encode_table(torch.from_numpy(pdf.astype(np.int64)))[None]
    staged, counts, states = pencode.encode_blocks_batched(
        torch.from_numpy(d).view(torch.int32)[None], n, pb, tables)
    jstates, vals, mask = jax.jit(jencode._encode_core, static_argnums=2)(
        jnp.asarray(d), n, pb, jnp.asarray(pdf))
    vals, mask = np.asarray(vals).reshape(len(counts), -1), np.asarray(mask).reshape(len(counts), -1)
    np.testing.assert_array_equal(states.numpy().view(np.uint32), np.asarray(jstates))
    np.testing.assert_array_equal(counts.numpy(), mask.sum(1))
    for b, c in enumerate(counts.tolist()):
        want = vals[b][mask[b]][: C.MAX_COMP_WORDS_PER_BLOCK].astype(np.uint16)
        np.testing.assert_array_equal(staged[b, : min(c, C.MAX_COMP_WORDS_PER_BLOCK)].numpy()
                                      .view(np.uint16), want, err_msg=f"block {b}")
    return counts


@pytest.mark.parametrize("lengths", [RAGGED, EQUAL, SHORT, [OVERFLOW_LEN]],
                         ids=["ragged", "equal", "short", "overflow"])
@pytest.mark.parametrize("pb", C.SUPPORTED_PROB_BITS)
def test_encode_batched_matches_jax_per_member(pb, lengths):
    """Each member's archive equals the JAX XLA encoder's and the oracle's;
    it decodes in JAX, and the batch decodes in the port. The cases: ragged
    and equal lengths, lengths at every edge of a block's steps and of the
    block, and a block that overflows 2560 words at prob_bits 11, whose
    size carries the overflow bit in both packages, which the oracle
    refuses, and whose encode stage equals the JAX encoder's."""
    overflow = lengths == [OVERFLOW_LEN]
    d = _overflow_batch() if overflow else _batch(pb, lengths)
    size = d.shape[1]
    for ck in (False, True):
        arcs, sizes = port.ans_encode_batched(torch.from_numpy(d), lengths, None, pb, ck)
        assert arcs.shape == (len(lengths), pencode.archive_buffer_bytes(size) // 4)
        assert sizes.dtype == torch.int64
        if overflow and pb == 11:
            jarc, jsize = _enc_jit(jnp.asarray(d[0]), OVERFLOW_LEN, pb, ck)
            assert int(sizes[0]) == int(jsize) and int(jsize) & C.SIZE_OVERFLOW_BIT
            with pytest.raises(OverflowError):
                ans_ref.ans_encode(d[0], pb, use_checksum=ck)
            pdf = ans_ref.normalize_probs(np.bincount(d[0], minlength=256).astype(np.uint32),
                                          OVERFLOW_LEN, pb)
            counts = _encode_stage_matches_jax(d[0], OVERFLOW_LEN, pb, pdf)
            assert int(counts.max()) > C.MAX_COMP_WORDS_PER_BLOCK
            continue
        got = interop.archives_batch_to_numpy(arcs, sizes)
        for m, n in enumerate(lengths):
            want = _jax_archive(d[m], n, pb, ck)
            np.testing.assert_array_equal(got[m], want, err_msg=f"member {m}")
            np.testing.assert_array_equal(
                got[m], ans_ref.ans_encode(d[m, :n], pb, use_checksum=ck), err_msg=f"member {m}"
            )
            jres = _dec_jit(jnp.asarray(interop.archive_to_numpy(arcs[m])), pb, size, ck)
            assert bool(jres["success"]) and bool(jres["checksum_ok"])
            np.testing.assert_array_equal(np.asarray(jres["out"]), d[m])
        # the same bytes packed as int32 give the same archives
        a32, s32 = port.ans_encode_batched(torch.from_numpy(d).view(torch.int32), lengths,
                                           None, pb, ck)
        assert torch.equal(s32, sizes)
        for a, b in zip(got, interop.archives_batch_to_numpy(a32, s32)):
            np.testing.assert_array_equal(a, b)
        res = port.ans_decode_batched(arcs, pb, size, verify_checksum=ck)
        assert res["success"].all() and res["checksum_ok"].all()
        assert res["size"].tolist() == lengths
        np.testing.assert_array_equal(res["out"].numpy(), d)


def test_single_length_int_equals_a_list():
    d = _batch(3, EQUAL)
    a, s = port.ans_encode_batched(torch.from_numpy(d), L)
    b, t = port.ans_encode_batched(torch.from_numpy(d), EQUAL)
    assert torch.equal(s, t)
    for x, y in zip(interop.archives_batch_to_numpy(a, s), interop.archives_batch_to_numpy(b, t)):
        np.testing.assert_array_equal(x, y)


def test_encode_batched_with_pdfs_matches_jax():
    """Tables given by the caller (from other data) instead of the members'
    own histograms; the checksum still comes from the data."""
    d = _batch(5, RAGGED)
    other = _batch(6, EQUAL)
    pdfs = np.stack([
        ans_ref.normalize_probs(np.bincount(other[m], minlength=256).astype(np.uint32) + 1,
                                L + 256, 10)
        for m in range(3)
    ])
    arcs, sizes = port.ans_encode_batched(
        torch.from_numpy(d), RAGGED, torch.from_numpy(pdfs.astype(np.int64)), 10, True
    )
    got = interop.archives_batch_to_numpy(arcs, sizes)
    for m, n in enumerate(RAGGED):
        jarc, jsize = _enc_pdf_jit(jnp.asarray(d[m]), n, 10, jnp.asarray(pdfs[m]), True)
        np.testing.assert_array_equal(got[m], np.asarray(jarc)[: int(jsize)])


@pytest.mark.parametrize("pb", C.SUPPORTED_PROB_BITS)
def test_decode_batched_of_jax_archives(pb):
    """JAX archives laid out at the port's member stride and at a tighter
    one, as u32 words and as bytes, decode exactly; the oracle agrees."""
    d = _batch(7 + pb, RAGGED)
    jarcs = [_jax_archive(d[m], n, pb, True) for m, n in enumerate(RAGGED)]
    for stride in (None, pencode.archive_buffer_bytes(L) // 4):
        arcs = interop.archives_batch_from_numpy(jarcs, stride)
        for a in (arcs, arcs.view(torch.uint8)):
            res = port.ans_decode_batched(a, pb, L, verify_checksum=True)
            assert res["success"].all() and res["checksum_ok"].all()
            assert res["size"].tolist() == RAGGED
            np.testing.assert_array_equal(res["out"].numpy(), d)
    for m, n in enumerate(RAGGED):
        data, ok, size = ans_ref.ans_decode(jarcs[m], L, pb)
        assert ok and size == n
        np.testing.assert_array_equal(data, d[m, :n])


def test_decode_batched_member_faults_stay_in_their_member():
    lengths = [L, 9000, 4097]
    d = _batch(11, lengths)
    arcs, _ = port.ans_encode_batched(torch.from_numpy(d), lengths, None, 10, True)

    def decode(a, **kw):
        return port.ans_decode_batched(a, 10, L, verify_checksum=True, **kw)

    res = decode(arcs)
    assert res["success"].all() and res["checksum_ok"].all()
    # member 0 claims more bytes than the capacity: only it fails
    bad = arcs.clone()
    bad[0, 2] = L + 1
    res = decode(bad)
    assert res["success"].tolist() == [False, True, True]
    np.testing.assert_array_equal(res["out"][1:].numpy(), d[1:])
    # member 1 claims more blocks than its row holds: success stays as the
    # format defines it (magic, prob_bits, size), as in the JAX decoder,
    # with the JAX decoder's output, and the neighbours decode exactly
    bad = arcs.clone()
    bad[1, 1] = 0xFFFF
    res = decode(bad)
    jres = _dec_jit(jnp.asarray(interop.archive_to_numpy(bad[1])), 10, L, False)
    assert bool(res["success"][1]) == bool(jres["success"])
    np.testing.assert_array_equal(res["out"][1].numpy(), np.asarray(jres["out"]))
    np.testing.assert_array_equal(res["out"][[0, 2]].numpy(), d[[0, 2]])
    assert bool(res["success"][0]) and bool(res["success"][2])
    # a corrupted final state in member 2 decodes, to other bytes, and
    # fails only member 2's checksum
    bad = arcs.clone()
    bad[2, 136 + 5] ^= 0x10
    res = decode(bad)
    assert res["success"].all()
    assert res["checksum_ok"].tolist() == [True, True, False]
    np.testing.assert_array_equal(res["out"][:2].numpy(), d[:2])
    # static_nb: the block geometry comes from it, and a member whose
    # header disagrees fails success
    res = decode(arcs, static_nb=3)
    assert res["success"].tolist() == [True, True, False]
    np.testing.assert_array_equal(res["out"][:2].numpy(), d[:2])


def test_batched_entry_points_reject_bad_input():
    d = torch.zeros((2, L), dtype=torch.uint8)
    with pytest.raises(ValueError):
        port.ans_encode_batched(d, [1, 2, 3])
    with pytest.raises(ValueError):
        port.ans_encode_batched(d, L + 1)
    with pytest.raises(ValueError):
        port.ans_encode_batched(d[0], 1)
    with pytest.raises(ValueError):
        port.ans_encode_batched(d[:, :100], 1)
    with pytest.raises(ValueError):
        port.ans_decode_batched(torch.zeros(64, dtype=torch.int32), 10, L)
    with pytest.raises(ValueError):
        port.ans_decode_batched(torch.zeros((2, 64), dtype=torch.int32), 10, 1000)


def test_batched_matches_pallas_interpret(interpret_pallas):
    """The JAX batched Pallas codec in interpret mode, at the smallest shape
    that crosses a member boundary: two one-block members, ragged."""
    from dietgpu_tpu.ans import pallas_decode as pdec
    from dietgpu_tpu.ans import pallas_encode as penc

    Lm = C.DEFAULT_BLOCK_SIZE
    lengths = [Lm, 3000]
    d = _batch(12, lengths, Lm)
    pdfs = np.stack([
        ans_ref.normalize_probs(ans_ref.histogram_u8(d[m, :n]), n, 10)
        for m, n in enumerate(lengths)
    ]).astype(np.uint32)
    jarcs, jsizes = penc.ans_encode_batched_pallas(
        jnp.asarray(d.view(np.uint32)), jnp.asarray(lengths, jnp.int32), jnp.asarray(pdfs), 10
    )
    arcs, sizes = port.ans_encode_batched(torch.from_numpy(d), lengths)
    assert sizes.tolist() == np.asarray(jsizes).tolist()
    jarcs = np.asarray(jarcs)
    for m, a in enumerate(interop.archives_batch_to_numpy(arcs, sizes)):
        np.testing.assert_array_equal(a, jarcs[m].view(np.uint8)[: a.size], err_msg=f"member {m}")
    # JAX's batched decode on its own stride, the port's on its own
    jres = pdec.ans_decode_batched_pallas(jnp.asarray(jarcs), 10, Lm)
    res = port.ans_decode_batched(arcs, 10, Lm)
    assert np.asarray(jres["success"]).all() and res["success"].all()
    assert np.asarray(jres["size"]).tolist() == res["size"].tolist() == lengths
    np.testing.assert_array_equal(res["out"].numpy(), np.asarray(jres["out"]).view(np.uint8))
    np.testing.assert_array_equal(res["out"].numpy(), d)


@pytest.mark.gpu
def test_batched_ans_kernels_on_card_match_plain(cuda_device):
    """The hist, encode, assembly and decode_raw kernels on batches against
    their plain versions, at B = 1, a one-block member and ragged lengths,
    each launched once per call."""
    for lengths, size in (([L], L), ([1, L, 5000], L), (RAGGED * 3, 4 * L)):
        d = torch.from_numpy(_batch(len(lengths), lengths, size))
        kd = d.to(cuda_device)
        for pb in C.SUPPORTED_PROB_BITS:
            for ck in (False, True):
                _build.reset_kernel_launches()
                ka, ks = port.ans_encode_batched(kd, lengths, None, pb, ck)
                counts = _build.kernel_launches()
                assert [counts[k] for k in ("hist", "encode", "assembly")] == [1, 1, 1]
                pa, ps = cuda_encode.ans_encode_batched_plain(kd, lengths, None, pb, ck)
                assert torch.equal(ks, ps)
                for m in range(len(lengths)):
                    n32 = int(ks[m]) // 4
                    assert torch.equal(ka[m, :n32], pa[m, :n32])
                for digest in (False, True):
                    got = cuda_decode.decode_raw_batched_cuda(ka, pb, size, None, digest)
                    want = cuda_decode.decode_raw_batched_plain(ka, pb, size, None, digest)
                    for a, b in zip(got, want):
                        assert torch.equal(a.to(torch.int64), b.to(torch.int64))
                res = port.ans_decode_batched(ka, pb, size, verify_checksum=ck)
                assert res["success"].all() and res["checksum_ok"].all()
                assert torch.equal(res["out"].cpu(), d)


def test_entry_argument_types_match_the_c_signatures():
    """Every C entry point's parameters, read from its source, against the
    ctypes argument types the launcher sets (ctypes passes arguments past
    them unchecked, as C ints, so a missing one cuts a pointer)."""
    import ctypes
    import re

    ctype = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
             "long long": ctypes.c_longlong, "int": ctypes.c_int}
    for name, (source, sym, argtypes) in _build._ENTRY.items():
        text = (_build.CSRC / f"{source}.cu").read_text()
        params = re.search(rf'extern "C" int {sym}\(([^)]*)\)', text).group(1)
        types = [re.sub(r"\s+\w+$", "", p.strip()) for p in params.split(",")]
        assert [ctype[t] for t in types] == [*argtypes, ctypes.c_void_p], name
    # every source is built, and the new and changed entry points are bound
    assert {source for source, _, _ in _build._ENTRY.values()} == set(_build.SOURCES)
    assert {"join", "join_f32", "split", "split_f32"} <= set(_build._ENTRY)
    # the decode's three configurations bind one symbol with one tuple, and
    # decode.cu exports no other launch entry point
    decode = {_build._ENTRY[k] for k in ("decode", "decode_f32", "decode_raw")}
    assert len(decode) == 1 and next(iter(decode))[:2] == ("decode", "dtt_decode")
    text = (_build.CSRC / "decode.cu").read_text()
    assert re.findall(r'extern "C" int (\w+)\(', text) == ["dtt_decode", "dtt_decode_resources"]


def test_resource_entries_match_the_c_signatures():
    """Each kernel whose resources are reported has a C entry `(int config,
    int* out)` in its source that returns the report of launch.cuh, and the
    report names as many fields as the header writes."""
    import re

    assert set(_build._RESOURCES) == {"split", "split_f32", "hist", "tables", "encode",
                                      "sections", "decode", "decode_f32", "decode_raw",
                                      "join", "join_f32"}
    header = (_build.CSRC / "launch.cuh").read_text()
    assert sorted(int(i) for i in re.findall(r"out\[(\d)\] =", header)) == list(
        range(len(_build.RESOURCE_FIELDS)))
    for name, (source, sym, config) in _build._RESOURCES.items():
        text = (_build.CSRC / f"{source}.cu").read_text()
        params = re.search(rf'extern "C" int {sym}\(([^)]*)\)', text).group(1)
        assert [p.strip().rsplit(" ", 1)[0] for p in params.split(",")] == ["int", "int*"], name
        body = text[text.index(f'extern "C" int {sym}('):]
        assert re.search(r"return .*\.report\(out\);", body.split("\n}")[0]), name
        assert not re.findall(r"out\[(\d)\]", text), name
        assert 0 <= config <= 2
