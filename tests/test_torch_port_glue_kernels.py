"""The compress glue's two kernels: tables (``csrc/stats.cu``: the
probability quantization and the encode table) and sections
(``csrc/assembly.cu``: header, probabilities, states, blockWords, prefix
and sizes).

On the CPU:

- a CPU tensor takes the plain versions (``stats.normalize_probs``,
  ``encode.encode_table``, ``encode.write_sections_batched``) on every
  compress route, and no kernel wrapper is called;
- a wrong dtype or shape raises ValueError before any launch.

The tests marked `gpu` hold each kernel bit for bit against its plain
version on the card: tables on the edge cases of the quantization (a
total of 0, one symbol, all 256, pure deficits, an excess of many
passes), on N(0,1) bf16 and f32 exponent histograms, at prob_bits 9-11,
at B = 1, seven ragged totals and 65,537 members; sections on equal and
ragged archive offsets, with and without the checksum, with members of
fewer blocks than the batch's widest, with overflowing blocks, and at
path A's 32,768 blocks; then each compress route launches each kernel
once and gives the plain pipeline's archives.

This file imports nothing of JAX: the plain versions are its oracle (the
other test files hold them against the JAX package).
"""

import numpy as np
import pytest
import torch

import dietgpu_tpu_torch as port
from dietgpu_tpu_torch import _build
from dietgpu_tpu_torch import constants as C
from dietgpu_tpu_torch.ans import cuda_encode, stats
from dietgpu_tpu_torch.ans import encode as pencode
from dietgpu_tpu_torch.floatcodec import codec, cuda_float
from torch_port_helpers import cuda_device  # noqa: F401

BF = C.FLOAT_TYPE_BFLOAT16
FP32 = C.FLOAT_TYPE_FLOAT32
MASK = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def exponent_histograms(n=1 << 16, seed=0):
    """The split's exponent histograms of N(0,1) words: bf16, then f32."""
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(n).astype(np.float32))
    pairs = (x.view(torch.int32) >> 16).to(torch.int16).view(torch.int32)
    h_bf = cuda_float.split_words_plain(pairs, n, BF)[2]
    h_32 = cuda_float.split_words_f32_plain(x.view(torch.int32), n)[3]
    return h_bf, h_32


def edge_histograms(seed=0):
    """(256,) int64 counts whose quantization takes every branch."""
    rng = np.random.default_rng(seed)
    rows = []
    rows.append(np.zeros(256))  # total 0
    one = np.zeros(256)
    one[77] = 12345
    rows.append(one)  # one nonzero symbol
    rows.append(rng.integers(1, 5000, 256))  # all 256 nonzero
    deficit = np.zeros(256)
    deficit[:200] = 7  # 5.12 each at K = 1024: a deficit of 24
    rows.append(deficit)
    three = np.zeros(256)
    three[[3, 100, 250]] = 1000
    rows.append(three)  # a deficit of 1
    many = np.ones(256)
    many[9] = 10**6  # 255 weights forced up to 1: 254 passes on one symbol
    rows.append(many)
    two = np.ones(256)
    two[[9, 200]] = [10**6, 3 * 10**5]
    rows.append(two)
    sparse = np.zeros(256)
    sparse[rng.choice(256, 40, replace=False)] = rng.integers(1, 50, 40)
    rows.append(sparse)
    rows.append(rng.integers(0, 3, 256) * rng.integers(1, 10**6, 256))
    return [torch.from_numpy(np.asarray(r, np.int64)) for r in rows]


def all_histograms():
    return edge_histograms() + list(exponent_histograms())


def plain_tables(hist, total, pb):
    pdfs = stats.normalize_probs(hist, total, pb)
    return pdfs, pencode.encode_table(pdfs)


def assert_tables_equal(got, want):
    (pk, tk), (pp, tp) = got, want
    assert pk.dtype == torch.int32 and tk.dtype == torch.int32
    assert torch.equal(pk.cpu().long() & MASK, pp.cpu() & MASK)
    assert torch.equal(tk.cpu(), tp.cpu())


# ---------------------------------------------------------------------------
# on the CPU: the plain route, and the wrappers' checks
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """Every compress route on CPU tensors runs the plain glue and calls no
    kernel wrapper; its archives decode to the input."""
    calls = {"normalize_probs": 0, "encode_table": 0, "write_sections_batched": 0}

    def spy(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    spy(stats, "normalize_probs")
    spy(pencode, "encode_table")
    spy(pencode, "write_sections_batched")
    for name in ("quantize_cuda", "encode_table_cuda", "write_sections_batched_cuda"):
        monkeypatch.setattr(cuda_encode, name, lambda *a, **k: pytest.fail("kernel wrapper"))

    rng = np.random.default_rng(5)
    L = 2 * C.DEFAULT_BLOCK_SIZE
    x = torch.from_numpy(rng.standard_normal((3, L)).astype(np.float32))
    for ft, w in ((BF, (x.view(torch.int32) >> 16).to(torch.int16)), (FP32, x)):
        arcs, sizes = port.float_compress_batched(w, [L, L - 5, 17], ft, 10, True)
        res = port.float_decompress_batched(arcs, ft, L, 10, True)
        assert bool(res["success"].all() and res["checksum_ok"].all())
    data = torch.from_numpy(rng.integers(0, 9, (2, L)).astype(np.uint8))
    for ck in (False, True):
        arcs, sizes = port.ans_encode_batched(data, [L, 100], None, 10, ck)
        res = port.ans_decode_batched(arcs, 10, L, verify_checksum=ck)
        assert bool(res["success"].all()) and torch.equal(res["out"][0], data[0])
    pdfs = stats.normalize_probs(torch.bincount(data[0].long(), minlength=256), L, 10)
    arcs, _ = port.ans_encode_batched(data, L, torch.stack([pdfs, pdfs]), 10)
    assert torch.equal(port.ans_decode_batched(arcs, 10, L)["out"], data)
    # float twice, raw twice: quantize; the given pdfs: the table alone
    assert calls == {"normalize_probs": 4 + 1, "encode_table": 5, "write_sections_batched": 5}
    h = torch.stack(all_histograms())
    totals = h.sum(1)
    for got, want in zip(cuda_encode.quantize(h, totals, 11, plain=True),
                         plain_tables(h, totals, 11)):
        assert torch.equal(got, want)
    assert not any(port.kernel_launches().values())


def _i32(*shape):
    return torch.zeros(shape, dtype=torch.int32)


WRONG = {
    "hist-shape": lambda: cuda_encode.quantize_cuda(_i32(2, 255), 100, 10),
    "hist-1d": lambda: cuda_encode.quantize_cuda(_i32(256), 100, 10),
    "hist-dtype": lambda: cuda_encode.quantize_cuda(_i32(2, 256).long(), 100, 10),
    "hist-cpu": lambda: cuda_encode.quantize_cuda(_i32(2, 256), 100, 10),
    "prob-bits": lambda: cuda_encode.quantize_cuda(_i32(2, 256), 100, 8),
    "pdfs-shape": lambda: cuda_encode.encode_table_cuda(_i32(1, 512)),
    "pdfs-dtype": lambda: cuda_encode.encode_table_cuda(_i32(1, 256).float()),
    "arcs-cpu": lambda: cuda_encode.write_sections_batched_cuda(
        _i32(1, 4096), 0, _i32(1, 256), _i32(32), _i32(1), [4096], 10),
    "arcs-dtype": lambda: cuda_encode.write_sections_batched_cuda(
        _i32(1, 4096).long(), 0, _i32(1, 256), _i32(32), _i32(1), [4096], 10),
}


@pytest.mark.parametrize("case", list(WRONG))
def test_wrong_dtype_or_shape_raises_before_any_launch(case):
    port.reset_kernel_launches()
    with pytest.raises(ValueError):
        WRONG[case]()
    assert not any(port.kernel_launches().values())


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("pb", C.SUPPORTED_PROB_BITS)
def test_tables_kernel_matches_plain_on_card(cuda_device, pb):
    hists = all_histograms()
    for h in hists:  # B = 1, one total for the member
        total = int(h.sum())
        got = cuda_encode.quantize_cuda(h[None].to(cuda_device, torch.int32), total, pb)
        assert_tables_equal(got, plain_tables(h[None], total, pb))
    # a batch of every case, each with its own total; a total of 0 beside
    # nonzero counts; seven ragged totals
    h = torch.stack(hists + [hists[2]])
    totals = h.sum(1)
    totals[-1] = 0
    for rows in (slice(None), slice(2, 9)):
        hc = h[rows].to(cuda_device, torch.int32).contiguous()
        got = cuda_encode.quantize_cuda(hc, totals[rows].to(cuda_device).contiguous(), pb)
        assert_tables_equal(got, plain_tables(h[rows], totals[rows], pb))
        # the table alone from the same weights
        tables = cuda_encode.encode_table_cuda(got[0])
        assert torch.equal(tables, got[1])


@pytest.mark.gpu
def test_tables_kernel_65537_members_on_card(cuda_device):
    """More members than a launch's grid y holds, each its own histogram."""
    B = 65537
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.integers(0, 4, (B, 256)) * rng.integers(0, 3000, (B, 1)))
    h[::7, 5] += 10**6  # excess on every seventh member
    totals = h.sum(1)
    got = cuda_encode.quantize_cuda(h.to(cuda_device, torch.int32), totals.to(cuda_device), 10)
    assert_tables_equal(got, plain_tables(h.to(cuda_device), totals.to(cuda_device), 10))


def sections_case(dev, B, NBm, lengths, base32, ck, seed, overflow=False):
    """Encode outputs and archive rows for write_sections_batched: random
    counts (0 past each member's blocks; some above 2560 if `overflow`),
    states and pdfs, rows prefilled with one random sentinel."""
    rng = np.random.default_rng(seed)
    nbs = [-(-n // C.DEFAULT_BLOCK_SIZE) for n in lengths]
    counts = rng.integers(0, 2561, (B, NBm))
    if overflow:
        counts[:, 0] = C.MAX_COMP_WORDS_PER_BLOCK + 1 + np.arange(B)
    for m, nb in enumerate(nbs):
        counts[m, nb:] = 0
    states = rng.integers(-(1 << 31), 1 << 31, (B * NBm, 32))
    pdfs = rng.integers(0, 2049, (B, 256))
    base = np.broadcast_to(np.asarray(base32), (B,))
    R = C.round_up(int(base.max()) + 136 + NBm * 32 + 2 * C.round_up(NBm, 2) + 20, 4)
    arcs = rng.integers(-(1 << 31), 1 << 31, (B, R))
    cks = rng.integers(-(1 << 31), 1 << 31, B) if ck else None

    def t(a):
        return None if a is None else torch.from_numpy(np.asarray(a, np.int32)).to(dev)
    return (t(arcs), base32, t(pdfs), t(states), t(counts.reshape(-1)), list(lengths), 10, ck,
            t(cks))


SECTIONS = {
    "equal": (4, 5, [5 * 4096] * 4, 8),
    "equal-short-members": (3, 6, [6 * 4096, 4096 + 1, 0], 12),
    "ragged-bases": (3, 7, [7 * 4096, 3 * 4096 - 5, 9], [4, 40, 400]),
    "one-block": (5, 1, [4096, 1, 4095, 0, 4096], [8, 8, 8, 12, 16]),
    "two-tiles-ragged": (2, 300, [300 * 4096, 257 * 4096 + 3], [4, 1000]),
}
SECTION_CASES = [(k, ck) for k in SECTIONS for ck in (False, True)]


def assert_sections_equal(args):
    want_arcs = args[0].clone()
    got = cuda_encode.write_sections_batched_cuda(*args)
    want = pencode.write_sections_batched(want_arcs, *args[1:])
    assert torch.equal(args[0], want_arcs)
    prefix, ds32, ds32_t, sizes = got
    assert prefix.dtype == torch.int32 and torch.equal(prefix, want[0])
    assert ds32 == want[1] and torch.equal(ds32_t, want[2])
    assert sizes.dtype == torch.int64 and torch.equal(sizes, want[3])
    return sizes


@pytest.mark.gpu
@pytest.mark.parametrize("case,ck", SECTION_CASES,
                         ids=[f"{k}-ck{int(c)}" for k, c in SECTION_CASES])
def test_sections_kernel_matches_plain_on_card(cuda_device, case, ck):
    B, NBm, lengths, base32 = SECTIONS[case]
    assert_sections_equal(sections_case(cuda_device, B, NBm, lengths, base32, ck, len(case)))


@pytest.mark.gpu
def test_sections_kernel_overflow_and_path_a_on_card(cuda_device):
    """Overflowing blocks set the size's bit 31; path A's one member of
    32,768 blocks spreads over 128 tiles."""
    sizes = assert_sections_equal(
        sections_case(cuda_device, 3, 4, [4 * 4096, 2 * 4096, 1], [4, 8, 12], True, 1,
                      overflow=True))
    assert bool((sizes & C.SIZE_OVERFLOW_BIT).all())
    NB = 32768
    sizes = assert_sections_equal(
        sections_case(cuda_device, 1, NB, [NB * 4096], 4 + (1 << 25), False, 2))
    assert not bool((sizes & C.SIZE_OVERFLOW_BIT).any())


@pytest.mark.gpu
def test_compress_routes_launch_each_glue_kernel_once_on_card(cuda_device):
    """Float (single and ragged) and raw ANS (own and given pdfs) each
    launch tables and sections once a call, and give the plain pipeline's
    archives."""
    rng = np.random.default_rng(9)
    L = 3 * C.DEFAULT_BLOCK_SIZE
    x = torch.from_numpy(rng.standard_normal((3, L)).astype(np.float32)).to(cuda_device)
    w_bf = (x.view(torch.int32) >> 16).to(torch.int16)
    data = torch.from_numpy(rng.integers(0, 30, (2, L)).astype(np.uint8)).to(cuda_device)
    pdfs = stats.normalize_probs(torch.bincount(data[0].long(), minlength=256), L, 10)
    calls = [
        lambda p: (codec.float_compress_padded_plain if p else codec.float_compress_padded)(
            w_bf[0], L - 3, BF, 10, True),
        lambda p: (codec.float_compress_batched_plain if p else codec.float_compress_batched)(
            x, [L, 5, 4096], FP32, 11, False),
        lambda p: (cuda_encode.ans_encode_batched_plain if p else port.ans_encode_batched)(
            data, [L, 77], None, 9, True),
        lambda p: (cuda_encode.ans_encode_batched_plain if p else port.ans_encode_batched)(
            data, L, torch.stack([pdfs, pdfs]), 10, False),
    ]
    for fn in calls:
        port.reset_kernel_launches()
        arcs, sizes = fn(False)
        torch.cuda.synchronize()
        launched = port.kernel_launches()
        assert launched["tables"] == 1 and launched["sections"] == 1
        parcs, psizes = fn(True)
        arcs, parcs = (arcs[None], parcs[None]) if arcs.dim() == 1 else (arcs, parcs)
        assert torch.equal(sizes.reshape(-1), psizes.reshape(-1))
        for m, s in enumerate(sizes.reshape(-1).tolist()):
            assert torch.equal(arcs[m, : s // 4], parcs[m, : s // 4])
    for k in ("tables", "sections"):
        assert _build.kernel_resources(k)["local_bytes"] == 0
