"""The ten ops of the PyTorch port against the JAX package, op by op.

Each case is one input, made from a seed with numpy, through one op of a
pair of front-ends: ``dietgpu_tpu.api`` against ``dietgpu_tpu_torch.api``
(functional) and ``dietgpu_tpu.torch_api`` against
``dietgpu_tpu_torch.torch_api`` (in place). The stride forms and the header
queries run only through the functional pair, the only one that has them.
Both sides run on the CPU, the JAX side on its XLA route. Tolerance 0:

- every member's archive ``comp[b, :sizes[b]]`` (the static buffer widths
  may differ), sizes, temp_mem and status;
- the decoded bytes, or an output's bytes after an in-place op (outputs
  start as a sentinel, so a write, or its absence, shows), read through
  integer views so NaN payloads count;
- header info;
- when both sides raise, the exception type; when only one raises, the
  case fails.

Archives that decompress cases take are made by the JAX API once a module.
The tests marked `gpu` run the split, stride and info cases with the port's
tensors on the card, against the JAX package on the CPU.

Inputs that the two packages treat differently by design have their own
tests at the end, which pin the port's behaviour.
"""

import contextlib
import functools

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dietgpu_tpu import api as japi
from dietgpu_tpu import torch_api as jtapi

from dietgpu_tpu_torch import _build
from dietgpu_tpu_torch import api as papi
from dietgpu_tpu_torch import constants as C
from dietgpu_tpu_torch import torch_api as ptapi
from torch_port_helpers import cuda_device  # noqa: F401

BF16 = np.dtype(ml_dtypes.bfloat16)
F16, F32, U8 = np.dtype(np.float16), np.dtype(np.float32), np.dtype(np.uint8)
_TORCH_DTYPE = {BF16: torch.bfloat16, F16: torch.float16, F32: torch.float32, U8: torch.uint8,
                np.dtype(np.int16): torch.int16, np.dtype(np.int32): torch.int32}


# ---------------------------------------------------------------------------
# inputs: numpy arrays, handed to each side in its own type
# ---------------------------------------------------------------------------


class Strided:
    """An input or output that is not contiguous: the transpose of `a`
    (2-D). The port and the torch front-ends get ``.t()`` of a tensor; the
    JAX API, whose arrays have no strides, gets the same values."""

    def __init__(self, a):
        self.a = a


def normal(n, dtype, seed):
    """Standard-normal words, as the JAX package's tests make them."""
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32).astype(dtype)


def exp_bytes(n, seed):
    """Exponential(30) bytes, as benchmarks/sweep.py makes them."""
    return np.minimum(np.random.default_rng(seed).exponential(30, n), 255).astype(np.uint8)


def sentinel(shape, dtype):
    """An output whose every byte is 0x5A."""
    n = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
    return np.full(n, 0x5A, np.uint8).view(dtype).reshape(shape)


def overflow_words(dtype, n=6 * C.DEFAULT_BLOCK_SIZE):
    """Words whose coded bytes are 0 for n - 4096 words, then one block of
    the 255 other values: at prob_bits 11 each of those weighs 1 and the
    block needs more than its 2560 payload words."""
    comp = np.zeros(n, np.uint32)
    comp[-C.DEFAULT_BLOCK_SIZE:] = np.tile(np.arange(1, 256), 17)[: C.DEFAULT_BLOCK_SIZE]
    low = np.random.default_rng(3).integers(0, 1 << 24, n).astype(np.uint32)
    if dtype == F32:  # v = rotl32(word, 1) = comp:hi:lo
        v = (comp << 24) | (low & 0xFFFFFF)
        return ((v >> 1) | (v << 31)).astype(np.uint32).view(np.float32)
    w = (comp << 8) | (low & 0xFF)  # f16: word = comp:nc; bf16: rotl16(word, 1)
    if dtype == BF16:
        w = (w >> 1) | ((w & 1) << 15)
    return w.astype(np.uint16).view(dtype)


def to_torch(a, device="cpu"):
    """A numpy array (or Strided) as a tensor of its own memory."""
    if isinstance(a, Strided):
        return to_torch(a.a, device).t()
    a = np.array(a)  # a copy: in-place ops must not write the case's inputs
    t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) if a.dtype == BF16 else \
        torch.from_numpy(a)
    return t.to(device)


def to_jax(a):
    return jnp.asarray(a.a.T if isinstance(a, Strided) else a)


def data(x):
    """dtype name, shape and bytes of a tensor or array."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).removeprefix("torch.")
        x = x.detach().cpu().contiguous()
        a = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    else:
        a = np.asarray(x)
        name = a.dtype.name
    return name, tuple(a.shape), np.ascontiguousarray(a).tobytes()


def ints(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x).tolist()


class Side:
    """One front-end: its module, the type it takes, and whether its
    decompress writes its outputs in place."""

    def __init__(self, mod, jax_arrays, in_place, device="cpu"):
        self.mod, self.jax_arrays, self.in_place, self.device = mod, jax_arrays, in_place, device

    def arr(self, a):
        if isinstance(a, list):
            return [self.arr(x) for x in a]
        return to_jax(a) if self.jax_arrays else to_torch(a, self.device)

    def dtype(self, d):
        return jnp.dtype(d) if self.jax_arrays else _TORCH_DTYPE[np.dtype(d)]


FRONTS = {
    "api": (Side(japi, True, False), Side(papi, False, False)),
    "torch_api": (Side(jtapi, False, True), Side(ptapi, False, True)),
}


# ---------------------------------------------------------------------------
# the ops: each runs one call on one side and returns what is compared
# ---------------------------------------------------------------------------


def archives(comp, sizes):
    """Every member's archive [0, size); a row whose size carries the
    overflow bit holds no archive."""
    comp = comp.cpu() if isinstance(comp, torch.Tensor) else np.asarray(comp)
    return [data(comp[b, :s]) if s >= 0 else None for b, s in enumerate(ints(sizes))]


def max_sizes(s, xs, ns):
    m = s.mod
    return ([m.max_any_compressed_size(n) for n in ns],
            [m.max_float_compressed_size(s.dtype(d), n) for n in ns for d in (F16, BF16, F32)],
            m.max_any_compressed_output_size(s.arr(xs)),
            m.max_float_compressed_output_size(s.arr(xs)))


def compress(s, ca, xs, ck=False, pb=10):
    comp, sizes, tm = s.mod.compress_data(ca, s.arr(xs), ck, pb)
    return archives(comp, sizes), data(sizes), tm


def compress_simple(s, ca, xs, ck=False, pb=10):
    return [data(a) for a in s.mod.compress_data_simple(ca, s.arr(xs), ck, pb)]


def compress_split(s, ca, x, splits, ck=False, pb=10):
    comp, sizes, tm = s.mod.compress_data_split_size(ca, s.arr(x), splits, ck, pb)
    return archives(comp, sizes), data(sizes), tm


def compress_stride(s, ca, x, sizes, ck=False, pb=10):
    comp, sizes, tm = s.mod.compress_data_stride(ca, s.arr(x), sizes, ck, pb)
    return archives(comp, sizes), data(sizes), tm


def decompress(s, ca, arcs, like, ck=False, pb=10):
    outs = s.arr(like)
    res = s.mod.decompress_data(ca, s.arr(arcs), outs, ck, pb)
    if s.in_place:
        res = (outs, *res)
    outs, status, sizes, tm = res
    return [data(o) for o in outs], data(status), data(sizes), tm


def decompress_simple(s, ca, arcs, ck=False):
    return [data(o) for o in s.mod.decompress_data_simple(ca, s.arr(arcs), ck)]


def decompress_split(s, ca, arcs, like, splits, ck=False, pb=10):
    out = s.arr(like)
    res = s.mod.decompress_data_split_size(ca, s.arr(arcs), out, splits, ck, pb)
    if s.in_place:
        res = (out, *res)
    flat, status, sizes, tm = res
    return data(flat), data(status), data(sizes), tm


def decompress_stride(s, ca, arcs, batch, stride, dtype, sizes, ck=False, pb=10):
    out, status, sizes, tm = s.mod.decompress_data_stride(
        ca, s.arr(arcs), batch, stride, s.dtype(dtype), sizes, ck, pb)
    return data(out), data(status), data(sizes), tm


def info(s, ca, arcs):
    return s.mod.get_compressed_info(ca, s.arr(arcs))


def info_device(s, ca, matrix):
    return {k: ints(v) for k, v in s.mod.get_compressed_info_device(ca, s.arr(matrix)).items()}


# ---------------------------------------------------------------------------
# archives for the decompress cases, made by the JAX API once a module
# ---------------------------------------------------------------------------


def exact(comp, sizes, *_):
    """A JAX compress result as its exact-size archives (numpy)."""
    comp = np.asarray(comp)
    return [comp[b, :s].copy() for b, s in enumerate(ints(sizes))]


@functools.cache
def jax_archives(kind, lengths, pb=10, ck=False):
    """The JAX API's archives of members of `lengths` bf16, f16 or f32 words
    (normal) or bytes ("raw", exponential)."""
    xs = [exp_bytes(n, i) if kind == "raw" else normal(n, np.dtype(kind), i)
          for i, n in enumerate(lengths)]
    return exact(*japi.compress_data(kind != "raw", [jnp.asarray(x) for x in xs], ck, pb))


def arcs_of(kind, lengths, **kw):
    return jax_archives(kind, tuple(lengths), **kw)


def edit(arc, at, value):
    """A copy of an archive with bytes [at, at + len(value)) replaced."""
    arc = arc.copy()
    arc[at : at + len(value)] = value
    return arc


def split_archives(x, splits, ca=True, ck=False):
    """The JAX API's archives of consecutive splits of the flat input."""
    return exact(*japi.compress_data_split_size(ca, to_jax(x).reshape(-1), splits, ck))


def header_matrix(arcs):
    """Archives as the rows of one (B, bytes) u8 matrix, zero past each."""
    out = np.zeros((len(arcs), max(a.size for a in arcs)), np.uint8)
    for b, a in enumerate(arcs):
        out[b, : a.size] = a
    return out


# ---------------------------------------------------------------------------
# the cases: name -> (fronts, a function making (op, args), run the JAX side
# with 64-bit arrays). The functions run inside the test, never at collection.
# ---------------------------------------------------------------------------

BOTH, API = ("api", "torch_api"), ("api",)
CASES = {}


def case(name, fronts=BOTH, x64=False):
    def register(make):
        CASES[name] = (fronts, make, x64)
        return make
    return register


FLOAT_LENS = (12000, 4096, 9001)
ONE = (12000,)
# 64-bit members: an int64 one whose values need more than 32 bits, a float64 one
WIDE = [np.random.default_rng(4).integers(-(1 << 40), 1 << 40, 3000),
        np.random.default_rng(5).standard_normal(1000)]

# --- the four size queries ---
case("max_sizes")(lambda: (max_sizes, ([normal(1000, BF16, 0), normal(300, BF16, 1)],
                                       (0, 1, 4095, 4096, 123457))))

# --- compress_data ---
# per dtype, a batch whose last member overflows a block at prob_bits 11
for _d in (F16, BF16, F32):
    for _op in (compress, compress_simple):
        case(f"{_op.__name__}_overflow_{_d.name}")(lambda d=_d, op=_op: (op, (True, [
            normal(12000, d, 0), normal(4096, d, 1), overflow_words(d)], False, 11)))
for _pb, _ck in ((9, False), (10, False), (10, True), (11, False), (11, True)):
    case(f"compress_bf16_pb{_pb}_ck{int(_ck)}")(
        lambda pb=_pb, ck=_ck: (compress, (True, [normal(12000, BF16, 0)], ck, pb)))
for _pb in (9, 10, 11):
    case(f"compress_raw_pb{_pb}")(lambda pb=_pb: (compress, (False, [exp_bytes(12000, 0)], False, pb)))
case("compress_raw_members")(lambda: (compress, (False, [
    np.zeros(0, np.uint8), exp_bytes(1, 1), np.array(-123456, np.int32),
    exp_bytes(8192, 2).reshape(64, 128),
    Strided(np.random.default_rng(3).integers(-999, 999, (64, 96)).astype(np.int16))], True)))
case("compress_raw_64bit", x64=True)(lambda: (compress, (False, WIDE)))
case("compress_float_strided")(lambda: (compress, (True, [
    Strided(normal(96 * 128, BF16, 6).reshape(96, 128))])))
case("compress_empty_batch")(lambda: (compress, (True, [])))
case("compress_mixed_dtypes")(lambda: (compress, (True, [normal(64, F16, 0), normal(64, BF16, 0)])))
case("compress_int_as_float")(lambda: (compress, (True, [np.arange(64, dtype=np.int32)])))

# --- compress_data_simple ---
case("compress_simple_bf16")(lambda: (compress_simple, (True, [
    normal(n, BF16, i) for i, n in enumerate(FLOAT_LENS)])))
case("compress_simple_raw_ck")(lambda: (compress_simple, (False, [exp_bytes(12000, 0)], True)))

# --- compress_data_split_size ---
case("split_f16")(lambda: (compress_split, (True, normal(12000, F16, 1), [4096, 4096, 3808])))
# raw splits and stride rows of one shape, one with no bytes
RAW_SIZES = [9000, 0, 5000]
case("split_raw_zero_length_ck")(lambda: (compress_split, (
    False, exp_bytes(14000, 2), RAW_SIZES, True)))
case("split_strided_f16")(lambda: (compress_split, (
    True, Strided(normal(12000, F16, 1).reshape(120, 100)), [4000, 8000])))
case("split_misaligned")(lambda: (compress_split, (False, exp_bytes(100, 0), [3, 97])))
case("split_bad_sum")(lambda: (compress_split, (False, exp_bytes(100, 0), [4, 97])))

# --- compress_data_stride ---
case("stride_bf16", API)(lambda: (compress_stride, (
    True, normal(4 * 6000, BF16, 8).reshape(4, 6000), [6000, 4096, 1024, 5000])))
case("stride_raw_zero_row_ck", API)(lambda: (compress_stride, (
    False, exp_bytes(3 * 9000, 9).reshape(3, 9000), RAW_SIZES, True)))
case("stride_not_2d", API)(lambda: (compress_stride, (True, normal(6000, BF16, 8), None)))
case("stride_size_past_stride", API)(lambda: (compress_stride, (
    True, normal(2 * 100, BF16, 8).reshape(2, 100), [100, 101])))

# --- decompress_data: good archives, then outputs that do not fit them ---
case("decompress_float")(lambda: (decompress, (
    True, arcs_of("bfloat16", FLOAT_LENS), [sentinel((n,), BF16) for n in FLOAT_LENS])))
case("decompress_raw")(lambda: (decompress, (False, arcs_of("raw", ONE), [sentinel((12000,), U8)])))
case("decompress_raw_into_int32")(lambda: (decompress, (
    False, arcs_of("raw", ONE), [sentinel((3000,), np.int32)])))
case("decompress_at_pb11")(lambda: (decompress, (
    True, arcs_of("bfloat16", ONE), [sentinel((12000,), BF16)], False, 11)))
for _d in (F16, F32):
    case(f"decompress_into_{_d.name}")(lambda d=_d: (decompress, (
        True, arcs_of("bfloat16", ONE), [sentinel((12000,), d)])))
case("decompress_into_int32")(lambda: (decompress, (
    True, arcs_of("bfloat16", ONE), [sentinel((12000,), np.int32)])))
case("decompress_too_small")(lambda: (decompress, (
    True, arcs_of("bfloat16", ONE), [sentinel((8000,), BF16)])))
case("decompress_too_large")(lambda: (decompress, (
    True, arcs_of("bfloat16", ONE), [sentinel((20000,), BF16)])))
case("decompress_into_2d")(lambda: (decompress, (
    True, arcs_of("bfloat16", ONE), [sentinel((100, 120), BF16)])))
case("decompress_into_strided")(lambda: (decompress, (
    True, arcs_of("bfloat16", ONE), [Strided(sentinel((120, 100), BF16))])))

# --- decompress_data: archives that are wrong ---
case("decompress_raw_as_float")(lambda: (decompress, (
    True, arcs_of("raw", ONE), [sentinel((12000,), BF16)])))
for _kind, _ca in (("bfloat16", True), ("raw", False)):
    case(f"decompress_truncated_{_kind}")(lambda kind=_kind, ca=_ca: (decompress, (
        ca, [arcs_of(kind, ONE)[0][:300]], [sentinel((12000,), BF16 if ca else U8)])))
    case(f"decompress_garbage_{_kind}")(lambda kind=_kind, ca=_ca: (decompress, (
        ca, [np.random.default_rng(10).integers(0, 256, arcs_of(kind, ONE)[0].size)
             .astype(np.uint8)], [sentinel((12000,), BF16 if ca else U8)])))
    case(f"decompress_bad_magic_{_kind}")(lambda kind=_kind, ca=_ca: (decompress, (
        ca, [edit(arcs_of(kind, ONE)[0], 3, [0x00])], [sentinel((12000,), BF16 if ca else U8)])))
    # the four words of the float header; the first four of the ANS header
    for _w in range(4):
        for _v in (0x00, 0xFF):
            case(f"decompress_header_word{_w}_{_v:02x}_{_kind}")(
                lambda kind=_kind, ca=_ca, w=_w, v=_v: (decompress, (
                    ca, [edit(arcs_of(kind, ONE)[0], 4 * w, [v] * 4)],
                    [sentinel((12000,), BF16 if ca else U8)])))
    # a payload byte past the headers (a lane's final state of block 0)
    case(f"decompress_corrupt_payload_{_kind}")(lambda kind=_kind, ca=_ca: (decompress, (
        ca, [edit(arcs_of(kind, ONE)[0], -100, [0x11])],
        [sentinel((12000,), BF16 if ca else U8)])))
    case(f"decompress_corrupt_payload_ck_{_kind}")(lambda kind=_kind, ca=_ca: (decompress, (
        ca, [edit(arcs_of(kind, ONE, ck=True)[0], -100, [0x11])],
        [sentinel((12000,), BF16 if ca else U8)], True)))
# the stored checksum: word 3 of the float header, word 5 of the ANS header
case("decompress_corrupt_checksum_bfloat16")(lambda: (decompress, (
    True, [edit(arcs_of("bfloat16", ONE, ck=True)[0], 12, [0x00, 0x01])],
    [sentinel((12000,), BF16)], True)))
case("decompress_corrupt_checksum_raw")(lambda: (decompress, (
    False, [edit(arcs_of("raw", ONE, ck=True)[0], 20, [0x00, 0x01])],
    [sentinel((12000,), U8)], True)))

# --- decompress_data_simple ---
case("dsimple_float")(lambda: (decompress_simple, (True, arcs_of("bfloat16", FLOAT_LENS))))
case("dsimple_raw_ck")(lambda: (decompress_simple, (False, arcs_of("raw", ONE, ck=True), True)))
case("dsimple_pb11")(lambda: (decompress_simple, (True, arcs_of("bfloat16", ONE, pb=11))))
case("dsimple_truncated")(lambda: (decompress_simple, (True, [arcs_of("bfloat16", ONE)[0][:300]])))
case("dsimple_empty_batch")(lambda: (decompress_simple, (True, [])))
case("dsimple_garbage")(lambda: (decompress_simple, (
    False, [np.random.default_rng(11).integers(0, 256, 600).astype(np.uint8)])))


# --- decompress_data_split_size, with fault 6's inputs ---
def _split_case(x, splits, swap=None):
    """x's (f16) split archives, member `swap` replaced by an 8000-word
    archive, which fails it, into a sentinel output shaped like x."""
    arcs = split_archives(x, splits)
    if swap is not None:
        arcs[swap] = split_archives(normal(12000, F16, 6), [4000, 8000])[1]
    like = Strided(sentinel(x.a.shape, F16)) if isinstance(x, Strided) else \
        sentinel(x.shape, F16)
    return decompress_split, (True, arcs, like, splits)


case("dsplit_f16")(lambda: _split_case(normal(12000, F16, 1), [4096, 4096, 3808]))
case("dsplit_failing_member")(
    lambda: _split_case(normal(12000, F16, 5), [4096, 4096, 3808], swap=1))
case("dsplit_strided")(
    lambda: _split_case(Strided(normal(12000, F16, 1).reshape(120, 100)), [4000, 8000]))
case("dsplit_strided_failing_member")(
    lambda: _split_case(Strided(normal(12000, F16, 1).reshape(120, 100)), [4000, 8000], swap=0))
case("dsplit_raw_zero_length_ck")(lambda: (decompress_split, (
    False, split_archives(exp_bytes(14000, 2), RAW_SIZES, ca=False, ck=True),
    sentinel((14000,), U8), RAW_SIZES, True)))
case("dsplit_misaligned")(lambda: (decompress_split, (
    False, [np.zeros(64, np.uint8)], sentinel((100,), U8), [33, 67])))


# --- decompress_data_stride ---
STRIDE_SIZES = [6000, 4096, 1024, 5000]


def _stride_case(fail_row=None):
    x = normal(4 * 6000, BF16, 8).reshape(4, 6000)
    arcs = exact(*japi.compress_data_stride(True, jnp.asarray(x), STRIDE_SIZES))
    if fail_row is not None:  # a larger member's archive: that row fails
        arcs[fail_row] = arcs_of("bfloat16", ONE)[0]
    return decompress_stride, (True, arcs, 4, 6000, BF16, STRIDE_SIZES)


case("dstride_bf16", API)(_stride_case)
case("dstride_failing_row", API)(lambda: _stride_case(fail_row=2))
case("dstride_raw_zero_row_ck", API)(lambda: (decompress_stride, (
    False, exact(*japi.compress_data_stride(
        False, jnp.asarray(exp_bytes(3 * 9000, 9).reshape(3, 9000)), RAW_SIZES, True)),
    3, 9000, U8, RAW_SIZES, True)))


# --- get_compressed_info, get_compressed_info_device ---
case("info_float", API)(lambda: (info, (True, arcs_of("bfloat16", FLOAT_LENS))))
case("info_raw", API)(lambda: (info, (False, arcs_of("raw", ONE, pb=11))))
case("info_raw_as_float", API)(lambda: (info, (True, arcs_of("raw", ONE))))
case("info_empty_batch", API)(lambda: (info, (False, [])))
case("info_too_small", API)(lambda: (info, (True, [np.zeros(16, np.uint8)])))
case("info_device_float", API)(lambda: (info_device, (
    True, header_matrix(arcs_of("bfloat16", FLOAT_LENS)))))
case("info_device_raw", API)(lambda: (info_device, (
    False, header_matrix(arcs_of("raw", ONE, pb=11)))))
case("info_device_raw_as_float", API)(lambda: (info_device, (
    True, header_matrix(arcs_of("raw", ONE)))))
case("info_device_not_a_matrix", API)(lambda: (info_device, (True, np.zeros(64, np.uint8))))

PARAMS = [(f, n) for n, (fronts, _, _) in CASES.items() for f in fronts]
# the cases of the split and stride forms and the header queries, run with
# the port's tensors on the card by the tests marked gpu
CARD_CASES = [(f, n) for f, n in PARAMS if n.startswith(("split", "dsplit", "stride", "dstride",
                                                         "info"))]


def outcome(side, op, args, x64):
    """What one side's call gives, or the type of what it raises."""
    ctx = jax.enable_x64(True) if x64 and side.mod in (japi, jtapi) else contextlib.nullcontext()
    with ctx:
        try:
            return op(side, *args)
        except Exception as e:  # the comparison is the point: any type, on either side
            return ("raises", type(e).__name__)


def check_case(front, name, device="cpu"):
    fronts, make, x64 = CASES[name]
    op, args = make()
    jside, pside = FRONTS[front]
    if device != "cpu":
        pside = Side(pside.mod, False, pside.in_place, device)
    want = outcome(jside, op, args, x64)
    got = outcome(pside, op, args, x64)
    assert got == want, f"{front}.{op.__name__}: port {got!r:.600} != JAX {want!r:.600}"
    return got


@pytest.mark.parametrize("front,name", PARAMS, ids=[f"{f}-{n}" for f, n in PARAMS])
def test_port_matches_jax(front, name):
    check_case(front, name)


@pytest.mark.gpu
@pytest.mark.parametrize("front,name", CARD_CASES, ids=[f"{f}-{n}" for f, n in CARD_CASES])
def test_port_on_card_matches_jax(cuda_device, front, name):
    _build.reset_kernel_launches()
    check_case(front, name, cuda_device)
    if name.startswith(("split_f16", "stride_bf16", "dsplit_f16", "dstride_bf16")):
        assert any(_build.kernel_launches().values()), "no kernel ran on the card"


def test_outcome_keeps_nan_payloads_and_exception_types():
    """The comparison itself: NaN payloads that differ make different
    results, and two exception types differ."""
    a, b = (np.array([v], np.uint16).view(F16) for v in (0x7E00, 0x7E01))
    assert data(to_torch(a)) != data(to_torch(b)) and data(a) != data(b)
    assert data(to_torch(a)) == data(a)

    def boom(side, exc):
        raise exc("x")

    side = FRONTS["api"][1]
    assert outcome(side, boom, (ValueError,), False) != outcome(side, boom, (TypeError,), False)


# ---------------------------------------------------------------------------
# differences by design: the port's behaviour, pinned
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pb", [8, 12])
def test_prob_bits_outside_9_to_11_raise_value_error(pb):
    """The port raises ValueError for prob_bits outside 9-11, on compress and
    decompress; the JAX package asserts (``dietgpu_tpu/ans/encode.py:131``)."""
    x = normal(5000, BF16, 0)
    for fn in (lambda: papi.compress_data(True, [to_torch(x)], False, pb),
               lambda: ptapi.compress_data(False, [to_torch(exp_bytes(100, 0))], False, pb),
               lambda: papi.decompress_data(True, [to_torch(arcs_of("bfloat16", ONE)[0])],
                                            [to_torch(x)], False, pb)):
        with pytest.raises(ValueError, match="prob_bits"):
            fn()
    with pytest.raises(AssertionError):
        japi.compress_data(True, [jnp.asarray(x)], False, pb)


@pytest.mark.parametrize("front", [papi, ptapi], ids=["api", "torch_api"])
def test_empty_batch_decompress_raises_value_error(front):
    """decompress_data and decompress_data_split_size of no archives raise
    ValueError in the port; the JAX package asserts (``dietgpu_tpu/api.py``,
    ``decompress_data``)."""
    with pytest.raises(ValueError, match="one output per archive"):
        front.decompress_data(True, [], [])
    with pytest.raises(ValueError, match="one output per archive"):
        front.decompress_data_split_size(True, [], torch.zeros(0, dtype=torch.bfloat16), [])
    with pytest.raises(AssertionError):
        japi.decompress_data(True, [], [])


def test_bool_members_taken_as_bytes():
    """The port compresses a bool tensor as its bytes, the archive the JAX
    API writes for those bytes as uint8, and decodes it back into a bool
    output; the JAX API raises TypeError for a bool array."""
    mask = np.random.default_rng(12).random(9000) < 0.3
    comp, sizes, _ = papi.compress_data(False, [torch.from_numpy(mask)])
    jcomp, jsizes, _ = japi.compress_data(False, [jnp.asarray(mask.view(np.uint8))])
    assert archives(comp, sizes) == archives(jcomp, jsizes)
    outs, status, _, _ = papi.decompress_data(False, [comp[0, : int(sizes[0])]],
                                              [torch.zeros(9000, dtype=torch.bool)])
    assert status.tolist() == [1] and torch.equal(outs[0], torch.from_numpy(mask))
    with pytest.raises(TypeError):
        japi.compress_data(False, [jnp.asarray(mask)])


def test_64_bit_tensors_are_not_narrowed():
    """The JAX torch front-end hands tensors to JAX, whose 64-bit types are
    off: a float64 tensor under compress_as_float is archived as float32
    words (a lossy archive from a lossless codec) and a 64-bit tensor on the
    raw path loses its upper halves. The port refuses float64 as a float
    type, and on the raw path compresses all 8 bytes of each element (the
    archive the JAX API writes for the same array with 64-bit types on, as
    the compress_raw_64bit case holds) and decodes them back."""
    x = np.random.default_rng(0).standard_normal(12000)
    with pytest.raises(ValueError, match="unsupported float dtype float64"):
        ptapi.compress_data(True, [torch.from_numpy(x)])
    jarc = jtapi.compress_data_simple(True, [torch.from_numpy(x)])[0]
    head = japi.get_compressed_info(True, [jnp.asarray(jarc.numpy())])[0]
    assert head["float_type"] == C.FLOAT_TYPE_FLOAT32 and head["size"] == x.size

    wide = [torch.from_numpy(w) for w in WIDE]
    comp, sizes, _ = ptapi.compress_data(False, wide)
    arcs = [comp[b, : int(sizes[b])] for b in range(2)]
    assert papi.get_compressed_info(False, arcs)[0]["total_uncompressed_words"] == 8 * 3000
    outs = [torch.zeros_like(w) for w in wide]
    status, _, _ = ptapi.decompress_data(False, arcs, outs)
    assert status.tolist() == [1, 1] and all(torch.equal(o, w) for o, w in zip(outs, wide))
    narrowed = jtapi.compress_data_simple(False, wide[:1])[0]
    head = japi.get_compressed_info(False, [jnp.asarray(narrowed.numpy())])[0]
    assert head["total_uncompressed_words"] == 4 * 3000
