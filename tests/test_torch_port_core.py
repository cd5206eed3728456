"""The PyTorch port's building blocks against the JAX package (CPU).

Constants, import hygiene, probability quantization and the encode-table
arithmetic, and the f16/bf16 split with its histogram and checksum. Every
comparison is bit-exact (tolerance 0): the codec is lossless and its
archive format fixed.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dietgpu_tpu import constants as JC
from dietgpu_tpu.ans import checksum as jchecksum
from dietgpu_tpu.ans import stats as jstats
from dietgpu_tpu.floatcodec import split as jsplit
from dietgpu_tpu.ref import ans_ref

from dietgpu_tpu_torch import constants as PC
from dietgpu_tpu_torch.ans import checksum as pchecksum
from dietgpu_tpu_torch.ans import layout as playout
from dietgpu_tpu_torch.ans import stats as pstats
from dietgpu_tpu_torch.floatcodec import cuda_float
from dietgpu_tpu_torch.floatcodec import split as psplit
from torch_port_helpers import cuda_device  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_normalize_jit = jax.jit(jstats.normalize_probs, static_argnums=(2,))
_table_jit = jax.jit(jstats.build_encode_table)
_umulhi_jit = jax.jit(jstats.umulhi_u32)


def test_constants_match_jax_package():
    names = [n for n in dir(JC) if not n.startswith("_")]
    assert names == [n for n in dir(PC) if not n.startswith("_")]
    for name in names:
        j, p = getattr(JC, name), getattr(PC, name)
        if callable(j):
            for arg in (1, 4095, 4096, 4097, 123456):
                if name in ("float_noncomp_bytes", "float_word_size",
                            "max_float_compressed_size"):
                    for ft in (1, 2, 3):
                        args = (ft, arg) if name != "float_word_size" else (ft,)
                        assert j(*args) == p(*args), name
                elif name in ("div_up", "round_up", "round_down"):
                    assert j(arg, 16) == p(arg, 16), name
                else:
                    assert j(arg) == p(arg), name
        else:
            assert j == p, name


def test_import_hygiene_no_jax():
    """The port imports neither jax, ml_dtypes nor dietgpu_tpu, and runs a
    CPU roundtrip, a checkpoint among them, with all three blocked."""
    code = textwrap.dedent(
        """
        import sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                root = name.split(".")[0]
                if root in ("jax", "jaxlib", "dietgpu_tpu", "ml_dtypes"):
                    raise ImportError(f"blocked import of {name}")
                return None

        sys.meta_path.insert(0, Block())
        import torch
        import dietgpu_tpu_torch as port
        import io
        from dietgpu_tpu_torch import api, headers, interop, torch_api  # noqa: F401
        from dietgpu_tpu_torch import checkpoint, cli, profiling  # noqa: F401
        from dietgpu_tpu_torch.floatcodec import codec

        x = torch.randn(5000, generator=torch.Generator().manual_seed(1))
        for dtype in (torch.bfloat16, torch.float32):
            arc = port.float_compress(x.to(dtype), use_checksum=True, device="cpu")
            y = port.float_decompress(arc, device="cpu")
            assert torch.equal(y, x.to(dtype))
        data = (x.abs() * 20).to(torch.uint8)[:4096]
        arc, size = port.ans_encode_padded(data, 4000, 10, use_checksum=True)
        res = port.ans_decode_padded(arc, 10, 4096, verify_checksum=True)
        assert bool(res["success"]) and bool(res["checksum_ok"])
        assert torch.equal(res["out"][:4000], data[:4000])
        assert int(port.histogram_u8(data, 4000).sum()) == 4000
        ts = [x[:n].to(torch.bfloat16) for n in (0, 1, 4097)]
        comp, sizes, _ = api.compress_data(True, ts, checksum=True)
        outs = [torch.empty_like(t) for t in ts]
        status, _, _ = torch_api.decompress_data(
            True, [comp[i, : int(sizes[i])] for i in range(3)], outs, checksum=True)
        assert status.tolist() == [1, 1, 1]
        assert all(torch.equal(o, t) for o, t in zip(outs, ts))
        arcs = torch_api.compress_data_simple(False, [data[:100], data[:5000]])
        assert all(torch.equal(o, d) for o, d in zip(
            api.decompress_data_simple(False, arcs), (data[:100], data[:5000])))
        e = torch.arange(16, dtype=torch.int32)
        assert port.join_words_packed(e, e, 2).shape == (32,)
        assert port.join_words_packed_f32(e, torch.cat([e, e]), e).shape == (64,)
        sd = {"w": x.to(torch.bfloat16).view(50, 100), "b": x[:7], "n": torch.tensor(3),
              "m": x[:9] > 0}
        buf = io.BytesIO()
        checkpoint.save_arrays(buf, sd, device="cpu")
        buf.seek(0)
        back = checkpoint.load_arrays(buf, device="cpu")
        assert all(torch.equal(back[k], v) and back[k].dtype == v.dtype for k, v in sd.items())
        with profiling.annotate("float.split"):
            pass
        blocked = ("jax", "dietgpu_tpu", "ml_dtypes")
        assert not [m for m in sys.modules if m.split(".")[0] in blocked]
        print("OK")
        """
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        cwd=REPO, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("OK")


def test_layout_views_are_zero_copy():
    b = torch.arange(64, dtype=torch.uint8)
    w = playout.u8_to_u32le(b)
    assert w.data_ptr() == b.data_ptr()
    assert int(playout.to_u32(w[0])) == 0x03020100
    assert playout.u32_to_u8le(w).data_ptr() == b.data_ptr()
    v = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**32 - 1], dtype=torch.int64)
    assert playout.to_u32(playout.to_i32(v)).tolist() == v.tolist()


def _adversarial_hists(rng):
    hists = {}
    h = np.zeros(256, np.uint32)
    h[77] = 123456
    hists["single"] = h
    hists["all_ones"] = np.ones(256, np.uint32)
    h = np.ones(256, np.uint32)
    h[3] = 10**7
    hists["skew_excess"] = h
    h = np.zeros(256, np.uint32)
    h[:200] = rng.integers(1, 4, 200)
    h[250] = 5000
    hists["tiny_deficit"] = h
    hists["zero"] = np.zeros(256, np.uint32)
    h = np.zeros(256, np.uint32)
    h[:40] = rng.integers(1, 3, 40)
    h[100] = 90
    hists["many_tiny"] = h
    for i in range(6):
        hists[f"random{i}"] = rng.integers(0, 2000, 256).astype(np.uint32) * (
            rng.random(256) < 0.4 + 0.1 * i
        )
        hists[f"expo{i}"] = np.bincount(
            np.minimum(rng.exponential(3 + 8 * i, 30000), 255).astype(np.int64),
            minlength=256,
        ).astype(np.uint32)
    return hists


@pytest.mark.parametrize("pb", PC.SUPPORTED_PROB_BITS)
def test_normalize_probs_fuzz(pb):
    rng = np.random.default_rng(pb)
    for name, h in _adversarial_hists(rng).items():
        total = int(h.sum())
        got = pstats.normalize_probs(torch.from_numpy(h.astype(np.int64)), total, pb)
        want_j = np.asarray(_normalize_jit(jnp.asarray(h), np.uint32(total), pb))
        np.testing.assert_array_equal(got.numpy(), want_j, err_msg=name)
        want_r = ans_ref.normalize_probs(h, total, pb)
        np.testing.assert_array_equal(got.numpy(), want_r, err_msg=name)
        if total:
            assert int(got.sum()) == 1 << pb, name


def test_encode_table_arithmetic():
    pdf = np.arange(1, 2049, dtype=np.uint32)
    cpdf = np.concatenate([pdf, np.zeros(1, np.uint32)])  # pdf 0 too
    magic, shift = pstats.div_magic_u32(torch.from_numpy(cpdf.astype(np.int64)))
    jm, js = jax.jit(jstats.div_magic_u32)(jnp.asarray(cpdf))
    np.testing.assert_array_equal(magic.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(shift.numpy(), np.asarray(js))

    rng = np.random.default_rng(7)
    for _ in range(4):
        p = np.zeros(256, np.uint32)
        idx = rng.choice(256, 60, replace=False)
        p[idx] = rng.integers(1, 2049, 60)
        e1, mg = pstats.build_encode_table(torch.from_numpy(p.astype(np.int64)))
        je1, jmg = _table_jit(jnp.asarray(p))
        np.testing.assert_array_equal(e1.numpy(), np.asarray(je1))
        np.testing.assert_array_equal(mg.numpy(), np.asarray(jmg))

    a = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    b = np.concatenate([np.asarray(jm), rng.integers(0, 2**32, 4096 - 2049, dtype=np.uint64).astype(np.uint32)])
    got = pstats.umulhi_u32(torch.from_numpy(a.astype(np.int64)), torch.from_numpy(b.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(_umulhi_jit(jnp.asarray(a), jnp.asarray(b))))
    exact = (a.astype(object) * b.astype(object)) >> 32
    assert got.tolist() == [int(v) for v in exact]


def test_checksum_matches_jax():
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, 1003, dtype=np.uint8)
    for length in (0, 1, 2, 3, 4, 5, 1000, 1003):
        want = int(jax.jit(jchecksum.checksum_u8, static_argnums=(1,))(jnp.asarray(data), length))
        got = int(pchecksum.checksum_u8(torch.from_numpy(data), length))
        assert got == want == ans_ref.checksum_bytes(data[:length]), length


_jsplit_jit = jax.jit(jsplit.split_words, static_argnums=(1,))
_jjoin_jit = jax.jit(jsplit.join_words, static_argnums=(2,))
_jhist_jit = jax.jit(jstats.histogram_u8)
_jcks_jit = jax.jit(jchecksum.checksum_u8)


@pytest.mark.parametrize("ft", [PC.FLOAT_TYPE_FLOAT16, PC.FLOAT_TYPE_BFLOAT16])
@pytest.mark.parametrize("n", [4096, 4095, 3001])
def test_split_plain_matches_jax(ft, n):
    """The split kernel's plain version: planes, histogram and checksum."""
    Lw = 4096
    rng = np.random.default_rng(n + ft)
    w = rng.integers(0, 2**16, Lw, dtype=np.uint32).astype(np.uint16)
    pairs = torch.from_numpy(w.view(np.int32).copy())
    exp32, nc32, hist, cks = cuda_float.split_words_plain(pairs, n, ft, True)

    wz = w.copy()
    wz[n:] = 0
    comp, (nc,) = _jsplit_jit(jnp.asarray(wz), ft)
    comp = np.asarray(comp)
    np.testing.assert_array_equal(playout.u32_to_u8le(exp32).numpy(), comp)
    np.testing.assert_array_equal(playout.u32_to_u8le(nc32).numpy(), np.asarray(nc))
    np.testing.assert_array_equal(hist.numpy(), np.asarray(_jhist_jit(jnp.asarray(comp), n)))
    want = int(_jcks_jit(jnp.asarray(wz.view(np.uint8)), 2 * n))
    assert int(cks) == want

    # join inverts split, as the JAX join does
    joined = psplit.join_words(
        playout.u32_to_u8le(exp32), (playout.u32_to_u8le(nc32),), ft
    )
    jj = np.asarray(_jjoin_jit(jnp.asarray(comp), (jnp.asarray(nc),), ft))
    np.testing.assert_array_equal(joined.numpy().view(np.uint16), jj)
    np.testing.assert_array_equal(jj, wz)


def test_split_plain_rejects_bad_input():
    pairs = torch.zeros(2048, dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_float.split_words_plain(pairs, 4097, PC.FLOAT_TYPE_BFLOAT16)
    with pytest.raises(ValueError):
        cuda_float.split_words_plain(pairs, 10, PC.FLOAT_TYPE_FLOAT32)
    with pytest.raises(ValueError):
        cuda_float.split_words_plain(torch.zeros(100, dtype=torch.int32), 10, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("ft", [PC.FLOAT_TYPE_FLOAT16, PC.FLOAT_TYPE_BFLOAT16])
def test_split_kernel_matches_plain(cuda_device, ft):
    Lw = 1 << 16
    g = torch.Generator(device=cuda_device).manual_seed(ft)
    pairs = torch.randint(-(2**31), 2**31, (Lw // 2,), dtype=torch.int32,
                          device=cuda_device, generator=g)
    for n in (Lw, Lw - 5, 17):
        got = [x[0] for x in cuda_float.split_words_batched_cuda(pairs[None], n, ft, True)]
        want = cuda_float.split_words_plain(pairs, n, ft, True)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
