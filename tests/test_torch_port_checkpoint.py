"""The port's compressed checkpoint (``dietgpu_tpu_torch.checkpoint``)
against ``dietgpu_tpu.checkpoint`` on the CPU.

The same numpy inputs, made from a seed, go through both packages: the
files must be equal byte for byte (tolerance 0: the container and its
archives are a fixed format), and each package must load the other's file
to equal arrays. The port runs with ``device="cpu"`` (the kernels' plain
versions); one case marked ``gpu`` holds the card's file against the CPU
route's.
"""

import io

import ml_dtypes
import numpy as np
import pytest
import torch

from dietgpu_tpu import checkpoint as jckpt
from dietgpu_tpu_torch import checkpoint as pckpt
from test_checkpoint import _mixed_arrays
from torch_port_helpers import cuda_device  # noqa: F401

SEED = 0x5EED


def _jax_file(arrays, **kw) -> tuple:
    buf = io.BytesIO()
    stats = jckpt.save_arrays(buf, arrays, **kw)
    return buf.getvalue(), stats


def _port_file(arrays, device="cpu", **kw) -> tuple:
    buf = io.BytesIO()
    stats = pckpt.save_arrays(buf, arrays, device=device, **kw)
    return buf.getvalue(), stats


def _bits(x) -> np.ndarray:
    """A numpy array or torch tensor as numpy, floats by their bits (so
    NaNs compare equal)."""
    if isinstance(x, torch.Tensor):
        x = x.cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        if x.dtype in (torch.float16, torch.float32, torch.float64):
            return x.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()]
                          ).numpy()
        return x.numpy()
    x = np.asarray(x)
    if x.dtype.name in ("bfloat16", "float16", "float32", "float64"):
        return x.view({2: np.int16, 4: np.int32, 8: np.int64}[x.dtype.itemsize])
    return x


def _same(got: dict, want: dict):
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        w = np.asarray(w) if not isinstance(w, torch.Tensor) else w
        wname = str(w.dtype).removeprefix("torch.") if isinstance(w, torch.Tensor) else w.dtype.name
        gname = str(g.dtype).removeprefix("torch.") if isinstance(g, torch.Tensor) else g.dtype.name
        assert gname == wname, k
        assert tuple(g.shape) == tuple(w.shape), k
        assert np.array_equal(_bits(g), _bits(w)), k


def _gpt2(layers=2, width=64, vocab=512, ctx=64, seed=SEED) -> dict:
    """A GPT-2-shaped state dict in numpy: bf16 matrices and embeddings
    (std 0.02, residual projections 0.02 / sqrt(2 layers)), f32
    LayerNorm parameters (ones, zeros) and linear biases (zeros), an int64
    step and a bool causal mask."""
    rng = np.random.default_rng(seed)

    def normal(shape, std=0.02):
        return (rng.standard_normal(shape) * std).astype(np.float32).astype(ml_dtypes.bfloat16)

    ones = lambda n: np.ones(n, np.float32)  # noqa: E731
    zeros = lambda n: np.zeros(n, np.float32)  # noqa: E731
    proj = 0.02 / np.sqrt(2 * layers)
    sd = {"wte": normal((vocab, width)), "wpe": normal((ctx, width))}
    for i in range(layers):
        p = f"h.{i}."
        sd.update({
            p + "ln_1.weight": ones(width), p + "ln_1.bias": zeros(width),
            p + "attn.c_attn.weight": normal((width, 3 * width)),
            p + "attn.c_attn.bias": zeros(3 * width),
            p + "attn.c_proj.weight": normal((width, width), proj),
            p + "attn.c_proj.bias": zeros(width),
            p + "ln_2.weight": ones(width), p + "ln_2.bias": zeros(width),
            p + "mlp.c_fc.weight": normal((width, 4 * width)),
            p + "mlp.c_fc.bias": zeros(4 * width),
            p + "mlp.c_proj.weight": normal((4 * width, width), proj),
            p + "mlp.c_proj.bias": zeros(width),
        })
    sd["ln_f.weight"], sd["ln_f.bias"] = ones(width), zeros(width)
    sd["step"] = np.array(1234, dtype=np.int64)
    sd["attn.mask"] = np.tril(np.ones((ctx, ctx), dtype=bool))
    return sd


def _edge_arrays(rng) -> dict:
    f = rng.standard_normal(300).astype(np.float32)
    f[[0, 7, 99]] = [np.nan, np.inf, -np.inf]
    return {
        "empty_f32": np.zeros((0,), np.float32),
        "empty_u8": np.zeros((3, 0), np.uint8),
        "scalar_f16": np.array(1.5, np.float16),
        "scalar_i64": np.array(-7, np.int64),
        "nan_inf_f32": f,
        "nan_inf_f16": f.astype(np.float16),
        "nan_inf_bf16": f.astype(ml_dtypes.bfloat16),
        "u16": rng.integers(0, 1 << 16, 1001, dtype=np.uint16),
        "u32": rng.integers(0, 1 << 32, 777, dtype=np.uint32),
        "u64": rng.integers(0, 1 << 63, (5, 33), dtype=np.uint64) * 2 + 1,
        "f64": rng.standard_normal((17, 3)),
        "bool": rng.random(999) > 0.3,
        "i8": rng.integers(-128, 128, 5000, dtype=np.int8),
        "constant_u8": np.full(20000, 42, np.uint8),
        "transposed_f32": rng.standard_normal((40, 70)).astype(np.float32).T,
    }


def _to_torch(a: np.ndarray) -> torch.Tensor:
    """The same array as a torch tensor (bf16 through its bits), keeping a
    transposed array's strides."""
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    elif not a.flags.c_contiguous and a.ndim == 2:
        return torch.from_numpy(np.ascontiguousarray(a.T)).T
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    return t.reshape(a.shape)  # ascontiguousarray makes a 0-d array 1-d


@pytest.mark.parametrize("use_checksum", [False, True])
@pytest.mark.parametrize("prob_bits", [9, 10, 11])
def test_file_equals_jax(prob_bits, use_checksum):
    arrays = _mixed_arrays(np.random.default_rng(SEED))
    jfile, jstats = _jax_file(arrays, prob_bits=prob_bits, use_checksum=use_checksum)
    pfile, pstats = _port_file(arrays, prob_bits=prob_bits, use_checksum=use_checksum)
    assert pfile == jfile
    assert pstats == jstats


def test_each_package_reads_the_others_file():
    arrays = _mixed_arrays(np.random.default_rng(SEED))
    jfile, _ = _jax_file(arrays)
    pfile, _ = _port_file(arrays)
    back = pckpt.load_arrays(io.BytesIO(jfile), device="cpu")
    assert all(t.device.type == "cpu" for t in back.values())
    _same(back, arrays)
    _same(jckpt.load_arrays(io.BytesIO(pfile)), arrays)


def test_gpt2_shaped_dict_spans_size_classes():
    sd = _gpt2()
    classes = {(a.dtype.name, pckpt._size_class(a.size if a.dtype.name in pckpt._FLOAT_TYPES
                                                else a.nbytes))
               for a in sd.values()}
    assert len(classes) >= 6, classes
    jfile, jstats = _jax_file(sd)
    pfile, pstats = _port_file(sd)
    assert pfile == jfile and pstats == jstats
    _same(pckpt.load_arrays(io.BytesIO(pfile), device="cpu"), sd)


def test_torch_state_dict_equals_numpy_dict():
    """A state_dict of torch tensors writes the file its numpy copy writes."""
    sd = _gpt2(seed=1)
    pfile, _ = _port_file({k: _to_torch(a) for k, a in sd.items()})
    assert pfile == _jax_file(sd)[0]


@pytest.mark.parametrize("as_torch", [False, True])
def test_edge_entries(as_torch):
    arrays = _edge_arrays(np.random.default_rng(SEED))
    jfile, jstats = _jax_file(arrays)
    given = {k: _to_torch(a) for k, a in arrays.items()} if as_torch else arrays
    if as_torch:
        assert not given["transposed_f32"].is_contiguous()
    pfile, pstats = _port_file(given)
    assert pfile == jfile
    assert pstats == jstats
    back = pckpt.load_arrays(io.BytesIO(jfile), device="cpu")
    _same(back, arrays)
    assert back["scalar_i64"].dim() == 0 and back["empty_u8"].shape == (3, 0)
    _same(jckpt.load_arrays(io.BytesIO(pfile)), arrays)


def test_paths_and_files(tmp_path):
    arrays = _mixed_arrays(np.random.default_rng(SEED))
    path = tmp_path / "ckpt.dgt"
    pckpt.save_arrays(path, arrays, device="cpu")
    assert path.read_bytes() == _jax_file(arrays)[0]
    _same(pckpt.load_arrays(str(path), device="cpu"), arrays)
    with open(path, "rb") as f:
        _same(pckpt.load_arrays(f, device="cpu"), arrays)


def test_corruption_detected():
    """The JAX test's byte flip (inside the first archive's nonComp plane)
    in the JAX file and in the port's: ValueError naming the entry."""
    arrays = {"x": np.random.default_rng(SEED).standard_normal(8192).astype(np.float16)}
    for blob in (_jax_file(arrays)[0], _port_file(arrays)[0]):
        blob = bytearray(blob)
        blob[60] ^= 0xFF
        with pytest.raises(ValueError, match="'x'.*checksum"):
            pckpt.load_arrays(io.BytesIO(bytes(blob)), device="cpu")


def test_corrupt_payload_names_its_entry():
    """A flipped byte in the last entry's ANS payload fails that entry."""
    arrays = {"a": np.arange(5000, dtype=np.int32), "b": np.arange(9000, dtype=np.int32)}
    blob, stats = _port_file(arrays)
    blob = bytearray(blob)
    blob[len(blob) - stats["b"]["stored_bytes"] // 3] ^= 0x5A
    with pytest.raises(ValueError, match="'b'"):
        pckpt.load_arrays(io.BytesIO(bytes(blob)), device="cpu")


def test_bad_magic_rejected():
    with pytest.raises(ValueError, match="checkpoint"):
        pckpt.load_arrays(io.BytesIO(b"\x00" * 16), device="cpu")


@pytest.mark.parametrize("bad", [np.zeros(3, np.complex64), torch.zeros(3, dtype=torch.complex64),
                                 np.zeros(3, np.float128) if hasattr(np, "float128")
                                 else np.zeros(3, np.complex128)])
def test_unsupported_dtype_raises_type_error(bad):
    with pytest.raises(TypeError, match="entry z"):
        pckpt.save_arrays(io.BytesIO(), {"ok": np.ones(3, np.float32), "z": bad}, device="cpu")


def test_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arrays = {"x": np.ones(10, np.float32)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pckpt.save_arrays(io.BytesIO(), arrays)
    pfile, _ = _port_file(arrays)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pckpt.load_arrays(io.BytesIO(pfile))


@pytest.mark.gpu
def test_card_file_equals_cpu_route(cuda_device):
    for arrays in (_mixed_arrays(np.random.default_rng(SEED)), _gpt2(),
                   _edge_arrays(np.random.default_rng(SEED))):
        on_card = {k: _to_torch(a).to(cuda_device) for k, a in arrays.items()}
        pfile, pstats = _port_file(on_card, device=None)
        assert (pfile, pstats) == _port_file(arrays)
        back = pckpt.load_arrays(io.BytesIO(pfile))
        assert all(t.is_cuda for t in back.values())
        _same(back, arrays)
