"""Shared pieces of the PyTorch port's tests (tests/test_torch_port_*.py)."""

import pytest
import torch


@pytest.fixture
def cuda_device():
    """The card, for tests marked `gpu`; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on the card)")
    return torch.device("cuda")


@pytest.fixture()
def interpret_pallas(monkeypatch):
    """Force pallas_call interpret mode and clear build caches (the same
    patch as tests/test_pallas.py)."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    import dietgpu_tpu.ans.pallas_decode as pdec
    import dietgpu_tpu.ans.pallas_encode as penc
    import dietgpu_tpu.ans.pallas_hist as phist
    import dietgpu_tpu.floatcodec.pallas_float as pf

    def clear_caches():
        for mod in (pdec, penc, phist, pf):
            for name in dir(mod):
                obj = getattr(mod, name)
                if hasattr(obj, "cache_clear"):
                    obj.cache_clear()

    monkeypatch.setattr(pl, "pallas_call", patched)
    clear_caches()
    yield
    clear_caches()
