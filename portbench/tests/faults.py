"""Programs with the timed path broken underneath, for the tests: each
factory wraps the port's entry points with one fault that a cell can
have, and a run with it has to come out not correct."""

from types import SimpleNamespace

import torch
import torch.distributed as dist

from portbench import sut


def _flip(t: torch.Tensor, index: int) -> None:
    b = t.view(torch.uint8).view(-1)
    b[index % b.numel()] ^= 1


def altered():
    """A produced answer altered where it is produced: one archive byte
    past the headers, one decoded word, one gathered word."""
    p = sut.program()

    def float_compress_padded(words, length, *a, **k):
        arc, size = p.float_compress_padded(words, length, *a, **k)
        _flip(arc, 4096)
        return arc, size

    def float_decompress_padded(*a, **k):
        r = p.float_decompress_padded(*a, **k)
        _flip(r["out32"], 2)
        return r

    def compress_data(as_float, ts, *a, **k):
        comp, sizes, tm = p.compress_data(as_float, ts, *a, **k)
        _flip(comp[0], 4096)
        return comp, sizes, tm

    def decompress_data(as_float, ts_in, ts_out, *a, **k):
        r = p.decompress_data(as_float, ts_in, ts_out, *a, **k)
        _flip(ts_out[0], 2)
        return r

    def compressed_all_gather(x, *a, **k):
        full, used = p.compressed_all_gather(x, *a, **k)
        _flip(full, 2 * full.numel() - 2)
        return full, used

    return SimpleNamespace(**{**vars(p), "name": "altered", "capturable": False,
                              **{f.__name__: f for f in (
                                  float_compress_padded, float_decompress_padded,
                                  compress_data, decompress_data, compressed_all_gather)}})


def half():
    """Half of each call's words left out: compressed or gathered, and
    decoded into the output."""
    p = sut.program()

    def float_compress_padded(words, length, float_type, *a, **k):
        cut = words.clone()
        cut[length // 2 :] = 0
        return p.float_compress_padded(cut, length // 2, float_type, *a, **k)

    def compress_data(as_float, ts, *a, **k):
        return p.compress_data(as_float, [ts[0].reshape(-1)[: ts[0].numel() // 2]], *a, **k)

    def decompress_data(as_float, ts_in, ts_out, *a, **k):
        out = ts_out[0].reshape(-1)
        return p.decompress_data(as_float, ts_in, [out[: out.numel() // 2]], *a, **k)

    def compressed_all_gather(x, *a, **k):
        full, used = p.compressed_all_gather(x, *a, **k)
        n, w = x.numel(), full.numel() // x.numel()
        full.view(w, n)[:, n // 2 :] = 0
        return full, used

    return SimpleNamespace(**{**vars(p), "name": "half", "capturable": False,
                              **{f.__name__: f for f in (
                                  float_compress_padded, compress_data, decompress_data,
                                  compressed_all_gather)}})


def no_exchange():
    """The exchange between ranks left out: each rank's shard stands for
    every rank's."""
    p = sut.program()

    def compressed_all_gather(x, group=None, *a, **k):
        return x.repeat(dist.get_world_size(group)), True

    return SimpleNamespace(**{**vars(p), "name": "no_exchange",
                              "compressed_all_gather": compressed_all_gather})


def rank2_raises():
    """The program, but rank 2 raises in its third call."""
    p = sut.program()
    calls = [0]

    def compressed_all_gather(x, *a, **k):
        calls[0] += 1
        if dist.get_rank() == 2 and calls[0] == 3:
            raise RuntimeError("a rank raises, as the test asks")
        return p.compressed_all_gather(x, *a, **k)

    return SimpleNamespace(**{**vars(p), "name": "rank2_raises",
                              "compressed_all_gather": compressed_all_gather})


def marks_window():
    """The program, but its first all-gather call writes the file that
    PORTBENCH_TEST_MARK names, so that a test knows the window is open."""
    import os
    from pathlib import Path

    p = sut.program()

    def compressed_all_gather(x, *a, **k):
        Path(os.environ["PORTBENCH_TEST_MARK"]).touch()
        return p.compressed_all_gather(x, *a, **k)

    return SimpleNamespace(**{**vars(p), "name": "marks_window",
                              "compressed_all_gather": compressed_all_gather})


def loads_jax_package():
    """The program, after a module named as the JAX package has been
    loaded: the run has to refuse to print a result."""
    import sys
    import types

    sys.modules.setdefault("dietgpu_tpu", types.ModuleType("dietgpu_tpu"))
    return sut.program()
