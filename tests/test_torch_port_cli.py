"""The port's file CLI (``dietgpu_tpu_torch.cli``) against the JAX CLI and
the NumPy oracle, on the CPU (``--device cpu``).

The same inputs, made from a seed, go through both CLIs in-process: the
archive files must be equal byte for byte (tolerance 0: the format is
fixed), each CLI must decompress the other's files, and `info` must print
the same JSON. The JAX CLI runs on the native host codec; where that does
not build, the cases that call it skip, as ``tests/test_cli.py`` does, and
the port is held against the oracle (``dietgpu_tpu.ref``) alone. One
subprocess runs ``python -m dietgpu_tpu_torch.cli`` as a smoke test.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from dietgpu_tpu import hostcodec
from dietgpu_tpu.ref import ans_ref, float_ref
from dietgpu_tpu_torch import cli as pcli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FT = {"f16": 1, "bf16": 2, "f32": 3}


def _wait_until_settled(path, timeout=60.0, poll=0.25, still=1.0):
    """Wait (up to `timeout` seconds) until `path` exists and its size has
    not changed for `still` seconds."""
    deadline = time.monotonic() + timeout
    last, held = None, 0.0
    while time.monotonic() < deadline:
        try:
            size = os.path.getsize(path)
        except OSError:  # not there yet, or being replaced
            size = None
        held = held + poll if size is not None and size == last else 0.0
        if held >= still:
            return
        last = size
        time.sleep(poll)


@pytest.fixture
def jcli():
    """The JAX CLI, which needs the native host codec.

    Test processes that start together may each build the codec's library
    into the same file, and one that loads it while another still writes it
    keeps the load error for good. So where the library did not load but
    can be built (its source and g++ are there), wait for the file to stop
    changing, clear the kept error and load it once more; skip only if that
    fails too."""
    if not hostcodec.available():
        if not (os.path.exists(hostcodec._SRC) and shutil.which("g++")):
            pytest.skip("native host codec unavailable (no source or no g++)")
        _wait_until_settled(hostcodec._SO)
        hostcodec._load_error = None
        if not hostcodec.available():
            pytest.skip(f"native host codec unavailable: {hostcodec._load_error!r}")
    from dietgpu_tpu import cli

    return cli


def _input(kind: str) -> np.ndarray:
    rng = np.random.default_rng(0x5EED)
    x = rng.standard_normal(30001).astype(np.float32)
    return {
        "raw": np.minimum(rng.exponential(20.0, 50001), 255).astype(np.uint8),
        "f16": x.astype(np.float16),
        "bf16": (x.view(np.uint32) >> 16).astype(np.uint16),
        "f32": x,
    }[kind]


def _options(kind: str) -> list:
    return [] if kind == "raw" else ["--float", kind]


def _oracle_archive(kind, data, prob_bits=10, checksum=True) -> bytes:
    if kind == "raw":
        return ans_ref.ans_encode(data, prob_bits=prob_bits, use_checksum=checksum).tobytes()
    words = data.view(np.uint32 if kind == "f32" else np.uint16)
    return float_ref.float_compress(words, FT[kind], prob_bits=prob_bits,
                                    use_checksum=checksum).tobytes()


@pytest.mark.parametrize("extra", [[], ["--no-checksum", "--prob-bits", "9"],
                                   ["--prob-bits", "11"]])
@pytest.mark.parametrize("kind", ["raw", "f16", "bf16", "f32"])
def test_archive_equals_oracle_and_round_trips(tmp_path, capsys, kind, extra):
    data = _input(kind)
    src, arc, out = tmp_path / "in.bin", tmp_path / "a.dg", tmp_path / "out.bin"
    data.tofile(src)
    assert pcli.main(["compress", *_options(kind), *extra, "--device", "cpu",
                      str(src), str(arc)]) == 0
    err = capsys.readouterr().err
    pb = int(extra[extra.index("--prob-bits") + 1]) if "--prob-bits" in extra else 10
    want = _oracle_archive(kind, data, pb, "--no-checksum" not in extra)
    assert arc.read_bytes() == want
    assert err == f"{data.nbytes} -> {len(want)} bytes ({len(want) / data.nbytes:.4f}x)\n"
    assert pcli.main(["decompress", "--device", "cpu", str(arc), str(out)]) == 0
    assert out.read_bytes() == data.tobytes()
    assert capsys.readouterr().err == f"{len(want)} -> {data.nbytes} bytes\n"


@pytest.mark.parametrize("kind", ["raw", "f16", "bf16", "f32"])
def test_files_and_info_equal_the_jax_cli(tmp_path, capsys, jcli, kind):
    data = _input(kind)
    src = tmp_path / "in.bin"
    data.tofile(src)
    files = {}
    for name, cli, dev in (("jax", jcli, []), ("port", pcli, ["--device", "cpu"])):
        files[name] = tmp_path / f"{name}.dg"
        assert cli.main(["compress", *_options(kind), *dev, str(src), str(files[name])]) == 0
    logs = capsys.readouterr().err.splitlines()
    assert logs[0] == logs[1]
    assert files["port"].read_bytes() == files["jax"].read_bytes()
    # each decompresses the other's file
    assert pcli.main(["decompress", "--device", "cpu", str(files["jax"]),
                      str(tmp_path / "p.out")]) == 0
    assert jcli.main(["decompress", str(files["port"]), str(tmp_path / "j.out")]) == 0
    assert (tmp_path / "p.out").read_bytes() == data.tobytes()
    assert (tmp_path / "j.out").read_bytes() == data.tobytes()
    logs = capsys.readouterr().err.splitlines()
    assert logs[0] == logs[1]
    # info: the same JSON, key for key and line for line
    assert jcli.main(["info", str(files["jax"])]) == 0
    want = capsys.readouterr().out
    assert pcli.main(["info", str(files["jax"])]) == 0
    got = capsys.readouterr().out
    assert got == want
    info = json.loads(got)
    assert info["kind"] == ("ans" if kind == "raw" else "float")
    if kind == "raw":
        assert info["total_compressed_size"] == files["jax"].stat().st_size
    else:
        assert info["float_type_name"] == kind and info["size"] == data.size


def test_info_of_a_forged_checksum_word_equals_the_jax_cli(tmp_path, capsys, jcli):
    """A header whose checksum word has bits above the low byte: both
    report the low byte."""
    data = _input("raw")
    arc = bytearray(_oracle_archive("raw", data))
    arc[21] ^= 0x7F  # byte 1 of the checksum word (u32 5)
    path = tmp_path / "forged.dg"
    path.write_bytes(bytes(arc))
    assert jcli.main(["info", str(path)]) == 0
    want = capsys.readouterr().out
    assert pcli.main(["info", str(path)]) == 0
    assert capsys.readouterr().out == want


def test_bad_magic_and_word_size_exit_2(tmp_path, capsys):
    junk = tmp_path / "junk.bin"
    junk.write_bytes(b"not an archive at all")
    assert pcli.main(["info", str(junk)]) == 2
    assert pcli.main(["decompress", "--device", "cpu", str(junk), str(tmp_path / "o")]) == 2
    assert capsys.readouterr().err == "not a dietgpu archive (bad magic)\n" * 2
    odd = tmp_path / "odd.bin"
    odd.write_bytes(b"\x01\x02\x03")
    for kind in ("f16", "f32"):
        assert pcli.main(["compress", "--float", kind, "--device", "cpu", str(odd),
                          str(tmp_path / "o")]) == 2
    assert not (tmp_path / "o").exists()
    assert capsys.readouterr().err.splitlines() == [
        "input size 3 is not a multiple of the f16 word size 2",
        "input size 3 is not a multiple of the f32 word size 4",
    ]


def test_no_card_without_device_cpu_exits_2(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = tmp_path / "in.bin"
    _input("raw").tofile(src)
    assert pcli.main(["compress", str(src), str(tmp_path / "a.dg")]) == 2
    assert not (tmp_path / "a.dg").exists()
    (tmp_path / "a.dg").write_bytes(_oracle_archive("raw", _input("raw")))
    assert pcli.main(["decompress", str(tmp_path / "a.dg"), str(tmp_path / "o")]) == 2
    assert not (tmp_path / "o").exists()
    assert "--device cpu" in capsys.readouterr().err
    # info reads only the header, on the host
    assert pcli.main(["info", str(tmp_path / "a.dg")]) == 0


def test_module_runs_in_a_subprocess(tmp_path):
    data = _input("bf16")
    src, arc, out = tmp_path / "in.bin", tmp_path / "a.dg", tmp_path / "out.bin"
    data.tofile(src)
    env = dict(os.environ, PYTHONPATH=REPO)
    for args in (["compress", "--float", "bf16", "--device", "cpu", str(src), str(arc)],
                 ["decompress", "--device", "cpu", str(arc), str(out)]):
        r = subprocess.run([sys.executable, "-m", "dietgpu_tpu_torch.cli", *args],
                           capture_output=True, text=True, env=env, cwd=tmp_path, timeout=120)
        assert r.returncode == 0, r.stderr
    assert arc.read_bytes() == _oracle_archive("bf16", data)
    assert out.read_bytes() == data.tobytes()
