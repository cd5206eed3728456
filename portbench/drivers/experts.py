"""The expert cells: one MoE layer's routed experts on one rank, sent as one
``torch_api`` batch of float8 matrices, as an expert-parallel deployment
ships them when it moves experts between ranks or syncs weights.

The configuration names a layer's members (``layer``: [name, shape, init])
and how many layers a run holds (``model.n_layer``). Member m of layer i is
drawn in float32 on the card from ``inputs.sub_seed(seed, i, m)`` ("normal":
N(0, initializer_range^2); "ones", "zeros") and quantized block by block to
the configuration's float8 format (``reference.fp8_blocks``); its bytes are
what the codec carries. The window has two halves, as the codec cells':

- first, one caller in a closed loop calls ``torch_api.compress_data(False,
  <layer i's members>, False, prob_bits)`` for i = 0, 1, ..., n_layer - 1,
  round and round;
- then ``torch_api.decompress_data(False, <layer i's last archive rows>,
  <layer i's receive buffers>, False, prob_bits)``, in place, in the same
  order.

Each half ends in a synchronize, and its rate is the raw bytes of its calls
over all of its time. After the window, the last archive of every member of
the first ``check_layers`` layers is held byte for byte against the
reference's (``floatref.ans_archive``), every member's last decode byte for
byte against its input, and every call's own sizes and status against what
they should be.
"""

import time
from collections import Counter

import torch

from .. import device, inputs, sut as sut_mod, trace, work
from ..reference import floatref, fp8_blocks
from .codec import PREFIX, mismatch, timed_half

FLOAT8 = {"float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2}
FILLS = {"ones": 1.0, "zeros": 0.0}


def hist_bytes(raw: int) -> int:
    """The histogram pass of a byte compress reads the raw bytes once."""
    return raw


def decode_raw_bytes(raw: int, archive: int) -> int:
    """The raw decode reads the archive and writes the raw bytes."""
    return archive + raw


def make_member(cfg, layer: int, m: int, dev, seed: int) -> torch.Tensor:
    """Member m of layer `layer`: its float8 values, shaped as the
    configuration says."""
    _, shape, init = cfg["layer"][m]
    if init == "normal":
        n = 1
        for d in shape:
            n *= d
        w = inputs.normal(n, torch.float32, 0.0, cfg["model"]["initializer_range"], dev,
                          seed, layer, m).view(shape)
    else:
        w = torch.full(shape, FILLS[init], dtype=torch.float32, device=dev)
    q, _ = fp8_blocks.quantize(w, tuple(cfg["block"]), FLOAT8[cfg["dtype"]])
    return q


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


def host_lists(tensors) -> list:
    """Each 1-D device tensor's values as a list, read in one transfer."""
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1).to(torch.int64) for t in tensors]).tolist()
    out, at = [], 0
    for t in tensors:
        out.append(flat[at : at + t.numel()])
        at += t.numel()
    return out


class Caller:
    """One closed-loop caller of the front end over the layers."""

    def __init__(self, sut, layers, outs, prob_bits):
        self.sut, self.layers, self.outs, self.pb = sut, layers, outs, prob_bits
        self.comps = [None] * len(layers)
        self.rows = [None] * len(layers)  # each layer's archive rows, made once a compress
        self.compress_calls, self.decompress_calls = [], []

    def compress(self, i):
        comp, sizes, _ = self.sut.compress_data(False, self.layers[i], False, self.pb)
        self.comps[i], self.rows[i] = comp, None
        self.compress_calls.append((i, sizes))

    def decompress(self, i):
        if self.rows[i] is None:
            self.rows[i] = list(self.comps[i].unbind(0))
        status, sizes, _ = self.sut.decompress_data(False, self.rows[i], self.outs[i], False,
                                                    self.pb)
        self.decompress_calls.append((i, status, sizes))

    def warm(self, rounds: int):
        for _ in range(rounds):
            for i in range(len(self.layers)):
                self.compress(i)
                self.decompress(i)
        for out in self.outs:
            for o in out:
                as_bytes(o).fill_(0xA5)  # only what the window writes can pass the check
        self.compress_calls.clear()
        self.decompress_calls.clear()


def run(cell, seed, seconds, trace_on, sut_spec, dev, t_start) -> dict:
    """One run of an expert cell on `dev`; see ``portbench.run`` for what it
    returns."""
    cfg, tr = cell.config, cell.traffic
    if cfg.get("checksum"):
        raise ValueError("the expert cells' reference writes no checksum")
    if tr["entry"] != "torch_api":
        raise ValueError("the expert cells call the program through torch_api")
    n_layer, members, pb = cfg["model"]["n_layer"], len(cfg["layer"]), cfg["prob_bits"]
    layers = [[make_member(cfg, i, m, dev, seed) for m in range(members)]
              for i in range(n_layer)]
    outs = [[torch.empty_like(x) for x in layer] for layer in layers]
    caller = Caller(sut_mod.load(sut_spec), layers, outs, pb)
    caller.warm(tr["warm_calls"])
    device.sync(dev)
    setup_s = time.perf_counter() - t_start

    half_s = tr["trace_seconds"] if trace_on else seconds / 2
    comp = timed_half("compress", caller.compress, n_layer, half_s, dev, trace_on)
    dec = timed_half("decompress", caller.decompress, n_layer, half_s, dev, trace_on)
    peak = device.memory_peak(dev)
    t_check = time.perf_counter()

    # every call's own sizes and status, read back in one transfer
    cc, dc = caller.compress_calls, caller.decompress_calls
    got = host_lists([s for _, s in cc] + [s for _, _, s in dc] + [st for _, st, _ in dc])
    c_sizes, d_sizes, d_status = got[: len(cc)], got[len(cc) : -len(dc)], got[-len(dc) :]
    last = {i: s for (i, _), s in zip(cc, c_sizes)}  # the sizes of each layer's kept archives

    # the kept archives of the first check_layers layers against the
    # reference's; every other layer's calls are held to its last call's sizes
    want, bad_c, arc_wrong = {}, set(), 0
    for i in range(n_layer):
        if i >= tr["check_layers"]:
            want[i] = last[i]
            continue
        want[i], wrong, kept = [], 0, caller.comps[i]
        for m, x in enumerate(layers[i]):
            ref = floatref.ans_archive(as_bytes(x), pb)
            want[i].append(ref.numel())
            s = last[i][m] if m < len(last[i]) else -1
            wrong += mismatch(kept[m, :s] if 0 <= s <= kept.shape[1] else None, ref)
            del ref
        arc_wrong += wrong
        if wrong:
            bad_c.add(i)
    caller.comps = caller.rows = [None] * n_layer
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # every member's last decode against its input
    wrong_d = torch.stack([sum((as_bytes(o) != as_bytes(x)).sum() for o, x in zip(out, layer))
                           for out, layer in zip(outs, layers)]).tolist()
    bad_d = {i for i, w in enumerate(wrong_d) if w}
    nbytes = [[x.numel() * x.element_size() for x in layer] for layer in layers]
    failed_c = sum(1 for (i, _), s in zip(cc, c_sizes) if i in bad_c or s != want[i])
    failed_d = sum(1 for (i, _, _), s, st in zip(dc, d_sizes, d_status)
                   if i in bad_d or s != nbytes[i] or st != [1] * members)

    raw = [sum(b) for b in nbytes]
    c_name, d_name = PREFIX["torch_api"] + "compress", PREFIX["torch_api"] + "decompress"
    outcome = {
        "attempted": comp.calls + dec.calls,
        "failed": failed_c + failed_d,
        "end_to_end": {
            c_name + "_GBps": {"value": sum(raw[i] for i, _ in cc) / comp.wall_s / 1e9,
                               "unit": "GB/s"},
            d_name + "_GBps": {"value": sum(raw[i] for i, _, _ in dc) / dec.wall_s / 1e9,
                               "unit": "GB/s"},
            "setup_s": {"value": setup_s, "unit": "s"},
        },
        "checks": {
            "archive_bytes_wrong": {"value": arc_wrong, "limit": 0},
            "decoded_bytes_wrong": {"value": sum(wrong_d), "limit": 0},
            "failed_calls": {"value": failed_c + failed_d, "limit": 0},
        },
        "memory_peak_bytes": peak,
        "check_s": time.perf_counter() - t_check,
        "count": 1,
        "trace": None,
    }
    if trace_on:
        arc = [sum(max(s, 0) for s in want[i]) for i in range(n_layer)]
        per_c, per_d = Counter(i for i, _ in cc), Counter(i for i, _, _ in dc)

        def least(per, nbytes_of):
            return sum(c * work.least_seconds(nbytes_of(raw[i], arc[i])) for i, c in per.items())

        halves = {
            c_name: {"calls": comp.calls, "wall_s": comp.wall_s,
                     "least_s": least(per_c, work.compress_bytes),
                     "hist_least_s": least(per_c, lambda r, a: hist_bytes(r)), **comp.summary},
            d_name: {"calls": dec.calls, "wall_s": dec.wall_s,
                     "least_s": least(per_d, work.decompress_bytes),
                     "decode_raw_least_s": least(per_d, decode_raw_bytes), **dec.summary},
        }
        both = trace.merge([comp.summary, dec.summary])
        outcome["trace"] = {
            "ctx": {"cell": cell.name, "halves": halves},
            "busy_s": both["busy_s"],
            "window_s": both["window_s"],
            "breakdown": {"device_ops": trace.top(both["device_ops"]),
                          "idle_gaps": trace.top(both["idle_gaps"])},
        }
    return outcome
