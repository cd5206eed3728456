"""The codec cells: one caller in a closed loop over a pool of tensors.

The window has two halves. For the first, the caller compresses the pool's
tensors in turn; for the second, it decompresses the archives the first
half made, each into its own output. Each half ends in a synchronize, and
its rate is all the raw bytes of its calls over all of its time.

The mix's ``entry`` says how the program is called:

- ``graph``: ``float_compress_padded`` of each tensor, and
  ``float_decompress_padded`` of its archive, each captured once in a CUDA
  graph after an eager warm-up, and the graphs replayed back to back, as a
  user replays a captured step;
- ``torch_api``: ``torch_api.compress_data(True, [t])`` and
  ``torch_api.decompress_data`` in place, eagerly, with whatever host
  reads the front end makes.

After the window every tensor's archive (the last its half made) is held
byte for byte against the reference's, and its decoded words word for word
against the input; every call's own size or status against what it should
be.
"""

import time
from collections import Counter

import torch

from .. import device, inputs, sut as sut_mod, trace, work
from ..reference import floatref

FLOAT_TYPES = {"float16": floatref.FLOAT16, "bfloat16": floatref.BFLOAT16,
               "float32": floatref.FLOAT32}
OVERFLOW = 1 << 31


def _sentinel(t: torch.Tensor) -> None:
    """Fill an output so that only what a call of the window writes into
    it can pass the check."""
    t.view(torch.uint8).fill_(0xA5)


class GraphEntry:
    """``float_compress_padded`` / ``float_decompress_padded`` of each
    tensor, captured in CUDA graphs where the program and the device allow,
    else called as they are."""

    def __init__(self, sut, xs, float_type, prob_bits, capture):
        self.sut, self.ft, self.pb, self.capture = sut, float_type, prob_bits, capture
        self.words = [inputs.words(x) for x in xs]
        self.n = xs[0].numel()
        self.arcs, self.sizes, self.decoded = [None] * len(xs), [None] * len(xs), [None] * len(xs)
        self.graphs = {}

    def _compress(self, i):
        self.arcs[i], self.sizes[i] = self.sut.float_compress_padded(
            self.words[i], self.n, self.ft, self.pb)

    def _decompress(self, i):
        self.decoded[i] = self.sut.float_decompress_padded(
            self.arcs[i], self.ft, floatref.round_up(self.n, floatref.BLOCK), self.pb,
            static_length=self.n)

    def warm(self):
        for i in range(len(self.words)):
            for kind, fn in (("compress", self._compress), ("decompress", self._decompress)):
                fn(i)  # eager: loads the kernels and the geometry on the card
                if self.capture:
                    g = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(g):
                        fn(i)
                    g.replay()
                    self.graphs[kind, i] = g
        for i in range(len(self.words)):
            _sentinel(self.arcs[i])
            _sentinel(self.decoded[i]["out32"])

    def compress(self, i):
        if self.capture:
            self.graphs["compress", i].replay()
        else:
            self._compress(i)

    def decompress(self, i):
        if self.capture:
            self.graphs["decompress", i].replay()
        else:
            self._decompress(i)

    def results(self):
        """Per tensor (archive uint8 or None on overflow, decoded words,
        decode ok); every call's own verdict is its tensor's."""
        out = []
        for i in range(len(self.words)):
            size = int(self.sizes[i])
            arc = None if size & OVERFLOW else self.arcs[i].view(torch.uint8)[:size].clone()
            d = self.decoded[i]
            words = d["out32"].view(self.words[i].dtype)[: self.n].clone()
            out.append((arc, words, bool(d["success"]) and int(d["size"]) == self.n))
        self.graphs.clear()
        return out, [], []


class ApiEntry:
    """``torch_api.compress_data`` and ``torch_api.decompress_data`` (in
    place) of each tensor, eagerly."""

    def __init__(self, sut, xs, float_type, prob_bits, capture):
        self.sut, self.xs, self.pb = sut, xs, prob_bits
        self.outs = [torch.empty_like(x) for x in xs]
        self.comps, self.last_size = [None] * len(xs), [None] * len(xs)
        self.compress_calls, self.decompress_calls = [], []

    def warm(self):
        for i in range(len(self.xs)):
            self.compress(i)
            self.decompress(i)
        for o in self.outs:
            _sentinel(o)
        self.compress_calls.clear()
        self.decompress_calls.clear()

    def compress(self, i):
        comp, sizes, _ = self.sut.compress_data(True, [self.xs[i]], False, self.pb)
        self.comps[i], self.last_size[i] = comp, sizes
        self.compress_calls.append((i, sizes))

    def decompress(self, i):
        status, sizes, _ = self.sut.decompress_data(
            True, [self.comps[i][0]], [self.outs[i]], False, self.pb)
        self.decompress_calls.append((i, status, sizes))

    def results(self):
        out = []
        for i, x in enumerate(self.xs):
            size = int(self.last_size[i][0])
            arc = None if size < 0 else self.comps[i][0, :size].clone()
            out.append((arc, inputs.words(self.outs[i]), True))
        comp_calls = [(i, int(s[0])) for i, s in self.compress_calls]
        dec_calls = [(i, int(st[0]) == 1 and int(s[0]) == self.xs[i].numel()
                      * self.xs[i].element_size()) for i, st, s in self.decompress_calls]
        self.comps = [None] * len(self.xs)
        return out, comp_calls, dec_calls


ENTRIES = {"graph": GraphEntry, "torch_api": ApiEntry}
# the end-to-end metrics of an entry are named by its calls: a replayed
# entry point and the eager front end spread differently between runs, so
# each has bounds of its own
PREFIX = {"graph": "", "torch_api": "api_"}


class Half:
    def __init__(self, calls, wall_s, summary):
        self.calls, self.wall_s, self.summary = calls, wall_s, summary


def timed_half(label, call, pool, seconds, dev, traced) -> Half:
    """Call call(0), call(1), ... round the pool for `seconds` (and at
    least once a tensor), then synchronize."""
    with trace.Window(label, traced) as w:
        t0 = time.perf_counter()
        calls = 0
        while calls < pool or time.perf_counter() - t0 < seconds:
            call(calls % pool)
            calls += 1
        device.sync(dev)
        wall = time.perf_counter() - t0
    return Half(calls, wall, w.summary)


def mismatch(got, want) -> int:
    """Bytes (or words) of `want` that `got` does not hold: the differing
    ones of the common length and every one past it; all of `want` when
    there is nothing."""
    if got is None:
        return want.numel()
    m = min(got.numel(), want.numel())
    return int((got[:m] != want[:m]).sum()) + abs(got.numel() - want.numel())


def run(cell, seed, seconds, trace_on, sut_spec, dev, t_start) -> dict:
    """One run of a codec cell on `dev`; see ``portbench.run`` for what it
    returns."""
    cfg, tr = cell.config, cell.traffic
    if cfg.get("checksum"):
        raise ValueError("the codec cells' reference writes no checksum")
    dtype, ft, pb = inputs.DTYPES[cfg["dtype"]], FLOAT_TYPES[cfg["dtype"]], cfg["prob_bits"]
    n, pool = tr["words"], tr["pool"]
    mean, std = cfg["init"]["mean"], cfg["init"]["std"]
    xs = [inputs.normal(n, dtype, mean, std, dev, seed, i) for i in range(pool)]
    sut = sut_mod.load(sut_spec)
    entry = ENTRIES[tr["entry"]](sut, xs, ft, pb, dev.type == "cuda" and sut.capturable)
    entry.warm()
    device.sync(dev)
    setup_s = time.perf_counter() - t_start

    half_s = tr["trace_seconds"] if trace_on else seconds / 2
    comp = timed_half("compress", entry.compress, pool, half_s, dev, trace_on)
    dec = timed_half("decompress", entry.decompress, pool, half_s, dev, trace_on)
    peak = device.memory_peak(dev)
    t_check = time.perf_counter()

    results, comp_calls, dec_calls = entry.results()
    del entry
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    arc_wrong = words_wrong = 0
    sizes, ref_sizes, bad_c, bad_d = [], [], set(), set()
    for i, (arc, got, ok) in enumerate(results):
        w = inputs.words(xs[i])
        ref = floatref.float_archive(w, ft, pb)
        ref_sizes.append(ref.numel())
        sizes.append(ref.numel() if arc is None else arc.numel())
        a, b = mismatch(arc, ref), mismatch(got, w)
        arc_wrong += a
        words_wrong += b
        if a:
            bad_c.add(i)
        if b or not ok:
            bad_d.add(i)
        del ref
    if comp_calls:  # a call whose own size is not its tensor's archive's failed
        failed_c = sum(1 for i, s in comp_calls if i in bad_c or s != ref_sizes[i])
        failed_d = sum(1 for i, ok in dec_calls if i in bad_d or not ok)
    else:
        failed_c = sum(c for i, c in Counter(k % pool for k in range(comp.calls)).items()
                       if i in bad_c)
        failed_d = sum(c for i, c in Counter(k % pool for k in range(dec.calls)).items()
                       if i in bad_d)

    raw = n * xs[0].element_size()
    c_name, d_name = PREFIX[tr["entry"]] + "compress", PREFIX[tr["entry"]] + "decompress"
    outcome = {
        "attempted": comp.calls + dec.calls,
        "failed": failed_c + failed_d,
        "end_to_end": {
            c_name + "_GBps": {"value": raw * comp.calls / comp.wall_s / 1e9, "unit": "GB/s"},
            d_name + "_GBps": {"value": raw * dec.calls / dec.wall_s / 1e9, "unit": "GB/s"},
            "setup_s": {"value": setup_s, "unit": "s"},
        },
        "checks": {
            "archive_bytes_wrong": {"value": arc_wrong, "limit": 0},
            "decoded_words_wrong": {"value": words_wrong, "limit": 0},
            "failed_calls": {"value": failed_c + failed_d, "limit": 0},
        },
        "memory_peak_bytes": peak,
        "check_s": time.perf_counter() - t_check,
        "count": 1,
        "trace": None,
    }
    if trace_on:
        def least(half, nbytes):
            per = Counter(k % pool for k in range(half.calls))
            return sum(c * work.least_seconds(nbytes(raw, sizes[i])) for i, c in per.items())

        halves = {
            c_name: {"calls": comp.calls, "wall_s": comp.wall_s,
                     "least_s": least(comp, work.compress_bytes), **comp.summary},
            d_name: {"calls": dec.calls, "wall_s": dec.wall_s,
                     "least_s": least(dec, work.decompress_bytes), **dec.summary},
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
