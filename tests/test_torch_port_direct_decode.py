"""``torch_api.decompress_data`` decoding each member straight into its
destination: the rule that chooses it, its counters, and its results held
bit for bit against the staged route (archives copied into a zero-filled
buffer, the status read back, the members copied out), the port's CPU
route and the JAX package.

The rule (``torch_api.decodes_in_place``) is a function of what the call's
tensors are: no checksum, contiguous destinations of whole symbols,
archives that can be read where they lie, and no destination overlapping
an archive or another destination. Each scenario below names the
outputs it starts from (a sentinel, so that a write or its absence shows).
The CPU cases hold the in-place route against the JAX package; the cases
marked `gpu` run it on the card against the staged route on the card and
the CPU route, and import nothing of JAX.
"""

import numpy as np
import pytest
import torch

from dietgpu_tpu_torch import _build, api, profiling
from dietgpu_tpu_torch import torch_api as ptapi
from dietgpu_tpu_torch.ans import cuda_decode
from torch_port_helpers import cuda_device  # noqa: F401

SENTINEL = 0x5A


def _normal(n, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    return torch.from_numpy(x).to(dtype)


def _exp_bytes(n, seed):
    x = np.minimum(np.random.default_rng(seed).exponential(30, n), 255).astype(np.uint8)
    return torch.from_numpy(x)


def _archives(compress_as_float, ts):
    """Each member's archive, as an exact-size uint8 tensor of its own."""
    comp, sizes, _ = api.compress_data(compress_as_float, ts)
    return [comp[b, :s].clone() for b, s in enumerate(sizes.tolist())]


def _edit(arc, word, value):
    """`arc` with u32 word `word` set to `value`."""
    arc = arc.clone()
    arc.view(torch.int32)[word] = np.array(value, np.uint32).view(np.int32).item()
    return arc


def _sentinel(n, dtype):
    return torch.full((n * torch.empty((), dtype=dtype).element_size(),), SENTINEL,
                      dtype=torch.uint8).view(dtype)


def _bytes(t):
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)


# ---------------------------------------------------------------------------
# scenarios: (compress_as_float, archives, outputs, aliased)
# ---------------------------------------------------------------------------


def _ragged(dtype, lens):
    ts = [_normal(n, dtype, i) for i, n in enumerate(lens)]
    return True, _archives(True, ts), [_sentinel(n, dtype) for n in lens], False


RAW_LENS = [26000, 4096, 300, 1]


def _raw_inputs():
    return [_exp_bytes(n, i) for i, n in enumerate(RAW_LENS)]


def _raw_ragged():
    return (False, _archives(False, _raw_inputs()),
            [_sentinel(n, torch.uint8) for n in RAW_LENS], False)


def _too_small():
    """The second output holds 96 words fewer than its archive: status 0,
    and its sentinel stays."""
    lens = [10000, 4096]
    ca, arcs, _, _ = _ragged(torch.bfloat16, lens)
    return ca, arcs, [_sentinel(10000, torch.bfloat16), _sentinel(4000, torch.bfloat16)], False


def _larger(dtype):
    """Outputs larger than their archives' counts: zeros past the count."""
    lens = [5000, 300]
    if dtype == torch.uint8:
        arcs = _archives(False, [_exp_bytes(n, i) for i, n in enumerate(lens)])
    else:
        arcs = _ragged(dtype, lens)[1]
    return dtype != torch.uint8, arcs, [_sentinel(5003, dtype), _sentinel(9000, dtype)], False


def _lying_header():
    """Raw archives whose headers lie: more blocks than the archive holds
    (the block table is read past the archive's end), and a byte count
    below the true one; a third member is sound."""
    lens = [26000, 5000, 5000]
    arcs = _archives(False, [_exp_bytes(n, i) for i, n in enumerate(lens)])
    arcs[0] = _edit(arcs[0], 1, 255)
    arcs[1] = _edit(arcs[1], 2, 3000)
    return False, arcs, [_sentinel(n, torch.uint8) for n in lens], False


def _short_archive():
    """Archives cut short of their size, far shorter than the decode
    width's buffer: one inside its header, one inside its payload."""
    lens = [10000, 12000]
    arcs = _ragged(torch.bfloat16, lens)[1]
    arcs = [arcs[0][:300].clone(), arcs[1][: arcs[1].numel() * 3 // 5 // 4 * 4].clone()]
    return True, arcs, [_sentinel(n, torch.bfloat16) for n in lens], False


def _past_the_inline_table():
    """129 members, one more than a launch carries in its parameters."""
    lens = [40 + 37 * i for i in range(129)]
    arcs = _archives(False, [_exp_bytes(n, i) for i, n in enumerate(lens)])
    return False, arcs, [_sentinel(n, torch.uint8) for n in lens], False


def _aliased():
    """A destination that shares its bytes with its own archive: staged."""
    arcs = _archives(False, [_exp_bytes(3000, 0)])
    return False, arcs, [_sentinel(3000, torch.uint8)], True


SCENARIOS = {
    "raw_ragged": _raw_ragged,
    "bf16_ragged": lambda: _ragged(torch.bfloat16, [10000, 4096, 77, 1]),
    "f32_ragged": lambda: _ragged(torch.float32, [5000, 8192, 3]),
    "too_small": _too_small,
    "larger_raw": lambda: _larger(torch.uint8),
    "larger_f16": lambda: _larger(torch.float16),
    "lying_header": _lying_header,
    "short_archive": _short_archive,
    "129_members": _past_the_inline_table,
    "aliased": _aliased,
}


def _tensors(scenario, device):
    """The scenario's archives and outputs on `device`; an aliased one's
    first output is a view of the buffer its first archive lies in."""
    ca, arcs, outs, aliased = scenario
    ts_in = [a.to(device) for a in arcs]
    ts_out = [o.clone().to(device) for o in outs]
    if aliased:
        n = max(arcs[0].numel(), _bytes(outs[0]).numel())
        buf = torch.full((n,), SENTINEL, dtype=torch.uint8, device=device)
        buf[: arcs[0].numel()] = ts_in[0]
        ts_in[0] = buf[: arcs[0].numel()]
        ts_out[0] = buf[: _bytes(outs[0]).numel()].view(outs[0].dtype)
    return ca, ts_in, ts_out


def _decompress(scenario, device, staged=False, monkeypatch=None):
    """torch_api.decompress_data of the scenario: (status, sizes,
    temp_mem, each output's bytes); `staged` forces the buffer route,
    archives copied included."""
    ca, ts_in, ts_out = _tensors(scenario, device)
    if staged:
        monkeypatch.setattr(ptapi, "decodes_in_place", lambda *a: False)
        monkeypatch.setattr(cuda_decode, "takes_members", lambda *a: False)
    else:
        assert ptapi.decodes_in_place(ca, ts_in, ts_out, False) == (not scenario[3])
    st, sz, tm = ptapi.decompress_data(ca, ts_in, ts_out)
    if staged:
        monkeypatch.undo()
    return st.tolist(), sz.tolist(), tm, [_bytes(o) for o in ts_out]


def _same(a, b):
    assert a[:3] == b[:3]
    for x, y in zip(a[3], b[3]):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------


def _rule_case(name):
    """(compress_as_float, ts_in, ts_out, checksum, expected) for one
    condition of the rule."""
    ca, arcs, outs, _ = _raw_ragged()
    checksum = False
    if name == "checksum":
        checksum = True
    elif name == "destination_not_contiguous":
        outs[0] = torch.zeros((outs[0].numel(), 2), dtype=torch.uint8)[:, 0]
    elif name == "archive_misaligned":
        buf = torch.zeros(arcs[0].numel() + 4, dtype=torch.uint8)
        buf[2 : 2 + arcs[0].numel()] = arcs[0]
        arcs[0] = buf[2 : 2 + arcs[0].numel()]
    elif name == "archive_not_whole_words":
        arcs[0] = torch.cat([arcs[0], torch.zeros(2, dtype=torch.uint8)])
    elif name == "archive_not_contiguous":
        arcs[0] = torch.stack([arcs[0], arcs[0]], 1)[:, 0]
    elif name == "destination_overlaps_archive":
        n = arcs[0].numel()
        buf = torch.zeros(n + outs[0].numel(), dtype=torch.uint8)
        buf[:n] = arcs[0]
        arcs[0], outs[0] = buf[:n], buf[n - 4 : n - 4 + outs[0].numel()]
    elif name == "destinations_overlap":
        buf = torch.zeros(outs[0].numel() + outs[1].numel(), dtype=torch.uint8)
        outs[0] = buf[: outs[0].numel()]
        outs[1] = buf[outs[0].numel() - 1 : outs[0].numel() - 1 + outs[1].numel()]
    elif name == "archives_share_bytes":  # archives may: they are only read
        arcs[1] = arcs[0]
    elif name == "float_words_of_another_size":
        ca, arcs, outs, _ = _ragged(torch.bfloat16, [5000, 300])
        outs[1] = torch.zeros(150, dtype=torch.float32)
    elif name == "float_words":
        ca, arcs, outs, _ = _ragged(torch.bfloat16, [5000, 300])
    want = name in ("plain", "archives_share_bytes", "float_words")
    return ca, arcs, outs, checksum, want


RULE_CASES = ["plain", "checksum", "destination_not_contiguous", "archive_misaligned",
              "archive_not_whole_words", "archive_not_contiguous",
              "destination_overlaps_archive", "destinations_overlap", "archives_share_bytes",
              "float_words", "float_words_of_another_size"]


@pytest.mark.parametrize("name", RULE_CASES)
def test_the_rule_for_decoding_in_place(name):
    """One condition at a time; every other holds."""
    ca, ts_in, ts_out, checksum, want = _rule_case(name)
    assert ptapi.decodes_in_place(ca, ts_in, ts_out, checksum) is want


@pytest.mark.parametrize("name", ["checksum", "destination_not_contiguous",
                                  "archive_misaligned", "destination_overlaps_archive"])
def test_a_call_the_rule_refuses_is_staged_and_still_right(name):
    """The staged route takes over with the same results: each output holds
    its member's bytes, and no member counts as decoded in place."""
    ca, ts_in, ts_out, checksum, _ = _rule_case(name)
    before = profiling.counter(profiling.DIRECT_MEMBERS)
    st, _, _ = ptapi.decompress_data(ca, ts_in, ts_out, checksum)
    assert profiling.counter(profiling.DIRECT_MEMBERS) == before
    assert st.tolist() == [1] * len(ts_in)
    assert all(torch.equal(_bytes(o), x) for o, x in zip(ts_out, _raw_inputs()))


@pytest.mark.parametrize("name", ["archive_misaligned", "archive_not_whole_words",
                                  "archive_not_contiguous", "destination_not_contiguous"])
def test_the_member_decode_refuses_what_the_rule_refuses(name):
    """The descriptor form and the rule share one predicate: the member
    decode raises where a call's tensors fail it, before any decode."""
    _, ts_in, ts_out, _, _ = _rule_case(name)
    assert not cuda_decode.takes_members(ts_in, ts_out)
    with pytest.raises(ValueError, match="takes_members"):
        cuda_decode.decode_members(ts_in, 2048, 1 << 15, 10, None, ts_out)


def test_the_functional_decompress_reads_archives_in_place_only_where_it_can():
    """``api.decompress_data`` without a checksum reads each archive where it
    lies when the predicate holds, else stages it (no copy bytes counted,
    then some); both give the input back."""
    _, arcs, outs, _ = _raw_ragged()
    buf = torch.zeros(arcs[0].numel() + 4, dtype=torch.uint8)
    buf[2 : 2 + arcs[0].numel()] = arcs[0]
    for ts_in, staged in ((arcs, False), ([buf[2 : 2 + arcs[0].numel()], *arcs[1:]], True)):
        before = profiling.counter(profiling.COPY_BYTES)
        got, st, _, _ = api.decompress_data(False, ts_in, outs)
        assert (profiling.counter(profiling.COPY_BYTES) > before) is staged
        assert st.tolist() == [1] * len(arcs)
        assert all(torch.equal(_bytes(g), x) for g, x in zip(got, _raw_inputs()))


def test_an_in_place_call_reads_nothing_back_and_copies_nothing():
    """The counters of an in-place call: every member decoded straight into
    its destination, no host read and no front-end copy; all in the call's
    spans."""
    ca, ts_in, ts_out = _tensors(_raw_ragged(), "cpu")
    names = (profiling.DIRECT_MEMBERS, profiling.HOST_READS, profiling.COPY_BYTES)
    before = [profiling.counter(n) for n in names]
    with profiling.record_spans() as rec:
        st, _, _ = ptapi.decompress_data(ca, ts_in, ts_out)
    got = [profiling.counter(n) - b for n, b in zip(names, before)]
    assert got == [len(ts_in), 0, 0]
    counts = [sum((s["counts"] or {}).get(n, 0) for s in rec.spans()) for n in names]
    assert counts == got
    assert st.tolist() == [1] * len(ts_in)


# ---------------------------------------------------------------------------
# results: the CPU against the JAX package, the card against both routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_in_place_matches_the_jax_package(name):
    """The port's in-place route on the CPU against ``dietgpu_tpu.torch_api``
    on the same tensors: status, sizes, temp_mem and every output byte."""
    from dietgpu_tpu import torch_api as jtapi

    scenario = SCENARIOS[name]()
    got = _decompress(scenario, "cpu")
    ca, ts_in, ts_out = _tensors(scenario, "cpu")
    st, sz, tm = jtapi.decompress_data(ca, ts_in, ts_out)
    _same(got, (st.tolist(), sz.tolist(), tm, [_bytes(o) for o in ts_out]))
    if name == "too_small":
        assert got[0] == [1, 0] and torch.equal(got[3][1], _bytes(scenario[2][1]))
    if name.startswith("larger"):
        assert got[0] == [1, 1] and not got[3][1][-100:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_in_place_on_the_card_matches_the_staged_route(cuda_device, monkeypatch, name):
    """The card's in-place route against its staged route and the CPU's
    in-place route (held against the JAX package above), bit for bit; one
    decode launch and no host read where the rule holds."""
    scenario = SCENARIOS[name]()
    _build.reset_kernel_launches()
    reads = profiling.counter(profiling.HOST_READS)
    card = _decompress(scenario, cuda_device)
    launches = _build.kernel_launches()
    assert launches["decode"] + launches["decode_f32"] + launches["decode_raw"] == 1
    if not scenario[3]:
        # the reads the test itself makes: status and sizes, then each output
        assert profiling.counter(profiling.HOST_READS) == reads
    staged = _decompress(scenario, cuda_device, staged=True, monkeypatch=monkeypatch)
    cpu = _decompress(scenario, "cpu")
    _same(card, staged)
    _same(card, cpu)


@pytest.mark.gpu
def test_a_checksum_mismatch_raises_with_outputs_untouched_on_the_card(cuda_device):
    """A checksum call is staged: a corrupt member raises, and no output is
    written, the sound member's neither."""
    ts = [_normal(n, torch.bfloat16, i) for i, n in enumerate([10000, 4096])]
    comp, sizes, _ = api.compress_data(True, ts, checksum=True)
    arcs = [comp[b, :s].clone() for b, s in enumerate(sizes.tolist())]
    arcs[1] = _edit(arcs[1], 3, 12345)  # the stored checksum
    ts_in = [a.to(cuda_device) for a in arcs]
    ts_out = [_sentinel(t.numel(), torch.bfloat16).to(cuda_device) for t in ts]
    assert not ptapi.decodes_in_place(True, ts_in, ts_out, True)
    with pytest.raises(ValueError, match="checksum"):
        ptapi.decompress_data(True, ts_in, ts_out, True)
    assert all(bool((_bytes(o) == SENTINEL).all()) for o in ts_out)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_strided_form_reads_nothing_past_a_short_row_on_the_card(cuda_device, dtype):
    """The strided form, beside which the descriptor form was added: rows
    far shorter than their planes (a lying header's count, and a container
    cut to 64 words) read zeros past the row, as the plain version does."""
    from dietgpu_tpu_torch.ans import cuda_decode
    from dietgpu_tpu_torch.floatcodec.codec import _TYPES

    ft = _TYPES[dtype]
    arcs = _ragged(dtype, [4096, 3000])[1]
    rows = torch.zeros((2, 64), dtype=torch.int32)
    for m, a in enumerate(arcs):
        rows[m] = a[:256].view(torch.int32)
    rows[1, 1] = 4096  # a count whose planes lie far past the row
    got = cuda_decode.decode_float_batched_cuda(rows.to(cuda_device), ft, 4096, 10)
    want = cuda_decode.decode_float_batched_plain(rows, ft, 4096, 10)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [3, 129])
def test_the_functional_decompress_captures_on_the_card(cuda_device, B):
    """``api.decompress_data`` without a checksum, captured in a CUDA graph
    after an eager warm-up and replayed on new archives of the same row
    width, against eager calls and the inputs bit for bit: up to 128
    members by the descriptor form, whose table the launch carries; past
    that by the staged route, since a larger table would be copied from
    host memory that does not outlive the call. Inside the capture the
    member decode itself refuses 129 members."""
    lens = [40 + 37 * m for m in range(B)]
    data = [[_exp_bytes(n, 1000 * s + m).to(cuda_device) for m, n in enumerate(lens)]
            for s in range(3)]
    comps = [api.compress_data(False, ds)[0] for ds in data]
    static = comps[0].clone()
    outs = [torch.empty(n, dtype=torch.uint8, device=cuda_device) for n in lens]

    def dec(comp):
        got, st, sz, _ = api.decompress_data(False, list(comp.unbind(0)), outs)
        return [st, sz, *got]

    dec(static)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    _build.reset_kernel_launches()
    with torch.cuda.graph(g):
        res = dec(static)
        refused = not cuda_decode.takes_members(list(static.unbind(0)))
        if refused:
            with pytest.raises(ValueError, match="takes_members"):
                cuda_decode.decode_members(list(static.unbind(0)), static.shape[1] // 4,
                                           4096, 10)
    assert refused is (B > cuda_decode.INLINE)
    assert {k: v for k, v in _build.kernel_launches().items() if v} == {"decode_raw": 1}
    for comp, ds in zip(comps, data):
        static.copy_(comp)
        g.replay()
        want = dec(comp)
        torch.cuda.synchronize()
        for a, b in zip(res, want):
            assert torch.equal(a, b)
        assert all(torch.equal(o, d) for o, d in zip(res[2:], ds))
