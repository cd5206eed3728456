"""The control of the FP8 expert cells: the reference put in the program's
place and computed one precision below the configuration's, float8 e4m3
bytes through float8 e5m2 (one mantissa bit fewer) and back to e4m3. A
byte batch's archives are the reference's archives of the rounded bytes
(``floatref.ans_archive``), and its decode hands back the rounded bytes
(what decoding its own archive gives). Float batches and the other entry
points are the float cells' control. A run with it in the program's place
has to come out not correct.

Run it at a cell's own size on the card with ``portbench.run.execute`` and
the spec ``portbench.reference.control_fp8:lower_precision``.
"""

from collections import OrderedDict
from types import SimpleNamespace

import torch

from . import control, floatref

KEEP_ROWS = 1024  # more archive rows than a run keeps (40 layers of 24)


def lower(t: torch.Tensor) -> torch.Tensor:
    """A float8 e4m3 tensor rounded to e5m2 and back."""
    return t.to(torch.float8_e5m2).to(t.dtype)


def lower_precision():
    floats = control.lower_precision()
    decoded = OrderedDict()  # an archive row's data pointer -> the bytes it holds

    def compress_data(as_float, ts, checksum=False, prob_bits=10):
        if as_float:
            return floats.compress_data(as_float, ts, checksum, prob_bits)
        data = [lower(t).reshape(-1).view(torch.uint8) for t in ts]
        arcs = [floatref.ans_archive(d, prob_bits) for d in data]
        width = floatref.round_up(max(a.numel() for a in arcs), 16)
        comp = torch.zeros((len(ts), width), dtype=torch.uint8, device=ts[0].device)
        for m, (a, d) in enumerate(zip(arcs, data)):
            comp[m, : a.numel()] = a
            decoded[comp[m].data_ptr()] = d
            decoded.move_to_end(comp[m].data_ptr())
        while len(decoded) > KEEP_ROWS:
            decoded.popitem(last=False)
        sizes = torch.tensor([a.numel() for a in arcs], dtype=torch.int32, device=comp.device)
        return comp, sizes, 0

    def decompress_data(as_float, ts_in, ts_out, checksum=False, prob_bits=10):
        if as_float:
            return floats.decompress_data(as_float, ts_in, ts_out, checksum, prob_bits)
        for arc, out in zip(ts_in, ts_out):
            out.view(torch.uint8).view(-1).copy_(decoded[arc.data_ptr()])
        dev = ts_out[0].device
        return (torch.ones(len(ts_out), dtype=torch.uint8, device=dev),
                torch.tensor([o.numel() for o in ts_out], dtype=torch.int32, device=dev), 0)

    return SimpleNamespace(**{**vars(floats), "compress_data": compress_data,
                              "decompress_data": decompress_data})
