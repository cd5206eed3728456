"""The control: the reference put in the program's place and computed one
precision below the configuration's, the step that would tempt a later
change (bfloat16 and float16 words through float8 e4m3; float32 words
through bfloat16). Its archives are the reference's archives of the
rounded words, its decode hands back the rounded words (what decoding its
own archive gives), and its all-gather moves the rounded shards raw. A
run with it in the program's place has to come out not correct.

``portbench.control`` runs it at a cell's own size on the card.
"""

from collections import OrderedDict
from types import SimpleNamespace

import torch
import torch.distributed as dist

from . import floatref

_FLOAT = {floatref.FLOAT16: torch.float16, floatref.BFLOAT16: torch.bfloat16,
          floatref.FLOAT32: torch.float32}
LOWER = {torch.float16: torch.float8_e4m3fn, torch.bfloat16: torch.float8_e4m3fn,
         torch.float32: torch.bfloat16}


def lower(x: torch.Tensor) -> torch.Tensor:
    """x (a float tensor) rounded to the precision below and back."""
    return x.to(LOWER[x.dtype]).to(x.dtype)


def lower_words(words: torch.Tensor, float_type: int) -> torch.Tensor:
    return lower(words.view(_FLOAT[float_type])).view(words.dtype)


def lower_precision():
    decoded = OrderedDict()  # an archive's data pointer -> the words it holds

    def keep(arc, w):
        decoded[arc.data_ptr()] = w
        decoded.move_to_end(arc.data_ptr())
        while len(decoded) > 16:  # more than the archives a run keeps
            decoded.popitem(last=False)

    def float_compress_padded(words, length, float_type, prob_bits=10, use_checksum=False):
        w = lower_words(words[:length], float_type)
        arc = floatref.float_archive(w, float_type, prob_bits)
        keep(arc, w)
        return arc.view(torch.int32), torch.tensor(arc.numel(), device=words.device)

    def float_decompress_padded(archive, float_type, out_max_words, prob_bits=10,
                                verify_checksum=False, static_length=None):
        w = decoded[archive.data_ptr()]
        out = torch.zeros(out_max_words, dtype=w.dtype, device=w.device)
        out[: w.numel()] = w
        dev = archive.device
        return {"out32": out.view(torch.int32), "size": torch.tensor(w.numel(), device=dev),
                "success": torch.tensor(True, device=dev),
                "checksum_ok": torch.tensor(True, device=dev)}

    def compress_data(as_float, ts, checksum=False, prob_bits=10):
        (t,) = ts
        w = lower(t.reshape(-1)).view(torch.int32 if t.element_size() == 4 else torch.int16)
        ft = {v: k for k, v in _FLOAT.items()}[t.dtype]
        arc = floatref.float_archive(w, ft, prob_bits)
        keep(arc, w)
        sizes = torch.tensor([arc.numel()], dtype=torch.int32, device=t.device)
        return arc[None], sizes, 0

    def decompress_data(as_float, ts_in, ts_out, checksum=False, prob_bits=10):
        (arc,), (out,) = ts_in, ts_out
        w = decoded[arc.data_ptr()]
        out.view(w.dtype).view(-1).copy_(w)
        dev = out.device
        return (torch.ones(1, dtype=torch.uint8, device=dev),
                torch.tensor([out.numel() * out.element_size()], dtype=torch.int32, device=dev), 0)

    def compressed_all_gather(x, group=None, budget_bytes=None, prob_bits=10):
        y = lower(x)
        full = torch.empty(dist.get_world_size(group) * y.numel(), dtype=y.dtype, device=y.device)
        dist.all_gather_into_tensor(full, y, group=group)
        return full, True

    return SimpleNamespace(
        name="control", capturable=False,
        float_compress_padded=float_compress_padded,
        float_decompress_padded=float_decompress_padded,
        compress_data=compress_data, decompress_data=decompress_data,
        compressed_all_gather=compressed_all_gather)
