"""dietTPU's float codec and raw-ANS byte codec in PyTorch and CUDA, for the
NVIDIA H100.

A port of ``dietgpu_tpu`` that imports neither JAX nor the JAX package.
Tensors on the card go through hand-written CUDA kernels (``csrc/``, built
with nvcc for sm_90a on first use); tensors on the CPU go through the
kernels' plain torch versions. Archives are byte-compatible with the JAX
package's. The ``*_batched`` entry points take B members as rows of one
tensor and launch each kernel once for the whole batch. ``api`` is the
ten-op batch API over them and ``torch_api`` the same ops with the
reference's in-place tensor contract; ``join_words_packed`` and
``join_words_packed_f32`` turn packed float planes back into words. The
shard codec and the compressed collectives on torch.distributed are in
``dietgpu_tpu_torch.parallel``.
"""

from . import api, torch_api
from ._build import kernel_launches, reset_kernel_launches
from .ans.cuda_decode import ans_decode_batched, ans_decode_padded
from .ans.cuda_encode import ans_encode_batched, ans_encode_padded
from .ans.cuda_hist import histogram_u8
from .floatcodec.codec import (
    float_archive_buffer_bytes,
    float_compress,
    float_compress_batched,
    float_compress_padded,
    float_decompress,
    float_decompress_batched,
    float_decompress_padded,
)
from .floatcodec.cuda_float import join_words_packed, join_words_packed_f32

__all__ = [
    "ans_decode_batched",
    "api",
    "ans_decode_padded",
    "ans_encode_batched",
    "ans_encode_padded",
    "float_archive_buffer_bytes",
    "float_compress",
    "float_compress_batched",
    "float_compress_padded",
    "float_decompress",
    "float_decompress_batched",
    "float_decompress_padded",
    "histogram_u8",
    "join_words_packed",
    "join_words_packed_f32",
    "kernel_launches",
    "reset_kernel_launches",
    "torch_api",
]
