"""Multi-card scaling on torch.distributed: the shard codec and the
compressed collectives (counterpart of ``dietgpu_tpu.parallel``)."""

from .collectives import (  # noqa: F401
    compressed_all_gather,
    compressed_all_gather_auto,
    compressed_all_reduce,
    compressed_all_to_all,
    compressed_ppermute,
    compressed_reduce_scatter,
)
from .runtime import initialize_process_group  # noqa: F401
from .sharding import make_group, shard_compress, shard_decompress  # noqa: F401
