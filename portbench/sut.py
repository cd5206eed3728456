"""The system under test: the entry points of ``dietgpu_tpu_torch`` that
the cells drive, gathered in one object so that a test or a control can
put another in its place. A spec ``module:factory`` names a factory that
returns such an object; ``program`` is the port itself.
"""

import importlib
from types import SimpleNamespace


def program():
    import dietgpu_tpu_torch as port
    from dietgpu_tpu_torch import _build, torch_api
    from dietgpu_tpu_torch.parallel import collectives

    return SimpleNamespace(
        name="program",
        capturable=True,  # the entry points capture in a CUDA graph
        build=_build.build_all,
        float_compress_padded=port.float_compress_padded,
        float_decompress_padded=port.float_decompress_padded,
        compress_data=torch_api.compress_data,
        decompress_data=torch_api.decompress_data,
        compressed_all_gather=collectives.compressed_all_gather,
        default_budget_bytes=collectives.default_budget_bytes,
    )


PROGRAM = "portbench.sut:program"


def load(spec: str):
    module, _, factory = spec.partition(":")
    return getattr(importlib.import_module(module), factory)()
