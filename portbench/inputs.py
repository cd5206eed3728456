"""Inputs made on the device from the run's seed, in a few large calls."""

import numpy as np
import torch

DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16, "float32": torch.float32}
WORD = {2: torch.int16, 4: torch.int32}


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for the generator of the input at `path` of a run:
    the same (seed, path) always gives the same one."""
    ss = np.random.SeedSequence([seed % (1 << 64), *path])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def normal(n: int, dtype, mean: float, std: float, dev, seed: int, *path: int) -> torch.Tensor:
    """n words drawn from N(mean, std^2) in `dtype`, on `dev`."""
    g = torch.Generator(device=dev)
    g.manual_seed(sub_seed(seed, *path))
    return torch.empty(n, dtype=dtype, device=dev).normal_(mean, std, generator=g)


def words(x: torch.Tensor) -> torch.Tensor:
    """The raw words of a float tensor: int16 or int32, flat."""
    return x.reshape(-1).view(WORD[x.element_size()])
