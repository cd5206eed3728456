"""What a run says of the card and of the modules it loaded."""

import subprocess
import sys

import torch

# top-level module names that no process of a run may hold: JAX and the
# JAX package, whose name the port's only begins with
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "dietgpu_tpu")


class NoCard(RuntimeError):
    """The run found fewer cards than its cell asks for."""


def require_cards(count: int) -> None:
    if not torch.cuda.is_available():
        raise NoCard("no CUDA device: the benchmark runs only on the card")
    if torch.cuda.device_count() < count:
        raise NoCard(f"the cell needs {count} CUDA devices, found {torch.cuda.device_count()}")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN_MODULES, compared whole."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN_MODULES)


def power_limit() -> str:
    """The card's power limit as nvidia-smi prints it ("700.00 W"), or
    "not read"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.strip().splitlines()[0] if out.strip() else "not read"


def describe(count: int, memory_peak_bytes: int, power: str) -> dict:
    """The result's `device`: the card's name, the cards used, the peak on
    the fullest, and the power limit."""
    if torch.cuda.is_available():
        platform, kind = "gpu", torch.cuda.get_device_name(0)
    else:
        platform, kind = "cpu", "cpu"
    return {"platform": platform, "kind": kind, "count": count,
            "memory_peak_bytes": int(memory_peak_bytes), "power_limit": power}


def memory_peak(dev) -> int:
    """The peak of device memory allocated by this process, 0 on the CPU."""
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
