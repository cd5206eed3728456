"""Process-group bootstrap for the compressed collectives.

Counterpart of ``dietgpu_tpu.parallel.runtime``. torch.distributed's model
is one process per card: every rank calls :func:`initialize_process_group`
once, and the collectives of :mod:`.collectives` and the shard codec of
:mod:`.sharding` then run over the default group (or a subgroup from
``make_group``). NCCL on the card is the default; ``backend="gloo"`` with
CPU tensors is the CPU route, which the tests use.

Typical launch (one process per card, e.g. under torchrun)::

    from dietgpu_tpu_torch.parallel import initialize_process_group
    initialize_process_group()   # RANK, WORLD_SIZE, MASTER_ADDR from the env

A tensor's device must match its group's backend: a CUDA tensor needs
NCCL and a CPU tensor gloo. Nothing is ever moved between them quietly.
"""

import os

import torch
import torch.distributed as dist

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def initialize_process_group(
    backend=None, init_method=None, world_size=None, rank=None, timeout=None
) -> bool:
    """Idempotent wrapper of ``torch.distributed.init_process_group``.

    Returns True if a process group was initialized (or already was), and
    False when no argument is given and none of RANK, WORLD_SIZE and
    MASTER_ADDR is set (a single-process caller can always call this
    first). `backend=None` means NCCL on the card ``cuda:LOCAL_RANK``
    (LOCAL_RANK, else the rank modulo the card count) and raises when
    there is no card; pass ``backend="gloo"`` for the CPU route. `timeout`
    is a ``datetime.timedelta`` that bounds every wait on a peer (torch's
    default when None).
    """
    if dist.is_initialized():
        return True
    args = (backend, init_method, world_size, rank, timeout)
    if all(a is None for a in args) and not any(k in os.environ for k in _ENV):
        return False
    if backend is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "initialize_process_group: no CUDA device for NCCL; "
                "pass backend='gloo' to run the collectives on the CPU"
            )
        r = rank if rank is not None else int(os.environ.get("RANK", 0))
        local = int(os.environ.get("LOCAL_RANK", r % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        backend = "nccl"
    kwargs = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(
        backend,
        init_method=init_method,
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank,
        **kwargs,
    )
    return True


def resolve_group(group):
    """`group`, or the default group for None; raises if there is none."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_process_group first")
    return dist.group.WORLD if group is None else group


def check_device(t: torch.Tensor, group, what: str) -> None:
    """Raise ValueError unless `t`'s device suits `group`'s backend: a CUDA
    tensor needs NCCL, a CPU tensor gloo."""
    backend = str(dist.get_backend(group)).lower()
    need = {"cuda": "nccl", "cpu": "gloo"}.get(t.device.type)
    if need is None or need not in backend:
        raise ValueError(
            f"{what}: a {t.device.type} tensor on a {backend} group; CUDA tensors "
            "go over NCCL and CPU tensors over gloo, and none is moved between them"
        )
