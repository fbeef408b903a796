"""Multi-process set-up (counterpart of
``lemas_tts_tpu/parallel/distributed.py``).

JAX runs one controller per host over its local chips; the PyTorch idiom is
one process per GPU, started by ``torchrun --nproc_per_node N``, which sets
``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``/``LOCAL_RANK``.
Every process then runs the same program (SPMD) over a ``DeviceMesh``::

    from lemas_tts_tpu_torch.parallel.distributed import initialize
    from lemas_tts_tpu_torch.parallel.mesh import make_mesh
    initialize()                    # reads torchrun's environment
    mesh = make_mesh()              # ("data", "model") over every process

``device_type=None`` means CUDA (NCCL) and raises without it; ``"cpu"``
runs the process group on gloo.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def resolve_device_type(device_type: Optional[str]) -> str:
    """``None`` -> ``"cuda"``, which raises when CUDA is absent; ``"cpu"``
    as asked."""
    device_type = device_type or "cuda"
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type {device_type!r}: only 'cuda' and 'cpu' are supported")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh needs CUDA, but torch.cuda.is_available() is false; "
                           "pass device_type='cpu' for a gloo mesh on the CPU")
    return device_type


def backend_for(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device_type: Optional[str] = None) -> bool:
    """Join the multi-process job: ``coordinator_address`` ("host:port"),
    ``num_processes`` and ``process_id`` override torchrun's ``MASTER_ADDR``/
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``. Returns True when a process
    group is up (also when it already was), False when no job is configured
    (a single process: nothing to do). A configured job that fails to join
    raises: a process carrying on alone would serve or write on its own. On
    CUDA the process takes the GPU ``LOCAL_RANK``."""
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if coordinator_address is None:
        return False  # single-process run
    if num_processes is None:
        num_processes = int(env["WORLD_SIZE"]) if "WORLD_SIZE" in env else None
    if process_id is None:
        process_id = int(env["RANK"]) if "RANK" in env else None
    if num_processes is None or process_id is None:
        raise ValueError(f"a job at {coordinator_address} needs its size and this process's "
                         "rank: set WORLD_SIZE and RANK (torchrun does) or pass "
                         "num_processes and process_id")
    device_type = resolve_device_type(device_type)
    if device_type == "cuda":
        local = int(env.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend_for(device_type), init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id))
    return True


def is_primary() -> bool:
    """True on process 0 (and in a single process): gate writes and logs."""
    return not dist.is_initialized() or dist.get_rank() == 0
