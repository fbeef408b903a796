"""Device mesh and data-parallel sampling (counterpart of the serving half
of ``lemas_tts_tpu/parallel/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the JAX axis
names, one process per device: ``("data", "model")`` here,
``("data", "seq")`` in ``parallel/sequence.py``. Every process runs the same
calls with the same inputs (SPMD); collectives run on NCCL for a CUDA mesh
and on gloo for a CPU mesh. Where no process group is up and no job is
configured (``distributed.initialize`` returns False), a mesh is built over
a process group of one, so ``TTS(mesh=make_mesh())`` also runs in a plain
single process, as the JAX mesh over one chip does.

``data_parallel`` is the JAX ``data_parallel_sampler`` (a ``shard_map``
over ``data``) for any batch-first function: each process runs the sampler
on its ``B / data`` rows (on the card its own CUDA graph per bucket, at the
local batch) and ``all_gather``s the mel along ``data``, outside any
graph. The inputs, the noise included, are the whole batch on every process
and each slices its rows, so the result equals the unmeshed one row for
row. The tensor-parallel and FSDP specs of the JAX
module (training) are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from lemas_tts_tpu_torch.parallel.distributed import (backend_for, initialize,
                                                      resolve_device_type)


def ensure_process_group(device_type: Optional[str] = None) -> str:
    """A process group for a ``device_type`` mesh: the job's
    (``distributed.initialize``), or one of a single process when no job is
    configured. Returns the device type; raises when the group's backend
    cannot run collectives on that device."""
    device_type = resolve_device_type(device_type)
    if not dist.is_initialized() and not initialize(device_type=device_type):
        dist.init_process_group(backend_for(device_type), store=dist.HashStore(), rank=0,
                                world_size=1)
    backend = str(dist.get_backend())
    if backend_for(device_type) not in backend:
        raise RuntimeError(f"a {device_type} mesh needs a {backend_for(device_type)} process "
                           f"group, but the process group runs {backend}")
    return device_type


def device_mesh(n_devices: Optional[int], inner: int, axis_names: Sequence[str],
                device_type: Optional[str] = None):
    """``(n // inner, inner)`` mesh over the job's ``n`` processes (one
    device each) with ``axis_names``. ``n_devices`` must be the job's size
    (None: it is): every process of the job is in the mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = ensure_process_group(device_type)
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"a mesh of {n} devices in a job of {world} processes: run one "
                         f"process per device (torchrun --nproc_per_node {n})")
    if inner < 1 or n % inner:
        raise ValueError(f"{n} devices do not split into groups of {inner}")
    return init_device_mesh(device_type, (n // inner, inner), mesh_dim_names=tuple(axis_names))


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              device_type: Optional[str] = None):
    """``("data", "model")`` mesh over the job's processes, the JAX
    ``make_mesh`` and ``make_global_mesh`` in one (a mesh here always spans
    the whole job); ``device_type=None`` means CUDA."""
    return device_mesh(n_devices, model_parallel, ("data", "model"), device_type)


def axis_size(mesh, name: str) -> int:
    """Size of the mesh axis ``name`` (1 when the mesh has no such axis)."""
    names = mesh.mesh_dim_names or ()
    return int(mesh.shape[names.index(name)]) if name in names else 1


def axis_rank(mesh, name: str) -> int:
    """This process's coordinate along ``name`` (0 without that axis)."""
    return mesh.get_local_rank(name) if name in (mesh.mesh_dim_names or ()) else 0


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The shards of ``t`` of every process of ``group``, joined along
    ``dim`` in rank order."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def gather_output(out, group, dim: int):
    """``all_gather`` of a sampler's output along its batch (``dim`` 0) or
    sequence (``dim`` 1) axis; a ``(mel, trajectory)`` pair
    (``return_trajectory``) gathers the trajectory one axis further in."""
    if isinstance(out, tuple):
        return all_gather(out[0], group, dim), all_gather(out[1], group, dim + 1)
    return all_gather(out, group, dim)


def data_parallel(fn, mesh):
    """Wrap ``fn(*tensors)`` (batch-first tensors, or None) so each process
    runs it on its rows of the batch and every process gets the whole
    batch's result, joined along ``data``. The batch must be a multiple of
    the ``data`` axis (``Synthesizer._pick_batch`` pads the sampler's B to
    one). The JAX package's ``data_parallel_sampler``."""
    d, r = axis_size(mesh, "data"), axis_rank(mesh, "data")
    group = mesh.get_group("data")

    def wrapped(*args):
        B = args[0].shape[0]
        if B % d:
            raise ValueError(f"batch {B} does not split over the {d} processes of 'data'")
        rows = slice(r * (B // d), (r + 1) * (B // d))
        return gather_output(fn(*(None if x is None else x[rows] for x in args)), group, 0)

    return wrapped

