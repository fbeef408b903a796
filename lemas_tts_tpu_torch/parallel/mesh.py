"""Device mesh, data-parallel sampling and the parameter plans of training
(counterpart of ``lemas_tts_tpu/parallel/mesh.py``).

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
row.

Training (``cfm/train.py``, ``cfm/distill.py``, ``parallel/pipeline.py``)
places parameters by plans that follow the JAX pspec rules under the port's
parameter names, one dict ``{parameter name: dimension}`` per mesh axis:

- ``tp_param_dims`` (``dit_param_pspecs``): column-parallel q/k/v and FF-in
  (weight and bias split on the output features), row-parallel ``to_out``
  and FF-out and the AdaLN modulations (weight split on the input
  features, bias whole), everything else replicated;
- ``fsdp_param_dims`` (``fsdp_param_pspecs``): one more dimension over
  ``data`` for every leaf of at least ``min_elems`` elements;
- ``ParamPlacement`` holds the plans of one module on a mesh (with the
  pipeline stages of ``parallel/pipeline.py``) and moves tensors between
  the reference layout and this process's part (``shard_pytree``,
  ``opt_state_pspecs`` and the checkpoint gather in one). The optimizer
  state follows the parameters.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

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



# ------------------------------------------------------------------ training plans
def tp_param_dims(model: nn.Module) -> Dict[str, int]:
    """The JAX ``dit_param_pspecs`` under the port's names: ``{parameter
    name: dimension split over 'model'}`` (torch layout: a Linear weight is
    ``[out, in]``). Column-parallel ``Attention.to_q/to_k/to_v`` and
    ``FeedForward.ff.0.0`` (weight and bias on the output features),
    row-parallel ``Attention.to_out.0`` and ``FeedForward.ff.2`` and the
    AdaLN ``linear`` of ``AdaLayerNorm``/``AdaLayerNormFinal`` (weight on
    the input features); every other parameter is replicated (absent)."""
    from lemas_tts_tpu_torch.models.modules import (AdaLayerNorm, AdaLayerNormFinal,
                                                    Attention, FeedForward)

    dims = {}
    for mname, m in model.named_modules():
        pre = f"{mname}." if mname else ""
        if isinstance(m, Attention):
            for proj in ("to_q", "to_k", "to_v"):
                dims[f"{pre}{proj}.weight"] = dims[f"{pre}{proj}.bias"] = 0
            dims[f"{pre}to_out.0.weight"] = 1
        elif isinstance(m, FeedForward):
            dims[f"{pre}ff.0.0.weight"] = dims[f"{pre}ff.0.0.bias"] = 0
            dims[f"{pre}ff.2.weight"] = 1
        elif isinstance(m, (AdaLayerNorm, AdaLayerNormFinal)):
            dims[f"{pre}linear.weight"] = 1
    return dims


def _jax_dim_order(module: nn.Module, pname: str, ndim: int) -> range:
    """The port's dimensions in the order of the JAX leaf's: a Dense kernel
    ``[in, out]`` is a Linear weight ``[out, in]``, a Conv kernel
    ``[K, Cin/g, Cout]`` a Conv1d weight ``[Cout, Cin/g, K]``; the rest keep
    their order."""
    if pname == "weight" and isinstance(module, (nn.Linear, nn.Conv1d)):
        return range(ndim - 1, -1, -1)
    return range(ndim)


def fsdp_param_dims(model: nn.Module, axis_size: int, base: Optional[Dict[str, int]] = None,
                    min_elems: int = 1 << 16) -> Dict[str, int]:
    """The JAX ``fsdp_param_pspecs`` rule under the port's names: ``{name:
    dimension split over 'data'}`` for each leaf of at least ``min_elems``
    elements, on its largest dimension that ``axis_size`` divides and that
    ``base`` (the tensor-parallel plan) does not split; ties go to the
    first in the JAX leaf's order. The JAX DiT stacks its blocks on a
    leading depth axis, so a block parameter's leaf has ``depth`` times its
    elements, and that is the size ``min_elems`` is held against. The depth
    axis itself is not a candidate here (each block's parameters are
    separate tensors); it would win in JAX only where the depth exceeded
    every other divisible dimension, which no configuration has."""
    base = base or {}
    depth = len(getattr(model, "transformer_blocks", ()))
    out = {}
    for mname, m in model.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            size = p.numel() * (depth if name.startswith("transformer_blocks.") else 1)
            if size < min_elems:
                continue
            cands = [d for d in _jax_dim_order(m, pname, p.ndim)
                     if d != base.get(name) and p.shape[d] % axis_size == 0
                     and p.shape[d] >= axis_size]
            if cands:
                out[name] = max(cands, key=lambda d: p.shape[d])
    return out


def _part(t: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    """Part ``i`` of ``n`` equal parts of ``t`` along ``dim``, a tensor of
    its own."""
    if t.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not split into {n} parts")
    k = t.shape[dim] // n
    return t.narrow(dim, i * k, k).contiguous().clone()


class ParamPlacement:
    """Where each parameter of ``module`` lives on ``mesh``: split over
    ``model`` (``tp``), split over ``data`` (``fsdp``), held by one stage of
    ``pipe`` (``stages``), or whole on every process. Three layouts of a
    parameter's tensor:

    - *full*: the reference layout, the whole tensor (checkpoints);
    - *working*: what the module computes with, its ``model`` part (empty
      on a stage that does not hold it);
    - *master*: what the optimizer steps, the EMA tracks and a checkpoint
      gathers from: the working tensor's ``data`` part (ZeRO-3), else the
      working tensor itself.

    ``module`` is the whole module; the plans are made on its full shapes.
    Every method that gathers is a collective: every process of the mesh
    calls it for the same names in the same order."""

    def __init__(self, module: nn.Module, mesh, tp: Optional[Dict[str, int]] = None,
                 fsdp: Optional[Dict[str, int]] = None,
                 stages: Optional[Dict[str, int]] = None):
        self.mesh = mesh
        self.names = [n for n, _ in module.named_parameters()]
        self.shapes = {n: tuple(p.shape) for n, p in module.named_parameters()}
        self.dtypes = {n: p.dtype for n, p in module.named_parameters()}
        self.device = torch.device(mesh.device_type)
        self.tp, self.fsdp, self.stages = dict(tp or {}), dict(fsdp or {}), dict(stages or {})
        self.groups = {a: mesh.get_group(a) for a in (mesh.mesh_dim_names or ())}
        self.size = {a: axis_size(mesh, a) for a in ("data", "model", "pipe")}
        self.rank = {a: axis_rank(mesh, a) for a in ("data", "model", "pipe")}

    def owned(self, name: str) -> bool:
        """Whether this process's stage holds ``name``."""
        return self.stages.get(name, self.rank["pipe"]) == self.rank["pipe"]

    def owned_names(self) -> list:
        return [n for n in self.names if self.owned(n)]

    def working(self, name: str, full: torch.Tensor) -> torch.Tensor:
        if not self.owned(name):
            return full.new_empty(0)
        if name in self.tp:
            return _part(full, self.tp[name], self.size["model"], self.rank["model"])
        return full.clone()

    def master(self, name: str, working: torch.Tensor) -> torch.Tensor:
        """The master tensor of a working one."""
        if name in self.fsdp and self.owned(name):
            return _part(working, self.fsdp[name], self.size["data"], self.rank["data"])
        return working

    def unshard(self, name: str, master: torch.Tensor) -> torch.Tensor:
        """The working tensor of a master one (all-gather over ``data``)."""
        if name in self.fsdp and self.owned(name):
            return all_gather(master, self.groups["data"], self.fsdp[name])
        return master

    def gather(self, name: str, t: Optional[torch.Tensor], master: bool = True) -> torch.Tensor:
        """The full tensor of ``t``, a master (or, ``master=False``, a
        working) tensor of ``name``; on every process (``t`` is None on a
        stage that does not hold ``name``)."""
        if self.owned(name):
            if master:
                t = self.unshard(name, t)
            if name in self.tp:
                t = all_gather(t, self.groups["model"], self.tp[name])
        if name in self.stages and self.size["pipe"] > 1:
            group = self.groups["pipe"]
            if not self.owned(name):
                t = torch.empty(self.shapes[name], dtype=self.dtypes[name], device=self.device)
            dist.broadcast(t, src=dist.get_global_rank(group, self.stages[name]), group=group)
        return t

    def reduce_grads(self, grads: Iterable[torch.Tensor], names: Sequence[str],
                     divide_by: int = 1) -> None:
        """In place, the gradients of the whole step from this process's:
        summed over ``pipe`` where every stage holds the parameter (each
        stage's use of it contributes), then the mean over ``data`` (the
        loss is the global batch's on every data process, so each holds its
        rows' part times the axis size: ``cfm/loss.py``), then divided by
        ``divide_by`` (the accumulation window)."""
        grads = list(grads)
        if self.size["pipe"] > 1:
            _all_reduce_flat([g for g, n in zip(grads, names) if n not in self.stages],
                             self.groups["pipe"])
        _all_reduce_flat(grads, self.groups["data"])
        torch._foreach_div_(grads, float(self.size["data"] * divide_by))

    def global_norm(self, grads: Sequence[torch.Tensor], names: Sequence[str]) -> torch.Tensor:
        """The global norm of the whole model's gradient from this process's
        parts (working layout, equal over ``data``): the ``model`` parts and
        the stages' blocks summed over their axes, the replicated leaves
        counted once."""
        def sq(ts):
            ts = list(ts)
            if not ts:
                return torch.zeros((), device=grads[0].device)
            return torch.stack([torch.linalg.vector_norm(t.float()) ** 2 for t in ts]).sum()

        tp = sq(g for g, n in zip(grads, names) if n in self.tp)
        pipe = sq(g for g, n in zip(grads, names) if n in self.stages)
        rest = sq(g for g, n in zip(grads, names) if n not in self.tp and n not in self.stages)
        if "model" in self.groups:
            dist.all_reduce(tp, group=self.groups["model"])
        if "pipe" in self.groups:
            dist.all_reduce(pipe, group=self.groups["pipe"])
        return torch.sqrt(tp + pipe + rest)


def _all_reduce_flat(ts: Sequence[torch.Tensor], group) -> None:
    """One sum all-reduce over ``group`` for all of ``ts`` (one dtype), in
    place."""
    if not ts:
        return
    flat = torch.cat([t.reshape(-1) for t in ts])
    dist.all_reduce(flat, group=group)
    off = 0
    for t in ts:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()
