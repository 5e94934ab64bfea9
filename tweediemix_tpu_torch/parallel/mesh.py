"""Device meshes and row sharding (counterpart of
``tweediemix_tpu/parallel/mesh.py``).

A mesh is a list of torch devices on one named axis, optionally spanning
the ranks of a ``torch.distributed`` process group. One row-sharding
wrapper serves both forms:

* **In one process** a mesh over local devices runs one UNet replica per
  distinct device (``replicate``). Every call's rows are split into
  contiguous shards, each shard runs on its device, and the results are
  concatenated where the rows came from. This is the JAX package's
  single-process ``--mesh_devices``. A device may repeat: repeated entries
  share one replica and run one after the other, which gives a 2-way mesh
  on one CPU or one card (the stand-in for JAX's
  ``--xla_force_host_platform_device_count``).
* **Across processes** (after ``init_distributed``, ``make_mesh()`` with no
  devices) the mesh has one entry per rank, each the rank's own device.
  Each rank computes its own shard of the rows and ``all_gather``s the
  results, so what follows the call (the sampler's fusion math) runs
  replicated on every rank, as JAX's replicated layout leaves it.
* **Training data parallelism** (``cli/train.py``) uses the process group:
  each rank takes its rows of the global batch (``shard_batch`` or
  ``place_global_batch``) and the trainable gradients are summed across
  ranks (``all_reduce_sum``), which is what XLA's psum does. The UNet is
  not wrapped in DDP: its hooks conflict with gradient checkpointing.

The reference's only distribution is accelerate's DDP for training
(``diffusers_training_xl_new.py:503-508``, NCCL underneath); the port keeps
one axis, as the JAX package's layouts use (no tensor, pipeline or
sequence parallelism: SDXL fits one card).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import itertools
import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from tweediemix_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices[i]`` runs shard i of every row split. With ``group`` set
    the shards are the ranks of that process group (shard i is rank i) and
    every entry is this rank's own device."""

    axis: str
    devices: Tuple[torch.device, ...]
    group: Optional[object] = dataclasses.field(default=None, compare=False)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis: self.size}

    def local_shards(self) -> range:
        """The shards this process runs: all of them in one process, its
        rank's alone across processes."""
        if self.group is None:
            return range(self.size)
        rank = dist.get_rank(self.group)
        return range(rank, rank + 1)


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def _rank_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _normalize(device) -> torch.device:
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(axes: Optional[Dict[str, int]] = None, devices=None) -> Mesh:
    """A one-axis mesh (default ``{"dp": n}``). Without ``devices``: the
    process group's ranks after ``init_distributed``, else ``cuda:0`` ..
    ``cuda:n-1`` (all the cards when ``axes`` is None); raises if the host
    has fewer CUDA devices than the axis asks for, or none. ``devices`` may
    repeat a device."""
    if axes is not None and len(axes) != 1:
        raise ValueError(f"the port's meshes have one axis, got {dict(axes)}")
    axis, n = next(iter(axes.items())) if axes else ("dp", None)
    if devices is None:
        if _distributed():
            world = dist.get_world_size()
            if n is not None and n != world:
                raise ValueError(f"a {n}-way {axis!r} mesh over a process group of {world} ranks")
            return Mesh(axis, (_rank_device(),) * world, dist.group.WORLD)
        resolve_device("cuda")
        count = torch.cuda.device_count()
        n = count if n is None else n
        if n > count:
            raise ValueError(f"a {n}-way {axis!r} mesh needs {n} CUDA devices; this host has {count}")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = tuple(_normalize(d) for d in devices)
    if n is not None and n != len(devices):
        raise ValueError(f"a {n}-way {axis!r} mesh over {len(devices)} devices")
    return Mesh(axis, devices)


def as_mesh(mesh_devices, device) -> Mesh:
    """A pipeline's ``mesh_devices``: a ``Mesh`` as it is, or a count n:
    ``cuda:0`` .. ``cuda:n-1``, or the CPU n times when the pipeline runs on
    the CPU."""
    if isinstance(mesh_devices, Mesh):
        return mesh_devices
    if mesh_devices < 1:
        raise ValueError(f"--mesh_devices must be at least 1, got {mesh_devices}")
    device = torch.device(device)
    return make_mesh({"dp": mesh_devices},
                     devices=[device] * mesh_devices if device.type == "cpu" else None)


def _map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    if hasattr(tree, "__array__"):
        return fn(torch.as_tensor(tree))
    return tree


def _module_to(module: nn.Module, device: torch.device) -> nn.Module:
    """A copy of ``module`` whose parameters and buffers are copies of its
    own on ``device`` (nothing is re-initialised, nothing is copied twice)."""
    tensors = itertools.chain(module.parameters(), module.buffers())
    if all(t.device == device for t in tensors):
        return module
    memo = {}
    for p in module.parameters():
        memo[id(p)] = nn.Parameter(p.detach().to(device, copy=True), requires_grad=p.requires_grad)
    for b in module.buffers():
        memo[id(b)] = b.detach().to(device, copy=True)
    return copy.deepcopy(module, memo)


def replicate(mesh: Mesh, module_or_tensors):
    """One copy per distinct device of the mesh, in the mesh's order
    (repeated devices share their copy; a module already on a device is
    that device's copy). A module's copies take its tensors as they are."""
    copies = {}
    out = []
    for device in mesh.devices:
        if device not in copies:
            if isinstance(module_or_tensors, nn.Module):
                copies[device] = _module_to(module_or_tensors, device)
            else:
                copies[device] = _map(lambda t: t.to(device), module_or_tensors)
        out.append(copies[device])
    return out


def shard_batch(mesh: Mesh, tree) -> list:
    """The shards of a global batch that this process holds, one tree per
    shard on its device: every leaf's leading rows split contiguously over
    the mesh (they must divide it)."""
    def rows(t, i):
        if t.shape[0] % mesh.size:
            raise ValueError(f"{t.shape[0]} rows do not divide over a {mesh.size}-way mesh")
        per = t.shape[0] // mesh.size
        return t[i * per:(i + 1) * per].to(mesh.devices[i])

    return [_map(lambda t, i=i: rows(t, i), tree) for i in mesh.local_shards()]


def place_global_batch(mesh: Mesh, tree) -> list:
    """The multi-process data layout: each process holds the rows it loaded
    itself, ``global_rows / ranks`` of them, so across processes this is
    ``[tree]`` on the rank's device. In one process it is
    ``shard_batch``."""
    if mesh.group is None:
        return shard_batch(mesh, tree)
    device = mesh.devices[mesh.local_shards()[0]]
    return [_map(lambda t: t.to(device), tree)]


def pad_rows_to(x: torch.Tensor, n: int):
    """Pad the leading dim up to ``n`` by repeating the last row; returns
    (padded, original rows). More than ``n`` rows are left as they are."""
    b = x.shape[0]
    if b >= n:
        return x, b
    return torch.cat([x] + [x[-1:]] * (n - b), dim=0), b


def globalize(mesh: Mesh, tree):
    """The identity on values every rank computes alike from the same
    checkpoint, prompt and seed (parameters, text embeddings, masks, seed
    latents), placed on this process's first shard device: nothing moves
    between ranks."""
    device = mesh.devices[mesh.local_shards()[0]]
    return _map(lambda t: t.to(device), tree)


def gather_rows(mesh: Mesh, outs: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """This process's shard results → all shards' rows, concatenated on
    ``device``: a concatenation in one process, an ``all_gather`` across
    processes."""
    if mesh.group is None:
        return torch.cat([o.to(device) for o in outs])
    mine = outs[0].contiguous()
    parts = [torch.empty_like(mine) for _ in range(mesh.size)]
    dist.all_gather(parts, mine, group=mesh.group)
    return torch.cat(parts).to(device)


def on_device(device: torch.device):
    """A context that makes ``device`` current while a shard runs, so every
    kernel it launches goes to that card's stream."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def run_sharded(mesh: Mesh, fns, shards: Sequence[Tuple[int, tuple]]) -> list:
    """Run ``fns[i](*args)`` for each (shard index, args) of this process,
    each with its device current; returns the outputs in order."""
    outs = []
    for i, args in shards:
        with on_device(mesh.devices[i]):
            outs.append(fns[i](*args))
    return outs


def _per_shard(mesh: Mesh, unet_fn) -> list:
    if isinstance(unet_fn, (list, tuple)):
        if len(unet_fn) != mesh.size:
            raise ValueError(f"{len(unet_fn)} functions for a {mesh.size}-way mesh")
        return list(unet_fn)
    return [unet_fn] * mesh.size


def _sharded_call(mesh: Mesh, fns, x, t, rows):
    per = x.shape[0] // mesh.size
    shards = []
    for i in mesh.local_shards():
        device = mesh.devices[i]
        lo, hi = i * per, (i + 1) * per
        xs, *rest = (a[lo:hi].to(device, non_blocking=True) for a in (x, *rows))
        shards.append((i, (xs, t, *rest)))
    return gather_rows(mesh, run_sharded(mesh, fns, shards), x.device)


def seed_sharded_unet_fn(mesh: Mesh, unet_fn):
    """Wrap a sampler ``unet_fn(x, t, ctx, pooled, concept_idx)`` so every
    forward's rows shard over the mesh: the "seeds in parallel" serving
    layout and the one-image latency layout alike. Rows are embed-major /
    seed-minor, so any contiguous split is valid; a row count that does not
    divide the mesh (the 2-row joint phase on 4 devices) is padded by
    repeating the last row and the padding sliced off after. The output
    returns to the input rows' device. ``unet_fn`` is one function for
    every shard or one per mesh entry (each on its replica, see
    ``replicate``); each shard's inputs are moved to its device first."""
    fns = _per_shard(mesh, unet_fn)

    def wrapped(x, t, ctx, pooled, concept_idx):
        b = x.shape[0]
        bp = -(-b // mesh.size) * mesh.size
        rows = [pad_rows_to(a, bp)[0] for a in (ctx, pooled, concept_idx)]
        return _sharded_call(mesh, fns, pad_rows_to(x, bp)[0], t, rows)[:b]

    return wrapped


def concept_sharded_unet_fn(mesh: Mesh, unet_fn):
    """Wrap ``unet_fn(x, t, ctx, pooled, concept_idx)`` so its rows (uncond
    + N concepts) shard over the mesh, each concept's forward on its own
    device; the output is replicated (on the input's device, and on every
    rank across processes). The rows must divide the mesh."""
    fns = _per_shard(mesh, unet_fn)

    def wrapped(x, t, ctx, pooled, concept_idx):
        if x.shape[0] % mesh.size:
            raise ValueError(f"{x.shape[0]} rows do not divide over a {mesh.size}-way mesh; "
                             "pad them to a multiple first")
        return _sharded_call(mesh, fns, x, t, (ctx, pooled, concept_idx))

    return wrapped


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None, process_id: Optional[int] = None,
                     device="cuda") -> bool:
    """Join a ``torch.distributed`` process group: NCCL on CUDA, gloo on the
    CPU, over ``tcp://<coordinator_address>`` (``host:port`` of rank 0) with
    ``num_processes`` ranks, this one ``process_id``; without an address,
    from the environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``, as ``torchrun`` sets them). On CUDA the rank's card becomes
    the current device: ``cuda:<LOCAL_RANK>``, else ``cuda:<rank mod cards>``.
    Idempotent. Returns whether the group has more than one rank."""
    device = resolve_device(device)
    if not _distributed():
        if coordinator_address is None:
            init_method = "env://"
        elif num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs the process count and this "
                             "process's rank")
        else:
            init_method = f"tcp://{coordinator_address}"
        rank = int(os.environ.get("RANK", 0)) if process_id is None else process_id
        if device.type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
            torch.cuda.set_device(local)
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo", init_method=init_method,
            world_size=-1 if num_processes is None else num_processes,
            rank=-1 if process_id is None else process_id)
    return dist.get_world_size() > 1


def all_reduce_sum(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Sum each tensor across the ranks in place, one collective per dtype
    (the tensors are packed into one flat buffer)."""
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        for t, part in zip(same, flat.split([t.numel() for t in same])):
            t.copy_(part.view_as(t))


def barrier() -> None:
    """Wait for every rank (nothing to wait for in one process)."""
    if _distributed():
        dist.barrier()


def host_gather(x: torch.Tensor, mesh: Optional[Mesh] = None):
    """This process's rows → every rank's rows as numpy, on every rank (an
    ``all_gather`` along dim 0 over the mesh's process group, or the
    default group once ``init_distributed`` ran); in one process, the rows
    themselves."""
    group = mesh.group if mesh is not None else (dist.group.WORLD if _distributed() else None)
    if group is not None:
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        x = torch.cat(parts)
    return x.detach().cpu().numpy()


def is_primary_process() -> bool:
    """True on the process that writes images, metrics and checkpoints:
    rank 0, or the only process."""
    return not _distributed() or dist.get_rank() == 0


def destroy_distributed() -> None:
    """Leave the process group, if one was joined."""
    if _distributed():
        dist.destroy_process_group()
