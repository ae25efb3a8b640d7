"""Sharding over cards with `torch.distributed` (the port's counterpart of
the JAX package's mesh plumbing: `NamedSharding`, `shard_map`, the psums
of `parallel/structured.py` and `process_allgather`).

One process per card.  A mesh is PyTorch's own
`torch.distributed.device_mesh.DeviceMesh` with a named dimension (the
JAX argument names `batch_axis` / `scen_axis` select it); NCCL carries
its collectives on the cards, gloo on the CPU.  `resolve` turns (mesh,
axis name, device) into an `Axis`: the process group of that dimension,
this process's rank in it, its size, and the device the rank computes on.
A stacked array of R rows is laid out as JAX's `P(axis)`: rank r owns the
block [r L, (r + 1) L) with L = R / world.

The four collectives every sharded path uses are `Axis` methods:
  * `gather_rows(t)`: all-gather along dim 0, in rank order (the joins of
    the sharded vectors);
  * `sum_across(t)`: all-reduce SUM (the cross-scenario Schur sums and the
    batch's failed-lane count);
  * `all_true(flag)`: all-reduce MIN of a flag (the factorization's
    `factor_ok`, which every rank's host loop branches on);
  * `gather_objects(items)`: all-gather of Python lists, concatenated in
    rank order (the agreed padded shapes, the results of `solve_all`).
NCCL's and gloo's all-reduce hand every rank the same bits, so tensors
that every rank computes from collective results stay replicated bit for
bit, and every host decision taken on them is the same on every rank.

`spawn` starts a group of processes (tests, `tools/multihost_torch.py`).
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
from typing import Any, List, NamedTuple

import torch
import torch.distributed as dist


class Axis(NamedTuple):
    """One named dimension of a mesh as this process sees it."""

    group: Any            # the dimension's ProcessGroup
    rank: int             # this process's rank along it
    world: int            # its size
    device: torch.device  # where this rank computes

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t` (same shape on all) stacked along dim 0 in rank
        order."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts)

    def sum_across(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's `t` (a new tensor; `t` is untouched)."""
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out

    def all_true(self, flag) -> torch.Tensor:
        """A 0-d bool tensor on this rank's device: `flag` holds on every
        rank."""
        v = torch.as_tensor(flag, device=self.device).to(torch.int32).reshape(1)
        dist.all_reduce(v, op=dist.ReduceOp.MIN, group=self.group)
        return v.reshape(()) > 0

    def gather_objects(self, items) -> list:
        """Every rank's list of picklable `items`, concatenated in rank
        order."""
        parts: List[Any] = [None] * self.world
        dist.all_gather_object(parts, list(items), group=self.group)
        return [x for part in parts for x in part]


def resolve(mesh, axis: str, device) -> Axis:
    """The `Axis` named `axis` of `mesh` for this process.

    A mesh of device_type "cuda" computes on the card the launcher made
    current (`torch.cuda.set_device`, before any CUDA work), a "cpu" mesh
    on the CPU; a `device` of another type or card raises ValueError, a
    `mesh` that is not a DeviceMesh TypeError, a mesh without a dimension
    named `axis` ValueError."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed.device_mesh.DeviceMesh, "
                        f"not {type(mesh).__name__}")
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"the mesh has no dimension named {axis!r} (it has {names})")
    if mesh.device_type == "cuda":
        here = torch.device("cuda", torch.cuda.current_device())
    elif mesh.device_type == "cpu":
        here = torch.device("cpu")
    else:
        raise ValueError(f"unsupported mesh device_type {mesh.device_type!r}")
    want = torch.device(device)
    if want.type != here.type or (want.index is not None and want.index != here.index):
        raise ValueError(f"device={str(want)!r} disagrees with the mesh, whose rank "
                         f"computes on {here}")
    dim = names.index(axis)
    return Axis(group=mesh.get_group(axis), rank=mesh.get_local_rank(axis),
                world=mesh.size(dim), device=here)


def _child(rank, world, tmp, fn, args, backend, device, timeout):
    if device == "cuda":
        # before any CUDA work and before NCCL starts
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method="file://" + os.path.join(tmp, "rendezvous"),
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    out = fn(*args)
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
    dist.destroy_process_group()


def spawn(fn, world: int, *args, backend: str = "gloo", device: str = "cpu",
          timeout: float = 600.0) -> list:
    """Run `fn(*args)` in `world` new processes, one rank each of one
    process group (`backend` over a `file://` rendezvous in a temporary
    directory, so concurrent groups never share a port), and return what
    each rank returned, in rank order.

    With device "cuda" rank r computes on card r; on the CPU each rank runs
    one thread.  `fn` must be importable by name (a module-level function)
    and its result picklable.  A rank that raises ends the whole run:
    `torch.multiprocessing.spawn` stops the others and raises here; a rank
    stuck in a collective raises after `timeout` seconds."""
    with tempfile.TemporaryDirectory(prefix="madqp_mesh_") as tmp:
        torch.multiprocessing.spawn(
            _child, args=(world, tmp, fn, args, backend, device, timeout),
            nprocs=world, join=True)
        out = []
        for rank in range(world):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
