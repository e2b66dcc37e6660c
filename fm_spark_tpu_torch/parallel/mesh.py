"""Meshes of ranks over ``torch.distributed`` and the collectives the
sharded steps use (the port of ``fm_spark_tpu/parallel/mesh.py`` and of
``field_step.make_field_mesh``).

A :class:`Mesh` lays the ranks of the default process group out on named
axes, row-major: ``("data", "feat")`` for the dense strategies (a rank's
global index is ``d·n_feat + f``), ``("feat",)`` or ``("feat", "row")``
for the field-sharded steps (``f·n_row + r``). One rank drives one device:
``cuda:LOCAL_RANK`` under NCCL on the card, the CPU under gloo when the
caller asks for it. The group of an axis set holds the ranks that share
every other coordinate, in ascending rank order, so a gather over it
concatenates in mesh order, as JAX's collectives over a mesh axis do.

Each axis set's groups are made once, by every rank of the default group
in the same order (``torch.distributed.new_group``'s contract); a mesh
over a GIVEN subset of ranks (``ranks=``: the survivors an elastic
rebuild keeps) is built the same way, its groups holding those ranks
only. A mesh of one rank with no process group (``Mesh.local``) runs
every collective as the identity: the sharded steps' single-device form.

The collectives are the ones both torch builds of the project have:
``all_reduce``, ``all_to_all_single``, the flat all-gather (named
``all_gather_single`` where a build has that name, else
``all_gather_into_tensor``) and, outside the steps, ``gather`` to one
rank. Every one is synchronous from the
host's view and asynchronous on the card (the current stream waits for
the collective's stream), returns no ``Work`` handle, and so can be
recorded in a CUDA graph once NCCL has made its communicator (the
captured steps' warm-up runs every collective first).
"""

from __future__ import annotations

import datetime
import itertools
import os

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "init_distributed", "make_field_mesh", "make_mesh"]

#: The flat all-gather ``(out [n·m], x [m], group=)``: one collective under
#: two names (the newer build warns on the older one).
_all_gather_flat = (getattr(dist, "all_gather_single", None)
                    or dist.all_gather_into_tensor)


def init_distributed(device=None, *, coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     timeout_s: float = 300.0) -> torch.device:
    """Join the default process group (once; a second call returns the
    device) and return this rank's device. NCCL on the card, gloo when
    ``device`` is the CPU: never gloo while a card is used.

    The explicit triple (``coordinator`` ``host:port``, ``num_processes``,
    ``process_id``) gives the store; without it torchrun's environment
    (``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``) does. The
    card is ``cuda:LOCAL_RANK`` (default 0)."""
    from fm_spark_tpu_torch import resolve_device

    cpu = device is not None and torch.device(device).type == "cpu"
    if cpu:
        dev = torch.device("cpu")
    else:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev = resolve_device(device if device is not None
                             else f"cuda:{local}")
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    explicit = (coordinator, num_processes, process_id)
    if any(x is not None for x in explicit) and None in explicit:
        raise ValueError("coordinator, num_processes and process_id must be "
                         "given together")
    kw = dict(backend="gloo" if cpu else "nccl",
              timeout=datetime.timedelta(seconds=timeout_s))
    if coordinator is not None:
        kw.update(init_method=f"tcp://{coordinator}",
                  world_size=int(num_processes), rank=int(process_id))
    if not cpu:
        kw["device_id"] = dev
    dist.init_process_group(**kw)
    return dev


class Mesh:
    """Ranks on named axes (see the module's docstring). ``shape`` maps
    each axis to its extent, ``coords`` this rank's coordinate on each,
    ``size`` the rank count, ``index`` this rank's row-major position."""

    def __init__(self, axis_names, sizes, ranks=None, device=None,
                 _local: bool = False):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.size = int(np.prod(list(self.shape.values())))
        self.device = torch.device(device) if device is not None else None
        if _local:
            if self.size != 1:
                raise ValueError("a mesh without a process group has one rank")
            self.ranks = (0,)
            self.index = 0
            self._groups = {}
        else:
            if not dist.is_initialized():
                raise RuntimeError(
                    "no process group: call parallel.init_distributed first "
                    "(or Mesh.local for a single-device mesh)")
            world = dist.get_world_size()
            self.ranks = tuple(range(world)) if ranks is None else tuple(
                int(r) for r in ranks)
            if not self.ranks:
                raise ValueError("empty rank list: no surviving ranks to "
                                 "build a mesh from")
            if len(self.ranks) != self.size:
                raise ValueError(f"need {self.size} ranks, have "
                                 f"{len(self.ranks)}")
            me = dist.get_rank()
            self.index = self.ranks.index(me) if me in self.ranks else None
            self._groups = self._make_groups(world)
        grid = np.arange(self.size).reshape([self.shape[a]
                                             for a in self.axis_names])
        self.coords = ({} if self.index is None else dict(zip(
            self.axis_names,
            (int(c) for c in np.argwhere(grid == self.index)[0]))))

    @classmethod
    def local(cls, axis_names=("feat",), device=None) -> "Mesh":
        """A mesh of this process alone, every axis of extent 1, with no
        process group: its collectives are the identity."""
        return cls(axis_names, [1] * len(tuple(axis_names)), device=device,
                   _local=True)

    def _make_groups(self, world: int) -> dict:
        """``{axes: group of this rank}`` for every non-empty axis set;
        every rank of the default group makes every group, in one order."""
        grid = np.array(self.ranks).reshape([self.shape[a]
                                             for a in self.axis_names])
        me = dist.get_rank()
        groups = {}
        n = len(self.axis_names)
        for r in range(1, n + 1):
            for axes in itertools.combinations(range(n), r):
                rest = [i for i in range(n) if i not in axes]
                moved = np.moveaxis(grid, rest + list(axes),
                                    list(range(n)))
                members = moved.reshape(
                    -1, int(np.prod([grid.shape[i] for i in axes])))
                key = tuple(self.axis_names[i] for i in axes)
                for row in members:
                    row = sorted(int(x) for x in row)
                    if row == list(range(world)):
                        group = dist.group.WORLD
                    else:
                        group = dist.new_group(row)
                    if me in row:
                        groups[key] = (group, len(row))
        return groups

    def coord(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axes):
        """``(group, size)`` over ``axes`` (a name or a tuple, in mesh
        order) for this rank; ``(None, 1)`` on a local mesh."""
        axes = (axes,) if isinstance(axes, str) else tuple(
            a for a in self.axis_names if a in axes)
        if not self._groups:
            return None, int(np.prod([self.shape[a] for a in axes]))
        return self._groups[axes]

    # --------------------------------------------------------- collectives

    def all_reduce(self, x: torch.Tensor, axes, op: str = "sum",
                   wire=None) -> torch.Tensor:
        """The sum (or ``op='max'``) of ``x`` over ``axes``, a new tensor;
        ``wire`` casts it for the collective and back on arrival (the
        reference's ``_psum_wire``)."""
        group, _ = self.group(axes)
        out = x.to(wire) if wire is not None else x.clone()
        if group is not None:
            dist.all_reduce(out, op=(dist.ReduceOp.MAX if op == "max"
                                     else dist.ReduceOp.SUM), group=group)
        return out.to(x.dtype) if wire is not None else out

    def all_to_all(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Chunk ``j`` of ``x``'s leading axis (its extent the group's
        size) goes to the group's ``j``-th rank; chunk ``i`` of the result
        came from its ``i``-th."""
        group, n = self.group(axes)
        if x.shape[0] != n:
            raise ValueError(f"all_to_all wants a leading axis of {n}, got "
                             f"{tuple(x.shape)}")
        if group is None:
            return x.clone()
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    def all_gather(self, x: torch.Tensor, axes) -> torch.Tensor:
        """``[n, *x.shape]``: every rank's ``x`` over ``axes``, in group
        order, a new tensor."""
        group, n = self.group(axes)
        if group is None:
            return x.unsqueeze(0).clone()
        out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
        _all_gather_flat(out, x.contiguous().reshape(-1), group=group)
        return out.view(n, *x.shape)

    def gather(self, x: torch.Tensor, root: int = 0):
        """``[n, *x.shape]``: every rank's ``x`` over the whole mesh, in
        mesh order, on the mesh's rank ``root`` alone (None on the
        others)."""
        group, n = self.group(self.axis_names)
        if group is None:
            return x.unsqueeze(0).clone()
        x = x.contiguous()
        out = ([torch.empty_like(x) for _ in range(n)]
               if self.index == root else None)
        dist.gather(x, out, dst=self.ranks[root], group=group)
        return torch.stack(out) if out is not None else None

    def barrier(self) -> None:
        group, _ = self.group(self.axis_names)
        if group is not None:
            dist.barrier(group=group)


def make_mesh(n_data: int | None = None, n_feat: int = 1, ranks=None,
              device=None) -> Mesh:
    """A ``(data, feat)`` mesh over the default group's ranks (or the
    given ``ranks``): ``n_data`` defaults to every rank over ``n_feat``.
    Without a process group, the one-rank local mesh."""
    if not dist.is_initialized():
        if (n_data or 1) * n_feat != 1:
            raise RuntimeError("a mesh of more than one rank needs a process "
                               "group (parallel.init_distributed)")
        return Mesh.local(("data", "feat"), device)
    count = len(ranks) if ranks is not None else dist.get_world_size()
    if n_data is None:
        if count % n_feat:
            raise ValueError(f"{count} ranks not divisible by n_feat={n_feat}")
        n_data = count // n_feat
    if n_data * n_feat > count:
        raise ValueError(f"need {n_data * n_feat} ranks, have {count}")
    ranks = list(ranks if ranks is not None else range(count))
    return Mesh(("data", "feat"), (n_data, n_feat),
                ranks[:n_data * n_feat], device)


def make_field_mesh(n_devices: int | None = None, ranks=None,
                    n_row: int = 1, device=None) -> Mesh:
    """The field-sharded layout's mesh: 1-D ``(feat,)``, or 2-D ``(feat,
    row)`` with ``n_row`` shards of each field's bucket dimension. Without
    a process group, the one-rank local mesh."""
    if not dist.is_initialized():
        if (n_devices or 1) != 1 or n_row != 1:
            raise RuntimeError("a mesh of more than one rank needs a process "
                               "group (parallel.init_distributed)")
        return Mesh.local(("feat",), device)
    ranks = list(ranks if ranks is not None
                 else range(dist.get_world_size()))
    if n_devices is not None:
        ranks = ranks[:n_devices]
    if n_row <= 1:
        return Mesh(("feat",), (len(ranks),), ranks, device)
    if len(ranks) % n_row:
        raise ValueError(
            f"n_row={n_row} must divide the device count ({len(ranks)})")
    return Mesh(("feat", "row"), (len(ranks) // n_row, n_row), ranks, device)
