"""The device mesh over `torch.distributed`, port of `repro.launch.mesh`.

One process per device.  The mesh names its axes as the reference does:
("data", "model"), with "pod" in front when it has more than one pod.
Axis roles are the reference's: pod and data shard the sample (N)
dimension; model is the paper's fine-grained axis (spatial H for the
CNNs).  Ranks are laid out major-to-minor over the axes, so rank =
(pod * data + d) * model + m.

A mesh may span a subset of the process group (`members`, its global
ranks in ascending order; the reference's `make_mesh(devices=)`): mesh
rank i is global rank `members[i]`, and `Mesh.rank`, `ranks`, `index`
and the coordinates speak of mesh ranks.  This is how an elastic restart
runs on the survivors (launch.train --elastic).

A collective over a tuple of axes (one axis, or several forming one
product axis) runs on the process group of the ranks that differ only in
those axes; `Mesh` creates every such group when it is built, in one
order on every rank, because `dist.new_group` is itself collective: over
the whole process group, members or not.  So every process of the group
builds a subset's `Mesh` too; on a process outside `members` it makes the
groups and nothing else (`member` False).  (gloo's
`new_group(use_local_synchronization=True)`, which only the members
call, hangs in torch 2.13 where one rank's local groups overlap another
rank's in another order.)  A shard's index along a tuple of axes is its
coordinates linearized major-to-minor in tuple order (`core/halo.py`'s
convention).

Transport follows the backend.  NCCL moves device tensors.  gloo moves
host tensors: a CUDA tensor is copied to the host and back explicitly
(`to_wire`, `wire_buffer`), and each collective staged so (all-reduce,
all-gather, reduce-scatter, all-to-all) adds one to `Mesh.staged` (the
halo exchange counts its own in `core.halo.staged`).

Under an audit (`analysis.collectives.record`) each of those four
collectives gives the recorder one op: its kind (`psum`, `pmax`,
`all_gather`, `reduce_scatter`, `all_to_all`), the bytes that enter it on this rank,
its axes, and the layer, region and direction of the region it runs in
(`core.trace.scope`).
"""
from __future__ import annotations

import itertools
import os

import torch
import torch.distributed as dist

from repro_torch.core import trace

DATA_AXES = ("pod", "data")     # axes that shard the sample (N) dimension
MODEL_AXIS = "model"            # the paper's fine-grained axis


def axes_tuple(axis) -> tuple[str, ...]:
    """A mesh axis spec (None, a name, or a tuple of names) as a tuple."""
    if axis is None:
        return ()
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


class Mesh:
    """Axis names and sizes, this rank's coordinates, and the process group
    of every tuple of axes.

    `shape` maps each axis name to its size, in layout order; their product
    must be the world size of the running process group, or the number of
    `members` (global ranks, ascending).  A mesh of one rank needs no
    process group.  Given `rank`, the mesh only answers layout questions
    (coordinates, indices, ranks) for that rank and makes no group."""

    def __init__(self, shape: dict[str, int], *, rank: int | None = None,
                 members: list[int] | None = None):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.size = 1
        for n in self.shape.values():
            self.size *= n
        self._groups: dict[tuple[int, ...], object] = {}
        self.staged = 0
        self.members = list(range(self.size))
        self.member = True
        if rank is not None:
            self.rank, self.backend = rank, "none"
        elif self.size > 1 or dist.is_initialized() or members is not None:
            world = dist.get_world_size()
            if members is not None:
                self.members = [int(r) for r in members]
                if self.members != sorted(set(self.members)) or \
                        not 0 <= self.members[0] <= self.members[-1] < world:
                    raise ValueError(f"mesh members {members}: distinct "
                                     f"global ranks below {world}, "
                                     f"ascending")
            elif world != self.size:
                raise ValueError(f"mesh {self.shape} has {self.size} ranks "
                                 f"but the process group has {world}")
            if len(self.members) != self.size:
                raise ValueError(f"mesh {self.shape} has {self.size} ranks "
                                 f"but {len(self.members)} members")
            self.backend = dist.get_backend()
            if self.size > 1:
                self._make_groups()
            me = dist.get_rank()
            self.member = me in self.members
            if not self.member:
                self.rank = self.coords = None
                return
            self.rank = self.members.index(me)
        else:
            self.rank, self.backend = 0, "none"
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} outside mesh {self.shape}")
        self.coords = dict(zip(self.axis_names, self._unravel(self.rank)))

    def _unravel(self, rank: int) -> list[int]:
        out = []
        for n in reversed(list(self.shape.values())):
            out.append(rank % n)
            rank //= n
        return out[::-1]

    def rank_of(self, coords: dict[str, int]) -> int:
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + coords[a]
        return r

    def ranks(self, axes) -> list[int]:
        """The ranks of this rank's group along `axes`, in shard-index
        order (major-to-minor in tuple order)."""
        axes = axes_tuple(axes)
        out = []
        for idx in itertools.product(*(range(self.shape[a]) for a in axes)):
            c = dict(self.coords)
            c.update(zip(axes, idx))
            out.append(self.rank_of(c))
        return out

    def _make_groups(self) -> None:
        """One process group per distinct rank set of every axis subset.
        Every rank runs the same loop, so `new_group` is called in one
        order everywhere, also for the groups this rank is not in."""
        names = self.axis_names
        for k in range(1, len(names) + 1):
            for axes in itertools.combinations(names, k):
                rest = [a for a in names if a not in axes]
                for fixed in itertools.product(
                        *(range(self.shape[a]) for a in rest)):
                    base = dict(zip(rest, fixed))
                    members = []
                    for idx in itertools.product(
                            *(range(self.shape[a]) for a in axes)):
                        c = dict(base)
                        c.update(zip(axes, idx))
                        members.append(self.rank_of(c))
                    key = tuple(sorted(members))
                    if len(key) > 1 and key not in self._groups:
                        self._groups[key] = dist.new_group(
                            [self.members[r] for r in key])

    def axis_size(self, axes) -> int:
        """Total shard count of a (possibly product) axis."""
        n = 1
        for a in axes_tuple(axes):
            n *= self.shape[a]
        return n

    def index(self, axes) -> int:
        """This rank's shard index along `axes`, linearized major-to-minor
        in tuple order."""
        i = 0
        for a in axes_tuple(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes):
        """The process group of `axes` (None where it is one rank)."""
        return self._groups.get(tuple(sorted(self.ranks(axes))))

    def global_rank(self, rank: int) -> int:
        """The process-group rank of mesh rank `rank` (the peer a
        point-to-point message names)."""
        return self.members[rank]

    def barrier(self) -> None:
        """Wait for every rank of the mesh."""
        group = self.group(self.axis_names)
        if group is not None:
            dist.barrier(group=group)

    def broadcast_object(self, obj):
        """Mesh rank 0's picklable `obj` on every rank of the mesh (rank 0
        enters the collective only when it has it, so what the other
        ranks do next comes after it)."""
        group = self.group(self.axis_names)
        if group is None:
            return obj
        box = [obj if self.rank == 0 else None]
        dist.broadcast_object_list(box, src=self.members[0], group=group)
        return box[0]

    # ---------------------------------------------------------- transport

    def to_wire(self, t: torch.Tensor) -> torch.Tensor:
        """`t` as the backend sends it: NCCL takes device tensors as they
        are, gloo host tensors (a CUDA tensor is copied out)."""
        if self.stages(t.device):
            return t.detach().cpu().contiguous()
        return t.detach().contiguous()

    def wire_buffer(self, shape, dtype, device) -> torch.Tensor:
        """An empty receive buffer where the backend receives: on the host
        for gloo, on `device` for NCCL."""
        dev = torch.device("cpu") if self.backend == "gloo" else device
        return torch.empty(shape, dtype=dtype, device=dev)

    def stages(self, device: torch.device) -> bool:
        """Whether a tensor on `device` goes through the host."""
        return self.backend == "gloo" and device.type == "cuda"

    def all_reduce(self, t: torch.Tensor, axes, op: str = "sum"
                   ) -> torch.Tensor:
        """Sum (`op` "max": the maximum) of `t` over the ranks of `axes`,
        as a new tensor on t's device (`t` itself where the group is one
        rank).  Not differentiable: `core.spatial_norm` wraps it for
        autograd."""
        group = self.group(axes)
        if group is None:
            return t
        if trace.RECORDER is not None:
            trace.note("psum" if op == "sum" else "pmax", t,
                       axes_tuple(axes))
        buf = self.to_wire(t)
        buf = buf.clone() if buf.data_ptr() == t.data_ptr() else buf
        dist.all_reduce(buf, op=dist.ReduceOp.SUM if op == "sum" else
                        dist.ReduceOp.MAX, group=group)
        return self._land(buf, t.device)

    def all_max(self, values) -> list[float]:
        """Each of the floats `values` as its max over every rank of the
        mesh (the same list, in the same order, on every rank): what a
        timing takes when a step lasts as long as its slowest rank."""
        group = self.group(self.axis_names)
        if self.backend == "none" or group is None:
            return [float(v) for v in values]
        dev = torch.device("cuda") if self.backend == "nccl" else \
            torch.device("cpu")
        t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                         device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        return t.tolist()

    def _land(self, buf: torch.Tensor, device: torch.device) -> torch.Tensor:
        """A collective's result on `device`, counted in `staged` where it
        came through the host."""
        if buf.device != device:
            self.staged += 1
            buf = buf.to(device)
        return buf

    def _group_order(self, axes) -> list[int]:
        """The shard index along `axes` of each rank of their process
        group, in the group's rank order (ascending global rank), which
        the dim-0 collectives below concatenate and scatter in."""
        order = self.ranks(axes)
        return [order.index(r) for r in sorted(order)]

    def all_gather(self, t: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """The blocks of `t` of every rank of `axes`, concatenated along
        `dim` in shard-index order (`t` itself where the group is one
        rank).  The collective works on dim 0: `dim` is moved to the
        front and back.  Not differentiable (`core.collectives`)."""
        group = self.group(axes)
        if group is None:
            return t
        if trace.RECORDER is not None:
            trace.note("all_gather", t, axes_tuple(axes))
        src = self.to_wire(t.movedim(dim, 0))
        order = self._group_order(axes)
        out = torch.empty((len(order) * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        dist.all_gather_into_tensor(out, src, group=group)
        out = out.view((len(order),) + tuple(src.shape))[torch.tensor(
            sorted(range(len(order)), key=order.__getitem__))]
        out = self._land(out.flatten(0, 1), t.device)
        return out.movedim(0, dim).contiguous()

    def reduce_scatter(self, t: torch.Tensor, axes, dim: int
                       ) -> torch.Tensor:
        """This rank's block along `dim` of the sum of `t` over the ranks
        of `axes`: `dim` cut into one block per shard index."""
        group = self.group(axes)
        if group is None:
            return t
        if trace.RECORDER is not None:
            trace.note("reduce_scatter", t, axes_tuple(axes))
        p = len(self.ranks(axes))
        src = t.movedim(dim, 0)
        src = src.reshape((p, src.shape[0] // p) + tuple(src.shape[1:]))
        src = self.to_wire(src[torch.tensor(self._group_order(axes))])
        out = torch.empty(tuple(src.shape[1:]), dtype=src.dtype,
                          device=src.device)
        dist.reduce_scatter_tensor(out, src.flatten(0, 1), group=group)
        return self._land(out, t.device).movedim(0, dim).contiguous()

    def all_to_all(self, t: torch.Tensor, axes, split_dim: int,
                   cat_dim: int) -> torch.Tensor:
        """`split_dim` cut into one block per shard index of `axes`, block
        j sent to shard j, and the blocks received concatenated along
        `cat_dim` in shard-index order."""
        group = self.group(axes)
        if group is None:
            return t
        if trace.RECORDER is not None:
            trace.note("all_to_all", t, axes_tuple(axes))
        order = self._group_order(axes)
        p = len(order)
        src = t.movedim(split_dim, 0)
        src = src.reshape((p, src.shape[0] // p) + tuple(src.shape[1:]))
        src = self.to_wire(src[torch.tensor(order)])
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=group)
        out = self._land(out, t.device)
        out = out[torch.tensor(sorted(range(p), key=order.__getitem__))]
        out = out.movedim(1, split_dim + 1).movedim(0, cat_dim)
        return out.flatten(cat_dim, cat_dim + 1).contiguous()


def make_mesh(data: int = 1, model: int = 1, pod: int = 1,
              members: list[int] | None = None) -> Mesh:
    """The mesh of the running process group, or of its global ranks
    `members`: ("pod", "data", "model") with pod > 1, else ("data",
    "model"), as the reference names them."""
    if pod > 1:
        return Mesh({"pod": pod, "data": data, "model": model},
                    members=members)
    return Mesh({"data": data, "model": model}, members=members)


def init_distributed(device: torch.device) -> tuple[int, int, int]:
    """Join the process group and return (rank, world size, local rank).

    A process group that already exists is used as it is (how
    `chip_smoke.py` runs gloo ranks on one card).  Otherwise torchrun's
    environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT)
    names it, with NCCL for a CUDA device and gloo for the CPU; without
    that environment the process runs alone."""
    if dist.is_initialized():
        rank = dist.get_rank()
        return rank, dist.get_world_size(), int(
            os.environ.get("LOCAL_RANK", rank))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return 0, 1, 0
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    if device.type == "cuda":
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        backend="nccl" if device.type == "cuda" else "gloo",
        rank=rank, world_size=world)
    return rank, world, local


def elastic_factorization(n: int, *, batch: int | None = None
                          ) -> tuple[int, int]:
    """A (data, model) factorization of `n` devices: the most balanced
    split whose data size divides the global batch; when nothing divides,
    everything lands on the model axis."""
    best = 1
    for data in range(1, int(n ** 0.5) + 1):
        if n % data == 0 and (batch is None or batch % data == 0):
            best = data
    return best, n // best


def batch_axes(mesh: Mesh | None) -> tuple[str, ...]:
    if mesh is None:
        return ()
    return tuple(a for a in DATA_AXES if a in mesh.axis_names)


def model_axis_size(mesh: Mesh | None) -> int:
    return 1 if mesh is None else mesh.shape.get(MODEL_AXIS, 1)


def mesh_shape(mesh: Mesh | None) -> dict[str, int] | None:
    """The axis sizes of `mesh` (None for one device)."""
    return None if mesh is None else dict(mesh.shape)
