"""Process meshes: named axes over the processes of ``torch.distributed``.

Counterpart of ``spectral_tpu/parallel/mesh.py``.  A ``Mesh`` lays the
world's ranks out row-major over named axes (``make_mesh({"x": 2, "y":
2})``) and holds one process group per axis: the ranks that differ only
in that axis' coordinate.  It carries the exchanges the operators need,
each on plain tensors:

- ``allreduce`` (sum over every process: the Krylov inner products);
- ``all_to_all`` (the pencil transpose, on an axis' group);
- ``sendrecv`` (the halo planes, point to point on an axis' group);
- ``all_gather`` (``gather_tensor``).

The comm path is chosen once, when the mesh is built, from the backend:
NCCL takes CUDA tensors as they are, and so does gloo for every exchange
but the ones ``GLOO_CUDA_STAGED`` lists (point to point), which a gloo
mesh stages through pinned host buffers whenever the tensors handed to
them are CUDA tensors.  ``Mesh.comm_path`` names the choice.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import os

import numpy as np
import torch
import torch.distributed as dist

# exchanges that gloo cannot take on CUDA tensors, which a mesh on the
# gloo backend stages through pinned host memory when given CUDA tensors.  On the
# H100 machine's PyTorch 2.11 (cu128) gloo takes all_reduce,
# all_to_all_single, all_gather and broadcast on CUDA tensors and aborts
# the process on a CUDA send/recv (gloo_cuda_probe.py)
GLOO_CUDA_STAGED = frozenset({"sendrecv"})

# exchanges this process issued, by kind (a mesh of one issues none); the
# caller clears it before a run and reads it after
EXCHANGES: collections.Counter = collections.Counter()


@dataclasses.dataclass(eq=False)
class Mesh:
    """Named mesh axes over ``torch.distributed`` ranks (row-major)."""

    names: tuple[str, ...]
    shape: tuple[int, ...]
    rank: int
    coords: tuple[int, ...]
    groups: dict                 # axis name -> (process group, global ranks of the group)
    staged: frozenset            # exchanges whose CUDA tensors go through pinned host memory

    def size(self, name: str) -> int:
        return self.shape[self.names.index(name)]

    def index(self, name: str) -> int:
        """This process' coordinate along mesh axis ``name``."""
        return self.coords[self.names.index(name)]

    @property
    def comm_path(self) -> str:
        backend = dist.get_backend() if dist.is_initialized() else "none"
        if not self.staged:
            return f"{backend}, tensors as they are"
        return (f"{backend}; CUDA tensors staged through pinned host memory: "
                f"{', '.join(sorted(self.staged))}")

    # -- exchanges ---------------------------------------------------------
    @staticmethod
    def _to_host(t: torch.Tensor) -> torch.Tensor:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        return h

    def allreduce(self, t: torch.Tensor) -> torch.Tensor:
        """t summed over every process of the mesh (in place, returned)."""
        if math.prod(self.shape) > 1:
            EXCHANGES["allreduce"] += 1
            dist.all_reduce(t)
        return t

    def allmax(self, t: torch.Tensor) -> torch.Tensor:
        """t's elementwise maximum over every process (in place, returned)."""
        if math.prod(self.shape) > 1:
            EXCHANGES["allreduce"] += 1
            dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return t

    def all_to_all(self, y: torch.Tensor, name: str):
        """``all_to_all_single`` on axis ``name``'s group with equal splits
        of y's leading dimension, issued without waiting: (the result, its
        work handle), to be read after ``wait()``.  Block j goes to the
        axis' j-th process, block i of the result came from the i-th."""
        EXCHANGES["all_to_all"] += 1
        out = torch.empty_like(y)
        return out, dist.all_to_all_single(out, y, group=self.groups[name][0], async_op=True)

    def sendrecv(self, send, to: int, like, frm: int, name: str):
        """Point to point on axis ``name``: send ``send`` (unless None) to the
        process at coordinate ``to``, and receive a tensor shaped like
        ``like`` (unless None) from the one at ``frm``; returns it on
        ``like``'s device (None without a receive).  CUDA tensors go
        through pinned host memory where the mesh's comm path says so."""
        group, ranks = self.groups[name]
        EXCHANGES["sendrecv"] += 1
        ops, got = [], None
        if send is not None:
            staged = "sendrecv" in self.staged and send.is_cuda
            s = self._to_host(send) if staged else send.contiguous()
            ops.append(dist.P2POp(dist.isend, s, ranks[to], group=group))
        if like is not None:
            staged = "sendrecv" in self.staged and like.is_cuda
            got = (torch.empty(like.shape, dtype=like.dtype, pin_memory=True) if staged
                   else torch.empty_like(like))
            ops.append(dist.P2POp(dist.irecv, got, ranks[frm], group=group))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        return got.to(like.device) if got is not None else got

    def all_gather(self, t: torch.Tensor, name: str) -> list:
        group, ranks = self.groups[name]
        EXCHANGES["all_gather"] += 1
        outs = [torch.empty_like(t) for _ in ranks]
        dist.all_gather(outs, t.contiguous(), group=group)
        return outs


def initialize_distributed(**kwargs) -> None:
    """``torch.distributed.init_process_group(**kwargs)`` for a
    multi-process run: a no-op when the default group already exists, or
    in a single process (no ``world_size`` argument and no WORLD_SIZE in
    the environment, or a world of one)."""
    if dist.is_initialized():
        return
    world = kwargs.get("world_size", os.environ.get("WORLD_SIZE"))
    if world is None or int(world) <= 1:
        return
    dist.init_process_group(**kwargs)


def make_mesh(axes: dict[str, int] | None = None) -> Mesh:
    """A mesh from named axis sizes, e.g. make_mesh({"x": 2, "y": 2}),
    whose product must equal the world size (every process calls it, in
    the same order); with no argument every process lies on one "x" axis.
    The backend selects the comm path: on gloo, the exchanges of
    ``GLOO_CUDA_STAGED`` go through pinned host memory when they are given
    CUDA tensors.  Without a process group, a mesh of one."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    axes = {"x": world} if axes is None else dict(axes)
    names, shape = tuple(axes), tuple(int(v) for v in axes.values())
    if math.prod(shape) != world:
        raise RuntimeError(f"mesh {axes} needs {math.prod(shape)} processes, have {world}")
    layout = np.arange(world).reshape(shape)
    coords = tuple(int(c) for c in np.unravel_index(rank, shape))
    groups = {}
    for i, name in enumerate(names):
        lines = np.moveaxis(layout, i, -1).reshape(-1, shape[i])
        for line in lines:
            ranks = [int(r) for r in line]
            group = dist.new_group(ranks) if world > 1 else None
            if rank in ranks:
                groups[name] = (group, ranks)
    staged = frozenset()
    if world > 1 and dist.get_backend() == "gloo":
        staged = GLOO_CUDA_STAGED
    return Mesh(names, shape, rank, coords, groups, staged)


def local_slices(mesh: Mesh, dims: tuple[int, ...], axis_map: dict[int, str]) -> tuple:
    """This process' slab of a grid of ``dims`` (the ``grid_sharding``
    analog): grid axis -> mesh axis name, equal blocks in rank order."""
    sl = [slice(None)] * len(dims)
    for ax, name in axis_map.items():
        p = mesh.size(name)
        if dims[ax] % p:
            raise ValueError(f"grid axis {ax} extent {dims[ax]} not divisible by "
                             f"mesh axis {name!r} size {p}")
        c = dims[ax] // p
        sl[ax] = slice(mesh.index(name) * c, (mesh.index(name) + 1) * c)
    return tuple(sl)


def shard_tensor(t: torch.Tensor, mesh: Mesh, axis_map: dict[int, str]) -> torch.Tensor:
    """This process' slab of a global tensor (leading grid axes; trailing
    component axes whole), a contiguous copy."""
    return t[local_slices(mesh, t.shape, axis_map)].contiguous()


def gather_tensor(t: torch.Tensor, mesh: Mesh, axis_map: dict[int, str]) -> torch.Tensor:
    """The global tensor from every process' slab (every process gets it)."""
    for ax, name in axis_map.items():
        if mesh.size(name) > 1:
            t = torch.cat(mesh.all_gather(t, name), dim=ax)
    return t
