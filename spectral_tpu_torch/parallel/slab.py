"""A slab layout: the block of a sharded grid that one process holds.

The models and preconditioners on a mesh (``mesh=``) carry one ``Slab``:
the mesh and the grid axes it shards (``axis_map``, grid axis -> mesh
axis name).  It gathers the operations a solver component needs on its
block in one place:

- ``local`` / ``local_np`` cut a global tensor or host array to the
  slab; ``gather`` rebuilds the global tensor on every process;
- ``shift`` is ``ops.stencil.shift`` across slab edges (a halo plane
  from each neighbour, ``halo.py``), ``stencil`` cuts a global
  ``StencilOp`` to a ``SlabStencilOp`` whose apply takes the halo;
- ``apply_axis`` applies a per-axis matrix, locally along an unsharded
  axis and through the pencil exchange along a sharded one
  (``pencil.apply_axis_pencil``); ``pencil_slices`` is the layout while
  an axis is made whole, for coefficients that travel with it;
- ``allreduce`` / ``dot`` sum over every process (the Krylov and Newton
  reductions); ``divides`` says whether a grid of given extents can be
  laid out as slabs with working pencil exchanges (multigrid levels that
  cannot run replicated).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spectral_tpu_torch.parallel.mesh import Mesh, gather_tensor, local_slices, shard_tensor


@dataclasses.dataclass(frozen=True, eq=False)
class Slab:
    mesh: Mesh
    axis_map: dict            # grid axis -> mesh axis name
    pipeline_chunks: int = 1  # > 1: the chunked pencil exchange in ``dif``

    @staticmethod
    def of(mesh, axis_map=None, sharded_axis: int = 0, mesh_axis: str = "x",
           pipeline_chunks: int = 1):
        """The slab of a model's mesh arguments (None without a mesh)."""
        if mesh is None:
            return None
        return Slab(mesh, dict(axis_map or {sharded_axis: mesh_axis}), pipeline_chunks)

    # -- layout -----------------------------------------------------------
    def slices(self, dims) -> tuple:
        return local_slices(self.mesh, tuple(dims), self.axis_map)

    def local(self, t: torch.Tensor) -> torch.Tensor:
        return shard_tensor(t, self.mesh, self.axis_map)

    def local_np(self, a: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(a[self.slices(a.shape)])

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        return gather_tensor(t, self.mesh, self.axis_map)

    def gather_fields(self, tree):
        """``gather`` of every tensor of a dict / list of coefficient fields."""
        if isinstance(tree, dict):
            return {k: self.gather_fields(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.gather_fields(v) for v in tree)
        return self.gather(tree) if isinstance(tree, torch.Tensor) else tree

    def partner(self, ndim: int) -> int:
        """The grid axis a sharded axis exchanges with (the first unsharded)."""
        return [a for a in range(ndim) if a not in self.axis_map][0]

    def divides(self, dims) -> bool:
        """Whether a grid of ``dims`` lays out as slabs whose pencil
        exchanges work: every sharded extent and the partner's divisible by
        its mesh axis' size."""
        part = self.partner(len(dims))
        return all(dims[ax] % self.mesh.size(n) == 0 and dims[part] % self.mesh.size(n) == 0
                   for ax, n in self.axis_map.items())

    def pencil_slices(self, dims, axis: int) -> tuple:
        """This process' block while sharded ``axis`` is made whole: its mesh
        axis cuts the partner axis instead."""
        amap = {a: n for a, n in self.axis_map.items() if a != axis}
        amap[self.partner(len(dims))] = self.axis_map[axis]
        return local_slices(self.mesh, tuple(dims), amap)

    # -- exchanges --------------------------------------------------------
    def shift(self, x: torch.Tensor, axis: int, s: int) -> torch.Tensor:
        from spectral_tpu_torch.parallel.halo import halo_shift
        return halo_shift(x, axis, s, self.mesh, axis_map=self.axis_map)

    def stencil(self, S):
        """A global StencilOp cut to this slab (``SlabStencilOp``)."""
        from spectral_tpu_torch.parallel.halo import SlabStencilOp
        return SlabStencilOp(self.local(S.center), tuple(self.local(a) for a in S.lower),
                             tuple(self.local(a) for a in S.upper), slab=self)

    def apply_axis(self, M: torch.Tensor, u: torch.Tensor, axis: int) -> torch.Tensor:
        from spectral_tpu_torch.parallel.pencil import apply_axis_pencil
        return apply_axis_pencil(M, u, axis, self.mesh, self.axis_map)

    def exchanged(self, u: torch.Tensor, axis: int, fn) -> torch.Tensor:
        """fn on the slab with sharded ``axis`` made whole (the pencil
        exchange with the partner axis and back); fn itself if unsharded."""
        if axis not in self.axis_map:
            return fn(u)
        from spectral_tpu_torch.parallel.pencil import _exchanged
        return _exchanged(u, axis, self.partner(u.ndim), self.mesh, self.axis_map[axis], fn)

    def dif(self, method: str = "auto"):
        """The derivative dispatcher of the model operators (``make_dif``)."""
        from spectral_tpu_torch.parallel.pencil import make_dif
        if len(self.axis_map) == 1:
            (ax, name), = self.axis_map.items()
            return make_dif(self.mesh, None, sharded_axis=ax, mesh_axis=name, method=method,
                            pipeline_chunks=self.pipeline_chunks)
        return make_dif(self.mesh, self.axis_map, method=method)

    def dif_weight(self, grid, v: torch.Tensor, axis: int) -> torch.Tensor:
        """``grid.apply_dif_weight`` on a slab: a mapped grid's per-node
        chain-rule weights cut to the slab's block of the axis."""
        return grid.apply_dif_weight(v, axis, self.slices(grid.dims)[axis])

    def allreduce(self, t: torch.Tensor) -> torch.Tensor:
        return self.mesh.allreduce(t)

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.mesh.allreduce(torch.dot(a.reshape(-1), b.reshape(-1)))
