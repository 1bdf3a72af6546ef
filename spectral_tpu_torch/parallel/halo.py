"""Halo exchange for stencil operators on sharded grids.

Counterpart of ``spectral_tpu/parallel/halo.py``: the low-order FD
surrogate needs a one-deep halo along the sharded axis.  ``halo_shift``
is ``ops.stencil.shift`` on a slab: the neighbour's edge plane arrives by
point-to-point exchange (``torch.distributed.batch_isend_irecv``), and
the grid's global ends stay zero-filled (the dropped boundary couplings).
"""

from __future__ import annotations

import dataclasses

import torch

from spectral_tpu_torch.ops.stencil import StencilOp, shift
from spectral_tpu_torch.parallel.mesh import Mesh


def _shift_with_halo(x: torch.Tensor, axis: int, s: int, mesh: Mesh, name: str) -> torch.Tensor:
    """y_i = x_{i+s} (|s| = 1) on a slab, across slab edges."""
    y = shift(x, axis, s)
    p, me = mesh.size(name), mesh.index(name)
    if p == 1:
        return y
    n = x.shape[axis]
    first, last = x.narrow(axis, 0, 1), x.narrow(axis, n - 1, 1)
    if s > 0:
        # my first plane to the previous process; the next one's into my last slot
        got = mesh.sendrecv(first if me > 0 else None, me - 1,
                            first if me < p - 1 else None, me + 1, name)
        if got is not None:
            y.narrow(axis, n - 1, 1).copy_(got)
    else:
        got = mesh.sendrecv(last if me < p - 1 else None, me + 1,
                            last if me > 0 else None, me - 1, name)
        if got is not None:
            y.narrow(axis, 0, 1).copy_(got)
    return y


def halo_shift(x: torch.Tensor, axis: int, s: int, mesh: Mesh, sharded_axis: int = 0,
               mesh_axis: str = "x", axis_map: dict | None = None) -> torch.Tensor:
    """``shift`` of this process' slab of a grid sharded on ``sharded_axis``
    over ``mesh_axis`` (or on every axis of ``axis_map``, grid axis ->
    mesh axis name), zero fill at the global ends."""
    amap = axis_map or {sharded_axis: mesh_axis}
    if axis in amap:
        return _shift_with_halo(x, axis, s, mesh, amap[axis])
    return shift(x, axis, s)


def stencil_apply_sharded(S: StencilOp, x: torch.Tensor, mesh: Mesh, sharded_axis: int = 0,
                          mesh_axis: str = "x", axis_map: dict | None = None) -> torch.Tensor:
    """Apply a stencil to a slab (its coefficient fields sliced the same
    way); the shifts along a sharded axis take the neighbours' planes."""
    def b(c):
        return c.reshape(c.shape + (1,) * (x.ndim - c.ndim)) if x.ndim > c.ndim else c

    y = b(S.center) * x
    for ax in range(S.grid_ndim):
        xm = halo_shift(x, ax, -1, mesh, sharded_axis, mesh_axis, axis_map)
        xp = halo_shift(x, ax, +1, mesh, sharded_axis, mesh_axis, axis_map)
        y = y + b(S.lower[ax]) * xm + b(S.upper[ax]) * xp
    return y


@dataclasses.dataclass(frozen=True)
class SlabStencilOp(StencilOp):
    """A stencil whose coefficient fields are this process' slab
    (``Slab.stencil``): its apply and its shifts take the neighbours'
    edge planes along the sharded axes, so the smoothers and line sweeps
    that call ``S.apply`` and ``S.shift`` run on slabs unchanged."""

    slab: object = None

    def shift(self, x: torch.Tensor, axis: int, s: int) -> torch.Tensor:
        return self.slab.shift(x, axis, s)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return stencil_apply_sharded(self, x, self.slab.mesh, axis_map=self.slab.axis_map)
