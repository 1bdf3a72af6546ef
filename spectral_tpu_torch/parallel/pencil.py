"""Pencil-decomposed spectral transforms over a process mesh.

Counterpart of ``spectral_tpu/parallel/pencil.py``, in explicit SPMD: each
process holds its slab; a derivative along an unsharded axis is local,
and along a sharded axis an all_to_all exchanges it with a partner axis
(``(axis + 1) % ndim``, or the first unsharded axis of a multi-axis
mesh), so the axis becomes whole in the slab, the derivative runs
locally (K1 on a CUDA slab's last axis), and the exchange goes back.
``apply_axis_pencil`` is the same exchange around any per-axis 1-D
matrix (the sharded fast-diagonalization preconditioner's transforms, the
pressure extrapolation).
"""

from __future__ import annotations

import torch

from spectral_tpu_torch.ops.chebyshev import chebdiff
from spectral_tpu_torch.ops.tensorops import apply_axis_matmul
from spectral_tpu_torch.parallel.mesh import Mesh


def _a2a_start(u: torch.Tensor, split_axis: int, mesh: Mesh, name: str):
    """Issue the tiled all_to_all of ``jax.lax.all_to_all`` on mesh axis
    ``name``: ``split_axis`` of the slab is cut into P equal blocks, block
    j going to process j; returns what ``_a2a_finish`` takes."""
    y = torch.movedim(u, split_axis, 0).contiguous()
    return mesh.all_to_all(y, name) + (mesh.size(name),)


def _a2a_finish(pending, split_axis: int, concat_axis: int) -> torch.Tensor:
    """Wait for an exchange ``_a2a_start`` issued and concatenate the blocks
    received along ``concat_axis`` in process order."""
    out, work, p = pending
    work.wait()
    c = out.shape[0] // p
    others = list(out.shape[1:])
    ca = concat_axis if concat_axis < split_axis else concat_axis - 1
    z = torch.movedim(out.reshape([p, c] + others), 0, 1 + ca)
    z = z.reshape([c] + others[:ca] + [p * others[ca]] + others[ca + 1:])
    return torch.movedim(z, 0, split_axis)


def _all_to_all(u: torch.Tensor, split_axis: int, concat_axis: int, mesh: Mesh,
                name: str) -> torch.Tensor:
    """The tiled all_to_all (``_a2a_start``, then ``_a2a_finish``)."""
    if mesh.size(name) == 1:
        return u
    return _a2a_finish(_a2a_start(u, split_axis, mesh, name), split_axis, concat_axis)


def _check_partner(u: torch.Tensor, partner: int, mesh: Mesh, name: str) -> None:
    p = mesh.size(name)
    if u.shape[partner] % p:
        raise ValueError(f"axis {partner} extent {u.shape[partner]} not divisible by "
                         f"mesh axis {name!r} size {p}")


def _exchanged(u: torch.Tensor, axis: int, partner: int, mesh: Mesh, name: str, fn):
    """fn on the slab with ``axis`` made whole by the partner exchange."""
    _check_partner(u, partner, mesh, name)
    t = fn(_all_to_all(u, partner, axis, mesh, name))
    return _all_to_all(t, axis, partner, mesh, name)


def _partner(u: torch.Tensor, axis_map: dict[int, str]) -> int:
    partners = [a for a in range(u.ndim) if a not in axis_map]
    if not partners:
        raise ValueError("need at least one unsharded grid axis to exchange with")
    return partners[0]


def chebdiff_pencil(u: torch.Tensor, axis: int, mesh: Mesh, *, sharded_axis: int = 0,
                    mesh_axis: str = "x", method: str = "auto") -> torch.Tensor:
    """Derivative along ``axis`` of this process' slab of a grid sharded on
    ``sharded_axis`` over mesh axis ``mesh_axis``: local along another
    axis; along the sharded one, exchanged with axis (axis + 1) % ndim,
    whose extent must be divisible by the mesh axis' size."""
    if axis != sharded_axis:
        return chebdiff(u, axis, method)
    return _exchanged(u, axis, (axis + 1) % u.ndim, mesh, mesh_axis,
                      lambda t: chebdiff(t, axis, method))


def chebdiff_pencil2(u: torch.Tensor, axis: int, mesh: Mesh, axis_map: dict[int, str], *,
                     method: str = "auto") -> torch.Tensor:
    """Derivative on a slab of a grid sharded over a multi-axis mesh
    (``axis_map``: grid axis -> mesh axis name, the P x Q pencil): local
    along an unsharded axis; along a sharded one, one exchange on its mesh
    axis with the first unsharded grid axis."""
    if axis not in axis_map:
        return chebdiff(u, axis, method)
    return _exchanged(u, axis, _partner(u, axis_map), mesh, axis_map[axis],
                      lambda t: chebdiff(t, axis, method))


def chebdiff_pencil_pipelined(u: torch.Tensor, axis: int, mesh: Mesh, *,
                              sharded_axis: int = 0, mesh_axis: str = "x",
                              method: str = "auto", chunks: int = 2) -> torch.Tensor:
    """``chebdiff_pencil`` with the exchange split into ``chunks``
    independent (exchange, derivative, exchange) chains along a third
    axis: every chunk's forward exchange is issued at once (``async_op``),
    and each chunk's derivative runs while the later chunks' exchanges and
    the earlier chunks' return exchanges are in flight.  Mathematically
    identical; falls back to ``chebdiff_pencil`` for an unsharded axis,
    ``chunks <= 1``, a mesh axis of one process, or no third axis whose
    extent ``chunks`` divides (the JAX package's rules)."""
    partner = (axis + 1) % u.ndim
    batch_axes = [a for a in range(u.ndim)
                  if a not in (axis, partner) and u.shape[a] % chunks == 0]
    if axis != sharded_axis or chunks <= 1 or not batch_axes or mesh.size(mesh_axis) == 1:
        return chebdiff_pencil(u, axis, mesh, sharded_axis=sharded_axis,
                               mesh_axis=mesh_axis, method=method)
    _check_partner(u, partner, mesh, mesh_axis)
    fwd = [_a2a_start(part, partner, mesh, mesh_axis)
           for part in torch.chunk(u, chunks, dim=batch_axes[0])]
    back = [_a2a_start(chebdiff(_a2a_finish(f, partner, axis), axis, method), axis, mesh,
                       mesh_axis)
            for f in fwd]
    return torch.cat([_a2a_finish(b, axis, partner) for b in back], dim=batch_axes[0])


def apply_axis_pencil(M: torch.Tensor, u: torch.Tensor, axis: int, mesh: Mesh | None,
                      axis_map: dict[int, str] | None = None) -> torch.Tensor:
    """y = M applied along ``axis`` (``apply_axis_matmul``) of a slab: local
    when the axis is unsharded (or there is no mesh), else through the
    pencil exchange with the first unsharded axis."""
    if mesh is None or axis_map is None or axis not in axis_map:
        return apply_axis_matmul(M, u, axis)
    return _exchanged(u, axis, _partner(u, axis_map), mesh, axis_map[axis],
                      lambda t: apply_axis_matmul(M, t, axis))


def make_dif(mesh: Mesh | None, axis_map: dict[int, str] | None = None, *,
             sharded_axis: int = 0, mesh_axis: str = "x", method: str = "auto",
             pipeline_chunks: int = 1):
    """Derivative dispatcher for model operators: plain ``chebdiff``
    without a mesh; the single-axis pencil (pipelined over
    ``pipeline_chunks`` when > 1) with a mesh and no ``axis_map``; the
    multi-axis pencil with one."""
    if mesh is None:
        return lambda v, ax: chebdiff(v, ax, method)
    if axis_map is None:
        if pipeline_chunks > 1:
            return lambda v, ax: chebdiff_pencil_pipelined(
                v, ax, mesh, sharded_axis=sharded_axis, mesh_axis=mesh_axis,
                method=method, chunks=pipeline_chunks)
        return lambda v, ax: chebdiff_pencil(v, ax, mesh, sharded_axis=sharded_axis,
                                             mesh_axis=mesh_axis, method=method)
    return lambda v, ax: chebdiff_pencil2(v, ax, mesh, axis_map, method=method)
