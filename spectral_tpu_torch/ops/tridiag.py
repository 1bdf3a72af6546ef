"""Batched tridiagonal (line) solves and line smoothers.

Counterpart of ``spectral_tpu/ops/tridiag.py``.  Two jobs:

1. line smoothers for multigrid and the velocity PC: the CGL mesh has
   cells of aspect ~n near the boundary, where point smoothers stall;
   solving whole lines along an axis restores mesh-independent smoothing;
2. the one-sided mixed/Neumann traction rows (StokesPCSetUp0,
   stokes.C:1183-1199) couple a boundary node to the first interior
   layer along its normal, so a boundary-normal line solve inverts them
   exactly inside the preconditioner.

``thomas`` is the two-pass Thomas algorithm as a Python loop over the
line axis, batched over every other axis and any trailing component
axes.  ``LineSolver`` holds the per-line dense inverse (a batched
``torch.linalg.inv`` at PC setup), applied as one batched ``torch.matmul``:
neither is a kernel of the JAX package (XLA's inverse and einsum there).

On a slab of a sharded grid (``slab=``, ``parallel.slab.Slab``) a line
along an unsharded axis is local; a line along a sharded axis is made
whole by the pencil exchange with the partner axis, solved, and sent
back (the ``apply_axis_pencil`` pattern), its inverses built on that
transposed layout.  A slab's stencil (``SlabStencilOp``) takes its
neighbours' planes in the sweeps' shifts.
"""

from __future__ import annotations

import dataclasses

import torch

from spectral_tpu_torch.ops.stencil import StencilOp


def _expand(c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Broadcast a grid-shaped coefficient over trailing component axes."""
    if x.ndim > c.ndim:
        return c.reshape(c.shape + (1,) * (x.ndim - c.ndim))
    return c


def thomas(lower: torch.Tensor, center: torch.Tensor, upper: torch.Tensor,
           rhs: torch.Tensor, axis: int) -> torch.Tensor:
    """Solve per-line tridiagonal systems along ``axis``.

    Row i of each line: lower_i x_{i-1} + center_i x_i + upper_i x_{i+1}
    = rhs_i (the StencilOp single-axis convention).  The coefficients have
    the grid shape (or the mask's, with a trailing component axis); rhs
    may carry extra trailing component axes.  Rows with center 0 are
    identities."""
    axis = axis % center.ndim
    a = torch.movedim(_expand(lower, rhs), axis, 0)
    b = torch.movedim(_expand(center, rhs), axis, 0)
    c = torch.movedim(_expand(upper, rhs), axis, 0)
    r = torch.movedim(rhs, axis, 0)
    b = torch.where(b == 0, 1.0, b)
    cp_prev = rp_prev = torch.zeros_like(r[0])
    cps, rps = [], []
    for i in range(r.shape[0]):
        denom = b[i] - a[i] * cp_prev
        denom = torch.where(denom == 0, 1e-30, denom)
        cp_prev = c[i] / denom
        rp_prev = (r[i] - a[i] * rp_prev) / denom
        cps.append(cp_prev)
        rps.append(rp_prev)
    x_next = torch.zeros_like(r[0])
    xs = [None] * len(rps)
    for i in reversed(range(len(rps))):
        x_next = rps[i] - cps[i] * x_next
        xs[i] = x_next
    return torch.movedim(torch.stack(xs), 0, axis)


@dataclasses.dataclass(frozen=True)
class LineSolver:
    """Per-line dense inverses along one axis, built once per PC setup
    (lines x n^2 values) and applied as one batched product."""

    axis: int
    Tinv: torch.Tensor   # coefficient dims with ``axis`` moved last, then (n, n)
    slab: object = None  # parallel.slab.Slab: the lines of a slab

    @staticmethod
    def build(lower: torch.Tensor, center: torch.Tensor, upper: torch.Tensor,
              axis: int, mask: torch.Tensor | None = None, slab=None) -> "LineSolver":
        """Coefficients follow the StencilOp single-axis convention; with
        ``mask`` (True = free dof, may add trailing component axes),
        masked rows become identities.  With a component mask the lines
        run along ``axis`` of the grid, one set per component: the
        component axis is never the line axis.  With ``slab`` the
        coefficients are the global grid's, and the solver keeps the
        inverses of this process' lines (on the exchanged layout along a
        sharded axis)."""
        if slab is not None:
            dims = center.shape
            sl = (slab.pencil_slices(dims, axis) if axis in slab.axis_map
                  else slab.slices(dims))
            lower, center, upper = lower[sl], center[sl], upper[sl]
            mask = None if mask is None else mask[sl]
        if mask is not None:
            mf = mask.to(lower.dtype)
            lower = torch.where(mask, _expand(lower, mf), 0.0)
            upper = torch.where(mask, _expand(upper, mf), 0.0)
            center = torch.where(mask, _expand(center, mf), 1.0)
        axis = axis % min(lower.ndim, center.ndim)
        a = torch.movedim(lower, axis, -1)
        b = torch.movedim(center, axis, -1)
        c = torch.movedim(upper, axis, -1)
        b = torch.where(b == 0, 1.0, b)
        n = b.shape[-1]
        eye = torch.eye(n, dtype=b.dtype, device=b.device)
        sub = torch.diag(torch.ones(n - 1, dtype=b.dtype, device=b.device), -1)
        sup = torch.diag(torch.ones(n - 1, dtype=b.dtype, device=b.device), 1)
        T = b[..., :, None] * eye + a[..., :, None] * sub + c[..., :, None] * sup
        return LineSolver(axis=axis, Tinv=torch.linalg.inv(T), slab=slab)

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        if self.slab is not None:
            return self.slab.exchanged(rhs, self.axis, self._solve)
        return self._solve(rhs)

    def _solve(self, rhs: torch.Tensor) -> torch.Tensor:
        rm = torch.movedim(rhs, self.axis, -1)
        Ti = self.Tinv
        extra = rm.ndim - (Ti.ndim - 1)
        if extra > 0:      # rhs carries component axes the inverses do not
            Ti = Ti.reshape(Ti.shape[:-2] + (1,) * extra + Ti.shape[-2:])
        x = torch.matmul(Ti, rm[..., None])[..., 0]
        return torch.movedim(x, -1, self.axis)


def build_line_solvers(S: StencilOp, axes: tuple[int, ...],
                       mask: torch.Tensor | None = None, slab=None) -> tuple:
    """A LineSolver per axis, for line_smooth(..., solvers=...); with
    ``slab``, S and ``mask`` are the global grid's and the solvers keep
    this process' lines."""
    return tuple(LineSolver.build(S.lower[ax], S.center, S.upper[ax], ax, mask=mask,
                                  slab=slab)
                 for ax in axes)


def line_smooth(S: StencilOp, x: torch.Tensor, b: torch.Tensor,
                axes: tuple[int, ...], sweeps: int = 1,
                mask: torch.Tensor | None = None,
                solvers: tuple | None = None) -> torch.Tensor:
    """Alternating-direction line relaxation for a (2d+1)-point StencilOp.

    One sweep along an axis solves the tridiagonal part of S along it
    exactly, lagging the cross-axis couplings: T_ax x_new = b - (S x -
    T_ax x).  ``mask`` (broadcastable to x, True = free dof) turns masked
    rows into identities with zero right-hand side per component, so a
    component-dependent mask (the removed normal component at mixed Stokes
    nodes) does not spread a masked row's value along its line.
    ``solvers`` (from build_line_solvers, one per entry of ``axes``)
    replaces the Thomas loop by the dense inverses; a slab's sweep
    (``SlabStencilOp``) needs them."""
    for _ in range(sweeps):
        for i, ax in enumerate(axes):
            laE = _expand(S.lower[ax], x)
            ceE = _expand(S.center, x)
            uaE = _expand(S.upper[ax], x)
            tx = ceE * x + laE * S.shift(x, ax, -1) + uaE * S.shift(x, ax, +1)
            rhs = b - (S.apply(x) - tx)
            if mask is not None:
                rhs = torch.where(mask, rhs, 0.0)
            if solvers is not None:
                x = solvers[i].solve(rhs)
                continue
            if mask is not None:
                laE = torch.where(mask, laE, 0.0)
                uaE = torch.where(mask, uaE, 0.0)
                ceE = torch.where(mask, ceE, 1.0)
            x = thomas(laE, ceE, uaE, rhs, ax)
    return x
