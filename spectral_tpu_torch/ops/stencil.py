"""Low-order finite-difference rediscretization as stencil coefficient fields.

Counterpart of ``spectral_tpu/ops/stencil.py``: a (2d+1)-point stencil on
a tensor grid is stored as coefficient fields on the grid (center plus
lower/upper per axis), applied as shifted elementwise products.  Dirichlet
rows are identity and couplings into the boundary are dropped.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
import torch.utils._pytree

from spectral_tpu_torch.grid import Grid


def shift(x: torch.Tensor, axis: int, s: int) -> torch.Tensor:
    """y_i = x_{i+s} along ``axis``, zero-filled at the ends (|s| small)."""
    if s == 0:
        return x
    n = x.shape[axis]
    y = torch.zeros_like(x)
    if s > 0:
        y.narrow(axis, 0, n - s).copy_(x.narrow(axis, s, n - s))
    else:
        y.narrow(axis, -s, n + s).copy_(x.narrow(axis, 0, n + s))
    return y


def fd1d_coeffs(z: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Non-uniform 3-point second-derivative row coefficients (negated),
    the entries of the reference's AssemblePoissonPC2; boundary rows zero."""
    n = len(z)
    lower = np.zeros(n)
    center = np.zeros(n)
    upper = np.zeros(n)
    zm, z0, zp = z[:-2], z[1:-1], z[2:]
    lower[1:-1] = -1.0 / ((zm - z0) * (zm - zp))
    center[1:-1] = -1.0 / ((z0 - zm) * (z0 - zp))
    upper[1:-1] = -1.0 / ((zp - zm) * (zp - z0))
    return lower, center, upper


def _bcast_axis(a: np.ndarray, axis: int, ndim: int) -> np.ndarray:
    shape = [1] * ndim
    shape[axis] = len(a)
    return a.reshape(shape)


@dataclasses.dataclass(frozen=True)
class StencilOp:
    """A (2d+1)-point stencil operator as coefficient fields:

      y = center*x + sum_j lower[j]*shift(x, j, -1) + upper[j]*shift(x, j, +1)

    Extra trailing axes of x are broadcast.
    """

    center: torch.Tensor
    lower: tuple[torch.Tensor, ...]
    upper: tuple[torch.Tensor, ...]

    @property
    def grid_ndim(self) -> int:
        return self.center.ndim

    def _b(self, c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        if x.ndim > c.ndim:
            return c.reshape(c.shape + (1,) * (x.ndim - c.ndim))
        return c

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        y = self._b(self.center, x) * x
        for ax in range(self.grid_ndim):
            y = y + self._b(self.lower[ax], x) * shift(x, ax, -1)
            y = y + self._b(self.upper[ax], x) * shift(x, ax, +1)
        return y

    def shift(self, x: torch.Tensor, axis: int, s: int) -> torch.Tensor:
        """``shift`` along a grid axis of a field this stencil acts on (a
        slab's stencil takes its neighbours' planes)."""
        return shift(x, axis, s)

    def diag(self) -> torch.Tensor:
        return self.center

    def as_dense_np(self) -> np.ndarray:
        """Materialize as a dense float64 (size, size) matrix."""
        center = self.center.detach().cpu().double().numpy()
        dims = center.shape
        size = math.prod(dims)
        A = np.zeros((size, size))
        A[np.arange(size), np.arange(size)] = center.reshape(-1)
        strides = np.array([math.prod(dims[j + 1:]) for j in range(len(dims))])
        idx = np.indices(dims).reshape(len(dims), -1)
        flat = np.arange(size)
        for ax in range(len(dims)):
            lo = self.lower[ax].detach().cpu().double().numpy().reshape(-1)
            up = self.upper[ax].detach().cpu().double().numpy().reshape(-1)
            has_m = idx[ax] > 0
            has_p = idx[ax] < dims[ax] - 1
            A[flat[has_m], flat[has_m] - strides[ax]] += lo[has_m]
            A[flat[has_p], flat[has_p] + strides[ax]] += up[has_p]
        return A


# a pytree of its coefficient fields, so a family's multigrid setup maps
# over the batch (torch.func.vmap) and returns batched stencils
torch.utils._pytree.register_dataclass(StencilOp)


def poisson_fd_stencil(grid: Grid, dtype: torch.dtype | None = None) -> StencilOp:
    """d-dimensional FD Laplacian surrogate on CGL nodes (host float64
    assembly, cast once to ``dtype`` on the grid's device): interior rows
    are the Kronecker sum of 1-D non-uniform stencils, Dirichlet rows
    identity, couplings into the boundary dropped."""
    dtype = dtype or grid.dtype
    d = grid.ndim
    center = np.zeros(grid.dims)
    lowers, uppers = [], []
    interior = ~grid.boundary_mask_np

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=grid.device)

    for ax in range(d):
        lo1, c1, up1 = fd1d_coeffs(grid.nodes_1d[ax])
        center += _bcast_axis(c1, ax, d)
        lo = np.broadcast_to(_bcast_axis(lo1, ax, d), grid.dims).copy()
        up = np.broadcast_to(_bcast_axis(up1, ax, d), grid.dims).copy()
        lo[~interior] = 0.0
        up[~interior] = 0.0
        lo[~np.roll(interior, 1, axis=ax)] = 0.0   # neighbor i-1 on boundary
        up[~np.roll(interior, -1, axis=ax)] = 0.0  # neighbor i+1 on boundary
        lowers.append(dev(lo))
        uppers.append(dev(up))
    center[~interior] = 1.0
    return StencilOp(dev(center), tuple(lowers), tuple(uppers))


def elliptic_jacobian_stencil(grid: Grid, eta: torch.Tensor, deta: torch.Tensor,
                              gradu: Sequence[torch.Tensor]) -> StencilOp:
    """Variable-coefficient FD stencil of the linearized elliptic operator
    (FormJacobian, elliptic.C:537-590): flux-form FD of -div(eta grad .)
    plus the Newton term deta * grad(u0), with midpoint (arithmetic-mean)
    coefficients.  Dirichlet rows identity, couplings into the boundary
    dropped.  Runs in eta's dtype on eta's device."""
    d = grid.ndim
    interior = grid.interior_mask.to(eta.device)
    zero = torch.zeros((), dtype=eta.dtype, device=eta.device)
    center = torch.zeros(grid.dims, dtype=eta.dtype, device=eta.device)
    lowers, uppers = [], []

    def dev(a):
        return torch.as_tensor(a, dtype=eta.dtype, device=eta.device)

    for ax in range(d):
        z = grid.nodes_1d[ax]
        n = len(z)
        idxM = np.zeros(n)
        idxP = np.zeros(n)
        idx = np.zeros(n)
        idxM[1:-1] = 1.0 / (z[1:-1] - z[:-2])
        idxP[1:-1] = 1.0 / (z[2:] - z[1:-1])
        idx[1:-1] = 2.0 / (z[2:] - z[:-2])
        idxM = dev(_bcast_axis(idxM, ax, d))
        idxP = dev(_bcast_axis(idxP, ax, d))
        idx = dev(_bcast_axis(idx, ax, d))
        etaM = 0.5 * (shift(eta, ax, -1) + eta)
        etaP = 0.5 * (shift(eta, ax, +1) + eta)
        detaM = 0.5 * (shift(deta, ax, -1) + deta)
        detaP = 0.5 * (shift(deta, ax, +1) + deta)
        gu = gradu[ax]
        guM = 0.5 * (shift(gu, ax, -1) + gu)
        guP = 0.5 * (shift(gu, ax, +1) + gu)
        lo = -idx * (idxM * etaM - 0.5 * detaM * guM)
        up = -idx * (idxP * etaP + 0.5 * detaP * guP)
        center = center + idx * (idxP * etaP + idxM * etaM
                                 - 0.5 * (detaP * guP - detaM * guM))
        lowers.append(torch.where(interior & shift(interior, ax, -1), lo, zero))
        uppers.append(torch.where(interior & shift(interior, ax, +1), up, zero))
    center = torch.where(interior, center, torch.ones((), dtype=eta.dtype,
                                                      device=eta.device))
    return StencilOp(center, tuple(lowers), tuple(uppers))


def anisotropic_fd_stencil(grid: Grid, caxes: Sequence[torch.Tensor],
                           row_scale: torch.Tensor | None = None,
                           neumann_axes: Sequence[int] = (),
                           with_folds: bool = False):
    """Variable-coefficient FD stencil of -sum_i d_i(c_i(x) d_i .) with a
    different coefficient field per axis (midpoint arithmetic means), plus
    an optional interior row scaling.  Dirichlet rows identity, couplings
    into the boundary dropped: the anisotropic generalization of
    ``elliptic_jacobian_stencil``'s flux form.  Runs in the coefficients'
    dtype on their device.

    ``neumann_axes``: axes whose end faces carry a zero-flux row
    (u_end - u_adj)/h = r instead of the Dirichlet identity; the
    first-interior center absorbs the (dropped) coupling into the face, as
    in ``ops/fastdiag.py``.  With ``with_folds`` returns (StencilOp, folds),
    folds[ax] = (h_lo, f_lo, h_hi, f_hi): the 1-D end spacings and the
    full-grid fold-coefficient fields (the scaled face coupling, nonzero
    only on the face-adjacent interior slice)."""
    d = grid.ndim
    c0 = caxes[0]
    dtype, device = c0.dtype, c0.device
    interior = grid.interior_mask.to(device)
    zero = torch.zeros((), dtype=dtype, device=device)
    center = torch.zeros(grid.dims, dtype=dtype, device=device)
    lowers, uppers = [], []
    folds: dict = {}

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    for ax in range(d):
        z = grid.nodes_1d[ax]
        n = len(z)
        idxM = np.zeros(n)
        idxP = np.zeros(n)
        idx = np.zeros(n)
        idxM[1:-1] = 1.0 / (z[1:-1] - z[:-2])
        idxP[1:-1] = 1.0 / (z[2:] - z[1:-1])
        idx[1:-1] = 2.0 / (z[2:] - z[:-2])
        idxM = dev(_bcast_axis(idxM, ax, d))
        idxP = dev(_bcast_axis(idxP, ax, d))
        idx = dev(_bcast_axis(idx, ax, d))
        c = caxes[ax]
        cM = 0.5 * (shift(c, ax, -1) + c)
        cP = 0.5 * (shift(c, ax, +1) + c)
        lo = -idx * idxM * cM
        up = -idx * idxP * cP
        center = center + idx * (idxP * cP + idxM * cM)
        if ax in neumann_axes:
            adj_lo = np.zeros(grid.dims, bool)
            adj_hi = np.zeros(grid.dims, bool)
            sl = [slice(None)] * d
            sl[ax] = 1
            adj_lo[tuple(sl)] = True
            sl[ax] = -2
            adj_hi[tuple(sl)] = True
            adj_lo = torch.as_tensor(adj_lo, device=device) & interior
            adj_hi = torch.as_tensor(adj_hi, device=device) & interior
            center = center + torch.where(adj_lo, lo, zero) + torch.where(adj_hi, up, zero)
            if with_folds:
                f_lo = torch.where(adj_lo, lo, zero)
                f_hi = torch.where(adj_hi, up, zero)
                if row_scale is not None:
                    f_lo, f_hi = f_lo * row_scale, f_hi * row_scale
                folds[ax] = (abs(float(z[1] - z[0])), f_lo,
                             abs(float(z[-1] - z[-2])), f_hi)
        lowers.append(torch.where(interior & shift(interior, ax, -1), lo, zero))
        uppers.append(torch.where(interior & shift(interior, ax, +1), up, zero))
    if row_scale is not None:
        center = center * row_scale
        lowers = [lo * row_scale for lo in lowers]
        uppers = [up * row_scale for up in uppers]
    center = torch.where(interior, center, torch.ones((), dtype=dtype, device=device))
    S = StencilOp(center, tuple(lowers), tuple(uppers))
    return (S, folds) if with_folds else S
