"""Fast diagonalization: exact tensor-product solve of the FD surrogate.

Counterpart of ``spectral_tpu/ops/fastdiag.py``.  The constant-coefficient
FD Laplacian on a tensor grid is a Kronecker sum of 1-D tridiagonals, so
its exact inverse is u = V ((V^{-1} f) / (L_0 (+) ... (+) L_{d-1})): each
axis is diagonalized once on the host in numpy float64, and the apply is
per-axis dense products (``torch.tensordot``) on the grid's device.

``apply(slab=)`` is the same solve on one process' slab of a grid
sharded over a mesh (``parallel.slab.Slab``): each axis' factors are
embedded in the full axis (zero boundary rows and columns), so a
transform is one per-axis product, through the pencil exchange along a
sharded axis, and the zero-flux folds keep the mask/roll form, whose
rolls only read a neighbour inside the same slab.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np
import torch

from spectral_tpu_torch.grid import Grid
from spectral_tpu_torch.ops.stencil import fd1d_coeffs


def _interior_tridiag_np(z: np.ndarray) -> np.ndarray:
    """Interior (n-2)x(n-2) tridiagonal of the 1-D FD stencil on nodes z."""
    lo, c, up = fd1d_coeffs(z)
    T = np.diag(c[1:-1])
    T += np.diag(lo[2:-1], k=-1)
    T += np.diag(up[1:-2], k=+1)
    return T


@dataclasses.dataclass(frozen=True)
class FastDiagSolver:
    """Exact solver for the separable FD surrogate with Dirichlet boundary.

    Acts on full-grid tensors; boundary entries pass through unchanged
    (the identity boundary rows of the surrogate), except on zero-flux
    (``neumann_axes``) faces, see ``apply``.
    """

    grid: Grid
    V: tuple[torch.Tensor, ...]      # (m_j, m_j) eigenvector matrices
    Vinv: tuple[torch.Tensor, ...]
    lam_sum: torch.Tensor            # interior-shaped sum of eigenvalues (+ shift)
    shift_const: float = 0.0
    # per-axis (h_lo, f_lo, h_hi, f_hi) zero-flux elimination data, or None
    neumann_fold: tuple = ()

    @staticmethod
    def build(grid: Grid, dtype: torch.dtype | None = None, shift: float = 0.0,
              axis_scale: np.ndarray | None = None,
              neumann_axes: tuple[int, ...] = ()) -> "FastDiagSolver":
        """Diagonalize each axis' interior tridiagonal on the host in float64
        and cast the factors once to ``dtype`` (default: the grid's) on the
        grid's device.

        axis_scale: optional per-axis multiplier of T_j.
        neumann_axes: axes whose both end faces carry a zero-flux row; the
        end values are eliminated exactly (the adjacent interior row
        absorbs the coupling before diagonalization).
        """
        dtype = dtype or grid.dtype
        Vs, Vis, lams = [], [], []
        folds = []
        for ax in range(grid.ndim):
            z = grid.nodes_1d[ax]
            T = _interior_tridiag_np(z)
            s_ax = 1.0 if axis_scale is None else float(axis_scale[ax])
            if ax in neumann_axes:
                lo, c, up = fd1d_coeffs(z)
                T[0, 0] += lo[1]
                T[-1, -1] += up[-2]
                h_lo = abs(z[0] - z[1])
                h_hi = abs(z[-1] - z[-2])
                # python floats: a numpy scalar on the left of a tensor
                # product would convert the tensor to numpy
                folds.append((float(h_lo), float(s_ax * lo[1] * h_lo),
                              float(h_hi), float(s_ax * up[-2] * h_hi)))
            else:
                folds.append(None)
            if axis_scale is not None:
                T = T * float(axis_scale[ax])
            w, V = np.linalg.eig(T)
            order = np.argsort(w.real)
            w, V = w.real[order], V.real[:, order]
            Vs.append(V)
            Vis.append(np.linalg.inv(V))
            lams.append(w)
        lam = np.zeros(tuple(n - 2 for n in grid.dims))
        for ax, w in enumerate(lams):
            shape = [1] * grid.ndim
            shape[ax] = len(w)
            lam = lam + w.reshape(shape)
        return FastDiagSolver.from_factors(grid, Vs, Vis, lam + shift,
                                           shift, tuple(folds), dtype=dtype)

    @staticmethod
    def from_factors(grid: Grid, V, Vinv, lam_sum, shift_const: float = 0.0,
                     neumann_fold: tuple = (), *,
                     dtype: torch.dtype | None = None) -> "FastDiagSolver":
        """A solver from host (numpy float64) factors, cast to ``dtype`` on
        the grid's device."""
        dtype = dtype or grid.dtype

        def dev(a):
            return torch.as_tensor(np.array(a, np.float64), dtype=dtype,
                                   device=grid.device)

        return FastDiagSolver(grid, tuple(dev(a) for a in V),
                              tuple(dev(a) for a in Vinv), dev(lam_sum),
                              float(shift_const), tuple(neumann_fold))

    @staticmethod
    def _apply_axis(M: torch.Tensor, x: torch.Tensor, axis: int) -> torch.Tensor:
        # y[..., i, ...] = sum_j M[i, j] x[..., j, ...]
        return torch.movedim(torch.tensordot(x, M, dims=([axis], [1])), -1, axis)

    def solve_interior(self, r: torch.Tensor, shift=None) -> torch.Tensor:
        """Solve on the interior block (shape dims-2 each axis).

        ``shift`` adds a run-time scalar on top of the build-time
        ``shift_const``: the eigendecomposition is shift-independent."""
        w = r
        for ax in range(self.grid.ndim):
            w = self._apply_axis(self.Vinv[ax], w, ax)
        lam = self.lam_sum
        if w.ndim > lam.ndim:
            lam = lam.reshape(lam.shape + (1,) * (w.ndim - lam.ndim))
        if shift is not None:
            lam = lam + torch.as_tensor(shift, dtype=lam.dtype, device=lam.device)
        w = w / lam
        for ax in range(self.grid.ndim):
            w = self._apply_axis(self.V[ax], w, ax)
        return w

    @cached_property
    def _nm_masks(self) -> dict[int, tuple[torch.Tensor, ...]]:
        """Per zero-flux axis: (face_lo, adj_lo, adj_hi, face_hi) boolean
        masks of the grid's shape on its device: the end / first-interior
        slice along the axis, strictly interior along every other axis
        (nodes shared with another face keep the identity row)."""
        d = self.grid.ndim
        out = {}
        for ax, f in enumerate(self.neumann_fold):
            if f is None:
                continue
            other_interior = np.ones(self.grid.dims, bool)
            for a2 in range(d):
                if a2 == ax:
                    continue
                for end in (0, -1):
                    sl = [slice(None)] * d
                    sl[a2] = end
                    other_interior[tuple(sl)] = False
            masks = []
            for pos in (0, 1, -2, -1):
                m = np.zeros(self.grid.dims, bool)
                sl = [slice(None)] * d
                sl[ax] = pos
                m[tuple(sl)] = True
                masks.append(torch.as_tensor(m & other_interior,
                                             device=self.grid.device))
            out[ax] = tuple(masks)
        return out

    def apply(self, r: torch.Tensor, shift=None, slab=None) -> torch.Tensor:
        """Full-grid preconditioner apply: interior exact solve, boundary
        identity, except zero-flux faces, whose residual is folded into the
        adjacent interior row and whose value is reconstructed from the
        eliminated end row (still an exact solve of the surrogate).

        ``shift`` solves (A + shift_const + shift).  With ``slab``
        (``parallel.slab.Slab``), r is this process' slab of the grid
        (trailing component axes broadcast) and the interior solve runs
        through the pencil exchange (``_solve_slab``); the folds are the
        same."""
        d = self.grid.ndim
        trail = (1,) * (r.ndim - d)
        zero = torch.zeros((), dtype=r.dtype, device=r.device)
        nm = self._nm_masks if slab is None else self._slab_factors(slab)[4]
        masks = {ax: tuple(m.reshape(m.shape + trail) for m in ms) for ax, ms in nm.items()}

        reff = r
        for ax, (face_lo, adj_lo, adj_hi, face_hi) in masks.items():
            h_lo, f_lo, h_hi, f_hi = self.neumann_fold[ax]
            reff = reff + torch.where(adj_lo, torch.roll(r, 1, ax) * -f_lo, zero) \
                        + torch.where(adj_hi, torch.roll(r, -1, ax) * -f_hi, zero)
        if slab is None:
            inner = tuple([slice(1, -1)] * d)
            out = r.clone()
            out[inner] = self.solve_interior(reff[inner], shift=shift).to(r.dtype)
        else:
            out = self._solve_slab(reff, r, slab, shift)
        for ax, (face_lo, adj_lo, adj_hi, face_hi) in masks.items():
            h_lo, f_lo, h_hi, f_hi = self.neumann_fold[ax]
            out = torch.where(face_lo, torch.roll(out, -1, ax) + r * h_lo, out)
            out = torch.where(face_hi, torch.roll(out, 1, ax) + r * h_hi, out)
        return out

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        return self.apply(r)

    @cached_property
    def _slabs(self) -> dict:
        return {}

    def _slab_factors(self, slab):
        """(V, Vinv embedded in the full axes, the full eigenvalue sum with
        ones on the boundary cut to the slab, the interior and zero-flux
        masks cut to the slab), built once a slab."""
        got = self._slabs.get(id(slab))
        if got is not None and got[0] is slab:
            return got[1]
        dt, dev = self.lam_sum.dtype, self.lam_sum.device

        def full(M):
            n = M.shape[0] + 2
            F = torch.zeros((n, n), dtype=dt, device=dev)
            F[1:-1, 1:-1] = M
            return F

        for ax, f in enumerate(self.neumann_fold):
            if f is not None and ax in slab.axis_map and \
                    self.grid.dims[ax] // slab.mesh.size(slab.axis_map[ax]) < 2:
                raise ValueError(f"a zero-flux axis {ax} needs >= 2 nodes a slab")
        lam = torch.ones(self.grid.dims, dtype=dt, device=dev)
        lam[tuple([slice(1, -1)] * self.grid.ndim)] = self.lam_sum
        out = (tuple(full(M) for M in self.V), tuple(full(M) for M in self.Vinv),
               slab.local(lam), slab.local(self.grid.interior_mask),
               {ax: tuple(slab.local(m) for m in ms) for ax, ms in self._nm_masks.items()})
        self._slabs[id(slab)] = (slab, out)
        return out

    def _solve_slab(self, reff: torch.Tensor, r: torch.Tensor, slab, shift) -> torch.Tensor:
        """The interior solve of ``apply`` on a slab: r's boundary rows, the
        solve of reff's interior, each transform one per-axis product
        (through the pencil exchange along a sharded axis)."""
        V, Vinv, lam, interior, _ = self._slab_factors(slab)
        trail = (1,) * (r.ndim - self.grid.ndim)
        w = reff.to(lam.dtype)
        for ax in range(self.grid.ndim):
            w = slab.apply_axis(Vinv[ax], w, ax)
        if shift is not None:
            lam = torch.where(interior, lam + torch.as_tensor(shift, dtype=lam.dtype,
                                                              device=lam.device), lam)
        w = w / lam.reshape(lam.shape + trail)
        for ax in range(self.grid.ndim):
            w = slab.apply_axis(V[ax], w, ax)
        return torch.where(interior.reshape(interior.shape + trail), w.to(r.dtype), r)
