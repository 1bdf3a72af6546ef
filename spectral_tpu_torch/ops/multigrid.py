"""Geometric multigrid on CGL tensor grids.

Counterpart of ``spectral_tpu/ops/multigrid.py``: every level is a CGL
tensor grid, transfers are 1-D interpolation matrices in theta = acos(x),
coarse operators are rediscretized from restricted coefficient fields,
and the smoother is Chebyshev-accelerated Jacobi with its eigenvalue bound
from power iteration, damped Jacobi, or alternating-direction line
relaxation (``ops/tridiag.py``: per-line dense inverses built at setup).
The coarsest level is a dense LU solve.

Works on full-grid tensors with identity Dirichlet rows and zero boundary
values; trailing component axes broadcast through every level.  JAX's
``fori_loop`` is a Python loop here, and the eigenvalue bound stays a 0-d
tensor on the device, so a V-cycle never waits for the host.

On a mesh (``slab=``, ``parallel.slab.Slab``) the cycle runs on slabs:
- a level whose extents the mesh divides (with its pencil partner's) is
  sharded: its smoother applies the slab's stencil with a halo plane from
  each neighbour (``SlabStencilOp``), the Chebyshev bound comes from a
  power iteration on slabs (its norms summed over the mesh), the Jacobi
  diagonal is the slab's, and line sweeps along a sharded axis go through
  the pencil exchange (``ops/tridiag.py``); transfers between two sharded
  levels apply their per-axis matrices through the pencil exchange;
- coarsening halves extents, (n + 1) // 2, so levels soon stop dividing
  (20 -> 10 -> 5 over 2 processes): from the first such level down, every
  level runs replicated on every process (the residual ``all_gather``ed on
  the way down, the correction cut back to the slab on the way up), the
  usual agglomeration of coarse levels; the coarse LU is always
  replicated.
- ``setup`` takes the global coefficient fields and rediscretizes every
  level on the global grid exactly as one process does, then cuts the
  sharded levels' stencils to slabs, so the hierarchy, and with it the
  iteration counts, are the one-process ones.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import numpy as np
import torch

from spectral_tpu_torch.grid import Grid
from spectral_tpu_torch.ops.stencil import StencilOp, elliptic_jacobian_stencil
from spectral_tpu_torch.ops.tensorops import apply_axis_matmul, stencil_to_dense
from spectral_tpu_torch.ops.tridiag import build_line_solvers, line_smooth


def _theta_interp_np(n_f: int, n_c: int) -> np.ndarray:
    """(n_f, n_c) linear interpolation from coarse to fine CGL in theta."""
    tf = np.linspace(0.0, np.pi, n_f)
    tc = np.linspace(0.0, np.pi, n_c)
    P = np.zeros((n_f, n_c))
    j = np.clip(np.searchsorted(tc, tf) - 1, 0, n_c - 2)
    w = (tf - tc[j]) / (tc[j + 1] - tc[j])
    P[np.arange(n_f), j] = 1.0 - w
    P[np.arange(n_f), j + 1] += w
    return P


def theta_transfer_np(n_f: int, n_c: int) -> tuple[np.ndarray, np.ndarray]:
    """(P, R) per-axis transfer pair: linear coarse->fine interpolation in
    theta and its row-normalized (constants-preserving) restriction."""
    P = _theta_interp_np(n_f, n_c)
    R = P.T.copy()
    R /= R.sum(axis=1, keepdims=True)
    return P, R


def default_stencil_builder(grid: Grid, coeffs: dict) -> StencilOp:
    """Variable-coefficient elliptic Jacobian stencil from coefficient fields
    (eta, deta, gradu); the constant-coefficient Laplacian where a field is
    absent.  Runs in eta's dtype (the grid's when eta is absent)."""
    eta = coeffs.get("eta")
    dtype = grid.dtype if eta is None else eta.dtype

    def zeros():
        return torch.zeros(grid.dims, dtype=dtype, device=grid.device)

    if eta is None:
        eta = torch.ones(grid.dims, dtype=dtype, device=grid.device)
    deta = coeffs.get("deta")
    if deta is None:
        deta = zeros()
    gradu = coeffs.get("gradu")
    if gradu is None:
        gradu = [zeros() for _ in range(grid.ndim)]
    return elliptic_jacobian_stencil(grid, eta, deta, gradu)


def _map_fields(fn, coeffs):
    """Apply ``fn`` to every tensor of a coefficient dict (lists inside)."""
    if isinstance(coeffs, dict):
        return {k: _map_fields(fn, v) for k, v in coeffs.items()}
    if isinstance(coeffs, (list, tuple)):
        return type(coeffs)(_map_fields(fn, v) for v in coeffs)
    return fn(coeffs)


@functools.lru_cache(maxsize=None)
def _power_start(grid: Grid, dtype: torch.dtype) -> torch.Tensor:
    """The power iteration's deterministic start, sin(1..size) with a zero
    boundary: built in float64, then cast (as both packages do)."""
    x = np.sin(np.arange(1.0, grid.size + 1.0)).reshape(grid.dims)
    x = np.where(grid.boundary_mask_np, 0.0, x)
    return torch.as_tensor(x, dtype=dtype, device=grid.device)


@dataclasses.dataclass(frozen=True)
class Multigrid:
    """Static hierarchy; per-solve state comes from ``setup``.

    setup(coeffs) -> state dict (per level: stencil, diagonal, Chebyshev
    bound; the coarsest level's dense LU); vcycle(state, b) -> one
    preconditioner apply.
    """

    grids: tuple[Grid, ...]
    prolong: tuple[tuple[torch.Tensor, ...], ...]         # per level, per axis (n_f, n_c), float64
    restrict_coeff: tuple[tuple[torch.Tensor, ...], ...]  # normalized averaging, float64
    builder: Callable[[Grid, dict], StencilOp]
    pre_smooth: int = 2
    post_smooth: int = 2
    omega: float = 0.8
    smoother: str = "chebyshev"  # "chebyshev" | "jacobi" | "line"
    cycles: int = 1              # V-cycles per apply (residual-corrected)
    slab: object = None          # parallel.slab.Slab: the cycle on slabs

    def __post_init__(self):
        if self.smoother not in ("chebyshev", "jacobi", "line"):
            raise ValueError(f"unknown smoother {self.smoother!r}")
        if self.slab is not None and not self.slab.divides(self.grids[0].dims):
            raise ValueError(f"the fine level {self.grids[0].dims} does not divide over "
                             f"the mesh {self.slab.axis_map}")

    def with_slab(self, slab) -> "Multigrid":
        """This hierarchy on the slabs of ``slab`` (None: one process)."""
        return self if slab is self.slab else dataclasses.replace(self, slab=slab)

    @functools.cached_property
    def sharded(self) -> tuple:
        """Per level: True if it runs on slabs, False if replicated."""
        out, on = [], self.slab is not None
        for g in self.grids:
            on = on and self.slab.divides(g.dims)
            out.append(on)
        return tuple(out)

    @functools.cached_property
    def _masks(self) -> tuple:
        """Per level (interior, boundary) masks, cut to the slab on sharded
        levels."""
        return tuple((self.slab.local(g.interior_mask), self.slab.local(g.boundary_mask))
                     if sh else (g.interior_mask, g.boundary_mask)
                     for g, sh in zip(self.grids, self.sharded))

    @staticmethod
    def build(grid: Grid, builder: Callable = default_stencil_builder,
              coarsest: int = 4, max_levels: int = 10,
              pre_smooth: int = 2, post_smooth: int = 2,
              omega: float = 0.8, smoother: str = "chebyshev",
              cycles: int = 1) -> "Multigrid":
        """Halve every axis ((n + 1) // 2, at least 3 nodes) until the
        coarsest axis has ``coarsest`` nodes or fewer, or the level has at
        most 200 nodes; every level lives on the fine grid's device.
        smoother="line": alternating-direction line relaxation along every
        axis, for the high-aspect CGL cells near the boundary (spacing
        ~1/n^2 normal, ~1/n tangential) where point smoothers stall."""
        grids = [grid]
        while len(grids) < max_levels:
            dims = grids[-1].dims
            if max(dims) <= coarsest or math.prod(dims) <= 200:
                break
            new_dims = tuple(max(3, (n + 1) // 2) for n in dims)
            if new_dims == dims:
                break
            # a mapped grid's coarse levels carry the map itself, rediscretized
            maps_c = (None if grid.maps is None
                      else tuple(m.restrict(n) for m, n in zip(grid.maps, new_dims)))
            grids.append(Grid(new_dims, intervals=grid.intervals, maps=maps_c,
                              device=grid.device, dtype=grid.dtype))
        Ps, Rcs = [], []
        for fine, coarse in zip(grids[:-1], grids[1:]):
            pr = [theta_transfer_np(nf, nc) for nf, nc in zip(fine.dims, coarse.dims)]
            Ps.append(tuple(p for p, _ in pr))
            Rcs.append(tuple(r for _, r in pr))
        return Multigrid.from_transfers(tuple(grids), Ps, Rcs, builder=builder,
                                        pre_smooth=pre_smooth, post_smooth=post_smooth,
                                        omega=omega, smoother=smoother, cycles=cycles)

    @staticmethod
    def from_transfers(grids, prolong, restrict_coeff, **cfg) -> "Multigrid":
        """A hierarchy from per-level, per-axis host transfer matrices, kept
        in float64 on the fine grid's device."""
        cfg.setdefault("builder", default_stencil_builder)
        dev = grids[0].device

        def t(a):
            return torch.as_tensor(np.array(a, np.float64), device=dev)

        return Multigrid(tuple(grids),
                         tuple(tuple(t(a) for a in lvl) for lvl in prolong),
                         tuple(tuple(t(a) for a in lvl) for lvl in restrict_coeff),
                         **cfg)

    # -- transfers ------------------------------------------------------------
    def _transfer(self, mats, lvl: int, x: torch.Tensor, down: bool) -> torch.Tensor:
        """Apply the per-axis matrices between levels lvl and lvl + 1: on
        slabs through the pencil exchange when both levels are sharded;
        gathered before a restriction and cut after a prolongation where a
        sharded level meets a replicated one."""
        coarse_sh = self.slab is not None and self.sharded[lvl + 1]
        if down and self.slab is not None and self.sharded[lvl] and not coarse_sh:
            x = self.slab.gather(x)
        for ax in range(self.grids[0].ndim):
            M = mats[lvl][ax].to(x.dtype)
            x = self.slab.apply_axis(M, x, ax) if coarse_sh else apply_axis_matmul(M, x, ax)
        if not down and self.slab is not None and self.sharded[lvl] and not coarse_sh:
            x = self.slab.local(x)
        return x

    def _prolong(self, lvl: int, xc: torch.Tensor) -> torch.Tensor:
        return self._transfer(self.prolong, lvl, xc, down=False)

    def _restrict(self, lvl: int, f: torch.Tensor) -> torch.Tensor:
        """Residuals and coefficient fields alike: normalized averaging."""
        return self._transfer(self.restrict_coeff, lvl, f, down=True)

    def _restrict_global(self, lvl: int, f: torch.Tensor) -> torch.Tensor:
        """``_restrict`` of a global field (the setup's coefficients)."""
        for ax in range(self.grids[0].ndim):
            f = apply_axis_matmul(self.restrict_coeff[lvl][ax].to(f.dtype), f, ax)
        return f

    def _mask(self, lvl: int, x: torch.Tensor) -> torch.Tensor:
        if self.slab is None:
            return self.grids[lvl].zero_boundary(x)
        return torch.where(self.grids[lvl]._mask_for(self._masks[lvl][0], x), x,
                           torch.zeros((), dtype=x.dtype, device=x.device))

    # -- per-solve state ------------------------------------------------------
    def _level(self, lvl: int, S: StencilOp):
        """(stencil, diagonal, bound) of a level from its global stencil,
        the stencil cut to the slab on a sharded level."""
        if self.slab is not None and self.sharded[lvl]:
            S = self.slab.stencil(S)
        diag = S.diag()
        lam_max = None
        if self.smoother == "chebyshev" and lvl < len(self.grids) - 1:
            lam_max = self._power_lambda_max(lvl, S, diag)
        return S, diag, lam_max

    def _finish(self, stencils) -> dict:
        """The state from every level's global stencil: per-level (stencil,
        diagonal, bound) triples, the coarsest level's dense LU and, for the
        line smoother, every level's line solvers (state["line"]); on a
        mesh the global stencils too (state["global"], for shift_state)."""
        levels = [self._level(lvl, S) for lvl, S in enumerate(stencils)]
        A = stencil_to_dense(stencils[-1], self.grids[-1].dims)
        state = {"levels": levels, "coarse_lu": torch.linalg.lu_factor(A)}
        if self.smoother == "line":
            state["line"] = [build_line_solvers(S, tuple(range(S.grid_ndim)),
                                                slab=self.slab if sh else None)
                             for S, sh in zip(stencils, self.sharded)]
        if self.slab is not None:
            state["global"] = list(stencils)
        return state

    def setup(self, coeffs: dict | None = None) -> dict:
        """Restrict coefficient fields, rediscretize every level, estimate
        the smoother's eigenvalue bounds, factor the coarsest level (the
        analog of PCSetUp + hypre setup).  On a mesh the fields are the
        global grid's (every process rediscretizes the same hierarchy)."""
        coeffs = dict(coeffs or {})
        stencils = []
        for lvl, g in enumerate(self.grids):
            stencils.append(self.builder(g, coeffs))
            if lvl < len(self.grids) - 1:
                coeffs = _map_fields(lambda f, lvl=lvl: self._restrict_global(lvl, f), coeffs)
        return self._finish(stencils)

    def shift_state(self, state: dict, shift) -> dict:
        """State solving (S + shift) on the interior of every level, from a
        shift-free ``setup`` state: centers get ``shift`` on interior rows;
        diagonals, eigenvalue bounds, line solvers and the coarse LU are
        recomputed.  ``shift`` may be a number or a 0-d tensor."""
        stencils = []
        glob = state.get("global") or [S for S, _, _ in state["levels"]]
        for lvl, S in enumerate(glob):
            interior = self.grids[lvl].interior_mask
            sh = torch.as_tensor(shift, dtype=S.center.dtype, device=S.center.device)
            stencils.append(dataclasses.replace(
                S, center=torch.where(interior, S.center + sh, S.center)))
        return self._finish(stencils)

    def _power_lambda_max(self, lvl: int, S: StencilOp, diag: torch.Tensor,
                          iters: int = 12) -> torch.Tensor:
        """Largest eigenvalue of D^{-1} S by power iteration, times 1.1 (the
        analog of hypre's smoother eigenvalue estimate); a 0-d tensor.  On
        a sharded level the iteration runs on slabs, its norms and inner
        products summed over the mesh."""
        x = _power_start(self.grids[lvl], diag.dtype)
        if self.slab is not None and self.sharded[lvl]:
            x = self.slab.local(x)
            dot = self.slab.dot
        else:
            def dot(a, b):
                return torch.dot(a.reshape(-1), b.reshape(-1))
        for _ in range(iters):
            y = S.apply(x) / diag
            nrm = (torch.linalg.vector_norm(y) if self.slab is None
                   else torch.sqrt(dot(y, y)))
            x = y / torch.clamp_min(nrm, 1e-30)
        y = S.apply(x) / diag
        num = dot(x, y)
        den = dot(x, x)
        return 1.1 * num / torch.clamp_min(den, 1e-30)

    # -- cycle ----------------------------------------------------------------
    def _smooth(self, S: StencilOp, diag: torch.Tensor, lam_max, x, b, iters: int,
                solvers=None):
        if self.smoother == "line":
            return line_smooth(S, x, b, axes=tuple(range(S.grid_ndim)), sweeps=iters,
                               solvers=solvers)
        d = diag if x.ndim == diag.ndim else diag.reshape(
            diag.shape + (1,) * (x.ndim - diag.ndim))
        if self.smoother == "jacobi" or lam_max is None:
            for _ in range(iters):
                x = x + self.omega * (b - S.apply(x)) / d
            return x
        # Chebyshev smoothing on [lam_max/4, lam_max] of D^{-1} S
        lmin = lam_max / 4.0
        theta = 0.5 * (lam_max + lmin)
        delta = 0.5 * (lam_max - lmin)
        sigma = theta / delta
        rho = 1.0 / sigma
        r = (b - S.apply(x)) / d
        dx = r / theta
        x = x + dx
        for _ in range(iters - 1):
            rho_new = 1.0 / (2.0 * sigma - rho)
            r = (b - S.apply(x)) / d
            dx = rho_new * rho * dx + 2.0 * rho_new / delta * r
            x = x + dx
            rho = rho_new
        return x

    def _cycle(self, state: dict, lvl: int, b: torch.Tensor) -> torch.Tensor:
        S, diag, lam_max = state["levels"][lvl]
        if lvl == len(self.grids) - 1:
            # torch.linalg.lu_solve is dtype-strict: solve in the factors'
            # dtype and cast back to the cycle's working dtype; a sharded
            # coarsest level gathers, solves replicated and cuts back
            on_slab = self.slab is not None and self.sharded[lvl]
            bg = self.slab.gather(b) if on_slab else b
            size = self.grids[lvl].size
            LU, piv = state["coarse_lu"]
            z = torch.linalg.lu_solve(LU, piv, bg.reshape(size, -1).to(LU.dtype))
            z = z.reshape(bg.shape).to(b.dtype)
            return self.slab.local(z) if on_slab else z
        solvers = state["line"][lvl] if self.smoother == "line" else None
        x = self._smooth(S, diag, lam_max, torch.zeros_like(b), b, self.pre_smooth, solvers)
        r = b - S.apply(x)
        rc = self._mask(lvl + 1, self._restrict(lvl, r))
        ec = self._cycle(state, lvl + 1, rc)
        x = x + self._mask(lvl, self._prolong(lvl, ec))
        return self._smooth(S, diag, lam_max, x, b, self.post_smooth, solvers)

    def vcycle(self, state: dict, b: torch.Tensor) -> torch.Tensor:
        """``cycles`` residual-corrected V-cycles as one preconditioner
        apply; boundary entries pass through."""
        bi = self._mask(0, b)
        z = self._cycle(state, 0, bi)
        S = state["levels"][0][0]
        for _ in range(self.cycles - 1):
            z = z + self._cycle(state, 0, bi - self._mask(0, S.apply(z)))
        bm = self.grids[0].boundary_mask if self.slab is None else self._masks[0][1]
        return torch.where(self.grids[0]._mask_for(bm, b), b, z)
