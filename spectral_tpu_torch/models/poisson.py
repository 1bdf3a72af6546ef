"""Linear Poisson model: the main path of the port.

Counterpart of ``spectral_tpu/models/poisson.py``: the matrix-free spectral
Laplacian (each Chebyshev derivative applied twice, boundary rows
identity), solved by GMRES against the FD surrogate's exact fast
diagonalization, with the manufactured solution u = prod_j cos(pi x_j / 2).

Operator paths:
- composed (default): ``chebdiff`` per axis; on CUDA the last-axis
  derivatives run kernel K1 (``method="auto"`` or ``"kernel"``).
- ``method="kernel"`` on a 3-D grid without axis maps: the fused
  Laplacian, kernel K2, one pass over the field with the boundary select
  in its epilogue.  On a mapped grid (``Grid(maps=...)``) the chain-rule
  weights apply per node between the two derivatives, so the operator
  takes the composed path.
- ``mesh=``: the explicit pencil path on this process' slab
  (``parallel/``): derivatives through ``make_dif``, a mapped grid's
  chain-rule weights cut to the slab, Krylov inner products summed over
  the mesh, and every preconditioner on slabs (fastdiag through the
  pencil exchange, jacobi the slab's diagonal, multigrid with its coarse
  levels replicated, dense LU replicated).  K2 is never offered a slab.
"""

from __future__ import annotations

import dataclasses
import math
from functools import cached_property

import torch

from spectral_tpu_torch.grid import Grid
from spectral_tpu_torch.ops.chebyshev import chebdiff
from spectral_tpu_torch.ops.fastdiag import FastDiagSolver
from spectral_tpu_torch.ops.stencil import poisson_fd_stencil
from spectral_tpu_torch.solvers.krylov import KSPConfig
from spectral_tpu_torch.solvers.types import SolveResult


@dataclasses.dataclass(frozen=True)
class PoissonModel:
    """-Laplace(u) = f on the grid's box with Dirichlet boundary (identity
    rows).  Tensors live on ``grid.device``; the operator runs in the dtype
    of its input."""

    grid: Grid
    method: str = "auto"  # chebdiff execution path; "kernel" = K1 / K2
    mesh: object = None   # parallel.mesh.Mesh: the explicit pencil path on slabs
    sharded_axis: int = 0
    mesh_axis: str = "x"
    axis_map: object = None   # {grid_axis: mesh_axis} for P x Q meshes
    pipeline_chunks: int = 1  # > 1: the chunked pencil exchange

    @cached_property
    def slab(self):
        """The slab layout on the mesh (``parallel.slab.Slab``), or None."""
        from spectral_tpu_torch.parallel.slab import Slab
        return Slab.of(self.mesh, self.axis_map, self.sharded_axis, self.mesh_axis,
                       self.pipeline_chunks)

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """This process' slab of a global grid tensor (itself without a
        mesh)."""
        return t if self.mesh is None else self.slab.local(t)

    @cached_property
    def _bmask(self) -> torch.Tensor:
        return self.local(self.grid.boundary_mask)

    def operator(self, u: torch.Tensor) -> torch.Tensor:
        """y = -sum_j D_j(D_j u); boundary rows y_b = u_b.  With ``mesh``,
        u is this process' slab and every derivative takes the pencil path
        (K1 on a CUDA slab's unsharded last axis; never K2, which
        differentiates along the sharded axis too)."""
        g = self.grid
        if self.mesh is not None:
            dif = self.slab.dif()

            def wgt(v, ax):
                return self.slab.dif_weight(g, v, ax)

            y = torch.zeros_like(u)
            for ax in range(g.ndim):
                y = y - wgt(dif(wgt(dif(u, ax), ax), ax), ax)
            return torch.where(self._bmask, u, y)
        # K2 takes a constant per-axis scale: a mapped grid's per-node
        # weights sit between the two derivatives, so it takes K1's
        # composition instead
        if self.method == "kernel" and g.ndim == 3 and g.maps is None:
            from spectral_tpu_torch.ops.cuda_cheb import laplacian3d
            s2 = g.deriv_scale_np ** 2
            return laplacian3d(u, bmask=g.boundary_mask, scales=tuple(s2))
        wgt = g.apply_dif_weight  # the chain rule (identity if unmapped)
        y = torch.zeros_like(u)
        for ax in range(g.ndim):
            y = y - wgt(chebdiff(wgt(chebdiff(u, ax, self.method), ax),
                                 ax, self.method), ax)
        return torch.where(g.boundary_mask, u, y)

    @cached_property
    def fd_stencil(self):
        return poisson_fd_stencil(self.grid)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The global tensor of a slab (itself without a mesh)."""
        return t if self.mesh is None else self.slab.gather(t)

    def build_pc(self, pc_type: str = "fastdiag", dtype: torch.dtype | None = None):
        """Strong PC on the FD surrogate, in ``dtype`` (default: the grid's).
        With ``mesh`` it applies to slabs: fastdiag through the pencil
        exchange, jacobi the slab's diagonal, mg / mg<k> the multigrid on
        slabs with its coarse levels replicated (``ops/multigrid.py``), lu
        replicated on every process (the residual gathered, solved, and cut
        back)."""
        dtype = dtype or self.grid.dtype
        if pc_type == "fastdiag":
            fd = FastDiagSolver.build(self.grid, dtype=dtype)
            return fd if self.mesh is None else (lambda r: fd.apply(r, slab=self.slab))
        if pc_type == "jacobi":
            diag = self.local(self.fd_stencil.diag().to(dtype))
            return lambda r: r / diag
        if pc_type.startswith("mg"):
            # "mg<k>": k residual-corrected V-cycles an apply (2 for "mg"),
            # the constant-coefficient hierarchy in the grid's dtype
            from spectral_tpu_torch.ops.multigrid import Multigrid

            mg = Multigrid.build(self.grid, cycles=int(pc_type[2:]) if pc_type[2:] else 2)
            mg = mg.with_slab(self.slab)
            state = mg.setup({})
            return lambda r: mg.vcycle(state, r)
        if pc_type == "lu":
            # Dense LU of the assembled FD surrogate, the reference's
            # -pc_type lu; small grids only.  torch.linalg solves are
            # dtype-strict, so the right-hand side is cast to the factors'
            # dtype (the solve casts the result back to its own).
            if self.grid.size > 5000:
                raise ValueError("dense -pc_type lu is for small grids")
            A = torch.as_tensor(self.fd_stencil.as_dense_np(), dtype=dtype,
                                device=self.grid.device)
            LU, piv = torch.linalg.lu_factor(A)
            dims = self.grid.dims
            return lambda r: self.local(torch.linalg.lu_solve(
                LU, piv, self.gather(r).reshape(-1, 1).to(LU.dtype)).reshape(dims))
        if pc_type == "none":
            return None
        raise ValueError(f"unknown pc_type {pc_type!r}")

    def exact_solution(self) -> tuple[torch.Tensor, torch.Tensor]:
        """u = prod_j cos(pi x_j / 2), f = d (pi/2)^2 u, in the grid's dtype."""
        x = self.grid.coords  # (dims..., d)
        u = torch.prod(torch.cos(0.5 * math.pi * x), dim=-1)
        f = self.grid.ndim * (0.5 * math.pi) ** 2 * u
        return u, f

    def rhs(self, u_exact: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        """b carries f inside and the Dirichlet data on the boundary."""
        return torch.where(self.grid.boundary_mask, u_exact, f)

    def solve(self, b: torch.Tensor, *, ksp: KSPConfig | None = None,
              pc_type: str = "fastdiag") -> SolveResult:
        """Solve; with ``mesh``, b is this process' slab (``local``) and
        so is the solution, and the Krylov inner products are summed over
        the mesh (the ``reduce`` hook)."""
        ksp = ksp or KSPConfig(type="gmres", rtol=1e-10, max_it=200)
        M = self.build_pc(pc_type, dtype=b.dtype)
        reduce = None if self.mesh is None else self.mesh.allreduce
        return ksp.solve(self.operator, b, M=M, reduce=reduce)
