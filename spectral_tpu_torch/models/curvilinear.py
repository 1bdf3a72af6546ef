"""Poisson on a general curved domain (full curvilinear transform).

Counterpart of ``spectral_tpu/models/curvilinear.py``: the domain is the
image of the reference cube under a smooth invertible map x = Phi(xi)
(bent quadrilaterals, annulus sectors, perturbed boxes), the spectral
operator is in conservative metric form (``ops/curvilinear.py``; its
last-axis derivatives run kernel K1 on a CUDA tensor), and the
preconditioner is a multigrid V-cycle on the variable-coefficient FD
surrogate with the cross terms dropped.

``mesh=`` solves on this process' slab (``parallel/``): the derivatives
through the pencil exchange, the metric fields cut to the slab (the
metric contractions are pointwise), the multigrid on slabs with its
coarse levels replicated, the Krylov norms summed over the mesh.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Callable

import torch

from spectral_tpu_torch.grid import Grid
from spectral_tpu_torch.ops.curvilinear import CurvilinearMap, metric_surrogate_builder
from spectral_tpu_torch.solvers.krylov import KSPConfig
from spectral_tpu_torch.solvers.types import SolveResult


@dataclasses.dataclass(frozen=True, eq=False)
class CurvilinearPoisson:
    """-Laplace(u) = f on Phi([-1,1]^d), Dirichlet boundary (identity rows);
    tensors on ``grid.device``, every function in its input's dtype."""

    grid: Grid
    phi: Callable
    mesh: object = None      # parallel.mesh.Mesh: the solve on slabs
    sharded_axis: int = 0
    mesh_axis: str = "x"
    axis_map: object = None

    @cached_property
    def map(self) -> CurvilinearMap:
        return CurvilinearMap.build(self.grid, self.phi)

    @cached_property
    def slab(self):
        from spectral_tpu_torch.parallel.slab import Slab
        return Slab.of(self.mesh, self.axis_map, self.sharded_axis, self.mesh_axis)

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """This process' slab of a global tensor (itself without a mesh)."""
        return t if self.slab is None else self.slab.local(t)

    def operator(self, u: torch.Tensor) -> torch.Tensor:
        return torch.where(self.local(self.grid.boundary_mask), u,
                           -self.map.laplacian(u, self.slab))

    def build_pc(self, pc_type: str = "mg", dtype: torch.dtype | None = None):
        """The PC on the separable metric surrogate in ``dtype`` (default:
        the grid's): "mg" / "mg<k>" (k V-cycles an apply, 2 for "mg"),
        "jacobi" or "none"."""
        builder = metric_surrogate_builder(self.grid.ndim)
        coeffs = self.map.pc_coeffs(dtype=dtype or self.grid.dtype)
        if pc_type.startswith("mg"):
            from spectral_tpu_torch.ops.multigrid import Multigrid

            mg = Multigrid.build(self.grid, builder=builder,
                                 cycles=int(pc_type[2:]) if pc_type[2:] else 2)
            mg = mg.with_slab(self.slab)
            state = mg.setup(coeffs)
            return lambda r: mg.vcycle(state, r)
        if pc_type == "jacobi":
            diag = self.local(builder(self.grid, coeffs).diag())
            return lambda r: r / diag
        if pc_type == "none":
            return None
        raise ValueError(f"unknown pc_type {pc_type!r}")

    def manufactured(self, u_fn: Callable, lap_fn: Callable):
        """(u_exact, b) on the mapped grid from closed-form u(x) and its
        physical Laplacian, evaluated on the float64 physical nodes and
        cast to the grid's dtype."""
        x = self.map.coords
        g = self.grid
        u = torch.as_tensor(u_fn(x), dtype=g.dtype, device=g.device)
        f = torch.as_tensor(-lap_fn(x), dtype=g.dtype, device=g.device)
        return u, torch.where(g.boundary_mask, u, f)

    def solve(self, b: torch.Tensor, *, ksp: KSPConfig | None = None,
              pc_type: str = "mg") -> SolveResult:
        ksp = ksp or KSPConfig(type="gmres", rtol=1e-10, max_it=300)
        return ksp.solve(self.operator, b, M=self.build_pc(pc_type, dtype=b.dtype),
                         reduce=None if self.mesh is None else self.mesh.allreduce)
