"""Nonlinear elliptic model in any number of dimensions.

Counterpart of ``spectral_tpu/models/elliptic.py``.  Solves

    F(u) = -div(eta(u) grad u) - b = 0,   eta(u) = 1 + gamma * u^exponent

on the CGL tensor grid with Dirichlet boundary by Newton-Krylov, as the
reference's elliptic.C does: the residual (FormFunction,
elliptic.C:480-533) returns eta, eta' and grad(u), which the matrix-free
Jacobian (MatMult_Elliptic, elliptic.C:296-339) and the FD surrogate
preconditioner (FormJacobian, elliptic.C:537-590) reuse.  Every derivative
is ``chebdiff``; on a CUDA tensor the last-axis ones run kernel K1, in
float32 and float64 alike.

The surrogate is solved by fast diagonalization, dense LU (the reference's
``-pc_type lu``), Jacobi, or geometric multigrid (``mg``, ``mg<k>``); or
the separable Q1 FEM Laplacian is solved exactly (``q1fem``).

On a curved domain (``phi=``, ``ops/curvilinear.py``) the operator runs in
metric form, -div(eta grad u) = -(1/detJ) d_l(eta A_lm d_m u) with
A = detJ Jinv Jinv^T; the eta' Newton term contracts through the same A,
so the model stays in reference-gradient space.

With ``mesh=`` (``parallel/``) the whole Newton solve runs on this
process' slab: every derivative through the pencil exchange
(``make_dif``), a mapped grid's weights and a curved domain's metric
fields cut to the slab, the preconditioners on slabs (fastdiag through
the pencil exchange, jacobi, multigrid with replicated coarse levels,
dense LU replicated), and the Newton and Krylov norms summed over the
mesh.
"""

from __future__ import annotations

import dataclasses
import math
from functools import cached_property

import numpy as np
import torch

from spectral_tpu_torch.grid import Grid
from spectral_tpu_torch.ops.chebyshev import chebdiff, chebdiff_np
from spectral_tpu_torch.ops.fastdiag import FastDiagSolver
from spectral_tpu_torch.ops.stencil import elliptic_jacobian_stencil
from spectral_tpu_torch.ops.tensorops import stencil_to_dense
from spectral_tpu_torch.solvers.krylov import KSPConfig
from spectral_tpu_torch.solvers.newton import NewtonConfig, NewtonResult, newton_solve


def _pow(u, e: float):
    """C ``pow`` semantics for negative bases with integer exponents
    (elliptic.C:508 calls pow(u, exponent), exponent 2.0 by default)."""
    if float(e).is_integer():
        return u ** int(e)
    if isinstance(u, np.ndarray):
        return np.power(u, e)
    return torch.pow(u, e)


def exact_fields_np(nodes_1d, gamma: float, exponent: float, exact: int = 0,
                    cos_scale: float = 1.0, coords: np.ndarray | None = None):
    """Manufactured solution v and forcing w = A(v) v on the tensor grid of
    the per-axis ``nodes_1d``, float64 (CreateExactSolution,
    elliptic.C:593-677); w is nonlinearity-aware for exact=0.  Every
    closed form is a sum of products of 1-D factors: each factor is
    evaluated on its axis' nodes and broadcast, never on the full grid.
    ``coords`` ((dims..., d) physical nodes of a curved domain) evaluates
    the same pointwise identities on every node instead."""
    d = len(nodes_1d)

    def axis(f, j):   # a 1-D factor on axis j, shaped to broadcast
        if coords is not None:
            return f(np.asarray(coords[..., j], np.float64))
        shape = [1] * d
        shape[j] = -1
        return np.reshape(f(np.asarray(nodes_1d[j], np.float64)), shape)

    def prod(factors):
        out = np.ones([len(z) for z in nodes_1d])
        for f in factors:
            out = out * f
        return out

    if exact == 0:
        s = 0.5 * cos_scale
        cosx = [axis(lambda z: np.cos(s * np.pi * z), j) for j in range(d)]
        v = prod(cosx)
        eta = 1.0 + gamma * _pow(v, exponent)
        if gamma == 0.0 or abs(exponent) < 1e-10:
            deta = np.zeros_like(v)
        else:
            deta = exponent * gamma * _pow(v, exponent - 1.0)
        w = np.zeros_like(v)
        for j in range(d):
            dv = prod([axis(lambda z: -s * np.pi * np.sin(s * np.pi * z), j)]
                      + [cosx[k] for k in range(d) if k != j])
            w += deta * dv**2 + eta * (-(s * np.pi) ** 2) * v
        return v, -w
    if exact == 1:
        # u = prod(1-x_j^2), f = -Lap u = sum_j 2 prod_{k!=j}(1-x_k^2)
        # (elliptic.C:633-643 folds 2^(d-1) in, right for d == 2 only; the
        # JAX package and this one use the forcing that holds in any d)
        q = [axis(lambda z: 1.0 - z**2, j) for j in range(d)]
        w = sum(2.0 * prod([q[k] for k in range(d) if k != j]) for j in range(d))
        return prod(q), w
    if exact == 2:
        p = [axis(lambda z, j=j: z ** (4 + j), j) for j in range(d)]
        w = -sum(prod([axis(lambda z, j=j: (4 + j) * (3 + j) * z ** (2 + j), j)]
                      + [p[k] for k in range(d) if k != j]) for j in range(d))
        return prod(p), w
    raise ValueError("Choose an exact solution (elliptic.C:657).")


@dataclasses.dataclass(frozen=True)
class EllipticModel:
    """The nonlinear elliptic problem on ``grid``; tensors live on
    ``grid.device`` and every function runs in the dtype of its input."""

    grid: Grid
    gamma: float = 0.0
    exponent: float = 2.0
    method: str = "auto"   # chebdiff execution path
    mesh: object = None    # parallel.mesh.Mesh: residual and Jacobian on slabs
    phi: object = None
    sharded_axis: int = 0
    mesh_axis: str = "x"
    axis_map: object = None    # {grid_axis: mesh_axis} for P x Q meshes
    pipeline_chunks: int = 1   # > 1: the chunked pencil exchange

    def __post_init__(self):
        from spectral_tpu_torch.parallel.slab import Slab

        object.__setattr__(self, "_pc_cache", {})
        slab = Slab.of(self.mesh, self.axis_map, self.sharded_axis, self.mesh_axis,
                       self.pipeline_chunks)
        object.__setattr__(self, "slab", slab)
        if slab is not None:
            object.__setattr__(self, "_bmask", slab.local(self.grid.boundary_mask))
            object.__setattr__(self, "_mesh_dif", slab.dif(self.method))

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """This process' slab of a global grid tensor (itself without a
        mesh)."""
        return t if self.slab is None else self.slab.local(t)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The global tensor of a slab (itself without a mesh)."""
        return t if self.slab is None else self.slab.gather(t)

    def _set_boundary(self, u, values):
        if self.mesh is None:
            return self.grid.set_boundary(u, values)
        return torch.where(self._bmask, values, u)

    def _zero_boundary(self, u):
        if self.mesh is None:
            return self.grid.zero_boundary(u)
        return torch.where(self._bmask, torch.zeros((), dtype=u.dtype, device=u.device), u)

    @cached_property
    def cmap(self):
        """The CurvilinearMap of ``phi`` (None without one)."""
        if self.phi is None:
            return None
        if self.grid.intervals is not None or self.grid.maps is not None:
            raise ValueError("curvilinear elliptic needs an unmapped Grid; "
                             "fold affine/axis maps into phi")
        from spectral_tpu_torch.ops.curvilinear import CurvilinearMap
        return CurvilinearMap.build(self.grid, self.phi)

    @property
    def coords_phys_np(self) -> np.ndarray:
        """(dims..., d) float64 physical node positions."""
        return self.grid.coords_np if self.cmap is None else self.cmap.coords

    def _metric_flux(self, flux_ref: list) -> list:
        """A reference-gradient-space flux list contracted with A = Acoef."""
        A = self.cmap.field("Acoef", flux_ref[0].dtype, flux_ref[0].device, self.slab)
        d = self.grid.ndim
        return [sum(A[..., l, m] * flux_ref[m] for m in range(d)) for l in range(d)]

    def _div_flux(self, flux: list) -> torch.Tensor:
        """-sum_l D_l flux_l, over detJ on a curved domain."""
        y = torch.zeros_like(flux[0])
        for ax in range(self.grid.ndim):
            y = y - self._dif(flux[ax], ax)
        if self.cmap is not None:
            y = y / self.cmap.field("detJ", y.dtype, y.device, self.slab)
        return y

    def _dif(self, v: torch.Tensor, axis: int) -> torch.Tensor:
        if self.mesh is None:
            return self.grid.apply_dif_weight(chebdiff(v, axis, self.method), axis)
        return self.slab.dif_weight(self.grid, self._mesh_dif(v, axis), axis)

    # -- coefficients ---------------------------------------------------------
    def eta(self, u):
        """eta = 1 + gamma u^e, eta' = gamma e u^(e-1) (elliptic.C:507-509)."""
        eta = 1.0 + self.gamma * _pow(u, self.exponent)
        if self.gamma == 0.0 or abs(self.exponent) < 1e-10:
            deta = torch.zeros_like(u)
        else:
            deta = self.exponent * self.gamma * _pow(u, self.exponent - 1.0)
        return eta, deta

    # -- residual / Jacobian --------------------------------------------------
    def make_residual(self, b: torch.Tensor, dirichlet: torch.Tensor):
        """Residual closure uG -> (F, lin_state); FormFunction analog.

        uG and F are full-grid tensors with zero boundary entries;
        ``dirichlet`` carries the boundary data."""
        g = self.grid

        def residual(uG):
            u = self._set_boundary(uG, dirichlet)
            gradu = [self._dif(u, ax) for ax in range(g.ndim)]
            eta, deta = self.eta(u)
            flux = [eta * gu for gu in gradu]
            if self.cmap is not None:
                flux = self._metric_flux(flux)
            return self._zero_boundary(self._div_flux(flux)) - b, (eta, deta, gradu)

        return residual

    def make_residual_np(self, b_np: np.ndarray, dirichlet_np: np.ndarray):
        """Host float64 residual (numpy transforms): the high-precision side
        of defect-correction Newton (``solve_refined``)."""
        g = self.grid
        bm = g.boundary_mask_np
        A = None if self.cmap is None else self.cmap.Acoef
        detJ = None if self.cmap is None else self.cmap.detJ

        def residual(u_np):
            u = np.where(bm, dirichlet_np, u_np)
            eta = 1.0 + self.gamma * _pow(u, self.exponent)
            grad = [g.apply_dif_weight_np(chebdiff_np(u, ax), ax) for ax in range(g.ndim)]
            flux = [eta * gu for gu in grad]
            if A is not None:
                flux = [sum(A[..., l, m] * flux[m] for m in range(g.ndim))
                        for l in range(g.ndim)]
            F = np.zeros_like(u)
            for ax in range(g.ndim):
                F -= g.apply_dif_weight_np(chebdiff_np(flux[ax], ax), ax)
            if detJ is not None:
                F = F / detJ
            return np.where(bm, 0.0, F) - b_np

        return residual

    def jacobian_action(self, uG, lin_state, wG):
        """Frozen-coefficient Newton linearization (MatMult_Elliptic,
        elliptic.C:296-339): flux_j = eta dw_j + eta' w du0_j,
        y = -sum_j D_j flux_j, homogeneous Dirichlet on the perturbation."""
        g = self.grid
        eta, deta, gradu0 = lin_state
        w = self._zero_boundary(wG)
        flux = [eta * self._dif(w, ax) + deta * w * gradu0[ax] for ax in range(g.ndim)]
        if self.cmap is not None:
            flux = self._metric_flux(flux)
        return self._zero_boundary(self._div_flux(flux))

    # -- preconditioners ------------------------------------------------------
    def _fastdiag(self, dtype: torch.dtype) -> FastDiagSolver:
        key = ("fastdiag", dtype)
        if key not in self._pc_cache:
            self._pc_cache[key] = FastDiagSolver.build(self.grid, dtype=dtype)
        return self._pc_cache[key]

    def _multigrid(self, cycles: int):
        """The hierarchy of "mg<cycles>": the variable-coefficient Jacobian
        stencil, or the metric surrogate on a curved domain."""
        from spectral_tpu_torch.ops.multigrid import Multigrid

        key = ("mg", cycles)
        if key not in self._pc_cache:
            if self.cmap is None:
                mg = Multigrid.build(self.grid, cycles=cycles)
            else:
                from spectral_tpu_torch.ops.curvilinear import metric_surrogate_builder
                mg = Multigrid.build(self.grid, builder=metric_surrogate_builder(self.grid.ndim),
                                     cycles=cycles)
            self._pc_cache[key] = mg.with_slab(self.slab)
        return self._pc_cache[key]

    def make_pc(self, pc_type: str = "fastdiag", dtype: torch.dtype | None = None):
        """(pc_setup, pc_apply) for ``newton_solve``; FormJacobian analog.

        - "fastdiag": exact solve of the constant-coefficient FD Laplacian,
          its factors in ``dtype`` (default: the grid's);
        - "lu": dense LU of the assembled variable-coefficient FD stencil
          (the reference's ``-pc_type lu``), small grids only;
        - "jacobi": the stencil's diagonal;
        - "q1fem": exact solve of the separable Q1 FEM Laplacian
          (ops.fem.Q1FastDiag), its factors in ``dtype``;
        - "mg" / "mg<k>": geometric multigrid, k residual-corrected
          V-cycles per apply (2 for "mg").
        The stencil-based types follow the dtype of the linearization state.
        On a curved domain the surrogate of "mg", "jacobi" and "lu" is the
        separable metric stencil -(1/detJ) d_l(eta A_ll d_l .), the cross
        terms and the eta' term dropped; "fastdiag" and "q1fem" stay
        metric-blind (usable on gentle maps).

        With ``mesh`` every type but q1fem applies to slabs: fastdiag
        through the pencil exchange; the stencil setups gather the
        linearization's fields and build the global surrogate as one
        process does, then jacobi keeps the slab's diagonal, mg runs its
        cycle on slabs (coarse levels replicated) and lu solves replicated.
        """
        g, slab = self.grid, self.slab
        if pc_type == "none":
            return None, None

        def gathered(lin_state):   # the global linearization (one all_gather a field)
            return lin_state if slab is None else slab.gather_fields(lin_state)

        def _stencil(lin_state):
            eta, deta, gradu = gathered(lin_state)
            if self.cmap is None:
                return elliptic_jacobian_stencil(g, eta, deta, gradu)
            from spectral_tpu_torch.ops.curvilinear import metric_surrogate_builder
            return metric_surrogate_builder(g.ndim)(g, self.cmap.pc_coeffs(eta))

        if pc_type == "fastdiag":
            fd = self._fastdiag(dtype or g.dtype)
            return (lambda x, lin_state: None), (lambda state, r: fd.apply(r, slab=slab))
        if pc_type == "q1fem":
            if slab is not None:
                raise NotImplementedError("the Q1 FEM preconditioner on a mesh is not ported "
                                          "yet (ROADMAP.md queue 1, item 7d)")
            from spectral_tpu_torch.ops.fem import Q1FastDiag

            key = ("q1fem", dtype or g.dtype)
            if key not in self._pc_cache:
                self._pc_cache[key] = Q1FastDiag.build(g, dtype=key[1])
            q1 = self._pc_cache[key]
            return (lambda x, lin_state: None), (lambda state, r: q1.apply(r))
        if pc_type == "jacobi":
            return (lambda x, lin_state: self.local(_stencil(lin_state).diag())), \
                   (lambda diag, r: r / diag)
        if pc_type == "lu":
            if g.size > 5000:
                raise ValueError("dense -pc_type lu is for small grids; use mg/fastdiag")

            def setup(x, lin_state):
                return torch.linalg.lu_factor(stencil_to_dense(_stencil(lin_state), g.dims))

            def apply(lu, r):   # replicated on a mesh: r gathered, z cut back
                LU, piv = lu
                rg = self.gather(r)
                z = torch.linalg.lu_solve(LU, piv, rg.reshape(-1, 1).to(LU.dtype))
                return self.local(z.reshape(rg.shape))

            return setup, apply
        if pc_type.startswith("mg"):
            mg = self._multigrid(int(pc_type[2:]) if pc_type[2:] else 2)

            def setup(x, lin_state):
                eta, deta, gradu = gathered(lin_state)
                if self.cmap is not None:
                    return mg.setup(self.cmap.pc_coeffs(eta))
                return mg.setup({"eta": eta, "deta": deta, "gradu": list(gradu)})

            return setup, mg.vcycle
        raise ValueError(f"unknown pc_type {pc_type!r}")

    # -- exact solutions ------------------------------------------------------
    def exact_solution(self, exact: int = 0, cos_scale: float = 1.0):
        """(u, f) on the full grid in the grid's dtype and device: the
        manufactured solution and its forcing (at the physical nodes: the
        closed forms are pointwise identities, so they hold on curved
        domains too)."""
        v, w = self._exact_np(exact, cos_scale)
        g = self.grid
        return (torch.as_tensor(v, dtype=g.dtype, device=g.device),
                torch.as_tensor(w, dtype=g.dtype, device=g.device))

    def _exact_np(self, exact: int, cos_scale: float):
        return exact_fields_np(self.grid.nodes_1d, self.gamma, self.exponent, exact,
                               cos_scale, coords=None if self.cmap is None else self.cmap.coords)

    def setup_problem_np(self, exact: int = 0, cos_scale: float = 1.0):
        """(u_global, b, dirichlet) as float64 numpy arrays."""
        bm = self.grid.boundary_mask_np
        v, w = self._exact_np(exact, cos_scale)
        return np.where(bm, 0.0, v), np.where(bm, 0.0, w), np.where(bm, v, 0.0)

    def setup_problem(self, exact: int = 0, cos_scale: float = 1.0):
        """(u_global, b, dirichlet) in the grid's dtype on its device."""
        g = self.grid
        return tuple(torch.as_tensor(a, dtype=g.dtype, device=g.device)
                     for a in self.setup_problem_np(exact, cos_scale))

    # -- solves ---------------------------------------------------------------
    def solve(self, b: torch.Tensor, dirichlet: torch.Tensor, x0=None, *,
              ksp: KSPConfig | None = None, newton: NewtonConfig | None = None,
              pc_type: str = "fastdiag") -> NewtonResult:
        """Newton-Krylov in b's dtype on b's device (main, elliptic.C:117-246).
        With ``mesh``, b, dirichlet and x0 are this process' slabs
        (``local``) and so is the solution."""
        ksp = ksp or KSPConfig(type="fgmres", rtol=1e-5, max_it=300)
        newton = newton or NewtonConfig(rtol=1e-8, max_it=50)
        pc_setup, pc_apply = self.make_pc(pc_type, dtype=b.dtype)
        x0 = torch.zeros_like(b) if x0 is None else x0.to(b.device, b.dtype)
        return newton_solve(self.make_residual(b, dirichlet), x0,
                            jacobian_action=self.jacobian_action,
                            pc_setup=pc_setup, pc_apply=pc_apply, ksp=ksp,
                            config=newton,
                            reduce=None if self.mesh is None else self.mesh.allreduce)

    def _dev32(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=self.grid.device)

    def _inner32(self, pc_type: str, ksp: KSPConfig):
        """(x32, r32, b32, d32) -> (dx32, iters): one float32 linear solve
        of the Jacobian about x32, its preconditioner built in float32."""
        pc_setup, pc_apply = self.make_pc(pc_type, dtype=torch.float32)

        def inner(x32, r32, b32, d32):
            _, lin_state = self.make_residual(b32, d32)(x32)
            M = None
            if pc_apply is not None:
                state = pc_setup(x32, lin_state)
                M = lambda r: pc_apply(state, r)  # noqa: E731
            out = ksp.solve(lambda w: self.jacobian_action(x32, lin_state, w), r32, M=M)
            return out.x, out.iters

        return inner

    def _solve_refined(self, b_np, dirichlet_np, *, on_device: bool, rtol: float,
                       max_refine: int, ksp: KSPConfig | None,
                       newton: NewtonConfig | None, pc_type: str):
        """The defect-correction loop of both public entry points: float32
        Newton, then x -= J32^-1 F64(x) until ||F64(x)|| <= rtol ||b||.
        ``on_device`` picks where x and the float64 residual live."""
        ksp = ksp or KSPConfig(type="fgmres", rtol=1e-5, max_it=300)
        newton = newton or NewtonConfig(rtol=1e-6, max_it=30)
        b64_np = np.asarray(b_np, np.float64)
        d64_np = np.asarray(dirichlet_np, np.float64)
        b32, d32 = self._dev32(b64_np), self._dev32(d64_np)
        res32 = self.solve(b32, d32, ksp=ksp, newton=newton, pc_type=pc_type)

        if on_device:   # x and F float64 tensors on the card
            dev = self.grid.device
            residual64 = self.make_residual(torch.as_tensor(b64_np, device=dev),
                                            torch.as_tensor(d64_np, device=dev))
            residual_hi = lambda x: residual64(x)[0]  # noqa: E731
            norm = lambda F: float(torch.linalg.vector_norm(F))  # noqa: E731
            to32 = lambda a: a.to(torch.float32)  # noqa: E731
            x = res32.x.to(torch.float64)
        else:           # x and F float64 numpy arrays on the host
            residual_hi = self.make_residual_np(b64_np, d64_np)
            norm = lambda F: float(np.linalg.norm(F))  # noqa: E731
            to32 = self._dev32
            x = res32.x.cpu().numpy().astype(np.float64)

        inner = self._inner32(pc_type, ksp)
        bnorm = max(float(np.linalg.norm(b64_np)), 1e-300)
        F = residual_hi(x)
        rnorm = norm(F)
        hist = [rnorm]
        steps = inner_its = 0
        while steps < max_refine and rnorm > rtol * bnorm and math.isfinite(rnorm):
            dx, its = inner(to32(x), to32(F), b32, d32)
            if dx.dtype != torch.float32:
                raise TypeError(f"the inner solve must stay float32, returned {dx.dtype}")
            x = x - (dx.to(torch.float64) if on_device
                     else dx.cpu().numpy().astype(np.float64))
            F = residual_hi(x)
            rnorm = norm(F)
            hist.append(rnorm)
            steps += 1
            inner_its += int(its)
        info = {"newton32": res32, "refine_history": hist, "refine_steps": steps,
                "refine_inner_iters": inner_its, "rel_residual": rnorm / bnorm}
        return (x.cpu().numpy() if on_device else x), info

    def solve_refined(self, b_np, dirichlet_np, *, rtol: float = 1e-10,
                      max_refine: int = 10, ksp: KSPConfig | None = None,
                      newton: NewtonConfig | None = None,
                      pc_type: str = "fastdiag"):
        """Defect-correction Newton: float32 Newton on the device to its
        accuracy floor, then steps with float64 host residuals and float32
        preconditioned linear solves on the device.  Returns
        (x float64 numpy, info)."""
        return self._solve_refined(b_np, dirichlet_np, on_device=False, rtol=rtol,
                                   max_refine=max_refine, ksp=ksp, newton=newton,
                                   pc_type=pc_type)

    def solve_refined_fused(self, b_np, dirichlet_np, *, rtol: float = 1e-10,
                            max_refine: int = 10, ksp: KSPConfig | None = None,
                            newton: NewtonConfig | None = None,
                            pc_type: str = "fastdiag"):
        """``solve_refined`` with the refinement loop on the device: the
        float64 state and residual (``make_residual`` in float64, its
        last-axis derivatives through K1) stay on the card, the linear
        solves run in float32 there, and only the residual norm crosses to
        the host (the loop's stopping test).  Nothing is cached between
        calls: ``b`` and ``dirichlet`` are this call's.  Returns
        (x float64 numpy, info)."""
        return self._solve_refined(b_np, dirichlet_np, on_device=True, rtol=rtol,
                                   max_refine=max_refine, ksp=ksp, newton=newton,
                                   pc_type=pc_type)
