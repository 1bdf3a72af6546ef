"""Stokes saddle-point model with non-Newtonian rheology.

Counterpart of ``spectral_tpu/models/stokes.py``.  The system is

    [ VV  VP ] [v]   [f_v]        VV: Newton-linearized viscous operator
    [ PV  0  ] [p] = [f_p]        PV: divergence, VP: pressure gradient

on the CGL tensor grid (stokes.C), preconditioned by a Schur-complement
block factorization with configurable nested solves (``-vel_``,
``-svel_``, ``-schur_``; saddle types 0-3, stokes.C:1710-1817), wrapped in
Newton with parameter continuation (stokes.C:217-235).

- A state is a dict {"v": (dims..., d), "p": dims} of full-grid tensors;
  the reference's index sets and scatters are boolean mask tensors.
- Every function runs in the dtype of the state it is given, on the
  grid's device.  Boundary data, forcing and exact fields are float64
  numpy masters, cast once per dtype.
- Derivatives are ``chebdiff``.  The velocity's component axis is last,
  so its derivatives take the library product; the pressure's last axis
  (the gradient) and the velocity's last component along the last axis
  (the Schur complement's divergence) reach kernel K1 on a CUDA tensor.
- The velocity preconditioner is an exact fast-diagonalization solve of
  the FD Laplacian surrogate, an eta-weighted multigrid V-cycle (its
  smoother Chebyshev, Jacobi or line relaxation), the V-cycle on the
  nodal Jacobian stencil (``-pcvel 3``), the surrogate's diagonal, the
  strain-coupled Q1 element matrix on an exact separable-Q1 solve
  (``-pcvel 1``, ``ops/fem.py``), the separable Q1 solve alone, or a
  stencil probed from the velocity block (``-pcvel 2``).
  With mixed/Neumann boundaries the fastdiag and multigrid PCs add a
  damped boundary-normal line sweep on the surrogate with the one-sided
  traction rows, and ``tbc`` a multiplicative correction by the exact
  velocity block on the traction layer (a dense LU).
- The fused solves (``solve_continuation_fused``, ``solve_refined_fused``)
  run the host loops' control flow: the iterate and the residual stay on
  the card, and the stopping test, the forcing and the histories are host
  scalars read from it (one transfer a line-search trial or refine step).
  The JAX package compiles each into one dispatch; eager PyTorch issues
  the same kernels one by one (no CUDA graph is captured).

- ``mass_shift`` sigma adds sigma I to the velocity rows of the Jacobian
  (the unsteady step operator, ``models/stokes_unsteady.py``) and to the
  fastdiag and multigrid surrogates; ``make_dense_pc`` and
  ``make_dense_pc_var`` invert the assembled saddle Jacobian exactly
  (``ops/dense.py``).

- ``adjoint_gradient`` differentiates a quantity of interest of the
  converged state with respect to the rheology parameters
  (``solvers/adjoint.py``), preconditioned by ``make_pc(adjoint=True)``,
  the nested tree with every block transposed by ``torch.func.vjp``.

- ``phi`` solves on the curved domain Phi([-1,1]^d) (``ops/curvilinear.py``):
  gradients and the strain take the inverse-Jacobian chain rule
  d/dx_j = Jinv[l,j] d/dxi_l, divergences the conservative (Piola)
  cofactor form (1/detJ) d_xi_l(cofactor[l,j] F_j), boundary normals and
  tractions are physical, and the multigrid and nodal velocity PCs
  rediscretize the separable metric surrogate (``pcvel="mg"`` is the
  curved default of the CLI); the metric fields are float64 masters cast
  once per dtype, as the boundary data are.

- ``solve_family`` solves a parameter family at once: one batched Newton
  loop (``newton_solve_family``) over ``make_pc(batched=True)``, the nested tree
  with its loop-free blocks mapped over the family by ``torch.func.vmap``
  and every nested solve a ``KSPConfig.solve_batched``.

- ``mesh=`` runs the whole Newton solve on this process' slab of a
  sharded grid (``parallel/``): the pencil exchange for every derivative
  along a sharded axis, the masks, boundary data and metric fields cut to
  the slab, and the nested PC tree on slabs: the velocity sub-PC (fastdiag
  through the pencil exchange, multigrid and nodal with their coarse
  levels replicated, jacobi), the Schur block's pressure pieces and its
  null-space projection, every nested solve and the Newton norms summed
  over the mesh.  The mixed/Neumann line correction sweeps its lines
  through the pencil exchange; the traction-block correction solves its
  small dense block replicated.  The Q1 and probed velocity PCs and the
  dense tier on a mesh are ROADMAP item 7d.
"""

from __future__ import annotations

import dataclasses
import math
from functools import cached_property
from typing import Callable, Optional

import numpy as np
import torch

from spectral_tpu_torch.grid import Grid
from spectral_tpu_torch.models import stokes_exact as SE
from spectral_tpu_torch.models.rheology import RHEOLOGIES, PowerLawParams
from spectral_tpu_torch.ops.chebyshev import chebdiff, chebdiff_np
from spectral_tpu_torch.ops.extrapolation import _reduce_matrix_np, pressure_reduce_order
from spectral_tpu_torch.ops.fastdiag import FastDiagSolver
from spectral_tpu_torch.solvers.krylov import KSPConfig
from spectral_tpu_torch.solvers.newton import NewtonConfig, NewtonResult, _norm, newton_solve

# bytes of one-hot columns (times the intermediates of one velocity-block
# action) that the traction-block setup evaluates at once
_TBC_BATCH_BYTES = 1 << 29


_MASS_SHIFT_STEADY = ("mass_shift is the UNSTEADY step operator (the steady residual "
                      "carries no mass term — use models/stokes_unsteady.UnsteadyStokes "
                      "for time stepping)")


def _todo(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md queue 1, {item})")


@dataclasses.dataclass(frozen=True)
class StokesConfig:
    """-exact/-boundary/-rheology/... options (StokesProcessOptions,
    stokes.C:391-495) plus the nested solver configurations; the JAX
    package's fields and defaults."""

    exact: int = 0
    boundary: int = 0
    rheology: int = 0
    hardness: float = 1.0
    exponent: float = 1.0
    regularization: float = 1.0   # -eps
    gamma0: float = 1.0
    cont0: int = 0
    cont: int = 1
    scaleM: float = 1.0
    scaleN: float = 1.0
    zeroN: int = 0
    zeroV: float = 1.0
    pcvel: str = "fastdiag"   # fastdiag | mg | nodal | jacobi | q1fem | q1sep | probed | probed1
    saddle_pc: str = "schur"
    pcvel_smoother: str = "chebyshev"
    tbc: int = 0
    traction_p: bool = False
    mixed_tang: bool = False
    mass_shift: float = 0.0
    saddle: int = 0               # -pc_saddle_type: 0 LU, 1 upper, 2 diag, 3 lower
    outer_ksp: KSPConfig = KSPConfig(type="fgmres", rtol=1e-10, max_it=200, restart=50)
    vel_ksp: KSPConfig = KSPConfig(type="gmres", rtol=1e-5, max_it=4, restart=4)
    svel_ksp: KSPConfig = KSPConfig(type="preonly")
    schur_ksp: KSPConfig = KSPConfig(type="gmres", rtol=1e-5, max_it=3, restart=3)
    newton: NewtonConfig = NewtonConfig(rtol=1e-8, max_it=50)
    # "none" restarts Newton from the previous solution (stokes.C:217-235);
    # "secant" extrapolates through the last two, guarded by the residual
    cont_predictor: str = "none"


class StokesProblem:
    """The static domain structure (masks, boundary data, forcing) and the
    operators of one Stokes problem on ``grid``."""

    def __init__(self, grid: Grid, config: StokesConfig = StokesConfig(),
                 mesh=None, sharded_axis: int = 0, mesh_axis: str = "x",
                 axis_map: dict | None = None, phi: Callable | None = None,
                 pipeline_chunks: int = 1):
        """``mesh`` (``parallel.mesh.Mesh``) runs the solve on this process'
        slab: grid axis ``sharded_axis`` over mesh axis ``mesh_axis`` (or
        ``axis_map`` for a P x Q mesh), every derivative and the pressure
        extrapolation along a sharded axis through the pencil exchange, the
        masks, boundary data and metric fields as slabs, the pressure mean,
        the Krylov and Newton norms summed over the mesh, the nested PC on
        slabs.  States (``zero_state``, ``exact_state``, x0) are slabs."""
        from spectral_tpu_torch.parallel.slab import Slab

        self.mesh = mesh
        self.sharded_axis = sharded_axis
        self.mesh_axis = mesh_axis
        self.axis_map = axis_map
        self.pipeline_chunks = pipeline_chunks
        self.phi = phi
        self.slab = Slab.of(mesh, axis_map, sharded_axis, mesh_axis, pipeline_chunks)
        self._reduce = None if mesh is None else mesh.allreduce
        self.cmap = None
        if phi is not None:
            if grid.intervals is not None or grid.maps is not None:
                raise ValueError("curvilinear Stokes needs an unmapped Grid; "
                                 "fold affine/axis maps into phi")
            from spectral_tpu_torch.ops.curvilinear import CurvilinearMap
            self.cmap = CurvilinearMap.build(grid, phi)
            # float64 masters of the metric fields, cast once per dtype by _c
            self.Jinv_np = self.cmap.Jinv
            self.cofactor_np = self.cmap.cofactor
            self.detJ_np = self.cmap.detJ
            self.Acoef_np = self.cmap.Acoef
        self.grid = grid
        self.config = config
        self.d = grid.ndim
        self._consts: dict = {}
        self._fastdiag: dict = {}
        self._adjoint_ops: dict = {}   # dtype -> (PV^T, VP^T)
        self._setup_domain()
        self._setup_exact_and_force()
        if mesh is not None:
            self._mesh_dif = self.slab.dif()
            # the global masks stay for the PC setups that build global stencils
            self._global = {}
            for name in ("vel_mask", "p_mask", "dirichlet_mask", "nm_mask", "mixed_mask",
                         "neumann_mask"):
                self._global[name] = getattr(self, name)
                setattr(self, name, self._slab(getattr(self, name)))
            self._dirichlet_v = self.dirichlet_mask[..., None]
            self._nm_v = self.nm_mask[..., None]
            self._mixed_v = self.mixed_mask[..., None]
            self._neumann_v = self.neumann_mask[..., None]

    def _slab(self, t: torch.Tensor) -> torch.Tensor:
        """This process' slab of a global grid tensor (itself without a
        mesh)."""
        return t if self.mesh is None else self.slab.local(t)

    def _dif(self, v: torch.Tensor, axis: int) -> torch.Tensor:
        if self.mesh is None:
            return self.grid.apply_dif_weight(chebdiff(v, axis), axis)
        return self.slab.dif_weight(self.grid, self._mesh_dif(v, axis), axis)

    def _reduce_order(self, p: torch.Tensor) -> torch.Tensor:
        """pressure_reduce_order, through the pencil exchange along a
        sharded axis."""
        if self.mesh is None:
            return pressure_reduce_order(p, self.grid.nodes_1d)
        from spectral_tpu_torch.ops.extrapolation import reduce_order_matrix

        for ax in reversed(range(self.d)):
            p = self.slab.apply_axis(reduce_order_matrix(self.grid.nodes_1d[ax], p.dtype,
                                                         p.device), p, ax)
        return p

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """The global tensor of a slab (itself without a mesh)."""
        return t if self.mesh is None else self.slab.gather(t)

    def _whole(self, name: str) -> torch.Tensor:
        """A mask of the global grid (``vel_mask``, ``nm_mask``, ...)."""
        return getattr(self, name) if self.mesh is None else self._global[name]

    @cached_property
    def _one(self) -> "StokesProblem":
        """This problem in one process (the same grid, configuration and
        map): the replicated pieces of a PC on a mesh build on it."""
        return StokesProblem(self.grid, self.config, phi=self.phi)

    # ------------------------------------------------------------------
    # Domain setup: masks instead of IS/scatters (StokesSetupDomain analog)
    # ------------------------------------------------------------------
    def _setup_domain(self):
        g, d = self.grid, self.d
        cfg = self.config
        bmask = g.boundary_mask_np
        coords_b = g.coords_np[bmask]   # reference coordinates
        bf = SE.BOUNDARY_FUNCS[cfg.boundary]
        exact_fn = SE.EXACT_SOLUTIONS[cfg.exact]
        if self.cmap is None:
            normal_np = g.normal_np
            out = bf(coords_b, normal_np[bmask], exact_fn, full_traction=cfg.traction_p)
        else:
            # the node types from the reference coordinates; values and
            # tractions at the physical nodes with the physical normals
            normal_np = self.cmap.boundary_normal()
            out = bf(coords_b, g.normal_np[bmask], exact_fn,
                     phys_coords=self.cmap.coords[bmask], phys_normals=normal_np[bmask],
                     full_traction=cfg.traction_p)
        # boundary funcs may return an inhomogeneous normal-flux field
        # (manufactured sliding, boundary 5): v.n = vnormal at MIXED nodes
        if len(out) == 4:
            types_b, values_b, alpha_b, vnormal_b = out
        else:
            types_b, values_b, alpha_b = out
            vnormal_b = np.zeros(len(types_b))

        types = np.full(g.dims, -1, dtype=np.int32)
        types[bmask] = types_b
        bc_vel = np.zeros(g.dims + (d,))
        bc_vel[bmask] = values_b
        alpha = np.zeros(g.dims)
        alpha[bmask] = alpha_b
        bc_vnormal = np.zeros(g.dims)
        bc_vnormal[bmask] = vnormal_b

        dirichlet_mask = types == SE.BdyType.DIRICHLET
        neumann_mask = types == SE.BdyType.NEUMANN
        mixed_mask = types == SE.BdyType.MIXED
        nm_mask = neumann_mask | mixed_mask
        self.num_neumann = int(neumann_mask.sum())
        # -traction_p rows pin the pressure constant: no null space left
        self.has_p_null = not (cfg.traction_p and self.num_neumann > 0)

        # one-hot of the most-normal component at mixed nodes (stokes.C:836-851)
        in_onehot = np.zeros(g.dims + (d,))
        if mixed_mask.any():
            nvecs = normal_np[mixed_mask]
            comp = np.argmax(np.abs(nvecs), axis=-1)
            oh = np.zeros_like(nvecs)
            oh[np.arange(len(comp)), comp] = 1.0
            in_onehot[mixed_mask] = oh

        vel_mask = np.ones(g.dims + (d,), dtype=bool)
        vel_mask[dirichlet_mask] = False
        vel_mask &= in_onehot == 0.0  # mixed normal component removed

        # the principal normal axis (or axes, tied at edges and corners) of
        # every mixed/Neumann node, for the one-sided rows of the velocity
        # PC (stokes.C:1183-1199): float64, as the JAX package takes it,
        # so every dtype picks the same rows.  On a curved domain the axis
        # and the inward side come from the reference cube's normal (the
        # one-sided row must step to a neighbour on the grid).
        ref_normal = g.normal_np if self.cmap is not None else normal_np
        oh = np.where(nm_mask[..., None], 1.0, 0.0) * np.abs(ref_normal) \
            / np.maximum(np.max(np.abs(ref_normal), -1, keepdims=True), 1e-14)
        nm_onehot = (oh >= 1.0).astype(np.float64)
        self.ref_normal_np = ref_normal

        # float64 host masters; tensors per dtype come from _c
        self.types_np = types
        self.bc_vel_np = bc_vel
        self.bc_vnormal_np = bc_vnormal
        self.alpha_np = alpha
        self.normal_np = normal_np
        self.in_onehot_np = in_onehot
        self.nm_onehot_np = nm_onehot
        self.vel_mask_np = vel_mask
        self.p_mask_np = ~bmask
        self.dirichlet_mask_np = dirichlet_mask
        self.nm_mask_np = nm_mask
        self.mixed_mask_np = mixed_mask
        self.neumann_mask_np = neumann_mask

        def b(a):
            return torch.as_tensor(a, device=g.device)

        self.vel_mask = b(vel_mask)
        self.p_mask = b(~bmask)
        self.dirichlet_mask = b(dirichlet_mask)
        self.nm_mask = b(nm_mask)
        self.mixed_mask = b(mixed_mask)
        self.neumann_mask = b(neumann_mask)
        self._dirichlet_v = self.dirichlet_mask[..., None]
        self._nm_v = self.nm_mask[..., None]
        self._mixed_v = self.mixed_mask[..., None]
        self._neumann_v = self.neumann_mask[..., None]
        self.num_mixed = int(nm_mask.sum())
        # boundary 6 manufactures tangentially-projected sliding data and
        # boundary 7 (free-slip box) imposes zero tangential traction, so
        # the operator's mixed rows must use the matching P_t form
        self.mixed_tang = bool(cfg.mixed_tang or cfg.boundary in (6, 7))
        if cfg.boundary == 5 and self.mixed_tang:
            raise ValueError(
                "-boundary 5 manufactures FULL-COMPONENT mixed data; "
                "-mixed_tang rows would converge to a wrong solution — "
                "use -boundary 6 for the tangentially-projected form")
        if cfg.boundary in (5, 6) and (cfg.scaleM != 1.0 or cfg.scaleN != 1.0):
            raise ValueError(
                "boundary 5/6 manufactured data assumes scaleM = scaleN = 1")

    def census(self) -> str:
        """DOF distribution print (stokes.C:891)."""
        g, d = self.grid, self.d
        gv = int(self.vel_mask_np.sum())
        gp = int(self.p_mask_np.sum())
        dv = int(self.dirichlet_mask_np.sum()) * d
        return (f"DOF distribution: {gv + gp} global   {gp}/{g.size} pressure"
                f"    {gv}/{g.size * d} velocity    {dv} dirichlet"
                f"    {self.num_mixed} mixed")

    @property
    def coords_phys_np(self) -> np.ndarray:
        """(dims..., d) float64 physical node positions (the reference
        coordinates on an unmapped domain)."""
        return self.grid.coords_np if self.cmap is None else self.cmap.coords

    def _setup_exact_and_force(self):
        d = self.d
        value, rhs = SE.EXACT_SOLUTIONS[self.config.exact](self.coords_phys_np)
        rhs_v = np.where(self.nm_mask_np[..., None], self.bc_vel_np, rhs[..., :d])
        self.exact_v_np = np.where(self.vel_mask_np, value[..., :d], 0.0)
        self.exact_p_np = np.where(self.p_mask_np, value[..., d], 0.0)
        self.force_np = {"v": np.where(self.vel_mask_np, rhs_v, 0.0),
                         "p": np.where(self.p_mask_np, rhs[..., d], 0.0)}

    def _c(self, name: str, dtype: torch.dtype) -> torch.Tensor:
        """The float64 host master ``<name>_np`` (or force_np["v"|"p"] as
        "force_v"/"force_p") as a tensor in ``dtype`` on the grid's device
        (this process' slab on a mesh), cast once per dtype."""
        key = (name, dtype)
        t = self._consts.get(key)
        if t is None:
            a = (self.force_np[name[-1]] if name.startswith("force_")
                 else getattr(self, name + "_np"))
            if self.mesh is not None:
                a = self.slab.local_np(a)
            t = self._consts[key] = torch.as_tensor(a, dtype=dtype, device=self.grid.device)
        return t

    # the grid dtype's copies, as the JAX package names them
    @property
    def bc_vel(self) -> torch.Tensor:
        return self._c("bc_vel", self.grid.dtype)

    @property
    def normal(self) -> torch.Tensor:
        return self._c("normal", self.grid.dtype)

    @property
    def alpha(self) -> torch.Tensor:
        return self._c("alpha", self.grid.dtype)

    @property
    def in_onehot(self) -> torch.Tensor:
        return self._c("in_onehot", self.grid.dtype)

    @property
    def exact_v(self) -> torch.Tensor:
        return self._c("exact_v", self.grid.dtype)

    @property
    def exact_p(self) -> torch.Tensor:
        return self._c("exact_p", self.grid.dtype)

    @property
    def force(self) -> dict:
        return {"v": self._c("force_v", self.grid.dtype),
                "p": self._c("force_p", self.grid.dtype)}

    # ------------------------------------------------------------------
    # Masked "scatters"
    # ------------------------------------------------------------------
    def mask_v(self, v: torch.Tensor) -> torch.Tensor:
        return torch.where(self.vel_mask, v, 0.0)

    def mask_p(self, p: torch.Tensor) -> torch.Tensor:
        return torch.where(self.p_mask, p, 0.0)

    def recover_mixed(self, v: torch.Tensor, inhomogeneous: bool = False) -> torch.Tensor:
        """StokesMixedVelocity (stokes.C:1133-1156): reconstruct the removed
        most-normal component for the normal-flux constraint.  The residual
        path (``inhomogeneous``) enforces v.n = bc_vnormal; the Jacobian
        path keeps the homogeneous v.n = 0."""
        if self.num_mixed == 0:
            return v
        oh = self._c("in_onehot", v.dtype)
        n = self._c("normal", v.dtype)
        v_excl = v * (1.0 - oh)
        num = torch.sum(v_excl * n, dim=-1, keepdim=True)
        if inhomogeneous:
            num = num - self._c("bc_vnormal", v.dtype)[..., None]
        n_in = torch.sum(n * oh, dim=-1, keepdim=True)
        vin = -num / torch.where(torch.abs(n_in) > 1e-14, n_in, 1.0)
        return torch.where(self._mixed_v, v_excl + oh * vin, v)

    def local_velocity(self, vG: torch.Tensor, with_dirichlet: bool = True, *,
                       inhomogeneous: bool | None = None) -> torch.Tensor:
        """The full velocity field of a global one: masked, the mixed
        normal component recovered and, on the residual path
        (``with_dirichlet``), the Dirichlet data set."""
        if inhomogeneous is None:
            inhomogeneous = with_dirichlet
        v = self.recover_mixed(self.mask_v(vG), inhomogeneous=inhomogeneous)
        if with_dirichlet:
            v = torch.where(self._dirichlet_v, self._c("bc_vel", v.dtype), v)
        return v

    # ------------------------------------------------------------------
    # Differential pieces
    # ------------------------------------------------------------------
    def _grad_tensor(self, vL: torch.Tensor) -> torch.Tensor:
        """G[..., j, k] = d v_k / d x_j (Jinv[l, j] d/dxi_l on a curved
        domain)."""
        G = torch.stack([self._dif(vL, j) for j in range(self.d)], dim=-2)
        if self.cmap is not None:
            G = torch.einsum("...lj,...lk->...jk", self._c("Jinv", G.dtype), G)
        return G

    def _strain(self, vL: torch.Tensor) -> torch.Tensor:
        G = self._grad_tensor(vL)
        return 0.5 * (G + G.transpose(-1, -2))

    def _tensor_divergence(self, flux: torch.Tensor) -> torch.Tensor:
        """y_k = sum_j d flux[..., j, k] / d x_j (summed from j = 0, as the
        JAX package sums onto zeros); the Piola form on a curved domain."""
        if self.cmap is not None:
            flux = torch.einsum("...lj,...jk->...lk", self._c("cofactor", flux.dtype), flux)
        y = self._dif(flux[..., 0, :], 0)
        for j in range(1, self.d):
            y = y + self._dif(flux[..., j, :], j)
        if self.cmap is not None:
            y = y / self._c("detJ", y.dtype)[..., None]
        return y

    def _piola_div(self, vL: torch.Tensor) -> torch.Tensor:
        """Masked continuity rows of a full velocity field: sum_i d v_i/d x_i,
        the conservative Piola form on a curved domain."""
        if self.cmap is not None:
            vL = torch.einsum("...li,...i->...l", self._c("cofactor", vL.dtype), vL)
        div = self._dif(vL[..., 0], 0)
        for i in range(1, self.d):
            div = div + self._dif(vL[..., i], i)
        if self.cmap is not None:
            div = div / self._c("detJ", div.dtype)
        return self.mask_p(div)

    def divergence(self, vG: torch.Tensor, with_dirichlet: bool) -> torch.Tensor:
        """StokesDivergence (stokes.C:569-595)."""
        return self._piola_div(self.local_velocity(vG, with_dirichlet))

    def pressure_gradient(self, pG: torch.Tensor) -> torch.Tensor:
        """VP block (stokes.C:598-619): reduce the pressure order, take the
        gradient, zero mixed/Neumann rows (with -traction_p the Neumann rows
        carry the pressure's share of the traction), mask to the global
        velocity."""
        cfg = self.config
        pL = self._reduce_order(self.mask_p(pG))
        gp = torch.stack([self._dif(pL, i) for i in range(self.d)], dim=-1)
        if self.cmap is not None:
            gp = torch.einsum("...li,...l->...i", self._c("Jinv", gp.dtype), gp)
        if self.num_mixed:
            gp = torch.where(self._nm_v, 0.0, gp)
        if cfg.traction_p and self.num_neumann > 0:
            rows = cfg.scaleM * cfg.scaleN * (-pL[..., None] * self._c("normal", gp.dtype))
            gp = torch.where(self._neumann_v, rows, gp)
        return self.mask_v(gp)

    def _mixed_rows(self, y, stress, vL):
        """StokesMixedApply (stokes.C:1083-1110): replace Neumann/mixed rows
        with scaleM*(scaleN * stress.n + alpha * v); with ``mixed_tang`` the
        mixed rows are tangentially projected."""
        if self.num_mixed == 0:
            return y
        cfg = self.config
        n = self._c("normal", y.dtype)
        traction = torch.einsum("...jk,...k->...j", stress, n)
        load = cfg.scaleN * traction + self._c("alpha", y.dtype)[..., None] * vL
        rows = cfg.scaleM * load
        if self.mixed_tang:
            tang = load - torch.sum(load * n, dim=-1, keepdim=True) * n
            rows = torch.where(self._mixed_v, cfg.scaleM * tang, rows)
        return torch.where(self._nm_v, rows, y)

    def rheology(self, gamma: torch.Tensor, params: PowerLawParams):
        return RHEOLOGIES[self.config.rheology](gamma, params)

    # ------------------------------------------------------------------
    # Residual and Jacobian blocks
    # ------------------------------------------------------------------
    def _viscous_rows(self, vfull: torch.Tensor, params: PowerLawParams):
        """(masked momentum rows, lin_state) of -div(eta(eps) eps) at a full
        velocity field, with the mixed/Neumann traction rows."""
        S = self._strain(vfull)
        gamma = 0.5 * torch.sum(S * S, dim=(-1, -2))
        eta, deta = self.rheology(gamma, params)
        flux = eta[..., None, None] * S
        yv = -self._tensor_divergence(flux)
        yv = self._mixed_rows(yv, flux, vfull)
        return self.mask_v(yv), (eta, deta, S)

    def make_residual(self, params: PowerLawParams, monitor_eta: bool = False):
        """StokesFunction (stokes.C:679-758) as x -> (F, lin_state), in x's
        dtype.  ``monitor_eta`` prints the viscosity extremes at every
        evaluation (stokes.C:730-735), which synchronises with the host."""

        def residual(xG):
            vL = self.local_velocity(xG["v"], with_dirichlet=True)
            rows, (eta, deta, S) = self._viscous_rows(vL, params)
            if monitor_eta:
                print(f"Minimum eta = {float(torch.min(eta)):.3e}   "
                      f"Maximum eta = {float(torch.max(eta)):.3e}")
            Fv = rows + self.pressure_gradient(xG["p"])
            # div v is the trace of the strain already computed; a curved
            # domain keeps the conservative Piola divergence
            Fp = (self._div_from_strain(S) if self.cmap is None
                  else self.divergence(xG["v"], with_dirichlet=True))
            dt = Fv.dtype
            F = {"v": Fv - self._c("force_v", dt), "p": Fp - self._c("force_p", dt)}
            return F, (eta, deta, S)

        return residual

    def _div_from_strain(self, S: torch.Tensor) -> torch.Tensor:
        """Velocity divergence as the strain-tensor trace (the diagonal of
        G survives symmetrization bitwise, 0.5*(x+x) == x)."""
        div = S[..., 0, 0]
        for i in range(1, self.d):
            div = div + S[..., i, i]
        return self.mask_p(div)

    def _vv_core(self, lin_state, wv: torch.Tensor):
        """VV action and the strain of the perturbation (shared with PV)."""
        eta, deta, S0 = lin_state
        wL = self.recover_mixed(self.mask_v(wv))
        Sw = self._strain(wL)
        z = torch.sum(Sw * S0, dim=(-1, -2))
        e = eta[..., None, None]
        flux = e * Sw + deta[..., None, None] * S0 * z[..., None, None]
        yv = -self._tensor_divergence(flux)
        if self.config.mass_shift:
            # before _mixed_rows: traction rows carry no time derivative
            yv = yv + self.config.mass_shift * wL
        if self.num_mixed:
            yv = self._mixed_rows(yv, e * Sw, wL)
        return self.mask_v(yv), Sw

    def vv_action(self, lin_state, wv: torch.Tensor) -> torch.Tensor:
        """VV block (StokesMatMultVV, stokes.C:622-676): exact Newton
        linearization of the viscous term about the frozen state."""
        return self._vv_core(lin_state, wv)[0]

    def jacobian_action(self, x, lin_state, w) -> dict:
        """Full block matvec (StokesMatMult, stokes.C:497-519); the PV row
        reuses the VV row's strain (its trace is the divergence), except on
        a curved domain, which keeps the Piola divergence."""
        yv, Sw = self._vv_core(lin_state, w["v"])
        Fp = (self._div_from_strain(Sw) if self.cmap is None
              else self.divergence(w["v"], with_dirichlet=False))
        return {"v": yv + self.pressure_gradient(w["p"]), "p": Fp}

    # ------------------------------------------------------------------
    # Null space (StokesRemoveConstantPressure, stokes.C:1006-1025)
    # ------------------------------------------------------------------
    def project_p(self, p: torch.Tensor) -> torch.Tensor:
        if not self.has_p_null:   # -traction_p pins the constant
            return self.mask_p(p)
        count = float(self.grid.num_interior)
        total = torch.sum(self.mask_p(p))
        if self.mesh is not None:
            total = self.mesh.allreduce(total)
        return self.mask_p(p - total / count)

    def null_project(self, x: dict) -> dict:
        if not self.has_p_null:
            return x
        return {"v": x["v"], "p": self.project_p(x["p"])}

    # ------------------------------------------------------------------
    # Preconditioning (PCSetUp0 + PCApply0..3)
    # ------------------------------------------------------------------
    def _vel_fastdiag(self, dtype: torch.dtype) -> FastDiagSolver:
        fd = self._fastdiag.get(dtype)
        if fd is None:
            fd = self._fastdiag[dtype] = FastDiagSolver.build(
                self.grid, dtype=dtype, shift=self.config.mass_shift)
        return fd

    def _mg_builder(self, stencil):
        """A multigrid level builder: ``stencil(grid, eta)`` on each level's
        restricted eta (ones where absent)."""
        def builder(grid, coeffs):
            eta = coeffs.get("eta")
            if eta is None:
                eta = torch.ones(grid.dims, dtype=grid.dtype, device=grid.device)
            return stencil(grid, eta)

        return builder

    def _vel_mg_coeffs(self, eta: torch.Tensor) -> dict:
        """The velocity multigrid's coefficient fields: eta, and on a curved
        domain the metric surrogate's (``CurvilinearMap.pc_coeffs``)."""
        if self.cmap is None:
            return {"eta": eta}
        return self.cmap.pc_coeffs(eta)

    @cached_property
    def _vel_mg(self):
        from spectral_tpu_torch.models.stokes_pc import velocity_fd_stencil
        from spectral_tpu_torch.ops.multigrid import Multigrid

        if self.cmap is None:
            base = self._mg_builder(velocity_fd_stencil)
        else:   # -(1/detJ) d_l(eta A_ll d_l .), cross terms dropped
            from spectral_tpu_torch.ops.curvilinear import metric_surrogate_builder
            base = metric_surrogate_builder(self.d)
        sigma = self.config.mass_shift
        if not sigma:
            return Multigrid.build(self.grid, builder=base, smoother=self.config.pcvel_smoother
                                   ).with_slab(self.slab)

        def builder(grid, coeffs):
            # the shifted surrogate sigma + A rediscretized on every level
            S = base(grid, coeffs)
            return dataclasses.replace(
                S, center=torch.where(grid.interior_mask, S.center + sigma, S.center))

        return Multigrid.build(self.grid, builder=builder, smoother=self.config.pcvel_smoother
                               ).with_slab(self.slab)

    @cached_property
    def _vel_mg_nodal(self):
        """-pcvel 3 (StokesPCSetUp3, stokes.C:1569-1641): one V-cycle on the
        nodal Jacobian stencil, rediscretized per level; on a curved domain
        the nodal residual of the metric form (eta A_ll flux coefficients,
        1/detJ row scale)."""
        from spectral_tpu_torch.models.stokes_pc import nodal_jacfwd_stencil
        from spectral_tpu_torch.ops.multigrid import Multigrid

        if self.cmap is None:
            builder = self._mg_builder(nodal_jacfwd_stencil)
        else:
            d = self.d

            def builder(grid, coeffs):
                eta = coeffs.get("eta")
                if eta is None:
                    eta = torch.ones(grid.dims, dtype=grid.dtype, device=grid.device)
                return nodal_jacfwd_stencil(
                    grid, eta, caxes=[eta * coeffs[f"metric_a{ax}"] for ax in range(d)],
                    row_scale=1.0 / coeffs["metric_detJ"])
        return Multigrid.build(self.grid, builder=builder, smoother=self.config.pcvel_smoother
                               ).with_slab(self.slab)

    def _mixed_fd_stencil(self, eta: torch.Tensor):
        """The FD velocity surrogate with the one-sided traction rows,
        scaled like the residual's mixed rows (scaleM*(scaleN*traction +
        alpha*v), stokes.C:1183-1200), in eta's dtype.  On a curved domain
        the interior rows take the metric coefficients eta A_ll with the
        1/detJ row scale, and the traction rows are scaled by |(Jinv n)_ax|
        (the physical normal derivative along the principal reference
        axis, which and whose inward side the reference normal picks)."""
        from spectral_tpu_torch.models.stokes_pc import velocity_fd_stencil

        cfg = self.config
        dt = eta.dtype
        normal = self._c("normal", dt)
        nm_oh = self._c("nm_onehot", dt)
        kwargs = {}
        if self.cmap is not None:
            A = self._c("Acoef", dt)
            nu = torch.einsum("...lk,...k->...l", self._c("Jinv", dt), normal)
            kwargs = dict(caxes=[eta * A[..., ax, ax] for ax in range(self.d)],
                          row_scale=1.0 / self._c("detJ", dt),
                          nscale=torch.clamp_min(torch.sum(nm_oh * torch.abs(nu), dim=-1),
                                                 1e-14))
        return velocity_fd_stencil(
            self.grid, eta, scaleN=cfg.scaleM * cfg.scaleN, nm_mask=self.nm_mask,
            nm_onehot=nm_oh, normal=normal, ref_normal=self._c("ref_normal", dt),
            alpha=cfg.scaleM * self._c("alpha", dt), **kwargs)

    @cached_property
    def _nm_axes(self) -> tuple:
        """Axes that are a principal normal of some mixed/Neumann node (the
        reference cube's normal on a curved domain, as the stencil's
        one-sided rows take it)."""
        oh = np.where(self.nm_mask_np[..., None], np.abs(self.ref_normal_np), 0.0)
        mx = oh.max(axis=-1, keepdims=True)
        return tuple(ax for ax in range(self.d)
                     if bool(((oh[..., ax] >= mx[..., 0]) & (oh[..., ax] > 0)).any()))

    def _mixed_line_state(self, eta: torch.Tensor):
        """(stencil, per-axis line solvers) of the mixed-row correction,
        built once per PC setup."""
        from spectral_tpu_torch.ops.tridiag import build_line_solvers

        axes = self._nm_axes or tuple(range(self.d))
        if self.mesh is not None:   # the global surrogate, its lines on slabs
            S = self._one._mixed_fd_stencil(self._gather(eta))
            return self.slab.stencil(S), build_line_solvers(
                S, axes, mask=self._whole("vel_mask"), slab=self.slab)
        S = self._mixed_fd_stencil(eta)
        return S, build_line_solvers(S, axes, mask=self.vel_mask)

    def _mixed_line_correct(self, state, z: torch.Tensor, r: torch.Tensor,
                            omega: float = 0.5, sweeps: int = 1) -> torch.Tensor:
        """Damped boundary-normal line relaxation on the mixed-row FD
        surrogate, seeded by the interior solve z: the one-sided traction
        rows are inverted exactly along their normal (the cure for the
        reference's "convergence is terrible" mixed regime, README:124-153).
        omega 0.5: the component-decoupled two-point rows only approximate
        the spectral, component-coupled traction rows, and a full
        inversion overshoots."""
        from spectral_tpu_torch.ops.tridiag import line_smooth

        S, solvers = state
        zs = line_smooth(S, z, r, axes=self._nm_axes or tuple(range(self.d)),
                         sweeps=sweeps, mask=self.vel_mask, solvers=solvers)
        return self.mask_v(z + omega * (zs - z))

    @cached_property
    def _tbc_idx(self) -> torch.Tensor:
        """Flat indices (into the (dims..., d) velocity array) of the
        traction-block DOFs: the free velocity components at mixed/Neumann
        nodes, the node set dilated by ``tbc - 1`` one-step neighbour
        layers along every axis."""
        nodes = self.nm_mask_np.copy()
        for _ in range(max(0, self.config.tbc - 1)):
            grown = nodes.copy()
            for ax in range(self.d):
                lo = [slice(None)] * self.d
                hi = [slice(None)] * self.d
                lo[ax] = slice(None, -1)
                hi[ax] = slice(1, None)
                grown[tuple(lo)] |= nodes[tuple(hi)]
                grown[tuple(hi)] |= nodes[tuple(lo)]
            nodes = grown
        idx = np.flatnonzero((nodes[..., None] & self.vel_mask_np).reshape(-1))
        return torch.as_tensor(idx, device=self.grid.device)

    def _tbc_setup(self, lin_state):
        """LU factors of the exact velocity block on the traction layer,
        A_BB, in the linearization's dtype: column j is vv_action of the
        j-th one-hot sampled at the block DOFs.  The one-hots go through
        ``torch.func.vmap(vv_action)`` in batches of about
        _TBC_BATCH_BYTES.  On a mesh the block is built replicated from the
        gathered linearization (every process holds the same factors)."""
        if self.mesh is not None:
            lu, piv, _ = self._one._tbc_setup(self.slab.gather_fields(lin_state))
            return lu, piv, lin_state
        idx = self._tbc_idx
        m = idx.numel()
        dt = lin_state[0].dtype
        shape = self.grid.dims + (self.d,)
        size = math.prod(shape)
        itemsize = torch.finfo(dt).bits // 8
        batch = max(1, min(m, _TBC_BATCH_BYTES // (16 * self.d * size * itemsize)))
        action = torch.func.vmap(lambda e: self.vv_action(lin_state, e))
        rows = []
        for start in range(0, m, batch):
            cols = idx[start:start + batch]
            e = torch.zeros((cols.numel(), size), dtype=dt, device=idx.device)
            e[torch.arange(cols.numel(), device=idx.device), cols] = 1.0
            rows.append(action(e.reshape((-1,) + shape)).reshape(cols.numel(), size)[:, idx])
        A_BB = torch.cat(rows).T   # (m, m): row i of `rows` is column i
        lu, piv = torch.linalg.lu_factor(A_BB)
        return lu, piv, lin_state

    def _tbc_correct(self, tb_state, z: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        """z += R^T A_BB^{-1} R (r - A z), with the exact residual update
        (one vv_action): the preconditioned operator acts as the identity
        on error modes supported in the traction block."""
        lu, piv, lin_state = tb_state
        idx = self._tbc_idx
        rz = r - self.vv_action(lin_state, z)
        zg, rz = self._gather(z), self._gather(rz).reshape(-1)   # replicated block solve
        dB = torch.linalg.lu_solve(lu, piv, rz[idx][:, None].to(lu.dtype))[:, 0]
        zg = zg.reshape(-1).index_add(0, idx, dB.to(z.dtype)).reshape(zg.shape)
        return self.mask_v(zg if self.mesh is None else self.slab.local(zg))

    def make_vel_pc(self):
        """(setup: lin_state -> vstate, apply: (vstate, r) -> z), the
        strong approximate inverse of the FD velocity surrogate (MatVVPC,
        solved with hypre in the reference), with the traction-block
        correction (``tbc``) composed multiplicatively on top."""
        setup, apply = self._make_vel_pc_base()
        if self.config.tbc <= 0 or self.num_mixed == 0:
            return setup, apply

        def setup_tbc(lin_state):
            return setup(lin_state), self._tbc_setup(lin_state)

        def apply_tbc(vstate, r):
            inner, tb = vstate
            return self._tbc_correct(tb, apply(inner, r), r)

        return setup_tbc, apply_tbc

    def _q1_fastdiag(self, dtype: torch.dtype):
        """The exact separable-Q1 solve (ops.fem.Q1FastDiag), its factors
        in ``dtype``, built once per dtype."""
        from spectral_tpu_torch.ops.fem import Q1FastDiag

        key = ("q1", dtype)
        fd = self._fastdiag.get(key)
        if fd is None:
            fd = self._fastdiag[key] = Q1FastDiag.build(self.grid, dtype=dtype)
        return fd

    def _make_vel_pc_base(self):
        """- "fastdiag": exact constant-coefficient tensor solve (the setup
          picks the factors of the linearization's dtype);
        - "mg": one eta-weighted multigrid V-cycle (StokesPCSetUp0 stencil
          rediscretized per level);
        - "nodal": one V-cycle on the nodal Jacobian stencil (-pcvel 3);
        - "jacobi": the stencil's diagonal;
        - "q1fem" (-pcvel 1, StokesPCSetUp1): the strain-coupled Q1 element
          matrix of the linearization (ops.fem.assemble_q1_strain), solved
          approximately by 1/eta-scaled Richardson, two corrections on the
          exact separable-Q1 solve;
        - "q1sep": the separable Q1 Laplacian, solved exactly;
        - "probed" (-pcvel 2, StokesPCSetUp2): the velocity block probed
          onto the upstream d (4d+1)-entry pattern, 4 damped-Jacobi sweeps
          at 0.7; "probed1": the component-diagonal (2d+1)-point probe, the
          same sweeps a component.
        With mixed/Neumann nodes, fastdiag and mg add the line-relaxed
        traction rows (_mixed_line_correct); the Q1 and probed PCs add no
        line correction, as in the JAX package.  With ``mesh``, fastdiag,
        mg, nodal and jacobi apply to slabs: fastdiag through the pencil
        exchange, the stencil setups from the gathered viscosity (the
        global hierarchy, as one process builds it), mg and nodal cycling
        on slabs with their coarse levels replicated, jacobi the slab's
        diagonal."""
        pcvel = self.config.pcvel
        if self.config.mass_shift and pcvel not in ("fastdiag", "mg"):
            raise ValueError(f"mass_shift (unsteady Stokes) supports pcvel fastdiag|mg, "
                             f"not {pcvel!r}")
        if self.mesh is not None and pcvel not in ("fastdiag", "mg", "nodal", "jacobi"):
            raise _todo(f"pcvel {pcvel!r} on a mesh", "item 7d")
        mixed = self.num_mixed > 0
        if pcvel == "fastdiag":
            if mixed:
                return (lambda ls: (self._vel_fastdiag(ls[0].dtype),
                                    self._mixed_line_state(ls[0])),
                        lambda st, r: self._mixed_line_correct(
                            st[1], self.mask_v(st[0].apply(r, slab=self.slab)), r))
            return (lambda lin_state: self._vel_fastdiag(lin_state[0].dtype),
                    lambda fd, r: self.mask_v(fd.apply(r, slab=self.slab)))
        if pcvel == "mg":
            mg = self._vel_mg
            if mixed:
                return (lambda ls: (mg.setup(self._vel_mg_coeffs(self._gather(ls[0]))),
                                    self._mixed_line_state(ls[0])),
                        lambda st, r: self._mixed_line_correct(
                            st[1], self.mask_v(mg.vcycle(st[0], r)), r))
            return (lambda lin_state: mg.setup(self._vel_mg_coeffs(self._gather(lin_state[0]))),
                    lambda vstate, r: self.mask_v(mg.vcycle(vstate, r)))
        if pcvel == "nodal":
            mg = self._vel_mg_nodal
            return (lambda lin_state: mg.setup(self._vel_mg_coeffs(self._gather(lin_state[0]))),
                    lambda vstate, r: self.mask_v(mg.vcycle(vstate, r)))
        if pcvel == "jacobi":
            from spectral_tpu_torch.models.stokes_pc import velocity_fd_stencil
            return (lambda lin_state: self._slab(velocity_fd_stencil(
                        self.grid, self._gather(lin_state[0])).diag())[..., None],
                    lambda diag, r: self.mask_v(r / diag))
        if pcvel == "q1fem":
            from spectral_tpu_torch.ops.fem import assemble_q1_strain
            cfg = self.config

            def setup(lin_state):
                eta, deta, S = lin_state
                # isoparametric elements on the physical nodes of a curved domain
                A = assemble_q1_strain(self.grid, eta, deta, S, self.vel_mask,
                                       zeroN=cfg.zeroN, zeroV=cfg.zeroV,
                                       coords=None if self.cmap is None else self.cmap.coords)
                return A, 1.0 / eta[..., None], self._q1_fastdiag(eta.dtype)

            def apply(state, r):
                A, inv_eta, fd = state
                z = self.mask_v(fd.apply(r * inv_eta))
                for _ in range(2):
                    z = z + self.mask_v(fd.apply((r - A.apply(z)) * inv_eta))
                return self.mask_v(z)

            return setup, apply
        if pcvel == "q1sep":
            return (lambda lin_state: self._q1_fastdiag(lin_state[0].dtype),
                    lambda fd, r: self.mask_v(fd.apply(r)))
        if pcvel == "probed":
            from spectral_tpu_torch.models.stokes_pc import colored_probe_stencil_full

            def setup(lin_state):
                S = colored_probe_stencil_full(lambda w: self.vv_action(lin_state, w),
                                               self.grid, self.vel_mask,
                                               dtype=lin_state[0].dtype)
                diag = S.diag()
                return S, torch.where(diag == 0, 1.0, diag)

            def apply(state, r):
                S, diag = state
                z = torch.zeros_like(r)
                for _ in range(4):   # damped Jacobi on the probed matrix
                    z = z + 0.7 * (r - S.apply(z)) / diag
                return self.mask_v(z)

            return setup, apply
        if pcvel == "probed1":
            from spectral_tpu_torch.models.stokes_pc import colored_probe_stencil

            def setup(lin_state):
                def mv(x, c):
                    w = torch.zeros(self.grid.dims + (self.d,), dtype=x.dtype, device=x.device)
                    w[..., c] = x
                    return self.vv_action(lin_state, w)[..., c]

                return [colored_probe_stencil(lambda x, c=c: mv(x, c), self.grid,
                                              dtype=lin_state[0].dtype)
                        for c in range(self.d)]

            def apply(stencils, r):
                z = torch.zeros_like(r)
                for c, S in enumerate(stencils):
                    zc = torch.zeros_like(r[..., c])
                    for _ in range(4):   # damped Jacobi on the probed stencil
                        zc = zc + 0.7 * (r[..., c] - S.apply(zc)) / S.diag()
                    z[..., c] = zc
                return self.mask_v(z)

            return setup, apply
        raise ValueError(f"unknown pcvel {pcvel!r}")

    def make_pc(self, adjoint: bool = False, batched: bool = False):
        """(pc_setup, pc_apply) of the saddle-point preconditioner: saddle
        type 0 full block LU, 1 upper, 2 block diagonal, 3 lower
        triangular (stokes.C:1710-1817), each with the nested ``-vel_``
        solves and the ``-schur_`` solve of S = -PV VV^-1 VP.

        ``adjoint=True`` preconditions the transposed saddle system J^T
        (adjoint_gradient): every linear block becomes its exact transpose,
        a ``torch.func.vjp`` of the block's action (``jax.linear_transpose``
        in the JAX package): VV^T in the nested velocity solves, PV^T as
        the gradient block and VP^T as the divergence block (J^T's
        off-diagonal roles swap).  VV^T is built once a linearization, in
        ``pc_setup``, and reused by every nested solve; the velocity sub-PC
        and the 1/eta Schur diagonal are reused as they are ((near-)
        symmetric).

        ``batched=True`` is the same tree over a batch of linearizations (a
        family, or B right-hand sides of one operator): its loop-free blocks
        (the VV action, gradient, divergence, the velocity sub-PC apply, the
        pressure projection) mapped over the batch by ``torch.func.vmap``,
        so a derivative launches K1 once for the batch, the masks and the
        1/eta Schur Jacobi applied to the batched tensors directly, and
        every nested solve a ``KSPConfig.solve_batched``; pc_setup(x_b,
        lin_b) takes the batched linearization states."""
        from spectral_tpu_torch.solvers.adjoint import transpose_op
        from spectral_tpu_torch.solvers.batching import batch_map

        cfg = self.config
        if self.mesh is not None and (adjoint or batched):
            raise _todo("the adjoint or batched PC tree of a problem on a mesh", "item 7d")
        if cfg.saddle not in (0, 1, 2, 3):
            raise ValueError(f"pc_saddle_type {cfg.saddle} not implemented")
        if adjoint and batched:
            raise ValueError("make_pc: the adjoint PC has no batched form")
        if batched:   # (one solve, one loop-free block) of a family
            vel_setup, vel_apply = self._vel_pc_batched()

            def solve(ksp, A, b, **kw):
                return ksp.solve_batched(A, b, batched=True, **kw).x

            lift = batch_map
        else:
            vel_setup, vel_apply = self.make_vel_pc()

            def solve(ksp, A, b, **kw):
                return ksp.solve(A, b, reduce=self._reduce, **kw).x

            def lift(f):
                return f
        vv, project = lift(self.vv_action), lift(self.project_p)
        grad_op = lift(self.pressure_gradient)
        div_op = lift(lambda v: self.divergence(v, with_dirichlet=False))

        def vel_solve(state, rv, ksp):
            lin_state, vstate, (vv_op, _, _) = state
            return solve(ksp, vv_op, rv, M=lambda r: vel_apply(vstate, r))

        def schur_solve(state, rp):
            eta = state[0][0]
            _, _, (_, grad_op, div_op) = state

            def schur_action(wp):   # S = -PV VV^{-1} VP with the -svel_ solve
                return -div_op(vel_solve(state, grad_op(wp), cfg.svel_ksp))

            # Jacobi PC with diag = 1/eta (StokesMatGetDiagonalSchur,
            # stokes.C:538-553): the apply multiplies by eta
            return solve(cfg.schur_ksp, schur_action, rp, M=lambda r: self.mask_p(r * eta),
                         null_project=project)

        def pc_setup(x, lin_state):
            if adjoint:
                ops = (transpose_op(lambda w: self.vv_action(lin_state, w),
                                    self.zero_state(lin_state[0].dtype)["v"]),
                       *self._adjoint_blocks(lin_state[0].dtype))
            else:
                ops = (lambda w: vv(lin_state, w), grad_op, div_op)
            return (lin_state, vel_setup(lin_state), ops)

        def pc_apply(state, r):
            rv, rp = r["v"], r["p"]
            _, _, (_, grad_op, div_op) = state
            if cfg.saddle == 0:    # full block LU (stokes.C:1710-1741)
                v1 = vel_solve(state, rv, cfg.vel_ksp)
                p1 = schur_solve(state, rp - div_op(v1))
                v2 = vel_solve(state, -grad_op(p1), cfg.vel_ksp)
                return {"v": v1 + v2, "p": p1}
            if cfg.saddle == 1:    # upper triangular (stokes.C:1743-1767)
                p1 = schur_solve(state, rp)
                return {"v": vel_solve(state, rv - grad_op(p1), cfg.vel_ksp), "p": p1}
            if cfg.saddle == 2:    # block diagonal (stokes.C:1769-1791)
                return {"v": vel_solve(state, rv, cfg.vel_ksp), "p": schur_solve(state, rp)}
            v1 = vel_solve(state, rv, cfg.vel_ksp)   # 3: lower (stokes.C:1793-1817)
            return {"v": v1, "p": schur_solve(state, rp - div_op(v1))}

        return pc_setup, pc_apply

    def _adjoint_blocks(self, dtype: torch.dtype):
        """(PV^T, VP^T) for the adjoint PC in ``dtype``: the transposed
        divergence (a velocity from a pressure) and the transposed
        pressure gradient (a pressure from a velocity).  They do not depend
        on the linearization, so they are built once a dtype."""
        from spectral_tpu_torch.solvers.adjoint import transpose_op

        ops = self._adjoint_ops.get(dtype)
        if ops is None:
            zero = self.zero_state(dtype)
            ops = self._adjoint_ops[dtype] = (
                transpose_op(lambda v: self.divergence(v, with_dirichlet=False), zero["v"]),
                transpose_op(self.pressure_gradient, zero["p"]))
        return ops

    def _dense_free_and_nulls(self):
        """(free, null vectors) of the flat saddle state in ``_ravel``'s
        order, p then v: the free dofs (bool) and, with the pressure null
        space, its constant mode on the pressure dofs."""
        free = np.concatenate([self.p_mask_np.reshape(-1), self.vel_mask_np.reshape(-1)])
        nulls = []
        if self.has_p_null:
            nulls.append(np.concatenate([self.p_mask_np.reshape(-1).astype(np.float64),
                                         np.zeros(self.vel_mask_np.size)]))
        return free, nulls

    def make_dense_pc(self, params=None, x=None, *, block: int = 1024,
                      factor: str = "host", lin_state=None):
        """The exact inverse of the full saddle Jacobian at a frozen
        linearization: the ``-pc_type lu`` role that the reference's
        matrix-free shell operator cannot offer.  The Jacobian is assembled
        on the grid's device in the linearization's dtype (ops/dense.py,
        K1 under ``torch.func.vmap`` on the pressure's last axis), then
        inverted with the fixed dofs decoupled and the constant-pressure
        mode shifted out: ``factor="host"`` in float64 numpy,
        ``"device"`` with ``torch.linalg.inv`` in working precision.  Each
        apply is one ``torch.matmul``.

        The linearization is ``lin_state`` if given (UnsteadyStokes
        freezes its own), else the residual's at ``x`` (default: the zero
        state) under ``params`` (default: the final continuation step).
        Returns ``(pc_setup, pc_apply, pc_apply_adjoint)``: the first two
        match ``make_pc``'s interface, the third applies Ainv^T (the
        preconditioner of the transposed saddle system)."""
        from spectral_tpu_torch.ops.dense import (assemble_dense, assemble_dense_device,
                                                  dense_apply, regularized_inverse,
                                                  regularized_inverse_device)

        if factor not in ("host", "device"):
            raise ValueError(f"unknown factor {factor!r}")
        if self.mesh is not None:
            raise _todo("the dense tier on a mesh", "item 7d")
        if lin_state is None:
            params = self.params_at(self.config.cont) if params is None else params
            _, lin_state = self.make_residual(params)(self.zero_state() if x is None else x)
        free, nulls = self._dense_free_and_nulls()
        example = self.zero_state(lin_state[0].dtype)

        def op(w):
            return self.jacobian_action(None, lin_state, w)

        if factor == "device":
            A, unravel = assemble_dense_device(op, example, block=block)
            Ainv = regularized_inverse_device(A, free=free, null_vecs=nulls)
        else:
            A, unravel = assemble_dense(op, example, block=block)
            Ainv = regularized_inverse(A, free=free, null_vecs=nulls)
        del A
        fwd = dense_apply(Ainv, unravel)
        adj = dense_apply(Ainv, unravel, transpose=True)
        return (lambda x, lin_state: None, lambda state, r: fwd(r),
                lambda state, r: adj(r))

    def make_dense_pc_var(self, *, block: int = 512):
        """The dense exact saddle inverse for variable-coefficient
        operators: ``pc_setup(x, lin_state)`` assembles the Jacobian at
        ``lin_state`` and inverts it on its device in its dtype, returning
        the inverse as the PC state, so the caller sets the refresh cadence
        by where it calls setup (the ``-pc_lag`` discipline on the
        ``-pc_type lu`` tier).  Each apply is one ``torch.matmul``.
        Returns (pc_setup, pc_apply, pc_apply_adjoint)."""
        from spectral_tpu_torch.ops.dense import (assemble_dense_device, dense_apply,
                                                  regularized_inverse_device)
        from spectral_tpu_torch.solvers.krylov import _ravel

        if self.mesh is not None:
            raise _todo("the dense tier on a mesh", "item 7d")
        free, nulls = self._dense_free_and_nulls()
        _, unravel = _ravel(self.zero_state(), self.grid.dtype)

        def pc_setup(x, lin_state):
            A, _ = assemble_dense_device(lambda w: self.jacobian_action(None, lin_state, w),
                                         self.zero_state(lin_state[0].dtype), block=block)
            return regularized_inverse_device(A, free=free, null_vecs=nulls)

        return (pc_setup, lambda Ainv, r: dense_apply(Ainv, unravel)(r),
                lambda Ainv, r: dense_apply(Ainv, unravel, transpose=True)(r))

    # ------------------------------------------------------------------
    # Drivers (main, stokes.C:119-253)
    # ------------------------------------------------------------------
    def zero_state(self, dtype: torch.dtype | None = None) -> dict:
        """The zero state (this process' slab on a mesh)."""
        dt = dtype or self.grid.dtype
        dev = self.grid.device
        dims = self.p_mask.shape
        return {"v": torch.zeros(dims + (self.d,), dtype=dt, device=dev),
                "p": torch.zeros(dims, dtype=dt, device=dev)}

    def exact_state(self, dtype: torch.dtype | None = None) -> dict:
        dt = dtype or self.grid.dtype
        return {"v": self._c("exact_v", dt), "p": self._c("exact_p", dt)}

    def params_at(self, i: int) -> PowerLawParams:
        """Continuation schedule (stokes.C:218-219), Python floats."""
        cfg = self.config
        if cfg.cont <= 0:
            return PowerLawParams(cfg.hardness, cfg.exponent, cfg.regularization, cfg.gamma0)
        t = i / cfg.cont
        exponent = 1.0 + t**0.8 * (cfg.exponent - 1.0)
        reg = math.exp(math.log(cfg.regularization) * t) if cfg.regularization > 0 else 0.0
        return PowerLawParams(cfg.hardness, exponent, reg, cfg.gamma0)

    @staticmethod
    def _dtype_ksp(ksp: KSPConfig, dtype: torch.dtype) -> KSPConfig:
        """Clamp a KSP rtol to 50 eps of the state's dtype: a float32 Krylov
        solve chasing rtol 1e-10 drags below its round-off floor with no
        gain when a float64 refinement follows.  Float64 is untouched."""
        floor = 50.0 * float(torch.finfo(dtype).eps)
        if ksp.rtol >= floor:
            return ksp
        return dataclasses.replace(ksp, rtol=floor)

    def solve(self, x0: dict | None = None, params: Optional[PowerLawParams] = None,
              monitor: bool = False, clamp_f32: bool = False,
              recycle_U0=None, fused: bool = False) -> NewtonResult:
        """One SNES solve at fixed rheology parameters, in x0's dtype
        (default: the grid's).  ``clamp_f32`` clamps the outer rtol to the
        dtype's floor, right only when a refinement stage follows.
        ``fused`` takes make_fused_newton's rules: the stopping test and
        the forcing in the state's dtype, no monitor.  With
        ``config.newton.recycle``, ``recycle_U0`` seeds the first linear
        solve's deflation space and the result's ``recycle_U`` carries the
        last harvest on (solve_continuation threads it)."""
        cfg = self.config
        if cfg.mass_shift:
            raise ValueError(_MASS_SHIFT_STEADY)
        if fused and cfg.newton.recycle > 0:
            raise ValueError("Krylov recycling is host-loop-only (newton_solve)")
        params = params or self.params_at(cfg.cont)
        residual_raw = self.make_residual(params, monitor_eta=monitor)

        def residual(x):
            # the constant-pressure mode leaves every residual (KSPSetNullSpace
            # removes it from every right-hand side, stokes.C:1006-1025)
            F, lin_state = residual_raw(x)
            return {"v": F["v"], "p": self.project_p(F["p"])}, lin_state

        pc_setup, pc_apply = self.make_pc()
        x0 = x0 if x0 is not None else self.zero_state()
        ksp = self._dtype_ksp(cfg.outer_ksp, x0["p"].dtype) if clamp_f32 else cfg.outer_ksp
        return newton_solve(residual, x0, jacobian_action=self.jacobian_action,
                            pc_setup=pc_setup, pc_apply=pc_apply, ksp=ksp,
                            config=dataclasses.replace(cfg.newton, monitor=monitor and not fused),
                            null_project=self.null_project,
                            control_dtype=x0["p"].dtype if fused else None,
                            recycle_U0=recycle_U0, reduce=self._reduce)

    def _vel_pc_batched(self):
        """(setup, apply) of the velocity sub-PC over a batch: the fastdiag
        and separable-Q1 solves do not depend on the linearization, so one
        state serves every member (fastdiag takes the batch as a trailing
        axis of its tensor solve; q1sep maps its apply over the batch);
        the multigrid, nodal and Jacobi setups are mapped member by member
        (``torch.func.vmap``, batched stencils and coarse LUs), and so are
        their applies.  The Q1 FEM and probed PCs, and any PC with the
        mixed/Neumann line and traction-block corrections (whose per-member
        state holds line solvers and dense factors), set up and apply member
        by member."""
        from spectral_tpu_torch.solvers.batching import batch_map, member

        pcvel = self.config.pcvel
        setup, apply = self.make_vel_pc()
        if self.num_mixed or pcvel in ("q1fem", "probed", "probed1"):
            def setup_members(lin_b):
                return [setup(member(lin_b, b)) for b in range(lin_b[0].shape[0])]

            def apply_members(states, r):
                return torch.stack([apply(st, r[b]) for b, st in enumerate(states)])

            return setup_members, apply_members
        if pcvel == "fastdiag":
            # the batch rides as one more trailing axis of the tensor solve
            return (lambda lin_b: setup(member(lin_b, 0)),
                    lambda fd, r: self.mask_v(torch.movedim(
                        fd.apply(torch.movedim(r, 0, -1)), -1, 0)))
        if pcvel == "q1sep":
            return (lambda lin_b: setup(member(lin_b, 0)),
                    batch_map(apply, in_dims=(None, 0)))
        if pcvel in ("mg", "nodal", "jacobi"):
            return batch_map(setup), batch_map(apply)
        raise ValueError(f"unknown pcvel {pcvel!r}")

    def family_params(self, params_list, dtype: torch.dtype | None = None) -> PowerLawParams:
        """A family's PowerLawParams as (B,) tensors on the grid's device."""
        dt = dtype or self.grid.dtype
        return PowerLawParams(*[
            torch.tensor([float(getattr(p, f.name)) for p in params_list], dtype=dt,
                         device=self.grid.device)
            for f in dataclasses.fields(PowerLawParams)])

    def solve_family(self, params_list, x0=None, monitor: bool = False,
                     x0_batched: bool = False, *, mesh=None, mesh_axis: str = "x"):
        """Solve a parameter family of Stokes problems at once: one batched
        Newton loop (``newton_solve_family``) drives every member, each
        Krylov step applying the operator and the nested PC to the B
        states together (``make_pc(batched=True)``).

        Args:
          params_list: a sequence of PowerLawParams (the family).
          x0: one state (broadcast) or, with ``x0_batched``, a batch.
        Returns a NewtonFamilyResult (leading axis = member).  Each member
        takes the Newton and Krylov counts of its own ``solve``.

        ``mesh`` cuts the family over mesh axis ``mesh_axis`` (a dp axis:
        each process solves its B / P members, every process gets the
        whole result, the per-step histories padded as the unsharded loop
        pads a finished member); the problem itself is a one-process one."""
        cfg = self.config
        if cfg.mass_shift:
            raise ValueError(_MASS_SHIFT_STEADY)
        if mesh is not None and mesh.size(mesh_axis) > 1:
            return self._solve_family_dp(params_list, x0, monitor, x0_batched, mesh,
                                         mesh_axis)
        from spectral_tpu_torch.solvers.batching import batch_map
        from spectral_tpu_torch.solvers.newton import newton_solve_family

        x0 = x0 if x0 is not None else self.zero_state()
        dt = x0["p"].dtype

        def residual(x, theta):
            F, lin_state = self.make_residual(theta)(x)
            return {"v": F["v"], "p": self.project_p(F["p"])}, lin_state

        pc_setup, pc_apply = self.make_pc(batched=True)
        return newton_solve_family(
            batch_map(residual), x0, self.family_params(params_list, dt),
            jacobian_action=batch_map(self.jacobian_action),
            pc_setup=pc_setup, pc_apply=pc_apply, ksp=cfg.outer_ksp,
            config=dataclasses.replace(cfg.newton, monitor=monitor),
            null_project=batch_map(self.null_project), x0_batched=x0_batched,
            batched=True)

    def _solve_family_dp(self, params_list, x0, monitor, x0_batched, mesh, mesh_axis):
        """``solve_family`` with the family cut over a mesh axis."""
        import torch.utils._pytree as pytree

        from spectral_tpu_torch.solvers.batching import dp_cut, dp_gather
        from spectral_tpu_torch.solvers.newton import NewtonFamilyResult

        sl = dp_cut(len(params_list), mesh, mesh_axis)
        if x0 is not None and x0_batched:
            x0 = pytree.tree_map(lambda a: a[sl], x0)
        r = self.solve_family(list(params_list)[sl], x0, monitor, x0_batched)
        # the loop ran until this block's last member finished: pad the
        # step histories to the longest block (norms held, no iterations)
        n = int(dp_gather(torch.tensor([len(r.fnorm_history)]), mesh, mesh_axis).max())
        fh = np.concatenate([r.fnorm_history] + [r.fnorm_history[-1:]] *
                            (n - len(r.fnorm_history)))
        kh = np.concatenate([r.ksp_iters, np.zeros((n - 1 - len(r.ksp_iters),
                                                    r.ksp_iters.shape[1]), np.int64)])
        return NewtonFamilyResult(
            x=pytree.tree_map(lambda a: dp_gather(a, mesh, mesh_axis), r.x),
            iters=dp_gather(r.iters, mesh, mesh_axis),
            reason=dp_gather(r.reason, mesh, mesh_axis),
            fnorm=dp_gather(r.fnorm, mesh, mesh_axis),
            fnorm_history=dp_gather(fh, mesh, mesh_axis, axis=1),
            ksp_iters=dp_gather(kh, mesh, mesh_axis, axis=1))

    def solve_continuation(self, monitor: bool = False, checkpoint_dir: str | None = None,
                           clamp_f32: bool = False, dtype: torch.dtype | None = None,
                           fused: bool = False) -> list[NewtonResult]:
        """The continuation loop (stokes.C:217-235): ramp exponent and
        regularization, each solution the next initial guess, in ``dtype``
        (default: the grid's).  ``fused`` is solve_continuation_fused's
        loop: each solve by make_fused_newton's rules, the outer rtol
        clamped, no secant predictor.  With ``config.newton.recycle``, each
        step's harvested Krylov subspace seeds the next step's solve.

        With ``checkpoint_dir`` (``utils/checkpoint.py``), each step's
        solution is saved with its parameters, fnorm and reason, and the
        loop resumes after the last step saved there: a run on a complete
        directory solves nothing and returns []."""
        from spectral_tpu_torch.utils import checkpoint as ckpt

        if checkpoint_dir is not None and self.mesh is not None:
            raise _todo("solve_continuation(checkpoint_dir=...) on a mesh", "item 7d")
        cfg = self.config
        results = []
        x = self.zero_state(dtype)
        x_prev = None      # previous step's solution (secant predictor)
        exp_prev = None    # its exponent (continuation parameter)
        recycle_U = None   # the Krylov subspace threaded across the steps
        start = cfg.cont0
        if checkpoint_dir is not None:
            last = ckpt.latest_step(checkpoint_dir)
            if last is not None and last >= cfg.cont0:
                x = ckpt.load_state(checkpoint_dir, last, x)
                start = last + 1
                if monitor:
                    print(f"## resuming continuation from step {last}")
        for i in range(start, cfg.cont + 1):
            p = self.params_at(i)
            if monitor:
                print(f"## [{i}/{cfg.cont}] Solving with exponent = {p.exponent:5f} "
                      f"regularization {p.regularization:8.2e}")
            x_start = x
            if cfg.cont_predictor == "secant" and x_prev is not None and not fused:
                # extrapolate the warm start through the last two solutions,
                # x + theta (x - x_prev), used only if its residual is smaller
                de_new = p.exponent - (exp_prev if exp_prev is not None else 0.0)
                de_old = exp_prev - self.params_at(i - 2).exponent if i >= 2 else 0.0
                theta = de_new / de_old if abs(de_old) > 1e-12 else 1.0
                theta = min(max(theta, 0.0), 2.0)
                x_pred = {k: x[k] + theta * (x[k] - x_prev[k]) for k in x}
                rfn = self.make_residual(p)
                fn_plain = float(_norm(rfn(x)[0], self._reduce))
                fn_pred = float(_norm(rfn(x_pred)[0], self._reduce))
                if fn_pred < fn_plain:
                    x_start = x_pred
                if monitor:
                    print(f"##   predictor theta={theta:.3f} "
                          f"fnorm plain {fn_plain:.3e} secant {fn_pred:.3e} "
                          f"-> {'secant' if fn_pred < fn_plain else 'plain'}")
            res = self.solve(x_start, params=p, monitor=monitor,
                             clamp_f32=clamp_f32 or fused, recycle_U0=recycle_U, fused=fused)
            x_prev, exp_prev = x, p.exponent
            x, recycle_U = res.x, res.recycle_U
            results.append(res)
            if checkpoint_dir is not None:
                ckpt.save_state(checkpoint_dir, i, x,
                                meta={"exponent": p.exponent,
                                      "regularization": p.regularization,
                                      "fnorm": float(res.fnorm), "reason": int(res.reason)})
        return results

    def solve_continuation_fused(self, dtype: torch.dtype | None = None) -> list[NewtonResult]:
        """The JAX package's fused continuation, in ``dtype`` (default: the
        grid's): the schedule params_at(cont0..cont), each step warm-started
        from the previous one, each Newton solve by make_fused_newton's
        rules with the outer rtol clamped to the state's dtype (_dtype_ksp:
        float32 stops at 50 eps, float64 is untouched), no secant predictor,
        no checkpointing.  One NewtonResult a step, ``x`` only on the last.
        The JAX package compiles each step into one dispatch; here the
        host loop issues the same kernels and reads its stopping scalars."""
        results = self.solve_continuation(dtype=dtype, fused=True)
        for r in results[:-1]:
            r.x = None
        return results

    # ------------------------------------------------------------------
    # Mixed precision: float64 residuals + defect-correction solves
    # ------------------------------------------------------------------
    def make_residual_dev64(self, params: PowerLawParams):
        """The float64 Stokes residual on the grid's device: x -> F for a
        float64 state.  make_residual's algorithm on the float64 masters
        that make_residual_np reads (``_c`` casts them once per dtype), so
        no float32 copy enters; the float64 side of solve_refined_fused."""
        residual = self.make_residual(params)

        def residual64(x: dict) -> dict:
            if x["v"].dtype != torch.float64 or x["p"].dtype != torch.float64:
                raise TypeError(f"make_residual_dev64 takes a float64 state, "
                                f"got {x['v'].dtype} and {x['p'].dtype}")
            return residual(x)[0]

        return residual64

    def make_residual_np(self, params: PowerLawParams):
        """Host float64 Stokes residual (numpy transforms), mirroring
        make_residual; the high-precision side of solve_refined."""
        g, d, cfg = self.grid, self.d, self.config
        apply_w = g.apply_dif_weight_np
        vel_mask, p_mask = self.vel_mask_np, self.p_mask_np
        dmask, nm, mixed = self.dirichlet_mask_np, self.nm_mask_np, self.mixed_mask_np
        neumann = self.neumann_mask_np
        normal, onehot = self.normal_np, self.in_onehot_np
        alpha, bc_vel, bc_vnormal = self.alpha_np, self.bc_vel_np, self.bc_vnormal_np
        force_v, force_p = self.force_np["v"], self.force_np["p"]
        Jinv = None if self.cmap is None else self.cmap.Jinv
        CT = None if self.cmap is None else self.cmap.cofactor
        detJ = None if self.cmap is None else self.cmap.detJ
        E_T = [_reduce_matrix_np(tuple(float(v) for v in g.nodes_1d[ax])).T
               for ax in range(d)]

        def rheology_hi(gamma):
            if cfg.rheology in (0, "linear"):
                return np.ones_like(gamma), np.zeros_like(gamma)
            n = params.exponent
            p = (1.0 - n) / (2.0 * n)
            base = params.regularization + gamma / params.gamma0
            eta = params.hardness * base**p
            deta = (params.hardness * p / params.gamma0 * base ** (p - 1.0)
                    if abs(n) > 1e-5 else np.zeros_like(gamma))
            return eta, deta

        def reduce_order(p):
            for ax in reversed(range(d)):
                p = np.moveaxis(np.moveaxis(p, ax, -1) @ E_T[ax], -1, ax)
            return p

        def recover(v):
            # residual path: inhomogeneous flux v.n = bc_vnormal (boundary 5)
            if self.num_mixed == 0:
                return v
            v_excl = v * (1.0 - onehot)
            num = np.sum(v_excl * normal, axis=-1, keepdims=True)
            num = num - bc_vnormal[..., None]
            n_in = np.sum(normal * onehot, axis=-1, keepdims=True)
            vin = -num / np.where(np.abs(n_in) > 1e-14, n_in, 1.0)
            return np.where(mixed[..., None], v_excl + onehot * vin, v)

        def residual(x):
            vL = recover(np.where(vel_mask, x["v"], 0.0))
            vL = np.where(dmask[..., None], bc_vel, vL)
            G = np.stack([apply_w(chebdiff_np(vL, j), j) for j in range(d)], axis=-2)
            if Jinv is not None:
                G = np.einsum("...lj,...lk->...jk", Jinv, G)
            S = 0.5 * (G + np.swapaxes(G, -1, -2))
            gamma = 0.5 * np.sum(S * S, axis=(-1, -2))
            eta, deta = rheology_hi(gamma)
            flux = eta[..., None, None] * S
            tflux = flux if CT is None else np.einsum("...lj,...jk->...lk", CT, flux)
            yv = np.zeros_like(vL)
            for j in range(d):
                yv = yv - apply_w(chebdiff_np(tflux[..., j, :], j), j)
            if detJ is not None:
                yv = yv / detJ[..., None]
            if self.num_mixed:
                traction = np.einsum("...jk,...k->...j", flux, normal)
                load = cfg.scaleN * traction + alpha[..., None] * vL
                rows = cfg.scaleM * load
                if self.mixed_tang:
                    tang = load - np.sum(load * normal, axis=-1, keepdims=True) * normal
                    rows = np.where(mixed[..., None], cfg.scaleM * tang, rows)
                yv = np.where(nm[..., None], rows, yv)
            pL = reduce_order(np.where(p_mask, x["p"], 0.0))
            gp = np.stack([apply_w(chebdiff_np(pL, i), i) for i in range(d)], axis=-1)
            if Jinv is not None:
                gp = np.einsum("...li,...l->...i", Jinv, gp)
            gp = np.where(nm[..., None], 0.0, gp)
            if cfg.traction_p and self.num_neumann > 0:
                rows = cfg.scaleM * cfg.scaleN * (-pL[..., None] * normal)
                gp = np.where(neumann[..., None], rows, gp)
            Fv = np.where(vel_mask, yv + gp, 0.0) - force_v
            w = vL if CT is None else np.einsum("...li,...i->...l", CT, vL)
            div = np.zeros(g.dims, np.float64)
            for i in range(d):
                div = div + apply_w(chebdiff_np(w[..., i], i), i)
            if detJ is not None:
                div = div / detJ
            Fp = np.where(p_mask, div, 0.0) - force_p
            return {"v": Fv, "p": Fp}

        return residual

    def _refine(self, x: dict, residual64: Callable, *, rtol: float, max_refine: int):
        """Defect correction, x -= J32^-1 F64(x), until ||F64|| <= rtol ||f||
        or max_refine steps: each step a float32 saddle-preconditioned
        Krylov solve about the float32 copy of x (the PC rebuilt there).
        x is a float64 state of numpy arrays or of tensors on the grid's
        device, and residual64 maps it to its projected residual of the
        same kind; the host reads one norm a step.  Returns (x, info)."""
        cfg = self.config
        f32, f64 = torch.float32, torch.float64
        on_host = isinstance(x["v"], np.ndarray)
        residual_lo = self.make_residual(self.params_at(cfg.cont))
        pc_setup, pc_apply = self.make_pc()
        ksp32 = self._dtype_ksp(cfg.outer_ksp, f32)

        def to32(t):
            return {k: torch.as_tensor(a, dtype=f32, device=self.grid.device)
                    for k, a in t.items()}

        def tnorm(t):
            if on_host:
                return float(np.sqrt(sum(np.vdot(v, v).real for v in t.values())))
            return float(_norm(t))

        bnorm = max(float(np.sqrt(sum(np.vdot(v, v).real for v in self.force_np.values()))),
                    1e-300)
        r = residual64(x)
        hist, inner = [tnorm(r)], 0
        while len(hist) <= max_refine and hist[-1] > rtol * bnorm and np.isfinite(hist[-1]):
            x32 = to32(x)
            _, lin_state = residual_lo(x32)
            pc_state = pc_setup(x32, lin_state)
            out = ksp32.solve(lambda w: self.jacobian_action(x32, lin_state, w), to32(r),
                              M=lambda z: pc_apply(pc_state, z), null_project=self.null_project)
            if out.x["v"].dtype != f32 or out.x["p"].dtype != f32:
                raise TypeError("the inner solve must stay float32")
            inner += int(out.iters)
            x = {k: x[k] - (out.x[k].cpu().numpy().astype(np.float64) if on_host
                            else out.x[k].to(f64)) for k in x}
            r = residual64(x)
            hist.append(tnorm(r))
        return x, {"refine_history": hist, "refine_steps": len(hist) - 1,
                   "refine_inner_iters": inner, "rel_residual": hist[-1] / bnorm}

    def solve_refined(self, *, rtol: float = 1e-10, max_refine: int = 10,
                      monitor: bool = False):
        """Defect-correction Stokes solve: the continuation and Newton in
        float32 on the grid's device (outer rtol clamped to the float32
        floor), then _refine with float64 host residuals.  Returns
        (x float64 numpy dict, info)."""
        results = self.solve_continuation(monitor=monitor, clamp_f32=True, dtype=torch.float32)
        x = {k: v.cpu().numpy().astype(np.float64) for k, v in results[-1].x.items()}
        residual_hi = self.make_residual_np(self.params_at(self.config.cont))
        p_mask = self.p_mask_np
        count = float(self.grid.num_interior)

        def residual64(t):
            F = residual_hi(t)
            p = np.where(p_mask, F["p"], 0.0)
            if self.has_p_null:
                p = p - np.where(p_mask, p.sum() / count, 0.0)
            return {"v": F["v"], "p": p}

        x, info = self._refine(x, residual64, rtol=rtol, max_refine=max_refine)
        return x, {"continuation": results, **info}

    def solve_refined_fused(self, *, rtol: float = 1e-10, max_refine: int = 10,
                            monitor: bool = False, fused_continuation: bool = False):
        """solve_refined with the state on the grid's device: float64
        residuals there (make_residual_dev64) and float64 updates, so only
        the residual norm comes to the host, once a refine step.  Linear
        rheology starts from zero (the first pass is the float32 solve);
        the power law runs the float32 continuation first, by the host loop
        or, with ``fused_continuation``, solve_continuation_fused.  Returns
        (x float64 numpy dict, info) with solve_refined's info keys."""
        cfg = self.config
        f32, f64 = torch.float32, torch.float64
        results = []
        if cfg.rheology not in (0, "linear"):
            results = (self.solve_continuation_fused(dtype=f32) if fused_continuation
                       else self.solve_continuation(monitor=monitor, clamp_f32=True,
                                                    dtype=f32))
        residual_hi = self.make_residual_dev64(self.params_at(cfg.cont))

        def residual64(t):   # -traction_p pins the constant: p is only masked
            F = residual_hi(t)
            return {"v": F["v"], "p": self.project_p(F["p"])}

        x = ({k: v.to(f64) for k, v in results[-1].x.items()} if results
             else self.zero_state(f64))
        x, info = self._refine(x, residual64, rtol=rtol, max_refine=max_refine)
        return {k: v.cpu().numpy() for k, v in x.items()}, {"continuation": results, **info}

    # ------------------------------------------------------------------
    # Adjoint sensitivities (solvers/adjoint.py; no reference analog)
    # ------------------------------------------------------------------
    def adjoint_gradient(self, qoi, x_star: dict, theta, *, residual_fn=None,
                         ksp: KSPConfig | None = None):
        """d/dtheta qoi(x*(theta), theta) at the converged state x*, with
        the adjoint saddle system preconditioned by the nested Schur PC of
        the forward solve transposed (``make_pc(adjoint=True)``, built at
        x*; FGMRES takes it on the transposed operator).

        ``theta`` defaults to ``PowerLawParams`` (floats or 0-d tensors)
        consumed by ``residual_fn(x, theta)`` = the null-projected
        make_residual(theta); pass a custom residual_fn for other
        parameterizations.  Returns (grad_theta, adjoint SolveResult)."""
        from spectral_tpu_torch.solvers.adjoint import implicit_gradient

        if residual_fn is None:
            def residual_fn(xG, th):
                F, _ = self.make_residual(th)(xG)
                return {"v": F["v"], "p": self.project_p(F["p"])}

        with torch.no_grad():   # the linearization is the PC's, not differentiated
            _, lin_state = self.make_residual(
                theta if isinstance(theta, PowerLawParams)
                else self.params_at(self.config.cont))(x_star)
        pc_setup, pc_apply = self.make_pc(adjoint=True)
        pc_state = pc_setup(x_star, lin_state)
        ksp = ksp or dataclasses.replace(self.config.outer_ksp, max_it=400)
        return implicit_gradient(residual_fn, qoi, x_star, theta, ksp=ksp,
                                 M=lambda r: pc_apply(pc_state, r),
                                 null_project=self.null_project)

    def error_vs_exact(self, x: dict) -> float:
        """Max-norm error with the constant-pressure mode removed
        (stokes.C:222-228); x a state of tensors or of numpy arrays (taken
        in float64)."""
        x = {k: (v if isinstance(v, torch.Tensor)
                 else torch.as_tensor(np.asarray(v, np.float64), device=self.grid.device))
             for k, v in x.items()}
        dt = x["v"].dtype
        dv = x["v"] - self._c("exact_v", dt)
        dp = self.project_p(x["p"] - self._c("exact_p", dt))
        err = torch.stack([torch.max(torch.abs(dv)), torch.max(torch.abs(dp))])
        if self.mesh is not None:
            err = self.mesh.allmax(err)
        return float(torch.max(err))
