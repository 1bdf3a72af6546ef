"""Time-dependent diffusion on the CGL grid (a capability extension).

Counterpart of ``spectral_tpu/models/heat.py``: implicit theta-scheme time stepping (backward Euler / Crank-Nicolson) for

    u_t = Laplace(u) + f,   u|boundary = g (time-independent),

from the spectral Laplacian (``chebdiff``, K1 on the last axis of a CUDA
tensor), masked Dirichlet rows, a Krylov solve (CG by default) and a
shifted fast diagonalization as the exact preconditioner of the implicit
operator (1/dt + theta * (-Laplace)).  ``neumann_axes`` insulates both
faces of the listed axes (a zero-flux spectral row, preconditioned by the
Neumann-eliminated fast diagonalization).

The JAX package's ``rollout`` is one ``lax.scan``; here it is a host loop
over the same step.  The steps that take dt as an argument
(``step_theta_dt``, ``step_bdf2_dt``) are the substrate of
``solvers/ts.py``: the preconditioner is the shift-free fast
diagonalization applied with the run-time shift.  On a curved domain
(``phi=``, ``ops/curvilinear.py``) the Laplacian is in conservative metric
form, the step solve is GMRES (the metric operator is not symmetric) and
its preconditioner one V-cycle on the shifted separable metric stencil
(1/dt + theta * stencil), the hierarchy built once shift-free and shifted
at run time (``Multigrid.shift_state``).  ``step_diff`` is the step
differentiable in its inputs (an implicit adjoint solve, not autograd
through the Krylov loop).
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np
import torch

from spectral_tpu_torch.grid import Grid
from spectral_tpu_torch.ops.chebyshev import chebdiff
from spectral_tpu_torch.ops.fastdiag import FastDiagSolver
from spectral_tpu_torch.solvers.krylov import KSPConfig


@dataclasses.dataclass(frozen=True)
class HeatModel:
    """theta = 1: backward Euler; theta = 0.5: Crank-Nicolson.

    ``neumann_axes``: BOTH end faces of each listed axis carry the
    spectral outward-derivative row dT/dn = 0 instead of Dirichlet.  Nodes
    shared with a Dirichlet face keep the Dirichlet row; nodes shared by
    two insulated faces (3-D edges) keep an identity row.
    """

    grid: Grid
    dt: float
    theta: float = 0.5
    ksp: KSPConfig = KSPConfig(type="cg", rtol=1e-10, max_it=100)
    phi: object = None
    neumann_axes: tuple = ()
    # parallel.slab.Slab: the step on this process' slab (states, forcing
    # and Dirichlet data are slabs; the fastdiag PC through the pencil
    # exchange, its zero-flux folds along a sharded axis included)
    slab: object = None

    def __post_init__(self):
        if self.slab is not None and self.phi is not None:
            raise NotImplementedError("the curved heat step on a mesh is not ported yet "
                                      "(ROADMAP.md queue 1, item 7d)")
        if self.neumann_axes and len(self.neumann_axes) >= self.grid.ndim:
            raise ValueError("at least one axis must stay Dirichlet "
                             "(all-Neumann diffusion is singular)")
        if (self.cmap is not None or self.neumann_axes) and self.ksp.type == "cg":
            # the metric operator and the one-sided Neumann rows are
            # nonsymmetric: CG (the default) is invalid; GMRES with the
            # same tolerances
            object.__setattr__(self, "ksp", dataclasses.replace(self.ksp, type="gmres"))

    @cached_property
    def cmap(self):
        """The CurvilinearMap of ``phi`` (None without one)."""
        if self.phi is None:
            return None
        if self.grid.intervals is not None or self.grid.maps is not None:
            raise ValueError("curvilinear heat needs an unmapped Grid")
        from spectral_tpu_torch.ops.curvilinear import CurvilinearMap
        return CurvilinearMap.build(self.grid, self.phi)

    @cached_property
    def _bmask(self) -> torch.Tensor:
        """The boundary mask (this process' slab of it on a mesh)."""
        bm = self.grid.boundary_mask
        return bm if self.slab is None else self.slab.local(bm)

    @cached_property
    def _slab_dif(self):
        return self.slab.dif()

    def _dif(self, u: torch.Tensor, ax: int) -> torch.Tensor:
        """The first derivative along ``ax`` with its chain-rule weight."""
        if self.slab is None:
            return self.grid.apply_dif_weight(chebdiff(u, ax), ax)
        return self.slab.dif_weight(self.grid, self._slab_dif(u, ax), ax)

    def _zero_b(self, u: torch.Tensor) -> torch.Tensor:
        return torch.where(self._bmask, torch.zeros((), dtype=u.dtype, device=u.device), u)

    @property
    def _reduce(self):
        return None if self.slab is None else self.slab.allreduce

    def laplacian(self, u: torch.Tensor) -> torch.Tensor:
        """Spectral Laplacian with homogeneous rows at the boundary (the
        solution's boundary values are held by the Dirichlet data)."""
        g = self.grid
        if self.cmap is not None:
            return g.zero_boundary(self.cmap.laplacian(u))
        y = torch.zeros_like(u)
        for ax in range(g.ndim):
            y = y + self._dif(self._dif(u, ax), ax)
        return self._zero_b(y)

    @cached_property
    def _nm_masks(self):
        """({(axis, "lo"|"hi"): nodes EXCLUSIVE to that end face}, the
        any-Neumann-row mask), bool tensors on the grid's device."""
        g = self.grid
        face_count = np.zeros(g.dims, dtype=np.int32)
        for ax in range(g.ndim):
            sl0 = [slice(None)] * g.ndim
            sl1 = [slice(None)] * g.ndim
            sl0[ax], sl1[ax] = 0, -1
            face_count[tuple(sl0)] += 1
            face_count[tuple(sl1)] += 1
        masks = {}
        any_nm = np.zeros(g.dims, dtype=bool)
        for ax in self.neumann_axes:
            for end, lbl in ((0, "lo"), (-1, "hi")):
                m = np.zeros(g.dims, dtype=bool)
                sl = [slice(None)] * g.ndim
                sl[ax] = end
                m[tuple(sl)] = True
                m &= face_count == 1
                masks[(ax, lbl)] = torch.as_tensor(m, device=g.device)
                any_nm |= m
        any_nm = torch.as_tensor(any_nm, device=g.device)
        if self.slab is not None:
            masks = {k: self.slab.local(m) for k, m in masks.items()}
            any_nm = self.slab.local(any_nm)
        return masks, any_nm

    def _bc_rows(self, y: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """Overwrite the boundary rows of an interior result: identity
        Dirichlet rows; on insulated faces the outward spectral
        derivative (index 0 = +1, outward +ax; the last, -ax), on a curved
        domain the outward conormal flux sum_j A_{ax j} d_j u (the mapped
        face's physical normal flux)."""
        g = self.grid
        y = torch.where(self._bmask, u, y)
        if self.neumann_axes:
            masks, _ = self._nm_masks
            if self.cmap is not None:
                A = self.cmap.field("Acoef", u.dtype, u.device)
                grads = [chebdiff(u, j) for j in range(g.ndim)]
            for ax in self.neumann_axes:
                if self.cmap is None:
                    du = self._dif(u, ax)
                else:
                    du = sum(A[..., ax, j] * grads[j] for j in range(g.ndim))
                y = torch.where(masks[(ax, "lo")], du, y)
                y = torch.where(masks[(ax, "hi")], -du, y)
        return y

    def _implicit_op_c(self, u: torch.Tensor, shift, c: float) -> torch.Tensor:
        """shift*u - c*Laplace(u) on the interior, with the shared boundary
        rows (shift-free: Dirichlet identity / dT/dn)."""
        return self._bc_rows(shift * u - c * self.laplacian(u), u)

    def implicit_operator(self, u: torch.Tensor) -> torch.Tensor:
        """A = 1/dt - theta * Laplace on the interior; identity boundary
        rows, except insulated faces, which carry dT/dn."""
        return self._implicit_op_c(u, 1.0 / self.dt, self.theta)

    def _fastdiag(self, shift: float, c: float) -> FastDiagSolver:
        # the FD surrogate T_j approximates -(1/2) d^2/dx_j^2, so the
        # operator shift - c Laplace matches axis_scale 2c
        return FastDiagSolver.build(self.grid, shift=shift,
                                    axis_scale=np.full(self.grid.ndim, 2.0 * c),
                                    neumann_axes=tuple(self.neumann_axes))

    @cached_property
    def _pc_apply(self):
        if self.cmap is None:
            fd = self._fastdiag(1.0 / self.dt, self.theta)
            return lambda r: fd.apply(r, slab=self.slab)
        # the shift-free theta-scaled metric hierarchy, shifted by 1/dt: the
        # fixed-dt and the dt-argument steps solve the same surrogate
        mg, state0, folds = self._mgc_theta
        state = mg.shift_state(state0, 1.0 / self.dt)
        return lambda r: self._metric_pc_apply(mg, state, folds, r)

    # ------------------------------------------------------------------
    # Curved domains: the metric multigrid surrogate (shift-free
    # hierarchies; zero-flux faces eliminated as in ops/fastdiag.py)
    # ------------------------------------------------------------------
    def _curved_mg(self, c: float):
        """(mg, shift-free state, folds) of c * (-(1/detJ) d_l(A_ll d_l .))
        with the insulated faces' couplings eliminated into the adjacent
        centers on every level.  ``folds[ax]``: the 1-D end spacings and
        the c-scaled fold-coefficient fields of the finest level
        (``_metric_pc_apply``)."""
        from spectral_tpu_torch.ops.curvilinear import (metric_surrogate_builder,
                                                        metric_surrogate_folds)
        from spectral_tpu_torch.ops.multigrid import Multigrid

        nm = tuple(self.neumann_axes)
        base = metric_surrogate_builder(self.grid.ndim, nm)

        def builder(grid, coeffs):
            S = base(grid, coeffs)
            return dataclasses.replace(
                S, center=torch.where(grid.interior_mask, c * S.center, S.center),
                lower=tuple(c * lo for lo in S.lower), upper=tuple(c * up for up in S.upper))

        mg = Multigrid.build(self.grid, builder=builder)
        coeffs = self.cmap.pc_coeffs()
        folds = {ax: (h_lo, c * f_lo, h_hi, c * f_hi)
                 for ax, (h_lo, f_lo, h_hi, f_hi)
                 in metric_surrogate_folds(self.grid, coeffs, nm).items()}
        return mg, mg.setup(coeffs), folds

    @cached_property
    def _mgc_theta(self):
        return self._curved_mg(self.theta)

    @cached_property
    def _mgc_unit(self):
        return self._curved_mg(1.0)

    def _metric_pc_apply(self, mg, state, folds, r: torch.Tensor) -> torch.Tensor:
        """A V-cycle with zero-flux face elimination: the face residuals,
        scaled by h / A_ff, fold into the adjacent interior rows; after the
        solve the face values are reconstructed (u_face = u_adj + (h/A_ff)
        r_face), masks and rolls only, as FastDiagSolver.apply does."""
        if not folds:
            return mg.vcycle(state, r)
        masks, _ = self._nm_masks
        A = self.cmap.field("Acoef", r.dtype, r.device)
        reff, srs = r, {}
        for ax, (h_lo, f_lo, h_hi, f_hi) in folds.items():
            a = A[..., ax, ax]
            s_lo = torch.where(masks[(ax, "lo")], (h_lo / a) * r, 0.0)
            s_hi = torch.where(masks[(ax, "hi")], (h_hi / a) * r, 0.0)
            srs[ax] = (s_lo, s_hi)
            reff = reff - f_lo * torch.roll(s_lo, 1, ax) - f_hi * torch.roll(s_hi, -1, ax)
        z = mg.vcycle(state, reff)
        for ax in folds:
            s_lo, s_hi = srs[ax]
            z = torch.where(masks[(ax, "lo")], torch.roll(z, -1, ax) + s_lo, z)
            z = torch.where(masks[(ax, "hi")], torch.roll(z, 1, ax) + s_hi, z)
        return z

    def _step_rhs(self, u: torch.Tensor, f: torch.Tensor, dirichlet: torch.Tensor):
        """(initial guess, rhs) of the theta-scheme step A u_next = rhs.
        Insulated faces carry the zero-flux row (rhs 0) and keep the
        current value as the initial guess."""
        uL = self._masked_state(u, dirichlet)
        rhs = uL / self.dt + (1.0 - self.theta) * self.laplacian(uL) + self._zero_b(f)
        return uL, self._bc_rhs(rhs, dirichlet)

    def step(self, u: torch.Tensor, f: torch.Tensor, dirichlet: torch.Tensor) -> torch.Tensor:
        """One theta-scheme step: solve A u_next = rhs."""
        uL, rhs = self._step_rhs(u, f, dirichlet)
        return self.ksp.solve(self.implicit_operator, rhs, x0=uL, M=self._pc_apply,
                              reduce=self._reduce).x

    def step_diff(self, u: torch.Tensor, f: torch.Tensor, dirichlet: torch.Tensor) -> torch.Tensor:
        """``step``, differentiable in u, f and the Dirichlet data: the
        Krylov solve is ``solvers.adjoint.linear_solve`` of the right-hand
        side (``lax.custom_linear_solve`` in the JAX package).  Its
        forward solves without a graph, warm-started at the masked state;
        its backward solves the transposed implicit system A^T lambda = g
        by GMRES (CG where the forward takes CG) from zero.  A^T and the
        preconditioner's transpose M^T are vjps of the linear
        ``implicit_operator`` and fastdiag apply, built once.  The JAX
        package preconditions A^T with M itself; on insulated faces the
        fold makes M nonsymmetric, and M^T keeps the transposed solve at
        the forward's count (16^2, dt 5e-4, one insulated axis: 14
        iterations against 144)."""
        from spectral_tpu_torch.solvers.adjoint import linear_solve

        uL, rhs = self._step_rhs(u, f, dirichlet)
        uL = uL.detach()
        tksp = (dataclasses.replace(self.ksp, type="gmres") if self.ksp.type == "cg"
                else self.ksp)

        def solve(b):
            return self.ksp.solve(self.implicit_operator, b, x0=uL, M=self._pc_apply).x

        def tsolve(g):
            At, Mt = self._transposes_for(g.dtype, g.device)
            return tksp.solve(At, g, M=Mt).x

        return linear_solve(rhs, solve, tsolve)

    @cached_property
    def _transposes(self) -> dict:
        return {}

    def _transposes_for(self, dtype: torch.dtype, device: torch.device):
        """(w -> A^T w, r -> M^T r): vjps of the linear implicit operator
        and fastdiag apply, built once per dtype and device and applied at
        every Krylov iteration."""
        from spectral_tpu_torch.solvers.adjoint import transpose_op

        key = (dtype, device)
        if key not in self._transposes:
            zero = torch.zeros(self.grid.dims, dtype=dtype, device=device)
            self._transposes[key] = (transpose_op(self.implicit_operator, zero),
                                     transpose_op(self._pc_apply, zero))
        return self._transposes[key]

    def rollout(self, u0: torch.Tensor, f: torch.Tensor, dirichlet: torch.Tensor,
                nsteps: int) -> torch.Tensor:
        """``nsteps`` steps of time integration, a host loop."""
        u = u0
        for _ in range(nsteps):
            u = self.step(u, f, dirichlet)
        return u

    # ------------------------------------------------------------------
    # Steps with dt as an argument (solvers/ts.py): one shift-free fast
    # diagonalization per Laplacian scale serves every step size
    # ------------------------------------------------------------------
    def _traced_pc(self, c: float, shift: float):
        """r -> z preconditioner of (shift - c * Laplace): the shift-free
        fastdiag applied with the run-time ``shift``, or on a curved domain
        the shift-free metric hierarchy shifted by it.  ``c``: theta for the
        theta step, 1.0 for BE/BDF2."""
        if self.cmap is not None:
            if c == self.theta:
                mg, state0, folds = self._mgc_theta
            elif c == 1.0:
                mg, state0, folds = self._mgc_unit
            else:
                mg, state0, folds = self._curved_mg(c)
            state = mg.shift_state(state0, shift)
            return lambda r: self._metric_pc_apply(mg, state, folds, r)
        if c == self.theta:
            fd = self._fd0_theta
        elif c == 1.0:
            fd = self._fd0_unit
        else:  # exotic theta override: exact surrogate for this c
            fd = self._fastdiag(0.0, c)
        return lambda r: fd.apply(r, shift=shift, slab=self.slab)

    @cached_property
    def _fd0_theta(self) -> FastDiagSolver:
        """Shift-free fastdiag of theta * (-Laplace): the run-time shift
        1/dt makes it the exact surrogate inverse of the theta step."""
        return self._fastdiag(0.0, self.theta)

    @cached_property
    def _fd0_unit(self) -> FastDiagSolver:
        """Shift-free fastdiag of (-Laplace): the run-time shift a/dt
        preconditions the backward-Euler and BDF2 step operators."""
        return self._fastdiag(0.0, 1.0)

    def _masked_state(self, u: torch.Tensor, dirichlet: torch.Tensor) -> torch.Tensor:
        """The state with the Dirichlet trace imposed (insulated faces
        keep their evolved value)."""
        uL = torch.where(self._bmask, dirichlet, u)
        if self.neumann_axes:
            _, any_nm = self._nm_masks
            uL = torch.where(any_nm, u, uL)
        return uL

    def _bc_rhs(self, rhs: torch.Tensor, dirichlet: torch.Tensor) -> torch.Tensor:
        rhs = torch.where(self._bmask, dirichlet, rhs)
        if self.neumann_axes:
            _, any_nm = self._nm_masks
            rhs = torch.where(any_nm, 0.0, rhs)
        return rhs

    def step_theta_dt(self, u, f, dirichlet, dt: float, theta: float | None = None):
        """One theta step of size ``dt`` (``theta=1.0`` overrides to
        backward Euler: the BDF2 startup step)."""
        th = self.theta if theta is None else float(theta)
        uL = self._masked_state(u, dirichlet)
        rhs = self._bc_rhs(uL / dt + (1.0 - th) * self.laplacian(uL)
                           + self._zero_b(f), dirichlet)
        return self.ksp.solve(lambda w: self._implicit_op_c(w, 1.0 / dt, th), rhs,
                              x0=uL, M=self._traced_pc(th, 1.0 / dt), reduce=self._reduce).x

    def step_bdf2_dt(self, u, u_prev, f, dirichlet, dt: float, rr: float):
        """One variable-step BDF2 step of size ``dt`` with step ratio
        rr = dt/dt_prev:

            [(1+2r)/(1+r) u1 - (1+r) u + r^2/(1+r) u_prev]/dt = Lap u1 + f1

        (A-stable for r <= 1+sqrt(2); the solvers/ts.py controller clips
        growth well inside that).  History fields enter algebraically only,
        so their boundary rows pass through."""
        a = (1.0 + 2.0 * rr) / (1.0 + rr)
        uL = self._masked_state(u, dirichlet)
        rhs = self._bc_rhs(((1.0 + rr) * uL - (rr * rr / (1.0 + rr)) * u_prev) / dt
                           + self._zero_b(f), dirichlet)
        return self.ksp.solve(lambda w: self._implicit_op_c(w, a / dt, 1.0), rhs,
                              x0=uL, M=self._traced_pc(1.0, a / dt), reduce=self._reduce).x
