"""Boussinesq thermal convection at infinite Prandtl number: the coupled
flagship application (Rayleigh-Benard / mantle-convection class).

Counterpart of ``spectral_tpu/models/convection.py`` on flat domains:

    -div(eta eps(v)) + grad p = Ra T ghat,   div v = 0        (momentum)
    T_t + v . grad T = Laplace T + q                          (energy)

nondimensionalized on the depth-1 box [0, L]^(d-1) x [0, 1] (the vertical
axis is the last), thermal diffusion time, hot bottom T = 1, cold top
T = 0, eta = 2 so the viscous operator is the standard 2 eps(v) form.
The velocity is an instantaneous functional of the temperature: each time
step solves the linear Stokes saddle system with the buoyancy right-hand
side (warm-started; nested Schur PC or the dense exact inverse), then
advances the energy equation by the theta scheme with AB2-extrapolated
explicit advection (IMEX: implicit diffusion on the shifted fast
diagonalization of ``models/heat.py``), second order in dt at theta = 1/2.

The JAX package compiles a step (and a rollout into one ``lax.scan``);
here every rollout is a host loop over the same step, on the grid's
device and in its dtype.  Last-axis derivatives (the Stokes operator's,
the advection's ``chebdiff(T, d-1)``, the Nusselt flux) reach kernel K1 on
a CUDA tensor, also under ``torch.func.vmap`` in the dense assembly.

Also here: the adaptive march (``march_adaptive``), the direct
Newton-Krylov steady state (``steady_newton``), the linear stability of
the conduction or a convecting state (``critical_rayleigh``,
``stability_eigenvalues``, on ``solvers/eig.py``) and the Nusselt / rms
velocity diagnostics on Clenshaw-Curtis quadrature, and the rollout
differentiable by autograd (``rollout_diff``: implicit adjoint solves for
both Krylov solves, optional checkpointed segments).  The
Anderson-accelerated steady state (``steady_accelerated``) runs the
time stepper as the fixed-point map of ``anderson_solve``.
"""

from __future__ import annotations

import dataclasses
import math
from functools import cached_property

import numpy as np
import torch

from spectral_tpu_torch.grid import Grid
from spectral_tpu_torch.models.heat import HeatModel
from spectral_tpu_torch.models.rheology import PowerLawParams
from spectral_tpu_torch.models.stokes import StokesConfig, StokesProblem
from spectral_tpu_torch.ops.chebyshev import chebdiff
from spectral_tpu_torch.solvers.krylov import KSPConfig


@dataclasses.dataclass(frozen=True)
class ConvectionConfig:
    """Rayleigh number and solver knobs of the coupled step (the JAX
    package's fields and defaults).

    ``velocity_bc``: 'noslip' (v = 0, boundary 0), 'freeslip' (v.n = 0
    and zero tangential traction, boundary 7: the Blankenbach regime) or
    'rigid' (no-slip top and bottom, free-slip symmetry sidewalls,
    boundary 8: the Busse et al. 1994 box).  ``side_bc``: 'conducting'
    (Dirichlet conductive profile) or 'insulated' (zero flux on every
    horizontal axis).  ``eta_contrast``: eta(T) = exp(-ln(contrast) T)
    (1 = isoviscous; otherwise the velocity PC becomes 'mg' where it was
    'fastdiag', and the operator follows T).  ``tbc``: None = 1 for
    freeslip/rigid, 0 for noslip.  ``heating``: uniform internal heat
    production H.  ``dealias``: False, True (the 3/2 rule) or a padding
    ratio.  ``stokes_pc``: 'nested' (the velocity/Schur Krylov tree),
    'dense' (the exact inverse of the frozen isoviscous saddle operator,
    factored in host float64) or 'dense-device' (factored on the device);
    with ``eta_contrast != 1`` the dense tier reassembles and refactors
    every ``stokes_pc_lag`` steps.
    """

    Ra: float = 1e4
    dt: float = 1e-3
    theta: float = 0.5
    velocity_bc: str = "noslip"
    side_bc: str = "conducting"
    eta_contrast: float = 1.0
    tbc: int | None = None
    heating: float = 0.0
    pcvel: str = "fastdiag"
    dealias: bool | float = False
    stokes_pc: str = "nested"
    stokes_pc_lag: int = 25
    stokes_ksp: KSPConfig = KSPConfig(type="fgmres", rtol=1e-6, max_it=80, restart=40)
    temp_ksp: KSPConfig = KSPConfig(type="cg", rtol=1e-8, max_it=60)


_BOUNDARY = {"noslip": 0, "freeslip": 7, "rigid": 8}


class _SaddleSolve(torch.autograd.Function):
    """x = A(lin)^-1 b, differentiable in lin = (eta, eta', S) and b =
    (b_v, b_p): the tensors are the inputs, since a Function tracks tensor
    arguments only.  ``ConvectionModel._stokes_solve_diff``."""

    @staticmethod
    def forward(model, eta, deta, S, bv, bp):
        x = model._saddle_solve((eta, deta, S), {"v": bv, "p": bp})
        return x["v"], x["p"]

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.model = inputs[0]
        ctx.save_for_backward(*inputs[1:4], *output)

    @staticmethod
    def backward(ctx, gv, gp):
        from spectral_tpu_torch.solvers.adjoint import _like

        model = ctx.model
        eta, deta, S, xv, xp = ctx.saved_tensors
        lin, x = (eta, deta, S), {"v": xv, "p": xp}
        lam = model._saddle_tsolve(lin, {"v": gv, "p": gp})
        dlin = (None, None, None)
        need = ctx.needs_input_grad[1:4]
        if any(need):
            y, vjp_lin = torch.func.vjp(
                lambda e, de, s: model.stokes.jacobian_action(None, (e, de, s), x), *lin)
            dlin = tuple(-t if want else None for t, want in zip(vjp_lin(_like(y, lam)), need))
        return (None, *dlin, lam["v"], lam["p"])


class ConvectionModel:
    """Coupled Stokes + energy stepping on the unit (or aspect-ratio) box."""

    def __init__(self, grid: Grid, config: ConvectionConfig = ConvectionConfig(), *,
                 mesh=None, sharded_axis: int = 0, mesh_axis: str = "x",
                 axis_map: dict | None = None):
        """``mesh`` (``parallel.mesh.Mesh``) runs the coupled step on this
        process' slab (grid axis ``sharded_axis`` over ``mesh_axis``, or
        ``axis_map``; the vertical axis stays whole): the Stokes solve with
        its nested PC on slabs, the AB2 advection's derivatives through the
        pencil exchange (the rest pointwise), the implicit heat solve with
        its insulated sides folded on slabs, and the Nusselt and Vrms
        integrals summed over the mesh.  Temperatures, states and the
        conductive profile are slabs.  The dense tiers, the 3/2-rule
        advection, the steady solvers and the stability analysis on a
        mesh are ROADMAP item 7d."""
        if grid.intervals is None or any(abs(a) > 1e-12 for a, _ in grid.intervals) or \
                abs(grid.intervals[-1][1] - 1.0) > 1e-12:
            raise ValueError(
                "ConvectionModel is nondimensionalized on the layer depth: "
                "the vertical (last) axis must be (0, 1), horizontal axes "
                "(0, L) — pass Grid(dims, intervals=...) "
                "(ConvectionModel.unit_box / ConvectionModel.box)")
        if config.velocity_bc not in _BOUNDARY:
            raise ValueError(f"unknown velocity_bc {config.velocity_bc!r}")
        from spectral_tpu_torch.parallel.slab import Slab

        self.grid = grid
        self.config = config
        self.d = grid.ndim
        self.vax = grid.ndim - 1      # vertical = last axis
        self.mesh = mesh
        self.slab = Slab.of(mesh, axis_map, sharded_axis, mesh_axis)
        if self.slab is not None:
            if self.vax in self.slab.axis_map:
                raise ValueError("the vertical (last) axis stays whole on a mesh")
            if config.stokes_pc != "nested" or config.dealias:
                raise NotImplementedError("the dense tiers and the 3/2-rule advection on a "
                                          "mesh are not ported yet (ROADMAP.md queue 1, "
                                          "item 7d)")
        self._var_eta = config.eta_contrast != 1.0
        pcvel = config.pcvel
        if self._var_eta and pcvel == "fastdiag":
            pcvel = "mg"          # fastdiag cannot track eta(T)
        tbc = config.tbc
        if tbc is None:
            tbc = 1 if config.velocity_bc in ("freeslip", "rigid") else 0
        # eta = 2: the power law with exponent 1 is exactly eta = hardness
        scfg = StokesConfig(exact=0, boundary=_BOUNDARY[config.velocity_bc], rheology=1,
                            hardness=2.0, exponent=1.0, pcvel=pcvel, tbc=tbc,
                            outer_ksp=config.stokes_ksp)
        self.stokes = StokesProblem(grid, scfg, mesh=mesh, sharded_axis=sharded_axis,
                                    mesh_axis=mesh_axis, axis_map=axis_map)
        self._params = PowerLawParams(2.0, 1.0, 1.0, 1.0)
        # the frozen linearization of the linear operator (eta = 2, deta = 0)
        zero = self.stokes.zero_state()
        _, self._lin0 = self.stokes.make_residual(self._params)(zero)
        self._dense_var = False
        if config.stokes_pc in ("dense", "dense-device"):
            if self._var_eta:
                # variable viscosity: pc_setup(None, lin) is the refresh,
                # called on the stokes_pc_lag cadence by the rollouts and
                # once a Newton step by steady_newton
                self._dense_var = True
                self._pc_setup, self._pc_apply, apply_adj = self.stokes.make_dense_pc_var()
                self._adjoint_pc = (self._pc_setup, apply_adj)
            else:
                _, apply_d, apply_adj = self.stokes.make_dense_pc(
                    params=self._params,
                    factor="device" if config.stokes_pc == "dense-device" else "host")
                self._pc_setup = lambda x, lin: None
                self._pc_apply = apply_d
                # the adjoint PC: the same factorization transposed (Ainv^T),
                # in place of the nested tree's (the _adjoint_pc property)
                self._adjoint_pc = (self._pc_setup, apply_adj)
            self._pc_state = None
        elif config.stokes_pc == "nested":
            self._pc_setup, self._pc_apply = self.stokes.make_pc()
            # the isoviscous PC state is static; eta(T) rebuilds it a solve
            self._pc_state = None if self._var_eta else self._pc_setup(zero, self._lin0)
        else:
            raise ValueError(f"unknown stokes_pc {config.stokes_pc!r}")
        # the implicit diffusion substep (insulated sides: the
        # Neumann-eliminated fast diagonalization)
        if config.side_bc == "insulated":
            nm_axes = tuple(range(self.d - 1))
        elif config.side_bc == "conducting":
            nm_axes = ()
        else:
            raise ValueError(f"unknown side_bc {config.side_bc!r}")
        self.heat = HeatModel(grid, dt=config.dt, theta=config.theta, ksp=config.temp_ksp,
                              neumann_axes=nm_axes, slab=self.slab)

        def t(a):   # a global host array, as this process' block of it
            if self.slab is not None and np.ndim(a) >= 1:
                a = self.slab.local_np(a) if np.ndim(a) == self.d else a[
                    self.slab.slices(grid.dims)[:np.ndim(a)]]
            return torch.as_tensor(a, dtype=grid.dtype, device=grid.device)

        # the conductive profile T = 1 - y and its boundary trace
        self._T_cond_np = 1.0 - grid.coords_np[..., self.vax]
        self.T_cond = t(self._T_cond_np)
        self.bc_T = t(np.where(grid.boundary_mask_np, self._T_cond_np, 0.0))
        e = np.zeros(self.d)
        e[self.vax] = 1.0
        self._evert = torch.as_tensor(e, dtype=grid.dtype, device=grid.device)   # buoyancy
        self._W = t(grid.quad_weights_np)      # volume quadrature
        # surface quadrature over the horizontal axes (top/bottom slices)
        Wh = np.ones(grid.dims[:-1])
        for ax, w in enumerate(grid.quad_weights_1d_np[:-1]):
            shape = [1] * (self.d - 1)
            shape[ax] = len(w)
            Wh = Wh * w.reshape(shape)
        self._Wh = t(Wh)
        self._dealias = None
        if config.dealias:
            from spectral_tpu_torch.ops.chebyshev import cheb_pad_matrices_np
            ratio = 1.5 if config.dealias is True else float(config.dealias)
            pads = [cheb_pad_matrices_np(n, int(np.ceil(ratio * (n - 1))) + 1)
                    for n in grid.dims]
            self._dealias = (tuple(t(U) for U, _ in pads), tuple(t(D) for _, D in pads))

    @classmethod
    def unit_box(cls, dims, config: ConvectionConfig = ConvectionConfig(), *,
                 device: torch.device | str = "cuda", dtype: torch.dtype = torch.float64,
                 **mesh_kw):
        """The unit box; ``mesh_kw`` (mesh, sharded_axis, mesh_axis,
        axis_map) puts the model on a mesh."""
        g = Grid(tuple(dims), intervals=((0.0, 1.0),) * len(dims), device=device, dtype=dtype)
        return cls(g, config, **mesh_kw)

    @classmethod
    def box(cls, dims, config: ConvectionConfig = ConvectionConfig(), aspect=1.0, *,
            device: torch.device | str = "cuda", dtype: torch.dtype = torch.float64,
            **mesh_kw):
        """Aspect-ratio box: horizontal width(s) ``aspect`` (a scalar or
        one per horizontal axis), depth 1; ``mesh_kw`` as in ``unit_box``."""
        d = len(dims)
        widths = ((float(aspect),) * (d - 1) if np.ndim(aspect) == 0
                  else tuple(map(float, aspect)))
        if len(widths) != d - 1:
            raise ValueError(f"aspect needs {d - 1} widths, got {widths}")
        ivals = tuple((0.0, w) for w in widths) + ((0.0, 1.0),)
        return cls(Grid(tuple(dims), intervals=ivals, device=device, dtype=dtype), config,
                   **mesh_kw)

    # ------------------------------------------------------------------
    # Coupled step pieces
    # ------------------------------------------------------------------
    def _one_process(self, what: str) -> None:
        if self.slab is not None:
            raise NotImplementedError(f"ConvectionModel.{what} on a mesh is not ported yet "
                                      "(ROADMAP.md queue 1, item 7d)")

    def buoyancy_rhs(self, T: torch.Tensor, Ra=None) -> dict:
        """Saddle right-hand side {Ra T ghat, 0} on the free velocity dofs;
        mixed (free-slip) rows are traction rows with zero datum."""
        Ra = self.config.Ra if Ra is None else Ra
        bv = Ra * T[..., None] * self._evert
        bv = torch.where(self.stokes.nm_mask[..., None], 0.0, bv)
        return {"v": self.stokes.mask_v(bv), "p": torch.zeros_like(T)}

    def eta_of_T(self, T: torch.Tensor, contrast=None) -> torch.Tensor:
        """Relative viscosity exp(-ln(contrast) T): 1 at the cold top,
        1/contrast at the hot bottom (the Blankenbach case-2 law)."""
        c = self.config.eta_contrast if contrast is None else contrast
        log_c = torch.log(c) if isinstance(c, torch.Tensor) else math.log(c)
        return torch.exp(-log_c * T)

    def _lin_of(self, T: torch.Tensor, contrast=None):
        """Linearization state of the variable-viscosity operator: eta =
        2 eta(T), deta = 0 (no strain dependence)."""
        if not self._var_eta and contrast is None:
            return self._lin0
        eta = 2.0 * self.eta_of_T(T, contrast)
        return (eta, torch.zeros_like(T), torch.zeros(T.shape + (self.d, self.d),
                                                      dtype=T.dtype, device=T.device))

    def solve_stokes(self, T: torch.Tensor, x0: dict, pc_state=None):
        """The Stokes solve for the buoyancy of T (with eta_contrast != 1
        the operator and the eta-aware PC follow T); ``pc_state``
        overrides the PC state (a lagged dense factorization)."""
        lin = self._lin_of(T)
        if pc_state is not None:
            state = pc_state
        else:
            state = self._pc_setup(None, lin) if self._var_eta else self._pc_state
        return self.config.stokes_ksp.solve(
            lambda w: self.stokes.jacobian_action(None, lin, w), self.buoyancy_rhs(T), x0,
            M=lambda r: self._pc_apply(state, r), null_project=self.stokes.null_project,
            reduce=self.stokes._reduce)

    def velocity_full(self, x: dict) -> torch.Tensor:
        """Full-grid velocity with the reconstructed mixed components."""
        return self.stokes.local_velocity(x["v"], with_dirichlet=True)

    # ------------------------------------------------------------------
    # The differentiable rollout (autograd through the coupled integration)
    # ------------------------------------------------------------------
    @cached_property
    def _adjoint_pc(self):
        """(setup, apply) of the transposed saddle system's PC: the nested
        tree transposed (the dense tiers set Ainv^T in __init__)."""
        return self.stokes.make_pc(adjoint=True)

    def _saddle_solve(self, lin, b: dict, pc_state=None) -> dict:
        """x = A(lin)^-1 b from the zero state (no warm start: the
        differentiable solves are functions of b alone)."""
        state = self._pc_setup(None, lin) if pc_state is None else pc_state
        return self.config.stokes_ksp.solve(
            lambda w: self.stokes.jacobian_action(None, lin, w), b, self.stokes.zero_state(),
            M=lambda r: self._pc_apply(state, r), null_project=self.stokes.null_project).x

    def _saddle_tsolve(self, lin, g: dict, At=None, astate=None) -> dict:
        """lambda = A(lin)^-T g under the adjoint PC; A^T is one vjp of the
        linear action, built here once (or given) and applied at every
        iteration."""
        from spectral_tpu_torch.solvers.adjoint import transpose_op

        asetup, aapply = self._adjoint_pc
        if At is None:
            At = transpose_op(lambda y: self.stokes.jacobian_action(None, lin, y),
                              self.stokes.zero_state(lin[0].dtype))
        if astate is None:
            astate = asetup(None, lin)
        return self.config.stokes_ksp.solve(At, g, self.stokes.zero_state(),
                                            M=lambda r: aapply(astate, r),
                                            null_project=self.stokes.null_project).x

    @cached_property
    def _stokes_solve_diff_const(self):
        """b -> x: ``_stokes_solve_diff`` for the frozen isoviscous
        operator, its forward and adjoint PC states and A^T built once here;
        the operator carries no gradient, so the backward pass is the lone
        transposed solve (``solvers.adjoint.linear_solve``)."""
        from spectral_tpu_torch.solvers.adjoint import linear_solve, transpose_op

        lin = self._lin0
        fstate = self._pc_state if self._pc_state is not None else self._pc_setup(None, lin)
        astate = self._adjoint_pc[0](None, lin)
        At = transpose_op(lambda y: self.stokes.jacobian_action(None, lin, y),
                          self.stokes.zero_state())

        def solve(b):
            return linear_solve(b, lambda bb: self._saddle_solve(lin, bb, fstate),
                                lambda g: self._saddle_tsolve(lin, g, At, astate))

        return solve

    @property
    def _stokes_solve_diff(self):
        """(lin, b) -> x, the saddle solve differentiable in both (the
        implicit function theorem, solvers/adjoint.py on the linear case):
        the backward pass solves the transposed system under the adjoint PC
        for lambda = A^-T x_bar, the right-hand side's cotangent, and
        contracts -lambda through the vjp of lin -> A(lin) x for the
        operator's, so with variable viscosity the gradient also flows
        through eta(T) in the operator."""
        def solve(lin, b: dict) -> dict:
            xv, xp = _SaddleSolve.apply(self, *lin, b["v"], b["p"])
            return {"v": xv, "p": xp}

        return solve

    def rollout_diff(self, T0: torch.Tensor, nsteps: int, Ra=None, contrast=None,
                     checkpoint: bool | int = False):
        """``nsteps`` coupled steps, differentiable by autograd: returns (T,
        x) with gradients flowing to T0, Ra and the viscosity contrast
        (pass them as tensors; None freezes the config's value).

        Both Krylov solves are implicit (``_stokes_solve_diff`` and
        ``HeatModel.step_diff``: an adjoint solve each in the backward
        pass, not autograd through the loops); the buoyancy, eta(T), the
        AB2 advection and the theta-scheme right-hand side are plain
        tensor code, so ``torch.autograd.grad`` of a loss of the result is
        the discrete transient adjoint of the coupled system.  No warm
        starts: prefer ``rollout`` when no gradient is needed.

        ``checkpoint``: True (or a segment length k) runs the host loop in
        segments of k = ceil(sqrt(n)) steps under
        ``torch.utils.checkpoint``: the backward pass keeps the O(sqrt n)
        segment-boundary states and integrates one segment again at a time
        (one extra forward pass in all), the rest of n - 1 steps after the
        peeled first one unsegmented.  The same gradient."""
        self._one_process("rollout_diff")
        from torch.utils.checkpoint import checkpoint as ckpt

        Ra = self.config.Ra if Ra is None else Ra
        if contrast is None and self._var_eta:
            contrast = self.config.eta_contrast
        const_op = contrast is None and not self._var_eta

        def stokes_of(T):
            if const_op:   # the frozen operator: PC states built once
                return self._stokes_solve_diff_const(self.buoyancy_rhs(T, Ra))
            return self._stokes_solve_diff(self._lin_of(T, contrast), self.buoyancy_rhs(T, Ra))

        def body(T, N_prev):
            x = stokes_of(T)
            N = self.advection(self.velocity_full(x), T)
            N_mid = 1.5 * N - 0.5 * N_prev
            return self.heat.step_diff(T, self._forcing(N_mid, None), self.bc_T), N

        def segment(T, N, length: int):
            for _ in range(length):
                T, N = body(T, N)
            return T, N

        if nsteps <= 0:
            return T0, stokes_of(T0)
        # the first step is peeled: its AB2 extrapolation degenerates to N0
        x0 = stokes_of(T0)
        N0 = self.advection(self.velocity_full(x0), T0)
        T, N = self.heat.step_diff(T0, self._forcing(N0, None), self.bc_T), N0
        n = nsteps - 1
        if checkpoint and n > 1:
            k = int(checkpoint) if checkpoint is not True else int(np.ceil(np.sqrt(n)))
            k = max(1, min(k, n))
            nseg, rem = divmod(n, k)
            for _ in range(nseg):
                T, N = ckpt(segment, T, N, k, use_reentrant=False)
            T, N = segment(T, N, rem)
        else:
            T, N = segment(T, N, n)
        return T, stokes_of(T)

    # ------------------------------------------------------------------
    # Advection and the step
    # ------------------------------------------------------------------
    def _pad_apply(self, mats, z: torch.Tensor) -> torch.Tensor:
        """Per-axis dense transfer (coarse <-> fine CGL), one library
        product an axis."""
        from spectral_tpu_torch.ops.tensorops import apply_axis_matmul
        for ax, M in enumerate(mats):
            z = apply_axis_matmul(M.to(z.dtype), z, ax)
        return z

    def advection(self, v_full: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
        """N = v . grad T on the interior (boundary rows are constraints).
        With ``config.dealias`` the product is evaluated on the padded CGL
        grid and projected back (the 3/2 rule)."""
        g = self.grid
        if self._dealias is None:
            N = torch.zeros_like(T)
            for ax in range(self.d):
                N = N + v_full[..., ax] * self.stokes._dif(T, ax)
            return self.heat._zero_b(N)
        Us, Ds = self._dealias
        Nf = None
        for ax in range(self.d):
            dT = g.apply_dif_weight(chebdiff(T, ax), ax)
            prod = self._pad_apply(Us, v_full[..., ax]) * self._pad_apply(Us, dT)
            Nf = prod if Nf is None else Nf + prod
        return g.zero_boundary(self._pad_apply(Ds, Nf))

    def _forcing(self, N_mid: torch.Tensor, q):
        if q is None and self.config.heating:
            q = self.config.heating
        return -N_mid if q is None else q - N_mid

    def step(self, T, N_prev, x_prev, q=None, pc_state=None):
        """One IMEX step: Stokes solve, AB2 advection, theta diffusion.
        Returns (T_next, N, x): N this step's advection (the next step's
        N_prev), x the saddle solution (the next warm start)."""
        x = self.solve_stokes(T, x_prev, pc_state=pc_state).x
        N = self.advection(self.velocity_full(x), T)
        N_mid = 1.5 * N - 0.5 * N_prev          # t_{n+1/2} extrapolation
        return self.heat.step(T, self._forcing(N_mid, q), self.bc_T), N, x

    def step_dt(self, T, N_prev, x_prev, dt: float, rho: float, q=None, pc_state=None):
        """One IMEX step of size ``dt`` with the advection history's step
        ratio ``rho`` = dt/dt_prev (0 on the first step): N_mid = N +
        theta rho (N - N_prev), the fixed AB2 weights at theta = 1/2,
        rho = 1; the diffusion substep takes dt as an argument."""
        x = self.solve_stokes(T, x_prev, pc_state=pc_state).x
        N = self.advection(self.velocity_full(x), T)
        N_mid = N + self.config.theta * rho * (N - N_prev)
        return self.heat.step_theta_dt(T, self._forcing(N_mid, q), self.bc_T, dt), N, x

    def _pc_refresh(self, T: torch.Tensor):
        """T -> a lagged dense PC state (one assembly and inverse)."""
        return self._pc_setup(None, self._lin_of(T))

    @cached_property
    def _min_spacing_np(self) -> np.ndarray:
        """Per-axis minimum node spacing (the advective CFL length)."""
        return np.array([np.abs(np.diff(np.asarray(z))).min() for z in self.grid.nodes_1d])

    def _cfl_dt(self, x: dict, cfl: float) -> float:
        """Advective CFL bound cfl * min_ax(h_min_ax / max|v_ax|)."""
        vmax = torch.amax(torch.abs(self.velocity_full(x)).reshape(-1, self.d), dim=0)
        out = np.inf
        for ax, vm in enumerate(vmax.cpu().tolist()):
            if vm > 0.0:
                out = min(out, float(self._min_spacing_np[ax]) / vm)
        return cfl * out

    def march_adaptive(self, T0, max_steps: int = 5000, tol: float = 1e-6,
                       rtol: float = 1e-3, atol: float = 1e-8, cfl: float = 4.0,
                       dt0: float | None = None, dt_max: float = np.inf,
                       grow_max: float = 1.5, safety: float = 0.9, monitor: bool = False,
                       checkpoint: str | None = None, checkpoint_every: int = 50,
                       resume: bool = False):
        """Variable-step marching to steady state: a linear-predictor local
        error estimate drives an order-2 controller with accept/reject; a
        non-finite or violently unstable step is rejected (dt shrinks 5x),
        period-2 ringing (consecutive updates anticorrelated) caps dt, and
        the stall detector (the rate stops decaying over a window while
        the estimate is tolerance-bound: a numerical limit cycle just
        above the explicit advection's stability boundary) caps it below
        that boundary.  ``cfl`` is a loose a-priori net.

        Returns (T, x, info); info adds 'rejects' and 'dts' to the
        march_to_steady keys, and 'steps' counts accepted steps.

        ``checkpoint`` (a directory, ``utils/checkpoint.py``) saves the
        marching state, the (T, N, x, T_prev) carry and the controller's
        dt, dt_prev, dt_stab and counts, every ``checkpoint_every``
        accepted steps; ``resume`` restarts from the latest saved state,
        the step and reject counts carried on.  As in the JAX package, a
        resumed run starts the stall window and the lagged PC afresh, so
        it follows the JAX package's resumed run."""
        self._one_process("march_adaptive")
        from spectral_tpu_torch.solvers.ts import wrms
        from spectral_tpu_torch.utils import checkpoint as ckpt

        T = T0
        T_prev = None
        dt_prev = None
        dt = float(dt0 if dt0 is not None else self.config.dt)
        dt_stab = np.inf          # stability cap (recovers slowly)
        steps = rejects = 0
        rate = np.inf
        dts: list[float] = []
        rate_hist: list[float] = []
        steps_since_cap = 0
        window = 30
        carry = None
        if checkpoint and resume:
            k = ckpt.latest_step(checkpoint)
            if k is not None:
                like = (T, T, self.stokes.zero_state(), T)
                Tl, Nl, xl, T_prev = ckpt.load_state(checkpoint, k, like)
                meta = ckpt.load_meta(checkpoint, k)
                T, carry = Tl, (Tl, Nl, xl)
                dt = float(meta.get("dt", dt))
                dt_prev = float(meta.get("dt_prev", dt))
                dt_stab = float(meta.get("dt_stab", np.inf))
                steps = int(meta.get("steps", k))
                rejects = int(meta.get("rejects", 0))
                if monitor:
                    print(f"  resumed from checkpoint step {steps}")
        if carry is None:
            carry = self.init_carry(T)
        pcs = None
        pc_age = 10**9
        while steps < max_steps and steps + rejects < 4 * max_steps:
            Tc, Nc, xc = carry
            if self._dense_var and pc_age >= max(1, self.config.stokes_pc_lag):
                pcs = self._pc_refresh(Tc)   # the lagged refactorization
                pc_age = 0
            rho = 0.0 if dt_prev is None else dt / dt_prev
            Tn, Nn, xn = self.step_dt(Tc, Nc, xc, dt, rho, pc_state=pcs)
            if T_prev is not None:
                T_pred = Tc + (dt / dt_prev) * (Tc - T_prev)
                est = 0.5 * wrms(Tn - T_pred, Tn, rtol, atol)
                dT_new, dT_old = (Tn - Tc).reshape(-1), (Tc - T_prev).reshape(-1)
                dot, n_new, n_old = torch.stack(
                    [torch.dot(dT_new, dT_old), torch.linalg.vector_norm(dT_new),
                     torch.linalg.vector_norm(dT_old)]).cpu().tolist()
                corr = dot / max(n_new * n_old, 1e-300)
            else:
                # the first step is accepted at dt0 unless it blew up (a
                # non-finite first step could never be rejected back)
                est = 0.5 if bool(torch.all(torch.isfinite(Tn))) else np.inf
                corr = 1.0
            if not np.isfinite(est):
                est = np.inf
            if est <= 1.0:
                rate = float(torch.max(torch.abs(Tn - Tc))) / dt
                T_prev, dt_prev = Tc, dt
                carry = (Tn, Nn, xn)
                steps += 1
                pc_age += 1
                dts.append(dt)
                rate_hist.append(rate)
                steps_since_cap += 1
                if corr < -0.5:
                    # period-2 ringing: cap dt below the boundary
                    dt_stab = 0.7 * dt
                    steps_since_cap = 0
                elif steps_since_cap >= window and rate > 5.0 * tol and est > 0.3:
                    old = np.median(rate_hist[-window:-window // 2])
                    new = np.median(rate_hist[-(window // 2):])
                    if new > 0.8 * old:
                        dt_stab = 0.6 * dt
                        steps_since_cap = 0
                        if monitor:
                            print(f"  STALL: rate {old:.3e} -> {new:.3e}, "
                                  f"capping dt at {dt_stab:.3e}")
                dt_stab = min(dt_stab * 1.01, np.inf)
                if monitor:
                    print(f"  step {steps:5d}  t+={dt:.3e}  est={est:.3e}"
                          f"  corr={corr:+.2f}  |dT/dt| = {rate:.3e}")
                if rate < tol:
                    break
            else:
                rejects += 1
                if monitor:
                    print(f"  REJECT        t+={dt:.3e}  est={est:.3e}")
            fac = safety * est ** -0.5 if est > 0.0 else grow_max
            fac = min(grow_max, max(0.2, fac))
            dt = min(dt * fac, dt_max, dt_stab, self._cfl_dt(carry[2], cfl))
            if checkpoint and est <= 1.0 and steps % checkpoint_every == 0:
                # 1e300 stands for an infinite cap, as in the JAX package
                ckpt.save_state(checkpoint, steps, (*carry, T_prev),
                                meta={"dt": dt, "dt_prev": dt_prev,
                                      "dt_stab": dt_stab if np.isfinite(dt_stab) else 1e300,
                                      "steps": steps, "rejects": rejects})
        T, _, x = carry
        info = {"steps": steps, "rejects": rejects, "rate": rate, "dts": dts,
                **self._diagnostics(T, x), "converged": rate < tol}
        return T, x, info

    def init_carry(self, T0: torch.Tensor):
        """Initial (T, N, x) carry: one cold Stokes solve at t = 0."""
        x0 = self.solve_stokes(T0, self.stokes.zero_state()).x
        return T0, self.advection(self.velocity_full(x0), T0), x0

    def _scan_steps(self, carry, nsteps: int):
        """``nsteps`` coupled steps from (T, N, x), a host loop.  With the
        lagged dense tier the factorization refreshes from the chunk-head
        temperature every ``stokes_pc_lag`` steps."""
        k = max(1, min(self.config.stokes_pc_lag, nsteps)) if self._dense_var else max(nsteps, 1)
        pc = None
        for i in range(nsteps):
            if self._dense_var and i % k == 0:
                pc = self._pc_refresh(carry[0])
            carry = self.step(*carry, pc_state=pc)
        return carry

    def rollout(self, T0: torch.Tensor, nsteps: int):
        """``nsteps`` coupled steps; returns (T, N, x)."""
        return self._scan_steps(self.init_carry(T0), nsteps)

    def _steady_map(self, T: torch.Tensor, nsteps: int) -> torch.Tensor:
        """T -> T after ``nsteps`` coupled steps from a cold start: N and x
        are rebuilt from T inside the map, so it is a pure function of T
        (the fixed-point map Anderson acceleration extrapolates over)."""
        return self._scan_steps(self.init_carry(T), nsteps)[0]

    def steady_accelerated(self, T0, m: int = 5, chunk: int = 10, tol: float = 1e-6,
                           max_iters: int = 200, warmup: int = 0, monitor: bool = False):
        """Anderson-accelerated steady state: AA(m) over the fixed-point map
        G(T) = ``chunk`` coupled steps from T, a host loop of steps.  The
        time stepper plays the nonlinear preconditioner; the least-squares
        extrapolation over the last ``m`` residual differences replaces the
        slow physical transient.  Only T is extrapolated: velocity and the
        advection history are rebuilt from T inside the map.  ``warmup``
        plain steps first let the convective instability grow clear of the
        conductive state, which is also a fixed point of G.

        Returns (T, x, info) with march_to_steady's keys; info['steps'] =
        warmup + iterations * chunk, the physical steps taken."""
        self._one_process("steady_accelerated")
        from spectral_tpu_torch.solvers.newton import NewtonConfig, anderson_solve

        if warmup:
            T0 = self.rollout(T0, warmup)[0]
        dt_eff = chunk * self.config.dt

        def residual(T):
            return T - self._steady_map(T, chunk), None

        # ||.||_inf <= ||.||_2, so atol = tol chunk dt implies the marching
        # criterion ||T - G(T)||_inf / (chunk dt) < tol
        res = anderson_solve(residual, T0, m=m, config=NewtonConfig(
            rtol=0.0, atol=tol * dt_eff, max_it=max_iters, monitor=monitor))
        T = res.x
        rate = float(torch.max(torch.abs(residual(T)[0]))) / dt_eff
        x = self.solve_stokes(T, self.stokes.zero_state()).x
        info = {"steps": warmup + res.iters * chunk, "rate": rate, **self._diagnostics(T, x),
                "converged": bool(res.reason > 0) and np.isfinite(rate)}
        return T, x, info

    def _diagnostics(self, T: torch.Tensor, x: dict) -> dict:
        nu_top, nu_bottom, vrms = torch.stack(
            [self.nusselt_top(T), self.nusselt_bottom(T), self.vrms(x)]).cpu().tolist()
        return {"nu_top": nu_top, "nu_bottom": nu_bottom, "vrms": vrms}

    def steady_newton(self, T0, warmup: int = 150, newton=None, ksp: KSPConfig | None = None,
                      monitor: bool = False):
        """Direct Newton-Krylov steady state of the coupled system: solve
        R(T) = -Lap T - q + v(T).grad T = 0 (interior rows; T - bc on
        Dirichlet faces, dT/dn on insulated faces).  The exact Jacobian
        action is the stability linearization J u = -Lap u + dv(u).grad T
        + v.grad u, one Stokes solve a Krylov iteration; the PC is the
        Neumann-eliminated fast diagonalization of the diffusion part.

        ``warmup`` physical steps first clear the conduction fixed point.
        Returns (T, x, info): info adds 'newton' (the NewtonResult) to the
        march_to_steady keys; info['steps'] = warmup + total Krylov
        iterations + accepted Newton residual evaluations, a lower bound
        on the Stokes-solve count."""
        self._one_process("steady_newton")
        from spectral_tpu_torch.solvers.newton import NewtonConfig, newton_solve

        g = self.grid
        lap = self._stability_lap
        Ra = self.config.Ra
        q = self.config.heating
        bcvec = torch.where(g.boundary_mask, self.bc_T, 0.0)
        if lap.neumann_axes:
            bcvec = torch.where(lap._nm_masks[1], 0.0, bcvec)
        q_int = (g.zero_boundary(torch.full(g.dims, float(q), dtype=g.dtype, device=g.device))
                 if q else None)

        def residual(T):
            x = self.solve_stokes(T, self.stokes.zero_state()).x
            v0 = self.velocity_full(x)
            F = lap.implicit_operator(T) - bcvec + self.advection(v0, T)
            if q_int is not None:
                F = F - q_int
            dT0 = tuple(g.apply_dif_weight(chebdiff(T, ax), ax) for ax in range(self.d))
            lin = self._lin_of(T)
            state = self._pc_setup(None, lin) if self._var_eta else self._pc_state
            return F, (dT0, lin, state, T, x, v0)

        def jac(_T, ls, u):
            dT0, lin, state, T, x, v0 = ls
            return lap.implicit_operator(u) - self._stability_advective(
                (dT0, lap, lin, state, T, x, v0), u, Ra)

        if warmup:
            T0 = self.rollout(T0, warmup)[0]
        newton = newton or NewtonConfig(rtol=1e-9, max_it=20, ksp_ew=True, monitor=monitor)
        ksp = ksp or KSPConfig(type="fgmres", rtol=1e-6, max_it=200, restart=80)
        res = newton_solve(residual, T0, jacobian_action=jac,
                           pc_apply=lambda _s, r: lap._pc_apply(r), ksp=ksp, config=newton)
        T = res.x
        x = self.solve_stokes(T, self.stokes.zero_state()).x
        solves = warmup + int(np.sum(np.asarray(res.ksp_iters))) + int(res.iters) + 1
        info = {"steps": solves, "rate": float(res.fnorm), "newton": res,
                **self._diagnostics(T, x), "converged": bool(res.reason > 0)}
        return T, x, info

    def march_to_steady(self, T0, max_steps: int = 5000, tol: float = 1e-6,
                        chunk: int = 25, monitor: bool = False):
        """March until || dT/dt ||_inf < tol, checked every ``chunk`` steps.
        Returns (T, x, info) with info = {steps, rate, nu_top, nu_bottom,
        vrms, converged}."""
        self._one_process("march_to_steady")
        T_prev = T0
        carry = self.init_carry(T0)
        steps = 0
        rate = np.inf
        while steps < max_steps:
            carry = self._scan_steps(carry, chunk)
            steps += chunk
            T = carry[0]
            rate = float(torch.max(torch.abs(T - T_prev))) / (chunk * self.config.dt)
            if monitor:
                print(f"  step {steps:5d}  |dT/dt| = {rate:.3e}  "
                      f"Nu = {float(self.nusselt_top(T)):.6f}")
            if not np.isfinite(rate):
                break       # blow-up (CFL of the explicit advection): stop
            if rate < tol:
                break
            T_prev = T
        T, _, x = carry
        info = {"steps": steps, "rate": rate, **self._diagnostics(T, x),
                "converged": rate < tol}
        return T, x, info

    # ------------------------------------------------------------------
    # Linear stability analysis (solvers/eig.py)
    # ------------------------------------------------------------------
    # At infinite Prandtl the linearization about the conduction base
    # (T0, v0 = 0: the buoyancy of T0 is a pressure gradient) acts on the
    # temperature alone: dT'/dt = L T', L = Lap + Ra B', B' T' =
    # -v1(T') . grad T0, with v1(T') the unit-Ra Stokes velocity response
    # to the buoyancy of T'.  The constrained rows (Dirichlet top/bottom,
    # zero-flux insulated sides) are solved with those rows, so Krylov
    # vectors stay in the constraint manifold.

    @cached_property
    def _stability_lap(self) -> HeatModel:
        """(-Laplace) on the constrained space: the heat operator at
        dt = 1e12, theta = 1 (exact Dirichlet / zero-flux rows, the
        Neumann-eliminated fastdiag PC).  Base-state independent."""
        return HeatModel(self.grid, dt=1e12, theta=1.0,
                         ksp=KSPConfig(type="cg", rtol=1e-12, max_it=500),
                         neumann_axes=self.heat.neumann_axes)

    @property
    def _conduction_base_is_equilibrium(self) -> bool:
        """The 1-D profile 1 - y + (H/2) y (1-y) is a flowless equilibrium
        unless internal heating meets conducting sidewalls."""
        return not (self.config.heating and self.config.side_bc == "conducting")

    @cached_property
    def _stability_pieces(self):
        """(grad T0 components, the (-Lap) HeatModel, (lin, frozen Stokes
        PC state), T0) at the heating-aware conduction profile."""
        g = self.grid
        H = self.config.heating
        y = g.coords_np[..., self.vax]
        T0 = torch.as_tensor(1.0 - y + 0.5 * H * y * (1.0 - y), dtype=g.dtype, device=g.device)
        dT0 = tuple(g.apply_dif_weight(chebdiff(T0, ax), ax) for ax in range(self.d))
        lin = self._lin_of(T0)
        return dT0, self._stability_lap, (lin, self._pc_setup(None, lin)), T0

    @cached_property
    def _auto_base(self):
        """The steady base state (T, x) where no conduction equilibrium
        exists (heated conducting sidewalls), by steady_newton at
        config.Ra; raises if that solve does not converge."""
        T, x, info = self.steady_newton(self.conductive_state(amp=0.0))
        if not info["converged"]:
            raise RuntimeError(
                "auto base-state solve (steady_newton) did not converge: "
                f"|R| = {info['rate']:.3e}; compute the base yourself "
                "(march_to_steady / march_adaptive) and pass base=(T, x)")
        return T, x

    def _stability_ctx(self, base=None):
        """Linearization context about a base state: None = the conduction
        profile where that is an equilibrium, else the auto-computed
        steady base; or (T_base, x_base) from a steady solve."""
        if base is None and not self._conduction_base_is_equilibrium:
            base = self._auto_base
        if base is None:
            dT0c, lap, (linc, statec), T0c = self._stability_pieces
            return dT0c, lap, linc, statec, T0c, None, None
        g = self.grid
        T0, x0 = base
        dT0 = tuple(g.apply_dif_weight(chebdiff(T0, ax), ax) for ax in range(self.d))
        lin = self._lin_of(T0)
        return (dT0, self._stability_lap, lin, self._pc_setup(None, lin), T0, x0,
                self.velocity_full(x0))

    def _stability_dv(self, ctx, Tp: torch.Tensor, Ra) -> torch.Tensor:
        """The linearized velocity response dv(T') at the base: the
        buoyancy of T' plus, with variable viscosity about a flowing base,
        -A^{-1} dA[d eta(T')] x0 (directional derivatives by
        ``torch.func.jvp``)."""
        dT0, lap, lin, state, T0, x0, v0 = ctx
        rhs = self.buoyancy_rhs(Tp, Ra=Ra)
        if x0 is not None and self._var_eta:
            dlin = torch.func.jvp(self._lin_of, (T0,), (Tp,))[1]
            dAx0 = torch.func.jvp(lambda *l: self.stokes.jacobian_action(None, l, x0),
                                  tuple(lin), tuple(dlin))[1]
            rhs = {k: rhs[k] - dAx0[k] for k in rhs}
        res = self.config.stokes_ksp.solve(
            lambda w: self.stokes.jacobian_action(None, lin, w), rhs, self.stokes.zero_state(),
            M=lambda r: self._pc_apply(state, r), null_project=self.stokes.null_project)
        return self.velocity_full(res.x)

    def _stability_advective(self, ctx, Tp: torch.Tensor, Ra) -> torch.Tensor:
        """The non-Laplacian interior rows of the linearized energy
        operator: -dv(T') . grad T0 - v0 . grad T' (zero on the
        constrained rows)."""
        dT0, lap, lin, state, T0, x0, v0 = ctx
        g = self.grid
        dv = self._stability_dv(ctx, Tp, Ra)
        w = torch.zeros_like(Tp)
        for ax in range(self.d):
            w = w - dv[..., ax] * dT0[ax]
            if v0 is not None:
                w = w - v0[..., ax] * g.apply_dif_weight(chebdiff(Tp, ax), ax)
        return g.zero_boundary(w)

    def _stability_B(self, Tp: torch.Tensor) -> torch.Tensor:
        """B' T' = -v1(T') . grad T0 at the conduction base (unit Ra)."""
        return self._stability_advective(self._stability_ctx(None), Tp, 1.0)

    def _start_vector(self, seed: int) -> torch.Tensor:
        g = self.grid
        v0 = np.random.default_rng(seed).standard_normal(g.dims)
        return g.zero_boundary(torch.as_tensor(v0, dtype=g.dtype, device=g.device))

    def critical_rayleigh(self, k: int = 2, m: int = 20, tol: float = 1e-9):
        """Onset of convection as a direct generalized eigenproblem: at
        neutral stability Lap T' + Ra B' T' = 0, so Ra_c = 1 / mu_max with
        mu_max the largest positive eigenvalue of (-Lap)^{-1} B' (one
        Stokes and one Poisson solve an Arnoldi step).  Free-slip insulated
        unit box: Ra_c = 8 pi^4.  Returns (Ra_c, EPSResult)."""
        self._one_process("critical_rayleigh")
        from spectral_tpu_torch.solvers.eig import eigs

        if not self._conduction_base_is_equilibrium:
            raise ValueError(
                "critical_rayleigh assumes a flowless conduction branch; "
                "with internal heating and conducting sidewalls the base "
                "state flows at EVERY Ra (imperfect bifurcation — no sharp "
                "onset exists).  Use stability_eigenvalues(), which "
                "linearizes about the computed steady base automatically.")
        lap = self._stability_lap

        def op(Tp):
            return lap.ksp.solve(lap.implicit_operator, self._stability_B(Tp),
                                 M=lap._pc_apply).x

        res = eigs(op, self._start_vector(0), k=k, which="LR", m=m, tol=tol)
        lam = res.eigenvalues_polished if res.eigenvalues_polished is not None \
            else res.eigenvalues
        mu = max((z.real for z in lam if abs(z.imag) < 1e-8 * abs(z) + 1e-12 and z.real > 0),
                 default=np.nan)
        return (1.0 / mu if np.isfinite(mu) else np.nan), res

    def stability_eigenvalues(self, Ra: float | None = None, sigma: float = 0.0, k: int = 4,
                              m: int = 25, tol: float = 1e-8, ksp: KSPConfig | None = None,
                              base=None):
        """Growth rates: the eigenvalues of L T' = Lap T' - dv(T').grad T0
        - v0.grad T' nearest ``sigma``, by shift-invert Arnoldi (each
        matvec one GMRES solve of (L - sigma I) z = w, each of whose
        iterations applies a Stokes solve).  ``base=None``: the conduction
        state; ``base=(T, x)``: a convecting steady state.  Returns an
        EPSResult with transformed eigenvalues."""
        self._one_process("stability_eigenvalues")
        from spectral_tpu_torch.solvers.eig import eigs, shift_invert

        Ra = self.config.Ra if Ra is None else Ra
        ctx = self._stability_ctx(base)
        lap = ctx[1]
        ksp = ksp or KSPConfig(type="gmres", rtol=1e-10, max_it=200, restart=80)
        g = self.grid

        def neg_L_shift(u):
            # -(L - sigma I) u on the interior rows, the heat operator's
            # constraint rows
            return lap.implicit_operator(u) + g.zero_boundary(sigma * u) \
                - self._stability_advective(ctx, u, Ra)

        def op_si(u):
            return ksp.solve(neg_L_shift, g.zero_boundary(-u), M=lap._pc_apply).x

        _, back = shift_invert(op_si, sigma)
        return eigs(op_si, self._start_vector(1), k=k, which="LM", m=m, tol=tol,
                    transform=back)

    # ------------------------------------------------------------------
    # Diagnostics (unit-box nondimensionalization: conductive flux = 1)
    # ------------------------------------------------------------------
    def _dTdy(self, T: torch.Tensor) -> torch.Tensor:
        return self.stokes._dif(T, self.vax)

    def _mean(self, f: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
        """sum(f W) / sum(W), both sums over the mesh on slabs (one
        reduction)."""
        s = torch.stack([torch.sum(f * W), torch.sum(W)])
        if self.slab is not None:
            s = self.slab.allreduce(s)
        return s[0] / s[1]

    def nusselt_top(self, T: torch.Tensor) -> torch.Tensor:
        """Nu = -<dT/dy> over the cold top surface (CGL index 0 is y = 1)."""
        return self._mean(-torch.select(self._dTdy(T), self.vax, 0), self._Wh)

    def nusselt_bottom(self, T: torch.Tensor) -> torch.Tensor:
        return self._mean(-torch.select(self._dTdy(T), self.vax, -1), self._Wh)

    def nusselt_volume(self, T: torch.Tensor, x: dict) -> torch.Tensor:
        """Power-balance form Nu = 1 + <v_y T> (a steady-state identity)."""
        vy = self.velocity_full(x)[..., self.vax]
        return 1.0 + self._mean(vy * T, self._W)

    def vrms(self, x: dict) -> torch.Tensor:
        v = self.velocity_full(x)
        return torch.sqrt(self._mean(torch.sum(v * v, dim=-1), self._W))

    # ------------------------------------------------------------------
    # Initial states
    # ------------------------------------------------------------------
    def conductive_state(self, amp: float = 0.0, modes=None, kind: str = "roll") -> torch.Tensor:
        """T = 1 - y plus a perturbation of amplitude ``amp``: kind='roll'
        multiplies cos(k pi x_h / L_h) over the horizontal axes by
        sin(k pi y) (the single-roll seed of the insulated regime);
        kind='sin' takes sin on every axis (zero on the whole boundary)."""
        T = self._T_cond_np.copy()
        if amp:
            modes = modes or (1,) * self.d
            pert = np.ones(self.grid.dims)
            for ax in range(self.d):
                xi = self.grid.coords_np[..., ax]
                L = self.grid.intervals[ax][1]
                if kind == "roll" and ax != self.vax:
                    pert = pert * np.cos(modes[ax] * np.pi * xi / L)
                else:
                    pert = pert * np.sin(modes[ax] * np.pi * xi / L)
            T = T + amp * pert
        if self.slab is not None:
            T = self.slab.local_np(T)
        return torch.as_tensor(T, dtype=self.grid.dtype, device=self.grid.device)
