"""Time-dependent (unsteady) Stokes flow (a capability extension).

Counterpart of ``spectral_tpu/models/stokes_unsteady.py``: implicit time
stepping of

    v_t - div(eta eps(v)) + grad p = f,    div v = 0,
    v|boundary = s(t) * bc_vel   (Dirichlet, scalar time modulation),

from the steady model's pieces: its strain, divergence and masks, its
saddle-point preconditioner and the shifted velocity surrogates
(``StokesConfig.mass_shift``).  The Schur complement is solved against the
shifted velocity inverse, so the pressure preconditioning follows the time
step (the Cahouet-Chabard role).

Theta scheme (0.5 Crank-Nicolson, 1 backward Euler), in the "q-form" with
sigma = 1/(theta dt) and q = p/theta, so the step operator is exactly the
mass-shifted steady Jacobian:

    [sigma I + VV   VP] [v1]   [sigma v0 - (1-theta)/theta VV v0 + fbar/theta]
    [PV              0] [q ] = [0                                            ]

BDF2: sigma = 3/(2 dt), one Crank-Nicolson startup step.  Linear
rheology: each step is one FGMRES solve of ``jacobian_action``.  Power
law: each step is a small Newton loop on the discretized residual (the
backtracking line search, no Eisenstat-Walker forcing, no step-norm test),
whose exact Jacobian is the mass-shifted steady Jacobian.

The JAX package compiles a step (and ``rollout_scan`` the whole rollout)
into one program; here every rollout is a host loop over one cached step
(its preconditioner built once).  The discrete transient adjoint
(``adjoint_gradient``, ``adjoint_gradient_checkpointed``) sweeps back
through the theta steps with one transposed saddle solve a step.
``phi`` runs the integrator on a curved domain (the strain, the Piola
divergence and the shifted metric-multigrid velocity PC come from the
steady model).  ``family_rollout`` runs B independent linear rollouts
over the shared operator and preconditioner, each step one batched
saddle solve (``KSPConfig.solve_batched`` over the steady model's
``make_pc(batched=True)``).
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np
import torch

from spectral_tpu_torch.grid import Grid
from spectral_tpu_torch.models.stokes import StokesConfig, StokesProblem


@dataclasses.dataclass(frozen=True)
class UnsteadyStokes:
    """Theta-scheme or BDF2 time integrator over a ``StokesProblem``.

    ``config`` follows the steady conventions (boundary/exact select the
    spatial data; ``outer_ksp`` is the per-step linear solve, ``newton``
    the power-law step's Newton tolerances).  Boundaries must be
    Dirichlet-type: the Neumann/mixed traction rows carry no time
    derivative.  ``scheme``: "theta" or "bdf2" (fixed step, L-stable order
    2, the same mass-shifted step operator with sigma = 3/(2 dt)).
    """

    grid: Grid
    config: StokesConfig
    dt: float
    theta: float = 0.5
    phi: object = None
    scheme: str = "theta"
    # the step on this process' slab (StokesProblem's mesh arguments):
    # states, forcings and boundary data are slabs, every solve on slabs
    mesh: object = None
    sharded_axis: int = 0
    mesh_axis: str = "x"
    axis_map: object = None
    pipeline_chunks: int = 1

    def __post_init__(self):
        if self.scheme not in ("theta", "bdf2"):
            raise ValueError(f"unknown scheme {self.scheme!r} (theta|bdf2)")
        if not (0.0 < self.theta <= 1.0):
            raise ValueError("theta must be in (0, 1]")
        if not self.dt > 0.0:
            raise ValueError("dt must be > 0")
        if self.problem.num_mixed:
            raise ValueError(
                "UnsteadyStokes requires Dirichlet-type boundaries: "
                "Neumann/mixed traction rows carry no time derivative, so "
                "the mass-shifted step algebra does not apply to them")
        if self._linear:   # the step and its PC, built once
            _ = self._step if self.scheme == "theta" else self._step_b2

    @property
    def _linear(self) -> bool:
        return self.config.rheology in (0, "linear")

    def _frozen_lin(self):
        """The linear rheology's linearization state: eta 1, deta 0, S 0."""
        p = self.problem
        dev, dt, dims = p.grid.device, p.grid.dtype, p.p_mask.shape
        return (torch.ones(dims, dtype=dt, device=dev),
                torch.zeros(dims, dtype=dt, device=dev),
                torch.zeros(dims + (p.d, p.d), dtype=dt, device=dev))

    @cached_property
    def _dense_pc(self):
        p = self.problem
        return p.make_dense_pc(lin_state=self._frozen_lin(),
                               factor="device" if p.config.saddle_pc == "dense-device"
                               else "host")

    def _saddle_pc(self, adjoint: bool = False, batched: bool = False):
        """(pc_setup, pc_apply) honoring ``config.saddle_pc``: the linear
        step operator is the SAME mass-shifted saddle Jacobian at every
        step, so 'dense'/'dense-device' invert it once (make_dense_pc at
        the frozen linear state) and each apply is one matmul.  The
        power-law Newton loops keep the nested tree: their linearization
        moves every iteration.  ``adjoint``: the PC of the transposed step
        operator (Ainv^T; the nested tree transposed).  ``batched``: over
        a batch of states (``make_pc(batched=True)``)."""
        from spectral_tpu_torch.solvers.batching import batch_map

        p = self.problem
        if p.config.saddle_pc in ("dense", "dense-device") and self._linear:
            _, fwd, adj = self._dense_pc
            apply = adj if adjoint else fwd
            return (lambda x, lin: None), (batch_map(apply, in_dims=(None, 0)) if batched
                                           else apply)
        return p.make_pc(adjoint=adjoint, batched=batched)

    @cached_property
    def sigma(self) -> float:
        if self.scheme == "bdf2":
            return 1.5 / self.dt
        return 1.0 / (self.theta * self.dt)

    @cached_property
    def problem(self) -> StokesProblem:
        return StokesProblem(self.grid, dataclasses.replace(self.config, mass_shift=self.sigma),
                             phi=self.phi, mesh=self.mesh, sharded_axis=self.sharded_axis,
                             mesh_axis=self.mesh_axis, axis_map=self.axis_map,
                             pipeline_chunks=self.pipeline_chunks)

    # -- spatial blocks on FULL velocity fields (boundary values baked) ----
    def _momentum_rows(self, vfull, params=None):
        """Masked momentum rows and linearization state: the steady model's
        viscous block, so the step residual and the mass-shifted Jacobian
        cannot drift apart."""
        p = self.problem
        return p._viscous_rows(vfull, params or p.params_at(p.config.cont))

    def _visc_rows(self, vfull, params=None):
        return self._momentum_rows(vfull, params)[0]

    def _div_full(self, vfull: torch.Tensor) -> torch.Tensor:
        """Masked continuity rows of a full field (the conservative Piola
        form on a curved domain)."""
        return self.problem._piola_div(vfull)

    def _div_rows(self, lin_state, v1_full: torch.Tensor) -> torch.Tensor:
        """The step residual's continuity rows: the trace of the strain
        _viscous_rows computed (bitwise the divergence on Cartesian grids),
        the Piola divergence on a curved domain."""
        p = self.problem
        if p.cmap is None:
            return p.project_p(p._div_from_strain(lin_state[2]))
        return p.project_p(self._div_full(v1_full))

    def _bc_ext(self, s) -> torch.Tensor:
        p = self.problem
        return torch.where(p._dirichlet_v, s * p.bc_vel, 0.0)

    def _linear_solve(self, b: dict, pc):
        """One outer solve of the frozen mass-shifted Jacobian; ``pc`` is
        ``_frozen_pc()``'s (lin_state, pc_apply, pc_state)."""
        p = self.problem
        lin_state, pc_apply, pc_state = pc
        return p.config.outer_ksp.solve(
            lambda w: p.jacobian_action(None, lin_state, w), b,
            M=lambda r: pc_apply(pc_state, r), null_project=p.null_project,
            reduce=p._reduce)

    def _frozen_pc(self):
        lin_state = self._frozen_lin()
        pc_setup, pc_apply = self._saddle_pc()
        return lin_state, pc_apply, pc_setup(None, lin_state)

    def _step_fn(self, nb: int | None = None):
        """(v0_full, s1, fbar) -> (v1_full, p1, iters, rnorm), over the PC
        built here once.  With ``nb``, the same step over a batch of ``nb``
        states (``s1`` a (nb,) tensor): its loop-free blocks mapped over
        the batch, one batched outer solve, iters and rnorm per member."""
        from spectral_tpu_torch.solvers.batching import batch_map

        p, th, sigma = self.problem, self.theta, self.sigma
        lin = self._frozen_lin()
        pc_setup, pc_apply = self._saddle_pc(batched=nb is not None)
        ksp = p.config.outer_ksp
        if nb is None:
            pc_state = pc_setup(None, lin)

            def solve(A, b, **kw):
                return ksp.solve(A, b, reduce=p._reduce, **kw)

            def lift(f):
                return f
        else:
            pc_state = pc_setup(None, tuple(t.expand((nb,) + t.shape) for t in lin))

            def solve(A, b, **kw):
                return ksp.solve_batched(A, b, batched=True, **kw)

            lift = batch_map
        visc, div, null = lift(self._visc_rows), lift(self._div_full), lift(p.null_project)
        jac = lift(lambda w: p.jacobian_action(None, lin, w))

        def step(v0_full, s1, fbar):
            R = sigma * v0_full - ((1.0 - th) / th) * visc(v0_full) + fbar / th
            if nb is not None:   # one modulation a member
                s1 = s1.to(v0_full.dtype).reshape((nb,) + (1,) * (v0_full.ndim - 1))
            bc1 = self._bc_ext(s1)
            # the unknowns' boundary coupling is the NONLOCAL viscous and
            # divergence action of the bc extension (the mass term is
            # diagonal: nothing on the interior rows)
            b = {"v": p.mask_v(R) - visc(bc1), "p": -div(bc1)}
            res = solve(jac, b, M=lambda r: pc_apply(pc_state, r), null_project=null)
            v1_full = bc1 + p.mask_v(res.x["v"])
            return v1_full, th * p.mask_p(res.x["p"]), res.iters, res.rnorm

        return step

    @cached_property
    def _step(self):
        return self._step_fn()

    def _step_residual(self, x, v0_full, params, s1, fbar, N0=None):
        """The theta-discretized step residual in the q-form, (F,
        lin_state).  ``N0`` optionally injects the previous state's viscous
        rows (the Newton loop computes them once a step)."""
        p, th, sigma = self.problem, self.theta, self.sigma
        bc1 = self._bc_ext(s1)
        v1_full = bc1 + p.mask_v(x["v"])
        N1, lin_state = p._viscous_rows(v1_full, params)
        if N0 is None:
            N0 = p._viscous_rows(v0_full, params)[0]
        Fv = (p.mask_v(sigma * (v1_full - v0_full)) + N1
              + ((1.0 - th) / th) * N0 - fbar / th + p.pressure_gradient(x["p"]))
        return {"v": Fv, "p": self._div_rows(lin_state, v1_full)}, lin_state

    def _newton_loop(self, residual, x0, pc_setup, pc_apply):
        """The Newton-on-step loop shared by the theta and BDF2 power-law
        steps: backtracking line search, the problem's Newton tolerances
        (rtol, atol, max_it), around the mass-shifted saddle solve.
        Returns (x, fnorm, total outer iterations)."""
        from spectral_tpu_torch.solvers.newton import _line_search_bt, _norm

        p, ncfg, ksp = self.problem, self.config.newton, self.config.outer_ksp
        red = p._reduce
        x, (F, lst) = x0, residual(x0)
        fnorm = float(_norm(F, red))
        floor = max(ncfg.rtol * fnorm, ncfg.atol)
        it = its = 0
        ok = True
        while ok and fnorm > floor and it < ncfg.max_it and np.isfinite(fnorm):
            pc_state = pc_setup(x, lst)
            xc, lc = x, lst
            lres = ksp.solve(lambda w: p.jacobian_action(xc, lc, w), F,
                             M=lambda r: pc_apply(pc_state, r), null_project=p.null_project,
                             reduce=red)
            (x, F, lst, (fnorm, _, _)), ok = _line_search_bt(
                residual, x, lres.x, fnorm, _norm(lres.x, red), ncfg, red)
            it += 1
            its += int(lres.iters)
        return x, fnorm, its

    @cached_property
    def _newton_pc(self):
        return self.problem.make_pc()

    def _step_newton(self, v0_full, s1, fbar, x0=None):
        """Power-law step: Newton on the theta-discretized residual in the
        q-form (its exact Jacobian is the mass-shifted jacobian_action)."""
        p, th = self.problem, self.theta
        params = p.params_at(p.config.cont)
        if x0 is None:
            x0 = {"v": p.mask_v(v0_full), "p": torch.zeros_like(v0_full[..., 0])}
        N0 = p._viscous_rows(v0_full, params)[0]
        x, fnorm, its = self._newton_loop(
            lambda x: self._step_residual(x, v0_full, params, s1, fbar, N0=N0), x0,
            *self._newton_pc)
        v1_full = self._bc_ext(s1) + p.mask_v(x["v"])
        return v1_full, th * p.mask_p(x["p"]), its, fnorm

    def step(self, v0_full, s1: float, fbar):
        """Advance one step.  ``v0_full`` is the full velocity field at t0
        (boundary values included), ``s1`` the boundary modulation at t1,
        ``fbar`` the theta-weighted momentum forcing
        theta f(t1) + (1-theta) f(t0) (masked rows)."""
        if self.scheme != "theta":
            raise ValueError("scheme='bdf2': use step_bdf2 / rollout")
        if self._linear:
            return self._step(v0_full, float(s1), fbar)
        return self._step_newton(v0_full, float(s1), fbar)

    # ------------------------------------------------------------------
    # BDF2: sigma = 3/(2 dt), pressure weight 1 (no q-scaling), history
    # enters algebraically only
    # ------------------------------------------------------------------
    @cached_property
    def _startup(self) -> "UnsteadyStokes":
        """Crank-Nicolson integrator for the BDF2 startup step (locally
        order 3, so BDF2's global order 2 is kept)."""
        return UnsteadyStokes(self.grid, self.config, self.dt, theta=0.5, phi=self.phi,
                              scheme="theta")

    def _step_fn_bdf2(self):
        """(v0_full, vm1_full, s1, f1) -> (v1_full, p1, iters, rnorm);
        sigma lives inside ``jacobian_action`` (config.mass_shift)."""
        p, dt = self.problem, self.dt
        pc = self._frozen_pc()

        def step(v0_full, vm1_full, s1, f1):
            R = (4.0 * v0_full - vm1_full) / (2.0 * dt)
            bc1 = self._bc_ext(s1)
            b = {"v": p.mask_v(R) + f1 - self._visc_rows(bc1), "p": -self._div_full(bc1)}
            res = self._linear_solve(b, pc)
            v1_full = bc1 + p.mask_v(res.x["v"])
            return v1_full, p.mask_p(res.x["p"]), res.iters, res.rnorm

        return step

    @cached_property
    def _step_b2(self):
        return self._step_fn_bdf2()

    def _step_residual_bdf2(self, x, v0_full, vm1_full, params, s1, f1):
        """BDF2 step residual, (F, lin_state); its exact Jacobian in x is
        the mass-shifted ``jacobian_action`` with sigma = 3/(2 dt)."""
        p, sigma, dt = self.problem, self.sigma, self.dt
        bc1 = self._bc_ext(s1)
        v1_full = bc1 + p.mask_v(x["v"])
        N1, lin_state = p._viscous_rows(v1_full, params)
        Fv = (p.mask_v(sigma * v1_full - (4.0 * v0_full - vm1_full) / (2.0 * dt))
              + N1 - f1 + p.pressure_gradient(x["p"]))
        return {"v": Fv, "p": self._div_rows(lin_state, v1_full)}, lin_state

    def step_bdf2(self, v0_full, vm1_full, s1: float, f1, x0=None):
        """Advance one BDF2 step from (v_{n-1}, v_n) to v_{n+1}.  ``s1``
        is the boundary modulation at t1, ``f1`` the momentum forcing at
        t1 (masked rows): BDF evaluates everything at the step's end."""
        if self.scheme != "bdf2":
            raise ValueError("step_bdf2 requires scheme='bdf2'")
        p, s1 = self.problem, float(s1)
        if self._linear:
            return self._step_b2(v0_full, vm1_full, s1, f1)
        params = p.params_at(p.config.cont)
        if x0 is None:
            x0 = {"v": p.mask_v(v0_full), "p": torch.zeros_like(v0_full[..., 0])}
        x, fnorm, its = self._newton_loop(
            lambda x: self._step_residual_bdf2(x, v0_full, vm1_full, params, s1, f1), x0,
            *self._newton_pc)
        v1_full = self._bc_ext(s1) + p.mask_v(x["v"])
        return v1_full, p.mask_p(x["p"]), its, fnorm

    def rollout(self, v0_full, times, s_of_t, f_of_t, keep_trajectory: bool = False):
        """Integrate over ``times`` (t0..tN): returns (v_full, p, iters),
        or (trajectory, p, iters) with the full [v_0..v_N] list when
        ``keep_trajectory``.  ``s_of_t(t) -> float`` modulates the
        Dirichlet data; ``f_of_t(t)`` returns the masked momentum forcing,
        evaluated on the host's schedule each step."""
        if self.scheme == "bdf2":
            steps = np.diff(np.asarray(times, float))
            if steps.size and np.abs(steps - steps[0]).max() > 1e-12 * abs(steps[0]):
                raise ValueError("scheme='bdf2' (fixed sigma) needs uniform times")
        v, vprev, pres, its, traj = v0_full, None, None, [], [v0_full]
        for t0, t1 in zip(times[:-1], times[1:]):
            if self.scheme == "bdf2" and vprev is not None:
                vn, pres, it, _ = self.step_bdf2(v, vprev, s_of_t(t1), f_of_t(t1))
            else:
                stepper = self._startup if self.scheme == "bdf2" else self
                # the STEPPER's theta weights the forcing: the BDF2 startup
                # is Crank-Nicolson whatever theta this model has
                fbar = stepper.theta * f_of_t(t1) + (1.0 - stepper.theta) * f_of_t(t0)
                vn, pres, it, _ = stepper.step(v, s_of_t(t1), fbar)
            vprev, v = v, vn
            its.append(int(it))
            if keep_trajectory:
                traj.append(v)
        if keep_trajectory:
            return traj, pres, its
        return v, pres, its

    def adjoint_gradient(self, qoi, traj, times, s_of_t, f_of_t, *, params=None, ksp=None):
        """Discrete transient adjoint: d/dparams qoi(v_N) through every
        implicit theta step, one transposed mass-shifted saddle solve a
        step in a reverse sweep, preconditioned by ``_saddle_pc(adjoint=
        True)``, with the parameter and prior-state contractions as vjps of
        the same step residual the forward Newton loop solves.  The cost
        does not grow with the number of parameters (reverse mode).

        ``traj``: [v_0..v_N] from ``rollout(..., keep_trajectory=True)``.
        Boundary and forcing data are taken as independent of the
        parameters; ``qoi`` maps the final full velocity field to a scalar.
        Returns (grad_params, adjoint iterations a step, in reverse
        order)."""
        p = self.problem
        params = params if params is not None else p.params_at(p.config.cont)
        ksp = ksp or p.config.outer_ksp
        w = torch.func.grad(qoi)(traj[-1])
        _, gtheta, its = self._adjoint_sweep(w, self._zero_grad(params, traj[-1]), traj, times,
                                             s_of_t, f_of_t, params, ksp)
        return gtheta, its

    @staticmethod
    def _zero_grad(params, like: torch.Tensor):
        """Zeros in params' structure: float64 0-d tensors on like's device."""
        import torch.utils._pytree as pytree

        return pytree.tree_map(lambda a: torch.zeros((), dtype=torch.float64,
                                                     device=like.device), params)

    def _adjoint_sweep(self, w, gtheta, traj, times, s_of_t, f_of_t, params, ksp):
        """Reverse sweep over one contiguous span of steps: carry the state
        cotangent ``w`` back through traj[-1] .. traj[0] (``times``
        aligned with traj), accumulating the parameter gradient.  Returns
        (w at traj[0], gtheta, iterations in reverse order)."""
        import torch.utils._pytree as pytree

        from spectral_tpu_torch.solvers.adjoint import _like, as_tensors

        p, th = self.problem, self.theta
        params = as_tensors(params, traj[-1].device)
        pc_setup, pc_apply = self._saddle_pc(adjoint=True)
        zero_p = torch.zeros(p.grid.dims, dtype=traj[-1].dtype, device=traj[-1].device)
        its = []
        for k in range(len(traj) - 1, 0, -1):
            v1_full, v0_full = traj[k], traj[k - 1]
            s1 = float(s_of_t(times[k]))
            fbar = th * f_of_t(times[k]) + (1.0 - th) * f_of_t(times[k - 1])
            # q is a placeholder: the residual is linear in q, so its
            # derivatives in z, v0 and the parameters at the true v1 do not
            # depend on the value
            z_star = {"v": p.mask_v(v1_full), "p": zero_p}
            # two separate vjps by design: the z-only vjp keeps every Krylov
            # iteration's backward pass free of the v0 and parameter
            # branches; the (v0, params) vjp runs once a step below
            F, vjp_z, lin_state = torch.func.vjp(
                lambda z: self._step_residual(z, v0_full, params, s1, fbar),
                z_star, has_aux=True)
            pc_state = pc_setup(None, lin_state)
            res = ksp.solve(lambda lam: vjp_z(_like(F, lam))[0],
                            {"v": p.mask_v(w), "p": zero_p},
                            M=lambda r: pc_apply(pc_state, r), null_project=p.null_project)
            its.append(int(res.iters))
            F, vjp_v0p = torch.func.vjp(
                lambda v0, prm: self._step_residual(z_star, v0, prm, s1, fbar)[0],
                v0_full, params)
            dv0, dparams = vjp_v0p(_like(F, res.x))
            gtheta = pytree.tree_map(torch.sub, gtheta, dparams)
            w = -dv0
        return w, gtheta, its

    def adjoint_gradient_checkpointed(self, qoi, v0_full, times, s_of_t, f_of_t, *,
                                      params=None, ksp=None, segments: int | None = None):
        """``adjoint_gradient`` in bounded memory: uniform sqrt-T
        checkpointing (Griewank's revolve at one level).  The forward sweep
        keeps only the ``segments + 1`` segment-boundary states (default
        segments = ceil(sqrt(N)), so O(sqrt N) states where
        ``adjoint_gradient`` keeps the O(N) trajectory); the reverse sweep
        integrates each segment forward again (keeping its trajectory
        only) and runs ``_adjoint_sweep`` over it: twice the forward
        solves, the same adjoint solves.

        Runs the forward integration itself.  Returns (grad_params, info),
        info = {iters (the adjoint counts a step, reversed), peak_states
        (most states held at once), forward_steps (forward solves,
        recomputation included), qoi (the objective), segments}."""
        if self.scheme != "theta":
            raise ValueError("checkpointed adjoint covers the theta scheme "
                             "(the step residual the sweeps transpose)")
        p = self.problem
        params = params if params is not None else p.params_at(p.config.cont)
        ksp = ksp or p.config.outer_ksp
        N = len(times) - 1
        if N < 1:
            raise ValueError("need at least one step")
        segments = int(segments) if segments else max(1, int(np.ceil(np.sqrt(N))))
        bounds = np.unique(np.round(np.linspace(0, N, segments + 1)).astype(int))

        # forward sweep: keep only the boundary states
        boundary_states = {0: v0_full}
        v = v0_full
        forward_steps = 0
        for b0, b1 in zip(bounds[:-1], bounds[1:]):
            v, _, its_f = self.rollout(v, times[b0:b1 + 1], s_of_t, f_of_t)
            forward_steps += len(its_f)
            boundary_states[int(b1)] = v

        qoi_val = float(qoi(v))
        w = torch.func.grad(qoi)(v)
        gtheta = self._zero_grad(params, v)
        its = []
        peak = len(boundary_states)
        for i in range(len(bounds) - 1, 0, -1):
            b0, b1 = int(bounds[i - 1]), int(bounds[i])
            seg_traj, _, its_f = self.rollout(boundary_states[b0], times[b0:b1 + 1], s_of_t,
                                              f_of_t, keep_trajectory=True)
            forward_steps += len(its_f)
            peak = max(peak, len(boundary_states) + len(seg_traj))
            w, gtheta, its_seg = self._adjoint_sweep(w, gtheta, seg_traj, times[b0:b1 + 1],
                                                     s_of_t, f_of_t, params, ksp)
            its.extend(its_seg)
            del boundary_states[b1]
        info = {"iters": its, "peak_states": peak, "forward_steps": forward_steps,
                "qoi": qoi_val, "segments": len(bounds) - 1}
        return gtheta, info

    def family_rollout(self, v0s, s_values, fbars, *, mesh=None, mesh_axis: str = "x"):
        """A batch of independent linear integrations (distinct initial
        states, boundary modulations and forcings) over the shared operator
        and PC: each step is one batched saddle solve, every member keeping
        its own Krylov state and count.

        ``v0s``: (B, dims..., d); ``s_values``: (B, nsteps); ``fbars``:
        (B, nsteps, dims..., d).  Returns (v_finals, p_finals, iters
        (B, nsteps) int32).  ``mesh`` cuts the batch over mesh axis
        ``mesh_axis`` (a dp axis: each process integrates its B / P
        members, every process gets the whole result); the integrator
        itself is a one-process one."""
        if not self._linear:
            raise ValueError("family_rollout is the linear fast path")
        if mesh is not None and mesh.size(mesh_axis) > 1:
            from spectral_tpu_torch.solvers.batching import dp_cut, dp_gather

            sl = dp_cut(len(v0s), mesh, mesh_axis)
            out = self.family_rollout(v0s[sl], torch.as_tensor(s_values)[sl], fbars[sl])
            return tuple(dp_gather(t, mesh, mesh_axis) for t in out)
        s_values = torch.as_tensor(s_values, dtype=torch.float64)
        nb, nsteps = s_values.shape
        steps = self.__dict__.setdefault("_family_steps", {})   # one a batch size
        step = steps[nb] if nb in steps else steps.setdefault(nb, self._step_fn(nb))
        v = v0s
        pl = torch.zeros_like(v0s[..., 0])
        its = []
        for j in range(nsteps):
            v, pl, it, _ = step(v, s_values[:, j].to(v.device), fbars[:, j])
            its.append(np.asarray(it))
        return v, pl, torch.as_tensor(np.stack(its, axis=1), dtype=torch.int32)

    def rollout_scan(self, v0_full, s_values, fbars):
        """The linear rollout over precomputed per-step data, with the JAX
        package's signature (one ``lax.scan`` there, a host loop over the
        cached step here).  ``s_values``: (nsteps,) boundary modulations
        at t1..tN; ``fbars``: (nsteps, dims..., d) theta-weighted forcings.
        Returns (v_full_final, p_final, iters per step as an int32
        tensor)."""
        if not self._linear:
            raise ValueError("rollout_scan is the linear fast path; "
                             "use rollout for power-law rheology")
        v = v0_full
        pl = torch.zeros_like(v0_full[..., 0])
        its = []
        for s1, fb in zip(s_values, fbars):
            v, pl, it, _ = self._step(v, float(s1), fb)
            its.append(int(it))
        return v, pl, torch.tensor(its, dtype=torch.int32)

    def rollout_scan_bdf2(self, v0_full, s_values, f1s, fbar0):
        """The linear BDF2 rollout over precomputed data: one
        Crank-Nicolson startup step (``fbar0``, the theta-weighted forcing
        of the first interval), then BDF2 steps.  ``s_values``: (nsteps,)
        modulations at t1..tN; ``f1s``: (nsteps-1, ...) end-of-step
        forcings at t2..tN.  Returns (v, p, iters)."""
        if not self._linear:
            raise ValueError("rollout_scan_bdf2 is the linear fast path; "
                             "use rollout for power-law rheology")
        if self.scheme != "bdf2":
            raise ValueError("rollout_scan_bdf2 requires scheme='bdf2'")
        vp = v0_full
        v, pl, it0, _ = self._startup._step(v0_full, float(s_values[0]), fbar0)
        its = [int(it0)]
        for s1, f1 in zip(s_values[1:], f1s):
            vn, pl, it, _ = self._step_b2(v, vp, float(s1), f1)
            vp, v = v, vn
            its.append(int(it))
        return v, pl, torch.tensor(its, dtype=torch.int32)

    # -- manufactured time-dependent solution (test/demo oracle) -----------
    def manufactured(self, omega: float = 1.0):
        """u(x,t) = cos(omega t) u0(x), p(x,t) = cos(omega t) p0(x) with
        (u0, p0) the problem's exact steady solution; the forcing is built
        from the DISCRETE operators, so the semi-discrete momentum rows
        hold exactly and the measured error is the time integration's
        (plus the spectrally small discrete divergence of u0).

        Returns (v0_full, s_of_t, f_of_t, u_full_of_t, p_of_t)."""
        p = self.problem
        params = p.params_at(p.config.cont)
        u0 = torch.where(p._dirichlet_v, p.bc_vel, p.exact_v)
        p0 = p.exact_p
        gradp0 = p.pressure_gradient(p0)
        u0_rows = p.mask_v(u0)

        def s_of_t(t):
            return float(np.cos(omega * t))

        def f_of_t(t):
            # N is nonlinear in general: evaluate it at the SCALED field
            c = float(np.cos(omega * t))
            return (-omega * float(np.sin(omega * t))) * u0_rows + \
                self._visc_rows(c * u0, params) + c * gradp0

        def u_full_of_t(t):
            return float(np.cos(omega * t)) * u0

        def p_of_t(t):
            return float(np.cos(omega * t)) * p0

        return u0, s_of_t, f_of_t, u_full_of_t, p_of_t
