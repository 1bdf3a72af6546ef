"""Adaptive implicit time integration: the PETSc TS / TSAdapt role.

Counterpart of ``spectral_tpu/solvers/ts.py``.  The model exposes implicit
steps that take the step size as an argument (``HeatModel.step_theta_dt``
and ``step_bdf2_dt``), preconditioned by a shift-free fast diagonalization
applied with a run-time shift, so one model serves every step size; the
controller runs on the host over states on the model's device, with the
JAX package's float arithmetic (Python floats throughout).

Scheme: variable-step BDF2 with a quadratic-predictor local error estimate
(the classic BDF device, cf. SUNDIALS CVODE / PETSc TSBDF): predict
u_{n+1} by the quadratic through the last three accepted states, estimate
the local error from the predictor-corrector gap (for uniform steps
LTE = (2/9) dt^3 u''' and the gap is (11/9) dt^3 u''', so
est = (2/11) ||u - u_pred||_WRMS), accept when est <= 1 in the weighted
RMS norm (atol + rtol |u| per node), and set the next step from the
order-3 elementary controller dt <- dt * safety * est^(-1/3).  Startup:
one backward-Euler step with a step-doubling (Richardson) estimate and an
order-2 controller.

The JAX package's ``rollout_bdf2`` is one ``lax.scan``; here it is a host
loop over the same step.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# fixed-step predictor-corrector gap -> LTE conversion (see module doc)
_BDF2_EST = 2.0 / 11.0


@dataclasses.dataclass(frozen=True)
class TSConfig:
    """Adaptive-step controls (TSAdapt 'basic' analog).

    ``grow_max`` stays well inside the variable-step BDF2 zero-stability
    bound r < 1 + sqrt(2).
    """

    rtol: float = 1e-4
    atol: float = 1e-8
    dt0: float = 1e-3
    dt_min: float = 1e-12
    dt_max: float = float("inf")
    safety: float = 0.9
    grow_max: float = 2.0
    shrink_min: float = 0.2
    max_steps: int = 10_000
    monitor: bool = False


def wrms(e: torch.Tensor, u: torch.Tensor, rtol: float, atol: float) -> float:
    """Weighted RMS error norm: accept when <= 1 (SUNDIALS convention)."""
    w = atol + rtol * torch.abs(u)
    return float(torch.sqrt(torch.mean(torch.square(e / w))))


def _combo3(ua, ub, uc, wa: float, wb: float, wc: float) -> torch.Tensor:
    return wa * ua + wb * ub + wc * uc


def _quad_predict(ts, us, t_new: float) -> torch.Tensor:
    """Value at ``t_new`` of the quadratic through the 3 (t, u) pairs;
    the Lagrange weights are host floats."""
    (ta, tb, tc), (ua, ub, uc) = ts, us
    wa = (t_new - tb) * (t_new - tc) / ((ta - tb) * (ta - tc))
    wb = (t_new - ta) * (t_new - tc) / ((tb - ta) * (tb - tc))
    wc = (t_new - ta) * (t_new - tb) / ((tc - ta) * (tc - tb))
    return _combo3(ua, ub, uc, wa, wb, wc)


def integrate_adaptive(model, u0, t0: float, t1: float, f, dirichlet,
                       config: TSConfig = TSConfig()):
    """Integrate ``model`` (a stepper with ``step_theta_dt`` and
    ``step_bdf2_dt``, e.g. HeatModel) from t0 to t1 with adaptive
    variable-step BDF2.

    ``f`` is the forcing: a tensor (autonomous) or a callable t -> tensor,
    evaluated at the step's END time (the BDF convention).  ``dirichlet``
    is the (time-independent) boundary trace.

    Returns (u, info) with info = {'steps', 'rejects', 'dts', 't'}.
    """
    f_of_t = f if callable(f) else (lambda t: f)

    def step_be(u, ff, g, dt):
        return model.step_theta_dt(u, ff, g, dt, theta=1.0)

    horizon = t1 - t0
    if not horizon > 0.0:
        raise ValueError("t1 must exceed t0")
    dt = min(config.dt0, config.dt_max, horizon)
    t = float(t0)
    u = u0
    hist = [(t, u)]           # accepted (t, u), newest last, max 3 kept
    steps = rejects = 0
    dts: list[float] = []

    def _ctrl(dt, est, order):
        fac = config.safety * est ** (-1.0 / order) if est > 0.0 \
            else config.grow_max
        fac = min(config.grow_max, max(config.shrink_min, fac))
        return max(config.dt_min, min(config.dt_max, dt * fac))

    while t < t1 - 1e-14 * horizon:
        if steps + rejects >= config.max_steps:
            raise RuntimeError(
                f"ts: max_steps={config.max_steps} exhausted at t={t:.6g} "
                f"(dt={dt:.3g}) — loosen tolerances or raise max_steps")
        dt_try = min(dt, t1 - t)
        t_new = t + dt_try
        ff = f_of_t(t_new)
        if len(hist) == 1:
            # startup: BE with a step-doubling (Richardson) estimate
            u_full = step_be(u, ff, dirichlet, dt_try)
            u_half = step_be(u, f_of_t(t + 0.5 * dt_try), dirichlet, 0.5 * dt_try)
            u_new = step_be(u_half, ff, dirichlet, 0.5 * dt_try)
            # BE local error ~ C dt^2: the halved pair leaves ~ half of it
            est = wrms(u_new - u_full, u_new, config.rtol, config.atol)
            order = 2
        else:
            rr = dt_try / (hist[-1][0] - hist[-2][0])
            u_new = model.step_bdf2_dt(u, hist[-2][1], ff, dirichlet, dt_try, rr)
            if len(hist) >= 3:
                u_pred = _quad_predict([h[0] for h in hist[-3:]],
                                       [h[1] for h in hist[-3:]], t_new)
                k = _BDF2_EST
            else:
                # one-point-short history: linear predictor (~ dt^2 u'' —
                # over-estimates BDF2's dt^3 error; conservative for the
                # single step it covers)
                w = dt_try / (hist[-1][0] - hist[-2][0])
                u_pred = _combo3(hist[-2][1], hist[-1][1], hist[-1][1], -w, w, 1.0)
                k = 0.5
            est = k * wrms(u_new - u_pred, u_new, config.rtol, config.atol)
            order = 3
        if not np.isfinite(est):
            est, accept = np.inf, False
        else:
            accept = est <= 1.0
        if accept:
            t, u = t_new, u_new
            hist.append((t, u))
            if len(hist) > 3:
                hist.pop(0)
            steps += 1
            dts.append(dt_try)
            if config.monitor:
                print(f"ts step {steps:4d}  t={t:.6g}  dt={dt_try:.4g}  "
                      f"est={est:.3g}")
        else:
            rejects += 1
            if config.monitor:
                print(f"ts REJECT      t={t:.6g}  dt={dt_try:.4g}  "
                      f"est={est:.3g}")
            # test the CONTROLLER's dt, not the horizon-clipped dt_try: a
            # rejected tiny final step (t1 - t < dt_min) should shrink and
            # retry, not raise a misleading dt_min failure
            if dt <= config.dt_min * (1 + 1e-12):
                raise RuntimeError(
                    f"ts: step rejected at dt_min={config.dt_min} "
                    f"(t={t:.6g}, est={est:.3g})")
        dt = _ctrl(dt_try, est, order) if np.isfinite(est) \
            else max(config.dt_min, dt_try * config.shrink_min)
    return u, {"steps": steps, "rejects": rejects, "dts": dts, "t": t}


def _tmap(fn, *xs):
    """fn leaf by leaf over tensors, or over dicts of tensors."""
    if isinstance(xs[0], torch.Tensor):
        return fn(*xs)
    return {k: fn(*(x[k] for x in xs)) for k in xs[0]}


def pseudo_transient_solve(residual, x0, jac_action, M_shifted, *,
                           ksp=None, dt0: float = 1.0, dt_max: float = 1e12,
                           rtol: float = 1e-8, atol: float = 0.0,
                           max_it: int = 100, ser_power: float = 1.0,
                           monitor: bool = False):
    """Pseudo-transient continuation — the PETSc TSPSEUDO role.

    Globalizes Newton on F(x) = 0 without a line search by taking
    backward-Euler steps of dx/dt = -F(x) with SER (switched evolution
    relaxation) step control:

        (I/dt_n + J(x_n)) dx = -F(x_n),
        dt_n = dt0 * (||F_0|| / ||F_n||)^ser_power  (capped at dt_max).

    Far from the solution dt is small and the identity dominates; as ||F||
    falls, dt grows and the iteration turns into Newton.  The shifted
    operator is preconditioned through ``M_shifted(r, shift)`` (e.g.
    ``lambda r, s: fd.apply(r, 0.5 * s)`` with the model's shift-free
    fast diagonalization).

    Args:
      residual: x -> (F, lin_state), the Newton residual contract.
      jac_action: (x, lin_state, w) -> J w.
      M_shifted: (r, shift) -> approx (shift + J)^{-1} r, or None.
      ksp: the inner linear solve (default gmres, rtol 1e-3).

    Returns a dict {x, fnorm, iters, history, converged}.
    """
    from spectral_tpu_torch.solvers.krylov import KSPConfig
    from spectral_tpu_torch.solvers.newton import _norm

    ksp = ksp or KSPConfig(type="gmres", rtol=1e-3, max_it=200)
    x = x0
    F, lin = residual(x)
    f0 = float(_norm(F))
    fn = f0
    history = [f0]
    converged = fn <= max(rtol * f0, atol)
    it = 0
    while not converged and it < max_it:
        dt = min(dt0 * (f0 / max(fn, 1e-300)) ** ser_power, dt_max)
        sigma = 1.0 / dt
        xc, linc = x, lin

        def op(w):
            return _tmap(lambda a, b: sigma * a + b, w, jac_action(xc, linc, w))

        M = None if M_shifted is None else (lambda r: M_shifted(r, sigma))
        res = ksp.solve(op, _tmap(lambda a: -a, F), M=M)
        xn = _tmap(lambda a, b: a + b, x, res.x)
        Fn, linn = residual(xn)
        fnn = float(_norm(Fn))
        if np.isfinite(fnn) and fnn <= 2.0 * fn:
            x, F, lin, fn = xn, Fn, linn, fnn
            history.append(fn)
        else:
            # diverging step: SER cannot shrink dt (it only tracks ||F||)
            # — back the reference step size off directly
            dt0 = 0.3 * dt0
            if dt0 < 1e-14:
                break
        it += 1
        if monitor:
            print(f"ptc {it:4d}  |F| = {fn:.6e}  dt = {dt:.3e}")
        converged = fn <= max(rtol * f0, atol)
    return {"x": x, "fnorm": fn, "iters": it, "history": history,
            "converged": bool(converged)}


def rollout_bdf2(model, u0, f, dirichlet, dt: float, nsteps: int):
    """Fixed-step BDF2 rollout: one theta startup step (the model's own
    theta — Crank-Nicolson by default keeps the startup locally order 3),
    then ``nsteps - 1`` BDF2 steps in a host loop.  ``f`` and
    ``dirichlet`` are time-independent tensors; global order 2."""
    if nsteps < 1:
        raise ValueError("nsteps must be >= 1")
    dt = float(dt)
    up, u = u0, model.step_theta_dt(u0, f, dirichlet, dt)
    for _ in range(nsteps - 1):
        up, u = u, model.step_bdf2_dt(u, up, f, dirichlet, dt, 1.0)
    return u
