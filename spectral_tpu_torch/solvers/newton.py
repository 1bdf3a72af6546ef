"""Newton-Krylov nonlinear solver: the PETSc SNES replacement.

Counterpart of ``spectral_tpu/solvers/newton.py`` for ``newton_solve``
(line-search Newton with Eisenstat-Walker forcing and a lagged
preconditioner):

- the residual returns ``(F, lin_state)`` and the Jacobian action and the
  PC setup consume ``lin_state``: the linearization state is threaded
  explicitly (elliptic.C:544-548 leaves it to call order);
- without a Jacobian action the step uses ``torch.func.jvp`` of the
  residual (JFNK, the reference's ``-snes_mf``);
- line search: backtracking with Armijo sufficient decrease ("bt"), the
  full step ("basic"), or a user callable;
- a state is a tensor or a dict of tensors (the Stokes state); norms run
  over every leaf, updates leaf by leaf.

The JAX package compiles one Newton step; here the step runs eagerly.
Every line-search trial makes one host transfer, which carries the trial's
residual norm, the step norm and the new iterate's norm together: a Newton
step whose full step is accepted synchronises once beyond its Krylov solve
(the single ``device_get`` of the JAX step).

``make_fused_newton`` gives the JAX package's whole-solve interface (one
compiled ``while_loop`` there) over this loop: the stopping test and the
forcing in the state's dtype, the histories as -1-padded tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from spectral_tpu_torch.solvers.krylov import KSPConfig
from spectral_tpu_torch.solvers.types import ConvergedReason


def _norm(x) -> torch.Tensor:
    """2-norm of a tensor, or over every leaf of a dict of tensors (sorted
    key order, as the JAX package sums a pytree's leaves); a 0-d tensor."""
    if isinstance(x, torch.Tensor):
        return torch.linalg.vector_norm(x.reshape(-1))
    return torch.sqrt(sum(torch.dot(x[k].reshape(-1), x[k].reshape(-1))
                          for k in sorted(x)))


def _step(x, dx, lam: float):
    """x - lam dx on tensors, or leaf by leaf on dicts of tensors."""
    if isinstance(x, torch.Tensor):
        return x - lam * dx
    return {k: x[k] - lam * dx[k] for k in x}


@dataclasses.dataclass
class NewtonResult:
    x: Any
    iters: int
    reason: int
    fnorm: float
    fnorm_history: list[float]
    ksp_iters: list[int]
    lin_state: Any = None
    ksp_history_last: list[float] = dataclasses.field(default_factory=list)

    def reason_str(self) -> str:
        return ConvergedReason.describe(self.reason)


@dataclasses.dataclass(frozen=True)
class NewtonConfig:
    """SNES-like configuration (defaults match PETSc SNESNEWTONLS)."""

    rtol: float = 1e-8
    atol: float = 1e-50
    stol: float = 1e-8
    max_it: int = 50
    # "bt" | "basic" | a callable (residual_fn, x, dx, fnorm) -> (x, F,
    # lin_state, fnorm, ok), with fnorm a float (nk.c:117 SNESSetLineSearch)
    line_search: Any = "bt"
    ls_alpha: float = 1e-4    # sufficient-decrease parameter
    ls_max_steps: int = 12
    monitor: bool = False
    recycle: int = 0          # Krylov recycling: not ported (raises if > 0)
    # Eisenstat-Walker inexact-Newton forcing (PETSc -snes_ksp_ew, choice 2)
    ksp_ew: bool = False
    ew_eta0: float = 0.3
    ew_etamax: float = 0.9
    ew_gamma: float = 1.0
    ew_alpha: float = 1.61803398875   # (1+sqrt(5))/2
    # -snes_lag_preconditioner: rebuild the PC state every pc_lag Newton
    # steps (1 = every step); the Jacobian action is always current
    pc_lag: int = 1

    def __post_init__(self):
        if int(self.pc_lag) < 1:
            raise ValueError(f"NewtonConfig: pc_lag must be >= 1, got {self.pc_lag}")


def _unported(name: str, item: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(f"{name} is not ported yet (ROADMAP.md queue 1, {item})")

    fn.__name__ = name
    return fn


newton_tr_solve = _unported("newton_tr_solve", "item 2")
quasi_newton_solve = _unported("quasi_newton_solve", "item 2")
anderson_solve = _unported("anderson_solve", "item 2")
ngmres_solve = _unported("ngmres_solve", "item 2")
newton_solve_family = _unported("newton_solve_family", "item 7")


def _trial(residual_fn, x, dx, lam: float, dxnorm: torch.Tensor):
    """x - lam dx and its residual; one host transfer returns
    (fnorm, dxnorm, xnorm) as floats."""
    xt = _step(x, dx, lam)
    Ft, lst = residual_fn(xt)
    host = torch.stack([_norm(Ft), dxnorm, _norm(xt)]).cpu().tolist()
    return xt, Ft, lst, host


def _line_search_bt(residual_fn, x, dx, fnorm0: float, dxnorm, cfg: NewtonConfig):
    """Backtracking on ||F|| with sufficient decrease: lambda = 1, 1/2,
    1/4, ... until accepted or ``ls_max_steps`` trials.  Returns the last
    trial (x, F, lin_state, [fnorm, dxnorm, xnorm]) and whether it was
    accepted."""
    lam = 1.0
    for tries in range(cfg.ls_max_steps):
        if tries:
            lam *= 0.5
        best = _trial(residual_fn, x, dx, lam, dxnorm)
        fn = best[3][0]
        ok = bool(np.isfinite(fn) and fn <= (1.0 - cfg.ls_alpha * lam) * fnorm0)
        if ok:
            break
    return best, ok


def newton_solve(
    residual_fn: Callable[[Any], tuple[Any, Any]],
    x0,
    *,
    jacobian_action: Optional[Callable[[Any, Any, Any], Any]] = None,
    pc_setup: Optional[Callable[[Any, Any], Any]] = None,
    pc_apply: Optional[Callable[[Any, Any], Any]] = None,
    ksp: KSPConfig = KSPConfig(type="gmres", rtol=1e-5),
    config: NewtonConfig = NewtonConfig(),
    null_project: Optional[Callable] = None,
    callback: Optional[Callable] = None,
    control_dtype: Optional[torch.dtype] = None,
) -> NewtonResult:
    """Solve F(x) = 0 by Newton-Krylov.

    Args:
      residual_fn: x -> (F(x), lin_state).
      x0: initial guess, a tensor or a dict of tensors (its dtype and
        device are the solve's).
      jacobian_action: (x, lin_state, w) -> J(x) @ w; defaults to jvp (JFNK).
      pc_setup: (x, lin_state) -> pc_state (PCSetUp analog).
      pc_apply: (pc_state, r) -> z (PCApply analog).
      ksp: linear solver configuration.
      config: Newton configuration.
      null_project: null-space projector for the linear solves.
      callback: optional host hook (it, x, fnorm).
      control_dtype: the dtype of the stopping test and the EW forcing;
        None computes them in Python floats (the JAX package's host loop),
        make_fused_newton passes the state's (its compiled loop).
    """
    if config.recycle > 0:
        raise NotImplementedError(
            "NewtonConfig(recycle > 0): Krylov recycling is not ported yet "
            "(ROADMAP.md queue 1, item 1b: solve_recycled)")
    if jacobian_action is None:
        def jacobian_action(x, lin_state, w):  # noqa: F811  (JFNK via jvp)
            return torch.func.jvp(lambda z: residual_fn(z)[0], (x,), (w,))[1]

    sc = float if control_dtype is None else torch.empty(0, dtype=control_dtype).numpy().dtype.type
    lagging = config.pc_lag > 1 and pc_setup is not None
    x = x0
    F, lin_state = residual_fn(x)
    fnorm = sc(_norm(F).item())
    fnorm0 = max(fnorm, sc(1e-300))
    hist = [float(fnorm)]
    ksp_iters: list[int] = []
    ksp_history_last: list[float] = []
    reason = int(ConvergedReason.ITERATING)
    newton_its = 0
    eta_prev = None
    fnorm_prev = None
    pc_state = None

    for it in range(config.max_it + 1):
        newton_its = it
        if callback:
            callback(it, x, fnorm)
        if config.monitor:
            print(f"{it:3d} SNES Function norm {fnorm:.12e}")
        if fnorm <= sc(config.atol):
            reason = int(ConvergedReason.CONVERGED_ATOL)
            break
        if fnorm <= sc(config.rtol) * fnorm0:
            reason = int(ConvergedReason.CONVERGED_RTOL)
            break
        if not np.isfinite(fnorm):
            reason = int(ConvergedReason.DIVERGED_NANORINF)
            break
        if it == config.max_it:
            reason = int(ConvergedReason.DIVERGED_ITS)
            break

        if pc_setup is not None and (not lagging or it % config.pc_lag == 0):
            pc_state = pc_setup(x, lin_state)

        lin_rtol = sc(ksp.rtol)
        if config.ksp_ew:
            # Eisenstat-Walker choice 2 (PETSc SNESKSPSetUseEW defaults):
            # eta_k = gamma (|F_k|/|F_{k-1}|)^alpha, safeguarded by
            # gamma eta_{k-1}^alpha when that is still > 0.1, capped by
            # eta_max, floored so the last step still reaches the
            # nonlinear tolerance.
            if eta_prev is None:
                eta = sc(config.ew_eta0)
            else:
                eta = sc(config.ew_gamma) * (fnorm / fnorm_prev) ** sc(config.ew_alpha)
                guard = sc(config.ew_gamma) * eta_prev ** sc(config.ew_alpha)
                if guard > sc(0.1):
                    eta = max(eta, guard)
            eta = min(eta, sc(config.ew_etamax))
            eta = max(eta, sc(0.5) * sc(config.rtol) * fnorm0 / fnorm)
            eta = min(eta, sc(config.ew_etamax))
            lin_rtol = max(eta, sc(ksp.rtol))
            eta_prev = lin_rtol
        fnorm_prev = fnorm

        # the linear solve about the current linearization
        st = pc_state
        M = (lambda r: pc_apply(st, r)) if pc_apply is not None else None
        xc, lsc = x, lin_state
        lres = dataclasses.replace(ksp, rtol=lin_rtol).solve(
            lambda w: jacobian_action(xc, lsc, w), F, M=M, null_project=null_project)
        dx = lres.x
        dxnorm = _norm(dx)
        if callable(config.line_search):
            x, F, lin_state, fn, ok = config.line_search(residual_fn, x, dx, float(fnorm))
            fnorm, ok = float(fn), bool(ok)
            dxn, xnorm = torch.stack([dxnorm, _norm(x)]).cpu().tolist()
        elif config.line_search == "basic":
            x, F, lin_state, (fnorm, dxn, xnorm) = _trial(residual_fn, x, dx, 1.0, dxnorm)
            ok = bool(np.isfinite(fnorm))
        elif config.line_search == "bt":
            (x, F, lin_state, (fnorm, dxn, xnorm)), ok = _line_search_bt(
                residual_fn, x, dx, float(fnorm), dxnorm, config)
        else:
            raise ValueError(f"unknown line search {config.line_search!r}")
        fnorm = sc(fnorm)
        ksp_iters.append(int(lres.iters))
        ksp_history_last = lres.history_list()
        hist.append(float(fnorm))
        if config.line_search != "basic" and not ok:
            newton_its = it + 1
            reason = int(ConvergedReason.DIVERGED_LINE_SEARCH)
            break
        if sc(dxn) <= sc(config.stol) * max(sc(xnorm), sc(1e-30)):
            newton_its = it + 1
            reason = int(ConvergedReason.CONVERGED_SNORM_RELATIVE)
            break

    return NewtonResult(x=x, iters=newton_its, reason=reason, fnorm=float(fnorm),
                        fnorm_history=hist, ksp_iters=ksp_iters,
                        lin_state=lin_state, ksp_history_last=ksp_history_last)


def make_fused_newton(
    residual_fn: Callable[[Any, Any], tuple[Any, Any]],
    *,
    jacobian_action: Optional[Callable[[Any, Any, Any], Any]] = None,
    pc_setup: Optional[Callable[[Any, Any], Any]] = None,
    pc_apply: Optional[Callable[[Any, Any], Any]] = None,
    ksp: KSPConfig = KSPConfig(type="gmres", rtol=1e-5),
    config: NewtonConfig = NewtonConfig(),
    null_project: Optional[Callable] = None,
):
    """The JAX package's whole-solve Newton interface over ``newton_solve``.

    ``residual_fn(x, theta)`` takes the parameter explicitly, so one solver
    serves a parameter schedule.  Returns ``run(x0, theta) -> (x, fnorm,
    fnorm0, iters, kits_hist, fnorm_hist, reason)``: x on x0's device,
    fnorm and fnorm0 floats, the Krylov counts (int32, ``max_it``) and the
    residual norms (x's dtype, ``max_it + 1``) as tensors on x0's device
    padded with -1.

    The JAX package compiles this solve into one ``while_loop``; eager
    PyTorch has nothing to fuse it into, so ``run`` is ``newton_solve``
    under the JAX loop's rules: the stopping test and the Eisenstat-Walker
    forcing in the state's dtype, no monitor, no recycling.  The control
    flow and its scalars are the host loop's; the iterate and the residual
    stay on x0's device."""
    if config.recycle > 0:
        raise ValueError("Krylov recycling is host-loop-only (newton_solve)")
    config = dataclasses.replace(config, monitor=False)

    def run(x0, theta):
        leaf = x0 if isinstance(x0, torch.Tensor) else x0[sorted(x0)[0]]
        res = newton_solve(lambda z: residual_fn(z, theta), x0,
                           jacobian_action=jacobian_action, pc_setup=pc_setup,
                           pc_apply=pc_apply, ksp=ksp, config=config,
                           null_project=null_project, control_dtype=leaf.dtype)
        kits = torch.full((config.max_it,), -1, dtype=torch.int32)
        kits[:len(res.ksp_iters)] = torch.tensor(res.ksp_iters, dtype=torch.int32)
        hist = torch.full((config.max_it + 1,), -1.0, dtype=leaf.dtype)
        hist[:len(res.fnorm_history)] = torch.tensor(res.fnorm_history, dtype=leaf.dtype)
        return (res.x, res.fnorm, max(res.fnorm_history[0], 1e-300), res.iters,
                kits.to(leaf.device), hist.to(leaf.device), res.reason)

    return run
