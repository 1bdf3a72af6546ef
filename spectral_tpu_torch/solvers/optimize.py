"""Unconstrained and bound-constrained minimization over parameter
pytrees: the TAO role.

Counterpart of ``spectral_tpu/solvers/optimize.py``.  The adjoint
machinery (``solvers/adjoint.py``: one linear solve a gradient, two a
Hessian-vector product) exists to feed an optimizer; this module closes
the loop:

- ``lbfgs_minimize``: limited-memory BFGS (TaoLMVM): the two-loop
  recursion with a gamma-scaled H0, curvature-guarded pair updates, Armijo
  backtracking with quadratic interpolation, a steepest-descent restart
  when the line search fails, and with ``bounds`` the projected variant
  (TaoBLMVM);
- ``newton_cg_minimize``: trust-region Newton-CG (TaoNLS/BNTR):
  Steihaug-Toint CG on H p = -g, truncated at the radius or at negative
  curvature, the classic 1/4-3/4 radius control.  The Hessian enters only
  through matvecs (``implicit_hvp``: two Krylov solves each).

An objective evaluation is a PDE solve in the intended use, so the drivers
are host loops over pytrees of tensors (``torch.utils._pytree``: tensors,
dicts of tensors, ``PowerLawParams``); their scalars are Python floats.
The dot products are plain library reductions.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
import torch.utils._pytree as pytree

from spectral_tpu_torch.solvers.types import ConvergedReason

_tm = pytree.tree_map


def _dot(a, b) -> float:
    return float(sum(torch.vdot(x.reshape(-1), y.reshape(-1)).real
                     for x, y in zip(pytree.tree_leaves(a), pytree.tree_leaves(b))))


def _axpy(alpha: float, x, y):
    """alpha * x + y."""
    return _tm(lambda a, b: alpha * a + b, x, y)


def _scale(alpha: float, x):
    return _tm(lambda a: alpha * a, x)


def _norm_inf(x) -> float:
    leaves = pytree.tree_leaves(x)
    return max(float(torch.max(torch.abs(a))) for a in leaves) if leaves else 0.0


@dataclasses.dataclass(frozen=True)
class OptimizeConfig:
    gtol: float = 1e-8          # ||grad||_inf convergence
    ftol: float = 0.0           # relative objective decrease (0 = off)
    max_it: int = 200
    m: int = 10                 # L-BFGS memory
    c1: float = 1e-4            # Armijo slope fraction
    ls_max: int = 30
    # trust region (newton_cg_minimize)
    delta0: float = 1.0
    delta_max: float = 1e3
    cg_rtol: float = 0.1        # inner CG forcing
    cg_max_it: int = 50
    monitor: bool = False


@dataclasses.dataclass
class OptimizeResult:
    x: Any
    f: float
    gnorm: float
    iters: int
    nfev: int
    reason: int
    history: list

    def reason_str(self) -> str:
        return ConvergedReason.describe(self.reason)


def _make_project(bounds):
    """bounds = None or (lo, hi), each None, a scalar or a pytree matching
    x.  Returns P(x) (the identity without bounds)."""
    if bounds is None:
        return lambda x: x
    lo, hi = bounds

    def bound_tree(b, x, default):
        if b is None:
            return _tm(lambda _: default, x)
        if np.ndim(b) == 0 and not isinstance(b, dict):
            return _tm(lambda _: float(b), x)
        return b                    # a pytree matching x

    def project(x):
        return _tm(lambda leaf, lo_, hi_: torch.clamp(leaf, float(lo_), float(hi_)),
                   x, bound_tree(lo, x, -np.inf), bound_tree(hi, x, np.inf))

    return project


def _armijo(value_and_grad, x, f0, g0, p, cfg, nfev, project=None):
    """Backtracking Armijo line search with quadratic interpolation, along
    the projected arc x(alpha) = P(x + alpha p) when ``project`` is given
    (the bound-constrained TaoBLMVM shape), the sufficient decrease then
    measured against g . (x(alpha) - x).  Returns (x_new, f_new, g_new,
    alpha, nfev, ok)."""
    slope = _dot(g0, p)
    if project is None and slope >= 0.0:   # not a descent direction
        return x, f0, g0, 0.0, nfev, False
    alpha = 1.0
    for _ in range(cfg.ls_max):
        xn = _axpy(alpha, p, x)
        if project is not None:
            xn = project(xn)
            dec = _dot(g0, _tm(torch.sub, xn, x))
            if dec >= 0.0:      # the projected step is not a descent direction
                alpha *= 0.5
                continue
        else:
            dec = alpha * slope
        fn, gn = value_and_grad(xn)
        fn = float(fn)
        nfev += 1
        if np.isfinite(fn) and fn <= f0 + cfg.c1 * dec:
            return xn, fn, gn, alpha, nfev, True
        # quadratic model through (0, f0, slope) and (alpha, fn)
        denom = 2.0 * (fn - f0 - alpha * slope)
        a_q = -slope * alpha * alpha / denom if np.isfinite(fn) and \
            denom > 0.0 else 0.5 * alpha
        alpha = min(max(a_q, 0.1 * alpha), 0.5 * alpha)
    return x, f0, g0, 0.0, nfev, False


def lbfgs_minimize(value_and_grad: Callable[[Any], tuple], x0: Any,
                   config: OptimizeConfig = OptimizeConfig(), bounds=None) -> OptimizeResult:
    """Minimize f(theta) by limited-memory BFGS (TaoLMVM).

    ``value_and_grad``: theta -> (f, grad); for a PDE-constrained
    objective, a forward Newton solve and ``implicit_gradient``.

    ``bounds = (lo, hi)`` (each None, a scalar or a pytree matching theta)
    takes the projected variant (TaoBLMVM): the line search runs along the
    projected arc P(x + alpha p) and convergence is on the projected
    gradient ||P(x - g) - x||_inf (positivity of a viscosity or hardness
    is the common use)."""
    cfg = config
    project = _make_project(bounds)
    x = project(x0)
    f, g = value_and_grad(x)
    f = float(f)
    nfev = 1
    pairs: list = []            # (s, y, rho), newest last
    history = [f]
    reason = int(ConvergedReason.DIVERGED_ITS)
    it = 0

    def stat_norm(x, g):
        if bounds is None:
            return _norm_inf(g)
        return _norm_inf(_tm(torch.sub, x, project(_tm(torch.sub, x, g))))

    for it in range(1, cfg.max_it + 1):
        gnorm = stat_norm(x, g)
        if cfg.monitor:
            print(f"lbfgs {it - 1:4d}  f = {f:.12e}  |g| = {gnorm:.3e}")
        if gnorm <= cfg.gtol:
            reason = int(ConvergedReason.CONVERGED_ATOL)
            break
        # two-loop recursion: p = -H g
        q = g
        alphas = []
        for s, y, rho in reversed(pairs):
            a = rho * _dot(s, q)
            alphas.append(a)
            q = _axpy(-a, y, q)
        if pairs:
            s, y, rho = pairs[-1]
            gamma = _dot(s, y) / max(_dot(y, y), 1e-300)
        else:
            gamma = 1.0
        r = _scale(gamma, q)
        for (s, y, rho), a in zip(pairs, reversed(alphas)):
            b = rho * _dot(y, r)
            r = _axpy(a - b, s, r)
        p = _scale(-1.0, r)
        xn, fn, gn, alpha, nfev, ok = _armijo(value_and_grad, x, f, g, p, cfg, nfev,
                                              project=None if bounds is None else project)
        if not ok:
            if not pairs:       # steepest descent already failed
                reason = int(ConvergedReason.DIVERGED_LINE_SEARCH)
                break
            pairs.clear()       # restart from steepest descent
            continue
        s = _tm(torch.sub, xn, x)
        y = _tm(torch.sub, gn, g)
        sy = _dot(s, y)
        if sy > 1e-12 * np.sqrt(max(_dot(s, s), 0.0)) * np.sqrt(max(_dot(y, y), 0.0)):
            pairs.append((s, y, 1.0 / sy))
            if len(pairs) > cfg.m:
                pairs.pop(0)
        f_prev, x, f, g = f, xn, fn, gn
        history.append(f)
        if cfg.ftol > 0.0 and abs(f_prev - f) <= cfg.ftol * max(abs(f_prev), abs(f), 1.0):
            reason = int(ConvergedReason.CONVERGED_RTOL)
            break
    else:
        it = cfg.max_it
    gnorm = stat_norm(x, g)
    if gnorm <= cfg.gtol:
        reason = int(ConvergedReason.CONVERGED_ATOL)
    return OptimizeResult(x, f, gnorm, it, nfev, reason, history)


def _steihaug_cg(hvp, g, delta, cfg):
    """Steihaug-Toint CG for H p = -g within ||p|| <= delta.  Returns (p,
    Hp, hits_boundary, cg_iters); Hp follows the CG recurrences (Hz = -g -
    r; a boundary exit adds tau Hd), so the caller's model decrease costs
    no extra Hessian application (two PDE solves each through
    implicit_hvp)."""
    z = _scale(0.0, g)
    Hz = z
    r = _scale(-1.0, g)
    d = r
    rr = _dot(r, r)
    tol2 = (cfg.cg_rtol ** 2) * rr
    for k in range(cfg.cg_max_it):
        Hd = hvp(d)
        dHd = _dot(d, Hd)
        if dHd <= 0.0:
            # negative curvature: go to the boundary along d
            p, tau = _to_boundary(z, d, delta)
            return p, _axpy(tau, Hd, Hz), True, k
        alpha = rr / dHd
        zn = _axpy(alpha, d, z)
        if np.sqrt(max(_dot(zn, zn), 0.0)) >= delta:
            p, tau = _to_boundary(z, d, delta)
            return p, _axpy(tau, Hd, Hz), True, k
        Hz = _axpy(alpha, Hd, Hz)
        r = _axpy(-alpha, Hd, r)
        rr_new = _dot(r, r)
        z = zn
        if rr_new <= tol2:
            return z, Hz, False, k + 1
        d = _axpy(rr_new / rr, d, r)
        rr = rr_new
    return z, Hz, False, cfg.cg_max_it


def _to_boundary(z, d, delta):
    """(z + tau d, tau) with ||z + tau d|| = delta, tau >= 0."""
    zz, zd, dd = _dot(z, z), _dot(z, d), _dot(d, d)
    disc = max(zd * zd + dd * (delta * delta - zz), 0.0)
    tau = (-zd + np.sqrt(disc)) / max(dd, 1e-300)
    return _axpy(tau, d, z), tau


def newton_cg_minimize(value_and_grad: Callable[[Any], tuple],
                       hvp: Callable[[Any, Any], Any], x0: Any,
                       config: OptimizeConfig = OptimizeConfig()) -> OptimizeResult:
    """Trust-region Newton-CG (TaoNLS/BNTR): Steihaug-Toint inner CG,
    1/4-3/4 rho radius control.

    ``hvp``: (theta, v) -> H v; for a reduced PDE objective,
    ``solvers.adjoint.implicit_hvp`` at the current forward solution."""
    cfg = config
    x = x0
    f, g = value_and_grad(x)
    f = float(f)
    nfev = 1
    delta = cfg.delta0
    history = [f]
    reason = int(ConvergedReason.DIVERGED_ITS)
    it = 0
    for it in range(1, cfg.max_it + 1):
        gnorm = _norm_inf(g)
        if cfg.monitor:
            print(f"ncg {it - 1:4d}  f = {f:.12e}  |g| = {gnorm:.3e}  delta = {delta:.3e}")
        if gnorm <= cfg.gtol:
            reason = int(ConvergedReason.CONVERGED_ATOL)
            break
        p, Hp, boundary, _ = _steihaug_cg(lambda v: hvp(x, v), g, delta, cfg)
        # predicted decrease of the quadratic model (Hp from CG, free)
        pred = -(_dot(g, p) + 0.5 * _dot(p, Hp))
        xn = _tm(torch.add, x, p)
        fn, gn = value_and_grad(xn)
        fn = float(fn)
        nfev += 1
        rho = (f - fn) / pred if pred > 0.0 and np.isfinite(fn) else -1.0
        pnorm = np.sqrt(max(_dot(p, p), 0.0))
        if rho < 0.25:
            delta = 0.25 * pnorm
        elif rho > 0.75 and boundary:
            delta = min(2.0 * delta, cfg.delta_max)
        if rho > 1e-4:
            f_prev, x, f, g = f, xn, fn, gn
            history.append(f)
            if cfg.ftol > 0.0 and abs(f_prev - f) <= cfg.ftol * max(abs(f_prev), abs(f), 1.0):
                reason = int(ConvergedReason.CONVERGED_RTOL)
                break
        if delta < 1e-14:
            reason = int(ConvergedReason.DIVERGED_TR_DELTA)
            break
    else:
        it = cfg.max_it
    gnorm = _norm_inf(g)
    if gnorm <= cfg.gtol:
        reason = int(ConvergedReason.CONVERGED_ATOL)
    return OptimizeResult(x, f, gnorm, it, nfev, reason, history)
