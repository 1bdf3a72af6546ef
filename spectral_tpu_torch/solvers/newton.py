"""Newton-Krylov nonlinear solver: the PETSc SNES replacement.

Counterpart of ``spectral_tpu/solvers/newton.py`` for ``newton_solve``
(line-search Newton with Eisenstat-Walker forcing, a lagged
preconditioner and Krylov recycling) and the rest of the SNES family:
``newton_tr_solve`` (trust region), ``quasi_newton_solve`` (L-BFGS),
``anderson_solve`` and ``ngmres_solve``, and ``newton_solve_family`` (a
parameter family in one batched loop over ``KSPConfig.solve_batched``,
per-member reasons, forcing and line search).  For ``newton_solve``:

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

The other family members keep the same rule: each iteration's controller
scalars cross to the host in one transfer (the trust-region ratio's
reductions, a quasi-Newton trial's norms and curvature, an Anderson or
NGMRES residual norm).  Anderson's and NGMRES's small least-squares
problems are solved on the device by the SVD, which checks its result on
the host: one more synchronisation an iteration there.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

from spectral_tpu_torch.solvers.batching import batch_map, member, where_members
from spectral_tpu_torch.solvers.krylov import KSPConfig, _leaf_dtype, _ravel
from spectral_tpu_torch.solvers.types import ConvergedReason


def _norm(x, reduce=None) -> torch.Tensor:
    """2-norm of a tensor, or over every leaf of a dict of tensors (sorted
    key order, as the JAX package sums a pytree's leaves); a 0-d tensor.
    ``reduce`` sums the square over a mesh (the norm of a slab's global
    vector)."""
    if reduce is not None:
        leaves = [x] if isinstance(x, torch.Tensor) else [x[k] for k in sorted(x)]
        return torch.sqrt(reduce(sum(torch.dot(a.reshape(-1), a.reshape(-1))
                                     for a in leaves)))
    if isinstance(x, torch.Tensor):
        return torch.linalg.vector_norm(x.reshape(-1))
    return torch.sqrt(sum(torch.dot(x[k].reshape(-1), x[k].reshape(-1))
                          for k in sorted(x)))


def _step(x, dx, lam):
    """x - lam dx on tensors, or leaf by leaf on dicts of tensors; lam a
    float or a 0-d tensor."""
    if isinstance(x, torch.Tensor):
        return x - lam * dx
    return {k: x[k] - lam * dx[k] for k in x}


def _scaled(x, a):
    """a x on a tensor or leaf by leaf on a dict of tensors."""
    if isinstance(x, torch.Tensor):
        return a * x
    return {k: a * x[k] for k in x}


def _jfnk(residual_fn):
    """The Jacobian action by forward-mode differentiation of the residual
    (the JAX package's ``jax.jvp`` default, the reference's -snes_mf)."""
    def jacobian_action(x, lin_state, w):
        return torch.func.jvp(lambda z: residual_fn(z)[0], (x,), (w,))[1]

    return jacobian_action


def _lstsq(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Minimum-norm least squares min ||A x - b|| by the SVD, with
    ``jnp.linalg.lstsq``'s cut: singular values above 0 and at least
    eps max(A.shape) times the largest.  On A's device, in its dtype; zero
    columns get zero entries."""
    U, s, Vh = torch.linalg.svd(A, full_matrices=False)
    rcond = torch.finfo(A.dtype).eps * max(A.shape)
    keep = (s > 0) & (s >= rcond * s[0])
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    return Vh.T @ (s_inv * (U.T @ b))


def _stop_reason(fnorm: float, fnorm0: float, it: int, config) -> int:
    """The stopping test at the top of a SNES iteration: atol, rtol,
    non-finite, max_it, else ITERATING."""
    if fnorm <= config.atol:
        return int(ConvergedReason.CONVERGED_ATOL)
    if fnorm <= config.rtol * fnorm0:
        return int(ConvergedReason.CONVERGED_RTOL)
    if not np.isfinite(fnorm):
        return int(ConvergedReason.DIVERGED_NANORINF)
    if it == config.max_it:
        return int(ConvergedReason.DIVERGED_ITS)
    return int(ConvergedReason.ITERATING)


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
    recycle_U: Any = None      # the harvested Krylov subspace (config.recycle)

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
    # Krylov recycling across the sequence of linear solves (Newton steps,
    # and continuation steps through solve_continuation): harvest this many
    # slow directions from each solve and deflate the next solve's PC with
    # them (KSPConfig.solve_recycled); 0 disables; gmres/fgmres only.  The
    # JAX package measured it neutral to negative under the nested Stokes
    # saddle PC, whose preconditioned spectrum is flat.
    recycle: int = 0
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


@dataclasses.dataclass
class NewtonFamilyResult:
    """Batched Newton outcome: the leading axis of x is the family member.
    ``ksp_iters`` holds each step's linear iterations per member (0 for a
    frozen member), which the JAX package does not return."""

    x: Any
    iters: np.ndarray          # (B,) iterations each member took
    reason: np.ndarray         # (B,) ConvergedReason codes
    fnorm: np.ndarray          # (B,)
    fnorm_history: np.ndarray  # (steps + 1, B)
    ksp_iters: np.ndarray = None   # (steps, B)

    def reason_str(self, b: int) -> str:
        return ConvergedReason.describe(int(self.reason[b]))


def _norms(x) -> torch.Tensor:
    """(B,) member norms of a batched tensor or dict of batched tensors
    (leaves summed in sorted key order, as ``_norm`` sums a member's)."""
    if isinstance(x, torch.Tensor):
        return torch.sqrt(torch.sum((x * x).reshape(x.shape[0], -1), dim=1))
    return torch.sqrt(sum(torch.sum((x[k] * x[k]).reshape(x[k].shape[0], -1), dim=1)
                          for k in sorted(x)))


def _step_members(x, dx, lam: torch.Tensor):
    """x - lam_b dx_b member by member; lam a (B,) tensor."""
    def one(a, d):
        return a - lam.reshape(lam.shape + (1,) * (a.ndim - 1)).to(a.dtype) * d

    if isinstance(x, torch.Tensor):
        return one(x, dx)
    return {k: one(x[k], dx[k]) for k in x}


def _line_search_bt_family(res_b, x, dx, fnorm0: np.ndarray, live: np.ndarray,
                           cfg: NewtonConfig, dev: torch.device):
    """The backtracking line search (``_line_search_bt``) member by member,
    the JAX package's under ``vmap``: each member halves its own lambda
    until it accepts or has made ``ls_max_steps`` trials, and is frozen
    from then on; every trial evaluates the residual on the whole batch
    and reads the B norms in one host transfer.  Returns the kept trial
    (x, F, lin_state), its norms and the accepted flags."""
    lam = np.ones(len(fnorm0))
    xt = _step_members(x, dx, torch.as_tensor(lam, device=dev))
    Ft, lst = res_b(xt)
    fn = _norms(Ft).cpu().numpy()
    ok = np.isfinite(fn) & (fn <= (1.0 - cfg.ls_alpha * lam) * fnorm0)
    best = (xt, Ft, lst)
    tries = 1
    while np.any(live & ~ok) and tries < cfg.ls_max_steps:
        go = ~ok
        lam = np.where(go, 0.5 * lam, lam)
        xt = _step_members(x, dx, torch.as_tensor(lam, device=dev))
        Ft, lst = res_b(xt)
        fnt = _norms(Ft).cpu().numpy()
        best = where_members(torch.as_tensor(go, device=dev), (xt, Ft, lst), best)
        fn = np.where(go, fnt, fn)
        ok = ok | (go & np.isfinite(fnt) & (fnt <= (1.0 - cfg.ls_alpha * lam) * fnorm0))
        tries += 1
    return best, fn, ok


def _line_search_callable_family(res_b, thetas, x, F, lin_state, dx, fnorm: np.ndarray,
                                 live: np.ndarray, line_search):
    """A callable line search (``NewtonConfig.line_search``) applied member
    by member to the live members: each call sees one member's residual
    (the family's residual on a batch of one, at the member's parameters),
    state, step and norm, as under the JAX package's ``vmap``.  Returns
    the batch with the live members' results written in, their norms and
    the accepted flags (frozen members keep theirs, accepted)."""
    def put(batch, b, one):
        def f(a, v):
            if not isinstance(a, torch.Tensor):
                return a
            a = a.clone()
            a[b] = v
            return a
        return pytree.tree_map(f, batch, one)

    def at(b):
        th = pytree.tree_map(lambda a: a[b:b + 1] if isinstance(a, torch.Tensor) else a,
                             thetas)

        def residual(z):
            F1, ls1 = res_b(pytree.tree_map(lambda a: a[None], z), th)
            return member(F1, 0), member(ls1, 0)
        return residual

    fnn, ok = fnorm.copy(), np.ones(len(fnorm), bool)
    new = (x, F, lin_state)
    for b in np.flatnonzero(live):
        xb, Fb, lsb, fnb, okb = line_search(at(b), member(x, b), member(dx, b),
                                            float(fnorm[b]))
        new = (put(new[0], b, xb), put(new[1], b, Fb), put(new[2], b, lsb))
        fnn[b], ok[b] = float(fnb), bool(okb)
    return new, fnn, ok


def newton_solve_family(
    residual_fn: Callable[[Any, Any], tuple[Any, Any]],
    x0: Any,
    thetas: Any,
    *,
    jacobian_action: Callable[[Any, Any, Any], Any],
    pc_setup: Optional[Callable[[Any, Any], Any]] = None,
    pc_apply: Optional[Callable[[Any, Any], Any]] = None,
    ksp: KSPConfig = KSPConfig(type="gmres", rtol=1e-5),
    config: NewtonConfig = NewtonConfig(),
    null_project: Optional[Callable] = None,
    x0_batched: bool = False,
    batched: bool = False,
) -> NewtonFamilyResult:
    """Solve F(x; theta_b) = 0 for a whole parameter family at once.

    Args:
      residual_fn: (x, theta) -> (F, lin_state); ``thetas`` is a pytree
        whose tensor leaves carry the leading family axis B (for example
        ``PowerLawParams`` of (B,) tensors).
      x0: one member's initial guess (broadcast to the family), or, with
        ``x0_batched=True``, a batch with leading axis B (an explicit flag:
        a shape heuristic would misread a grid whose leading extent is B).
      jacobian_action/pc_setup/pc_apply/null_project: as in
        ``newton_solve``.  With ``batched=False`` (the JAX package's
        signature) they act on one member and are mapped over the family by
        ``torch.func.vmap``, so they must be loop-free; with
        ``batched=True`` they act on the whole family themselves (the
        Stokes family, whose preconditioner holds nested Krylov solves).

    The Krylov solve is ``KSPConfig.solve_batched`` (one space a member,
    per-member forcing under ``config.ksp_ew``, Eisenstat-Walker choice 2
    member by member); the line search is per member.  Members that reach
    a terminal reason (atol, rtol, NaN/Inf, the iteration limit, a failed
    line search, a small step) are frozen while the rest iterate; the loop
    ends when every member is terminal.  The stopping tests and the
    forcing run on the host in float64, as in the JAX package's loop.
    """
    leaves = [a for a in pytree.tree_leaves(thetas) if isinstance(a, torch.Tensor)]
    B = int(leaves[0].shape[0])
    if not x0_batched:
        x0 = pytree.tree_map(lambda a: a.expand((B,) + a.shape).clone(), x0)
    if batched:
        res_b, jac_b, setup_b, apply_b, null_b = (residual_fn, jacobian_action, pc_setup,
                                                  pc_apply, null_project)
    else:
        res_b = batch_map(residual_fn)
        jac_b = batch_map(jacobian_action)
        setup_b = None if pc_setup is None else batch_map(pc_setup)
        apply_b = None if pc_apply is None else batch_map(pc_apply)
        null_b = None if null_project is None else batch_map(null_project)
    if not callable(config.line_search) and config.line_search not in ("bt", "basic"):
        raise ValueError(f"unknown line search {config.line_search!r}")

    def res_t(z):
        return res_b(z, thetas)

    x = x0
    F, lin_state = res_t(x)
    fn_t = _norms(F)
    fnorm, dev = fn_t.cpu().numpy(), fn_t.device
    fnorm0 = np.maximum(fnorm, 1e-300)
    hist = [fnorm.copy()]
    ksp_hist = []
    reason = np.full(B, int(ConvergedReason.ITERATING), dtype=np.int64)
    iters = np.zeros(B, dtype=np.int64)
    eta_prev = None
    fnorm_prev = None

    for it in range(config.max_it + 1):
        fn = fnorm
        live = reason == int(ConvergedReason.ITERATING)
        reason[live & (fn <= config.atol)] = int(ConvergedReason.CONVERGED_ATOL)
        live = reason == int(ConvergedReason.ITERATING)
        reason[live & (fn <= config.rtol * fnorm0)] = int(ConvergedReason.CONVERGED_RTOL)
        live = reason == int(ConvergedReason.ITERATING)
        reason[live & ~np.isfinite(fn)] = int(ConvergedReason.DIVERGED_NANORINF)
        live = reason == int(ConvergedReason.ITERATING)
        if it == config.max_it:
            reason[live] = int(ConvergedReason.DIVERGED_ITS)
            live[:] = False
        if not live.any():
            break
        if config.monitor:
            print(f"{it:3d} SNES family fnorms " + " ".join(f"{v:.3e}" for v in fn))
        lin_rtol = np.full(B, ksp.rtol)
        if config.ksp_ew:
            if eta_prev is None:
                eta = np.full(B, config.ew_eta0)
            else:
                ratio = fn / np.maximum(fnorm_prev, 1e-300)
                eta = config.ew_gamma * ratio ** config.ew_alpha
                guard = config.ew_gamma * eta_prev ** config.ew_alpha
                eta = np.where(guard > 0.1, np.maximum(eta, guard), eta)
            eta = np.minimum(eta, config.ew_etamax)
            eta = np.maximum(eta, 0.5 * config.rtol * fnorm0 / np.maximum(fn, 1e-300))
            eta = np.minimum(eta, config.ew_etamax)
            lin_rtol = np.maximum(eta, ksp.rtol)
            eta_prev = lin_rtol
        fnorm_prev = fn

        pc_state = setup_b(x, lin_state) if setup_b is not None else None
        M = (lambda r, st=pc_state: apply_b(st, r)) if apply_b is not None else None
        xc, lsc = x, lin_state
        lres = ksp.solve_batched(lambda w: jac_b(xc, lsc, w), F, M=M,
                                 null_project=null_b, rtol=lin_rtol, active=live,
                                 batched=True)
        dx = lres.x
        if callable(config.line_search):
            new, fnn, ok = _line_search_callable_family(res_b, thetas, x, F, lin_state, dx,
                                                        fnorm, live, config.line_search)
        elif config.line_search == "basic":
            xn = _step_members(x, dx, torch.ones(B, device=dev))
            Fn, lsn = res_t(xn)
            fnn = _norms(Fn).cpu().numpy()
            new, ok = (xn, Fn, lsn), np.isfinite(fnn)
        else:
            new, fnn, ok = _line_search_bt_family(res_t, x, dx, fnorm, live, config, dev)
        host = torch.stack([_norms(dx), _norms(new[0])]).cpu().numpy()
        dxn, xn_norm = host[0], host[1]
        on = torch.as_tensor(live, device=dev)
        x, F, lin_state = where_members(on, new, (x, F, lin_state))
        fnorm = np.where(live, fnn, fnorm)
        iters[live] = it + 1
        hist.append(fnorm.copy())
        ksp_hist.append(np.where(live, lres.iters, 0))
        if config.line_search != "basic":
            reason[live & ~ok] = int(ConvergedReason.DIVERGED_LINE_SEARCH)
        small = live & (dxn <= config.stol * np.maximum(xn_norm, 1e-30))
        small &= reason == int(ConvergedReason.ITERATING)
        reason[small] = int(ConvergedReason.CONVERGED_SNORM_RELATIVE)

    return NewtonFamilyResult(x=x, iters=iters, reason=reason, fnorm=fnorm,
                              fnorm_history=np.stack(hist),
                              ksp_iters=(np.stack(ksp_hist) if ksp_hist
                                         else np.zeros((0, B), np.int64)))


def _trial(residual_fn, x, dx, lam: float, dxnorm: torch.Tensor, reduce=None):
    """x - lam dx and its residual; one host transfer returns
    (fnorm, dxnorm, xnorm) as floats."""
    xt = _step(x, dx, lam)
    Ft, lst = residual_fn(xt)
    host = torch.stack([_norm(Ft, reduce), dxnorm, _norm(xt, reduce)]).cpu().tolist()
    return xt, Ft, lst, host


def _line_search_bt(residual_fn, x, dx, fnorm0: float, dxnorm, cfg: NewtonConfig,
                    reduce=None):
    """Backtracking on ||F|| with sufficient decrease: lambda = 1, 1/2,
    1/4, ... until accepted or ``ls_max_steps`` trials.  Returns the last
    trial (x, F, lin_state, [fnorm, dxnorm, xnorm]) and whether it was
    accepted."""
    lam = 1.0
    for tries in range(cfg.ls_max_steps):
        if tries:
            lam *= 0.5
        best = _trial(residual_fn, x, dx, lam, dxnorm, reduce)
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
    recycle_U0=None,
    reduce=None,
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
      recycle_U0: with ``config.recycle``, the first solve's recycled
        subspace ((k, n) flat rows, cast to the state's dtype); None
        starts from zeros.  The result's ``recycle_U`` carries the last
        harvest on.
      reduce: the mesh reduction hook of a solve on slabs
        (``parallel.mesh.Mesh.allreduce``): the residual, step and state
        norms of the stopping tests and the line search are summed over
        the mesh, and the linear solves take it, so every process takes
        the one-process steps.
    """
    if reduce is not None and config.recycle > 0:
        raise ValueError("Krylov recycling (NewtonConfig.recycle) runs in one process; "
                         "a solve on a mesh takes recycle=0")
    if jacobian_action is None:
        jacobian_action = _jfnk(residual_fn)
    sc = float if control_dtype is None else torch.empty(0, dtype=control_dtype).numpy().dtype.type
    lagging = config.pc_lag > 1 and pc_setup is not None
    recycling = config.recycle > 0 and ksp.type in ("gmres", "fgmres")
    x = x0
    F, lin_state = residual_fn(x)
    U = None
    if recycling:
        Ff = _ravel(F, _leaf_dtype(F))[0]
        U = (torch.zeros((config.recycle, Ff.numel()), dtype=Ff.dtype, device=Ff.device)
             if recycle_U0 is None else torch.as_tensor(recycle_U0).to(Ff.device, Ff.dtype))
    fnorm = sc(_norm(F, reduce).item())
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
        ksp_eff = dataclasses.replace(ksp, rtol=lin_rtol)
        A = lambda w: jacobian_action(xc, lsc, w)  # noqa: E731
        if recycling:
            lres, U = ksp_eff.solve_recycled(A, F, M=M, null_project=null_project,
                                             U=U, nkeep=config.recycle)
        else:
            lres = ksp_eff.solve(A, F, M=M, null_project=null_project, reduce=reduce)
        dx = lres.x
        dxnorm = _norm(dx, reduce)
        if callable(config.line_search):
            x, F, lin_state, fn, ok = config.line_search(residual_fn, x, dx, float(fnorm))
            fnorm, ok = float(fn), bool(ok)
            dxn, xnorm = torch.stack([dxnorm, _norm(x, reduce)]).cpu().tolist()
        elif config.line_search == "basic":
            x, F, lin_state, (fnorm, dxn, xnorm) = _trial(residual_fn, x, dx, 1.0, dxnorm,
                                                          reduce)
            ok = bool(np.isfinite(fnorm))
        elif config.line_search == "bt":
            (x, F, lin_state, (fnorm, dxn, xnorm)), ok = _line_search_bt(
                residual_fn, x, dx, float(fnorm), dxnorm, config, reduce)
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
                        lin_state=lin_state, ksp_history_last=ksp_history_last,
                        recycle_U=U)


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


def newton_tr_solve(
    residual_fn: Callable[[Any], tuple[Any, Any]],
    x0,
    *,
    jacobian_action: Optional[Callable[[Any, Any, Any], Any]] = None,
    pc_setup: Optional[Callable[[Any, Any], Any]] = None,
    pc_apply: Optional[Callable[[Any, Any], Any]] = None,
    ksp: KSPConfig = KSPConfig(type="gmres", rtol=1e-5),
    config: NewtonConfig = NewtonConfig(),
    null_project: Optional[Callable] = None,
    delta0: float = 0.2,
    delta_max: float = 1e10,
    eta1: float = 1e-3,
    eta2: float = 0.25,
    eta3: float = 0.75,
    t1: float = 0.25,
    t2: float = 2.0,
) -> NewtonResult:
    """Trust-region Newton on the merit 1/2 ||F||^2 (PETSc SNESNEWTONTR).

    The Krylov Newton step is clipped to the radius delta (delta0 times
    the norm of x0, or delta0 from a zero start); the candidate is scored
    by rho, the actual merit decrease over the decrease the linear model
    F - J s predicts (one more Jacobian action); delta shrinks by t1 when
    rho < eta2 and grows by t2, up to delta_max, when rho > eta3 and the
    step was clipped; a predicted decrease within eps ||F||^2, the merit's
    own round-off, scores rho = -1 (the JAX package scores pred <= 0 so,
    and leaves the sign of a round-off-sized prediction to chance).  A
    candidate with rho > eta1 is accepted; a rejected
    one keeps x and retries with the smaller radius, and a radius below
    1e-12 of the accepted iterate's norm ends the solve as
    DIVERGED_TR_DELTA.  Each iteration's scalars (the trial's fnorm, the
    step norms, both reductions, the trial's norm) reach the host in one
    transfer."""
    if jacobian_action is None:
        jacobian_action = _jfnk(residual_fn)
    x = x0
    F, lin_state = residual_fn(x)
    fnorm_d = _norm(F)
    fnorm, xnorm0 = torch.stack([fnorm_d, _norm(x)]).cpu().tolist()
    fnorm0 = max(fnorm, 1e-300)
    xnorm = xnorm0   # norm of the accepted iterate (not the trial's)
    delta = delta0 * xnorm0 if xnorm0 > 0 else delta0
    hist = [fnorm]
    ksp_iters: list[int] = []
    ksp_history_last: list[float] = []
    reason = int(ConvergedReason.ITERATING)
    newton_its = 0
    for it in range(config.max_it + 1):
        newton_its = it
        if config.monitor:
            print(f"{it:3d} SNES Function norm {fnorm:.12e}")
        reason = _stop_reason(fnorm, fnorm0, it, config)
        if reason != ConvergedReason.ITERATING:
            break
        pc_state = pc_setup(x, lin_state) if pc_setup is not None else None
        M = (lambda r: pc_apply(pc_state, r)) if pc_apply is not None else None
        xc, lsc = x, lin_state
        A = lambda w: jacobian_action(xc, lsc, w)  # noqa: E731
        lres = ksp.solve(A, F, M=M, null_project=null_project)
        dxnorm = _norm(lres.x)
        scale = torch.clamp(delta / torch.clamp(dxnorm, min=1e-300), max=1.0)
        s = _scaled(lres.x, scale)
        # the merit decrease the linear model F(x - s) ~ F - J s predicts
        pred = 0.5 * (fnorm_d ** 2 - _norm(_step(F, A(s), 1.0)) ** 2)
        xt = _step(x, s, 1.0)
        Ft, lst = residual_fn(xt)
        fnt_d = _norm(Ft)
        ared = 0.5 * (fnorm_d ** 2 - fnt_d ** 2)
        fnt, snorm, dxn, pred, ared, xtn = torch.stack(
            [fnt_d, scale * dxnorm, dxnorm, pred, ared, _norm(xt)]).cpu().tolist()
        ksp_iters.append(int(lres.iters))
        ksp_history_last = lres.history_list()
        rho = ared / pred if pred > 0 else -1.0
        at_boundary = snorm >= 0.999 * delta and dxn > delta
        if rho < eta2:
            delta = t1 * delta
        elif rho > eta3 and at_boundary:
            delta = min(t2 * delta, delta_max)
        if rho > eta1 and np.isfinite(fnt):
            x, F, lin_state, fnorm_d, fnorm, xnorm = xt, Ft, lst, fnt_d, fnt, xtn
            hist.append(fnorm)
            if snorm <= config.stol * max(xnorm, 1e-30):
                newton_its = it + 1
                reason = int(ConvergedReason.CONVERGED_SNORM_RELATIVE)
                break
        elif delta <= 1e-12 * max(xnorm, 1.0):
            newton_its = it + 1
            reason = int(ConvergedReason.DIVERGED_TR_DELTA)
            break
    return NewtonResult(x=x, iters=newton_its, reason=reason, fnorm=fnorm,
                        fnorm_history=hist, ksp_iters=ksp_iters, lin_state=lin_state,
                        ksp_history_last=ksp_history_last)


def _flat_problem(residual_fn, x0):
    """(x0 flat, unravel, residual on flat vectors -> (F flat, lin_state))
    in x0's dtype, for the solvers that keep secant or mixing histories as
    (m, n) blocks."""
    dtype = _leaf_dtype(x0)
    xf, unravel = _ravel(x0, dtype)

    def residual_flat(xf_):
        F, lin = residual_fn(unravel(xf_))
        return _ravel(F, dtype)[0], lin

    return xf, unravel, residual_flat


def _flat_pc(pc_setup, pc_apply, unravel, dtype):
    """r -> M r on flat vectors, M built at the tree state x by pc_setup;
    (x, lin) -> that apply, or None without a preconditioner."""
    if pc_apply is None:
        return None

    def at(x_tree, lin):
        st = pc_setup(x_tree, lin) if pc_setup is not None else None
        return lambda r: _ravel(pc_apply(st, unravel(r)), dtype)[0]

    return at


def quasi_newton_solve(
    residual_fn: Callable[[Any], tuple[Any, Any]],
    x0,
    *,
    m: int = 10,
    pc_setup: Optional[Callable[[Any, Any], Any]] = None,
    pc_apply: Optional[Callable[[Any, Any], Any]] = None,
    config: NewtonConfig = NewtonConfig(),
) -> NewtonResult:
    """Limited-memory quasi-Newton (PETSc SNESQN, L-BFGS): the direction is
    -H_k F(x_k), H_k from the last ``m`` secant pairs (s, y) by the
    two-loop recursion, with H_0 = gamma_k M (M the optional PC, gamma_k =
    s.y / y.y of the newest pair).  No Jacobian actions and no linear
    solves.  Pairs are stored as (s, sigma y), sigma the sign of the first
    usable pair's curvature, so operators of either sign are handled;
    pairs failing sigma s.y > sqrt(eps) |s| |y| are skipped (Powell).  A
    line-search failure restarts the memory; one right after a restart
    ends the solve as DIVERGED_LINE_SEARCH.  Each line-search trial brings
    its fnorm, the step's norm, the trial's norm and the pair's curvature
    to the host in one transfer.  ``ksp_iters`` are zeros."""
    xf, unravel, residual_flat = _flat_problem(residual_fn, x0)
    n, dtype, dev = xf.numel(), xf.dtype, xf.device
    eps = torch.finfo(dtype).eps
    pc_at = _flat_pc(pc_setup, pc_apply, unravel, dtype)

    def curvature_rho(idx):
        sy = torch.dot(Y[idx], S[idx])
        return torch.where(torch.abs(sy) > eps, 1.0 / torch.where(
            torch.abs(sy) > eps, sy, torch.ones_like(sy)), torch.zeros_like(sy))

    def trial(xf_, Ff_, dx, lam):
        xn = xf_ - lam * dx
        Fn, lin_n = residual_flat(xn)
        sv, yv = xn - xf_, Fn - Ff_
        sn, yn = _norm(sv), _norm(yv)
        fn, snorm, xnorm, sy, thresh = torch.stack(
            [_norm(Fn), sn, _norm(xn), torch.dot(sv, yv), math.sqrt(eps) * sn * yn]).cpu().tolist()
        return xn, Fn, lin_n, sv, yv, fn, snorm, xnorm, sy, thresh

    Ff, lin = residual_flat(xf)
    fnorm = float(_norm(Ff))
    fnorm0 = max(fnorm, 1e-300)
    hist = [fnorm]
    S = torch.zeros((m, n), dtype=dtype, device=dev)
    Y = torch.zeros((m, n), dtype=dtype, device=dev)
    k, sigma = 0, 1.0
    reason = int(ConvergedReason.ITERATING)
    its = 0
    for it in range(config.max_it + 1):
        its = it
        if config.monitor:
            print(f"{it:3d} SNES-QN Function norm {fnorm:.12e}")
        reason = _stop_reason(fnorm, fnorm0, it, config)
        if reason != ConvergedReason.ITERATING:
            break
        # the two-loop recursion over the stored pairs, newest first
        mM = min(k, m)
        q, alphas = Ff, [None] * m
        for j in range(mM):
            idx = (k - 1 - j) % m
            alphas[j] = curvature_rho(idx) * torch.dot(S[idx], q)
            q = q - alphas[j] * Y[idx]
        idx0 = (k - 1) % m
        gamma = 1.0
        if k > 0:
            sy0, yy0 = torch.dot(Y[idx0], S[idx0]), torch.dot(Y[idx0], Y[idx0])
            gamma = torch.where(yy0 > eps, sy0 / torch.clamp(yy0, min=eps), torch.ones_like(yy0))
        r = gamma * (q if pc_at is None else pc_at(unravel(xf), lin)(q))
        for jj in range(mM - 1, -1, -1):
            idx = (k - 1 - jj) % m
            beta = curvature_rho(idx) * torch.dot(Y[idx], r)
            r = r + (alphas[jj] - beta) * S[idx]
        dx = sigma * r
        if config.line_search == "basic":
            out = trial(xf, Ff, dx, 1.0)
            ok = bool(np.isfinite(out[5]))
        else:
            lam = 1.0
            for tries in range(config.ls_max_steps):
                if tries:
                    lam *= 0.5
                out = trial(xf, Ff, dx, lam)
                ok = bool(np.isfinite(out[5]) and out[5] <= (1.0 - config.ls_alpha * lam) * fnorm)
                if ok:
                    break
        xn, Fn, lin_n, sv, yv, fn, snorm, xnorm, sy, thresh = out
        if config.line_search != "basic" and not ok:
            # the secant memory went stale: restart it and retry from the
            # same point; a failure right after a restart is terminal
            if k == 0:
                its = it + 1
                reason = int(ConvergedReason.DIVERGED_LINE_SEARCH)
                hist.append(fn)
                break
            S.zero_()
            Y.zero_()
            k = 0
            hist.append(fnorm)
            continue
        if k == 0 and abs(sy) > thresh:
            sigma = float(np.sign(sy))
        if sigma * sy > thresh and ok:       # Powell: keep only curved pairs
            S[k % m] = sv
            Y[k % m] = sigma * yv
            k += 1
        xf, Ff, lin, fnorm = xn, Fn, lin_n, fn
        hist.append(fnorm)
        if snorm <= config.stol * max(xnorm, 1e-30):
            its = it + 1
            reason = int(ConvergedReason.CONVERGED_SNORM_RELATIVE)
            break
    return NewtonResult(x=unravel(xf), iters=its, reason=reason, fnorm=fnorm,
                        fnorm_history=hist, ksp_iters=[0] * its, lin_state=lin)


def anderson_solve(
    residual_fn: Callable[[Any], tuple[Any, Any]],
    x0,
    *,
    m: int = 5,
    beta: float = 1.0,
    pc_setup: Optional[Callable[[Any, Any], Any]] = None,
    pc_apply: Optional[Callable[[Any, Any], Any]] = None,
    config: NewtonConfig = NewtonConfig(),
) -> NewtonResult:
    """Anderson mixing (PETSc SNESANDERSON, Walker-Ni AA(m)) of the
    preconditioned fixed-point iteration x <- x - beta M F(x): with
    w = M F and the last ``m`` differences dX, dW,

        gamma = argmin || w_k - dW^T gamma ||,
        x_{k+1} = x_k - beta w_k - (dX - beta dW)^T gamma.

    One residual and one PC application an iteration, no Jacobian, no line
    search; the least-squares problem is solved on the device (minimum
    norm, by the SVD) and only the residual norm reaches the host.
    ``ksp_iters`` are zeros."""
    xf, unravel, residual_flat = _flat_problem(residual_fn, x0)
    n, dtype, dev = xf.numel(), xf.dtype, xf.device
    pc_at = _flat_pc(pc_setup, pc_apply, unravel, dtype)

    def w_of(xf_):
        Ff_, lin_ = residual_flat(xf_)
        w_ = Ff_ if pc_at is None else pc_at(unravel(xf_), lin_)(Ff_)
        return w_, Ff_, lin_

    w, Ff, lin = w_of(xf)
    fnorm = float(_norm(Ff))
    fnorm0 = max(fnorm, 1e-300)
    hist = [fnorm]
    dX = torch.zeros((m, n), dtype=dtype, device=dev)
    dW = torch.zeros((m, n), dtype=dtype, device=dev)
    k = 0
    reason = int(ConvergedReason.ITERATING)
    its = 0
    for it in range(config.max_it + 1):
        its = it
        if config.monitor:
            print(f"{it:3d} SNES-Anderson Function norm {fnorm:.12e}")
        reason = _stop_reason(fnorm, fnorm0, it, config)
        if reason != ConvergedReason.ITERATING:
            break
        cols = (torch.arange(m, device=dev) < min(k, m)).to(dtype)
        gamma = _lstsq((dW * cols[:, None]).T, w)
        xn = xf - beta * w - (dX - beta * dW).T @ gamma
        wn, Fn, lin = w_of(xn)
        dX[k % m] = xn - xf
        dW[k % m] = wn - w
        xf, w, Ff, k = xn, wn, Fn, k + 1
        fnorm = float(_norm(Ff))
        hist.append(fnorm)
    return NewtonResult(x=unravel(xf), iters=its, reason=reason, fnorm=fnorm,
                        fnorm_history=hist, ksp_iters=[0] * its, lin_state=lin)


def ngmres_solve(
    residual_fn: Callable[[Any], tuple[Any, Any]],
    x0,
    *,
    m: int = 5,
    npc: Optional[Callable[[Any], Any]] = None,
    beta: float = 1.0,
    pc_setup: Optional[Callable[[Any, Any], Any]] = None,
    pc_apply: Optional[Callable[[Any, Any], Any]] = None,
    gamma_a: float = 2.0,
    gamma_c: float = 2.0,
    config: NewtonConfig = NewtonConfig(),
) -> NewtonResult:
    """Nonlinear GMRES (PETSc SNESNGMRES, Washio-Oosterlee N-GMRES): an
    inner nonlinear preconditioner x_M = npc(x_k) (default: the damped
    preconditioned Richardson x - beta M F(x)), then the least-squares
    recombination over the last ``m`` stored iterates,
    alpha = argmin || F_M - sum_i a_i (F_M - F_i) ||,
    x_A = x_M + sum_i a_i (x_i - x_M); x_A is taken when ||F_A|| <
    gamma_a min_i ||F_i||, else x_M; when ||F_M|| > gamma_c min_i ||F_i||
    the inner step stagnated and the subspace restarts from x_M.

    The recombination does not depend on that restart test, so x_A and
    F_A are formed before it and ||F_M||, ||F_A|| reach the host in one
    transfer an iteration (a restart discards that residual evaluation).
    ``ksp_iters`` are zeros (linear work, if any, is the NPC's)."""
    xf, unravel, residual_flat = _flat_problem(residual_fn, x0)
    n, dtype, dev = xf.numel(), xf.dtype, xf.device
    if npc is None:
        if pc_apply is None:
            raise ValueError("ngmres_solve needs either npc= or pc_apply=")

        def npc(x_tree):  # noqa: F811 -- the damped preconditioned Richardson
            F, lin_ = residual_fn(x_tree)
            st = pc_setup(x_tree, lin_) if pc_setup is not None else None
            return _step(x_tree, pc_apply(st, F), beta)

    Ff, lin = residual_flat(xf)
    fnorm = float(_norm(Ff))
    fnorm0 = max(fnorm, 1e-300)
    hist = [fnorm]
    X = torch.zeros((m, n), dtype=dtype, device=dev)
    Fs = torch.zeros((m, n), dtype=dtype, device=dev)
    fnorms = np.full(m, np.inf)
    k = 0                      # stored entries (circular)
    reason = int(ConvergedReason.ITERATING)
    its = 0
    for it in range(config.max_it + 1):
        its = it
        if config.monitor:
            print(f"{it:3d} SNES-NGMRES Function norm {fnorm:.12e}")
        reason = _stop_reason(fnorm, fnorm0, it, config)
        if reason != ConvergedReason.ITERATING:
            break
        # store the current iterate, then take the inner step
        X[k % m], Fs[k % m], fnorms[k % m] = xf, Ff, fnorm
        k += 1
        xMf = _ravel(npc(unravel(xf)), dtype)[0]
        FMf, linM = residual_flat(xMf)
        cols = (torch.arange(m, device=dev) < min(k, m)).to(dtype)
        alpha = _lstsq(((FMf[None, :] - Fs) * cols[:, None]).T, FMf)
        xAf = xMf + (X - xMf[None, :]).T @ (alpha * cols)
        FAf, linA = residual_flat(xAf)
        fM, fA = torch.stack([_norm(FMf), _norm(FAf)]).cpu().tolist()
        fmin = float(np.min(fnorms[:min(k, m)]))
        if not np.isfinite(fM):
            reason = int(ConvergedReason.DIVERGED_NANORINF)
            fnorm = fM
            hist.append(fM)
            its = it + 1
            break
        if fM > gamma_c * fmin:
            # difference restart: recombining stale directions is unreliable
            fnorms[:] = np.inf
            fnorms[0] = fM
            X.zero_()
            Fs.zero_()
            X[0], Fs[0] = xMf, FMf
            k = 1
            xf, Ff, lin, fnorm = xMf, FMf, linM, fM
            hist.append(fM)
            continue
        if np.isfinite(fA) and fA < gamma_a * fmin:
            xf, Ff, lin, fnorm = xAf, FAf, linA, fA
        else:
            xf, Ff, lin, fnorm = xMf, FMf, linM, fM
        hist.append(fnorm)
    return NewtonResult(x=unravel(xf), iters=its, reason=reason, fnorm=fnorm,
                        fnorm_history=hist, ksp_iters=[0] * its, lin_state=lin)
