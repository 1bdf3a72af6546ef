"""Restarted GMRES / FGMRES on torch tensors: the PETSc KSP replacement.

Counterpart of ``spectral_tpu/solvers/krylov.py`` for ``gmres``,
``fgmres`` (with deflation over a recycled subspace), ``cg``,
``bicgstab``, ``richardson``, ``chebyshev``, ``minres``, ``preonly``,
``extreme_singular_values``, ``KSPConfig.solve``,
``KSPConfig.solve_recycled``, ``KSPConfig.solve_batched`` (B systems,
one Krylov space each, for gmres, fgmres, cg and preonly) and
``block_gmres`` (B right-hand sides in one shared space).  A state is a tensor or
a dict of tensors (the Stokes state {"v": (dims..., d), "p": dims}),
flattened by concatenation in sorted key order, as ``ravel_pytree``
flattens it.  It keeps the JAX package's algorithm step for step:

- CGS2 orthogonalization as two basis products per step;
- the restart residual reconstructed from the basis (one inverse Givens
  sweep and one basis product, no extra operator application);
- iteration count, converged reason and a fixed-length, -1-padded
  residual history returned as data.

JAX runs the solve as a ``while_loop`` over a ``cond``; here it is a
Python loop that runs exactly one branch per step.  The Krylov basis and
every vector live on the solve's device.  The small Hessenberg state
(rotated columns, Givens pairs, least-squares right-hand side) lives on
the host in numpy, in the solve's dtype: each step pulls one (k+2)-vector
from the device, which is also the one host synchronisation per step that
the convergence test needs.  The short-recurrence solvers keep their
vectors and inner products on the device and pull one residual norm a
step (MINRES: its two Lanczos inner products, whose rotations run on the
host).

A batched solve keeps the same arithmetic member by member: (B, ...)
host arrays for the Hessenberg state, (B, n) device blocks for the
vectors, one host transfer a step for the whole batch.  A solve on a
mesh slab (``reduce=``) sums every inner product and norm over the
mesh's processes: one reduction a CGS2 pass and one a norm.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from spectral_tpu_torch.solvers.types import ConvergedReason, SolveResult

Operator = Callable[[Any], Any]

HISTORY_LEN = 256
_TINY = 1e-300


def _identity(x):
    return x


def _hist_len(history_len: int, max_it: int) -> int:
    """Residual-history buffer size: one slot per iteration up to max_it,
    bounded."""
    return int(min(max(history_len, max_it + 1), 65536))


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.dot(v, v))


def _ravel(x, dtype):
    """(flat vector in ``dtype``, unravel) of a tensor, or of a dict of
    tensors (a Stokes state {"v": ..., "p": ...}): the leaves concatenated
    in sorted key order, as the JAX package's ``ravel_pytree`` orders a
    dict, and split back into views of the flat vector."""
    if isinstance(x, torch.Tensor):
        shape = x.shape
        return x.reshape(-1).to(dtype), (lambda vf: vf.reshape(shape))
    keys = sorted(x)
    shapes = [x[k].shape for k in keys]
    sizes = [x[k].numel() for k in keys]
    flat = torch.cat([x[k].reshape(-1).to(dtype) for k in keys])

    def unravel(vf):
        return {k: part.reshape(shp)
                for k, part, shp in zip(keys, torch.split(vf, sizes), shapes)}

    return flat, unravel


def _leaf_dtype(b) -> torch.dtype:
    if isinstance(b, torch.Tensor):
        return b.dtype
    dtypes = [v.dtype for v in b.values()]
    if len(set(dtypes)) != 1:
        raise TypeError(f"the leaves of a state must share one dtype, got {dtypes}")
    return dtypes[0]


def _flatten_system(A, b, x0, M, null_project):
    """Reduce a grid-shaped system to flat vectors: b a tensor, or a dict
    of tensors flattened by concatenation.

    The solve runs in b's dtype: operator and PC outputs are cast back to
    it, so f64 constants meeting f32 state cannot change the working type.
    """
    dtype = _leaf_dtype(b)
    bf, unravel = _ravel(b, dtype)

    def wrap(op):
        if op is None:
            return None
        return lambda vf: _ravel(op(unravel(vf)), dtype)[0]

    Af = wrap(A)
    Mf = wrap(M) or _identity
    Pf = wrap(null_project) or _identity
    x0f = torch.zeros_like(bf) if x0 is None else _ravel(x0, dtype)[0]
    return Af, bf, x0f, Mf, Pf, unravel


def _scalar_type(dtype: torch.dtype):
    """The numpy scalar type of a torch dtype: host control scalars in the
    solve's precision."""
    return torch.empty(0, dtype=dtype).numpy().dtype.type


def _reason(rnorm, it: int, rnorm0, *, rtol, atol, dtol=None, max_it) -> int:
    """The converged reason after a step of a short-recurrence solve (the
    JAX loops' nested ``where``); ``dtol=None`` skips the divergence test,
    as Richardson's loop does."""
    tol = max(rtol * rnorm0, atol)
    if not np.isfinite(rnorm):
        return int(ConvergedReason.DIVERGED_NANORINF)
    if rnorm <= tol:
        return int(ConvergedReason.CONVERGED_ATOL if rnorm <= atol
                   else ConvergedReason.CONVERGED_RTOL)
    if it >= max_it:
        return int(ConvergedReason.DIVERGED_ITS)
    if dtol is not None and rnorm >= dtol * rnorm0:
        return int(ConvergedReason.DIVERGED_DTOL)
    return int(ConvergedReason.ITERATING)


def _gmres_flat(A, M, P, b, x0, *, restart, rtol, atol, dtol, max_it,
                flexible, history_len, reduce=None):
    red = reduce or _identity
    m = restart
    n = b.shape[0]
    dtype, dev = b.dtype, b.device
    sc = _scalar_type(dtype)
    tiny, rtol, atol, dtol = sc(_TINY), sc(rtol), sc(atol), sc(dtol)
    zero, one = sc(0.0), sc(1.0)

    V = torch.zeros((m + 1, n), dtype=dtype, device=dev)   # Krylov basis
    Z = torch.zeros((m, n), dtype=dtype, device=dev) if flexible else None
    R = np.zeros((m, m), sc)       # rotated Hessenberg (upper triangular)
    Hraw = np.zeros((m + 1, m), sc)   # unrotated Hessenberg of the cycle
    g = np.zeros(m + 1, sc)        # least-squares right-hand side
    cs = np.zeros(m, sc)
    sn = np.zeros(m, sc)

    def new_cycle(rp: torch.Tensor, beta) -> None:
        V.zero_()
        V[0] = rp * float(one / beta if beta > tiny else zero)
        g[:] = zero
        g[0] = beta
        R[:] = zero
        Hraw[:] = zero
        cs[:] = zero
        sn[:] = zero

    # --- initialization -----------------------------------------------------
    r0 = P(b - A(x0))
    rp0 = r0 if flexible else M(r0)
    beta0 = sc(torch.sqrt(red(torch.dot(rp0, rp0))).item())
    hist = np.full(history_len, -1.0, sc)
    hist[0] = beta0
    reason = int(ConvergedReason.CONVERGED_ATOL if beta0 <= atol
                 else ConvergedReason.ITERATING)
    rnorm0 = max(beta0, tiny)
    x, k, it, rnorm, pending, k_last = x0, 0, 0, beta0, False, 0
    new_cycle(rp0, beta0)

    while reason == ConvergedReason.ITERATING:
        if pending or k == m:
            # --- close the cycle: form x, reconstruct the residual ----------
            on = np.arange(m) < k
            Rk = np.where(on[:, None] & on[None, :], R, np.eye(m, dtype=sc))
            gk = np.where(on, g[:m], zero)
            y = torch.linalg.solve_triangular(
                torch.from_numpy(Rk), torch.from_numpy(gk)[:, None],
                upper=True)[:k, 0]
            basis = Z if flexible else V
            if k > 0:
                x = x + basis[:k].T @ y.to(dev)
            # b - A x = V Q^T (e_k g_k): one inverse Givens sweep + one
            # basis product instead of another operator application
            q = np.zeros(m + 1, sc)
            q[k] = g[k]
            for i in range(k - 1, -1, -1):
                qi, qi1 = q[i], q[i + 1]
                q[i] = cs[i] * qi - sn[i] * qi1
                q[i + 1] = sn[i] * qi + cs[i] * qi1
            beta = abs(g[k])
            tol = max(rtol * rnorm0, atol)
            if not np.isfinite(beta):
                reason = ConvergedReason.DIVERGED_NANORINF
            elif beta <= tol:
                reason = (ConvergedReason.CONVERGED_ATOL if beta <= atol
                          else ConvergedReason.CONVERGED_RTOL)
            elif it >= max_it:
                reason = ConvergedReason.DIVERGED_ITS
            elif beta >= dtol * rnorm0:
                reason = ConvergedReason.DIVERGED_DTOL
            else:
                reason = ConvergedReason.ITERATING
            reason = int(reason)
            pending, rnorm, k_last = False, beta, k
            if reason == ConvergedReason.ITERATING:
                rp = V[:k + 1].T @ torch.from_numpy(q[:k + 1]).to(dev)
                new_cycle(rp, beta)
                k = 0
            continue

        # --- one Arnoldi step ------------------------------------------------
        v = V[k]
        if flexible:
            z = M(v)
            w = P(A(z))
            Z[k] = z
        else:
            w = M(P(A(v)))
        # CGS2 against the active basis rows: two basis products per pass
        # (on a mesh slab, one reduction over the mesh a pass and one for
        # the norm)
        Vk = V[:k + 1]
        h1 = red(Vk @ w)
        w = w - Vk.T @ h1
        h2 = red(Vk @ w)
        w = w - Vk.T @ h2
        hk1 = torch.sqrt(red(torch.dot(w, w)))
        V[k + 1] = w * torch.where(hk1 > _TINY, 1.0 / hk1, 0.0)
        host = torch.cat([h1 + h2, hk1.reshape(1)]).cpu().numpy()
        Hraw[:k + 2, k] = host
        col = np.zeros(m + 1, sc)
        col[:k + 2] = host
        for i in range(k):
            t0 = cs[i] * col[i] + sn[i] * col[i + 1]
            t1 = -sn[i] * col[i] + cs[i] * col[i + 1]
            col[i], col[i + 1] = t0, t1
        a0, a1 = col[k], col[k + 1]
        denom = np.sqrt(a0 * a0 + a1 * a1)
        ck, sk = (a0 / denom, a1 / denom) if denom > tiny else (one, zero)
        col[k], col[k + 1] = denom, zero
        gk = g[k]
        g[k], g[k + 1] = ck * gk, -sk * gk
        rnorm = abs(g[k + 1])
        it += 1
        hist[min(it, history_len - 1)] = rnorm
        pending = bool(rnorm <= max(rtol * rnorm0, atol) or it >= max_it
                       or not np.isfinite(rnorm) or rnorm >= dtol * rnorm0)
        R[:, k] = col[:m]
        cs[k], sn[k] = ck, sk
        k += 1

    # the loop ends on a closed cycle, whose basis is still in place (a new
    # cycle starts only while iterating): the recycling harvest's inputs
    basis = Z if flexible else V[:m]
    return x, it, reason, float(rnorm), torch.from_numpy(hist), basis, Hraw, k_last


def _deflated(Af, Mf, Pf, bf, recycle_U):
    """Mf augmented by an additive coarse correction over span(U), the
    JAX package's recycling deflation (GCRO-DR's U-space as a two-level
    PC): W = P A U by one batched apply, T = W W^T Cholesky-factored with
    an eps ridge, and each apply adds two (k, n) contractions.  U is cast
    to the solve's dtype."""
    Uf = recycle_U.to(device=bf.device, dtype=bf.dtype)
    W = torch.func.vmap(lambda u: Pf(Af(u)))(Uf)          # (k, n) = P A U rows
    T = W @ W.T
    ridge = torch.finfo(bf.dtype).eps * (torch.trace(T) + 1.0)
    # cholesky_ex: no host synchronisation for the error check (the ridge
    # keeps T positive definite)
    L = torch.linalg.cholesky_ex(T + ridge * torch.eye(T.shape[0], dtype=bf.dtype,
                                                        device=bf.device))[0]

    def apply(r):
        y = torch.cholesky_solve((W @ r)[:, None], L)[:, 0]
        return Mf(r - y @ W) + y @ Uf

    return apply


def _gmres_like(A, b, x0, *, M, rtol, atol, dtol, max_it, restart,
                null_project, history_len, flexible, recycle_U=None,
                return_basis=False, reduce=None):
    Af, bf, x0f, Mf, Pf, unravel = _flatten_system(A, b, x0, M, null_project)
    restart = min(restart, max_it) or 1
    history_len = _hist_len(history_len, max_it)
    if recycle_U is not None:
        Mf = _deflated(Af, Mf, Pf, bf, recycle_U)
    xf, it, reason, rnorm, hist, basis, H, k_last = _gmres_flat(
        Af, Mf, Pf, bf, x0f, restart=restart, rtol=rtol, atol=atol, dtol=dtol,
        max_it=max_it, flexible=flexible, history_len=history_len, reduce=reduce)
    res = SolveResult(unravel(xf), it, reason, rnorm, hist)
    if return_basis:
        return res, basis, H, k_last
    return res


def gmres(A: Operator, b, x0=None, *, M: Optional[Operator] = None,
          rtol=1e-5, atol=1e-50, dtol=1e4, max_it=10000, restart=30,
          null_project=None, history_len=HISTORY_LEN, reduce=None) -> SolveResult:
    """Restarted GMRES with left preconditioning (PETSc KSPGMRES semantics).
    ``reduce``: the mesh reduction hook of a solve on slabs (a tensor
    summed over the mesh's processes, ``parallel.mesh.Mesh.allreduce``);
    every inner product and norm goes through it."""
    return _gmres_like(A, b, x0, M=M, rtol=rtol, atol=atol, dtol=dtol,
                       max_it=max_it, restart=restart, null_project=null_project,
                       history_len=history_len, flexible=False, reduce=reduce)


def fgmres(A: Operator, b, x0=None, *, M: Optional[Operator] = None,
           rtol=1e-5, atol=1e-50, dtol=1e4, max_it=10000, restart=30,
           null_project=None, history_len=HISTORY_LEN, reduce=None) -> SolveResult:
    """Flexible GMRES, right preconditioning (PETSc KSPFGMRES semantics):
    the preconditioner may change between applications."""
    return _gmres_like(A, b, x0, M=M, rtol=rtol, atol=atol, dtol=dtol,
                       max_it=max_it, restart=restart, null_project=null_project,
                       history_len=history_len, flexible=True, reduce=reduce)


def _dot_norm(reduce):
    """(dot, norm) of a short-recurrence solve: torch's, or summed over the
    mesh by the reduction hook (one reduction each)."""
    if reduce is None:
        return torch.dot, _norm
    return (lambda a, b: reduce(torch.dot(a, b))), \
        (lambda v: torch.sqrt(reduce(torch.dot(v, v))))


def _cg_flat(A, M, P, b, x0, *, rtol, atol, dtol, max_it, history_len, reduce=None):
    sc = _scalar_type(b.dtype)
    tiny, rtol, atol, dtol = sc(_TINY), sc(rtol), sc(atol), sc(dtol)
    red = reduce or _identity
    dot, norm = _dot_norm(reduce)

    r = P(b - A(x0))
    z = M(r)
    beta0 = sc(norm(r).item())
    hist = np.full(history_len, -1.0, sc)
    hist[0] = beta0
    reason = int(ConvergedReason.CONVERGED_ATOL if beta0 <= atol
                 else ConvergedReason.ITERATING)
    rnorm0 = max(beta0, tiny)
    x, p, rz = x0, z, dot(r, z)
    it, rnorm = 0, beta0
    while reason == ConvergedReason.ITERATING:
        Ap = P(A(p))
        pAp = dot(p, Ap)
        alpha = rz / torch.where(torch.abs(pAp) > _TINY, pAp, 1.0)
        x = x + alpha * p
        r = r - alpha * Ap
        # the next direction is queued before the norm reaches the host,
        # as the JAX loop body computes it on its last pass too; on a mesh
        # the norm and r.z share one reduction
        z = M(r)
        rr, rz_new = red(torch.stack([torch.dot(r, r), torch.dot(r, z)]))
        rn = torch.sqrt(rr)
        p = z + (rz_new / torch.where(torch.abs(rz) > _TINY, rz, 1.0)) * p
        rz = rz_new
        rnorm = sc(rn.item())
        it += 1
        hist[min(it, history_len - 1)] = rnorm
        reason = _reason(rnorm, it, rnorm0, rtol=rtol, atol=atol, dtol=dtol, max_it=max_it)
    return x, it, reason, float(rnorm), torch.from_numpy(hist)


def cg(A: Operator, b, x0=None, *, M: Optional[Operator] = None,
       rtol=1e-5, atol=1e-50, dtol=1e4, max_it=10000,
       null_project=None, history_len=HISTORY_LEN, reduce=None) -> SolveResult:
    """Preconditioned conjugate gradients (for SPD operators); one host
    synchronisation per iteration, the residual norm.  ``reduce``: the
    mesh reduction hook (two reductions an iteration)."""
    Af, bf, x0f, Mf, Pf, unravel = _flatten_system(A, b, x0, M, null_project)
    xf, it, reason, rnorm, hist = _cg_flat(
        Af, Mf, Pf, bf, x0f, rtol=rtol, atol=atol, dtol=dtol, max_it=max_it,
        history_len=_hist_len(history_len, max_it), reduce=reduce)
    return SolveResult(unravel(xf), it, reason, rnorm, hist)


def _start(r0: torch.Tensor, atol, history_len: int, norm=_norm):
    """(beta0, rnorm0, hist, reason) of a short-recurrence solve from its
    initial residual r0: one host transfer."""
    sc = _scalar_type(r0.dtype)
    beta0 = sc(norm(r0).item())
    hist = np.full(history_len, -1.0, sc)
    hist[0] = beta0
    reason = int(ConvergedReason.CONVERGED_ATOL if beta0 <= sc(atol)
                 else ConvergedReason.ITERATING)
    return beta0, max(beta0, sc(_TINY)), hist, reason


def _safe(d: torch.Tensor) -> torch.Tensor:
    """d where |d| > 1e-300, else 1 (the JAX loops' guarded divisor)."""
    return torch.where(torch.abs(d) > _TINY, d, torch.ones_like(d))


def bicgstab(A: Operator, b, x0=None, *, M: Optional[Operator] = None,
             rtol=1e-5, atol=1e-50, dtol=1e4, max_it=10000,
             null_project=None, history_len=HISTORY_LEN, reduce=None) -> SolveResult:
    """BiCGStab with left preconditioning (PETSc KSPBCGS semantics): short
    recurrences for nonsymmetric systems, two operator applications a step,
    its inner products on the device, one host transfer (the residual
    norm) a step.  ``reduce``: the mesh reduction hook (four reductions a
    step, omega's two inner products in one)."""
    Af, bf, x0f, Mf, Pf, unravel = _flatten_system(A, b, x0, M, null_project)
    history_len = _hist_len(history_len, max_it)
    sc = _scalar_type(bf.dtype)
    rtol, atol, dtol = sc(rtol), sc(atol), sc(dtol)
    red = reduce or _identity
    dot, norm = _dot_norm(reduce)

    def op(v):
        return Mf(Pf(Af(v)))

    r = Mf(Pf(bf - Af(x0f)))
    beta0, rnorm0, hist, reason = _start(r, atol, history_len, norm)
    x, rhat = x0f, r
    p = v = torch.zeros_like(r)
    rho_old = alpha = omega = torch.ones((), dtype=bf.dtype, device=bf.device)
    it, rnorm = 0, beta0
    while reason == ConvergedReason.ITERATING:
        rho = dot(rhat, r)
        beta = (rho / _safe(rho_old)) * (alpha / _safe(omega))
        p = r + beta * (p - omega * v)
        v = op(p)
        alpha = rho / _safe(dot(rhat, v))
        sres = r - alpha * v
        t = op(sres)
        ts, tt = red(torch.stack([torch.dot(t, sres), torch.dot(t, t)]))
        omega = ts / _safe(tt)
        x = x + alpha * p + omega * sres
        r = sres - omega * t
        rho_old = rho
        rnorm = sc(norm(r).item())
        it += 1
        hist[min(it, history_len - 1)] = rnorm
        reason = _reason(rnorm, it, rnorm0, rtol=rtol, atol=atol, dtol=dtol, max_it=max_it)
    return SolveResult(unravel(x), it, reason, float(rnorm), torch.from_numpy(hist))


def richardson(A: Operator, b, x0=None, *, M: Optional[Operator] = None,
               scale=1.0, rtol=1e-5, atol=1e-50, dtol=1e4, max_it=10000,
               null_project=None, history_len=HISTORY_LEN, reduce=None) -> SolveResult:
    """Richardson iteration x += scale * M(b - A x) (PETSc KSPRICHARDSON):
    one operator application and one host transfer a step; no divergence
    test, as in the JAX package (a growing iterate runs to max_it or to a
    non-finite norm).  ``reduce``: the mesh reduction hook (the norm)."""
    Af, bf, x0f, Mf, Pf, unravel = _flatten_system(A, b, x0, M, null_project)
    history_len = _hist_len(history_len, max_it)
    sc = _scalar_type(bf.dtype)
    rtol, atol = sc(rtol), sc(atol)
    _, norm = _dot_norm(reduce)
    r = Pf(bf - Af(x0f))
    beta0, rnorm0, hist, reason = _start(r, atol, history_len, norm)
    x, it, rnorm = x0f, 0, beta0
    while reason == ConvergedReason.ITERATING:
        x = x + scale * Mf(r)
        r = Pf(bf - Af(x))
        rnorm = sc(norm(r).item())
        it += 1
        hist[min(it, history_len - 1)] = rnorm
        reason = _reason(rnorm, it, rnorm0, rtol=rtol, atol=atol, max_it=max_it)
    return SolveResult(unravel(x), it, reason, float(rnorm), torch.from_numpy(hist))


def chebyshev(A: Operator, b, x0=None, *, M: Optional[Operator] = None,
              emin: float | None = None, emax: float | None = None,
              est_steps: int = 12, eig_ratio: float = 1.0 / 30.0,
              eig_safety: float = 1.1,
              rtol=1e-5, atol=1e-50, dtol=1e4, max_it=10000,
              null_project=None, history_len=HISTORY_LEN, reduce=None) -> SolveResult:
    """Chebyshev semi-iteration (PETSc KSPCHEBYSHEV) for a preconditioned
    spectrum in [emin, emax]: no inner product in the recurrence, one
    operator and one PC application a step, one host transfer (the
    convergence-test norm).  Without bounds, ``est_steps`` power
    iterations on M P A from a vector of ones estimate lambda_max:
    emax = eig_safety * lambda, emin = eig_ratio * emax (the JAX
    package's in-solve estimate, the -ksp_chebyshev_esteig analog).
    ``reduce``: the mesh reduction hook (the norms)."""
    Af, bf, x0f, Mf, Pf, unravel = _flatten_system(A, b, x0, M, null_project)
    history_len = _hist_len(history_len, max_it)
    sc = _scalar_type(bf.dtype)
    rtol, atol, dtol = sc(rtol), sc(atol), sc(dtol)
    _, norm = _dot_norm(reduce)

    if emax is None:
        v = torch.ones_like(bf)
        v = v / norm(v)
        lam = torch.ones((), dtype=bf.dtype, device=bf.device)
        for _ in range(est_steps):
            w = Mf(Pf(Af(v)))
            lam = norm(w)
            v = w / torch.clamp(lam, min=_TINY)
        e_hi = sc(eig_safety) * max(sc(lam.item()), sc(_TINY))
        e_lo = e_hi * sc(eig_ratio)
    else:
        e_hi = sc(emax)
        e_lo = sc(emax * eig_ratio if emin is None else emin)
    theta = sc(0.5) * (e_hi + e_lo)
    delta = max(sc(0.5) * (e_hi - e_lo), sc(_TINY))
    sigma1 = theta / delta

    r = Pf(bf - Af(x0f))
    beta0, rnorm0, hist, reason = _start(r, atol, history_len, norm)
    d = Mf(r) / float(theta)
    rho = sc(1.0) / sigma1
    x, it, rnorm = x0f, 0, beta0
    while reason == ConvergedReason.ITERATING:
        x = x + d
        r = r - Pf(Af(d))
        rn = norm(r)
        # the next direction is queued before the norm reaches the host
        z = Mf(r)
        rho_new = sc(1.0) / (sc(2.0) * sigma1 - rho)
        d = float(rho_new * rho) * d + float(sc(2.0) * rho_new / delta) * z
        rho = rho_new
        rnorm = sc(rn.item())
        it += 1
        hist[min(it, history_len - 1)] = rnorm
        reason = _reason(rnorm, it, rnorm0, rtol=rtol, atol=atol, dtol=dtol, max_it=max_it)
    return SolveResult(unravel(x), it, reason, float(rnorm), torch.from_numpy(hist))


def minres(A: Operator, b, x0=None, *, M: Optional[Operator] = None,
           rtol=1e-5, atol=1e-50, dtol=1e4, max_it=10000,
           null_project=None, history_len=HISTORY_LEN, reduce=None) -> SolveResult:
    """Preconditioned MINRES (Paige-Saunders; PETSc KSPMINRES) for
    symmetric, possibly indefinite operators with an SPD preconditioner.
    It monitors sqrt(r^T M r); a PC with <r, M r> < 0 ends the solve as
    DIVERGED_INDEFINITE_PC.  The returned ``rnorm`` is the recomputed true
    residual norm.  The Lanczos vectors live on the device; each step
    brings its two inner products to the host in one transfer, where the
    Givens rotations run in the solve's dtype.  ``reduce``: the mesh
    reduction hook (two reductions a step)."""
    Af, bf, x0f, Mf, Pf, unravel = _flatten_system(A, b, x0, M, null_project)
    history_len = _hist_len(history_len, max_it)
    sc = _scalar_type(bf.dtype)
    rtol, atol, dtol = sc(rtol), sc(atol), sc(dtol)
    tiny, zero, one = sc(_TINY), sc(0.0), sc(1.0)
    dot, norm = _dot_norm(reduce)

    def safe(d):
        return d if abs(d) > tiny else one

    r1 = Pf(bf - Af(x0f))
    y = Mf(r1)
    beta1sq = sc(dot(r1, y).item())
    beta1 = np.sqrt(max(beta1sq, zero))
    phibar0 = max(beta1, tiny)
    hist = np.full(history_len, -1.0, sc)
    hist[0] = beta1
    if beta1sq < zero:
        reason = int(ConvergedReason.DIVERGED_INDEFINITE_PC)
    elif beta1 <= atol:
        reason = int(ConvergedReason.CONVERGED_ATOL)
    else:
        reason = int(ConvergedReason.ITERATING)
    x, r2 = x0f, r1
    w = w2 = torch.zeros_like(bf)
    oldb, beta, dbar, epsln, phibar, cs, sn = zero, beta1, zero, zero, beta1, -one, zero
    it = 0
    while reason == ConvergedReason.ITERATING:
        v = y / float(safe(beta))
        y = Pf(Af(v))
        if it >= 1:
            y = y - float(beta / safe(oldb)) * r1
        alfa_d = dot(v, y)
        y = y - (alfa_d / float(safe(beta))) * r2
        r1, r2 = r2, y
        y = Mf(r2)
        alfa, betasq = (sc(t) for t in torch.stack([alfa_d, dot(r2, y)]).cpu().tolist())
        oldb = beta
        beta = np.sqrt(max(betasq, zero))
        # the previous rotation, then the next one
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln = sn * beta
        dbar = -cs * beta
        gamma = max(np.sqrt(gbar * gbar + beta * beta), tiny)
        cs, sn = gbar / gamma, beta / gamma
        phi, phibar = cs * phibar, sn * phibar
        w1, w2 = w2, w
        w = (v - float(oldeps) * w1 - float(delta) * w2) / float(gamma)
        x = x + float(phi) * w
        it += 1
        hist[min(it, history_len - 1)] = phibar
        if betasq < zero:
            reason = int(ConvergedReason.DIVERGED_INDEFINITE_PC)
        else:
            reason = _reason(phibar, it, phibar0, rtol=rtol, atol=atol, dtol=dtol,
                             max_it=max_it)
    rnorm_true = float(norm(Pf(bf - Af(x))))
    return SolveResult(unravel(x), it, reason, rnorm_true, torch.from_numpy(hist))


def preonly(A: Operator, b, x0=None, *, M: Optional[Operator] = None,
            null_project=None, history_len=HISTORY_LEN, **_) -> SolveResult:
    """Apply the preconditioner once (PETSc KSPPREONLY, e.g. ``-svel_ksp_type
    preonly``).  It computes no residual: rnorm is 0, not NaN (PETSc runs
    it with KSP_NORM_NONE and reports 0), and the history holds no entry."""
    Mf = M or _identity
    Pf = null_project or _identity
    x = Mf(Pf(b))
    hist = torch.full((history_len,), -1.0, dtype=_leaf_dtype(b))
    return SolveResult(x, 1, int(ConvergedReason.CONVERGED_ITS), 0.0, hist)


def extreme_singular_values(A: Operator, b, *, m: int = 30,
                            M: Optional[Operator] = None,
                            null_project=None) -> tuple[float, float]:
    """(sigma_max, sigma_min) estimate of the (preconditioned) operator from
    ``m`` Arnoldi steps, the PETSc ``KSPComputeExtremeSingularValues`` /
    ``-ksp_compute_singularvalues`` analog: the Krylov basis of M P A
    built from M P b, then the SVD of the (k+1, k) Hessenberg.  The basis
    and the SVD are float64 numpy on the host, as in the JAX package; each
    step applies the operator (and the PC) once on b's device, in b's
    dtype.  b is a tensor or a dict of tensors."""
    Af, bf, _, Mf, Pf, _ = _flatten_system(A, b, None, M, null_project)

    def op(v: np.ndarray) -> np.ndarray:
        vt = torch.as_tensor(v, dtype=bf.dtype, device=bf.device)
        return Mf(Pf(Af(vt))).cpu().numpy().astype(np.float64)

    r0 = Mf(Pf(bf)).cpu().numpy().astype(np.float64)
    beta = np.linalg.norm(r0)
    if beta == 0:
        return 0.0, 0.0
    n = r0.shape[0]
    m = min(m, n)
    V = np.zeros((m + 1, n))
    H = np.zeros((m + 1, m))
    V[0] = r0 / beta
    k = m
    for j in range(m):
        w = op(V[j])
        for _ in range(2):              # MGS, twice for robustness
            for i in range(j + 1):
                h = V[i] @ w
                H[i, j] += h
                w -= h * V[i]
        hn = np.linalg.norm(w)
        H[j + 1, j] = hn
        if hn < 1e-14 * beta:           # happy breakdown: exact subspace
            k = j + 1
            break
        V[j + 1] = w / hn
    s = np.linalg.svd(H[:k + 1, :k], compute_uv=False)
    return float(s[0]), float(s[-1])


# ---------------------------------------------------------------------------
# Batched solves: B independent systems, one Krylov space each
# ---------------------------------------------------------------------------

def _ravel_batched(x, dtype):
    """(flat (B, n) in ``dtype``, unravel) of a batched state: a tensor
    whose leading axis is the batch, or a dict of such tensors flattened
    member by member in sorted key order (``_ravel`` of each member)."""
    if isinstance(x, torch.Tensor):
        shape = x.shape
        return x.reshape(shape[0], -1).to(dtype), (lambda vf: vf.reshape(shape))
    keys = sorted(x)
    nb = x[keys[0]].shape[0]
    shapes = [x[k].shape for k in keys]
    sizes = [x[k][0].numel() for k in keys]
    flat = torch.cat([x[k].reshape(nb, -1).to(dtype) for k in keys], dim=1)

    def unravel(vf):
        return {k: part.reshape(shp)
                for k, part, shp in zip(keys, torch.split(vf, sizes, dim=1), shapes)}

    return flat, unravel


def _flatten_batched(A, b, x0, M, null_project, batched: bool):
    """``_flatten_system`` of a batch: (B, n) vectors.  ``batched=False``:
    the operators act on one member and are mapped over the batch by
    ``torch.func.vmap`` (they must be loop-free); True: they act on the
    whole batch themselves (a preconditioner with nested solves)."""
    from spectral_tpu_torch.solvers.batching import batch_map

    dtype = _leaf_dtype(b)
    bf, unravel = _ravel_batched(b, dtype)

    def wrap(op):
        if op is None:
            return None
        if not batched:
            op = batch_map(op)
        return lambda vf: _ravel_batched(op(unravel(vf)), dtype)[0]

    Af = wrap(A)
    Mf = wrap(M) or _identity
    Pf = wrap(null_project) or _identity
    x0f = torch.zeros_like(bf) if x0 is None else _ravel_batched(x0, dtype)[0]
    return Af, bf, x0f, Mf, Pf, unravel


def _reasons(rnorm, it, rnorm0, *, rtol, atol, dtol, max_it) -> np.ndarray:
    """``_reason`` member by member ((B,) host arrays)."""
    tol = np.maximum(rtol * rnorm0, atol)
    return np.where(
        ~np.isfinite(rnorm), int(ConvergedReason.DIVERGED_NANORINF),
        np.where(rnorm <= tol,
                 np.where(rnorm <= atol, int(ConvergedReason.CONVERGED_ATOL),
                          int(ConvergedReason.CONVERGED_RTOL)),
                 np.where(it >= max_it, int(ConvergedReason.DIVERGED_ITS),
                          np.where(rnorm >= dtol * rnorm0,
                                   int(ConvergedReason.DIVERGED_DTOL),
                                   int(ConvergedReason.ITERATING)))))


def _start_batched(r0: torch.Tensor, atol, history_len: int, active):
    """(sc, beta0, rnorm0, hist, reason) of a batched solve from its (B, n)
    initial residual: one host transfer.  Members outside ``active`` start
    terminal (CONVERGED_ITS, no iteration)."""
    sc = _scalar_type(r0.dtype)
    beta0 = torch.sqrt(torch.sum(r0 * r0, dim=1)).cpu().numpy().astype(sc)
    hist = np.full((r0.shape[0], history_len), -1.0, sc)
    hist[:, 0] = beta0
    reason = np.where(beta0 <= sc(atol), int(ConvergedReason.CONVERGED_ATOL),
                      int(ConvergedReason.ITERATING))
    reason[~active] = int(ConvergedReason.CONVERGED_ITS)
    return sc, beta0, np.maximum(beta0, sc(_TINY)), hist, reason


def _rows(mask: np.ndarray, dev) -> torch.Tensor:
    """A (B,) host mask as a (B, 1) boolean tensor on ``dev``."""
    return torch.as_tensor(mask, device=dev)[:, None]


def _gmres_batched(A, M, P, b, x0, *, restart, rtol, atol, dtol, max_it,
                   flexible, history_len, active):
    """``_gmres_flat`` over a leading batch axis: every member has its own
    Krylov basis, Hessenberg, Givens pair, cycle, reason, count and
    history; the host state is (B, ...) numpy arrays updated member by
    member with the same arithmetic.  A member that reaches a terminal
    reason is frozen (its state is no longer written; the operators see
    zeros in its place), as under the JAX package's ``vmap`` of the
    ``while_loop``; the loop ends when every member is terminal.  Each
    loop pass closes the cycle of the members that asked for it and makes
    one Arnoldi step for the others, with one host transfer for the whole
    batch."""
    m = restart
    nb, n = b.shape
    dtype, dev = b.dtype, b.device
    L = history_len
    r0 = P(b - A(x0))
    rp0 = r0 if flexible else M(r0)
    sc, beta0, rnorm0, hist, reason = _start_batched(rp0, atol, L, active)
    tiny, atol, dtol = sc(_TINY), sc(atol), sc(dtol)
    rtol = np.broadcast_to(np.asarray(rtol, sc), (nb,)).copy()
    zero, one = sc(0.0), sc(1.0)
    rows = np.arange(nb)

    V = torch.zeros((nb, m + 1, n), dtype=dtype, device=dev)
    Z = torch.zeros((nb, m, n), dtype=dtype, device=dev) if flexible else None
    R = np.zeros((nb, m, m), sc)
    g = np.zeros((nb, m + 1), sc)
    cs = np.zeros((nb, m), sc)
    sn = np.zeros((nb, m), sc)
    k = np.zeros(nb, np.int64)
    it = np.zeros(nb, np.int64)
    rnorm = beta0.copy()
    pending = np.zeros(nb, bool)
    x = x0.clone()

    def new_cycle(sel, rp, beta):
        idx = torch.as_tensor(np.flatnonzero(sel), device=dev)
        scale = torch.as_tensor(np.where(beta > tiny, one / np.where(beta > tiny, beta, one),
                                         zero), device=dev)
        V[idx] = 0.0
        V[idx, 0] = rp[idx] * scale[idx, None]
        g[sel] = zero
        g[sel, 0] = beta[sel]
        R[sel] = zero
        cs[sel] = zero
        sn[sel] = zero
        k[sel] = 0

    new_cycle(reason == ConvergedReason.ITERATING, rp0, beta0)

    def close(sel):
        nonlocal x
        on = np.arange(m)[None, :] < k[:, None]
        Rk = np.where(on[:, :, None] & on[:, None, :], R, np.eye(m, dtype=sc))
        gk = np.where(on, g[:, :m], zero)
        y = torch.linalg.solve_triangular(torch.from_numpy(Rk[sel]),
                                          torch.from_numpy(gk[sel])[..., None],
                                          upper=True)[..., 0]
        idx = torch.as_tensor(np.flatnonzero(sel), device=dev)
        basis = Z if flexible else V[:, :m]
        x[idx] = x[idx] + torch.einsum("bm,bmn->bn", y.to(dev), basis[idx])
        # b - A x = V Q^T (e_k g_k): the inverse Givens sweep, member by member
        q = np.zeros((nb, m + 1), sc)
        q[rows, k] = g[rows, k]
        for i in range(int(k[sel].max()) - 1, -1, -1):
            on_i = i < k
            qi, qi1 = q[:, i].copy(), q[:, i + 1].copy()
            q[:, i] = np.where(on_i, cs[:, i] * qi - sn[:, i] * qi1, qi)
            q[:, i + 1] = np.where(on_i, sn[:, i] * qi + cs[:, i] * qi1, qi1)
        beta = np.abs(g[rows, k])
        new = _reasons(beta, it, rnorm0, rtol=rtol, atol=atol, dtol=dtol, max_it=max_it)
        reason[sel] = new[sel]
        pending[sel] = False
        rnorm[sel] = beta[sel]
        go = sel & (reason == ConvergedReason.ITERATING)
        if go.any():
            kmax = int(k[go].max())
            rp = torch.einsum("bj,bjn->bn", torch.from_numpy(q[:, :kmax + 1]).to(dev),
                              V[:, :kmax + 1])
            new_cycle(go, rp, beta)

    def arnoldi(sel):
        # the live members step together (all close their cycle at k == m,
        # and a member that asks to close early ends its solve), so one k
        # indexes them all; a frozen member's operators see zeros, its
        # rows take values no one reads again
        kmax = int(k[sel][0])
        if not (k[sel] == kmax).all():
            raise RuntimeError("batched GMRES: live members out of step")
        on = None if sel.all() else _rows(sel, dev)
        v = V[:, kmax] if on is None else torch.where(on, V[:, kmax], 0.0)
        if flexible:
            z = M(v)
            w = P(A(z))
            Z[:, kmax] = z
        else:
            w = M(P(A(v)))
        Vk = V[:, :kmax + 1]
        h1 = torch.einsum("bjn,bn->bj", Vk, w)
        w = w - torch.einsum("bjn,bj->bn", Vk, h1)
        h2 = torch.einsum("bjn,bn->bj", Vk, w)
        w = w - torch.einsum("bjn,bj->bn", Vk, h2)
        hk1 = torch.sqrt(torch.sum(w * w, dim=1))
        V[:, kmax + 1] = w * torch.where(hk1 > _TINY, 1.0 / hk1, 0.0)[:, None]
        host = torch.cat([h1 + h2, hk1[:, None]], dim=1).cpu().numpy()
        s = np.flatnonzero(sel)
        col = host[s]   # (S, kmax + 2): the new Hessenberg column of each live member
        for i in range(kmax):
            t0 = cs[s, i] * col[:, i] + sn[s, i] * col[:, i + 1]
            t1 = -sn[s, i] * col[:, i] + cs[s, i] * col[:, i + 1]
            col[:, i], col[:, i + 1] = t0, t1
        a0, a1 = col[:, kmax], col[:, kmax + 1]
        denom = np.sqrt(a0 * a0 + a1 * a1)
        big = denom > tiny
        ck = np.where(big, a0 / np.where(big, denom, one), one)
        sk = np.where(big, a1 / np.where(big, denom, one), zero)
        col[:, kmax], col[:, kmax + 1] = denom, zero
        gk = g[s, kmax]
        g[s, kmax] = ck * gk
        g[s, kmax + 1] = -sk * gk
        rn = np.abs(g[s, kmax + 1])
        it[s] += 1
        hist[s, np.minimum(it[s], L - 1)] = rn
        pending[s] = ((rn <= np.maximum(rtol[s] * rnorm0[s], atol)) | (it[s] >= max_it)
                      | ~np.isfinite(rn) | (rn >= dtol * rnorm0[s]))
        top = min(kmax + 2, m)
        R[s, :top, kmax] = col[:, :top]
        cs[s, kmax], sn[s, kmax] = ck, sk
        rnorm[s] = rn
        k[s] += 1

    while True:
        live = reason == ConvergedReason.ITERATING
        if not live.any():
            break
        shut = live & (pending | (k == m))
        if shut.any():
            close(shut)
        step = live & ~shut
        if step.any():
            arnoldi(step)
    return x, it, reason, rnorm, torch.from_numpy(hist)


def _cg_batched(A, M, P, b, x0, *, rtol, atol, dtol, max_it, history_len, active):
    """``_cg_flat`` over a leading batch axis: per-member step lengths and
    directions on the device, masked once a member is terminal; one host
    transfer (the B residual norms) an iteration."""
    nb = b.shape[0]
    dev = b.device
    r = P(b - A(x0))
    z = M(r)
    sc, beta0, rnorm0, hist, reason = _start_batched(r, atol, history_len, active)
    rtol = np.broadcast_to(np.asarray(rtol, sc), (nb,)).copy()
    atol, dtol = sc(atol), sc(dtol)
    x, p = x0, z
    rz = torch.sum(r * z, dim=1)
    it = np.zeros(nb, np.int64)
    rnorm = beta0.copy()

    def safe(d):
        return torch.where(torch.abs(d) > _TINY, d, torch.ones_like(d))

    while True:
        live = reason == ConvergedReason.ITERATING
        if not live.any():
            break
        on = _rows(live, dev)
        Ap = P(A(torch.where(on, p, 0.0)))
        alpha = rz / safe(torch.sum(p * Ap, dim=1))
        xn = x + alpha[:, None] * p
        rn_ = r - alpha[:, None] * Ap
        rnv = torch.sqrt(torch.sum(rn_ * rn_, dim=1))
        zn = M(torch.where(on, rn_, 0.0))
        rz_new = torch.sum(rn_ * zn, dim=1)
        pn = zn + (rz_new / safe(rz))[:, None] * p
        x, r, p = torch.where(on, xn, x), torch.where(on, rn_, r), torch.where(on, pn, p)
        rz = torch.where(on[:, 0], rz_new, rz)
        rh = rnv.cpu().numpy().astype(sc)
        it[live] += 1
        rnorm[live] = rh[live]
        s = np.flatnonzero(live)
        hist[s, np.minimum(it[s], history_len - 1)] = rh[s]
        new = _reasons(rh, it, rnorm0, rtol=rtol, atol=atol, dtol=dtol, max_it=max_it)
        reason[live] = new[live]
    return x, it, reason, rnorm, torch.from_numpy(hist)


def _sums(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B,) member inner products of (B, n) blocks."""
    return torch.sum(a * b, dim=1)


def _safe_rows(d: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(d) > _TINY, d, torch.ones_like(d))


def _record(rh, live, it, hist, rnorm, history_len):
    """Count a step of the live members and log their (B,) host norms."""
    it[live] += 1
    rnorm[live] = rh[live]
    s = np.flatnonzero(live)
    hist[s, np.minimum(it[s], history_len - 1)] = rh[s]


def _bicgstab_batched(A, M, P, b, x0, *, rtol, atol, dtol, max_it, history_len, active):
    """``bicgstab`` over a leading batch axis: per-member scalars on the
    device, a member's update masked once it is terminal, one host
    transfer (the B residual norms) a step."""
    nb, dev = b.shape[0], b.device

    def op(v):
        return M(P(A(v)))

    r = M(P(b - A(x0)))
    sc, beta0, rnorm0, hist, reason = _start_batched(r, atol, history_len, active)
    rtol = np.broadcast_to(np.asarray(rtol, sc), (nb,)).copy()
    atol, dtol = sc(atol), sc(dtol)
    x, rhat = x0, r
    p = v = torch.zeros_like(r)
    rho_old = alpha = omega = torch.ones(nb, dtype=b.dtype, device=dev)
    it, rnorm = np.zeros(nb, np.int64), beta0.copy()
    while True:
        live = reason == ConvergedReason.ITERATING
        if not live.any():
            break
        on = _rows(live, dev)
        rho = _sums(rhat, r)
        beta = (rho / _safe_rows(rho_old)) * (alpha / _safe_rows(omega))
        pn = r + beta[:, None] * (p - omega[:, None] * v)
        vn = op(torch.where(on, pn, 0.0))
        an = rho / _safe_rows(_sums(rhat, vn))
        sres = r - an[:, None] * vn
        t = op(torch.where(on, sres, 0.0))
        wn = _sums(t, sres) / _safe_rows(_sums(t, t))
        xn = x + an[:, None] * pn + wn[:, None] * sres
        rn_ = sres - wn[:, None] * t
        x, r = torch.where(on, xn, x), torch.where(on, rn_, r)
        p, v = torch.where(on, pn, p), torch.where(on, vn, v)
        o = on[:, 0]
        rho_old, alpha, omega = (torch.where(o, rho, rho_old), torch.where(o, an, alpha),
                                 torch.where(o, wn, omega))
        rh = torch.sqrt(_sums(r, r)).cpu().numpy().astype(sc)
        _record(rh, live, it, hist, rnorm, history_len)
        new = _reasons(rh, it, rnorm0, rtol=rtol, atol=atol, dtol=dtol, max_it=max_it)
        reason[live] = new[live]
    return x, it, reason, rnorm, torch.from_numpy(hist)


def _richardson_batched(A, M, P, b, x0, *, rtol, atol, dtol, max_it, history_len, active,
                        scale=1.0):
    """``richardson`` over a leading batch axis (no divergence test)."""
    nb, dev = b.shape[0], b.device
    r = P(b - A(x0))
    sc, beta0, rnorm0, hist, reason = _start_batched(r, atol, history_len, active)
    rtol = np.broadcast_to(np.asarray(rtol, sc), (nb,)).copy()
    atol = sc(atol)
    x, it, rnorm = x0, np.zeros(nb, np.int64), beta0.copy()
    while True:
        live = reason == ConvergedReason.ITERATING
        if not live.any():
            break
        on = _rows(live, dev)
        x = torch.where(on, x + scale * M(torch.where(on, r, 0.0)), x)
        r = torch.where(on, P(b - A(x)), r)
        rh = torch.sqrt(_sums(r, r)).cpu().numpy().astype(sc)
        _record(rh, live, it, hist, rnorm, history_len)
        new = _reasons(rh, it, rnorm0, rtol=rtol, atol=atol, dtol=np.inf, max_it=max_it)
        reason[live] = new[live]
    return x, it, reason, rnorm, torch.from_numpy(hist)


def _chebyshev_batched(A, M, P, b, x0, *, rtol, atol, dtol, max_it, history_len, active,
                       emin=None, emax=None, est_steps=12, eig_ratio=1.0 / 30.0,
                       eig_safety=1.1):
    """``chebyshev`` over a leading batch axis: each member its own
    power-iteration bound (as under ``vmap``), its own recurrence scalars."""
    nb, dev, dtype = b.shape[0], b.device, b.dtype
    sc = _scalar_type(dtype)
    if emax is None:
        v = torch.ones_like(b)
        v = v / torch.sqrt(_sums(v, v))[:, None]
        lam = torch.ones(nb, dtype=dtype, device=dev)
        for _ in range(est_steps):
            w = M(P(A(v)))
            lam = torch.sqrt(_sums(w, w))
            v = w / torch.clamp(lam, min=_TINY)[:, None]
        e_hi = sc(eig_safety) * np.maximum(lam.cpu().numpy().astype(sc), sc(_TINY))
        e_lo = e_hi * sc(eig_ratio)
    else:
        e_hi = np.full(nb, emax, sc)
        e_lo = np.full(nb, emax * eig_ratio if emin is None else emin, sc)
    theta = sc(0.5) * (e_hi + e_lo)
    delta = np.maximum(sc(0.5) * (e_hi - e_lo), sc(_TINY))
    sigma1 = theta / delta

    def col(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)[:, None]

    r = P(b - A(x0))
    sc, beta0, rnorm0, hist, reason = _start_batched(r, atol, history_len, active)
    rtol = np.broadcast_to(np.asarray(rtol, sc), (nb,)).copy()
    atol, dtol = sc(atol), sc(dtol)
    d = M(r) / col(theta)
    rho = sc(1.0) / sigma1
    x, it, rnorm = x0, np.zeros(nb, np.int64), beta0.copy()
    while True:
        live = reason == ConvergedReason.ITERATING
        if not live.any():
            break
        on = _rows(live, dev)
        x = torch.where(on, x + d, x)
        r = torch.where(on, r - P(A(torch.where(on, d, 0.0))), r)
        rn = torch.sqrt(_sums(r, r))
        z = M(torch.where(on, r, 0.0))
        rho_new = sc(1.0) / (sc(2.0) * sigma1 - rho)
        d = torch.where(on, col(rho_new * rho) * d + col(sc(2.0) * rho_new / delta) * z, d)
        rho = np.where(live, rho_new, rho)
        rh = rn.cpu().numpy().astype(sc)
        _record(rh, live, it, hist, rnorm, history_len)
        new = _reasons(rh, it, rnorm0, rtol=rtol, atol=atol, dtol=dtol, max_it=max_it)
        reason[live] = new[live]
    return x, it, reason, rnorm, torch.from_numpy(hist)


def _minres_batched(A, M, P, b, x0, *, rtol, atol, dtol, max_it, history_len, active):
    """``minres`` over a leading batch axis: the Lanczos vectors on the
    device, each member's Givens rotations on the host as (B,) arrays,
    one host transfer (the B pairs of inner products) a step; ``rnorm``
    the recomputed true residual norms."""
    nb, dev, dtype = b.shape[0], b.device, b.dtype
    sc = _scalar_type(dtype)
    tiny, zero, one = sc(_TINY), sc(0.0), sc(1.0)
    rtol = np.broadcast_to(np.asarray(rtol, sc), (nb,)).copy()
    atol, dtol = sc(atol), sc(dtol)

    def safe(a):
        return np.where(np.abs(a) > tiny, a, one)

    def col(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)[:, None]

    r1 = P(b - A(x0))
    y = M(r1)
    beta1sq = _sums(r1, y).cpu().numpy().astype(sc)
    beta1 = np.sqrt(np.maximum(beta1sq, zero))
    phibar0 = np.maximum(beta1, tiny)
    hist = np.full((nb, history_len), -1.0, sc)
    hist[:, 0] = beta1
    reason = np.where(beta1sq < zero, int(ConvergedReason.DIVERGED_INDEFINITE_PC),
                      np.where(beta1 <= atol, int(ConvergedReason.CONVERGED_ATOL),
                               int(ConvergedReason.ITERATING)))
    reason[~active] = int(ConvergedReason.CONVERGED_ITS)
    x, r2 = x0, r1
    w = w2 = torch.zeros_like(b)
    oldb, beta, dbar, epsln = np.zeros(nb, sc), beta1.copy(), np.zeros(nb, sc), np.zeros(nb, sc)
    phibar, cs, sn = beta1.copy(), np.full(nb, -one, sc), np.zeros(nb, sc)
    it = np.zeros(nb, np.int64)
    while True:
        live = reason == ConvergedReason.ITERATING
        if not live.any():
            break
        on = _rows(live, dev)
        v = y / col(safe(beta))
        yy = P(A(torch.where(on, v, 0.0)))
        yy = torch.where(_rows(it >= 1, dev), yy - col(beta / safe(oldb)) * r1, yy)
        alfa_d = _sums(v, yy)
        yy = yy - (alfa_d / col(safe(beta))[:, 0])[:, None] * r2
        yn = M(torch.where(on, yy, 0.0))
        host = torch.stack([alfa_d, _sums(yy, yn)]).cpu().numpy().astype(sc)
        alfa, betasq = host[0], host[1]
        beta_n = np.sqrt(np.maximum(betasq, zero))
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        gamma = np.maximum(np.sqrt(gbar * gbar + beta_n * beta_n), tiny)
        phi = (gbar / gamma) * phibar
        wn = (v - col(oldeps) * w2 - col(delta) * w) / col(gamma)
        x = torch.where(on, x + col(phi) * wn, x)
        r1, r2, y = torch.where(on, r2, r1), torch.where(on, yy, r2), torch.where(on, yn, y)
        w2, w = torch.where(on, w, w2), torch.where(on, wn, w)
        oldb = np.where(live, beta, oldb)
        epsln = np.where(live, sn * beta_n, epsln)
        dbar = np.where(live, -cs * beta_n, dbar)
        phibar = np.where(live, (beta_n / gamma) * phibar, phibar)
        cs, sn = np.where(live, gbar / gamma, cs), np.where(live, beta_n / gamma, sn)
        beta = np.where(live, beta_n, beta)
        it[live] += 1
        s = np.flatnonzero(live)
        hist[s, np.minimum(it[s], history_len - 1)] = phibar[s]
        new = np.where(betasq < zero, int(ConvergedReason.DIVERGED_INDEFINITE_PC),
                       _reasons(phibar, it, phibar0, rtol=rtol, atol=atol, dtol=dtol,
                                max_it=max_it))
        reason[live] = new[live]
    rt = P(b - A(x))
    rnorm = torch.sqrt(_sums(rt, rt)).cpu().numpy().astype(sc)
    return x, it, reason, rnorm, torch.from_numpy(hist)


# ---------------------------------------------------------------------------
# Block GMRES: one SHARED Krylov space for a block of right-hand sides
# ---------------------------------------------------------------------------

def _qr_block(W: torch.Tensor):
    """Thin QR of the (B, n) row block: (Q rows (B, n), R (B, B))."""
    Q, R = torch.linalg.qr(W.T, mode="reduced")
    return Q.T, R


def _lstsq_min_norm(H: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """Minimum-norm least squares by the SVD with ``jnp.linalg.lstsq``'s
    cut (singular values below eps max(H.shape) times the largest are
    dropped), on H's device: all-zero columns get exactly-zero rows."""
    U, s, Vh = torch.linalg.svd(H, full_matrices=False)
    keep = s >= torch.finfo(H.dtype).eps * max(H.shape) * s[0]
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    return Vh.T @ (s_inv[:, None] * (U.T @ G))


def block_gmres(A: Operator, B_rhs, X0=None, *, M: Optional[Operator] = None,
                rtol=1e-5, atol=1e-50, dtol=1e4, max_it=10000, restart=30,
                null_project=None, history_len=HISTORY_LEN) -> SolveResult:
    """Restarted block GMRES with left preconditioning: B right-hand sides
    sharing one operator and one Krylov space, which grows by B directions
    a block step (block CGS2, then an intra-block thin QR).  A direction
    is deflated (zeroed) when the R diagonal of its column is below
    16 eps (in the solve's dtype) times that column's own norm: a true
    near-duplicate.  Each cycle ends with the minimum-norm least squares
    (SVD) and the true residual recomputed; all members must pass
    ``rtol``/``atol``.

    ``B_rhs``/``X0`` carry a leading block axis on every leaf; ``A``,
    ``M`` and ``null_project`` act on one system and are mapped over the
    block by ``torch.func.vmap`` (loop-free operators).  ``iters`` counts
    block steps (times B for operator applications); the history records
    the largest member norm.  The basis and the Hessenberg stay on the
    device; the host reads the B residual norms once a cycle."""
    Af, Bmat, X, Mf, Pf, unravel = _flatten_batched(A, B_rhs, X0, M, null_project, False)
    nb, n = Bmat.shape
    dtype, dev = Bmat.dtype, Bmat.device
    sc = _scalar_type(dtype)
    m = max(1, min(restart, max_it, -(-n // nb) + 1))
    L = _hist_len(history_len, max_it)
    rows = (m + 1) * nb
    eps16 = 16 * torch.finfo(dtype).eps

    def residual_block(X):
        Rp = Mf(Pf(Bmat - Af(X)))
        return Rp, torch.sqrt(torch.sum(Rp * Rp, dim=1))

    Rp, rn = residual_block(X)
    rnorms0 = rn.cpu().numpy().astype(sc)
    rnorms = rnorms0.copy()
    r0 = np.maximum(rnorms0, sc(_TINY))
    hist = np.full(L, -1.0, sc)
    hist[0] = rnorms0.max()
    reason = int(ConvergedReason.CONVERGED_ATOL if rnorms0.max() <= atol
                 else ConvergedReason.ITERATING)
    it = 0

    def new_cycle(Rp):
        Q0, R0 = _qr_block(Rp)
        V = torch.zeros((rows, n), dtype=dtype, device=dev)
        V[:nb] = Q0
        G = torch.zeros((rows, nb), dtype=dtype, device=dev)
        G[:nb] = R0
        return V, torch.zeros((rows, m * nb), dtype=dtype, device=dev), G

    V, H, G = new_cycle(Rp)
    k = 0
    while reason == ConvergedReason.ITERATING:
        if k == m or it >= max_it:
            # cycle end: min-norm least squares over the active columns
            Hm = H.clone()
            Hm[:, k * nb:] = 0.0
            Y = _lstsq_min_norm(Hm, G)
            X = X + Y.T @ V[:m * nb]
            Rp, rn = residual_block(X)
            rnorms = rn.cpu().numpy().astype(sc)
            hist[min(it, L - 1)] = rnorms.max()
            if not np.all(np.isfinite(rnorms)):
                reason = int(ConvergedReason.DIVERGED_NANORINF)
            elif np.all(rnorms <= np.maximum(rtol * r0, atol)):
                reason = int(ConvergedReason.CONVERGED_ATOL if np.all(rnorms <= atol)
                             else ConvergedReason.CONVERGED_RTOL)
            elif it >= max_it:
                reason = int(ConvergedReason.DIVERGED_ITS)
            elif np.any(rnorms >= dtol * r0):
                reason = int(ConvergedReason.DIVERGED_DTOL)
            V, H, G = new_cycle(Rp)
            k = 0
            continue
        Vk = V[k * nb:(k + 1) * nb]
        W = Mf(Pf(Af(Vk)))
        Va = V[:(k + 1) * nb]
        H1 = Va @ W.T
        W = W - H1.T @ Va
        H2 = Va @ W.T
        W = W - H2.T @ Va
        wn = torch.sqrt(torch.sum(W * W, dim=1))
        Qn, Rn = _qr_block(W)
        keep = torch.abs(torch.diagonal(Rn)) > eps16 * torch.clamp_min(wn, _TINY)
        V[(k + 1) * nb:(k + 2) * nb] = Qn * keep[:, None].to(dtype)
        H[:(k + 1) * nb, k * nb:(k + 1) * nb] = H1 + H2
        H[(k + 1) * nb:(k + 2) * nb, k * nb:(k + 1) * nb] = Rn
        k += 1
        it += 1
    return SolveResult(unravel(X), it, reason, float(rnorms.max()), torch.from_numpy(hist))


_KSP_TYPES = {
    "gmres": gmres,
    "fgmres": fgmres,
    "cg": cg,
    "bcgs": bicgstab,
    "bicgstab": bicgstab,
    "richardson": richardson,
    "chebyshev": chebyshev,
    "minres": minres,
    "preonly": preonly,
}

_BATCHED_CORES = {
    "cg": _cg_batched,
    "bcgs": _bicgstab_batched,
    "bicgstab": _bicgstab_batched,
    "richardson": _richardson_batched,
    "chebyshev": _chebyshev_batched,
    "minres": _minres_batched,
}


@dataclasses.dataclass(frozen=True)
class KSPConfig:
    """Configuration of one linear solve (the analog of a prefixed PETSc KSP)."""

    type: str = "gmres"
    rtol: float = 1e-5
    atol: float = 1e-50
    dtol: float = 1e4
    max_it: int = 10000
    restart: int = 30
    history_len: int = HISTORY_LEN
    # chebyshev spectrum bounds (None: the in-solve power-iteration
    # estimate, the -ksp_chebyshev_esteig analog)
    emin: Optional[float] = None
    emax: Optional[float] = None

    def solve(self, A: Operator, b, x0=None, *, M=None,
              null_project=None, reduce=None) -> SolveResult:
        """Solve A x = b; b (and x0) a tensor or a dict of tensors.
        ``reduce``: the mesh reduction hook of a solve on slabs (every
        inner product and norm summed over the mesh; preonly has none)."""
        if self.type not in _KSP_TYPES:
            raise ValueError(f"unknown KSP type {self.type!r}")
        kwargs = dict(M=M, null_project=null_project, history_len=self.history_len)
        if self.type != "preonly":
            kwargs.update(rtol=self.rtol, atol=self.atol, dtol=self.dtol,
                          max_it=self.max_it)
        if self.type in ("gmres", "fgmres"):
            kwargs["restart"] = self.restart
        if self.type == "chebyshev":
            kwargs.update(emin=self.emin, emax=self.emax)
        if reduce is not None and self.type != "preonly":
            kwargs["reduce"] = reduce
        return _KSP_TYPES[self.type](A, b, x0, **kwargs)

    def solve_batched(self, A: Operator, b, x0=None, *, M=None, null_project=None,
                      rtol=None, active=None, batched: bool = False, mesh=None,
                      mesh_axis: str = "x") -> SolveResult:
        """Solve a batch of systems, each in its own Krylov space: ``b``
        (and ``x0``) carry a leading batch axis on every leaf.

        ``A``/``M``/``null_project`` act on one member and are mapped over
        the batch by ``torch.func.vmap`` (the JAX package's signature; they
        must be loop-free), or with ``batched=True`` act on the whole batch
        themselves (a preconditioner whose nested solves are themselves
        ``solve_batched``).  ``rtol`` optionally gives each member its own
        tolerance ((B,), the Eisenstat-Walker forcing of a family);
        ``active`` ((B,) bools) leaves the other members untouched (x0,
        no iteration, CONVERGED_ITS).  Each member keeps its own
        Hessenberg, count, reason and history, frozen once terminal: the
        SolveResult's ``iters``, ``reason`` and ``rnorm`` are (B,) numpy
        arrays and ``history`` a (B, L) tensor.  Every type has a batched
        core.

        ``mesh`` (``parallel.mesh.Mesh``) cuts the batch over mesh axis
        ``mesh_axis`` (data parallelism: each process solves its B / P
        members, in rank order, and every process gets the whole result);
        members are independent, so each takes the counts of the
        unsharded batch.  B must be divisible by the axis' size."""
        if self.type not in _KSP_TYPES:
            raise ValueError(f"unknown KSP type {self.type!r}")
        if mesh is not None and mesh.size(mesh_axis) > 1:
            return self._solve_batched_dp(A, b, x0, M=M, null_project=null_project,
                                          rtol=rtol, active=active, batched=batched,
                                          mesh=mesh, mesh_axis=mesh_axis)
        from spectral_tpu_torch.solvers.batching import batch_map

        dtype = _leaf_dtype(b)
        nb = (b if isinstance(b, torch.Tensor) else b[sorted(b)[0]]).shape[0]
        act = np.ones(nb, bool) if active is None else np.asarray(active, bool)
        if self.type == "preonly":
            Mb = M if batched or M is None else batch_map(M)
            Pb = null_project if batched or null_project is None else batch_map(null_project)
            xb = (Mb or _identity)((Pb or _identity)(b))
            return SolveResult(xb, act.astype(np.int64),
                               np.full(nb, int(ConvergedReason.CONVERGED_ITS)),
                               np.zeros(nb), torch.full((nb, self.history_len), -1.0,
                                                        dtype=dtype))
        Af, bf, x0f, Mf, Pf, unravel = _flatten_batched(A, b, x0, M, null_project, batched)
        L = _hist_len(self.history_len, self.max_it)
        rt = self.rtol if rtol is None else rtol
        common = dict(rtol=rt, atol=self.atol, dtol=self.dtol, max_it=self.max_it,
                      history_len=L, active=act)
        if self.type == "chebyshev":
            common.update(emin=self.emin, emax=self.emax)
        if self.type in _BATCHED_CORES:
            xf, it, reason, rnorm, hist = _BATCHED_CORES[self.type](Af, Mf, Pf, bf, x0f,
                                                                    **common)
        else:
            xf, it, reason, rnorm, hist = _gmres_batched(
                Af, Mf, Pf, bf, x0f, restart=min(self.restart, self.max_it) or 1,
                flexible=self.type == "fgmres", **common)
        return SolveResult(unravel(xf), it, reason, rnorm.astype(np.float64), hist)

    def _solve_batched_dp(self, A, b, x0, *, M, null_project, rtol, active, batched,
                          mesh, mesh_axis):
        """``solve_batched`` with the batch cut over a mesh axis: this
        process' members solved here, every result field gathered."""
        import torch.utils._pytree as pytree

        from spectral_tpu_torch.solvers.batching import dp_cut, dp_gather

        nb = (b if isinstance(b, torch.Tensor) else b[sorted(b)[0]]).shape[0]
        sl = dp_cut(nb, mesh, mesh_axis)

        def cut(t):   # a batch's tensors and (B,) arrays; None and scalars pass
            if isinstance(t, (torch.Tensor, dict)):
                return pytree.tree_map(lambda a: a[sl], t)
            return t if t is None or np.ndim(t) == 0 else np.asarray(t)[sl]

        res = self.solve_batched(A, cut(b), cut(x0), M=M, null_project=null_project,
                                 rtol=cut(rtol), active=cut(active), batched=batched)

        def gather(t):
            return dp_gather(t, mesh, mesh_axis)

        return SolveResult(pytree.tree_map(gather, res.x), gather(res.iters),
                           gather(res.reason), gather(res.rnorm), gather(res.history))

    def solve_recycled(self, A: Operator, b, x0=None, *, M=None,
                       null_project=None, U=None, nkeep: int = 8):
        """Deflated, recycling GMRES/FGMRES: deflate the preconditioner over
        the recycled subspace ``U`` ((k, n) flat rows from a previous
        related solve, None to start cold), solve, and harvest the final
        cycle's ``nkeep`` slowest directions as the next U.

        Returns (SolveResult, U_new), U_new a (nkeep, n) tensor on b's
        device in its dtype.  With A Z_k = V_{k+1} Hbar_k, the right
        singular vectors of Hbar with the smallest singular values give the
        directions Z g whose image under the operator is smallest; inactive
        columns are pinned to a large unit diagonal so the SVD excludes
        them, and rows without support on the active columns are dropped.
        Hbar lives on the host (the Hessenberg state of ``_gmres_flat``),
        so its SVD runs there, in the solve's dtype.  Other types fall
        through to ``solve`` and pass U on."""
        if self.type not in ("gmres", "fgmres"):
            return self.solve(A, b, x0, M=M, null_project=null_project), U
        m = min(self.restart, self.max_it) or 1
        nkeep = min(nkeep, m)
        res, basis, H, k_last = _gmres_like(
            A, b, x0, M=M, rtol=self.rtol, atol=self.atol, dtol=self.dtol,
            max_it=self.max_it, restart=self.restart, null_project=null_project,
            history_len=self.history_len, flexible=self.type == "fgmres",
            recycle_U=U, return_basis=True)
        cols = np.arange(m) < k_last
        Hm = np.where(cols[None, :], H, 0.0).astype(H.dtype)
        big = H.dtype.type(2.0) * np.linalg.norm(Hm) + H.dtype.type(1.0)
        Hm = Hm + big * np.eye(m + 1, m, dtype=H.dtype) * (~cols)[None, :]
        G = np.linalg.svd(Hm, full_matrices=False)[2][m - nkeep:]   # nkeep smallest
        support = np.sum((G * cols[None, :]) ** 2, axis=1)
        G = G * (support > 0.5)[:, None]
        return res, torch.from_numpy(G).to(basis.device) @ basis


def ksp_solve(config: KSPConfig, A: Operator, b, x0=None, *, M=None,
              null_project=None) -> SolveResult:
    return config.solve(A, b, x0, M=M, null_project=null_project)
