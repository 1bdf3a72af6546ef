"""Restarted GMRES / FGMRES on torch tensors: the PETSc KSP replacement.

Counterpart of ``spectral_tpu/solvers/krylov.py`` for ``gmres``,
``fgmres``, ``cg``, ``preonly``, ``extreme_singular_values`` and
``KSPConfig.solve``.  A state is a tensor or
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
the convergence test needs.
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


def _gmres_flat(A, M, P, b, x0, *, restart, rtol, atol, dtol, max_it,
                flexible, history_len):
    m = restart
    n = b.shape[0]
    dtype, dev = b.dtype, b.device
    sc = torch.empty(0, dtype=dtype).numpy().dtype.type  # numpy scalar type
    tiny, rtol, atol, dtol = sc(_TINY), sc(rtol), sc(atol), sc(dtol)
    zero, one = sc(0.0), sc(1.0)

    V = torch.zeros((m + 1, n), dtype=dtype, device=dev)   # Krylov basis
    Z = torch.zeros((m, n), dtype=dtype, device=dev) if flexible else None
    R = np.zeros((m, m), sc)       # rotated Hessenberg (upper triangular)
    g = np.zeros(m + 1, sc)        # least-squares right-hand side
    cs = np.zeros(m, sc)
    sn = np.zeros(m, sc)

    def new_cycle(rp: torch.Tensor, beta) -> None:
        V.zero_()
        V[0] = rp * float(one / beta if beta > tiny else zero)
        g[:] = zero
        g[0] = beta
        R[:] = zero
        cs[:] = zero
        sn[:] = zero

    # --- initialization -----------------------------------------------------
    r0 = P(b - A(x0))
    rp0 = r0 if flexible else M(r0)
    beta0 = sc(_norm(rp0).item())
    hist = np.full(history_len, -1.0, sc)
    hist[0] = beta0
    reason = int(ConvergedReason.CONVERGED_ATOL if beta0 <= atol
                 else ConvergedReason.ITERATING)
    rnorm0 = max(beta0, tiny)
    x, k, it, rnorm, pending = x0, 0, 0, beta0, False
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
            pending, rnorm = False, beta
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
        Vk = V[:k + 1]
        h1 = Vk @ w
        w = w - Vk.T @ h1
        h2 = Vk @ w
        w = w - Vk.T @ h2
        hk1 = _norm(w)
        V[k + 1] = w * torch.where(hk1 > _TINY, 1.0 / hk1, 0.0)
        host = torch.cat([h1 + h2, hk1.reshape(1)]).cpu().numpy()
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

    return x, it, reason, float(rnorm), torch.from_numpy(hist)


def _gmres_like(A, b, x0, *, M, rtol, atol, dtol, max_it, restart,
                null_project, history_len, flexible) -> SolveResult:
    Af, bf, x0f, Mf, Pf, unravel = _flatten_system(A, b, x0, M, null_project)
    restart = min(restart, max_it) or 1
    history_len = _hist_len(history_len, max_it)
    xf, it, reason, rnorm, hist = _gmres_flat(
        Af, Mf, Pf, bf, x0f, restart=restart, rtol=rtol, atol=atol, dtol=dtol,
        max_it=max_it, flexible=flexible, history_len=history_len)
    return SolveResult(unravel(xf), it, reason, rnorm, hist)


def gmres(A: Operator, b, x0=None, *, M: Optional[Operator] = None,
          rtol=1e-5, atol=1e-50, dtol=1e4, max_it=10000, restart=30,
          null_project=None, history_len=HISTORY_LEN) -> SolveResult:
    """Restarted GMRES with left preconditioning (PETSc KSPGMRES semantics)."""
    return _gmres_like(A, b, x0, M=M, rtol=rtol, atol=atol, dtol=dtol,
                       max_it=max_it, restart=restart, null_project=null_project,
                       history_len=history_len, flexible=False)


def fgmres(A: Operator, b, x0=None, *, M: Optional[Operator] = None,
           rtol=1e-5, atol=1e-50, dtol=1e4, max_it=10000, restart=30,
           null_project=None, history_len=HISTORY_LEN) -> SolveResult:
    """Flexible GMRES, right preconditioning (PETSc KSPFGMRES semantics):
    the preconditioner may change between applications."""
    return _gmres_like(A, b, x0, M=M, rtol=rtol, atol=atol, dtol=dtol,
                       max_it=max_it, restart=restart, null_project=null_project,
                       history_len=history_len, flexible=True)


def _cg_flat(A, M, P, b, x0, *, rtol, atol, dtol, max_it, history_len):
    dtype = b.dtype
    sc = torch.empty(0, dtype=dtype).numpy().dtype.type  # numpy scalar type
    tiny, rtol, atol, dtol = sc(_TINY), sc(rtol), sc(atol), sc(dtol)

    r = P(b - A(x0))
    z = M(r)
    beta0 = sc(_norm(r).item())
    hist = np.full(history_len, -1.0, sc)
    hist[0] = beta0
    reason = int(ConvergedReason.CONVERGED_ATOL if beta0 <= atol
                 else ConvergedReason.ITERATING)
    rnorm0 = max(beta0, tiny)
    x, p, rz = x0, z, torch.dot(r, z)
    it, rnorm = 0, beta0
    while reason == ConvergedReason.ITERATING:
        Ap = P(A(p))
        pAp = torch.dot(p, Ap)
        alpha = rz / torch.where(torch.abs(pAp) > _TINY, pAp, 1.0)
        x = x + alpha * p
        r = r - alpha * Ap
        rn = _norm(r)
        # the next direction is queued before the norm reaches the host,
        # as the JAX loop body computes it on its last pass too
        z = M(r)
        rz_new = torch.dot(r, z)
        p = z + (rz_new / torch.where(torch.abs(rz) > _TINY, rz, 1.0)) * p
        rz = rz_new
        rnorm = sc(rn.item())
        it += 1
        hist[min(it, history_len - 1)] = rnorm
        tol = max(rtol * rnorm0, atol)
        if not np.isfinite(rnorm):
            reason = ConvergedReason.DIVERGED_NANORINF
        elif rnorm <= tol:
            reason = (ConvergedReason.CONVERGED_ATOL if rnorm <= atol
                      else ConvergedReason.CONVERGED_RTOL)
        elif it >= max_it:
            reason = ConvergedReason.DIVERGED_ITS
        elif rnorm >= dtol * rnorm0:
            reason = ConvergedReason.DIVERGED_DTOL
        reason = int(reason)
    return x, it, reason, float(rnorm), torch.from_numpy(hist)


def cg(A: Operator, b, x0=None, *, M: Optional[Operator] = None,
       rtol=1e-5, atol=1e-50, dtol=1e4, max_it=10000,
       null_project=None, history_len=HISTORY_LEN) -> SolveResult:
    """Preconditioned conjugate gradients (for SPD operators); one host
    synchronisation per iteration, the residual norm."""
    Af, bf, x0f, Mf, Pf, unravel = _flatten_system(A, b, x0, M, null_project)
    xf, it, reason, rnorm, hist = _cg_flat(
        Af, Mf, Pf, bf, x0f, rtol=rtol, atol=atol, dtol=dtol, max_it=max_it,
        history_len=_hist_len(history_len, max_it))
    return SolveResult(unravel(xf), it, reason, rnorm, hist)


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


_KSP_TYPES = {"gmres": gmres, "fgmres": fgmres, "cg": cg, "preonly": preonly}
# KSP types of the JAX package that this package does not carry yet.
_NOT_PORTED = ("bcgs", "bicgstab", "richardson", "chebyshev", "minres")


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

    def solve(self, A: Operator, b, x0=None, *, M=None,
              null_project=None) -> SolveResult:
        """Solve A x = b; b (and x0) a tensor or a dict of tensors."""
        if self.type in _NOT_PORTED:
            raise NotImplementedError(
                f"KSP type {self.type!r} is not ported yet "
                "(ROADMAP.md queue 1, item 1b)")
        if self.type not in _KSP_TYPES:
            raise ValueError(f"unknown KSP type {self.type!r}")
        kwargs = dict(M=M, null_project=null_project, history_len=self.history_len)
        if self.type != "preonly":
            kwargs.update(rtol=self.rtol, atol=self.atol, dtol=self.dtol,
                          max_it=self.max_it)
        if self.type in ("gmres", "fgmres"):
            kwargs["restart"] = self.restart
        return _KSP_TYPES[self.type](A, b, x0, **kwargs)
