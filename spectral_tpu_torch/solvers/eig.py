"""Matrix-free eigenanalysis: Krylov-Schur restarted Arnoldi (EPS).

Counterpart of ``spectral_tpu/solvers/eig.py``.  The only device work is
the operator application (one matvec a step, on the vectors' device and in
their dtype); the small dense math (ordered real Schur forms, Ritz
extraction, convergence) runs on the host in float64 numpy.  A state is a
tensor or a dict of tensors, flattened as ``solvers/krylov.py`` flattens
it.

Algorithm: Krylov-Schur (Stewart 2001).  The decomposition is kept in
the general Krylov form A V_p = V_{p+1} H[:p+1, :p], whose square part is
real-Schur quasi-triangular after each restart.  Expansion appends
ordinary Arnoldi columns (classical Gram-Schmidt, twice); contraction
reorders the real Schur form so the wanted Ritz values lead, then
truncates without splitting conjugate 2x2 blocks.  A Ritz pair (theta, y)
has converged when the exact Arnoldi residual |b^T y| is below ``tol``
times the spectral scale.

Basis placement: the (m+1, n) basis lives on the starting vector's device
unless ``device_basis=False``; each step there is the matvec, a masked
CGS2 and the normalized write, and one (m+2)-vector (the projection
coefficients and the norm) crosses to the host.  The JAX package falls
back to the host basis when its operator cannot be compiled; an eager
operator always runs, so this package never switches by itself.  The
device basis orthogonalizes in the operator's dtype: float64 here.

Spectral transforms compose outside (``shift_invert``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from spectral_tpu_torch.solvers.krylov import _leaf_dtype, _ravel


class EPSResult(NamedTuple):
    eigenvalues: np.ndarray     # (k,) complex, sorted by ``which``
    eigenvectors: np.ndarray    # (k, n) complex rows, unit 2-norm
    residuals: np.ndarray       # (k,) Arnoldi residual estimates |b^T y|
    matvecs: int
    restarts: int
    converged: bool
    # float64 polish: one more operator apply a returned pair, the
    # Rayleigh quotient and the explicit residual ||A x - rq x|| in host
    # float64
    eigenvalues_polished: Optional[np.ndarray] = None
    residuals_polished: Optional[np.ndarray] = None


_WHICH = {
    "LR": lambda w: w.real,            # largest real part
    "SR": lambda w: -w.real,
    "LM": lambda w: np.abs(w),         # largest magnitude
    "SM": lambda w: -np.abs(w),
}


def _sort_key(which: str) -> Callable[[np.ndarray], np.ndarray]:
    try:
        return _WHICH[which]
    except KeyError:
        raise ValueError(f"which must be one of {sorted(_WHICH)}, "
                         f"got {which!r}") from None


def _schur_sorted(Hs: np.ndarray, key) -> tuple[np.ndarray, np.ndarray]:
    """Real Schur form of Hs with the eigenvalues ordered by ``key``
    (descending) along the (quasi-)diagonal: repeated selection sweeps of
    scipy's sorted Schur, each moving the best remaining cluster to the
    front of the trailing block."""
    from scipy.linalg import schur

    w = np.linalg.eigvals(Hs)
    ranked = w[np.argsort(-key(w), kind="stable")]

    T, Q = np.array(Hs, float), np.eye(Hs.shape[0])  # copy: sweeps mutate T
    done = 0
    while done < len(ranked) - 1:
        target = ranked[done]

        def make_select(t):
            # a real Schur form cannot split a conjugate 2x2 block: the
            # predicate must accept both members of the pair
            def select(re, im, _t=t):
                z = complex(re, im)
                tol = 1e-9 * (1.0 + abs(_t))
                return abs(z - _t) <= tol or abs(z - np.conj(_t)) <= tol
            return select

        T22, Q22, sdim = schur(T[done:, done:], output="real", sort=make_select(target))
        if sdim == 0:
            # the target drifted past the tolerance (clustered eigenvalues):
            # select the nearest eigenvalue instead
            w22 = np.linalg.eigvals(T[done:, done:])
            target = w22[np.argmin(np.abs(w22 - target))]
            T22, Q22, sdim = schur(T[done:, done:], output="real", sort=make_select(target))
        if sdim == 0:
            # both selections failed: stop reordering.  The decomposition
            # stays a valid similarity; advancing blindly could split a 2x2
            # block and corrupt the trailing sweeps.
            break
        T[done:, done:] = T22
        T[:done, done:] = T[:done, done:] @ Q22
        Q[:, done:] = Q[:, done:] @ Q22
        done += int(sdim)
        # rotations inside the trailing block permute its eigenvalues
        w_rest = np.linalg.eigvals(T[done:, done:])
        ranked = np.concatenate([ranked[:done],
                                 w_rest[np.argsort(-key(w_rest), kind="stable")]])
    return T, Q


def _block_edges(T: np.ndarray) -> np.ndarray:
    """Indices where the quasi-triangular T may be split (no 2x2 block
    straddles the cut): cut c is legal iff T[c, c-1] == 0."""
    n = T.shape[0]
    return np.array([c for c in range(1, n + 1)
                     if c == n or abs(T[c, c - 1]) < 1e-300])


class _HostBasis:
    """Arnoldi basis on the host (float64 numpy): one operator apply on
    the vectors' device and one full-vector transfer each way a step."""

    def __init__(self, A: Callable, unravel, n: int, m: int, dtype, device):
        self.n, self.m = n, m
        self.V = np.zeros((m + 1, n))
        self._A, self._unravel = A, unravel
        self._dtype, self._device = dtype, device

    def init(self, r0: np.ndarray):
        self.V[0] = r0

    def expand_step(self, j: int) -> tuple[np.ndarray, float]:
        v = torch.as_tensor(self.V[j], dtype=self._dtype, device=self._device)
        w = _ravel(self._A(self._unravel(v)), self._dtype)[0].cpu().numpy().astype(np.float64)
        h = np.zeros(self.m + 1)
        for _ in range(2):
            c = self.V[:j + 1] @ w
            h[:j + 1] += c
            w -= c @ self.V[:j + 1]
        beta = float(np.linalg.norm(w))
        if beta > 1e-300:
            self.V[j + 1] = w / beta
        return h, beta

    def breakdown_restart(self, j: int, seed: int) -> float:
        w = np.random.default_rng(seed).standard_normal(self.n)
        for _ in range(2):
            w -= (self.V[:j + 1] @ w) @ self.V[:j + 1]
        b = float(np.linalg.norm(w))
        if b >= 1e-300:
            self.V[j + 1] = w / b
        return b

    def contract(self, Q: np.ndarray, p: int, me: int):
        self.V[:p] = Q[:, :p].T @ self.V[:me]
        self.V[p] = self.V[me]

    def extract(self, Q: np.ndarray, Yk: np.ndarray, me: int) -> np.ndarray:
        return (self.V[:me].T @ (Q @ Yk)).T


class _DeviceBasis:
    """Arnoldi basis on the vectors' device, in their dtype: a step is the
    matvec, a masked CGS2 and the normalized write; only the coefficients
    and the norm (one transfer) cross to the host."""

    def __init__(self, A: Callable, unravel, n: int, m: int, dtype, device):
        self.n, self.m = n, m
        self._A, self._unravel = A, unravel
        self._dtype, self._device = dtype, device
        self.V = torch.zeros((m + 1, n), dtype=dtype, device=device)
        self._rows = torch.arange(m + 1, device=device)
        self._tiny = float(torch.finfo(dtype).tiny)

    def init(self, r0: np.ndarray):
        self.V[0] = torch.as_tensor(r0, dtype=self._dtype, device=self._device)

    def expand_step(self, j: int) -> tuple[np.ndarray, float]:
        V = self.V
        w = _ravel(self._A(self._unravel(V[j])), self._dtype)[0]
        mask = self._rows <= j
        h = torch.zeros(self.m + 1, dtype=self._dtype, device=self._device)
        for _ in range(2):   # CGS2: rows past j masked out
            c = torch.where(mask, V @ w, 0.0)
            h = h + c
            w = w - c @ V
        beta = torch.linalg.vector_norm(w)
        V[j + 1] = w / torch.clamp(beta, min=self._tiny)
        host = torch.cat([h, beta[None]]).cpu().numpy().astype(np.float64)
        return host[:-1], float(host[-1])

    def breakdown_restart(self, j: int, seed: int) -> float:
        # the rare path (an exact invariant subspace): host arithmetic
        V = self.V.cpu().numpy().astype(np.float64)
        w = np.random.default_rng(seed).standard_normal(self.n)
        for _ in range(2):
            w -= (V[:j + 1] @ w) @ V[:j + 1]
        b = float(np.linalg.norm(w))
        if b >= 1e-300:
            self.V[j + 1] = torch.as_tensor(w / b, dtype=self._dtype, device=self._device)
        return b

    def contract(self, Q: np.ndarray, p: int, me: int):
        m = self.m
        Qp = np.zeros((m, m))
        Qp[:me, :p] = Q[:, :p]
        Vp = torch.as_tensor(Qp, dtype=self._dtype, device=self._device).T @ self.V[:m]
        # rows past p come out zero; row p becomes the continuation vector
        Vp[p] = self.V[me]
        self.V[:m] = Vp

    def extract(self, Q: np.ndarray, Yk: np.ndarray, me: int) -> np.ndarray:
        Vh = self.V[:me].cpu().numpy().astype(np.float64)   # one transfer, at the end
        return (Vh.T @ (Q @ Yk)).T


def eigs(A: Callable, v0, k: int = 4, *, which: str = "LR", m: int = 0,
         tol: float = 1e-8, max_restarts: int = 60,
         transform: Optional[Callable] = None,
         device_basis: Optional[bool] = None,
         polish: bool = True) -> EPSResult:
    """k eigenpairs of the matrix-free operator ``A`` (state -> state).

    ``v0``: starting vector (a tensor or a dict of tensors); it fixes the
    shape, dtype and device of the matvecs.
    ``m``: Arnoldi basis size (default max(2k+8, 20)).
    ``transform``: optional map applied to the returned eigenvalues (e.g.
    ``lambda mu: sigma + 1/mu`` after shift-invert); sorting and
    convergence run on the untransformed spectrum.
    ``device_basis``: None or True keeps the basis on v0's device, False
    keeps it in host float64 numpy.
    ``polish`` (default on): each returned Ritz pair gets one more
    operator apply, with the Rayleigh quotient and the explicit residual
    ``||A x - rq x||`` accumulated in host float64 (``eigenvalues_polished``
    are transformed).  As in the JAX package, these applies are counted in
    ``matvecs``.

    Returns an EPSResult; ``converged`` is False if the residual target was
    not met within ``max_restarts`` (the best pairs are still returned).
    """
    dtype = _leaf_dtype(v0)
    v0f, unravel = _ravel(v0, dtype)
    device = v0f.device
    n = v0f.shape[0]
    m = int(m) if m else max(2 * k + 8, 20)
    m = min(m, n)
    if k > m - 2:
        raise ValueError(f"k={k} needs basis m >= k+2 (m={m}, n={n})")
    key = _sort_key(which)

    r0 = v0f.cpu().numpy().astype(np.float64)
    nrm = np.linalg.norm(r0)
    if nrm == 0:
        raise ValueError("starting vector is zero")

    basis = (_HostBasis if device_basis is False else _DeviceBasis)(
        A, unravel, n, m, dtype, device)
    basis.init(r0 / nrm)

    H = np.zeros((m + 1, m))
    me = m                      # effective basis size (shrinks only on the
    p = 0                       # exhausted-breakdown corner)
    matvecs = 0
    restarts = 0
    scale = 1.0                 # running spectral scale for the relative tol
    while True:
        # -- expand p -> me with ordinary Arnoldi columns (CGS2) ---------
        j = p
        while j < me:
            h, beta = basis.expand_step(j)
            matvecs += 1
            H[:, j] += h
            H[j + 1, j] = beta
            if beta < 1e-13 * max(scale, 1.0):
                # happy breakdown: an exact invariant subspace.  Restart the
                # expansion from a fresh random direction so the basis can
                # still grow to me.
                if basis.breakdown_restart(j, seed=j) < 1e-300:
                    me = j + 1
                    break
                H[j + 1, j] = 0.0
            j += 1

        # -- Schur-sort the square part, wanted values first -------------
        Hs = H[:me, :me]
        scale = max(np.max(np.abs(np.linalg.eigvals(Hs))), 1e-300)
        T, Q = _schur_sorted(Hs, key)
        b = H[me, me - 1] * Q[me - 1, :]       # new coupling row

        # -- convergence of the k wanted Ritz pairs ----------------------
        wT, Y = np.linalg.eig(T)
        order = np.argsort(-key(wT), kind="stable")
        wT, Y = wT[order], Y[:, order]
        kk = min(k, me)
        res = np.abs(b @ Y[:, :kk]) / max(scale, 1e-300)
        done = bool(np.all(res < tol))
        if done or restarts >= max_restarts:
            lam = wT[:kk]
            X = basis.extract(Q, Y[:, :kk], me)  # (kk, n) complex rows
            X = X / np.linalg.norm(X, axis=1, keepdims=True)
            lam_p = res_p = None
            if polish:
                def apply64(xr):
                    v = torch.as_tensor(xr, dtype=dtype, device=device)
                    return _ravel(A(unravel(v)), dtype)[0].cpu().numpy().astype(np.float64)

                lam_p = np.empty(kk, complex)
                res_p = np.empty(kk)
                for i in range(kk):
                    x = X[i]
                    Ax = apply64(np.ascontiguousarray(x.real))
                    matvecs += 1
                    if np.abs(x.imag).max() > 0.0:
                        Ax = Ax + 1j * apply64(np.ascontiguousarray(x.imag))
                        matvecs += 1
                    rq = np.vdot(x, Ax)          # x is unit-norm
                    lam_p[i] = rq
                    res_p[i] = np.linalg.norm(Ax - rq * x)
                if transform is not None:
                    lam_p = np.asarray([transform(z) for z in lam_p])
            if transform is not None:
                lam = np.asarray([transform(z) for z in lam])
            return EPSResult(lam, X, res * scale, matvecs, restarts, done, lam_p, res_p)

        # -- contract: keep p ~ k + me//2 columns, not splitting blocks --
        edges = _block_edges(T)
        p_want = min(kk + (me - kk) // 2, me - 1)
        legal = edges[(edges >= min(kk, edges[-1])) & (edges < me)]
        if len(legal) == 0:
            legal = edges[edges < me] if np.any(edges < me) else edges[:1]
        p = int(legal[np.argmin(np.abs(legal - p_want))])
        basis.contract(Q, p, me)
        H[:, :] = 0.0
        H[:p, :p] = T[:p, :p]
        H[p, :p] = b[:p]
        restarts += 1


def shift_invert(solve: Callable, sigma: float):
    """(operator, transform) pair for shift-invert eigenanalysis.

    ``solve(b)`` must return (A - sigma I)^{-1} b.  Pass both to ``eigs``:

        op, back = shift_invert(solve, sigma)
        res = eigs(op, v0, k, which="LM", transform=back)

    ``which="LM"`` on the transformed operator selects the eigenvalues of A
    closest to sigma (mu = 1/(lambda - sigma) is largest there).
    """
    return solve, (lambda mu: sigma + 1.0 / mu)
