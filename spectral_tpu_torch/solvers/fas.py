"""Full Approximation Scheme (FAS) nonlinear multigrid: the PETSc SNESFAS
analog.

Counterpart of ``spectral_tpu/solvers/fas.py``.  The multigrid cycle acts
on the nonlinear problem itself: a coarse level solves the full nonlinear
equation for the full approximation, with the tau correction

    N_H(u_H) = N_H(R u_h) + R (b_h - N_h(u_h)),

so the coarse correction P (u_H - R u_h) carries nonlinear information.
No global Jacobian and no Krylov space on the fine levels: the smoother
is preconditioned nonlinear Richardson with the level's constant-
coefficient fast-diagonalization solve, and the coarsest level is a short
Newton solve.  Levels regenerate the problem operator per grid (a model
factory, as -snes_grid_sequence does); Dirichlet data restricts face by
face, so coarse boundary rows carry pure boundary data.  Every level's
residual takes its last-axis derivatives through K1 on a CUDA state.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from spectral_tpu_torch.ops.multigrid import theta_transfer_np
from spectral_tpu_torch.ops.tensorops import apply_axis_matmul
from spectral_tpu_torch.solvers.krylov import KSPConfig
from spectral_tpu_torch.solvers.newton import NewtonConfig, newton_solve
from spectral_tpu_torch.solvers.types import ConvergedReason


def _level_dims(dims: tuple[int, ...], coarsest: int = 5,
                max_levels: int = 10) -> list[tuple[int, ...]]:
    """The FAS hierarchy, finest first: halve each axis ((n + 1) // 2, at
    least 5) until the largest axis is at most ``coarsest`` or the grid
    has at most 200 nodes."""
    out = [tuple(dims)]
    while len(out) < max_levels:
        d = out[-1]
        if max(d) <= coarsest or int(np.prod(d)) <= 200:
            break
        nd = tuple(max(5, (n + 1) // 2) for n in d)
        if nd == d:
            break
        out.append(nd)
    return out


def _restrict_dirichlet(dir_f: np.ndarray, dims_c: tuple[int, ...]) -> np.ndarray:
    """Coarse Dirichlet field by face-wise restriction: each boundary face
    of the fine grid restricts along its tangential axes only (the normal
    index maps to the same face), so coarse boundary rows carry pure
    boundary data."""
    d = dir_f.ndim
    dims_f = dir_f.shape
    Rs = [theta_transfer_np(dims_f[ax], dims_c[ax])[1] for ax in range(d)]
    out = np.zeros(dims_c, dir_f.dtype)
    for ax in range(d):
        for side in (0, -1):
            sl = [slice(None)] * d
            sl[ax] = side
            face = dir_f[tuple(sl)]
            for t, tax in enumerate([a for a in range(d) if a != ax]):
                face = np.moveaxis(np.tensordot(Rs[tax], np.moveaxis(face, t, 0), axes=1), 0, t)
            osl = [slice(None)] * d
            osl[ax] = side
            out[tuple(osl)] = face
    return out


@dataclasses.dataclass
class FASResult:
    x: torch.Tensor
    iters: int
    reason: int
    rnorm: float
    history: list

    def reason_str(self) -> str:
        return ConvergedReason.describe(self.reason)


class FASSolver:
    """FAS V-cycles over a hierarchy of regenerated elliptic problems.

    Args:
      model_factory: dims -> model exposing ``make_residual(b, dirichlet)``
        (F = N(u) - b on zero-boundary states), ``jacobian_action``,
        ``grid`` and a constant-coefficient solve ``make_pc("fastdiag")``;
        its grid's device and dtype are the solve's.
      dims: fine-grid dims.
      b, dirichlet: fine-level problem data, full-grid tensors (or arrays).
    """

    def __init__(self, model_factory: Callable, dims, b, dirichlet, *,
                 pre_smooth: int = 2, post_smooth: int = 2,
                 omega: float | None = None, coarsest: int = 5):
        self.levels = _level_dims(tuple(dims), coarsest=coarsest)
        self.models = [model_factory(d) for d in self.levels]
        self.pre = pre_smooth
        self.post = post_smooth
        self.omega = omega
        g0 = self.models[0].grid
        self.b_fine = torch.as_tensor(b, device=g0.device)
        dtype, dev = self.b_fine.dtype, self.b_fine.device
        dir_np = (dirichlet.cpu().numpy() if isinstance(dirichlet, torch.Tensor)
                  else np.asarray(dirichlet))
        self.dirichlets = [torch.as_tensor(dir_np, dtype=dtype, device=dev)]
        for d in self.levels[1:]:
            self.dirichlets.append(torch.as_tensor(_restrict_dirichlet(dir_np, d),
                                                   dtype=dtype, device=dev))
        # per-level operators N_l(u) (the residual with b = 0) and smoothers
        self._N, self._M = [], []
        for m, dr in zip(self.models, self.dirichlets):
            res = m.make_residual(torch.zeros(m.grid.dims, dtype=dtype, device=dev), dr)
            self._N.append(lambda u, _res=res: _res(u)[0])
            pcs, pca = m.make_pc("fastdiag")
            state = pcs(None, None) if pcs is not None else None
            self._M.append(lambda r, _pca=pca, _st=state: _pca(_st, r))
        # theta-space transfers between consecutive levels
        self._P, self._R = [], []
        for lf, lc in zip(self.levels[:-1], self.levels[1:]):
            pairs = [theta_transfer_np(lf[ax], lc[ax]) for ax in range(len(dims))]
            self._P.append([torch.as_tensor(P, dtype=dtype, device=dev) for P, _ in pairs])
            self._R.append([torch.as_tensor(R, dtype=dtype, device=dev) for _, R in pairs])

    def _transfer(self, mats, x):
        for ax, M in enumerate(mats):
            x = apply_axis_matmul(M.to(x.dtype), x, ax)
        return x

    def _smooth(self, lvl, u, b, sweeps):
        N, M = self._N[lvl], self._M[lvl]
        g = self.models[lvl].grid
        for _ in range(sweeps):
            u = g.zero_boundary(u - self.omega * M(N(u) - b))
        return u

    def _cycle(self, lvl, u, b):
        g = self.models[lvl].grid
        if lvl == len(self.levels) - 1:
            # coarsest: a short Newton solve of N(u) = b
            m = self.models[lvl]
            out = newton_solve(
                m.make_residual(b, self.dirichlets[lvl]), u,
                jacobian_action=m.jacobian_action,
                ksp=KSPConfig(type="gmres", rtol=1e-8, max_it=60, restart=30),
                config=NewtonConfig(rtol=1e-8, max_it=12, line_search="basic"))
            return out.x
        u = self._smooth(lvl, u, b, self.pre)
        r = b - self._N[lvl](u)
        gc = self.models[lvl + 1].grid
        uH0 = gc.zero_boundary(self._transfer(self._R[lvl], u))
        bH = self._N[lvl + 1](uH0) + gc.zero_boundary(self._transfer(self._R[lvl], r))
        uH = self._cycle(lvl + 1, uH0, bH)
        u = g.zero_boundary(u + self._transfer(self._P[lvl], uH - uH0))
        return self._smooth(lvl, u, b, self.post)

    def _auto_omega(self, u0) -> float:
        """Richardson damping 1 / lambda_max(M J(u0)), lambda_max by 10
        power iterations and a Rayleigh quotient from sin(1..size) (the
        JAX package's start), J by forward-mode differentiation of N."""
        g = self.models[0].grid
        N, M = self._N[0], self._M[0]
        dtype = self.b_fine.dtype
        v = g.zero_boundary(torch.sin(torch.arange(1.0, g.size + 1.0, dtype=torch.float64))
                            .reshape(g.dims).to(dtype=dtype, device=self.b_fine.device))

        def mj(w):
            return M(torch.func.jvp(N, (u0,), (w,))[1])

        for _ in range(10):
            y = mj(v)
            v = y / torch.clamp(torch.linalg.vector_norm(y.reshape(-1)), min=1e-30)
        y = mj(v)
        num = torch.dot(v.reshape(-1), y.reshape(-1))
        den = torch.dot(v.reshape(-1), v.reshape(-1))
        lam = float(num / torch.clamp(den, min=1e-30))
        return 1.0 / max(abs(lam), 1.0)

    def solve(self, x0=None, *, rtol: float = 1e-8, atol: float = 0.0,
              max_cycles: int = 30) -> FASResult:
        """V-cycles until ||N(u) - b|| <= max(rtol ||b||, atol): the
        problem's scale, not the initial residual, so a warm start near
        the solution stops at once.  One host transfer a cycle."""
        g = self.models[0].grid
        u = (torch.zeros(g.dims, dtype=self.b_fine.dtype, device=self.b_fine.device)
             if x0 is None else x0.to(self.b_fine.device, self.b_fine.dtype))
        if self.omega is None:
            self.omega = self._auto_omega(u)

        def rnorm(uu):
            return float(torch.linalg.vector_norm((self._N[0](uu) - self.b_fine).reshape(-1)))

        bnorm = float(torch.linalg.vector_norm(self.b_fine.reshape(-1)))
        tol = max(rtol * max(bnorm, 1e-300), atol)
        r0 = rnorm(u)
        hist = [r0]
        reason = int(ConvergedReason.DIVERGED_ITS)
        its = 0
        if r0 <= tol:
            return FASResult(x=u, iters=0, reason=int(ConvergedReason.CONVERGED_RTOL),
                             rnorm=r0, history=hist)
        for its in range(1, max_cycles + 1):
            u = self._cycle(0, u, self.b_fine)
            rn = rnorm(u)
            hist.append(rn)
            if not np.isfinite(rn):
                reason = int(ConvergedReason.DIVERGED_NANORINF)
                break
            if rn <= tol:
                reason = int(ConvergedReason.CONVERGED_RTOL)
                break
        return FASResult(x=u, iters=its, reason=reason, rnorm=hist[-1], history=hist)
