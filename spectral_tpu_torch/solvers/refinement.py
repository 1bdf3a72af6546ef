"""Mixed-precision iterative refinement (defect correction).

Counterpart of ``spectral_tpu/solvers/refinement.py``: the preconditioned
Krylov solver runs in float32 on the residual equation while residuals are
evaluated in float64, doubling the attainable accuracy per pass.

- ``refine_solve``: the high-precision state lives in host numpy float64,
  as in the JAX package; each step moves the residual to the device in
  float32 and the correction back.
- ``refine_solve_fused``: one device-resident loop; the float64 state and
  residual stay on the card, the inner solve runs in float32 there, and
  only the residual norm crosses to the host (the loop's stopping test).

The JAX package caches its fused program keyed on the identity of the
callables; that cache once gave wrong answers when reused across
right-hand sides.  Eager torch has nothing to compile, so nothing here is
cached: every call runs the callables it is given on the data it is given.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from spectral_tpu_torch.solvers.types import ConvergedReason


@dataclasses.dataclass
class RefineResult:
    x: Any
    refine_steps: int
    inner_iters: int
    reason: int
    rnorm: float
    history: list[float]


def _to_np64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().to(torch.float64).numpy()
    return np.asarray(a, np.float64)


def refine_solve(A_hi: Callable, inner_solve: Callable, b, *,
                 device: torch.device | str, rtol: float = 1e-10,
                 atol: float = 0.0, max_refine: int = 12,
                 x0=None) -> RefineResult:
    """Solve A x = b to ``rtol`` with float64 host residuals and float32
    inner solves on ``device``.

    Args:
      A_hi: high-precision operator on host float64 arrays (numpy in; numpy
        or a tensor out).
      inner_solve: r32 -> (dx, iters): approximate solve in float32 of a
        tensor on ``device``.
      b: right-hand side (numpy or tensor), held in host float64.
    """
    b = _to_np64(b)
    x = np.zeros_like(b) if x0 is None else _to_np64(x0)
    bnorm = max(float(np.linalg.norm(b)), 1e-300)
    hist = []
    inner_total = 0
    reason = int(ConvergedReason.DIVERGED_ITS)
    steps = 0
    for steps in range(max_refine + 1):
        r = b - _to_np64(A_hi(x))
        rnorm = float(np.linalg.norm(r))
        hist.append(rnorm)
        if rnorm <= max(rtol * bnorm, atol):
            reason = int(ConvergedReason.CONVERGED_RTOL)
            break
        if not np.isfinite(rnorm):
            reason = int(ConvergedReason.DIVERGED_NANORINF)
            break
        if steps == max_refine:
            break
        r32 = torch.from_numpy(r.astype(np.float32)).to(device)
        dx, iters = inner_solve(r32)
        inner_total += int(iters)
        x = x + _to_np64(dx)
    return RefineResult(x, steps, inner_total, reason, hist[-1], hist)


def refine_solve_fused(A_hi: Callable, inner_solve: Callable,
                       b: torch.Tensor, *, rtol: float = 1e-10,
                       atol: float = 0.0, max_refine: int = 12,
                       x0: torch.Tensor | None = None) -> RefineResult:
    """refine_solve with the whole loop on ``b``'s device.

    Args:
      A_hi: float64 operator on device tensors.
      inner_solve: r32 -> (dx32, iters), float32 in and out on the device.
      b: float64 right-hand side tensor on the device.
    Returns RefineResult with ``x`` a float64 tensor on the device.
    """
    if b.dtype != torch.float64:
        raise TypeError(f"refine_solve_fused keeps its state in float64, got b in {b.dtype}")
    bnorm = max(float(torch.linalg.vector_norm(b)), 1e-300)
    tol = max(rtol * bnorm, atol)
    x = torch.zeros_like(b) if x0 is None else x0.to(b.device, torch.float64)
    r = b - A_hi(x)
    rnorm = float(torch.linalg.vector_norm(r))
    hist = [rnorm]
    inner_total = 0
    steps = 0
    while steps < max_refine and rnorm > tol and np.isfinite(rnorm):
        dx, iters = inner_solve(r.to(torch.float32))
        if dx.dtype != torch.float32:
            raise TypeError(f"the inner solve must stay float32, returned {dx.dtype}")
        x = x + dx.to(torch.float64)
        r = b - A_hi(x)
        rnorm = float(torch.linalg.vector_norm(r))
        hist.append(rnorm)
        inner_total += int(iters)
        steps += 1
    if not np.isfinite(rnorm):
        reason = int(ConvergedReason.DIVERGED_NANORINF)
    elif rnorm <= tol:
        reason = int(ConvergedReason.CONVERGED_RTOL)
    else:
        reason = int(ConvergedReason.DIVERGED_ITS)
    return RefineResult(x, steps, inner_total, reason, rnorm, hist)


def build_fused_refiner(A_hi: Callable, inner_solve: Callable,
                        max_refine: int = 12):
    """A handle over ``refine_solve_fused`` for fixed callables: returns
    ``solve(b, *, rtol=1e-10, atol=0.0, x0=None) -> RefineResult``."""

    def solve(b: torch.Tensor, *, rtol: float = 1e-10, atol: float = 0.0,
              x0: torch.Tensor | None = None) -> RefineResult:
        return refine_solve_fused(A_hi, inner_solve, b, rtol=rtol, atol=atol,
                                  max_refine=max_refine, x0=x0)

    return solve
