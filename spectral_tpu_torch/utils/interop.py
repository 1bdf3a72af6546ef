"""Carry state from the JAX package into this one, as numpy arrays.

The JAX package (``spectral_tpu``) is the reference the port is held
against.  These functions take its state as plain numpy arrays (never JAX
objects: this module does not import jax) and build the port's objects
on a given device and dtype, so both packages can apply identical factors
and coefficients.
"""

from __future__ import annotations

import numpy as np
import torch

from spectral_tpu_torch.grid import Grid
from spectral_tpu_torch.ops.fastdiag import FastDiagSolver
from spectral_tpu_torch.ops.stencil import StencilOp


def grid_from_spec(dims, intervals=None, *, device: torch.device | str,
                   dtype: torch.dtype) -> Grid:
    """A Grid with the JAX grid's ``dims`` and ``intervals``."""
    return Grid(tuple(int(n) for n in dims),
                intervals=None if intervals is None else tuple(intervals),
                device=device, dtype=dtype)


def _dev(a, device, dtype) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float64), dtype=dtype, device=device)


def stencil_from_numpy(center, lower, upper, *, device: torch.device | str,
                       dtype: torch.dtype) -> StencilOp:
    """A StencilOp from coefficient fields (center, per-axis lower/upper)."""
    return StencilOp(_dev(center, device, dtype),
                     tuple(_dev(a, device, dtype) for a in lower),
                     tuple(_dev(a, device, dtype) for a in upper))


def fastdiag_from_numpy(grid: Grid, V, Vinv, lam_sum, shift_const=0.0,
                        neumann_fold=(), *, dtype: torch.dtype) -> FastDiagSolver:
    """A FastDiagSolver from the JAX solver's factors (V, Vinv, lam_sum as
    numpy), its build-time shift and its zero-flux fold data, on
    ``grid.device``."""
    folds = tuple(None if f is None else tuple(float(v) for v in f)
                  for f in neumann_fold)
    return FastDiagSolver.from_factors(grid, V, Vinv, lam_sum, shift_const,
                                       folds, dtype=dtype)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def solve_result_to_numpy(res) -> dict[str, np.ndarray]:
    """x, iters, reason, rnorm and history of a SolveResult of either
    package as numpy arrays (history trimmed of its -1 padding)."""
    hist = _np(res.history)
    return {"x": _np(res.x), "iters": int(_np(res.iters)),
            "reason": int(_np(res.reason)), "rnorm": float(_np(res.rnorm)),
            "history": hist[hist >= 0.0]}


def multigrid_from_numpy(grid: Grid, prolong, restrict_coeff, **cfg):
    """A Multigrid on ``grid`` (and its device) from the JAX hierarchy's
    per-level, per-axis transfer matrices as numpy arrays; ``cfg`` takes
    ``builder``, ``pre_smooth``, ``post_smooth``, ``omega``, ``smoother``
    and ``cycles``.  The coarse grids follow from the transfer shapes."""
    from spectral_tpu_torch.ops.multigrid import Multigrid

    grids = [grid]
    for lvl in prolong:
        dims = tuple(int(np.shape(P)[1]) for P in lvl)
        grids.append(Grid(dims, intervals=grid.intervals, device=grid.device,
                          dtype=grid.dtype))
    return Multigrid.from_transfers(tuple(grids), prolong, restrict_coeff, **cfg)


def newton_result_to_numpy(res) -> dict:
    """x, iters, reason, fnorm, fnorm history, per-step Krylov counts and
    the last Krylov history of a NewtonResult of either package, as numpy
    arrays and Python numbers."""
    return {"x": _np(res.x), "iters": int(res.iters), "reason": int(res.reason),
            "fnorm": float(res.fnorm),
            "fnorm_history": np.asarray([float(v) for v in res.fnorm_history]),
            "ksp_iters": [int(k) for k in res.ksp_iters],
            "ksp_history_last": np.asarray([float(v) for v in res.ksp_history_last])}
