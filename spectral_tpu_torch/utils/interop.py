"""Carry state from the JAX package into this one, as numpy arrays.

The JAX package (``spectral_tpu``) is the reference the port is held
against.  These functions take its state as plain numpy arrays (never JAX
objects: JAX is never imported here) and build the port's objects
on a given device and dtype, so both packages can apply identical factors
and coefficients.
"""

from __future__ import annotations

import dataclasses

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


def _np(a):
    """A tensor or array as numpy; a dict (a Stokes state) leaf by leaf."""
    if isinstance(a, dict):
        return {k: _np(v) for k, v in a.items()}
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def solve_result_to_numpy(res) -> dict[str, np.ndarray]:
    """x, iters, reason, rnorm and history of a SolveResult of either
    package as numpy arrays (history trimmed of its -1 padding; x a dict
    of arrays for a dict state)."""
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
        maps = (None if grid.maps is None
                else tuple(m.restrict(n) for m, n in zip(grid.maps, dims)))
        grids.append(Grid(dims, intervals=grid.intervals, maps=maps, device=grid.device,
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


def stokes_state_from_numpy(state, *, device: torch.device | str,
                            dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """A Stokes state {"v": (dims..., d), "p": dims} of either package (or
    of numpy arrays) as this package's tensors in ``dtype`` on ``device``."""
    return {k: _dev(_np(state[k]), device, dtype) for k in ("v", "p")}


def stokes_state_to_numpy(state) -> dict[str, np.ndarray]:
    """A Stokes state of either package as float64 numpy arrays."""
    return {k: np.asarray(_np(state[k]), np.float64) for k in ("v", "p")}


# the set-up fields two StokesProblems must agree on, by attribute name
_STOKES_MASKS = ("vel_mask", "p_mask", "dirichlet_mask", "nm_mask", "mixed_mask",
                 "neumann_mask")
_STOKES_FIELDS = ("bc_vel", "bc_vnormal_np", "alpha", "normal", "in_onehot",
                  "exact_v", "exact_p")


def stokes_problem_fields_to_numpy(problem) -> dict:
    """The set-up of a StokesProblem of either package as numpy: the masks
    (bool), boundary data, normals, the exact fields, the forcing
    ("force_v", "force_p"), the node types and the counts (num_mixed,
    num_neumann, has_p_null), so that two problems can be held equal field
    by field."""
    out = {k: np.asarray(_np(getattr(problem, k)), bool) for k in _STOKES_MASKS}
    for k in _STOKES_FIELDS:
        out[k.removesuffix("_np")] = np.asarray(_np(getattr(problem, k)), np.float64)
    out["force_v"] = np.asarray(_np(problem.force["v"]), np.float64)
    out["force_p"] = np.asarray(_np(problem.force["p"]), np.float64)
    out["types"] = np.asarray(problem.types_np)
    for k in ("num_mixed", "num_neumann", "has_p_null"):
        out[k] = getattr(problem, k)
    return out


def linearization_from_numpy(lin_state, *, device: torch.device | str,
                             dtype: torch.dtype) -> tuple[torch.Tensor, ...]:
    """A linearization state (eta, deta, S) of either package (or of numpy
    arrays) as this package's tensors in ``dtype`` on ``device``."""
    return tuple(_dev(_np(a), device, dtype) for a in lin_state)


def coupled_stencil_to_numpy(stencil) -> tuple[tuple, tuple]:
    """(offsets, coefficient arrays) of a coupled stencil (``Q1StrainStencil``
    of either package: the Q1 assembly or the full colored probe)."""
    return (tuple(tuple(int(o) for o in off) for off in stencil.offsets),
            tuple(np.asarray(_np(c), np.float64) for c in stencil.coef))



def dense_apply_from_numpy(Ainv, example, *, device: torch.device | str,
                           dtype: torch.dtype, transpose: bool = False):
    """The port's ``dense_apply`` of a dense inverse given as numpy (the
    JAX package's ``regularized_inverse`` output), in ``dtype`` on
    ``device``, for states shaped like ``example`` (a tensor or a dict of
    tensors, e.g. ``StokesProblem.zero_state()``): both packages flatten a
    state in the same order, so the factors carry across entry by entry."""
    from spectral_tpu_torch.ops.dense import dense_apply
    from spectral_tpu_torch.solvers.krylov import _ravel

    _, unravel = _ravel(example, dtype)
    return dense_apply(_dev(Ainv, device, dtype), unravel, transpose=transpose)


def convection_state_from_numpy(T, x, *, device: torch.device | str,
                                dtype: torch.dtype) -> tuple[torch.Tensor, dict]:
    """A convection state (T, x) of the JAX package, T and the saddle
    state x = {"v", "p"} as numpy arrays, as the port's tensors."""
    return _dev(T, device, dtype), stokes_state_from_numpy(x, device=device, dtype=dtype)


def eps_result_to_numpy(res) -> dict:
    """An EPSResult (of either package) as a dict of numpy arrays and
    Python scalars (None where the polish was off)."""
    return {k: (None if v is None else v if np.isscalar(v) else np.asarray(v))
            for k, v in res._asdict().items()}


def _leaf_np(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    a = np.asarray(a, np.float64)
    return float(a) if a.ndim == 0 else a


def pytree_to_numpy(tree):
    """A pytree of either package (a dict, a PowerLawParams, a tensor or
    an array) as a dict of float64 numpy leaves (0-d leaves as floats)
    keyed by field or key; a bare leaf as itself."""
    if isinstance(tree, dict):
        return {k: pytree_to_numpy(v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return {f.name: pytree_to_numpy(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    return _leaf_np(tree)


def power_law_params_from_numpy(fields, *, device: torch.device | str,
                                dtype: torch.dtype = torch.float64):
    """PowerLawParams with 0-d tensor fields (the form the adjoint tier
    differentiates) from a dict of numbers or from either package's
    PowerLawParams."""
    from spectral_tpu_torch.models.rheology import PowerLawParams

    if not isinstance(fields, dict):
        fields = pytree_to_numpy(fields)
    return PowerLawParams(**{k: torch.tensor(float(v), dtype=dtype, device=device)
                             for k, v in fields.items()})


def optimize_result_to_numpy(res) -> dict:
    """x (as pytree_to_numpy), f, gnorm, iters, nfev, reason and history of
    an OptimizeResult of either package."""
    return {"x": pytree_to_numpy(res.x), "f": float(res.f), "gnorm": float(res.gnorm),
            "iters": int(res.iters), "nfev": int(res.nfev), "reason": int(res.reason),
            "history": [float(h) for h in res.history]}


def axis_map_from_numpy(x, w):
    """An AxisMap from a JAX AxisMap's node positions and weights (its
    ``x`` and ``w`` tuples, or numpy arrays)."""
    from spectral_tpu_torch.ops.mapping import AxisMap

    return AxisMap(tuple(float(v) for v in np.asarray(x, np.float64)),
                   tuple(float(v) for v in np.asarray(w, np.float64)))


def curvilinear_map_from_numpy(grid: Grid, coords, detJ, Acoef, Jinv):
    """A CurvilinearMap on ``grid`` from a JAX CurvilinearMap's float64
    fields (its ``coords``, ``detJ``, ``Acoef`` and ``Jinv``); the
    cofactor follows from the coordinates, as in the JAX package."""
    from spectral_tpu_torch.ops.curvilinear import CurvilinearMap

    return CurvilinearMap(grid=grid, coords=np.array(coords, np.float64),
                          detJ=np.array(detJ, np.float64), Acoef=np.array(Acoef, np.float64),
                          Jinv=np.array(Jinv, np.float64))
