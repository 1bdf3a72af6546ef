"""The port's GMRES / FGMRES against the JAX package's on fastdiag-
preconditioned Poisson, float64, with the PC factors carried across so
both solves apply identical numbers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectral_tpu.grid import Grid as JGrid
from spectral_tpu.models.poisson import PoissonModel as JPoisson
from spectral_tpu.ops.fastdiag import FastDiagSolver as JFastDiag
from spectral_tpu.solvers import krylov as jkrylov
from spectral_tpu_torch.models.poisson import PoissonModel
from spectral_tpu_torch.solvers import krylov as tkrylov
from spectral_tpu_torch.solvers.types import ConvergedReason
from spectral_tpu_torch.utils.interop import (fastdiag_from_numpy, grid_from_spec,
                                              solve_result_to_numpy)


def _systems(dims):
    jm = JPoisson(JGrid(dims))
    u, f = jm.exact_solution()
    b = np.array(jm.rhs(u, f))  # a writable copy for torch.from_numpy
    jfd = JFastDiag.build(jm.grid)
    tm = PoissonModel(grid_from_spec(dims, device="cpu", dtype=torch.float64))
    tfd = fastdiag_from_numpy(tm.grid, [np.asarray(a) for a in jfd.V],
                              [np.asarray(a) for a in jfd.Vinv],
                              np.asarray(jfd.lam_sum), dtype=torch.float64)
    return jm, jfd, tm, tfd, b


@pytest.mark.parametrize("dims,ksp_type,restart,iters", [
    ((12, 12, 12), "gmres", 30, 7),
    ((16, 16), "gmres", 30, 5),
    ((12, 12, 12), "fgmres", 30, None),
    ((16, 16), "fgmres", 30, None),
    ((12, 12, 12), "gmres", 3, None),   # restarts: the reconstructed residual
    ((16, 16), "fgmres", 2, None),
])
def test_solve_matches_jax(dims, ksp_type, restart, iters):
    jm, jfd, tm, tfd, b = _systems(dims)
    kw = dict(rtol=1e-10, max_it=200, restart=restart)
    jfn = getattr(jkrylov, ksp_type)
    jres = jax.jit(lambda bb: jfn(jm.operator, bb, M=jfd, **kw))(jnp.asarray(b))
    tres = getattr(tkrylov, ksp_type)(tm.operator, torch.from_numpy(b), M=tfd, **kw)
    J, T = solve_result_to_numpy(jres), solve_result_to_numpy(tres)
    if iters is not None:
        assert J["iters"] == iters
    if restart < J["iters"]:
        assert J["iters"] > restart  # the case does restart
    assert T["iters"] == J["iters"]
    assert T["reason"] == J["reason"] == ConvergedReason.CONVERGED_RTOL
    # histories to relative 1e-8, norm-wise like x: the two operators sum in
    # another order, so the last entries (1e-11 of the first) carry an
    # absolute error of float64 round-off of the first, up to ~1e-7 of
    # themselves; norm-wise the two agree to ~1e-15
    assert T["history"].shape == J["history"].shape
    hdiff = np.linalg.norm(T["history"] - J["history"])
    assert hdiff <= 1e-8 * np.linalg.norm(J["history"]), hdiff
    # x to relative 1e-10 (norm-wise)
    assert np.linalg.norm(T["x"] - J["x"]) <= 1e-10 * np.linalg.norm(J["x"])
    assert T["x"].shape == tuple(dims)


def test_ksp_config_solve_and_unported_types():
    jm, jfd, tm, tfd, b = _systems((8, 8))
    cfg = tkrylov.KSPConfig(type="fgmres", rtol=1e-10, max_it=50)
    res = cfg.solve(tm.operator, torch.from_numpy(b), M=tfd)
    assert res.reason == ConvergedReason.CONVERGED_RTOL
    assert len(res.history_list()) == res.iters + 1
    assert res.history.shape == (256,)
    # cg is ported (tests/test_torch_heat.py); bicgstab still waits
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tkrylov.KSPConfig(type="bicgstab").solve(tm.operator, torch.from_numpy(b))


def test_max_it_reason_matches_jax():
    """A solve cut by max_it reports DIVERGED_ITS with the same count."""
    jm, jfd, tm, tfd, b = _systems((12, 12))
    kw = dict(rtol=1e-14, max_it=3, restart=30)
    jres = jax.jit(lambda bb: jkrylov.gmres(jm.operator, bb, M=jfd, **kw))(jnp.asarray(b))
    tres = tkrylov.gmres(tm.operator, torch.from_numpy(b), M=tfd, **kw)
    assert int(jres.reason) == tres.reason == ConvergedReason.DIVERGED_ITS
    assert int(jres.iters) == tres.iters == 3
