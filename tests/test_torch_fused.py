"""The port's fused solves (the JAX package's single-dispatch interfaces,
over the port's host loops) on the CPU, in float64: ``make_fused_newton``
against the port's ``newton_solve`` on the 12^2 elliptic problem,
``solve_refined_fused`` against the port's ``solve_refined`` at 8x8, and
``stokes -fused`` against the port's own host-loop CLI run of the same
command line.

The JAX package's own tests show its fused and host loops equal step for
step in float64 (tests/test_refined_fused.py:108-131), so the host loop
is the oracle here; the fused continuation is held to the JAX package in
tests/test_torch_stokes.py.
"""

import contextlib
import io
import json
import re

import numpy as np
import pytest
import torch

from spectral_tpu_torch.cli.main import main as t_main
from spectral_tpu_torch.grid import Grid
from spectral_tpu_torch.models.elliptic import EllipticModel
from spectral_tpu_torch.models.stokes import StokesConfig, StokesProblem
from spectral_tpu_torch.solvers.krylov import KSPConfig
from spectral_tpu_torch.solvers.newton import NewtonConfig, make_fused_newton, newton_solve
from spectral_tpu_torch.solvers.types import ConvergedReason

POWER_LAW = dict(exact=2, rheology=1, cont=2, regularization=1e-2, exponent=3.0)


@pytest.fixture(scope="module")
def elliptic12():
    tm = EllipticModel(Grid((12, 12), device="cpu"), gamma=1.0)
    _, b, d = tm.setup_problem(exact=0)
    return tm, tm.make_residual(b, d), tm.make_pc("fastdiag", dtype=b.dtype), torch.zeros_like(b)


@pytest.mark.parametrize("config,reason", [
    (NewtonConfig(rtol=1e-8), ConvergedReason.CONVERGED_RTOL),
    (NewtonConfig(rtol=1e-8, ksp_ew=True, pc_lag=2), ConvergedReason.CONVERGED_RTOL),
    (NewtonConfig(rtol=1e-30, max_it=2), ConvergedReason.DIVERGED_ITS),
    (NewtonConfig(atol=1e6), ConvergedReason.CONVERGED_ATOL),
    (NewtonConfig(stol=1.0), ConvergedReason.CONVERGED_SNORM_RELATIVE),
    (NewtonConfig(rtol=1e-8, line_search="basic"), ConvergedReason.CONVERGED_RTOL),
    ("nan", ConvergedReason.DIVERGED_NANORINF),
    ("jfnk", ConvergedReason.CONVERGED_RTOL)],
    ids=["rtol", "ew-lag", "max_it", "atol", "stol", "basic", "nan", "jfnk"])
def test_fused_newton_matches_host_loop(elliptic12, config, reason):
    """The same iterates, counts and norms as newton_solve (the same
    kernels in the same order), the reason by the host loop's precedence,
    the histories padded with -1 to max_it and max_it + 1."""
    tm, residual, (pc_setup, pc_apply), x0 = elliptic12
    jac = tm.jacobian_action
    if config == "nan":
        config = NewtonConfig()
        base = residual

        def residual(x):
            F, ls = base(x)
            return F * float("nan"), ls
    elif config == "jfnk":
        config, jac = NewtonConfig(rtol=1e-8), None
    kw = dict(jacobian_action=jac, pc_setup=pc_setup, pc_apply=pc_apply,
              ksp=KSPConfig(type="fgmres", rtol=1e-5, max_it=300), config=config)
    host = newton_solve(residual, x0, **kw)
    run = make_fused_newton(lambda x, theta: residual(x), **kw)
    x, fnorm, fnorm0, iters, kits, hist, got = run(x0, None)
    assert got == host.reason == int(reason)
    assert iters == host.iters
    assert kits.dtype == torch.int32 and kits.shape == (config.max_it,)
    assert hist.dtype == torch.float64 and hist.shape == (config.max_it + 1,)
    assert kits[:iters].tolist() == host.ksp_iters and bool((kits[iters:] == -1).all())
    assert bool((hist[iters + 1:] == -1).all())
    if reason == ConvergedReason.DIVERGED_NANORINF:
        assert np.isnan(fnorm) and np.isnan(host.fnorm)
        return
    assert hist[:iters + 1].tolist() == host.fnorm_history and fnorm == host.fnorm
    assert fnorm0 == host.fnorm_history[0]
    torch.testing.assert_close(x, host.x, rtol=0, atol=0)


def test_fused_newton_refuses_recycling():
    with pytest.raises(ValueError, match="host-loop-only"):
        make_fused_newton(lambda x, t: (x, None), config=NewtonConfig(recycle=2))


@pytest.mark.parametrize("cfg,fused_continuation", [
    (dict(exact=2, cont0=1), False),
    (dict(POWER_LAW, pcvel="mg", outer_ksp=KSPConfig(type="fgmres", rtol=1e-5, max_it=120,
                                                     restart=60),
          newton=NewtonConfig(rtol=2e-4, max_it=30, ksp_ew=True)), True)],
    ids=["linear", "powerlaw"])
def test_solve_refined_fused_matches_host_loop(cfg, fused_continuation):
    """8x8: rel residual <= 1e-10 and the solution within 1e-9 of
    solve_refined's (each solves the same system to rel 1e-10); the
    float32 stages stay float32, the state float64."""
    tp = StokesProblem(Grid((8, 8), device="cpu"), StokesConfig(**cfg))
    x, info = tp.solve_refined_fused(rtol=1e-10, fused_continuation=fused_continuation)
    xh, _ = tp.solve_refined(rtol=1e-10)
    assert info["rel_residual"] <= 1e-10, info
    assert x["v"].dtype == np.float64
    assert info["refine_steps"] == len(info["refine_history"]) - 1 >= 1
    assert all(r.x is None for r in info["continuation"][:-1])
    assert all(r.x["v"].dtype == torch.float32 for r in info["continuation"][-1:])
    for k in ("v", "p"):
        np.testing.assert_allclose(x[k], xh[k], rtol=0, atol=1e-9)


def _run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = t_main(["stokes", "-device", "cpu", *argv])
    return rc, buf.getvalue()


def _steps(out):
    m = re.search(r"Continuation steps: Newton (\[.*\])  Krylov (\[.*\])", out)
    return json.loads(m.group(1)), json.loads(m.group(2))


@pytest.mark.parametrize("argv", [
    ["-exact", "2", "-rheology", "1", "-cont", "2", "-eps", "1e-2", "-exponent", "3",
     "-dim", "10,10"],
    # float64 keeps -ksp_rtol: the state's dtype clamps it (50 eps of float64)
    ["-exact", "2", "-cont0", "1", "-dim", "8,8", "-ksp_rtol", "1e-10"]],
    ids=["powerlaw", "rtol-pin"])
def test_cli_fused_matches_host_loop(argv):
    """The JAX driver's "[fused i/n] ... Newton / ... Krylov, reason ..."
    lines (spectral_tpu/cli/drivers.py:483-485), one a continuation step,
    with the host-loop run's counts step for step, and the same solve."""
    rc_h, out_h = _run(argv)
    rc_f, out_f = _run([*argv, "-fused"])
    assert rc_h == rc_f == 0
    newton, krylov = _steps(out_h)
    assert _steps(out_f) == (newton, krylov)
    lines = [re.fullmatch(r"  \[fused (\d+)/(\d+)\] (\d+) Newton / (\d+) Krylov, "
                          r"reason (CONVERGED_\w+)", ln)
             for ln in out_f.splitlines() if "[fused" in ln]
    assert [tuple(int(v) for v in m.groups()[:4]) for m in lines] == [
        (i, len(newton) - 1, n, sum(k)) for i, (n, k) in enumerate(zip(newton, krylov))]
    assert f"Reason for solver termination: {lines[-1].group(5)}" in out_h
    drop = ("[fused", "Continuation steps", "WARNING")
    assert ([ln for ln in out_f.splitlines() if not ln.startswith(drop) and "[fused" not in ln]
            == [ln for ln in out_h.splitlines() if not ln.startswith(drop)])


def test_cli_fused_excludes_checkpointing():
    with pytest.raises(SystemExit, match="mutually exclusive"):
        _run(["-dim", "6,6", "-fused", "-checkpoint_dir", "ck"])
