"""The port's SNES family (trust-region Newton, L-BFGS, Anderson, NGMRES,
Krylov recycling in Newton), FAS and the elliptic CLI's -snes_type against
the JAX package, float64 on the CPU.

Every case runs the port and the JAX package on the same problem (the
JAX package's own test problems: the nk.c 1-D problem and the 16x16
nonlinear elliptic one) and holds the port to the JAX run: the same
iteration and Krylov counts and converged reason, the fnorm history to
1e-8 relative norm-wise (the repo's rule for histories) and entry by entry
to 1e-8 relative plus 1e-12 of the first entry (a residual near
convergence is the difference of terms of the size of the first one, so
it carries their round-off, ~1e-14 here, which the two packages'
summation orders set differently), the solution's norm to 1e-8 relative
(the solves stop at rtol 1e-9 to 1e-10), and its error at the exact
solution within the JAX tests' bounds.

Each test runs its JAX solve once.  The JAX package compiles a solver's
step on every call, and NGMRES composed with a Newton step calls
newton_solve once an outer iteration: those JAX runs go op by op
(``jax.disable_jit``), which costs them less than a compile an iteration
and computes the same iterations.
"""

import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectral_tpu.cli.drivers import elliptic_main as j_elliptic_main
from spectral_tpu.grid import Grid as JGrid
from spectral_tpu.models.elliptic import EllipticModel as JElliptic
from spectral_tpu.solvers import fas as jfas
from spectral_tpu.solvers import newton as jnewton
from spectral_tpu.solvers.krylov import KSPConfig as JKSP
from spectral_tpu.utils.options import Options as JOptions
from spectral_tpu_torch.cli.main import main as t_main
from spectral_tpu_torch.grid import Grid
from spectral_tpu_torch.models.elliptic import EllipticModel
from spectral_tpu_torch.solvers import fas as tfas
from spectral_tpu_torch.solvers import newton as tnewton
from spectral_tpu_torch.solvers.krylov import KSPConfig
from spectral_tpu_torch.solvers.types import ConvergedReason

RTOL = 1e-8

# the package's solver module, Krylov configuration and x0 maker
PKG = {
    "jax": (jnewton, JKSP, lambda shape, v=0.0: jnp.full(shape, v)),
    "torch": (tnewton, KSPConfig, lambda shape, v=0.0: torch.full(shape, v, dtype=torch.float64)),
}


def _hist(th, jh):
    th, jh = np.asarray(th, np.float64), np.asarray(jh, np.float64)
    assert th.shape == jh.shape
    assert np.linalg.norm(th - jh) <= RTOL * np.linalg.norm(jh)
    np.testing.assert_allclose(th, jh, rtol=RTOL, atol=1e-12 * jh[0])


def _xnorm(x) -> float:
    return float(np.linalg.norm(np.asarray(x)))


def _held(T, J):
    """The port's NewtonResult T against the JAX package's J."""
    assert (T.iters, T.reason) == (J.iters, J.reason), (T.iters, J.iters, T.reason_str())
    assert [int(k) for k in T.ksp_iters] == [int(k) for k in J.ksp_iters]
    _hist(T.fnorm_history, J.fnorm_history)
    assert _xnorm(T.x) == pytest.approx(_xnorm(J.x), rel=RTOL)


# -- trust-region Newton on nk.c's problem (tests/test_newton.py) ---------------

def _nk_problem(pkg, n=32):
    """nk.c:213-233's finite-difference residual with its exact Jacobian
    action (the tridiagonal d (w_{i-1} - 2 w_i + w_{i+1}) + 2 u_i w_i,
    identity rows at the ends), in ``pkg``'s arrays: the trust-region
    logic under test, without forward-mode differentiation's cost."""
    xg = np.linspace(0.0, 1.0, n)
    f = 6.0 * xg + (xg + 1e-12) ** 6
    f, cat = (jnp.asarray(f), jnp.concatenate) if pkg == "jax" else (torch.from_numpy(f),
                                                                     torch.cat)
    d = float((n - 1) ** 2)

    def residual(u):
        interior = d * (u[:-2] - 2.0 * u[1:-1] + u[2:]) + u[1:-1] ** 2 - f[1:-1]
        return cat([u[:1], interior, u[-1:] - 1.0]), u

    def jac(x, u, w):
        interior = d * (w[:-2] - 2.0 * w[1:-1] + w[2:]) + 2.0 * u[1:-1] * w[1:-1]
        return cat([w[:1], interior, w[-1:]])

    return residual, jac


# start, delta0, Newton max_it, Krylov max_it (the JAX tests' settings): the
# basin, the far start, the merit's local minimum
TR_CASES = {
    "basin": (0.5, 0.2, 30, 500),
    "far": (-20.0, 0.5, 80, 500),
    "local min": (2.0, 0.5, 80, 500),
}


def _tr(pkg, name):
    mod, ksp, full = PKG[pkg]
    u0, delta0, max_it, kmax = TR_CASES[name]
    residual, jac = _nk_problem(pkg)
    return mod.newton_tr_solve(residual, full((32,), u0), jacobian_action=jac,
                               ksp=ksp(type="gmres", rtol=1e-10, max_it=kmax),
                               config=mod.NewtonConfig(rtol=1e-10, max_it=max_it),
                               delta0=delta0)


# nk.c's operator has entries up to 4 (n-1)^2 ~ 4e3, so its residual carries
# round-off of ~1e-11 absolute: a linear solve whose target rtol ||F_k||
# lies below NK_FLOOR = 1e-10 (unpreconditioned GMRES at rtol 1e-10 from
# ||F_k|| < 1) ends on round-off, and its count differs between two
# summation orders (55 and 295 on the basin start's last step); so does the
# converged fnorm below NK_FLOOR.  Counts above the floor are exact, the
# history above it to 1e-8 relative.
NK_FLOOR = 1e-10
AT_LOCAL_MIN = (ConvergedReason.DIVERGED_TR_DELTA, ConvergedReason.CONVERGED_SNORM_RELATIVE)


@pytest.mark.parametrize("name", list(TR_CASES))
def test_newton_tr_matches_jax(name):
    """Newton count, reason, Krylov counts and the accepted-fnorm history
    equal to the JAX package's from each start, above NK_FLOOR: the far
    start converges by clipped steps.  At the merit's local minimum (J^T F
    = 0, F != 0) the predicted decrease of the last steps is round-off
    whose sign decides whether they are accepted, so the two packages may
    end there either way, DIVERGED_TR_DELTA (the radius shrunk away) or
    CONVERGED_SNORM_RELATIVE (a vanishing accepted step): the histories
    agree over the steps both took, every further entry equals the
    minimum's fnorm, and both stop at the same state."""
    T, J = _tr("torch", name), _tr("jax", name)
    th, jh = np.asarray(T.fnorm_history), np.asarray(J.fnorm_history)
    tk, jk = [int(k) for k in T.ksp_iters], [int(k) for k in J.ksp_iters]
    if name == "local min":
        assert T.reason in AT_LOCAL_MIN and J.reason in AT_LOCAL_MIN, (T.reason, J.reason)
        n = min(len(th), len(jh))
        _hist(th[:n], jh[:n])
        for h in (th[n:], jh[n:]):
            np.testing.assert_allclose(h, jh[-1], rtol=RTOL)
        assert tk[:min(len(tk), len(jk))] == jk[:min(len(tk), len(jk))]
        assert T.fnorm > 1.0 and T.fnorm == pytest.approx(float(J.fnorm), rel=RTOL)
    else:
        assert (T.iters, T.reason) == (J.iters, J.reason) and T.reason > 0
        assert th.shape == jh.shape
        above = jh >= NK_FLOOR
        _hist(th[above], jh[above])
        assert np.all(th[~above] < NK_FLOOR)
        assert len(tk) == len(jk)
        for k in range(len(jk)):
            if 1e-10 * jh[min(k, len(jh) - 1)] >= NK_FLOOR:
                assert tk[k] == jk[k], (k, tk[k], jk[k])
    assert _xnorm(T.x) == pytest.approx(_xnorm(J.x), rel=RTOL)


# -- the family on the 16x16 nonlinear elliptic problem --------------------------

def _elliptic(pkg, dims=(16, 16)):
    if pkg == "jax":
        m = JElliptic(JGrid(dims), gamma=1.0, exponent=2.0)
    else:
        m = EllipticModel(Grid(dims, device="cpu"), gamma=1.0, exponent=2.0)
    u, b, d = m.setup_problem(exact=0, cos_scale=1.0)
    pcs, pca = m.make_pc("fastdiag")
    return m, u, m.make_residual(b, d), pcs, pca


def _family(pkg, name):
    """Run family member ``name`` of ``pkg`` on the 16x16 problem, as
    tests/test_newton.py runs the JAX package's."""
    mod, ksp, full = PKG[pkg]
    m, u, residual, pcs, pca = _elliptic(pkg)
    x0 = full(m.grid.dims)
    if name == "qn":
        return mod.quasi_newton_solve(residual, x0, m=20, pc_setup=pcs, pc_apply=pca,
                                      config=mod.NewtonConfig(rtol=1e-9, max_it=300))
    if name == "anderson":
        return mod.anderson_solve(residual, x0, m=5, beta=0.2, pc_setup=pcs, pc_apply=pca,
                                  config=mod.NewtonConfig(rtol=1e-9, max_it=100))
    if name == "ngmres":
        return mod.ngmres_solve(residual, x0, m=5, beta=0.2, pc_setup=pcs, pc_apply=pca,
                                config=mod.NewtonConfig(rtol=1e-9, max_it=100))
    if name == "ngmres newton":
        def loose_newton_step(x):   # JFNK: the default Jacobian action
            return mod.newton_solve(residual, x, pc_setup=pcs, pc_apply=pca,
                                    ksp=ksp(type="gmres", rtol=0.3, max_it=3),
                                    config=mod.NewtonConfig(max_it=1, rtol=0.0, atol=0.0,
                                                            line_search="basic")).x

        with jax.disable_jit() if pkg == "jax" else contextlib.nullcontext():
            return mod.ngmres_solve(residual, x0, m=5, npc=loose_newton_step,
                                    config=mod.NewtonConfig(rtol=1e-9, max_it=60))
    assert name == "newton recycle"
    return mod.newton_solve(residual, x0, jacobian_action=m.jacobian_action,
                            pc_setup=pcs, pc_apply=pca,
                            ksp=ksp(type="fgmres", rtol=1e-5, max_it=200, restart=12),
                            config=mod.NewtonConfig(rtol=1e-10, max_it=20, recycle=4))


FAMILY = ("qn", "anderson", "ngmres", "newton recycle")


@pytest.mark.parametrize("name", FAMILY)
def test_family_matches_jax(name):
    """Counts, reason, fnorm history and the solution's norm equal to the
    JAX package's; the solves reach the exact solution (the JAX tests'
    error bounds); the recycled Newton's harvest is float64 of (4, n), as
    the JAX package's is of its shape."""
    T, J = _family("torch", name), _family("jax", name)
    _held(T, J)
    _, u, *_ = _elliptic("torch")
    assert T.reason > 0
    assert float(torch.max(torch.abs(T.x - u))) < (1e-5 if name == "qn" else 1e-7)
    if name == "newton recycle":
        assert T.recycle_U.dtype == torch.float64 and T.recycle_U.shape == (4, 256)
        assert tuple(J.recycle_U.shape) == (4, 256)
    else:
        assert all(k == 0 for k in T.ksp_iters)


def test_ngmres_loose_newton_matches_jax():
    """NGMRES composed with one loose JFNK Newton step an iteration (rtol
    0.3, 3 Krylov iterations): count, reason and fnorm history equal to
    the JAX package's, the solution's norm to 1e-8 relative, its error at
    the exact solution as small."""
    T, J = _family("torch", "ngmres newton"), _family("jax", "ngmres newton")
    assert (T.iters, T.reason) == (J.iters, J.reason) == (13, 2)
    _hist(T.fnorm_history, J.fnorm_history)
    assert _xnorm(T.x) == pytest.approx(_xnorm(J.x), rel=RTOL)
    _, u, *_ = _elliptic("torch")
    assert float(torch.max(torch.abs(T.x - u))) < 1e-9


def test_qn_basic_line_search_and_ngmres_needs_a_pc():
    """QN with the full step: the same counts as the JAX package's; NGMRES
    without npc= or pc_apply= raises as the JAX package does."""
    cfgs = {pkg: mod.NewtonConfig(rtol=1e-9, max_it=40, line_search="basic")
            for pkg, mod in (("jax", jnewton), ("torch", tnewton))}
    jm, _, jres, jpcs, jpca = _elliptic("jax")
    tm, _, tres, tpcs, tpca = _elliptic("torch")
    J = jnewton.quasi_newton_solve(jres, jnp.zeros(jm.grid.dims), m=5, pc_setup=jpcs,
                                   pc_apply=jpca, config=cfgs["jax"])
    T = tnewton.quasi_newton_solve(tres, torch.zeros(tm.grid.dims, dtype=torch.float64), m=5,
                                   pc_setup=tpcs, pc_apply=tpca, config=cfgs["torch"])
    _held(T, J)
    with pytest.raises(ValueError, match="npc= or pc_apply="):
        tnewton.ngmres_solve(tres, torch.zeros(tm.grid.dims, dtype=torch.float64))


# -- FAS at 25^2 (tests/test_fas.py) ------------------------------------------------

def _fas(pkg):
    """(solver, cold solve, warm solve from its answer, exact solution) of
    ``pkg``'s FASSolver at 25x25, as tests/test_fas.py runs it."""
    def factory(dims):
        if pkg == "jax":
            return JElliptic(JGrid(dims), gamma=1.0, exponent=2.0)
        return EllipticModel(Grid(dims, device="cpu"), gamma=1.0, exponent=2.0)

    u, b, d = factory((25, 25)).setup_problem(exact=0, cos_scale=1.0)
    fas = (jfas if pkg == "jax" else tfas).FASSolver(factory, (25, 25), b, d)
    cold = fas.solve(rtol=1e-9, max_cycles=30)
    return fas, cold, fas.solve(x0=cold.x, rtol=1e-9, max_cycles=30), u


def test_fas_matches_jax():
    """The hierarchy, the auto-damping omega (to 1e-8 relative), the cycle
    count and residual history, the solution's norm, and the warm start
    that stops before a cycle, against the JAX package's FASSolver on the
    same problem; the coarse Dirichlet data against the JAX package's
    restriction."""
    tf, T, Tw, u = _fas("torch")
    jf, J, Jw, _ = _fas("jax")
    assert tf.levels == jf.levels == [(25, 25), (13, 13)]
    np.testing.assert_allclose(tf.dirichlets[1].numpy(), np.asarray(jf.dirichlets[1]),
                               rtol=0, atol=1e-14)
    assert tf.omega == pytest.approx(jf.omega, rel=RTOL)
    assert (T.iters, T.reason) == (J.iters, J.reason) == (7, ConvergedReason.CONVERGED_RTOL)
    _hist(T.history, J.history)
    assert _xnorm(T.x) == pytest.approx(_xnorm(J.x), rel=RTOL)
    assert float(torch.max(torch.abs(T.x - u))) < 1e-9
    assert (Tw.iters, Tw.reason) == (Jw.iters, Jw.reason) == (0, 2)


def test_fas_level_dims_and_restriction():
    """_level_dims and the face-wise Dirichlet restriction equal to the JAX
    package's on grids of two and three axes."""
    rng = np.random.default_rng(3)
    for dims in ((33, 33), (32, 32, 32), (12, 12), (9, 20)):
        assert tfas._level_dims(dims) == jfas._level_dims(dims)
    for dims, dc in (((25, 25), (13, 13)), ((12, 10, 9), (6, 5, 5))):
        bm = JGrid(dims).boundary_mask_np
        dr = np.where(bm, rng.standard_normal(dims), 0.0)
        np.testing.assert_allclose(tfas._restrict_dirichlet(dr, dc),
                                   jfas._restrict_dirichlet(dr, dc), rtol=0, atol=1e-14)


# -- the elliptic CLI's -snes_type at 12^2 ------------------------------------------

def _run(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return rc, buf.getvalue()


SNES_CLI = {
    "newtontr": ["-snes_type", "newtontr", "-snes_tr_delta0", "0.5"],
    "qn": ["-snes_type", "qn", "-snes_qn_m", "6", "-snes_max_it", "30"],
    "anderson": ["-snes_type", "anderson", "-snes_anderson_m", "4"],
    "ngmres": ["-snes_type", "ngmres", "-snes_ngmres_beta", "0.25"],
    "ngmres npc": ["-snes_type", "ngmres", "-npc_snes_type", "newtonls", "-npc_ksp_rtol",
                   "0.2", "-npc_ksp_max_it", "4"],
    "fas": ["-snes_type", "fas"],
}


@pytest.mark.parametrize("name", list(SNES_CLI))
def test_cli_snes_type_matches_jax(name):
    """The elliptic CLI at 12x12 with each -snes_type and its knobs prints
    the JAX driver's lines (counts, reason, error to its 7 printed digits)
    and exits with its code, with no option left unused; FAS runs at
    16x16, where it has two levels."""
    dims = "16,16" if name == "fas" else "12,12"
    argv = ["-dim", dims, "-gamma", "1", "-debug", "1", *SNES_CLI[name]]
    keep = ("Number of nonlinear", "Reason", "Norm of error", "KSP iterations")
    trc, tout = _run(t_main, ["elliptic", "-device", "cpu", *argv])
    with jax.disable_jit() if name == "ngmres npc" else contextlib.nullcontext():
        jrc, jout = _run(j_elliptic_main, JOptions(argv))
    jl = [ln for ln in jout.splitlines() if ln.startswith(keep)]
    assert len(jl) == 4
    assert [ln for ln in tout.splitlines() if ln.startswith(keep)] == jl
    assert trc == jrc
    assert "WARNING" not in tout


def test_newton_recycle_dataclass_defaults():
    """NewtonConfig(recycle) and NewtonResult(recycle_U) as in the JAX
    package; recycling with a non-GMRES outer type runs without a harvest,
    as the JAX package's newton_solve skips it."""
    assert tnewton.NewtonConfig().recycle == jnewton.NewtonConfig().recycle == 0
    fields = {f.name for f in dataclasses.fields(tnewton.NewtonResult)}
    assert fields == {f.name for f in dataclasses.fields(jnewton.NewtonResult)}
    res = tnewton.newton_solve(lambda x: (x - 1.0, None), torch.zeros(3, dtype=torch.float64),
                               jacobian_action=lambda x, ls, w: w,
                               ksp=KSPConfig(type="cg", rtol=1e-10),
                               config=tnewton.NewtonConfig(recycle=2))
    assert res.reason > 0 and res.recycle_U is None
