"""The port's unsteady Stokes model (spectral_tpu_torch.models.stokes_unsteady)
and the ``ustokes`` CLI against the JAX package on the same inputs, on the
CPU, in float64, at 8x8.

The step data (the manufactured start, boundary modulation and forcing)
come from the port's model as numpy arrays (its ``manufactured`` is held
to the JAX CLI's errors by the CLI test).  Each JAX step is one compiled
program.  The test configuration tightens the outer rtol to 1e-12, so the
two packages' steps agree to 1e-9 of their largest entry whatever their
summation orders, and replaces the nested velocity and Schur GMRES of the
saddle preconditioner by one application of their preconditioners
(``preonly``; test_torch_stokes.py holds the nested tree to the JAX
package): each JAX step then compiles in a third of the time.
"""

import contextlib
import dataclasses
import io
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectral_tpu.grid import Grid as JGrid
from spectral_tpu.models.stokes import StokesConfig as JConfig
from spectral_tpu.models.stokes_unsteady import UnsteadyStokes as JUnsteady
from spectral_tpu.solvers.krylov import KSPConfig as JKSP
from spectral_tpu_torch.cli.main import main as t_main
from spectral_tpu_torch.grid import Grid
from spectral_tpu_torch.models.stokes import StokesConfig
from spectral_tpu_torch.models.stokes_unsteady import UnsteadyStokes
from spectral_tpu_torch.solvers.krylov import KSPConfig
from spectral_tpu_torch.utils.interop import linearization_from_numpy

DIMS = (8, 8)
DT = 0.05
OUTER = dict(type="fgmres", rtol=1e-12, max_it=400, restart=100)
LINEAR = dict(exact=1)
POWER_LAW = dict(exact=1, rheology=1, exponent=3.0)


def _rel(got, ref) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.max(np.abs(got - np.asarray(ref))) / np.max(np.abs(ref)))


def _models(scheme="theta", **cfg):
    jm = JUnsteady(JGrid(DIMS), JConfig(outer_ksp=JKSP(**OUTER), vel_ksp=JKSP(type="preonly"),
                                        schur_ksp=JKSP(type="preonly"), **cfg),
                   dt=DT, scheme=scheme)
    tm = UnsteadyStokes(Grid(DIMS, device="cpu"),
                        StokesConfig(outer_ksp=KSPConfig(**OUTER),
                                     vel_ksp=KSPConfig(type="preonly"),
                                     schur_ksp=KSPConfig(type="preonly"), **cfg),
                        dt=DT, scheme=scheme)
    return jm, tm


def _data(tm):
    """(v0, vm1, s1, fbar, f1) as numpy: the manufactured field at t = dt
    and at 0, the modulation at 2 dt, the CN-weighted forcing of the
    interval (dt, 2 dt) and the forcing at 2 dt."""
    u0, s_of_t, f_of_t, u_of_t, _ = tm.manufactured()
    v0, vm1 = np.asarray(u_of_t(DT)), np.asarray(u_of_t(0.0))
    f1 = np.asarray(f_of_t(2 * DT))
    fbar = 0.5 * f1 + 0.5 * np.asarray(f_of_t(DT))
    return v0, vm1, s_of_t(2 * DT), fbar, f1


def _T(a):
    return torch.from_numpy(np.array(a))


def _assert_step(got, want, iters_slack=1):
    v, p, its, _ = got
    jv, jp, jits, _ = want
    assert _rel(v, jv) <= 1e-9 and _rel(p, jp) <= 1e-9
    assert abs(int(its) - int(jits)) <= iters_slack, (int(its), int(jits))


@pytest.fixture(scope="module")
def linear():
    jm, tm = _models(**LINEAR)
    return jm, tm, _data(tm)


def test_linear_theta_step_matches_jax(linear):
    jm, tm, (v0, _, s1, fbar, _) = linear
    assert tm.sigma == jm.sigma == 1.0 / (0.5 * DT)
    want = jm.step(jnp.asarray(v0), s1, jnp.asarray(fbar))
    _assert_step(tm.step(_T(v0), s1, _T(fbar)), want)


def test_linear_bdf2_step_matches_jax(linear):
    # the manufactured data do not depend on the scheme's shift
    v0, vm1, s1, _, f1 = linear[2]
    jm, tm = _models(scheme="bdf2", **LINEAR)
    assert tm.sigma == jm.sigma == 1.5 / DT
    want = jm.step_bdf2(jnp.asarray(v0), jnp.asarray(vm1), s1, jnp.asarray(f1))
    _assert_step(tm.step_bdf2(_T(v0), _T(vm1), s1, _T(f1)), want)


def test_dense_step_matches_jax(linear):
    """saddle_pc="dense": the host-factored exact inverse of the fixed
    step operator, one outer iteration."""
    v0, _, s1, fbar, _ = linear[2]
    jm, tm = _models(saddle_pc="dense", **LINEAR)
    want = jm.step(jnp.asarray(v0), s1, jnp.asarray(fbar))
    got = tm.step(_T(v0), s1, _T(fbar))
    _assert_step(got, want, iters_slack=0)
    assert int(got[2]) <= 2


@pytest.fixture(scope="module")
def power_law():
    jm, tm = _models(**POWER_LAW)
    return jm, tm, _data(tm)


def test_step_residual_and_shifted_jacobian_match_jax(power_law):
    """The theta step residual and the mass-shifted Jacobian at a seeded
    power-law state, one compiled JAX program."""
    jm, tm, (v0, _, s1, fbar, _) = power_law
    rng = np.random.default_rng(4)
    vm, pm = tm.problem.vel_mask_np, tm.problem.p_mask_np
    x = {"v": np.where(vm, v0 + 0.1 * rng.standard_normal(vm.shape), 0.0),
         "p": np.where(pm, rng.standard_normal(pm.shape), 0.0)}
    w = {"v": np.where(vm, rng.standard_normal(vm.shape), 0.0),
         "p": np.where(pm, rng.standard_normal(pm.shape), 0.0)}
    jp = jm.problem

    def run(x, v0, fbar, w):
        F, lin = jm._step_residual(x, v0, jp.params_at(jp.config.cont), s1, fbar)
        return F, lin, jp.jacobian_action(None, lin, w)

    jF, jlin, jJw = jax.jit(run)(*(jax.tree_util.tree_map(jnp.asarray, a)
                                   for a in (x, v0, fbar, w)))
    tp = tm.problem
    tF, tlin = tm._step_residual({k: _T(a) for k, a in x.items()}, _T(v0),
                                 tp.params_at(tp.config.cont), s1, _T(fbar))
    for k in ("v", "p"):
        assert _rel(tF[k], jF[k]) <= 1e-12, k
    for a, b in zip(tlin, jlin):
        assert _rel(a, b) <= 1e-12
    # the Jacobian at JAX's linearization, so only the action is compared
    lin = linearization_from_numpy(jlin, device="cpu", dtype=torch.float64)
    tJw = tp.jacobian_action(None, lin, {k: _T(a) for k, a in w.items()})
    for k in ("v", "p"):
        assert _rel(tJw[k], jJw[k]) <= 1e-12, k


def test_power_law_step_matches_jax(power_law):
    """One Newton-on-step: the Newton loop's outer Krylov total within
    max(2, 10%) of the JAX package's, the step to the Newton tolerance."""
    jm, tm, (v0, _, s1, fbar, _) = power_law
    jv, jpres, jits, jfn = jm.step(jnp.asarray(v0), s1, jnp.asarray(fbar))
    tv, tpres, tits, tfn = tm.step(_T(v0), s1, _T(fbar))
    assert jits > 5
    assert abs(tits - jits) <= max(2, 0.1 * jits), (tits, jits)
    assert _rel(tv, jv) <= 1e-7 and _rel(tpres, jpres) <= 1e-7
    assert tfn <= 1e-8 * 1e3 and np.isfinite(tfn)


def test_rollout_scan_is_rollout():
    """rollout_scan and rollout_scan_bdf2 (the JAX package's lax.scan
    paths) are host loops over the same cached step: the same counts and
    fields as rollout."""
    for scheme in ("theta", "bdf2"):
        tm = UnsteadyStokes(Grid(DIMS, device="cpu"), StokesConfig(**LINEAR), dt=DT,
                            scheme=scheme)
        u0, s_of_t, f_of_t, _, _ = tm.manufactured()
        times = np.arange(3) * DT
        traj, pres, its = tm.rollout(u0, times, s_of_t, f_of_t, keep_trajectory=True)
        v = traj[-1]
        assert len(traj) == 3 and torch.equal(traj[0], u0)
        ss = [s_of_t(t) for t in times[1:]]
        if scheme == "theta":
            fbars = torch.stack([0.5 * f_of_t(t1) + 0.5 * f_of_t(t0)
                                 for t0, t1 in zip(times[:-1], times[1:])])
            sv, sp, sits = tm.rollout_scan(u0, ss, fbars)
        else:
            f1s = torch.stack([f_of_t(t) for t in times[2:]])
            sv, sp, sits = tm.rollout_scan_bdf2(u0, ss, f1s,
                                                0.5 * f_of_t(times[1]) + 0.5 * f_of_t(times[0]))
        assert sits.dtype == torch.int32 and sits.tolist() == its
        assert torch.equal(sv, v) and torch.equal(sp, pres)


def test_dense_adjoint_pc_is_the_transpose():
    """_saddle_pc(adjoint=True) on the dense tier applies Ainv^T: <M r, s>
    equals <r, M^T s> to 1e-12 for seeded states; on the power law it is
    the nested tree transposed (make_pc(adjoint=True))."""
    tm = UnsteadyStokes(Grid(DIMS, device="cpu"),
                        StokesConfig(saddle_pc="dense", outer_ksp=KSPConfig(**OUTER), **LINEAR),
                        dt=DT)
    (_, fwd), (_, adj) = tm._saddle_pc(), tm._saddle_pc(adjoint=True)
    rng = np.random.default_rng(9)
    p = tm.problem
    r, s = ({"v": p.mask_v(_T(rng.standard_normal(DIMS + (2,)))),
             "p": p.mask_p(_T(rng.standard_normal(DIMS)))} for _ in range(2))

    def dot(a, b):
        return float(sum(torch.sum(a[k] * b[k]) for k in ("v", "p")))

    lhs, rhs = dot(fwd(None, r), s), dot(r, adj(None, s))
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0)
    pl = UnsteadyStokes(Grid(DIMS, device="cpu"), StokesConfig(**POWER_LAW), dt=DT)
    setup, _ = pl._saddle_pc(adjoint=True)
    lin = pl._frozen_lin()
    assert len(setup(None, lin)[2]) == 3   # (VV^T, PV^T, VP^T)


def test_unsteady_raises():
    g = Grid(DIMS, device="cpu")
    m = UnsteadyStokes(g, StokesConfig(**LINEAR), dt=DT)
    # family_rollout runs (tests/test_torch_family.py); the power law is
    # refused, as the JAX package refuses it
    pl = UnsteadyStokes(g, StokesConfig(**POWER_LAW), dt=DT)
    with pytest.raises(ValueError, match="linear fast path"):
        pl.family_rollout(None, None, None)
    # a curved domain runs (tests/test_torch_curvilinear.py): phi reaches
    # the problem
    assert UnsteadyStokes(g, StokesConfig(**LINEAR), dt=DT,
                          phi=lambda x: x).problem.cmap is not None
    with pytest.raises(ValueError, match="Dirichlet"):
        UnsteadyStokes(g, StokesConfig(exact=2, boundary=2), dt=DT)
    with pytest.raises(ValueError, match="scheme"):
        UnsteadyStokes(g, StokesConfig(**LINEAR), dt=DT, scheme="rk4")
    with pytest.raises(ValueError, match="bdf2"):
        m.step_bdf2(None, None, 1.0, None)
    pl = UnsteadyStokes(g, StokesConfig(**POWER_LAW), dt=DT)
    with pytest.raises(ValueError, match="linear"):
        pl.rollout_scan(None, [], [])
    assert dataclasses.replace(m.config, mass_shift=m.sigma) == m.problem.config


def test_ustokes_cli_matches_oracle():
    """The JAX ustokes CLI's default run (stokes_oracle.py unsteady,
    "ustokes 12^2": outer 15 a step, error 1.412196e-06), printed to the
    same digits."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = t_main(["ustokes", "-device", "cpu"])
    out = buf.getvalue()
    assert rc == 0, out
    assert ("Unsteady Stokes  dim = [12,12]  dt = 0.05  scheme = theta  theta = 0.5"
            "  omega = 1.0  steps = 10") in out
    assert "Outer iterations per step: min 15  max 15" in out
    assert "Norm of error            : abs = 1.412196e-06 (time-integration)" in out


def test_curved_cn_step_matches_jax():
    """Crank-Nicolson steps on bump:0.05 at 8^2 (the Piola divergence of
    the full field, the shifted metric-multigrid velocity PC) in the
    ustokes CLI's configuration: the continuity rows against the JAX
    package's live, and three steps against the JAX CLI's run
    (stokes_oracle.py curvedcpu, "ustokes bump 8^2": 11 outer iterations a
    step, end-time error 7.999803e-03)."""
    from spectral_tpu.models.stokes import StokesProblem as JStokes
    from spectral_tpu.ops.curvilinear import named_map as j_named_map
    from spectral_tpu_torch.ops.curvilinear import named_map

    cfg = dict(exact=1, pcvel="mg")
    outer = dict(type="fgmres", rtol=1e-9, max_it=400, restart=100)
    tm = UnsteadyStokes(Grid(DIMS, device="cpu"), StokesConfig(outer_ksp=KSPConfig(**outer), **cfg),
                        dt=DT, phi=named_map("bump:0.05"))
    # the JAX model's continuity rows on its problem alone (building the JAX
    # integrator would set up its step's preconditioner)
    jp = JStokes(JGrid(DIMS), JConfig(mass_shift=tm.sigma, **cfg), phi=j_named_map("bump:0.05"))
    u0, s_of_t, f_of_t, u_of_t, _ = tm.manufactured()
    v = np.random.default_rng(10).standard_normal(DIMS + (2,))
    ref = JUnsteady._div_full(types.SimpleNamespace(problem=jp), jnp.asarray(v))
    assert _rel(tm._div_full(_T(v)), ref) <= 1e-12
    times = np.arange(4) * DT
    vT, _, its = tm.rollout(u0, times, s_of_t, f_of_t)
    assert [int(i) for i in its] == [11, 11, 11]
    assert abs(float(torch.max(torch.abs(vT - u_of_t(times[-1])))) - 7.999803e-03) <= 5e-10

