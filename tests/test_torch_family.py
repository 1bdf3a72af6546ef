"""The port's batched solves (ROADMAP item 7a) against the JAX package, float64.

The toy Newton families, ``KSPConfig.solve_batched`` and ``block_gmres``
run the JAX package live on the same seeded numpy inputs.  The Stokes
families (flat and curved) and ``family_rollout`` take too long to run
live (18.8 s, ~12 s and 14.0 s of the JAX package's own tests on this
CPU), so they are held to the numbers and solutions that ``python3
stokes_oracle.py family`` recorded (``FAMILY_JAX`` below and
``tests/data/torch_family_oracle.npz``; 46 s on the CPU), and to the
port's own sequential solves.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectral_tpu.models.rheology import PowerLawParams as JParams
from spectral_tpu.models.rheology import rheology_power as j_rheology_power
from spectral_tpu.solvers import block_gmres as j_block_gmres
from spectral_tpu.solvers.krylov import KSPConfig as JKSP
from spectral_tpu.solvers.newton import NewtonConfig as JNewton
from spectral_tpu.solvers.newton import newton_solve_family as j_family
from spectral_tpu_torch.grid import Grid
from spectral_tpu_torch.models.rheology import PowerLawParams, rheology_power
from spectral_tpu_torch.models.stokes import StokesConfig, StokesProblem
from spectral_tpu_torch.models.stokes_unsteady import UnsteadyStokes
from spectral_tpu_torch.solvers import block_gmres
from spectral_tpu_torch.solvers.batching import batch_map
from spectral_tpu_torch.solvers.krylov import KSPConfig
from spectral_tpu_torch.solvers.newton import NewtonConfig, newton_solve_family

F64 = torch.float64
ORACLE_NPZ = os.path.join(os.path.dirname(__file__), "data", "torch_family_oracle.npz")
# stokes_oracle.py family (the JAX package on the CPU, float64)
FAMILY_JAX = {"flat10": {"iters": [1, 11, 14], "reason": [2, 2, 2]},
              "curved10": {"iters": [7, 18, 10], "reason": [2, 2, 2]},
              "rollout10": [[15, 15, 15, 15]] * 3}


@pytest.fixture(scope="module")
def oracle():
    return np.load(ORACLE_NPZ)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


# -- newton_solve_family: the JAX package's toy cases --------------------------

def _toy(x, theta):
    return x * x - theta, None


def _toy_jac(x, lin, w):
    return 2.0 * x * w


@pytest.mark.parametrize("ew", [False, True])
def test_newton_family_matches_jax(ew):
    """x0 one member whose leading extent equals B (the explicit
    ``x0_batched`` flag), and Eisenstat-Walker per member with fgmres."""
    typ = "fgmres" if ew else "gmres"
    kw = dict(rtol=1e-12, max_it=40, ksp_ew=ew)
    thetas = np.array([1.0, 4.0, 9.0])
    jr = j_family(_toy, jnp.ones(3), jnp.asarray(thetas), jacobian_action=_toy_jac,
                  config=JNewton(**kw), ksp=JKSP(type=typ, rtol=1e-12, max_it=50))
    tr = newton_solve_family(_toy, torch.ones(3, dtype=F64), _t(thetas),
                             jacobian_action=_toy_jac, config=NewtonConfig(**kw),
                             ksp=KSPConfig(type=typ, rtol=1e-12, max_it=50))
    assert tr.iters.tolist() == np.asarray(jr.iters).tolist()
    assert tr.reason.tolist() == np.asarray(jr.reason).tolist()
    assert (tr.reason > 0).all()
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tr.fnorm_history, np.asarray(jr.fnorm_history),
                               rtol=0, atol=1e-12)
    # a batched x0 is taken as it is
    x0 = torch.tensor([[1.0, 2.0, 3.0]] * 3, dtype=F64)
    tb = newton_solve_family(_toy, x0, _t(thetas), jacobian_action=_toy_jac,
                             config=NewtonConfig(**kw), x0_batched=True,
                             ksp=KSPConfig(type=typ, rtol=1e-12, max_it=50))
    np.testing.assert_allclose(tb.x.numpy(), np.sqrt(thetas)[:, None] * np.ones((3, 3)),
                               rtol=1e-9)


def test_family_degenerate_exponent_isolated():
    """A degenerate exponent in a mapped family gives deta = 0, not NaN,
    as the JAX package's does under vmap."""
    th = dict(hardness=[1.0, 1.0], exponent=[1e-9, 3.0], regularization=[1e-2, 1e-2],
              gamma0=[1.0, 1.0])
    gamma = np.linspace(0.5, 2.0, 4)
    jeta, jdeta = jax.vmap(lambda t: j_rheology_power(jnp.asarray(gamma), t))(
        JParams(**{k: jnp.asarray(v) for k, v in th.items()}))
    teta, tdeta = batch_map(lambda t: rheology_power(_t(gamma), t))(
        PowerLawParams(**{k: _t(v) for k, v in th.items()}))
    assert torch.isfinite(tdeta).all() and torch.all(tdeta[0] == 0)
    np.testing.assert_allclose(tdeta.numpy(), np.asarray(jdeta), rtol=1e-14)
    np.testing.assert_allclose(teta.numpy(), np.asarray(jeta), rtol=1e-14)


# -- solve_batched and block_gmres: the JAX package's cases --------------------

def _spd(n, seed):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (Q * np.linspace(1.0, 50.0, n)) @ Q.T


@pytest.mark.parametrize("ksp_type", ["gmres", "fgmres", "cg"])
def test_solve_batched_matches_jax(ksp_type):
    """One batched solve over three right-hand sides: each member's count,
    reason and solution equal the JAX package's batched solve and the
    port's single solve."""
    A = _spd(40, 5)
    Bm = np.random.default_rng(7).standard_normal((3, 40))
    kw = dict(type=ksp_type, rtol=1e-10, max_it=300, restart=30)
    jr = JKSP(**kw).solve_batched(lambda x: jnp.asarray(A) @ x, jnp.asarray(Bm))
    At = _t(A)
    tr = KSPConfig(**kw).solve_batched(lambda x: At @ x, _t(Bm))
    assert tr.x.shape == (3, 40)
    assert tr.iters.tolist() == np.asarray(jr.iters).tolist()
    assert tr.reason.tolist() == np.asarray(jr.reason).tolist()
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=0, atol=1e-12)
    for i in range(3):
        single = KSPConfig(**kw).solve(lambda x: At @ x, _t(Bm[i]))
        assert int(tr.iters[i]) == single.iters
        np.testing.assert_allclose(tr.x[i].numpy(), single.x.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("ksp_type", ["gmres", "fgmres"])
def test_solve_batched_restart_one_freezes_members(ksp_type):
    """Restart 1 closes a cycle every step: a member that converges at a
    cycle's end is frozen there while the rest iterate, each with its
    single solve's count."""
    rng = np.random.default_rng(5)
    Q, _ = np.linalg.qr(rng.standard_normal((20, 20)))
    A = (Q * np.linspace(1.0, 5.0, 20)) @ Q.T
    Bm = np.random.default_rng(7).standard_normal((3, 20))
    Bm[0] = Q[:, 0]      # an eigenvector: one step, at its cycle's end
    At, d = _t(A), _t(np.full(20, 2.0))
    ksp = KSPConfig(type=ksp_type, rtol=1e-8, max_it=500, restart=1)
    tr = ksp.solve_batched(lambda x: At @ x, _t(Bm), M=lambda r: r / d)
    singles = [ksp.solve(lambda x: At @ x, _t(b), M=lambda r: r / d) for b in Bm]
    assert tr.iters.tolist() == [s.iters for s in singles]
    assert tr.iters[0] == 1 < min(tr.iters[1:])
    for i, s in enumerate(singles):
        np.testing.assert_allclose(tr.x[i].numpy(), s.x.numpy(), rtol=0, atol=1e-12)


def _spd_range(n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (Q * np.linspace(lo, hi, n)) @ Q.T


def test_solve_batched_unported_types_raise():
    """The four short-recurrence types that had no batched core (they
    raised before): each member's count, reason and solution equal the
    JAX package's ``solve_batched`` (its ``vmap`` of ``solve``), x to
    1e-10.  Richardson runs on a spectrum in [1, 1.9], where x += b - A x
    converges; the rest on kappa 50; one member starts half way to its
    solution."""
    A = _spd(30, 5)
    A2 = _spd_range(30, 1.0, 1.9, 6)
    Bm = np.random.default_rng(8).standard_normal((3, 30))
    x0 = np.zeros_like(Bm)
    for typ, M in (("bicgstab", A), ("richardson", A2), ("chebyshev", A), ("minres", A)):
        x0[2] = 0.5 * np.linalg.solve(M, Bm[2])
        kw = dict(type=typ, rtol=1e-10, max_it=400)
        jr = JKSP(**kw).solve_batched(lambda x: jnp.asarray(M) @ x, jnp.asarray(Bm),
                                      jnp.asarray(x0))
        Mt = _t(M)
        tr = KSPConfig(**kw).solve_batched(lambda x: Mt @ x, _t(Bm), _t(x0))
        assert tr.iters.tolist() == np.asarray(jr.iters).tolist(), typ
        assert tr.reason.tolist() == np.asarray(jr.reason).tolist(), typ
        assert (tr.reason > 0).all(), typ
        np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=0, atol=1e-10,
                                   err_msg=typ)


def test_block_gmres_shared_space_matches_jax():
    A = _spd(50, 2)
    rng = np.random.default_rng(11)
    base = rng.standard_normal(50)
    Bm = np.stack([base, base + 0.1 * rng.standard_normal(50), rng.standard_normal(50)])
    jr = j_block_gmres(lambda x: jnp.asarray(A) @ x, jnp.asarray(Bm), rtol=1e-10,
                       restart=40, max_it=200)
    At = _t(A)
    tr = block_gmres(lambda x: At @ x, _t(Bm), rtol=1e-10, restart=40, max_it=200)
    assert (tr.iters, tr.reason) == (int(jr.iters), int(jr.reason)) and tr.reason > 0
    np.testing.assert_allclose(tr.x.numpy(), np.linalg.solve(A, Bm.T).T, atol=1e-7)
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=0, atol=1e-10)
    worst = max(KSPConfig(rtol=1e-10, restart=40, max_it=200).solve(
        lambda x: At @ x, _t(b)).iters for b in Bm)
    assert tr.iters <= worst + 2


def test_block_gmres_f32_ill_conditioned_matches_jax():
    """float32, kappa ~ 1e3, unpreconditioned: the SVD least squares keeps
    the block steps at the single solves' (the JAX test's bounds), and the
    deflation threshold follows the dtype."""
    rng = np.random.default_rng(17)
    n = 120
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (Q * np.logspace(0, 3, n)) @ Q.T
    b0 = rng.standard_normal(n)
    Bm = np.stack([b0, b0 + 1e-3 * rng.standard_normal(n), rng.standard_normal(n)])
    rtol = 3e-5
    jr = j_block_gmres(lambda x: jnp.asarray(A, jnp.float32) @ x,
                       jnp.asarray(Bm, jnp.float32), rtol=rtol, restart=40, max_it=400)
    At = torch.tensor(A, dtype=torch.float32)
    tr = block_gmres(lambda x: At @ x, torch.tensor(Bm, dtype=torch.float32),
                     rtol=rtol, restart=40, max_it=400)
    assert tr.reason > 0 and tr.iters <= 100
    assert abs(tr.iters - int(jr.iters)) <= 1, (tr.iters, int(jr.iters))
    worst = 0
    for i in range(3):
        single = KSPConfig(rtol=rtol, restart=40, max_it=400).solve(
            lambda x: At @ x, torch.tensor(Bm[i], dtype=torch.float32))
        worst = max(worst, single.iters)
        r = Bm[i] - A @ tr.x[i].double().numpy()
        assert np.linalg.norm(r) <= 1.05 * rtol * np.linalg.norm(Bm[i])
    assert tr.iters <= worst


def test_block_gmres_pytree_and_pc_matches_jax():
    """A dict state, a Jacobi PC and a duplicated (rank-deficient) block."""
    rng = np.random.default_rng(4)
    n = 36
    d = np.linspace(1.0, 300.0, n)
    A = np.diag(d) + 0.05 * rng.standard_normal((n, n))
    b1 = rng.standard_normal((6, 6))
    U = np.stack([b1, b1, rng.standard_normal((6, 6))])
    jd = jnp.asarray(d).reshape(6, 6)
    jr = j_block_gmres(lambda t: {"u": (jnp.asarray(A) @ t["u"].reshape(-1)).reshape(6, 6)},
                       {"u": jnp.asarray(U)}, M=lambda t: {"u": t["u"] / jd},
                       rtol=1e-9, restart=30, max_it=200)
    At, dt = _t(A), _t(d).reshape(6, 6)
    tr = block_gmres(lambda t: {"u": (At @ t["u"].reshape(-1)).reshape(6, 6)}, {"u": _t(U)},
                     M=lambda t: {"u": t["u"] / dt}, rtol=1e-9, restart=30, max_it=200)
    assert (tr.iters, tr.reason) == (int(jr.iters), int(jr.reason)) and tr.reason > 0
    X = np.linalg.solve(A, U.reshape(3, n).T).T
    np.testing.assert_allclose(tr.x["u"].numpy().reshape(3, n), X, atol=1e-5)
    np.testing.assert_allclose(tr.x["u"].numpy(), np.asarray(jr.x["u"]), rtol=0, atol=1e-9)


# -- the Stokes families and family_rollout, against the recorded JAX runs -----

def test_stokes_solve_family_matches_jax(oracle):
    """JAX tests/test_stokes.py's family at 10^2: each member's Newton
    count and reason equal the JAX family's, its state within 1e-10 of the
    JAX family's and of the port's sequential solve (velocity 1e-12, the
    JAX test's own, which holds no pressure: the members' pressures part
    by up to 3e-11 of 0.5 where their velocities agree to 1e-15)."""
    p = StokesProblem(Grid((10, 10), device="cpu", dtype=F64),
                      StokesConfig(exact=2, rheology=1))
    fam = [PowerLawParams(1.0, e, 1e-2, 1.0) for e in (1.0, 2.0, 3.0)]
    res = p.solve_family(fam)
    assert res.iters.tolist() == FAMILY_JAX["flat10"]["iters"]
    assert res.reason.tolist() == FAMILY_JAX["flat10"]["reason"]
    np.testing.assert_allclose(res.x["v"].numpy(), oracle["flat10_v"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(res.x["p"].numpy(), oracle["flat10_p"], rtol=0, atol=1e-10)
    seq = p.solve(params=fam[2])
    assert seq.iters == res.iters[2]
    assert res.ksp_iters.shape == (14, 3) and res.ksp_iters[1:, 0].sum() == 0
    np.testing.assert_allclose(res.x["v"][2].numpy(), seq.x["v"].numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(res.x["p"][2].numpy(), seq.x["p"].numpy(), rtol=0, atol=1e-10)


def test_curved_solve_family_matches_jax(oracle):
    """JAX tests/test_curvilinear.py's family on the annulus sector at 10^2
    with the metric multigrid velocity PC (mapped member by member):
    counts equal, every member within 1e-12 of the JAX family's state."""
    from spectral_tpu_torch.ops.curvilinear import named_map

    cfg = StokesConfig(exact=0, boundary=3, rheology=1, regularization=1e-3, pcvel="mg",
                       newton=NewtonConfig(rtol=1e-8, max_it=40))
    p = StokesProblem(Grid((10, 10), device="cpu", dtype=F64), cfg,
                      phi=named_map("annulus:1:2"))
    res = p.solve_family([PowerLawParams(1.0, e, 1e-3, 1.0) for e in (1.5, 2.0, 2.5)])
    assert res.iters.tolist() == FAMILY_JAX["curved10"]["iters"]
    assert res.reason.tolist() == FAMILY_JAX["curved10"]["reason"]
    np.testing.assert_allclose(res.x["v"].numpy(), oracle["curved10_v"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(res.x["p"].numpy(), oracle["curved10_p"], rtol=0, atol=1e-10)


def test_family_rollout_matches_jax(oracle):
    """JAX tests/test_stokes_unsteady.py's family: three manufactured
    members, four CN steps at 10^2; per-step counts equal the JAX family's,
    states within 1e-11 of it (the JAX test's own tolerance); the member
    that drifts most (omega 2) against its own rollout_scan, the same."""
    cfg = StokesConfig(exact=1, boundary=0, pcvel="fastdiag",
                       outer_ksp=KSPConfig(type="fgmres", rtol=1e-10, max_it=300, restart=100))
    m = UnsteadyStokes(Grid((10, 10), device="cpu", dtype=F64), cfg, dt=0.05, theta=0.5)
    times = np.arange(0.0, 0.2 + 1e-12, 0.05)
    v0s, sss, fbs = [], [], []
    for om in (0.5, 1.0, 2.0):
        u0, s, f, _, _ = m.manufactured(omega=om)
        v0s.append(u0)
        sss.append(torch.tensor([s(t) for t in times[1:]], dtype=F64))
        fbs.append(torch.stack([m.theta * f(t1) + (1 - m.theta) * f(t0)
                                for t0, t1 in zip(times[:-1], times[1:])]))
    vs, ps, its = m.family_rollout(torch.stack(v0s), torch.stack(sss), torch.stack(fbs))
    assert its.tolist() == FAMILY_JAX["rollout10"] == oracle["rollout10_iters"].tolist()
    np.testing.assert_allclose(vs.numpy(), oracle["rollout10_v"], rtol=0, atol=1e-11)
    np.testing.assert_allclose(ps.numpy(), oracle["rollout10_p"], rtol=0, atol=1e-11)
    v, pl, it = m.rollout_scan(v0s[2], sss[2], fbs[2])
    assert its[2].tolist() == it.tolist()
    np.testing.assert_allclose(vs[2].numpy(), v.numpy(), rtol=0, atol=1e-11)
    np.testing.assert_allclose(ps[2].numpy(), pl.numpy(), rtol=0, atol=1e-11)


# -- families: a callable line search, the Q1 and probed velocity PCs ----------

def test_family_callable_line_search_member_by_member():
    """A callable line search in ``newton_solve_family``: applied member by
    member to the live members, the family takes each member's own
    ``newton_solve`` counts and solution (here a damped step, which the
    JAX package's family takes under ``vmap`` in the same way)."""
    from spectral_tpu_torch.solvers.newton import _norm, newton_solve

    def damped(residual_fn, x, dx, fnorm):
        xt = x - 0.8 * dx
        F, lin = residual_fn(xt)
        fn = float(_norm(F))
        return xt, F, lin, fn, fn < fnorm

    thetas = _t([2.0, 3.0, 5.0])
    cfg = NewtonConfig(rtol=1e-10, max_it=60, line_search=damped)
    fam = newton_solve_family(_toy, _t([1.0]), thetas, jacobian_action=_toy_jac,
                              ksp=KSPConfig(type="gmres", rtol=1e-12), config=cfg)
    for b, th in enumerate([2.0, 3.0, 5.0]):
        one = newton_solve(lambda x, th=th: _toy(x, _t(th)), _t([1.0]),
                           jacobian_action=_toy_jac, ksp=KSPConfig(type="gmres", rtol=1e-12),
                           config=cfg)
        assert (int(fam.iters[b]), int(fam.reason[b])) == (one.iters, one.reason)
        assert float(fam.x[b, 0]) == pytest.approx(float(one.x[0]), abs=1e-14)
        assert abs(float(fam.x[b, 0]) - np.sqrt(th)) < 1e-8


@pytest.mark.parametrize("case", ["q1fem", "probed", "probed1", "tbc"])
def test_family_q1_probed_and_traction_pcs(case):
    """The velocity PCs a family set up member by member (the Q1 FEM and
    probed PCs, and the mixed/Neumann line and traction-block corrections,
    whose states hold line solvers and dense factors): each member takes
    its own ``solve``'s Newton and Krylov counts and solution, at 8^2."""
    cfg = {"q1fem": StokesConfig(exact=2, pcvel="q1fem"),
           "probed": StokesConfig(exact=2, pcvel="probed"),
           "probed1": StokesConfig(exact=2, pcvel="probed1"),
           "tbc": StokesConfig(exact=1, boundary=3, tbc=1, traction_p=True)}[case]
    p = StokesProblem(Grid((8, 8), device="cpu", dtype=F64), cfg)
    params = [p.params_at(cfg.cont), PowerLawParams(1.3, cfg.exponent, cfg.regularization,
                                                    cfg.gamma0)]
    fam = p.solve_family(params)
    for b, q in enumerate(params):
        one = p.solve(params=q)
        assert int(fam.iters[b]) == one.iters
        assert fam.ksp_iters[:, b][:one.iters].tolist() == list(one.ksp_iters)
        np.testing.assert_allclose(fam.x["v"][b].numpy(), one.x["v"].numpy(), rtol=0,
                                   atol=1e-11)
