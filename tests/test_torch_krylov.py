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
    # every KSP type of the JAX package is registered; an unknown one raises
    assert set(tkrylov._KSP_TYPES) == set(jkrylov._KSP_TYPES)
    with pytest.raises(ValueError, match="unknown KSP type"):
        tkrylov.KSPConfig(type="lsqr").solve(tm.operator, torch.from_numpy(b))


def test_max_it_reason_matches_jax():
    """A solve cut by max_it reports DIVERGED_ITS with the same count."""
    jm, jfd, tm, tfd, b = _systems((12, 12))
    kw = dict(rtol=1e-14, max_it=3, restart=30)
    jres = jax.jit(lambda bb: jkrylov.gmres(jm.operator, bb, M=jfd, **kw))(jnp.asarray(b))
    tres = tkrylov.gmres(tm.operator, torch.from_numpy(b), M=tfd, **kw)
    assert int(jres.reason) == tres.reason == ConvergedReason.DIVERGED_ITS
    assert int(jres.iters) == tres.iters == 3


# -- the short-recurrence types and recycling, against the JAX package ---------
# Each case builds its system with numpy from a seed (the JAX package's own
# test systems), runs the JAX solver under one jit with the data as
# arguments, and holds the port to it in float64: the same iteration count
# and reason, the solution to 1e-10 relative (norm-wise), the residual
# history to 1e-8 relative (norm-wise).  MINRES's history only to 1e-6:
# its three-term Lanczos recurrence loses orthogonality on the saddle
# system, so the monitored M-norm estimates of its last steps (1e-9 of the
# first) move by a tenth of themselves under round-off, while the count
# and the solution do not.


def _dense_case(name):
    rng = np.random.default_rng({"bcgs": 11, "cheb": 11, "cheb_bounds": 12, "minres": 14}[name])
    if name == "bcgs":
        n = 60
        d = np.linspace(1, 100, n)
        A = np.diag(d) + 0.5 * rng.standard_normal((n, n))
        return A, A @ rng.standard_normal(n), 1.0 / d
    if name == "cheb":
        n = 80
        A = np.diag(np.linspace(1.0, 40.0, n))
        off = rng.standard_normal((n, n)) * 0.05
        A = A + off + off.T
        return A, A @ rng.standard_normal(n), 1.0 / np.diag(A)
    if name == "cheb_bounds":
        n = 60
        Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
        A = (Q * np.linspace(1.0, 10.0, n)) @ Q.T
        return A, A @ rng.standard_normal(n), None
    nv, npp = 50, 20     # minres: the saddle family with a block-diagonal SPD PC
    Bv = rng.standard_normal((nv, nv))
    Av = Bv @ Bv.T + nv * np.eye(nv)
    Bm = rng.standard_normal((npp, nv))
    A = np.block([[Av, Bm.T], [Bm, np.zeros((npp, npp))]])
    return A, A @ rng.standard_normal(nv + npp), np.concatenate([1.0 / np.diag(Av), np.ones(npp)])


def _held(T, J, hist_rtol=1e-8):
    assert T["iters"] == J["iters"] and T["reason"] == J["reason"], (T["iters"], J["iters"])
    assert np.linalg.norm(T["x"] - J["x"]) <= 1e-10 * np.linalg.norm(J["x"])
    assert T["history"].shape == J["history"].shape
    assert np.linalg.norm(T["history"] - J["history"]) <= hist_rtol * np.linalg.norm(J["history"])


@pytest.mark.parametrize("name,ksp_type,kw", [
    ("bcgs", "bicgstab", dict(rtol=1e-10, max_it=400)),
    ("cheb", "chebyshev", dict(rtol=1e-10, max_it=2000)),                  # auto bounds
    ("cheb_bounds", "chebyshev", dict(emin=1.0, emax=10.0, rtol=1e-8, max_it=5000)),
    ("minres", "minres", dict(rtol=1e-11, max_it=800)),
])
def test_short_recurrence_matches_jax(name, ksp_type, kw):
    A, b, dinv = _dense_case(name)
    jfn, tfn = getattr(jkrylov, ksp_type), getattr(tkrylov, ksp_type)

    @jax.jit
    def jrun(A, b, dinv):
        M = None if dinv is None else (lambda r: dinv * r)
        return jfn(lambda x: A @ x, b, M=M, **kw)

    J = solve_result_to_numpy(jrun(jnp.asarray(A), jnp.asarray(b),
                                   None if dinv is None else jnp.asarray(dinv)))
    At, dt = torch.from_numpy(A), None if dinv is None else torch.from_numpy(dinv)
    T = solve_result_to_numpy(tfn(lambda x: At @ x, torch.from_numpy(b),
                                  M=None if dt is None else (lambda r: dt * r), **kw))
    assert J["reason"] > 0
    _held(T, J, 1e-6 if ksp_type == "minres" else 1e-8)
    # through KSPConfig, the same solve
    cfg = tkrylov.KSPConfig(type=ksp_type, rtol=kw["rtol"], max_it=kw["max_it"],
                            emin=kw.get("emin"), emax=kw.get("emax"))
    res = cfg.solve(lambda x: At @ x, torch.from_numpy(b),
                    M=None if dt is None else (lambda r: dt * r))
    assert res.iters == T["iters"]


def test_richardson_and_bcgs_alias_match_jax():
    """Richardson on the Jacobi-preconditioned diagonal system of the JAX
    package's test, and the ``bcgs`` name on the Poisson system with the
    fastdiag PC (the KSPConfig dispatch, as -ksp_type bcgs reaches it)."""
    d = np.linspace(1, 2, 20)
    kw = dict(rtol=1e-12, max_it=50)
    J = solve_result_to_numpy(jax.jit(lambda dd: jkrylov.richardson(
        lambda x: dd * x, jnp.ones(20), M=lambda r: r / dd, **kw))(jnp.asarray(d)))
    dt = torch.from_numpy(d)
    T = solve_result_to_numpy(tkrylov.richardson(lambda x: dt * x, torch.ones(20, dtype=torch.float64),
                                                 M=lambda r: r / dt, **kw))
    _held(T, J)
    jm, jfd, tm, tfd, b = _systems((12, 12, 12))
    J = solve_result_to_numpy(jax.jit(lambda bb: jkrylov.KSPConfig(
        type="bcgs", rtol=1e-10, max_it=100).solve(jm.operator, bb, M=jfd))(jnp.asarray(b)))
    T = solve_result_to_numpy(tkrylov.KSPConfig(type="bcgs", rtol=1e-10, max_it=100).solve(
        tm.operator, torch.from_numpy(b), M=tfd))
    _held(T, J)


def test_minres_indefinite_pc_flagged():
    """A PC with <r, Mr> < 0 ends the solve as DIVERGED_INDEFINITE_PC, as
    in the JAX package, with no NaN."""
    J = jkrylov.minres(lambda x: 2.0 * x, jnp.ones(30), M=lambda r: -r, rtol=1e-8, max_it=100)
    T = tkrylov.minres(lambda x: 2.0 * x, torch.ones(30, dtype=torch.float64), M=lambda r: -r,
                       rtol=1e-8, max_it=100)
    assert T.reason == int(J.reason) == ConvergedReason.DIVERGED_INDEFINITE_PC
    assert T.iters == int(J.iters) == 0


def _outlier_sequence():
    """tests/test_krylov.py::test_recycling_deflation_outlier_spectrum's
    systems: 6 eigenvalues at 1e-3 below a [1, 2] bulk, 4 nearby steps."""
    rng = np.random.default_rng(9)
    n = 300
    d = np.concatenate([np.full(6, 1e-3), rng.uniform(1.0, 2.0, n - 6)])
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A0 = (Q * d) @ Q.T
    dA = rng.standard_normal((n, n))
    dA = 0.5 * (dA + dA.T) * 1e-5
    return [A0 + step * dA for step in range(4)], rng.standard_normal(n)


def test_solve_recycled_matches_jax():
    """solve_recycled over the outlier sequence: each step's count and
    reason equal to the JAX package's, its solution to 1e-10 relative.
    The harvested U is held through its effect (the next solve's count),
    since singular vectors carry a sign; it stays in the solve's dtype.
    Recycling saves iterations from the second solve on, as in the JAX
    package's test."""
    As, b = _outlier_sequence()
    cfg_kw = dict(type="gmres", rtol=1e-8, max_it=1000, restart=80)
    jcfg, tcfg = jkrylov.KSPConfig(**cfg_kw), tkrylov.KSPConfig(**cfg_kw)
    jrec = jax.jit(lambda A, bb, U: jcfg.solve_recycled(lambda x: A @ x, bb, U=U, nkeep=8))
    Uj = jnp.zeros((8, b.size))
    Ut, tot_rec, tot_plain = None, 0, 0
    for A in As:
        Jres, Uj = jrec(jnp.asarray(A), jnp.asarray(b), Uj)
        At = torch.from_numpy(A)
        Tres, Ut = tcfg.solve_recycled(lambda x: At @ x, torch.from_numpy(b), U=Ut, nkeep=8)
        J, T = solve_result_to_numpy(Jres), solve_result_to_numpy(Tres)
        assert T["iters"] == J["iters"] and T["reason"] == J["reason"] == 2, (T["iters"], J["iters"])
        assert np.linalg.norm(T["x"] - J["x"]) <= 1e-10 * np.linalg.norm(J["x"])
        assert Ut.shape == (8, b.size) and Ut.dtype == torch.float64
        tot_rec += T["iters"]
        tot_plain += tcfg.solve(lambda x: At @ x, torch.from_numpy(b)).iters
    assert tot_rec < 0.75 * tot_plain, (tot_rec, tot_plain)
    # a non-GMRES type solves plainly and passes U on
    res, U2 = tkrylov.KSPConfig(type="cg", rtol=1e-8, max_it=1000).solve_recycled(
        lambda x: torch.from_numpy(As[0]) @ x, torch.from_numpy(b), U=Ut)
    assert U2 is Ut and res.reason > 0


def test_solve_recycled_dict_state_null_project_matches_jax():
    """Deflation on a dict state {"p", "v"} with a null-space projector:
    W is built with the projected operator P(A(u)), as in the JAX package.
    FGMRES with a Jacobi PC; two related solves, the second deflated by
    the first's harvest: counts equal to the JAX package's, solutions to
    1e-10 relative."""
    rng = np.random.default_rng(7)
    nv, npp = 40, 12
    Kv = np.eye(nv) * 2 + 0.1 * rng.standard_normal((nv, nv))
    Kp = np.eye(npp) * 3 + 0.1 * rng.standard_normal((npp, npp))
    Kp[:, 0] = 0.0           # a null direction on p: the projector removes p[0]
    bv, bp = rng.standard_normal(nv), rng.standard_normal(npp)
    bp[0] = 0.0
    cfg_kw = dict(type="fgmres", rtol=1e-10, max_it=200, restart=20)

    def jsys(s):
        A = lambda x: {"v": (Kv + s) @ x["v"], "p": Kp @ x["p"]}
        P = lambda x: {"v": x["v"], "p": x["p"].at[0].set(0.0)}
        M = lambda r: {"v": r["v"] / 2.0, "p": r["p"] / 3.0}
        return A, P, M

    jrec = jax.jit(lambda bb, U, s: jkrylov.KSPConfig(**cfg_kw).solve_recycled(
        jsys(s)[0], bb, M=jsys(s)[2], null_project=jsys(s)[1], U=U, nkeep=6))
    Kvt, Kpt = torch.from_numpy(Kv), torch.from_numpy(Kp)

    def tsys(s):
        A = lambda x: {"v": (Kvt + s) @ x["v"], "p": Kpt @ x["p"]}
        P = lambda x: {"v": x["v"], "p": torch.cat([torch.zeros_like(x["p"][:1]), x["p"][1:]])}
        M = lambda r: {"v": r["v"] / 2.0, "p": r["p"] / 3.0}
        return A, P, M

    Uj, Ut = jnp.zeros((6, nv + npp)), None
    for s in (0.0, 1e-3):
        Jres, Uj = jrec({"v": jnp.asarray(bv), "p": jnp.asarray(bp)}, Uj, s)
        A, P, M = tsys(s)
        Tres, Ut = tkrylov.KSPConfig(**cfg_kw).solve_recycled(
            A, {"v": torch.from_numpy(bv), "p": torch.from_numpy(bp)}, M=M, null_project=P,
            U=Ut, nkeep=6)
        J, T = solve_result_to_numpy(Jres), solve_result_to_numpy(Tres)
        assert T["iters"] == J["iters"] and T["reason"] == J["reason"] > 0
        for k in ("v", "p"):
            assert np.linalg.norm(T["x"][k] - J["x"][k]) <= 1e-10 * np.linalg.norm(J["x"][k])
        assert Ut.dtype == torch.float64 and Ut.shape == (6, nv + npp)


def test_ksp_solve_and_chebyshev_options_match_jax():
    """-ksp_type chebyshev -ksp_chebyshev_eigenvalues emin,emax reaches
    KSPConfig as in the JAX package, and ksp_solve dispatches it."""
    from spectral_tpu.utils.options import Options as JOptions
    from spectral_tpu_torch.utils.options import Options

    argv = ["-ksp_type", "chebyshev", "-ksp_chebyshev_eigenvalues", "1.0,50.0",
            "-ksp_rtol", "1e-9", "-ksp_max_it", "4000"]
    tk, jk = Options(argv).ksp_config(), JOptions(argv).ksp_config()
    assert (tk.type, tk.emin, tk.emax, tk.rtol, tk.max_it) == \
        (jk.type, jk.emin, jk.emax, jk.rtol, jk.max_it) == ("chebyshev", 1.0, 50.0, 1e-9, 4000)
    assert Options([]).ksp_config().emin is None
    rng = np.random.default_rng(5)
    Q = np.linalg.qr(rng.standard_normal((40, 40)))[0]
    A = torch.from_numpy((Q * np.linspace(1.0, 50.0, 40)) @ Q.T)
    xs = torch.from_numpy(rng.standard_normal(40))
    res = tkrylov.ksp_solve(tk, lambda x: A @ x, A @ xs)
    assert res.reason > 0
    assert float(torch.max(torch.abs(res.x - xs))) < 1e-5
