"""The port's Stokes path (spectral_tpu_torch.models.stokes and the pieces
it imports: rheology, stokes_exact, extrapolation, Grid.normal, the FD
stencils, preonly and dict states in the Krylov and Newton solvers, the
``stokes`` CLI driver) against the JAX package on the same numpy-seeded
inputs, on the CPU, in float64.

Operators agree to round-off (1e-11 relative to the largest entry, or
the bound stated).  The JAX side of a comparison is one compiled
program (op by op, its first run costs more: each operation compiles on
its own).  Float64 solves agree
in Newton count and converged reason and, step by step, in Krylov count,
except the last linear solve of a Newton solve: it starts from a residual
already 1e-7 of the first and runs to rtol 1e-10 of that, at the float64
round-off floor, where the two packages' summation orders decide the
count (the JAX package itself takes 23 jitted and 22 op by op in the
power-law continuation below); that one is held within 1.
"""

import contextlib
import io
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectral_tpu.cli.drivers import stokes_main as j_stokes_main
from spectral_tpu.grid import Grid as JGrid
from spectral_tpu.models import rheology as j_rheology
from spectral_tpu.models import stokes_exact as JSE
from spectral_tpu.models.stokes import StokesConfig as JConfig
from spectral_tpu.models.stokes import StokesProblem as JProblem
from spectral_tpu.models.stokes_pc import velocity_fd_stencil as j_velocity_fd_stencil
from spectral_tpu.ops.extrapolation import pressure_reduce_order as j_reduce
from spectral_tpu.ops.stencil import anisotropic_fd_stencil as j_aniso
from spectral_tpu.solvers import krylov as jkrylov
from spectral_tpu.utils.options import Options as JOptions
from spectral_tpu_torch.cli.main import main as t_main
from spectral_tpu_torch.grid import Grid
from spectral_tpu_torch.models import rheology as t_rheology
from spectral_tpu_torch.models import stokes_exact as TSE
from spectral_tpu_torch.models.stokes import StokesConfig, StokesProblem
from spectral_tpu_torch.models.stokes_pc import velocity_fd_stencil
from spectral_tpu_torch.ops.extrapolation import pressure_reduce_order
from spectral_tpu_torch.ops.stencil import anisotropic_fd_stencil
from spectral_tpu_torch.solvers import krylov as tkrylov
from spectral_tpu_torch.solvers.krylov import KSPConfig
from spectral_tpu_torch.solvers.newton import NewtonConfig
from spectral_tpu_torch.solvers.types import ConvergedReason
from spectral_tpu_torch.utils.interop import (solve_result_to_numpy,
                                               stokes_problem_fields_to_numpy,
                                               stokes_state_from_numpy,
                                               stokes_state_to_numpy)
from spectral_tpu_torch.utils.options import Options

# the JAX test suite's configurations (tests/test_stokes.py)
POWER_LAW = dict(exact=2, rheology=1, cont=2, regularization=1e-2, exponent=3.0)


def _close(got, ref, rtol=1e-11):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    scale = max(float(np.max(np.abs(ref))), 1e-300)
    np.testing.assert_allclose(got / scale, ref / scale, atol=rtol, rtol=0)


def _close_state(got, ref, rtol=1e-11):
    for k in ("v", "p"):
        _close(got[k], ref[k], rtol)


def _problems(dims, **cfg):
    return (JProblem(JGrid(dims), JConfig(**cfg)),
            StokesProblem(Grid(dims, device="cpu"), StokesConfig(**cfg)))


def _state(jp, seed, scale=1.0):
    """A masked state of numpy arrays (O(scale) entries)."""
    rng = np.random.default_rng(seed)
    vm, pm = np.asarray(jp.vel_mask), np.asarray(jp.p_mask)
    return {"v": np.where(vm, scale * rng.standard_normal(vm.shape), 0.0),
            "p": np.where(pm, scale * rng.standard_normal(pm.shape), 0.0)}


def _t(state):
    return stokes_state_from_numpy(state, device="cpu", dtype=torch.float64)


def _j(state):
    return {k: jnp.asarray(v) for k, v in state.items()}


# -- the pieces models/stokes.py imports --------------------------------------

@pytest.mark.parametrize("rheology", [0, 1])
def test_rheology_matches_jax(rheology):
    gamma = np.random.default_rng(3).random(64) * 3.0
    for n in (3.0, 1.0, 1e-6):   # power law, Newtonian, the degenerate guard
        params = dict(hardness=2.0, exponent=n, regularization=1e-2, gamma0=0.5)
        je, jd = j_rheology.RHEOLOGIES[rheology](jnp.asarray(gamma),
                                                  j_rheology.PowerLawParams(**params))
        te, td = t_rheology.RHEOLOGIES[rheology](torch.from_numpy(gamma),
                                                  t_rheology.PowerLawParams(**params))
        assert te.dtype == td.dtype == torch.float64
        _close(te, je, 1e-15)
        _close(td, jd, 1e-15) if np.any(np.asarray(jd)) else np.testing.assert_array_equal(td, 0)


@pytest.mark.parametrize("dims", [(8, 7), (6, 6, 6)])
def test_exact_and_boundary_funcs_match_jax(dims):
    """stokes_exact is a copy: every exact solution 0-3 and boundary function
    0-8 gives the JAX module's arrays (or raises as it does)."""
    g = JGrid(dims)
    bm = g.boundary_mask_np
    coords, normals = g.coords_np[bm], g.normal_np[bm]

    def outcome(fn):
        try:
            return fn()
        except (ValueError, IndexError) as e:
            return type(e)

    assert TSE.BdyType.MIXED == JSE.BdyType.MIXED
    for e in range(4):
        ref = outcome(lambda: JSE.EXACT_SOLUTIONS[e](g.coords_np))
        got = outcome(lambda: TSE.EXACT_SOLUTIONS[e](g.coords_np))
        if isinstance(ref, type):
            assert got is ref, (e, got)
            continue
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
        for bdy in range(9):
            for full in (False, True):
                ref = outcome(lambda: JSE.BOUNDARY_FUNCS[bdy](
                    coords, normals, JSE.EXACT_SOLUTIONS[e], full_traction=full))
                got = outcome(lambda: TSE.BOUNDARY_FUNCS[bdy](
                    coords, normals, TSE.EXACT_SOLUTIONS[e], full_traction=full))
                if isinstance(ref, type):
                    assert got is ref, (e, bdy, got)
                    continue
                assert len(got) == len(ref)
                for a, b in zip(got, ref):
                    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dims", [(10, 9), (6, 6, 6)])
def test_pressure_reduce_order_matches_jax(dims):
    p = np.random.default_rng(4).standard_normal(dims)
    g = JGrid(dims)
    _close(pressure_reduce_order(torch.from_numpy(p), g.nodes_1d),
           j_reduce(jnp.asarray(p), g.nodes_1d), 1e-13)


@pytest.mark.parametrize("dims", [(8, 7), (5, 4, 6)])
def test_grid_normal_matches_jax(dims):
    tg = Grid(dims, device="cpu")
    np.testing.assert_array_equal(tg.normal_np, JGrid(dims).normal_np)
    assert tg.normal.dtype == torch.float64
    np.testing.assert_array_equal(tg.normal.numpy(), tg.normal_np)


@pytest.mark.parametrize("dims", [(6, 5, 4)])
def test_fd_stencils_match_jax(dims):
    """anisotropic_fd_stencil (with a row scale and zero-flux folds) and
    velocity_fd_stencil as dense matrices, to 1e-13."""
    rng = np.random.default_rng(5)
    d = len(dims)
    caxes = [1.0 + rng.random(dims) for _ in range(d)]
    rs = 0.5 + rng.random(dims)
    jS, jf = jax.jit(lambda cs, rs: j_aniso(JGrid(dims), cs, row_scale=rs, neumann_axes=(0,),
                                            with_folds=True))([jnp.asarray(c) for c in caxes],
                                                              jnp.asarray(rs))
    tS, tf = anisotropic_fd_stencil(Grid(dims, device="cpu"), [torch.from_numpy(c) for c in caxes],
                                    row_scale=torch.from_numpy(rs), neumann_axes=(0,),
                                    with_folds=True)
    _close(tS.as_dense_np(), jS.as_dense_np(), 1e-13)
    assert tf[0][0] == float(jf[0][0]) and tf[0][2] == float(jf[0][2])
    _close(tf[0][1], jf[0][1], 1e-13)
    _close(tf[0][3], jf[0][3], 1e-13)

    eta = 1.0 + rng.random(dims)
    jS = jax.jit(lambda e: j_velocity_fd_stencil(JGrid(dims), e))(jnp.asarray(eta))
    _close(velocity_fd_stencil(Grid(dims, device="cpu"), torch.from_numpy(eta)).as_dense_np(),
           jS.as_dense_np(), 1e-13)


# -- set-up, residual, Jacobian -------------------------------------------------

@pytest.mark.parametrize("dims,boundary", [((8, 7), b) for b in range(9)]
                         + [((6, 6, 6), 0)])
def test_setup_matches_jax(dims, boundary):
    """Masks, boundary data, normals, exact fields, forcing, node types,
    counts and the census line, field by field (or the same refusal)."""
    for exact in (1, 2):
        try:
            jp = JProblem(JGrid(dims), JConfig(exact=exact, boundary=boundary))
        except ValueError:
            with pytest.raises(ValueError):
                StokesProblem(Grid(dims, device="cpu"), StokesConfig(exact=exact, boundary=boundary))
            continue
        tp = StokesProblem(Grid(dims, device="cpu"), StokesConfig(exact=exact, boundary=boundary))
        J, T = stokes_problem_fields_to_numpy(jp), stokes_problem_fields_to_numpy(tp)
        assert J.keys() == T.keys()
        for k in J:
            np.testing.assert_array_equal(T[k], J[k], err_msg=k)
        assert tp.census() == jp.census()


@pytest.mark.parametrize("rheology", [0, 1])
@pytest.mark.parametrize("boundary", [0, 1, 3])
def test_residual_and_jacobian_match_jax(rheology, boundary):
    """make_residual, make_residual_np, jacobian_action and the blocks the
    PC uses (vv_action, divergence, pressure_gradient) on seeded states."""
    cfg = dict(exact=2, boundary=boundary, rheology=rheology, exponent=3.0,
               regularization=1e-2)
    jp, tp = _problems((8, 7), **cfg)
    x, w = _state(jp, 6, 0.3), _state(jp, 7)

    def blocks(x, w):
        F, ls = jp.make_residual(jp.params_at(1))(x)
        return (F, ls, jp.jacobian_action(None, ls, w),
                jp.divergence(w["v"], with_dirichlet=False), jp.pressure_gradient(w["p"]))

    jF, jls, jJ, jdiv, jgp = jax.jit(blocks)(_j(x), _j(w))
    tF, tls = tp.make_residual(tp.params_at(1))(_t(x))
    _close_state(tF, jF)
    _close_state(tp.make_residual_np(tp.params_at(1))(x), jF)
    for a, b in zip(tls, jls):
        _close(a, b)
    _close_state(tp.jacobian_action(None, tls, _t(w)), jJ)
    _close(tp.divergence(_t(w)["v"], with_dirichlet=False), jdiv)
    _close(tp.pressure_gradient(_t(w)["p"]), jgp)


@pytest.mark.parametrize("boundary", [0, 3])
def test_hand_jacobian_equals_jvp(boundary):
    """On all-Dirichlet boundaries the block Jacobian is the exact jvp of the
    residual, power law included (tests/test_stokes.py:36's check, on the
    port's own residual)."""
    jp, tp = _problems((8, 7), exact=2, boundary=boundary, rheology=1, exponent=2.0,
                       regularization=0.1)
    x, w = _t(_state(jp, 8)), _t(_state(jp, 9))
    residual = tp.make_residual(tp.params_at(1))
    _, ls = residual(x)
    Jw = tp.jacobian_action(x, ls, w)
    _, jvp = torch.func.jvp(lambda z: residual(z)[0], (x,), (w,))
    for k in ("v", "p"):
        np.testing.assert_allclose(Jw[k].numpy(), jvp[k].numpy(), atol=1e-8)


def test_constant_pressure_in_null_space():
    tp = StokesProblem(Grid((16, 16), device="cpu"), StokesConfig(exact=2))
    F, ls = tp.make_residual(tp.params_at(1))(tp.exact_state())
    assert float(torch.max(torch.abs(F["v"]))) < 1e-10
    assert float(torch.max(torch.abs(F["p"]))) < 1e-12
    ns = {"v": torch.zeros_like(tp.exact_v), "p": tp.mask_p(torch.ones(16, 16, dtype=torch.float64))}
    An = tp.jacobian_action(None, ls, ns)
    assert float(torch.max(torch.abs(An["v"]))) < 1e-12
    assert float(torch.max(torch.abs(An["p"]))) == 0.0
    assert float(torch.max(torch.abs(tp.project_p(ns["p"])))) < 1e-15


# -- Krylov on dict states, preonly, the saddle-point PC ---------------------------

def _dict_system(dims=(8, 7)):
    """A coupled system on {"v": (dims..., 2), "p": dims} states, diagonally
    dominant, with a diagonal PC and the pressure-mean projection, in both
    packages: v -> a v + c p, p -> c sum(v) + e p."""
    rng = np.random.default_rng(10)
    a = 2.0 + rng.random(dims + (2,))
    c = 0.3 * rng.standard_normal(dims)
    e = 1.0 + rng.random(dims)
    b = {"v": rng.standard_normal(dims + (2,)), "p": rng.standard_normal(dims)}

    def ops(xp, to):
        A_, c_, e_ = to(a), to(c), to(e)
        A = lambda x: {"v": A_ * x["v"] + c_[..., None] * x["p"][..., None],  # noqa: E731
                       "p": c_ * x["v"].sum(-1) + e_ * x["p"]}
        M = lambda r: {"v": r["v"] / A_, "p": r["p"] / e_}  # noqa: E731
        P = lambda x: {"v": x["v"], "p": x["p"] - x["p"].mean()}  # noqa: E731
        return A, M, P

    return b, ops(jnp, jnp.asarray), ops(torch, torch.from_numpy)


def test_preonly_matches_jax():
    b, (jA, jM, jP), (tA, tM, tP) = _dict_system()
    J = solve_result_to_numpy(jkrylov.KSPConfig(type="preonly").solve(jA, _j(b), M=jM,
                                                                      null_project=jP))
    res = tkrylov.KSPConfig(type="preonly", rtol=1e-30).solve(tA, _t(b), M=tM, null_project=tP)
    T = solve_result_to_numpy(res)
    _close_state(T["x"], J["x"], 1e-15)
    assert (T["iters"], T["reason"], T["rnorm"]) == (J["iters"], J["reason"], J["rnorm"]) \
        == (1, int(ConvergedReason.CONVERGED_ITS), 0.0)
    assert T["history"].size == J["history"].size == 0
    assert res.history.dtype == torch.float64 and not np.isnan(res.rnorm)
    # README's -svel_ksp_type preonly reaches the inner solve's KSPConfig
    assert Options(["-svel_ksp_type", "preonly"]).ksp_config("svel_").type == "preonly"


@pytest.mark.parametrize("ksp_type", ["gmres", "fgmres"])
def test_dict_state_krylov_matches_jax(ksp_type):
    """gmres / fgmres on {"v", "p"} states (flattened p first, as
    ravel_pytree orders the keys): the same count, reason and history."""
    b, (jA, jM, jP), (tA, tM, tP) = _dict_system()
    cfg = dict(type=ksp_type, rtol=1e-12, max_it=60, restart=7)
    J = solve_result_to_numpy(jax.jit(lambda bb: jkrylov.KSPConfig(**cfg).solve(
        jA, bb, M=jM, null_project=jP))(_j(b)))
    T = solve_result_to_numpy(tkrylov.KSPConfig(**cfg).solve(tA, _t(b), M=tM, null_project=tP))
    assert (T["iters"], T["reason"]) == (J["iters"], J["reason"])
    assert T["reason"] == int(ConvergedReason.CONVERGED_RTOL) and T["iters"] > 7
    # the history norm-wise, as tests/test_torch_krylov.py holds it
    hdiff = np.linalg.norm(T["history"] - J["history"])
    assert hdiff <= 1e-8 * np.linalg.norm(J["history"]), hdiff
    _close_state(T["x"], J["x"], 1e-10)
    assert T["x"]["v"].shape == b["v"].shape and T["x"]["p"].shape == b["p"].shape


PC_BASE = dict(exact=2, rheology=1, exponent=3.0, regularization=1e-2)


@pytest.mark.parametrize("saddle,pcvel", [(0, "fastdiag"), (1, "fastdiag"), (2, "fastdiag"),
                                          (3, "fastdiag"), (0, "mg")])
def test_make_pc_matches_jax(saddle, pcvel):
    """One saddle-point PC apply (nested -vel_ GMRES, preonly -svel_, -schur_
    GMRES) about a power-law linearization, to 1e-10."""
    jp, tp = _problems((8, 7), saddle=saddle, pcvel=pcvel, **PC_BASE)
    x, r = _state(jp, 11, 0.3), _state(jp, 12)
    js, ja = jp.make_pc()

    def apply(x, r):
        _, ls = jp.make_residual(jp.params_at(1))(x)
        return ja(js(x, ls), r)

    jz = jax.jit(apply)(_j(x), _j(r))
    _, tls = tp.make_residual(tp.params_at(1))(_t(x))
    ts, ta = tp.make_pc()
    _close_state(ta(ts(_t(x), tls), _t(r)), jz, 1e-10)


def test_jacobi_velocity_pc():
    """pcvel jacobi: the velocity surrogate's diagonal (velocity_fd_stencil,
    held against the JAX package above), masked."""
    tp = StokesProblem(Grid((8, 7), device="cpu"), StokesConfig(pcvel="jacobi", **PC_BASE))
    x, r = _t(_state(tp, 11, 0.3)), _t(_state(tp, 12))
    _, ls = tp.make_residual(tp.params_at(1))(x)
    setup, apply = tp.make_vel_pc()
    diag = velocity_fd_stencil(tp.grid, ls[0]).diag()[..., None]
    torch.testing.assert_close(apply(setup(ls), r["v"]), tp.mask_v(r["v"] / diag), rtol=0, atol=0)
    z = tp.make_pc()[1](tp.make_pc()[0](x, ls), r)
    assert all(bool(torch.isfinite(t).all()) for t in z.values())


# -- solves ---------------------------------------------------------------------

def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _lines(out):
    """The printed lines both drivers share (no option warnings, no
    per-continuation-step counts, which only this package prints)."""
    return [ln for ln in out.splitlines()
            if not ln.startswith(("WARNING", "Continuation steps"))]


CLI_2D_ARGV = ["-exact", "2", "-cont0", "1", "-schur_ksp_max_it", "3", "-vel_ksp_max_it", "4",
               "-svel_ksp_type", "preonly", "-ksp_type", "fgmres", "-dim", "12,12",
               "-ksp_rtol", "1e-10"]


def _counts(results):
    return ([int(r.iters) for r in results],
            [[int(k) for k in r.ksp_iters] for r in results])


def _error(out):
    return float(out.split("Norm of error")[1].split("abs =")[1].split()[0])


@pytest.fixture(scope="module")
def jax_cli2d():
    """test_linear_stokes_2d's configuration (12x12, exact 2, cont0 1) as
    README:43's command line through the JAX package's stokes driver: its
    printed lines and the counts of the continuation results it solved."""
    captured = []
    orig = JProblem.solve_continuation

    def capture(self, *a, **kw):
        captured.extend(orig(self, *a, **kw))
        return captured

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JProblem, "solve_continuation", capture)
        rc, out = _run(j_stokes_main, JOptions(CLI_2D_ARGV))
    assert rc == 0
    newton, krylov = _counts(captured)
    return {"out": out, "newton": newton, "krylov": krylov, "error": _error(out)}


@pytest.fixture(scope="module")
def jax_power_law():
    """test_power_law_continuation's configuration (10x10, -cont 2, eps
    1e-2, exponent 3) through the JAX package's solve_continuation_fused:
    one compiled program where the host loop compiles a Newton step per
    continuation step, and the JAX package's own test holds the two equal
    step for step in this configuration
    (tests/test_refined_fused.py::test_fused_continuation_matches_host_loop)."""
    jp = JProblem(JGrid((10, 10)), JConfig(**POWER_LAW))
    res = jp.solve_continuation_fused()
    newton, krylov = _counts(res)
    return {"newton": newton, "krylov": krylov, "reasons": [int(r.reason) for r in res],
            "error": float(jp.error_vs_exact(res[-1].x))}


def test_linear_solve_and_cli_match_jax(jax_cli2d):
    """README:43's command line at 12x12: the JAX driver's printed lines to
    every digit, then the per-step Newton and Krylov counts of both solves."""
    rc, out = _run(t_main, ["stokes", "-device", "cpu", *CLI_2D_ARGV])
    assert rc == 0
    assert _lines(out) == _lines(jax_cli2d["out"])
    assert "Norm of error" in out and "CONVERGED_RTOL" in out
    m = re.search(r"Continuation steps: Newton (\[.*\])  Krylov (\[.*\])", out)
    assert m, out
    assert (json.loads(m.group(1)), json.loads(m.group(2))) == (jax_cli2d["newton"],
                                                                jax_cli2d["krylov"])


def test_power_law_continuation_matches_jax(jax_power_law):
    """solve_continuation in test_power_law_continuation's configuration:
    Newton counts and reasons equal, Krylov counts equal step by step (the
    last of each Newton solve within 1, see the module docstring), the
    error within 2x, eta varying."""
    ref = jax_power_law
    tp = StokesProblem(Grid((10, 10), device="cpu"), StokesConfig(**POWER_LAW))
    tres = tp.solve_continuation()
    assert [r.iters for r in tres] == ref["newton"]
    assert [r.reason for r in tres] == ref["reasons"]
    for a, kb in zip(tres, ref["krylov"]):
        ka = list(a.ksp_iters)
        assert ka[:-1] == kb[:-1], (ka, kb)
        assert abs(ka[-1] - kb[-1]) <= 1, (ka, kb)
    err = tp.error_vs_exact(tres[-1].x)
    assert ref["error"] / 2 <= err <= 2 * ref["error"], err
    eta = tres[-1].lin_state[0]
    assert float(torch.max(eta)) / float(torch.min(eta)) > 1.5


def test_fused_continuation_matches_jax(jax_power_law):
    """solve_continuation_fused in the same configuration, held to the JAX
    package's host loop by test_power_law_continuation_matches_jax's rule
    (its fused and host loops agree step for step in float64,
    tests/test_refined_fused.py:108-131); the state only on the last
    step."""
    ref = jax_power_law
    tp = StokesProblem(Grid((10, 10), device="cpu"), StokesConfig(**POWER_LAW))
    tres = tp.solve_continuation_fused()
    assert [r.iters for r in tres] == ref["newton"]
    assert [r.reason for r in tres] == ref["reasons"]
    for a, kb in zip(tres, ref["krylov"]):
        ka = list(a.ksp_iters)
        assert ka[:-1] == kb[:-1], (ka, kb)
        assert abs(ka[-1] - kb[-1]) <= 1, (ka, kb)
        assert len(a.fnorm_history) == a.iters + 1
    assert all(r.x is None for r in tres[:-1]) and tres[-1].x["v"].dtype == torch.float64
    err = tp.error_vs_exact(tres[-1].x)
    assert ref["error"] / 2 <= err <= 2 * ref["error"], err


def test_secant_predictor_reaches_the_same_solution():
    tp = StokesProblem(Grid((6, 6), device="cpu"), StokesConfig(**POWER_LAW))
    ts = StokesProblem(Grid((6, 6), device="cpu"),
                       StokesConfig(cont_predictor="secant", **POWER_LAW))
    a, b = tp.solve_continuation(), ts.solve_continuation()
    assert all(r.reason > 0 for r in a + b)
    assert abs(tp.error_vs_exact(a[-1].x) - ts.error_vs_exact(b[-1].x)) <= 1e-8


@pytest.mark.parametrize("dims,cfg,oracle", [
    # test_linear_stokes_2d's configuration: the JAX float64 CLI's error
    # comes from its rtol 1e-10 solve, refinement goes lower
    ((12, 12), dict(exact=2, cont0=1), "jax_cli2d"),
    # bench_stokes20_powerlaw's solver settings (bench.py) at -cont 2: the float64
    # solution's distance from the Newtonian manufactured one, the JAX solve's
    ((10, 10), dict(POWER_LAW, outer_ksp=KSPConfig(type="fgmres", rtol=1e-5, max_it=120,
                                                   restart=60),
                    newton=NewtonConfig(rtol=2e-4, max_it=30, ksp_ew=True)), "jax_power_law")])
def test_solve_refined_2d(dims, cfg, oracle, request):
    """Mixed precision: float32 continuation and Newton, float64 host
    residuals, float32 inner solves; rel residual <= 1e-10 and the float64
    solve's error."""
    ref = request.getfixturevalue(oracle)["error"]
    tp = StokesProblem(Grid(dims, device="cpu"), StokesConfig(**cfg))
    x, info = tp.solve_refined(rtol=1e-10)
    assert info["rel_residual"] <= 1e-10, info
    assert all(r.x["v"].dtype == torch.float32 for r in info["continuation"])
    assert x["v"].dtype == np.float64
    err = tp.error_vs_exact(x)
    if oracle == "jax_power_law":
        assert abs(err - ref) <= 1e-8 * ref, err
    else:
        assert err <= ref, err


@pytest.mark.parametrize("dims,cfg,oracle", [
    ((12, 12), dict(exact=2, cont0=1), "jax_cli2d"),
    ((10, 10), dict(POWER_LAW, outer_ksp=KSPConfig(type="fgmres", rtol=1e-5, max_it=120,
                                                   restart=60),
                    newton=NewtonConfig(rtol=2e-4, max_it=30, ksp_ew=True)), "jax_power_law")])
def test_solve_refined_fused_2d(dims, cfg, oracle, request):
    """solve_refined_fused (the power law with the fused continuation) in
    test_solve_refined_2d's configurations, held to the same JAX oracles
    by the same rules."""
    ref = request.getfixturevalue(oracle)["error"]
    tp = StokesProblem(Grid(dims, device="cpu"), StokesConfig(**cfg))
    x, info = tp.solve_refined_fused(rtol=1e-10, fused_continuation=True)
    assert info["rel_residual"] <= 1e-10, info
    assert x["v"].dtype == np.float64
    err = tp.error_vs_exact(x)
    if oracle == "jax_power_law":
        assert info["continuation"][-1].x["v"].dtype == torch.float32
        assert abs(err - ref) <= 1e-8 * ref, err
    else:
        assert info["continuation"] == [] and err <= ref, err


def test_dtype_ksp_clamps_to_the_state_dtype():
    """The outer rtol floor is 50 eps of the state's dtype, whatever the
    grid's dtype or a global default."""
    tp = StokesProblem(Grid((6, 6), device="cpu"), StokesConfig())
    ksp = tp.config.outer_ksp
    assert tp._dtype_ksp(ksp, torch.float32).rtol == 50 * float(np.finfo(np.float32).eps)
    assert tp._dtype_ksp(ksp, torch.float64) is ksp


def test_state_interop_round_trip():
    jp, tp = _problems((6, 5), exact=2)
    s = _state(jp, 13)
    t = stokes_state_from_numpy(_j(s), device="cpu", dtype=torch.float32)
    assert t["v"].dtype == torch.float32
    back = stokes_state_to_numpy(stokes_state_from_numpy(s, device="cpu", dtype=torch.float64))
    for k in s:
        np.testing.assert_array_equal(back[k], s[k])


# -- what waits ----------------------------------------------------------------

def test_unported_options_raise():
    g = Grid((8, 8), device="cpu")
    # item 4 runs: a mass-shifted problem builds, and its steady solve is
    # refused as the JAX package refuses it
    with pytest.raises(ValueError, match="UNSTEADY step operator"):
        StokesProblem(g, StokesConfig(mass_shift=1.0)).solve()
    # item 7c runs the sharded Newton solve, on mapped grids too
    # (tests/test_torch_parallel.py); the Q1 and probed velocity PCs and
    # the dense tier on a mesh wait for item 7d
    from spectral_tpu_torch.parallel import make_mesh

    mesh1 = make_mesh({"x": 1})
    assert StokesProblem(g, StokesConfig(exact=2), mesh=mesh1).solve().reason > 0
    from spectral_tpu_torch.ops.mapping import AxisMap

    pm = StokesProblem(Grid((8, 8), maps=(AxisMap.affine(0.0, 1.0, 8),) * 2, device="cpu"),
                       mesh=mesh1)
    for fn in (lambda: StokesProblem(g, StokesConfig(pcvel="q1fem"), mesh=mesh1).make_pc()[0](
                   None, pm.make_residual(pm.params_at(1))(pm.zero_state())[1]),
               lambda: pm.make_dense_pc()):
        with pytest.raises(NotImplementedError, match="item 7d"):
            fn()
    with pytest.raises(ValueError, match="unmapped Grid"):   # curved domains run
        StokesProblem(Grid((8, 8), intervals=((0.0, 1.0),) * 2, device="cpu"),
                      phi=lambda x: x)
    # items 7a and 7c run families with every velocity PC
    # (tests/test_torch_family.py); checkpoints run in one process
    # (tests/test_torch_utils.py), on a mesh they wait for item 7d
    for fn, name in ((lambda: StokesProblem(g, StokesConfig(exact=2), mesh=mesh1)
                      .solve_continuation(checkpoint_dir="x"), "item 7d"),):
        with pytest.raises(NotImplementedError, match=name):
            fn()
    # recycling runs in the host loop only, as in the JAX package
    pr = StokesProblem(g, StokesConfig(exact=2, newton=NewtonConfig(recycle=4)))
    with pytest.raises(ValueError, match="host-loop-only"):
        pr.solve(fused=True)
    # items 3c and 3d run: every pcvel, the mixed PC with tbc, the fused paths
    for cfg in (dict(pcvel="nodal"), dict(boundary=2), dict(boundary=1, pcvel="mg"),
                dict(boundary=2, tbc=1, pcvel="jacobi"), dict(pcvel="q1fem"),
                dict(pcvel="q1sep"), dict(pcvel="probed"), dict(pcvel="probed1"),
                dict(boundary=2, pcvel="probed"), dict(boundary=2, tbc=1, pcvel="q1fem")):
        StokesProblem(g, StokesConfig(exact=2, **cfg)).make_pc()
