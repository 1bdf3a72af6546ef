"""The port's nonlinear elliptic path (spectral_tpu_torch.models.elliptic,
solvers.newton, the ``elliptic`` CLI driver) against the JAX package on
the same numpy-seeded inputs, on the CPU.

Operators agree to round-off (float64, 1e-12 relative to the largest
entry); float64 Newton solves agree in Newton count, converged reason and
per-step Krylov counts; the mixed-precision solves are held to the JAX
oracle run in float32 (``jax.enable_x64(False)``, as the JAX package's
bench runs on the TPU) within the bands stated where they are checked."""

import contextlib
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectral_tpu.cli.drivers import elliptic_main as j_elliptic_main
from spectral_tpu.grid import Grid as JGrid
from spectral_tpu.models.elliptic import EllipticModel as JElliptic
from spectral_tpu.solvers.newton import NewtonConfig as JNewtonConfig
from spectral_tpu.utils.options import Options as JOptions
from spectral_tpu_torch.cli.main import main as t_main
from spectral_tpu_torch.grid import Grid
from spectral_tpu_torch.models.elliptic import EllipticModel
from spectral_tpu_torch.solvers import newton
from spectral_tpu_torch.solvers.krylov import KSPConfig
from spectral_tpu_torch.solvers.newton import NewtonConfig
from spectral_tpu_torch.solvers.types import ConvergedReason
from spectral_tpu_torch.utils.interop import newton_result_to_numpy

# the bench_elliptic32 Newton settings (bench.py)
EW = dict(rtol=3e-5, max_it=30, ksp_ew=True, ew_etamax=0.5, pc_lag=2)


def _close(got, ref, rtol=1e-12):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    scale = max(float(np.max(np.abs(ref))), 1e-300)
    np.testing.assert_allclose(got / scale, ref / scale, atol=rtol, rtol=0)


def _inputs(dims, seed):
    """A state u (O(1), zero boundary), b, dirichlet data and a direction w."""
    rng = np.random.default_rng(seed)
    bm = JGrid(dims).boundary_mask_np
    u = np.where(bm, 0.0, 0.5 * rng.standard_normal(dims))
    b = np.where(bm, 0.0, rng.standard_normal(dims))
    d = np.where(bm, rng.standard_normal(dims), 0.0)
    w = rng.standard_normal(dims)
    return u, b, d, w


@pytest.mark.parametrize("dims,exponent", [((10, 9), 2.0), ((10, 9), 3.0),
                                           ((6, 6, 6, 6), 2.0)])
def test_residual_and_jacobian_match_jax(dims, exponent):
    u, b, d, w = _inputs(dims, 1)
    jm = JElliptic(JGrid(dims), gamma=1.0, exponent=exponent)
    tm = EllipticModel(Grid(dims, device="cpu"), gamma=1.0, exponent=exponent)

    def j_both(u, b, d, w):
        F, ls = jm.make_residual(b, d)(u)
        return F, jm.jacobian_action(u, ls, w)

    jF, jJ = jax.jit(j_both)(*map(jnp.asarray, (u, b, d, w)))
    tu, tb, td, tw = map(torch.from_numpy, (u, b, d, w))
    tF, ls = tm.make_residual(tb, td)(tu)
    _close(tF, jF)
    _close(tm.jacobian_action(tu, ls, tw), jJ)
    # the host float64 residual (numpy transforms) is the same function
    _close(tm.make_residual_np(b, d)(u), jF)


@pytest.mark.parametrize("dims", [(10, 9), (6, 5, 4)])
def test_hand_jacobian_equals_jvp(dims):
    """MatMult_Elliptic is the exact derivative of the residual: the hand
    Jacobian equals torch.func.jvp of the port's residual to round-off."""
    u, b, d, w = map(torch.from_numpy, _inputs(dims, 2))
    tm = EllipticModel(Grid(dims, device="cpu"), gamma=1.0)
    residual = tm.make_residual(b, d)
    _, ls = residual(u)
    ad = torch.func.jvp(lambda z: residual(z)[0], (u,), (w,))[1]
    _close(tm.jacobian_action(u, ls, w), ad)


@pytest.mark.parametrize("pc", ["fastdiag", "lu", "jacobi", "mg"])
def test_solve_matches_jax(pc):
    """16^2, gamma 1, float64, the model's default FGMRES and Newton
    settings: Newton count, reason and per-step Krylov counts are equal.
    The function norms agree to 1e-6 at the first steps and drift to 3e-3
    (jacobi) at the last, where each norm is the residual an rtol 1e-5
    Krylov solve left: a Krylov residual that differs in round-off shows
    there in full; 1e-2 bounds it."""
    jm = JElliptic(JGrid((16, 16)), gamma=1.0)
    tm = EllipticModel(Grid((16, 16), device="cpu"), gamma=1.0)
    _, jb, jd = jm.setup_problem(exact=0)
    _, tb, td = tm.setup_problem(exact=0)
    ref = newton_result_to_numpy(jm.solve(jb, jd, pc_type=pc))
    got = newton_result_to_numpy(tm.solve(tb, td, pc_type=pc))
    assert got["iters"] == ref["iters"] == 5
    assert got["reason"] == ref["reason"] == ConvergedReason.CONVERGED_RTOL
    assert got["ksp_iters"] == ref["ksp_iters"]
    np.testing.assert_allclose(got["fnorm_history"], ref["fnorm_history"], rtol=1e-2)
    np.testing.assert_allclose(got["fnorm_history"][:3], ref["fnorm_history"][:3],
                               rtol=1e-6)


@pytest.fixture(scope="module")
def refined12():
    """The elliptic32 configuration at 12^3: the JAX oracle in float32
    (x64 off) and both port paths."""
    jm = JElliptic(JGrid((12, 12, 12)), gamma=1.0)
    u, b, d = jm.setup_problem_np(exact=0)
    with jax.enable_x64(False):
        jx, jinfo = jm.solve_refined(b, d, rtol=1e-10, pc_type="mg3",
                                     newton=JNewtonConfig(**EW))
    tm = EllipticModel(Grid((12, 12, 12), device="cpu"), gamma=1.0)
    out = {name: getattr(tm, name)(b, d, rtol=1e-10, pc_type="mg3",
                                   newton=NewtonConfig(**EW))
           for name in ("solve_refined", "solve_refined_fused")}
    return u, b, (jx, jinfo), out


@pytest.mark.parametrize("name", ["solve_refined", "solve_refined_fused"])
def test_refined_matches_jax_oracle(refined12, name):
    """Both reach rel residual 1e-10; the solutions agree to 1e-9 (each
    solves the same system to rel residual 1e-10) and so do their errors,
    7.68e-7 at 12^3, the grid's discretisation error.  Float32 Newton at
    rtol 3e-5 runs at the float32 floor, where iterates that differ in
    round-off take later steps that differ by more (here the JAX package
    takes 5 steps and the port 6), so the Newton count is held within 1
    and the total Krylov count within a factor 2."""
    u, b, (jx, jinfo), out = refined12
    x, info = out[name]
    assert x.dtype == np.float64
    assert info["newton32"].x.dtype == torch.float32
    assert info["rel_residual"] <= 1e-10 and jinfo["rel_residual"] <= 1e-10
    np.testing.assert_allclose(x, jx, atol=1e-9, rtol=0)
    jerr, err = np.max(np.abs(jx - u)), np.max(np.abs(x - u))
    assert abs(err - jerr) <= 1e-9, (err, jerr)
    jn, tn = jinfo["newton32"], info["newton32"]
    assert abs(tn.iters - jn.iters) <= 1, (tn.iters, jn.iters)
    assert tn.reason > 0 and jn.reason > 0
    jtot = sum(jn.ksp_iters) + jinfo["refine_inner_iters"]
    tot = sum(tn.ksp_iters) + info["refine_inner_iters"]
    assert jtot / 2 <= tot <= 2 * jtot, (tot, jtot)
    assert info["refine_history"][-1] == pytest.approx(info["rel_residual"]
                                                       * np.linalg.norm(b))


def test_fused_refiner_takes_each_calls_data():
    """Two solve_refined_fused calls on one model with different b and
    boundary data give two right answers: each matches the host-loop
    refinement of its own problem."""
    tm = EllipticModel(Grid((8, 8, 8), device="cpu"), gamma=1.0)
    sols = []
    for exact in (0, 1):
        _, b, d = tm.setup_problem_np(exact=exact)
        x, info = tm.solve_refined_fused(b, d, rtol=1e-10)
        xh, _ = tm.solve_refined(b, d, rtol=1e-10)
        assert info["rel_residual"] <= 1e-10
        np.testing.assert_allclose(x, xh, atol=1e-9, rtol=0)
        sols.append(x)
    assert np.max(np.abs(sols[0] - sols[1])) > 1e-2


def _run(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return rc, buf.getvalue()


def test_cli_matches_jax():
    argv = ["-dim", "16,16", "-exact", "0", "-gamma", "1", "-snes_rtol", "1e-10",
            "-debug", "1"]
    jrc, jout = _run(j_elliptic_main, JOptions(argv))
    trc, tout = _run(t_main, ["elliptic", "-device", "cpu", *argv])
    assert trc == jrc == 0

    def field(out, key):
        return next(ln for ln in out.splitlines() if ln.startswith(key))

    for key in ("Elliptic problem", "DOF distribution", "Number of nonlinear iterations",
                "Reason for solver termination", "KSP iterations per Newton step"):
        assert field(tout, key) == field(jout, key)

    def err(out):
        return float(re.search(r"abs = (\S+)", field(out, "Norm of error")).group(1))

    assert err(tout) <= 2 * err(jout), (err(tout), err(jout))


def test_cli_debug2_prints_the_field():
    rc, out = _run(t_main, ["elliptic", "-device", "cpu", "-dim", "8,6", "-debug", "2"])
    assert rc == 0
    rows = [ln for ln in out.splitlines() if ln.strip().startswith("computed u")]
    assert len(rows) == 4 and all(len(ln.split()) == 3 + 6 for ln in rows)


def test_unported_options_raise():
    g = Grid((8, 8), device="cpu")
    # mesh= runs the whole Newton solve on slabs, curved domains included
    # (tests/test_torch_parallel.py); the Q1 FEM PC on a mesh waits for
    # item 7d
    from spectral_tpu_torch.parallel import make_mesh

    em = EllipticModel(g, mesh=make_mesh({"x": 1}), phi=lambda x: x)
    with pytest.raises(NotImplementedError, match="item 7d"):
        em.make_pc("q1fem")
    # curved domains run (tests/test_torch_curvilinear.py); phi needs an
    # unmapped grid, and -map excludes -domain, as in the JAX package
    with pytest.raises(ValueError, match="unmapped Grid"):
        _ = EllipticModel(Grid((8, 8), intervals=((0, 1), (0, 1)), device="cpu"),
                          phi=lambda x: x).cmap
    base = ["elliptic", "-device", "cpu", "-dim", "8,8"]
    with pytest.raises(SystemExit, match="mutually exclusive"):
        _run(t_main, base + ["-map", "bump:0.1", "-domain", "0,1,0,1"])
    # families run (tests/test_torch_family.py), a callable line search
    # member by member; an unknown line search name raises
    with pytest.raises(ValueError, match="unknown line search"):
        newton.newton_solve_family(
            lambda x, t: (x - t, None), torch.zeros(2, dtype=torch.float64),
            torch.ones(2, dtype=torch.float64), jacobian_action=lambda x, ls, w: w,
            config=NewtonConfig(line_search="cp"))
    # the SNES family runs (tests/test_torch_snes.py); an unknown type exits
    with pytest.raises(SystemExit, match="unknown -snes_type"):
        _run(t_main, base + ["-snes_type", "ncg"])
    # recycling runs in the host loop; make_fused_newton refuses it, as the
    # JAX package does (tests/test_torch_fused.py)
    res = newton.newton_solve(lambda x: (x - 1.0, None), torch.zeros(3, dtype=torch.float64),
                              jacobian_action=lambda x, ls, w: w,
                              config=NewtonConfig(recycle=2))
    assert res.reason > 0 and res.recycle_U.shape == (2, 3)


def test_newton_config_rejects_pc_lag_below_one():
    with pytest.raises(ValueError, match="pc_lag"):
        NewtonConfig(pc_lag=0)
    assert NewtonConfig(pc_lag=1).pc_lag == 1


def test_line_search_variants():
    """A user callable that takes the full step gives the "basic" iterates
    bit for bit; "bt" (the JAX package's default, held to it in
    test_solve_matches_jax) decreases the function norm sufficiently at
    every step."""
    tm = EllipticModel(Grid((16, 16), device="cpu"), gamma=1.0)
    _, b, d = tm.setup_problem(exact=0)

    def full_step(residual_fn, x, dx, fnorm):
        xn = x - dx
        F, ls = residual_fn(xn)
        return xn, F, ls, float(torch.linalg.vector_norm(F)), True

    res = {ls: tm.solve(b, d, newton=NewtonConfig(rtol=1e-8, line_search=ls))
           for ls in ("bt", "basic", full_step)}
    basic, user = res["basic"], res[full_step]
    assert user.iters == basic.iters and user.ksp_iters == basic.ksp_iters
    torch.testing.assert_close(user.x, basic.x, rtol=0, atol=0)
    assert user.reason == basic.reason == res["bt"].reason == ConvergedReason.CONVERGED_RTOL
    h = res["bt"].fnorm_history
    assert all(f1 <= (1 - 1e-4 * 2.0 ** -11) * f0 for f0, f1 in zip(h, h[1:]))


def test_grid_defaults_to_cuda(monkeypatch):
    """Grid's device defaults to cuda: without CUDA it raises, naming the
    way to the host; the CLI's rule."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Grid((8, 8))
    assert Grid((8, 8), device="cpu").boundary_mask.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _run(t_main, ["elliptic", "-dim", "8,8"])


@pytest.mark.parametrize("dims", [(16, 16), (24, 24)])
def test_elliptic_mg_within_lu_count(dims):
    """The item-2 parity check of tests/test_parity_fixtures.py::
    test_elliptic_lu_crosscheck on the port's own counts: the multigrid PC
    (two residual-corrected V-cycles an apply) within 1.15x of the total
    FGMRES count under a dense LU of the same assembled stencil, the
    reference's -pc_type lu (the JAX package recorded 68 against 64 at
    16^2 and 71 against 62 at 24^2)."""
    m = EllipticModel(Grid(dims, device="cpu"), gamma=1.0, exponent=2.0)
    u, b, d = m.setup_problem(exact=0, cos_scale=1.0)
    ksp = KSPConfig(type="fgmres", rtol=1e-10, max_it=200)
    newton_cfg = NewtonConfig(rtol=1e-10)
    r_lu = m.solve(b, d, pc_type="lu", ksp=ksp, newton=newton_cfg)
    r_mg = m.solve(b, d, pc_type="mg", ksp=ksp, newton=newton_cfg)
    assert r_lu.reason > 0 and r_mg.reason > 0
    total_lu, total_mg = sum(r_lu.ksp_iters), sum(r_mg.ksp_iters)
    assert total_mg <= 1.15 * total_lu, (total_mg, total_lu)
