"""The port's heat path (spectral_tpu_torch.models.heat, solvers/ts.py, the
CG solver, Options.get_bool and the ``heat`` CLI) against the JAX package
on the same numpy-seeded inputs, on the CPU, in float64.

Each JAX program is compiled once, in a module fixture.  Steps agree to
1e-12 relative to the largest entry; the adaptive controller's decisions
(steps, rejects) are equal and every dt agrees to 1e-10; residual
histories agree norm-wise to the tolerance stated.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectral_tpu.grid import Grid as JGrid
from spectral_tpu.models.heat import HeatModel as JHeat
from spectral_tpu.ops.chebyshev import chebdiff as jchebdiff
from spectral_tpu.ops.fastdiag import FastDiagSolver as JFastDiag
from spectral_tpu.solvers import krylov as jkrylov
from spectral_tpu.solvers import ts as jts
from spectral_tpu_torch.cli.main import main as t_main
from spectral_tpu_torch.grid import Grid
from spectral_tpu_torch.models.heat import HeatModel
from spectral_tpu_torch.ops.chebyshev import chebdiff
from spectral_tpu_torch.ops.fastdiag import FastDiagSolver
from spectral_tpu_torch.solvers import krylov as tkrylov
from spectral_tpu_torch.solvers import ts as tts
from spectral_tpu_torch.solvers.krylov import KSPConfig
from spectral_tpu_torch.solvers.types import ConvergedReason
from spectral_tpu_torch.utils.interop import solve_result_to_numpy
from spectral_tpu_torch.utils.options import Options

DIMS = (8, 8)


def _rel(got, ref) -> float:
    return float(np.max(np.abs(np.asarray(got) - np.asarray(ref))) / np.max(np.abs(ref)))


def _hist_close(T, J, tol):
    assert T.shape == J.shape
    assert np.linalg.norm(T - J) <= tol * np.linalg.norm(J)


def _heat_inputs(seed):
    rng = np.random.default_rng(seed)
    g = Grid(DIMS, device="cpu")
    u0 = np.asarray(g.zero_boundary(torch.prod(torch.cos(0.5 * np.pi * g.coords), -1)))
    u0 = u0 + 0.1 * np.where(g.boundary_mask_np, 0.0, rng.standard_normal(DIMS))
    f = rng.standard_normal(DIMS)
    bc = np.where(g.boundary_mask_np, 0.2 * rng.standard_normal(DIMS), 0.0)
    return u0, f, bc


# -- CG ----------------------------------------------------------------------

def test_cg_matches_jax():
    """An SPD system on the 8x8 grid, c I + G^T G with G seeded, under the
    fast-diagonalization preconditioner of the same grid."""
    rng = np.random.default_rng(3)
    n = int(np.prod(DIMS))
    G = rng.standard_normal((n, n)) / np.sqrt(n)
    A = 2.0 * np.eye(n) + G.T @ G
    b = rng.standard_normal(DIMS)
    jfd = JFastDiag.build(JGrid(DIMS), shift=4.0)
    tfd = FastDiagSolver.build(Grid(DIMS, device="cpu"), shift=4.0)
    kw = dict(rtol=1e-12, max_it=200)
    Aj = jnp.asarray(A)
    jres = jax.jit(lambda bb: jkrylov.cg(lambda x: (Aj @ x.reshape(-1)).reshape(DIMS), bb,
                                         M=jfd.apply, **kw))(jnp.asarray(b))
    At = torch.from_numpy(A)
    tres = tkrylov.cg(lambda x: (At @ x.reshape(-1)).reshape(DIMS), torch.from_numpy(b),
                      M=tfd.apply, **kw)
    J, T = solve_result_to_numpy(jres), solve_result_to_numpy(tres)
    assert J["iters"] > 5
    assert T["iters"] == J["iters"] and T["reason"] == J["reason"] == ConvergedReason.CONVERGED_RTOL
    _hist_close(T["history"], J["history"], 1e-10)
    assert _rel(T["x"], J["x"]) <= 1e-10
    # through KSPConfig: cg is registered, and so are the short-recurrence
    # types (tests/test_torch_krylov.py holds them to the JAX package)
    res = KSPConfig(type="cg", **kw).solve(lambda x: (At @ x.reshape(-1)).reshape(DIMS),
                                           torch.from_numpy(b), M=tfd.apply)
    assert res.iters == T["iters"]
    res = KSPConfig(type="bicgstab", **kw).solve(lambda x: (At @ x.reshape(-1)).reshape(DIMS),
                                                 torch.from_numpy(b), M=tfd.apply)
    assert res.reason == ConvergedReason.CONVERGED_RTOL


def test_get_bool_matches_jax():
    from spectral_tpu.utils.options import Options as JOptions

    argv = ["-a", "-b", "0", "-c", "false", "-d", "no", "-e", "1", "-f", "yes"]
    t, j = Options(argv), JOptions(argv)
    for key in "abcdefg":
        assert t.get_bool(key, True) == j.get_bool(key, True), key
    assert t.get_bool("g") is False


# -- the model's steps -----------------------------------------------------------

@pytest.fixture(scope="module", params=[(), (0,)], ids=["dirichlet", "neumann0"])
def steps(request):
    """One theta step (dt 0.02, CN) and one variable BDF2 step (dt 0.015,
    rr 1.5) of the JAX model, with its Laplacian, implicit operator and PC
    on a seeded field, in one compiled program; the port's on the same
    inputs."""
    nm = request.param
    u0, f, bc = _heat_inputs(5)
    up = 0.9 * u0
    w = np.random.default_rng(7).standard_normal(DIMS)
    jm = JHeat(JGrid(DIMS), dt=0.02, neumann_axes=nm)

    def run(u, up, f, bc, w):
        return (jm.step_theta_dt(u, f, bc, 0.02), jm.step_bdf2_dt(u, up, f, bc, 0.015, 1.5),
                jm.laplacian(w), jm.implicit_operator(w), jm._pc_apply(w))

    J = jax.jit(run)(*(jnp.asarray(a) for a in (u0, up, f, bc, w)))
    tm = HeatModel(Grid(DIMS, device="cpu"), dt=0.02, neumann_axes=nm)
    u, upt, ft, bct, wt = (torch.from_numpy(a) for a in (u0, up, f, bc, w))
    T = (tm.step_theta_dt(u, ft, bct, 0.02), tm.step_bdf2_dt(u, upt, ft, bct, 0.015, 1.5),
         tm.laplacian(wt), tm.implicit_operator(wt), tm._pc_apply(wt))
    return nm, jm, tm, J, T


def test_steps_match_jax(steps):
    nm, jm, tm, J, T = steps
    assert tm.ksp.type == jm.ksp.type == ("gmres" if nm else "cg")
    for name, j, t in zip(("theta", "bdf2"), J, T):
        assert _rel(t, j) <= 1e-12, name


def test_operator_and_laplacian_match_jax(steps):
    _, _, _, J, T = steps
    for name, j, t in zip(("laplacian", "implicit_operator", "_pc_apply"), J[2:], T[2:]):
        assert _rel(t, j) <= 1e-12, name


@pytest.mark.parametrize("nm", [(), (0,)], ids=["dirichlet", "neumann0"])
def test_step_diff_vjp_matches_jax(nm):
    """HeatModel.step_diff differentiated in u, f and the Dirichlet data:
    the port's implicit adjoint (GMRES on A^T under the transposed fastdiag
    PC) by torch.autograd.grad and by torch.func.vjp, against jax.vjp of
    the JAX step_diff (lax.custom_linear_solve, A^T under the PC itself),
    compiled once, to 1e-10 of the largest entry; the step itself equals
    ``step``.  Both solve at rtol 1e-13: the two adjoint solves take other
    preconditioners, so each must land well inside the comparison."""
    u0, f, bc = _heat_inputs(13)
    ct = np.random.default_rng(17).standard_normal(DIMS)
    ksp = dict(type="cg", rtol=1e-13, max_it=200)
    jm = JHeat(JGrid(DIMS), dt=0.01, neumann_axes=nm, ksp=jkrylov.KSPConfig(**ksp))

    def jrun(u, f, bc, ct):
        y, vjp = jax.vjp(jm.step_diff, u, f, bc)
        return y, vjp(ct)

    jy, jg = jax.jit(jrun)(*(jnp.asarray(a) for a in (u0, f, bc, ct)))
    tm = HeatModel(Grid(DIMS, device="cpu"), dt=0.01, neumann_axes=nm, ksp=KSPConfig(**ksp))
    args = [torch.tensor(a, requires_grad=True) for a in (u0, f, bc)]
    y = tm.step_diff(*args)
    assert _rel(y.detach(), jy) <= 1e-12
    assert torch.equal(y.detach(), tm.step(*(a.detach() for a in args)))
    grads = torch.autograd.grad(y, args, torch.from_numpy(ct))
    _, vjp = torch.func.vjp(tm.step_diff, *(a.detach() for a in args))
    for name, a, b, j in zip(("u", "f", "dirichlet"), grads, vjp(torch.from_numpy(ct)), jg):
        assert _rel(a, j) <= 1e-10, name
        assert torch.equal(a, b), name


def test_heat_model_raises():
    g = Grid(DIMS, device="cpu")
    # a curved domain runs (tests/test_torch_curvilinear.py), with GMRES:
    # the metric operator is not symmetric
    assert HeatModel(g, dt=0.1, phi=lambda x: x).ksp.type == "gmres"
    with pytest.raises(ValueError, match="curvilinear heat needs an unmapped Grid"):
        HeatModel(Grid(DIMS, intervals=((0.0, 1.0),) * 2, device="cpu"), dt=0.1,
                  phi=lambda x: x)
    with pytest.raises(ValueError, match="Dirichlet"):
        HeatModel(g, dt=0.1, neumann_axes=(0, 1))


# -- solvers/ts.py -----------------------------------------------------------------

def test_integrate_adaptive_matches_jax():
    u0, f, bc = _heat_inputs(11)
    bc = np.zeros(DIMS)
    cfg = dict(rtol=1e-4, atol=1e-8, dt0=0.004)
    jm = JHeat(JGrid(DIMS), dt=0.01)
    ju, jinfo = jts.integrate_adaptive(jm, jnp.asarray(u0), 0.0, 0.05, jnp.asarray(f),
                                       jnp.asarray(bc), jts.TSConfig(**cfg))
    tm = HeatModel(Grid(DIMS, device="cpu"), dt=0.01)
    tu, tinfo = tts.integrate_adaptive(tm, torch.from_numpy(u0), 0.0, 0.05, torch.from_numpy(f),
                                       torch.from_numpy(bc), tts.TSConfig(**cfg))
    assert jinfo["rejects"] > 0 and jinfo["steps"] > 5
    assert (tinfo["steps"], tinfo["rejects"]) == (jinfo["steps"], jinfo["rejects"])
    # each dt follows est^(-1/3), est a WRMS reduction summed in another
    # order: the dts agree to 1e-10 (measured 7e-12)
    np.testing.assert_allclose(tinfo["dts"], jinfo["dts"], rtol=1e-10)
    assert _rel(tu, ju) <= 1e-12


def test_pseudo_transient_bratu_matches_jax():
    """PTC on the 8x8 Bratu problem -Lap u = lam e^u, u = 0 on the boundary,
    with the shift-free fastdiag applied with half the run-time shift."""
    lam = 0.5   # under the critical 6.81/4 of [-1, 1]^2
    jg, tg = JGrid(DIMS), Grid(DIMS, device="cpu")

    def make(g, cd, exp, fd):
        def lap(u):
            return cd(cd(u, 0), 0) + cd(cd(u, 1), 1)

        def residual(u):
            return g.zero_boundary(-lap(u) - lam * exp(u)) + g.set_boundary(0.0 * u, u), u

        def jac(x, lin, w):
            return g.zero_boundary(-lap(w) - lam * exp(x) * w) + g.set_boundary(0.0 * w, w)

        return residual, jac, (lambda r, s: fd.apply(r, 0.5 * s))

    # two steps (each JAX Krylov solve compiles anew), the second with a
    # dt grown by SER; the residuals stay far above the float64 floor,
    # where the two packages' summation orders would decide them
    kw = dict(dt0=20.0, rtol=1e-3, max_it=20)
    jres, jac_, jM = make(jg, jchebdiff, jnp.exp, JFastDiag.build(jg))
    jr = jts.pseudo_transient_solve(jres, jnp.zeros(DIMS), jac_, jM, **kw)
    tres, tjac, tM = make(tg, chebdiff, torch.exp, FastDiagSolver.build(tg))
    tr = tts.pseudo_transient_solve(tres, torch.zeros(DIMS, dtype=torch.float64), tjac, tM, **kw)
    assert jr["converged"] and tr["converged"]
    assert tr["iters"] == jr["iters"] == 2
    # norm-wise: each |F| is a difference of O(1) terms, so its last digits
    # carry float64 round-off of |F_0|
    _hist_close(np.asarray(tr["history"]), np.asarray(jr["history"]), 1e-8)
    assert _rel(tr["x"], jr["x"]) <= 1e-10


def test_rollout_bdf2_is_the_host_loop():
    u0, f, bc = _heat_inputs(2)
    tm = HeatModel(Grid(DIMS, device="cpu"), dt=0.01)
    u, ft, bct = (torch.from_numpy(a) for a in (u0, f, bc))
    got = tts.rollout_bdf2(tm, u, ft, bct, 0.01, 3)
    u1 = tm.step_theta_dt(u, ft, bct, 0.01)
    u2 = tm.step_bdf2_dt(u1, u, ft, bct, 0.01, 1.0)
    assert torch.equal(got, tm.step_bdf2_dt(u2, u1, ft, bct, 0.01, 1.0))


# -- the CLI ------------------------------------------------------------------------

def test_heat_cli_matches_oracle():
    """The JAX heat CLI's default run (stokes_oracle.py unsteady, "heat
    16^2": error 7.267423e-05), printed to the same digits."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = t_main(["heat", "-device", "cpu"])
    out = buf.getvalue()
    assert rc == 0, out
    assert "Heat problem  dims = [16,16]  dt = 0.01  theta = 0.5  steps = 20" in out
    assert "Norm of error vs analytic decay 7.267423e-05" in out
    # -map runs (tests/test_torch_curvilinear.py holds it to the JAX
    # driver); with -domain it is refused as the JAX driver refuses it
    with pytest.raises(SystemExit, match="mutually exclusive"):
        t_main(["heat", "-device", "cpu", "-map", "bump:0.1", "-domain", "0,1,0,1"])


def test_curved_heat_step_matches_jax():
    """HeatModel(phi=bump:0.08) at 10x9 with an insulated axis: the
    implicit operator (Dirichlet and conormal face rows), the metric
    multigrid PC with its zero-flux folds, and one step (GMRES: the metric
    operator is not symmetric) against the JAX model's."""
    neumann_axes = (1,)
    from spectral_tpu.ops.curvilinear import named_map as j_named_map
    from spectral_tpu_torch.ops.curvilinear import named_map

    dims = (10, 9)
    jm = JHeat(JGrid(dims), dt=0.1, phi=j_named_map("bump:0.08"), neumann_axes=neumann_axes)
    tm = HeatModel(Grid(dims, device="cpu"), dt=0.1, phi=named_map("bump:0.08"),
                   neumann_axes=neumann_axes)
    assert tm.ksp.type == jm.ksp.type == "gmres"
    xp = tm.cmap.coords
    harm = xp[..., 0] ** 2 - xp[..., 1] ** 2
    d = np.where(Grid(dims, device="cpu").boundary_mask_np, harm, 0.0)
    u = np.random.default_rng(7).standard_normal(dims)
    z = np.zeros(dims)
    T = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    assert _rel(tm.implicit_operator(T(u)), jm.implicit_operator(jnp.asarray(u))) <= 1e-12
    assert _rel(tm._pc_apply(T(u)), jm._pc_apply(jnp.asarray(u))) <= 1e-12
    assert _rel(tm.step(T(u), T(z), T(d)),
                jm.step(jnp.asarray(u), jnp.asarray(z), jnp.asarray(d))) <= 1e-10
