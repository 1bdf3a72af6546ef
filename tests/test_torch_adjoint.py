"""The port's differentiable tier (spectral_tpu_torch.solvers.adjoint, the
Stokes, transient and convection adjoints) against the JAX package on the
CPU in float64.

- Live: ``implicit_gradient`` and ``implicit_hvp`` on the 10 x 10
  field-parameter and HVP problems of tests/test_adjoint.py, the JAX side
  run once in a module fixture, to 1e-9 relative.
- Recorded: the gradients and adjoint counts that ``python3
  stokes_oracle.py adjoint`` printed for four of the JAX package's adjoint
  tests (ADJOINT_ORACLE below: a live run of the 12-step checkpointed
  adjoint alone takes the JAX package over two minutes).  The port holds to
  each gradient at 1e-6 relative and to each adjoint count within max(3,
  10%); where the JAX test holds a finite-difference gate that a CPU test
  can afford, the port holds it too (the rest are held on the card,
  chip_smoke.py phase 13).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectral_tpu.grid import Grid as JGrid
from spectral_tpu.ops.chebyshev import chebdiff as jchebdiff
from spectral_tpu.solvers import adjoint as jadj
from spectral_tpu.solvers.krylov import KSPConfig as JKSP
from spectral_tpu.solvers.newton import NewtonConfig as JNewton
from spectral_tpu.solvers.newton import newton_solve as jnewton
from spectral_tpu_torch.grid import Grid
from spectral_tpu_torch.models.convection import ConvectionConfig, ConvectionModel
from spectral_tpu_torch.models.rheology import PowerLawParams
from spectral_tpu_torch.models.stokes import StokesConfig, StokesProblem
from spectral_tpu_torch.models.stokes_unsteady import UnsteadyStokes
from spectral_tpu_torch.ops.chebyshev import chebdiff
from spectral_tpu_torch.solvers import adjoint as tadj
from spectral_tpu_torch.solvers.krylov import KSPConfig
from spectral_tpu_torch.solvers.newton import NewtonConfig, newton_solve
from spectral_tpu_torch.utils.interop import power_law_params_from_numpy, pytree_to_numpy

# stokes_oracle.py adjoint: the JAX package on the CPU in float64
ADJOINT_ORACLE = {
    "stokes 10x10": {"grad": {"hardness": -0.31284656094780944, "exponent": 0.04750934889809067,
                              "regularization": 2.198284525086777,
                              "gamma0": -0.05622879498608468},
                     "iters": 27, "newton": 11},
    "transient 8x8": {"grad": {"hardness": -0.029151590654105525,
                               "exponent": 0.01620632766203873,
                               "regularization": 0.09623661606902745,
                               "gamma0": -0.002036974654739482},
                      "iters": [8, 8], "qoi": 26.032842246686613},
    "checkpointed 8x8": {"grad": {"hardness": -0.0469770569338182,
                                  "exponent": 0.007811349198412104,
                                  "regularization": 0.25462303195105324,
                                  "gamma0": 0.006671480421578042},
                         "info": {"iters": [8, 7, 7, 8, 8, 8, 8, 8, 8, 8, 8, 8],
                                  "peak_states": 9, "forward_steps": 24,
                                  "qoi": 18.461698973975654, "segments": 4}},
    "rollout_diff 8x8": {"loss": 1.071729246300238,
                         "grad": {"Ra": 3.244756142370254e-05, "contrast": 0.013759237937072857,
                                  "T0": 0.07076380703407392}},
}
GRAD_RTOL = 1e-6


def _count_ok(got: int, ref: int) -> bool:
    return abs(got - ref) <= max(3, 0.1 * ref)


def _grads_close(got: dict, ref: dict, rtol=GRAD_RTOL):
    scale = max(abs(v) for v in ref.values())
    for k, v in ref.items():
        assert abs(got[k] - v) <= rtol * max(abs(v), 1e-3 * scale), (k, got[k], v)


# -- solvers/adjoint.py, live against the JAX package ----------------------------

DIMS = (10, 10)
NEWTON_TOL = 1e-13


def _toy(ops, g, base, field: bool):
    """tests/test_adjoint.py's elliptic residual F(u, theta) = -sum_ax
    d_ax((1 + gamma u^2) d_ax u) - b: with ``field`` theta is the forcing
    field b (gamma 0.5), else the dict {gamma, scale} (b = scale * base)."""
    zeros_like, cd = ops

    def residual(uG, th):
        u = g.zero_boundary(uG)
        eta = 1.0 + (0.5 if field else th["gamma"]) * u**2
        F = zeros_like(u)
        for ax in range(2):
            F = F - cd(eta * cd(u, ax), ax)
        return g.zero_boundary(F) - (g.zero_boundary(th) if field else th["scale"] * base)

    return residual


@pytest.fixture(scope="module")
def toy():
    jg, tg = JGrid(DIMS), Grid(DIMS, device="cpu")
    base_np = np.asarray(jg.zero_boundary(jnp.prod(jnp.cos(0.5 * jnp.pi * jg.coords), axis=-1)))
    th_np = {"gamma": 0.5, "scale": 1.2}
    v_np = {"gamma": 1.0, "scale": -0.7}
    out = {"base": base_np, "th": th_np, "v": v_np}
    # the JAX side, once: the field-parameter gradient and the HVP problem
    ksp = JKSP(type="gmres", rtol=1e-12, max_it=500)
    jres_f = _toy((jnp.zeros_like, jchebdiff), jg, None, True)
    jres_t = _toy((jnp.zeros_like, jchebdiff), jg, jnp.asarray(base_np), False)
    jb = jnp.asarray(base_np)

    def jsolve(res, th):
        return jnewton(lambda t: (res(t, th), None), jnp.zeros(DIMS),
                       ksp=JKSP(type="gmres", rtol=NEWTON_TOL, max_it=400),
                       config=JNewton(rtol=NEWTON_TOL, max_it=40)).x

    xs_f = jsolve(jres_f, jb)
    g_f, r_f = jadj.implicit_gradient(jres_f, lambda u, b: jnp.sum(u**2), xs_f, jb, ksp=ksp)
    xs_t = jsolve(jres_t, th_np)
    q = lambda u, th: jnp.sum(u**2) + 0.3 * th["scale"] ** 2 * th["gamma"]   # noqa: E731
    g_t, r_t = jadj.implicit_gradient(jres_t, q, xs_t, th_np, ksp=ksp)
    hv, rt, ra = jadj.implicit_hvp(jres_t, q, xs_t, th_np, r_t.x, v_np, ksp=ksp)
    out["jax"] = {"xs_f": np.asarray(xs_f), "grad_f": np.asarray(g_f),
                  "xs_t": np.asarray(xs_t), "grad_t": pytree_to_numpy(g_t),
                  "lam_t": np.asarray(r_t.x), "hvp": pytree_to_numpy(hv),
                  "iters": (int(r_f.iters), int(r_t.iters), int(rt.iters), int(ra.iters))}
    out["grid"] = tg
    return out


def test_implicit_gradient_matches_jax(toy):
    """The field-parameter gradient (one adjoint solve for every node) and
    the {gamma, scale} gradient, at the JAX package's converged states."""
    g, J = toy["grid"], toy["jax"]
    ksp = KSPConfig(type="gmres", rtol=1e-12, max_it=500)
    res_f = _toy((torch.zeros_like, chebdiff), g, None, True)
    b = torch.from_numpy(toy["base"].copy())
    grad, r = tadj.implicit_gradient(res_f, lambda u, th: torch.sum(u**2),
                                     torch.from_numpy(J["xs_f"].copy()), b, ksp=ksp)
    assert r.reason > 0 and grad.shape == DIMS and _count_ok(r.iters, J["iters"][0])
    err = np.max(np.abs(grad.numpy() - J["grad_f"])) / np.max(np.abs(J["grad_f"]))
    assert err <= 1e-9, err
    res_t = _toy((torch.zeros_like, chebdiff), g, b, False)
    q = lambda u, th: torch.sum(u**2) + 0.3 * th["scale"] ** 2 * th["gamma"]   # noqa: E731
    grad, r = tadj.implicit_gradient(res_t, q, torch.from_numpy(J["xs_t"].copy()),
                                     toy["th"], ksp=ksp)
    assert r.reason > 0 and _count_ok(r.iters, J["iters"][1])
    _grads_close(pytree_to_numpy(grad), J["grad_t"], 1e-9)


def test_implicit_hvp_matches_jax(toy):
    """The second-order adjoint's H v (a tangent and a second adjoint
    solve) at the JAX state and first adjoint, to 1e-9 relative, with
    theta a dict of Python floats."""
    g, J = toy["grid"], toy["jax"]
    ksp = KSPConfig(type="gmres", rtol=1e-12, max_it=500)
    res_t = _toy((torch.zeros_like, chebdiff), g, torch.from_numpy(toy["base"].copy()), False)
    q = lambda u, th: torch.sum(u**2) + 0.3 * th["scale"] ** 2 * th["gamma"]   # noqa: E731
    hv, rt, ra = tadj.implicit_hvp(res_t, q, torch.from_numpy(J["xs_t"].copy()), toy["th"],
                                   torch.from_numpy(J["lam_t"].copy()), toy["v"], ksp=ksp)
    assert rt.reason > 0 and ra.reason > 0
    assert _count_ok(rt.iters, J["iters"][2]) and _count_ok(ra.iters, J["iters"][3])
    _grads_close(pytree_to_numpy(hv), J["hvp"], 1e-9)
    assert all(isinstance(v, torch.Tensor) and v.dtype == torch.float64 for v in hv.values())


def test_port_newton_converges_to_the_jax_state(toy):
    """The port's own forward solve of the HVP problem reaches the state the
    JAX package's did, so the live comparisons above start from the same
    point either way."""
    g, J = toy["grid"], toy["jax"]
    th = {k: torch.tensor(v, dtype=torch.float64) for k, v in toy["th"].items()}
    res_t = _toy((torch.zeros_like, chebdiff), g, torch.from_numpy(toy["base"].copy()), False)
    out = newton_solve(lambda t: (res_t(t, th), None), torch.zeros(DIMS, dtype=torch.float64),
                       ksp=KSPConfig(type="gmres", rtol=NEWTON_TOL, max_it=400),
                       config=NewtonConfig(rtol=NEWTON_TOL, max_it=40))
    assert out.reason > 0
    assert np.max(np.abs(out.x.numpy() - J["xs_t"])) <= 1e-11 * np.max(np.abs(J["xs_t"]))


# -- the Stokes, transient and convection adjoints, against ADJOINT_ORACLE -------

def test_stokes_adjoint_gradient_preconditioned():
    """StokesProblem.adjoint_gradient on test_adjoint.py's 10 x 10 power
    law: the nested adjoint PC (make_pc(adjoint=True)), the gradient in
    every PowerLawParams field, its hardness component against central
    differences of two Newton solves (h 1e-4, 1e-4 relative: the JAX
    test's gate)."""
    spec = ADJOINT_ORACLE["stokes 10x10"]
    cfg = StokesConfig(exact=1, boundary=0, rheology=1, exponent=2.0, regularization=1e-2,
                       pcvel="fastdiag")
    p = StokesProblem(Grid((10, 10), device="cpu"), cfg)

    def solve(params, x0=None):
        out = p.solve(x0, params=params)
        assert out.reason > 0
        return out

    th0 = PowerLawParams(1.0, cfg.exponent, cfg.regularization, cfg.gamma0)
    fwd = solve(th0)
    assert fwd.iters == spec["newton"]
    qoi = lambda x, th: torch.sum(x["v"] ** 2)   # noqa: E731
    theta = power_law_params_from_numpy(th0, device="cpu")
    grad, res = p.adjoint_gradient(qoi, fwd.x, theta)
    assert res.reason > 0 and _count_ok(res.iters, spec["iters"]), res.iters
    assert isinstance(grad, PowerLawParams)
    _grads_close(pytree_to_numpy(grad), spec["grad"])
    h = 1e-4   # the perturbed solves start at x*, where they end in a few steps
    fd = (float(qoi(solve(dataclasses.replace(th0, hardness=1.0 + h), fwd.x).x, 0))
          - float(qoi(solve(dataclasses.replace(th0, hardness=1.0 - h), fwd.x).x, 0))) / (2 * h)
    assert abs(float(grad.hardness) - fd) < 1e-4 * max(1.0, abs(fd)), (float(grad.hardness), fd)


def _unsteady(dt):
    from spectral_tpu_torch.solvers.newton import NewtonConfig as NC

    cfg0 = StokesConfig(exact=1, boundary=0, rheology=1, exponent=3.0, regularization=1e-1,
                        hardness=1.2, pcvel="mg",
                        outer_ksp=KSPConfig(type="fgmres", rtol=1e-12, max_it=600, restart=150),
                        newton=NC(rtol=1e-12, max_it=20))
    return cfg0, UnsteadyStokes(Grid((8, 8), device="cpu"), cfg0, dt=dt, theta=0.5)


def test_transient_adjoint_matches_oracle_and_finite_differences():
    """test_stokes_unsteady.py's transient adjoint (8 x 8, 2 CN steps of
    the power law): the gradient and the per-step adjoint counts against
    ADJOINT_ORACLE, and the hardness component against central differences
    of the rollout (h 1e-6, 1e-5 relative: the JAX test's gate)."""
    spec = ADJOINT_ORACLE["transient 8x8"]
    cfg0, m0 = _unsteady(0.1)
    u0, s, f, _, _ = m0.manufactured(omega=1.0)
    times = np.array([0.0, 0.1, 0.2])
    qoi = lambda v: torch.sum(v * v)   # noqa: E731
    traj, _, _ = m0.rollout(u0, times, s, f, keep_trajectory=True)
    assert float(qoi(traj[-1])) == pytest.approx(spec["qoi"], rel=1e-9)
    grad, its = m0.adjoint_gradient(qoi, traj, times, s, f)
    assert len(its) == 2 and all(_count_ok(a, b) for a, b in zip(its, spec["iters"])), its
    _grads_close(pytree_to_numpy(grad), spec["grad"])

    def J(hard):
        m = UnsteadyStokes(m0.grid, dataclasses.replace(cfg0, hardness=hard), dt=0.1, theta=0.5)
        return float(qoi(m.rollout(u0, times, s, f)[0]))

    h = 1e-6
    fd = (J(1.2 + h) - J(1.2 - h)) / (2 * h)
    assert abs(fd - float(grad.hardness)) < 1e-5 * abs(fd), (fd, float(grad.hardness))


def test_checkpointed_adjoint_matches_oracle():
    """test_stokes_unsteady.py's checkpointed adjoint (8 x 8, 12 steps):
    sqrt(12) gives 4 segments, a peak of 9 states against the 13 of the
    whole trajectory, exactly one recomputation pass (24 forward solves);
    the gradient equals the JAX package's full-trajectory one (which its
    own checkpointed one equals to 1e-7) at 1e-6 relative, and the
    per-step adjoint counts its within max(3, 10%)."""
    spec = ADJOINT_ORACLE["checkpointed 8x8"]
    _, m0 = _unsteady(0.05)
    u0, s, f, _, _ = m0.manufactured(omega=1.0)
    times = np.arange(13) * 0.05
    grad, info = m0.adjoint_gradient_checkpointed(lambda v: torch.sum(v * v), u0, times, s, f)
    ref = spec["info"]
    assert info["segments"] == ref["segments"] == 4
    assert info["peak_states"] == ref["peak_states"] <= 9 < 13
    assert info["forward_steps"] == ref["forward_steps"] == 24
    assert info["qoi"] == pytest.approx(ref["qoi"], rel=1e-9)
    assert all(_count_ok(a, b) for a, b in zip(info["iters"], ref["iters"])), info["iters"]
    _grads_close(pytree_to_numpy(grad), spec["grad"])


def test_rollout_diff_matches_oracle():
    """test_convection.py's differentiable rollout (8 x 8, 3 steps, contrast
    3, the nested PC): autograd through rollout_diff in Ra (the right-hand
    side), the contrast (the operator's eta(T): the -lambda^T dA x term) and
    a seeded T0 direction, against ADJOINT_ORACLE at 1e-6 relative (the
    finite-difference gate, 1e-3, is phase 13c's on the card)."""
    spec = ADJOINT_ORACLE["rollout_diff 8x8"]
    cfg = ConvectionConfig(Ra=3e3, dt=1e-3, eta_contrast=3.0, velocity_bc="freeslip",
                           side_bc="insulated",
                           stokes_ksp=KSPConfig(type="fgmres", rtol=1e-10, max_it=200,
                                                restart=80),
                           temp_ksp=KSPConfig(type="cg", rtol=1e-12, max_it=120))
    m = ConvectionModel.unit_box((8, 8), cfg, device="cpu")
    T0 = m.conductive_state(amp=0.05)
    dT = torch.from_numpy(np.random.default_rng(3).standard_normal(m.grid.dims) * 0.01)
    args = [torch.tensor(v, dtype=torch.float64, requires_grad=True) for v in (3e3, 3.0, 0.0)]
    T, x = m.rollout_diff(T0 + args[2] * dT, 3, Ra=args[0], contrast=args[1])
    loss = m.nusselt_top(T) + 1e-2 * m.vrms(x)
    assert float(loss.detach()) == pytest.approx(spec["loss"], rel=1e-10)
    grads = torch.autograd.grad(loss, args)
    _grads_close(dict(zip(("Ra", "contrast", "T0"), map(float, grads))), spec["grad"])


def test_adjoint_pc_apply_matches_jax():
    """One application of make_pc(adjoint=True) at a seeded power-law
    linearization (8 x 8, full block LU, three fixed GMRES iterations in
    each nested velocity solve and two in the Schur solve, so both
    packages run the same iterations): VV^T, PV^T and VP^T as vjps against
    the JAX package's jax.linear_transpose, in one compiled program, to
    1e-11 of the largest entry."""
    from spectral_tpu.models.stokes import StokesConfig as JConfig
    from spectral_tpu.models.stokes import StokesProblem as JProblem
    from spectral_tpu.models.rheology import PowerLawParams as JParams

    fixed = dict(rtol=1e-30, atol=0.0, restart=30)
    kw = dict(exact=1, rheology=1, exponent=3.0, regularization=1e-1, pcvel="fastdiag")
    jp = JProblem(JGrid((8, 8)), JConfig(vel_ksp=JKSP(type="gmres", max_it=3, **fixed),
                                         svel_ksp=JKSP(type="gmres", max_it=3, **fixed),
                                         schur_ksp=JKSP(type="gmres", max_it=2, **fixed), **kw))
    tp = StokesProblem(Grid((8, 8), device="cpu"),
                       StokesConfig(vel_ksp=KSPConfig(type="gmres", max_it=3, **fixed),
                                    svel_ksp=KSPConfig(type="gmres", max_it=3, **fixed),
                                    schur_ksp=KSPConfig(type="gmres", max_it=2, **fixed), **kw))
    rng = np.random.default_rng(21)
    x = {"v": np.asarray(tp.mask_v(torch.from_numpy(rng.standard_normal((8, 8, 2))))),
         "p": np.asarray(tp.mask_p(torch.from_numpy(rng.standard_normal((8, 8)))))}
    r = {"v": rng.standard_normal((8, 8, 2)), "p": rng.standard_normal((8, 8))}
    params = (1.0, 3.0, 1e-1, 1.0)

    def jrun(x, r):
        setup, apply = jp.make_pc(adjoint=True)
        _, lin = jp.make_residual(JParams(*params))(x)
        return apply(setup(x, lin), r)

    want = jax.jit(jrun)(*({k: jnp.asarray(v) for k, v in d.items()} for d in (x, r)))
    tx = {k: torch.from_numpy(v.copy()) for k, v in x.items()}
    setup, apply = tp.make_pc(adjoint=True)
    _, lin = tp.make_residual(PowerLawParams(*params))(tx)
    got = apply(setup(tx, lin), {k: torch.from_numpy(v) for k, v in r.items()})
    for k in ("v", "p"):
        w = np.asarray(want[k])
        err = np.max(np.abs(got[k].numpy() - w)) / np.max(np.abs(w))
        assert err <= 1e-11, (k, err)
