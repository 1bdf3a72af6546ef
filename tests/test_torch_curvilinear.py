"""The port's curved domains against the JAX package, live on the same
inputs at 8^2 - 12^2 and 8^3: the tensor-product axis maps and
``Grid(maps=...)``, the full curvilinear map (its fields, cofactor,
normals, Laplacian and metric surrogate), the curved Poisson model, the
elliptic and Stokes models with ``phi=``, and the command lines with
``-map`` (the stokes and ustokes lines against the JAX lines that
``stokes_oracle.py curvedcpu`` recorded).  The heat, unsteady and
multigrid cases are in their own files."""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectral_tpu.grid import Grid as JGrid
from spectral_tpu.models.curvilinear import CurvilinearPoisson as JCurvedPoisson
from spectral_tpu.models.elliptic import EllipticModel as JElliptic
from spectral_tpu.models.stokes import StokesConfig as JConfig
from spectral_tpu.models.stokes import StokesProblem as JStokes
from spectral_tpu.ops import curvilinear as jcurv
from spectral_tpu.ops.mapping import AxisMap as JAxisMap
from spectral_tpu_torch.cli.main import main as t_main
from spectral_tpu_torch.grid import Grid
from spectral_tpu_torch.models.curvilinear import CurvilinearPoisson
from spectral_tpu_torch.models.elliptic import EllipticModel
from spectral_tpu_torch.models.poisson import PoissonModel
from spectral_tpu_torch.models.stokes import StokesConfig, StokesProblem
from spectral_tpu_torch.ops import curvilinear as tcurv
from spectral_tpu_torch.ops.chebyshev import chebdiff
from spectral_tpu_torch.ops.mapping import AxisMap
from spectral_tpu_torch.utils.interop import (axis_map_from_numpy, curvilinear_map_from_numpy,
                                              stokes_state_from_numpy, stokes_state_to_numpy)

CPU = dict(device="cpu")


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rel(got, ref) -> float:
    got, ref = _np(got), _np(ref)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-300))


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


# -- tensor-product axis maps -------------------------------------------------

@pytest.mark.parametrize("ctor", ["affine", "tanh_cluster", "kte", "from_nodes"])
def test_axis_maps_match_jax(ctor):
    """Every AxisMap constructor, restrict and from_nodes: host float64 in
    both packages, equal to 1e-14."""
    n = 11
    if ctor == "from_nodes":
        x = 1.5 + np.sinh(np.cos(np.arange(n) * np.pi / (n - 1)))
        j, t = JAxisMap.from_nodes(x), AxisMap.from_nodes(x)
    else:
        args = (0.0, 2.0, n) + {"affine": (), "tanh_cluster": (1.2,), "kte": (0.9,)}[ctor]
        j, t = getattr(JAxisMap, ctor)(*args), getattr(AxisMap, ctor)(*args)
    for jm, tm in ((j, t), (j.restrict(6), t.restrict(6)), (j.restrict(4), t.restrict(4))):
        np.testing.assert_allclose(tm.x, jm.x, rtol=0, atol=1e-14)
        np.testing.assert_allclose(tm.w, jm.w, rtol=0, atol=1e-14 * max(map(abs, jm.w)))
    assert axis_map_from_numpy(j.x, j.w) == t
    with pytest.raises(ValueError, match="monotone"):
        AxisMap.from_nodes(np.cos(np.linspace(0.0, 2.0 * np.pi, n)))


def _maps(pkg, dims):
    return (pkg.tanh_cluster(0.0, 2.0, dims[0], 1.4), pkg.kte(0.0, 1.0, dims[1], 0.9),
            pkg.affine(0.0, 1.0, dims[2]))[:len(dims)]


def test_grid_maps_weights_and_quadrature_match_jax():
    """Grid(maps=...): the nodes, the per-node chain-rule weights on a
    tensor (broadcast over a trailing component axis) and on numpy, and the
    quadrature weights divided by them, against the JAX grid."""
    dims = (9, 8, 7)
    jg, tg = JGrid(dims, maps=_maps(JAxisMap, dims)), Grid(dims, maps=_maps(AxisMap, dims), **CPU)
    v = np.random.default_rng(0).standard_normal(dims + (3,))
    for ax in range(3):
        np.testing.assert_array_equal(tg.nodes_1d[ax], jg.nodes_1d[ax])
        np.testing.assert_array_equal(tg.dif_weight_np(ax), jg.dif_weight_np(ax))
        assert _rel(tg.apply_dif_weight(_t(v), ax), jg.apply_dif_weight(jnp.asarray(v), ax)) == 0
        np.testing.assert_array_equal(tg.apply_dif_weight_np(v, ax),
                                      jg.apply_dif_weight_np(v, ax))
        np.testing.assert_allclose(tg.quad_weights_1d_np[ax], jg.quad_weights_1d_np[ax],
                                   rtol=1e-15)
        with pytest.raises(ValueError, match="per-node weights"):
            tg.deriv_scale(ax)
    np.testing.assert_allclose(tg.quad_weights_np, jg.quad_weights_np, rtol=1e-14)
    np.testing.assert_array_equal(tg.coords_np, jg.coords_np)
    with pytest.raises(ValueError, match="lengths"):
        Grid((9, 9, 7), maps=_maps(AxisMap, dims), **CPU)
    with pytest.raises(ValueError, match="OR maps"):
        Grid(dims, intervals=((0, 1),) * 3, maps=_maps(AxisMap, dims), **CPU)


def test_mapped_poisson_kernel_never_reaches_k2(monkeypatch):
    """A mapped 3-D PoissonModel(method="kernel") takes K1's composition,
    never K2 (whose constant per-axis scale cannot carry per-node weights),
    and equals the JAX operator on the same grid."""
    from spectral_tpu.models.poisson import PoissonModel as JPoisson
    from spectral_tpu_torch.ops import cuda_cheb

    def refuse(*a, **kw):
        raise AssertionError("K2 reached on a mapped grid")

    monkeypatch.setattr(cuda_cheb, "laplacian3d", refuse)
    dims = (9, 8, 7)
    x = np.random.default_rng(1).standard_normal(dims)
    got = PoissonModel(Grid(dims, maps=_maps(AxisMap, dims), **CPU), method="kernel").operator(_t(x))
    ref = JPoisson(JGrid(dims, maps=_maps(JAxisMap, dims))).operator(jnp.asarray(x))
    assert _rel(got, ref) <= 1e-13
    with pytest.raises(AssertionError, match="K2 reached"):   # the flat grid still takes it
        PoissonModel(Grid(dims, **CPU), method="kernel").operator(_t(x))


# -- the full curvilinear map ---------------------------------------------------

MAP_CASES = [("bump:0.08", (10, 9)), ("shear:0.3", (10, 9)), ("annulus:1:2", (10, 9)),
             ("bump:0.08", (8, 8, 8))]


@pytest.mark.parametrize("spec,dims", MAP_CASES)
def test_curvilinear_map_matches_jax(spec, dims):
    """CurvilinearMap.build's fields, the cofactor (2-D adjugate, 3-D curl
    form) and the physical normals equal the JAX map's to 1e-12; the
    cofactor satisfies the discrete GCL; the Laplacian (K1's plain version
    on the last axis here) equals the JAX one to 1e-12; the interop copy
    carries the fields."""
    jm = jcurv.CurvilinearMap.build(JGrid(dims), jcurv.named_map(spec))
    tg = Grid(dims, **CPU)
    tm = tcurv.CurvilinearMap.build(tg, tcurv.named_map(spec))
    for name in ("coords", "detJ", "Acoef", "Jinv", "cofactor"):
        ref = getattr(jm, name)
        np.testing.assert_allclose(getattr(tm, name), ref, rtol=0,
                                   atol=1e-12 * np.max(np.abs(ref)), err_msg=name)
    np.testing.assert_allclose(tm.boundary_normal(), jm.boundary_normal(), rtol=0, atol=1e-12)
    C = tm.field("cofactor", torch.float64)
    for j in range(len(dims)):
        gcl = sum(chebdiff(C[..., l, j].contiguous(), l) for l in range(len(dims)))
        assert float(torch.max(torch.abs(gcl))) <= 1e-11 * float(torch.max(torch.abs(C)))
    u = np.random.default_rng(2).standard_normal(dims)
    assert _rel(tm.laplacian(_t(u)), jm.laplacian(jnp.asarray(u))) <= 1e-12
    cm = curvilinear_map_from_numpy(tg, jm.coords, jm.detJ, jm.Acoef, jm.Jinv)
    np.testing.assert_allclose(cm.cofactor, jm.cofactor, rtol=0,
                               atol=1e-12 * np.max(np.abs(jm.cofactor)))
    assert tm.field("detJ", torch.float64) is tm.field("detJ", torch.float64)   # made once


def test_named_map_validation():
    assert tcurv.named_map("") is None
    with pytest.raises(ValueError, match="unknown map"):
        tcurv.named_map("twist:1")
    with pytest.raises(ValueError, match="0 < r0 < r1"):
        tcurv.named_map("annulus:2:1")
    with pytest.raises(ValueError, match="not invertible"):
        tcurv.CurvilinearMap.build(Grid((9, 9), **CPU), tcurv.named_map("bump:0.6"))


def test_metric_surrogate_and_folds_match_jax():
    """The separable metric stencil with eta, zero-flux folds on axis 1,
    and the pc_coeffs it is built from, against the JAX builder (1e-12)."""
    dims = (10, 9)
    jm = jcurv.CurvilinearMap.build(JGrid(dims), jcurv.named_map("bump:0.08"))
    tg = Grid(dims, **CPU)
    tm = tcurv.CurvilinearMap.build(tg, tcurv.named_map("bump:0.08"))
    eta = 1.0 + np.random.default_rng(3).random(dims)
    jc, tc = jm.pc_coeffs(jnp.asarray(eta)), tm.pc_coeffs(_t(eta))
    assert sorted(jc) == sorted(tc)
    jS = jcurv.metric_surrogate_builder(2, (1,))(JGrid(dims), jc)
    tS = tcurv.metric_surrogate_builder(2, (1,))(tg, tc)
    for a, b in zip((tS.center, *tS.lower, *tS.upper), (jS.center, *jS.lower, *jS.upper)):
        assert _rel(a, b) <= 1e-12
    jf = jcurv.metric_surrogate_folds(JGrid(dims), jc, (1,))
    tf = tcurv.metric_surrogate_folds(tg, tc, (1,))
    assert sorted(jf) == sorted(tf) == [1]
    for a, b in zip(tf[1], jf[1]):
        assert (a == b) if isinstance(a, float) else _rel(a, b) <= 1e-12


def test_curved_poisson_matches_jax():
    """CurvilinearPoisson at 10x9 on bump:0.08: the operator and the jacobi
    preconditioner (1e-12); its multigrid solve's count and error are the
    CLI's (test_cli_map_matches_jax_driver)."""
    dims = (10, 9)
    jp = JCurvedPoisson(JGrid(dims), jcurv.named_map("bump:0.08"))
    tp = CurvilinearPoisson(Grid(dims, **CPU), tcurv.named_map("bump:0.08"))
    x = np.random.default_rng(4).standard_normal(dims)
    assert _rel(tp.operator(_t(x)), jp.operator(jnp.asarray(x))) <= 1e-12
    assert _rel(tp.build_pc("jacobi")(_t(x)), jp.build_pc("jacobi")(jnp.asarray(x))) <= 1e-12
    assert tp.build_pc("none") is None

    assert _rel(tp.map.laplacian(_t(x)), jp.map.laplacian(jnp.asarray(x))) <= 1e-12


# -- the elliptic model with phi ---------------------------------------------------

def test_elliptic_phi_matches_jax():
    """EllipticModel(phi=bump:0.08) at 10x9: the manufactured problem, the
    metric residual and Jacobian action (1e-12), the host float64
    residual, the metric-surrogate mg and jacobi PCs, and the Newton solve
    (mg, the counts equal)."""
    dims = (10, 9)
    jm = JElliptic(JGrid(dims), gamma=1.0, phi=jcurv.named_map("bump:0.08"))
    tm = EllipticModel(Grid(dims, **CPU), gamma=1.0, phi=tcurv.named_map("bump:0.08"))
    jset, tset = jm.setup_problem(), tm.setup_problem()
    for a, b in zip(tset, jset):
        assert _rel(a, b) <= 1e-14
    np.testing.assert_array_equal(tm.coords_phys_np, jm.coords_phys_np)
    _, jb, jd = jset
    _, tb, td = tset
    rng = np.random.default_rng(5)
    x = np.where(Grid(dims, **CPU).boundary_mask_np, 0.0, 0.1 * rng.standard_normal(dims))
    w = rng.standard_normal(dims)
    jF, jl = jm.make_residual(jb, jd)(jnp.asarray(x))
    tF, tl = tm.make_residual(tb, td)(_t(x))
    assert _rel(tF, jF) <= 1e-12
    assert _rel(tm.jacobian_action(_t(x), tl, _t(w)),
                jm.jacobian_action(jnp.asarray(x), jl, jnp.asarray(w))) <= 1e-12
    jnp_res = jm.make_residual_np(np.asarray(jb), np.asarray(jd))(x)
    assert _rel(tm.make_residual_np(_np(tb), _np(td))(x), jnp_res) <= 1e-13
    for pc in ("mg", "jacobi"):
        (js, ja), (ts, ta) = jm.make_pc(pc), tm.make_pc(pc)
        assert _rel(ta(ts(_t(x), tl), _t(w)), ja(js(jnp.asarray(x), jl), jnp.asarray(w))) \
            <= 1e-12, pc
    jr, tr = jm.solve(jb, jd, pc_type="mg"), tm.solve(tb, td, pc_type="mg")
    assert tr.iters == int(jr.iters) and list(tr.ksp_iters) == [int(k) for k in jr.ksp_iters]
    assert _rel(tr.x, jr.x) <= 1e-9
    with pytest.raises(ValueError, match="unmapped Grid"):
        _ = EllipticModel(Grid(dims, intervals=((0, 1),) * 2, **CPU),
                          phi=tcurv.named_map("bump:0.08")).cmap


def test_fas_composes_with_curved_elliptic():
    """FASSolver on the metric-form elliptic model: the factory rebuilds
    the metric operator a level (the JAX package's
    tests/test_fas.py::test_fas_curvilinear_composes, its bounds)."""
    from spectral_tpu_torch.solvers.fas import FASSolver

    def factory(dims):
        return EllipticModel(Grid(dims, **CPU), gamma=1.0, exponent=2.0,
                             phi=tcurv.named_map("bump:0.08"))

    m = factory((17, 17))
    u, b, d = m.setup_problem(exact=0, cos_scale=1.0)
    res = FASSolver(factory, (17, 17), b, d).solve(rtol=1e-7, max_cycles=40)
    assert res.reason > 0
    assert float(torch.max(torch.abs(res.x - u))) < 2e-5


# -- Stokes with phi ---------------------------------------------------------------

STOKES_CASES = {   # map, config, the velocity PCs applied to one linearization
    "neumann": ("bump:0.06", dict(exact=1, boundary=1, tbc=1, traction_p=True), ("mg",)),
    "dirichlet": ("annulus:1:2", dict(exact=1), ("nodal", "q1fem")),
}


@pytest.mark.parametrize("case", sorted(STOKES_CASES))
def test_stokes_phi_blocks_match_jax(case):
    """StokesProblem(phi=...) at (10, 9): the residual, one Jacobian action
    and one saddle-PC apply for each velocity PC of the case (the metric
    multigrid with the traction-block correction on curved Neumann rows;
    the metric nodal stencil; isoparametric q1fem) against the JAX
    problem's, one compiled JAX program a case (1e-11); the host and
    device float64 residuals against the JAX host residual."""
    spec, kw, pcvels = STOKES_CASES[case]
    dims = (10, 9)
    jps = [JStokes(JGrid(dims), JConfig(pcvel=v, **kw), phi=jcurv.named_map(spec))
           for v in pcvels]
    tps = [StokesProblem(Grid(dims, **CPU), StokesConfig(pcvel=v, **kw),
                         phi=tcurv.named_map(spec)) for v in pcvels]
    jp, tp = jps[0], tps[0]
    rng = np.random.default_rng(6)
    x = {"v": rng.standard_normal(dims + (2,)), "p": rng.standard_normal(dims)}
    w = {"v": rng.standard_normal(dims + (2,)), "p": rng.standard_normal(dims)}
    jpar, tpar = jp.params_at(jp.config.cont), tp.params_at(tp.config.cont)
    jpcs = [q.make_pc() for q in jps]

    @jax.jit
    def jax_side(xx, ww):
        F, lin = jp.make_residual(jpar)(xx)
        return F, jp.jacobian_action(None, lin, ww), [a(s(None, lin), ww) for s, a in jpcs]

    jF, jJ, jP = jax_side(*({k: jnp.asarray(v) for k, v in s.items()} for s in (x, w)))
    tx, tw = (stokes_state_from_numpy(s, dtype=torch.float64, **CPU) for s in (x, w))
    tF, tl = tp.make_residual(tpar)(tx)
    got = [tF, tp.jacobian_action(None, tl, tw)]
    for q in tps:
        ts, ta = q.make_pc()
        got.append(ta(ts(None, tl), tw))
    for name, a, b in zip(("residual", "jacobian", *pcvels), got, (jF, jJ, *jP)):
        for k in ("v", "p"):
            assert _rel(a[k], b[k]) <= 1e-11, (name, k)
    jnp_res = jp.make_residual_np(jpar)(x)
    for k, v in tp.make_residual_np(tpar)(x).items():
        assert _rel(v, jnp_res[k]) <= 1e-13, k
    for k, v in tp.make_residual_dev64(tpar)(tx).items():
        assert _rel(v, jnp_res[k]) <= 1e-12, k
    np.testing.assert_array_equal(tp.normal_np, np.asarray(jp.normal_np))
    np.testing.assert_array_equal(tp.vel_mask_np, np.asarray(jp.vel_mask))


def test_stokes_phi_solve_matches_jax_oracle():
    """The 8^2 annulus solve through the port's model converges to the
    error of the JAX CLI's run of the same problem (CURVED_CPU8 below:
    1.893557e-03, the discretization's at 8^2)."""
    p = StokesProblem(Grid((8, 8), **CPU), StokesConfig(exact=1, pcvel="mg"),
                      phi=tcurv.named_map("annulus:1:2"))
    r = p.solve()
    assert r.reason > 0
    assert abs(p.error_vs_exact(stokes_state_to_numpy(r.x)) - 1.893557e-03) <= 1e-8


# -- the command lines with -map ------------------------------------------------

def _t_cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = t_main([*argv, "-device", "cpu"])
    return rc, buf.getvalue().splitlines()


def test_cli_map_matches_jax_driver():
    """poisson with -map prints the JAX driver's lines, line for line
    (live), and exits as it does; -map with -domain is refused by every
    driver that reads -map."""
    from spectral_tpu.cli import drivers
    from spectral_tpu.utils.options import Options

    argv = "poisson -m 10 -n 9 -map annulus:1:2 -ksp_rtol 1e-10".split()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jrc = drivers.poisson_main(Options(argv[1:]))
    rc, lines = _t_cli(argv)
    assert rc == jrc == 0
    assert lines == buf.getvalue().splitlines()
    for name in ("poisson", "elliptic", "stokes", "heat"):
        with pytest.raises(SystemExit, match="mutually exclusive"):
            _t_cli([name, "-map", "bump:0.1", "-domain", "0,1,0,1"])


# stokes_oracle.py curvedcpu: the JAX drivers' lines
CURVED_CPU8 = {
    "elliptic -dim 10,10 -exact 0 -gamma 1 -map bump:0.08 -debug 1": [
        "Elliptic problem  dims = [10,10]    gamma = 1.000000    exponent = 2.000000",
        "  curvilinear domain: -map bump:0.08",
        "DOF distribution:      100 local       64 global       36 dirichlet",
        "Norm of exact residual   : abs = 1.708950e-01   rel = 4.439873e+00",
        "Number of nonlinear iterations = 5",
        "Reason for solver termination: CONVERGED_RTOL",
        "Norm of error            : abs = 1.264353e-03   rel = 4.596427e-03",
        "KSP iterations per Newton step: [9, 9, 9, 9, 9]"],
    "heat -dim 10,10 -dt 0.5 -theta 1 -nsteps 5 -map bump:0.08": [
        "Heat problem  dims = [10,10]  dt = 0.5  theta = 1.0  steps = 5",
        "  curvilinear domain: -map bump:0.08",
        "Norm of error vs analytic decay 1.035706e-04 (harmonic steady state)"],
    "stokes -exact 1 -dim 8,8 -map annulus:1:2": [
        "Stokes problem  dim = [8,8]",
        "  hardness = 1.000000    exponent = 1.000000    regularization = 1.000000"
        "    gamma0 = 1.000000",
        "  curvilinear domain: -map annulus:1:2",
        "DOF distribution: 108 global   36/64 pressure    72/128 velocity    56 dirichlet"
        "    0 mixed",
        "Norm of solution 2.738e+01  norm of forcing 1.279e+01  norm of residual 4.544e-02",
        "Number of nonlinear iterations = 1",
        "Reason for solver termination: CONVERGED_SNORM_RELATIVE",
        "Norm of error            : abs = 1.893557e-03"],
    "ustokes -dim 8,8 -dt 0.05 -nsteps 3 -map bump:0.05": [
        "Unsteady Stokes  dim = [8,8]  dt = 0.05  scheme = theta  theta = 0.5  omega = 1.0"
        "  steps = 3  map = bump:0.05",
        "DOF distribution: 108 global   36/64 pressure    72/128 velocity    56 dirichlet"
        "    0 mixed",
        "Outer iterations per step: min 11  max 11",
        "Norm of error            : abs = 7.999803e-03 (time-integration)"],
}


@pytest.mark.parametrize("argv", sorted(CURVED_CPU8))
def test_cli_map_matches_jax_lines(argv):
    """elliptic, heat, stokes and ustokes with -map print the JAX drivers'
    lines (the port's own lines after them: the continuation and per-step
    counts), with the metric multigrid PC by default."""
    rc, lines = _t_cli(argv.split())
    ref = CURVED_CPU8[argv]
    assert rc == 0
    assert lines[:len(ref)] == ref
    assert all(not ln.startswith(("Norm", "Number", "Reason")) for ln in lines[len(ref):])
