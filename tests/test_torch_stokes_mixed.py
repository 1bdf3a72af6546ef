"""The port's mixed and Neumann Stokes machinery against the JAX package
on the same numpy-seeded inputs, on the CPU, in float64: the line solves
(spectral_tpu_torch.ops.tridiag), the line-smoothed multigrid, the
velocity stencils with one-sided traction rows and the nodal Jacobian
stencil, the mixed velocity PC with and without the traction-block
correction, a mixed solve, and the float64 device residual.

Operators agree to round-off: 1e-12 relative to the largest entry unless
stated (the same float64 arithmetic in another summation order; the line
inverses come from LAPACK on both sides).  The JAX side of a comparison
is jitted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectral_tpu.grid import Grid as JGrid
from spectral_tpu.models.stokes import StokesConfig as JConfig
from spectral_tpu.models.stokes import StokesProblem as JProblem
from spectral_tpu.models.stokes_pc import nodal_jacfwd_stencil as j_nodal
from spectral_tpu.ops import tridiag as jtri
from spectral_tpu.ops.multigrid import Multigrid as JMultigrid
from spectral_tpu.ops.stencil import StencilOp as JStencilOp
from spectral_tpu.solvers.krylov import KSPConfig as JKSPConfig
from spectral_tpu.solvers.newton import NewtonConfig as JNewtonConfig
from spectral_tpu_torch.grid import Grid
from spectral_tpu_torch.models.stokes import StokesConfig, StokesProblem
from spectral_tpu_torch.models.stokes_pc import nodal_jacfwd_stencil, velocity_fd_stencil
from spectral_tpu_torch.ops import tridiag
from spectral_tpu_torch.ops.multigrid import Multigrid
from spectral_tpu_torch.ops.stencil import StencilOp
from spectral_tpu_torch.solvers.krylov import KSPConfig
from spectral_tpu_torch.solvers.newton import NewtonConfig
from spectral_tpu_torch.utils.interop import stokes_state_from_numpy

RTOL = 1e-12



def _close(got, ref, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    scale = max(float(np.max(np.abs(ref))), 1e-300)
    np.testing.assert_allclose(got / scale, ref / scale, atol=rtol, rtol=0)


def _close_stencil(tS, jS, rtol=RTOL):
    _close(tS.center, jS.center, rtol)
    for ax in range(len(tS.lower)):
        _close(tS.lower[ax], jS.lower[ax], rtol)
        _close(tS.upper[ax], jS.upper[ax], rtol)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float64))


# -- line solves -----------------------------------------------------------------

DIMS3 = (7, 6, 5)


def _line_inputs(seed=0):
    """A diagonally dominant (2d+1)-point stencil on DIMS3 (grid-shaped
    fields), x and b with a trailing component axis, and a
    component-dependent mask of shape DIMS3 + (3,)."""
    rng = np.random.default_rng(seed)
    d = len(DIMS3)
    lower = [-(0.2 + rng.random(DIMS3)) for _ in range(d)]
    upper = [-(0.2 + rng.random(DIMS3)) for _ in range(d)]
    center = 2.5 * d + rng.random(DIMS3)
    x = rng.standard_normal(DIMS3 + (3,))
    b = rng.standard_normal(DIMS3 + (3,))
    mask = rng.random(DIMS3 + (3,)) > 0.3
    return center, lower, upper, x, b, mask


@pytest.fixture(scope="module")
def jax_lines():
    """The JAX package's line solves on _line_inputs' seeded data, in one
    jitted program: LineSolver along every axis with and without the mask,
    and line_smooth with and without the mask and with and without those
    LineSolvers (build_line_solvers' own)."""
    center, lower, upper, x, b, mask = _line_inputs(1)
    lo_m = [np.where(mask, lo[..., None], 0.0) for lo in lower]
    up_m = [np.where(mask, up[..., None], 0.0) for up in upper]
    ce_m = np.where(mask, center[..., None], 1.0)

    def run(lower, center, upper, lo_m, ce_m, up_m, x, b, mask):
        S = JStencilOp(center, tuple(lower), tuple(upper))
        out = {}
        for masked, m in ((False, None), (True, mask)):
            built = tuple(jtri.LineSolver.build(lower[ax], center, upper[ax], ax, mask=m)
                          for ax in range(3))
            out[f"solver {masked}"] = [(js.Tinv, js.solve(b)) for js in built]
            for with_solvers in (False, True):
                out[f"smooth {masked} {with_solvers}"] = jtri.line_smooth(
                    S, x, b, (0, 1, 2), sweeps=2, mask=m, solvers=built if with_solvers else None)
        return out

    out = jax.jit(run)(*jax.tree_util.tree_map(
        jnp.asarray, (lower, center, upper, lo_m, ce_m, up_m, x, b, mask)))
    return (center, lower, upper, lo_m, ce_m, up_m, x, b, mask), out


def test_thomas_matches_jax(jax_lines):
    """Along every axis, with grid-shaped coefficients and with the
    masked-row coefficients of the mask's shape that line_smooth builds,
    against the JAX package's solve of the same tridiagonal systems
    (LineSolver's, without and with the mask: a masked row is an identity
    row either way)."""
    (center, lower, upper, lo_m, ce_m, up_m, _, b, _), ref = jax_lines
    for ax in range(3):
        _close(tridiag.thomas(_t(lower[ax]), _t(center), _t(upper[ax]), _t(b), ax),
               ref["solver False"][ax][1])
        _close(tridiag.thomas(_t(lo_m[ax]), _t(ce_m), _t(up_m[ax]), _t(b), ax),
               ref["solver True"][ax][1])


@pytest.mark.parametrize("masked", [False, True])
def test_line_solver_matches_jax(jax_lines, masked):
    """LineSolver with a component-dependent mask: the lines run along the
    grid axis for each component, never along the component axis."""
    (center, lower, upper, _, _, _, _, b, mask), ref = jax_lines
    tm = torch.from_numpy(mask) if masked else None
    for ax in range(3):
        ts = tridiag.LineSolver.build(_t(lower[ax]), _t(center), _t(upper[ax]), ax, mask=tm)
        Tinv, z = ref[f"solver {masked}"][ax]
        assert ts.axis == ax and tuple(ts.Tinv.shape) == Tinv.shape
        _close(ts.Tinv, Tinv)
        _close(ts.solve(_t(b)), z)
        if masked:   # masked rows are identities
            got = ts.solve(_t(b)).numpy()
            np.testing.assert_allclose(got[~mask], b[~mask], rtol=0, atol=1e-14)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("with_solvers", [False, True])
def test_line_smooth_matches_jax(jax_lines, masked, with_solvers):
    (center, lower, upper, _, _, _, x, b, mask), ref = jax_lines
    tS = StencilOp(_t(center), tuple(map(_t, lower)), tuple(map(_t, upper)))
    tm = torch.from_numpy(mask) if masked else None
    sv = tridiag.build_line_solvers(tS, (0, 1, 2), mask=tm) if with_solvers else None
    _close(tridiag.line_smooth(tS, _t(x), _t(b), (0, 1, 2), sweeps=2, mask=tm, solvers=sv),
           ref[f"smooth {masked} {with_solvers}"])


@pytest.mark.parametrize("dims", [(9, 8), (7, 6, 5)])
def test_line_multigrid_vcycle_matches_jax(dims):
    """One V-cycle with smoother="line", before and after shift_state."""
    rng = np.random.default_rng(4)
    eta = 1.0 + 0.5 * rng.random(dims)
    b = rng.standard_normal(dims + (2,))
    jmg = JMultigrid.build(JGrid(dims), smoother="line")
    tmg = Multigrid.build(Grid(dims, device="cpu"), smoother="line")
    assert [g.dims for g in tmg.grids] == [g.dims for g in jmg.grids]

    def jrun(eta, b):
        st = jmg.setup({"eta": eta})
        return jmg.vcycle(st, b), jmg.vcycle(jmg.shift_state(st, 2.5), b)

    ref, ref_s = jax.jit(jrun)(jnp.asarray(eta), jnp.asarray(b))
    st = tmg.setup({"eta": _t(eta)})
    assert len(st["line"]) == len(tmg.grids)
    _close(tmg.vcycle(st, _t(b)), ref)
    _close(tmg.vcycle(tmg.shift_state(st, 2.5), _t(b)), ref_s)


# -- stencils --------------------------------------------------------------------

def _problems(dims, **cfg):
    return (JProblem(JGrid(dims), JConfig(**cfg)),
            StokesProblem(Grid(dims, device="cpu"), StokesConfig(**cfg)))


MIXED_CFGS = {1: dict(exact=2, boundary=1, scaleM=2.0, scaleN=0.5),
              2: dict(exact=2, boundary=2, scaleM=0.5, scaleN=3.0),
              5: dict(exact=1, boundary=5, traction_p=True),
              6: dict(exact=1, boundary=6, traction_p=True)}


@pytest.mark.parametrize("dims", [(8, 7), (6, 5, 4)])
@pytest.mark.parametrize("boundary", sorted(MIXED_CFGS))
def test_mixed_fd_stencil_matches_jax(dims, boundary):
    """velocity_fd_stencil with the one-sided traction rows (scaleN,
    nm_mask, nm_onehot, normal, alpha, ref_normal), as the mixed velocity
    PC builds it, coefficient field by field."""
    jp, tp = _problems(dims, **MIXED_CFGS[boundary])
    assert tp.num_mixed > 0 and tp._nm_axes == jp._nm_axes
    eta = 1.0 + np.random.default_rng(5).random(dims)
    _close_stencil(tp._mixed_fd_stencil(_t(eta)),
                   jax.jit(jp._mixed_fd_stencil)(jnp.asarray(eta)), 1e-13)


@pytest.mark.parametrize("dims", [(8, 7), (6, 5, 4)])
def test_nodal_stencil_matches_fd_and_jax(dims):
    """-pcvel 3: torch.func.jacfwd of the nodal residual gives the FD
    stencil (tests/test_stokes_pc.py's check) and the JAX package's."""
    eta = 1.0 + np.random.default_rng(6).random(dims)
    tS = nodal_jacfwd_stencil(Grid(dims, device="cpu"), _t(eta))
    _close_stencil(tS, velocity_fd_stencil(Grid(dims, device="cpu"), _t(eta)), 1e-13)
    _close_stencil(tS, jax.jit(lambda e: j_nodal(JGrid(dims), e))(jnp.asarray(eta)), 1e-13)
    # the metric form's arguments: eta in every axis and a unit row scale
    # are the plain stencil
    _close_stencil(nodal_jacfwd_stencil(Grid(dims, device="cpu"), _t(eta),
                                        caxes=[_t(eta)] * len(dims),
                                        row_scale=_t(np.ones(dims))), tS, 1e-13)


# -- the mixed velocity PC --------------------------------------------------------

PC_BASE = dict(exact=2, rheology=1, exponent=3.0, regularization=1e-2)


def _state(jp, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    vm, pm = np.asarray(jp.vel_mask), np.asarray(jp.p_mask)
    return {"v": np.where(vm, scale * rng.standard_normal(vm.shape), 0.0),
            "p": np.where(pm, scale * rng.standard_normal(pm.shape), 0.0)}


@pytest.fixture(scope="module")
def jax_vel_pc():
    """(pcvel, boundary) -> (x, r, {tbc: the JAX package's velocity PC
    apply}), both tbc cases from one jitted program: make_vel_pc's
    composed apply with tbc 1, and its base apply, which is make_vel_pc's
    with tbc 0 (the base reads no tbc)."""
    cache = {}

    def get(pcvel, boundary):
        if (pcvel, boundary) not in cache:
            jp = JProblem(JGrid((8, 7)), JConfig(boundary=boundary, pcvel=pcvel, tbc=1,
                                                  **PC_BASE))
            x, r = _state(jp, 11, 0.3), _state(jp, 12)["v"]
            bs, ba = jp._make_vel_pc_base()
            js, ja = jp.make_vel_pc()

            def apply(x, r):
                _, ls = jp.make_residual(jp.params_at(1))(x)
                return {0: ba(bs(ls), r), 1: ja(js(ls), r)}

            cache[pcvel, boundary] = x, r, jax.jit(apply)(
                {k: jnp.asarray(v) for k, v in x.items()}, jnp.asarray(r))
        return cache[pcvel, boundary]

    return get


@pytest.mark.parametrize("tbc", [0, 1])
@pytest.mark.parametrize("boundary", [1, 2])
@pytest.mark.parametrize("pcvel", ["fastdiag", "mg"])
def test_mixed_velocity_pc_matches_jax(jax_vel_pc, pcvel, boundary, tbc):
    """One apply of make_vel_pc about a power-law linearization: the
    interior solve, the line-relaxed traction rows and (tbc 1) the
    traction-block correction."""
    x, r, refs = jax_vel_pc(pcvel, boundary)
    ref = refs[tbc]
    tp = StokesProblem(Grid((8, 7), device="cpu"),
                       StokesConfig(boundary=boundary, pcvel=pcvel, tbc=tbc, **PC_BASE))
    _, ls = tp.make_residual(tp.params_at(1))(stokes_state_from_numpy(
        x, device="cpu", dtype=torch.float64))
    ts, ta = tp.make_vel_pc()
    state = ts(ls)
    if tbc:
        assert state[1][0].shape == (tp._tbc_idx.numel(),) * 2
    _close(ta(state, _t(r)), ref, 1e-11)


def test_mixed_solve_matches_jax():
    """boundary 5 (manufactured sliding bed) at 8x8: Newton and Krylov
    counts equal, the error within 2x (tests/test_stokes.py:409's solver
    settings, but FGMRES restarted at 50, the JAX default, which this
    42-iteration solve never reaches and which compiles faster)."""
    cfg = dict(exact=1, boundary=5, traction_p=True)
    jp = JProblem(JGrid((8, 8)), JConfig(
        outer_ksp=JKSPConfig(type="fgmres", rtol=1e-12, max_it=800, restart=50),
        newton=JNewtonConfig(rtol=1e-10, max_it=20), **cfg))
    tp = StokesProblem(Grid((8, 8), device="cpu"), StokesConfig(
        outer_ksp=KSPConfig(type="fgmres", rtol=1e-12, max_it=800, restart=50),
        newton=NewtonConfig(rtol=1e-10, max_it=20), **cfg))
    jr, tr = jp.solve(), tp.solve()
    assert (tr.iters, tr.reason) == (int(jr.iters), int(jr.reason))
    assert [int(k) for k in tr.ksp_iters] == [int(k) for k in jr.ksp_iters]
    ref = float(jp.error_vs_exact(jr.x))
    assert ref / 2 <= tp.error_vs_exact(tr.x) <= 2 * ref


@pytest.mark.parametrize("cfg", [dict(exact=1, boundary=1, traction_p=True),
                                 dict(exact=1, boundary=5, traction_p=True),
                                 dict(exact=2, rheology=1, exponent=3.0, regularization=1e-2)],
                         ids=["boundary1", "boundary5", "powerlaw"])
def test_residual_dev64_matches_jax(cfg):
    """make_residual_dev64 on the port's CPU device against the JAX
    package's float64 host residual (tests/test_refined_fused.py:38-63)."""
    jp, tp = _problems((8, 7), **cfg)
    x = _state(jp, 14, 0.3)
    ref = jp.make_residual_np(jp.params_at(jp.config.cont))(x)
    got = tp.make_residual_dev64(tp.params_at(tp.config.cont))(
        stokes_state_from_numpy(x, device="cpu", dtype=torch.float64))
    assert got["v"].dtype == torch.float64 and got["v"].device.type == "cpu"
    for k in ("v", "p"):
        _close(got[k], ref[k])
    with pytest.raises(TypeError, match="float64"):
        tp.make_residual_dev64(tp.params_at(1))(
            stokes_state_from_numpy(x, device="cpu", dtype=torch.float32))
