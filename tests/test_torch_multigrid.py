"""The port's geometric multigrid (spectral_tpu_torch.ops.multigrid) and its
helpers (ops.tensorops, the elliptic Jacobian stencil) against the JAX
package on the same numpy-seeded inputs, in float64 on the CPU.

Operators, transfers and V-cycles agree to round-off: both packages run the
same float64 arithmetic in another summation order, so the tolerances are
1e-12 relative to the largest entry unless stated."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectral_tpu.grid import Grid as JGrid
from spectral_tpu.ops.multigrid import Multigrid as JMultigrid
from spectral_tpu.ops.multigrid import theta_transfer_np as j_theta_transfer_np
from spectral_tpu.ops.stencil import StencilOp as JStencilOp
from spectral_tpu.ops.stencil import elliptic_jacobian_stencil as j_ejs
from spectral_tpu.ops.tensorops import apply_axis_matmul as j_apply_axis_matmul
from spectral_tpu.ops.tensorops import stencil_to_dense as j_stencil_to_dense
from spectral_tpu_torch.grid import Grid
from spectral_tpu_torch.ops.multigrid import Multigrid, theta_transfer_np
from spectral_tpu_torch.ops.stencil import elliptic_jacobian_stencil
from spectral_tpu_torch.ops.tensorops import apply_axis_matmul, stencil_to_dense
from spectral_tpu_torch.utils.interop import multigrid_from_numpy

DIMS = (10, 9, 8)
RTOL = 1e-12


def _close(got, ref, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    scale = max(float(np.max(np.abs(ref))), 1e-300)
    np.testing.assert_allclose(got / scale, ref / scale, atol=rtol, rtol=0)


def _fields(dims, seed):
    """eta > 0, deta and one gradient field per axis, numpy float64."""
    rng = np.random.default_rng(seed)
    eta = 1.0 + 0.5 * rng.random(dims)
    deta = 0.3 * rng.standard_normal(dims)
    gradu = [rng.standard_normal(dims) for _ in dims]
    return eta, deta, gradu


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float64))


@pytest.fixture(scope="module")
def pair():
    """The JAX hierarchy on DIMS and the port's built from its transfer
    matrices, each set up on the same coefficient fields (JAX jitted: one
    compile in place of one per eager op)."""
    eta, deta, gradu = _fields(DIMS, 5)
    jmg = JMultigrid.build(JGrid(DIMS))
    jstate = jax.jit(jmg.setup)({"eta": jnp.asarray(eta), "deta": jnp.asarray(deta),
                                 "gradu": [jnp.asarray(g) for g in gradu]})
    tmg = multigrid_from_numpy(Grid(DIMS, device="cpu"),
                               [[np.asarray(P) for P in lvl] for lvl in jmg.prolong],
                               [[np.asarray(R) for R in lvl] for lvl in jmg.restrict_coeff])
    tstate = tmg.setup({"eta": _t(eta), "deta": _t(deta), "gradu": [_t(g) for g in gradu]})
    return jmg, jstate, tmg, tstate


def _jvcycle(jmg, jstate, b):
    return jax.jit(jmg.vcycle)(jstate, jnp.asarray(b))


@pytest.mark.parametrize("nf,nc", [(33, 17), (10, 5), (8, 4), (5, 3)])
def test_theta_transfers_match(nf, nc):
    for got, ref in zip(theta_transfer_np(nf, nc), j_theta_transfer_np(nf, nc)):
        np.testing.assert_array_equal(got, ref)   # the same numpy code


def test_hierarchy_and_transfers_match_build():
    """The port's own build makes the JAX levels and transfer matrices."""
    jmg = JMultigrid.build(JGrid((32, 32, 32)))
    tmg = Multigrid.build(Grid((32, 32, 32), device="cpu"))
    assert [g.dims for g in tmg.grids] == [g.dims for g in jmg.grids] == [
        (32, 32, 32), (16, 16, 16), (8, 8, 8), (4, 4, 4)]
    for tl, jl in zip(tmg.prolong + tmg.restrict_coeff, jmg.prolong + jmg.restrict_coeff):
        for t, j in zip(tl, jl):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_apply_axis_matmul_and_dense_stencil_match():
    rng = np.random.default_rng(1)
    x = rng.standard_normal(DIMS)
    for ax, n in enumerate(DIMS):
        M = rng.standard_normal((n + 2, n))
        _close(apply_axis_matmul(_t(M), _t(x), ax),
               jax.jit(j_apply_axis_matmul, static_argnums=2)(jnp.asarray(M),
                                                              jnp.asarray(x), ax))
    eta, deta, gradu = _fields((6, 5, 4), 2)
    jg = JGrid((6, 5, 4))
    jA = jax.jit(lambda e, d, g: j_stencil_to_dense(j_ejs(jg, e, d, g), jg.dims))(
        jnp.asarray(eta), jnp.asarray(deta), [jnp.asarray(g) for g in gradu])
    tS = elliptic_jacobian_stencil(Grid((6, 5, 4), device="cpu"), _t(eta), _t(deta),
                                   [_t(g) for g in gradu])
    A = stencil_to_dense(tS, (6, 5, 4))
    _close(A, jA)
    # the scatter accumulates: off-grid neighbours land on the diagonal
    # with zero coefficients and must not overwrite it
    np.testing.assert_array_equal(np.diag(A.numpy()), tS.center.reshape(-1).numpy())
    np.testing.assert_allclose(A.numpy(), tS.as_dense_np(), atol=0, rtol=0)


def test_elliptic_stencil_matches():
    eta, deta, gradu = _fields(DIMS, 3)
    x = np.random.default_rng(4).standard_normal(DIMS)
    jg = JGrid(DIMS)

    def j_build_apply(e, d, g, x):
        S = j_ejs(jg, e, d, g)
        return S, S.apply(x)

    jS, jy = jax.jit(j_build_apply)(jnp.asarray(eta), jnp.asarray(deta),
                                    [jnp.asarray(g) for g in gradu], jnp.asarray(x))
    tS = elliptic_jacobian_stencil(Grid(DIMS, device="cpu"), _t(eta), _t(deta),
                                   [_t(g) for g in gradu])
    _close(tS.center, jS.center)
    for ax in range(3):
        _close(tS.lower[ax], jS.lower[ax])
        _close(tS.upper[ax], jS.upper[ax])
    _close(tS.apply(_t(x)), jy)


def test_per_level_stencils_and_lambda_max_match(pair):
    _, jstate, tmg, tstate = pair
    assert len(tstate["levels"]) == len(jstate["levels"]) == len(tmg.grids)
    for (tS, tdiag, tlam), (jS, jdiag, jlam, _) in zip(tstate["levels"], jstate["levels"]):
        _close(tS.center, jS.center)
        for ax in range(3):
            _close(tS.lower[ax], jS.lower[ax])
            _close(tS.upper[ax], jS.upper[ax])
        _close(tdiag, jdiag)
        if jlam is None:
            assert tlam is None
        else:
            # 12 power steps from the same float64 start: round-off only
            assert tlam.ndim == 0
            assert abs(float(tlam) - float(jlam)) <= 1e-12 * abs(float(jlam))


@pytest.mark.parametrize("cycles", [1, 3])
def test_vcycle_matches(pair, cycles):
    """One V-cycle, and mg3's three residual-corrected cycles, on a small
    3-D grid to round-off."""
    jmg, jstate, tmg, tstate = pair
    jmg = dataclasses.replace(jmg, cycles=cycles)
    tmg = dataclasses.replace(tmg, cycles=cycles)
    b = np.random.default_rng(7).standard_normal(DIMS)
    _close(tmg.vcycle(tstate, _t(b)), _jvcycle(jmg, jstate, b))


def test_shift_state_matches(pair):
    jmg, jstate, tmg, tstate = pair
    js = jax.jit(jmg.shift_state)(jstate, 2.5)
    ts = tmg.shift_state(tstate, 2.5)
    for (tS, _, tlam), (jS, _, jlam, _) in zip(ts["levels"], js["levels"]):
        _close(tS.center, jS.center)
        if jlam is not None:
            assert abs(float(tlam) - float(jlam)) <= 1e-12 * abs(float(jlam))
    b = np.random.default_rng(9).standard_normal(DIMS)
    _close(tmg.vcycle(ts, _t(b)), _jvcycle(jmg, js, b))
    # a 0-d tensor shift gives the same state as a number
    t0 = tmg.shift_state(tstate, torch.tensor(2.5, dtype=torch.float64))
    _close(tmg.vcycle(t0, _t(b)), tmg.vcycle(ts, _t(b)), rtol=0)


def test_float32_rhs_against_float64_factors(pair):
    """lu_solve is dtype-strict: a float32 right-hand side meeting float64
    factors is solved in the factors' dtype (both packages promote the
    cycle to float64 and agree); and a float32 hierarchy set up from
    float32 fields runs float32 throughout, within float32 round-off of
    the float64 cycle."""
    jmg, jstate, tmg, tstate = pair
    b = np.random.default_rng(11).standard_normal(DIMS)
    b32 = torch.from_numpy(b.astype(np.float32))
    got = tmg.vcycle(tstate, b32)
    ref = _jvcycle(jmg, jstate, b.astype(np.float32))
    assert got.dtype == torch.float64 and np.asarray(ref).dtype == np.float64
    _close(got, ref)
    eta, deta, gradu = _fields(DIMS, 5)
    s32 = tmg.setup({"eta": _t(eta).float(), "deta": _t(deta).float(),
                     "gradu": [_t(g).float() for g in gradu]})
    assert s32["coarse_lu"][0].dtype == torch.float32
    got32 = tmg.vcycle(s32, b32)
    assert got32.dtype == torch.float32
    # a few float32 V-cycle stages: 1e-5 relative to the largest entry
    _close(got32.double(), ref, rtol=1e-5)


def test_line_smoother_raises():
    """The line smoother is ported (held to the JAX package in
    tests/test_torch_stokes_mixed.py); an unknown smoother raises."""
    assert Multigrid.build(Grid((8, 8), device="cpu"), smoother="line").smoother == "line"
    with pytest.raises(ValueError, match="unknown smoother"):
        Multigrid.build(Grid((8, 8), device="cpu"), smoother="lines")


def test_stencil_of_jax_matches_port_apply():
    """Sanity of the interop: the JAX StencilOp built from the port's
    coefficient fields applies like the port's."""
    eta, deta, gradu = _fields((7, 6), 12)
    tS = elliptic_jacobian_stencil(Grid((7, 6), device="cpu"), _t(eta), _t(deta),
                                   [_t(g) for g in gradu])
    jS = JStencilOp(jnp.asarray(tS.center.numpy()),
                    tuple(jnp.asarray(a.numpy()) for a in tS.lower),
                    tuple(jnp.asarray(a.numpy()) for a in tS.upper))
    x = np.random.default_rng(13).standard_normal((7, 6))
    _close(tS.apply(_t(x)), jS.apply(jnp.asarray(x)))


def test_mapped_grid_levels_and_vcycle_match_jax():
    """On a mapped grid every coarse level carries the AxisMap.restrict of
    the fine map: the JAX hierarchy's levels, bit for bit (the V-cycles on
    them are held to the JAX package through the mapped Poisson solve's
    counts, test_torch_poisson.py)."""
    from spectral_tpu.ops.mapping import AxisMap as JAxisMap
    from spectral_tpu_torch.ops.mapping import AxisMap

    def maps(pkg, dims):
        return (pkg.tanh_cluster(0.0, 2.0, dims[0], 1.3), pkg.kte(-1.0, 1.0, dims[1], 0.9))

    dims = (33, 25)
    jmg = JMultigrid.build(JGrid(dims, maps=maps(JAxisMap, dims)))
    tmg = Multigrid.build(Grid(dims, maps=maps(AxisMap, dims), device="cpu"))
    assert len(tmg.grids) == len(jmg.grids) == 3
    for tg, jg in zip(tmg.grids, jmg.grids):
        assert tg.dims == jg.dims
        for tm, jm in zip(tg.maps, jg.maps):
            assert tm.x == jm.x and tm.w == jm.w
