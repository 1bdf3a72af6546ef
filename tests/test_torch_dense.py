"""The port's dense tier (spectral_tpu_torch.ops.dense, the mass-shifted
saddle Jacobian, StokesProblem.make_dense_pc / make_dense_pc_var, K1's
vmap rule) against the JAX package on the same
numpy-seeded inputs, on the CPU, in float64.

The assembled matrices agree to 1e-13 of their largest entry, the
inverses built from the same matrix exactly (the same numpy code), the
applies on the JAX package's factors to 1e-13, and the port's own
factors' applies to 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectral_tpu.grid import Grid as JGrid
from spectral_tpu.models.stokes import StokesConfig as JConfig
from spectral_tpu.models.stokes import StokesProblem as JProblem
from spectral_tpu.ops import dense as jdense
from spectral_tpu_torch.grid import Grid
from spectral_tpu_torch.models.stokes import StokesConfig, StokesProblem
from spectral_tpu_torch.ops import cuda_cheb
from spectral_tpu_torch.ops import dense as tdense
from spectral_tpu_torch.ops.chebyshev import chebdiff
from spectral_tpu_torch.utils.interop import (dense_apply_from_numpy,
                                              linearization_from_numpy,
                                              stokes_state_from_numpy)

DIMS = (6, 6)
SHIFTED = dict(exact=2, mass_shift=7.0)
POWER_LAW = dict(exact=2, rheology=1, regularization=1e-2, exponent=3.0)


def _rel(got, ref) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.max(np.abs(got - np.asarray(ref))) / np.max(np.abs(ref)))


def _problems(**cfg):
    return (JProblem(JGrid(DIMS), JConfig(**cfg)),
            StokesProblem(Grid(DIMS, device="cpu"), StokesConfig(**cfg)))


def _state(p, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    vm, pm = p.vel_mask_np, p.p_mask_np
    return {"v": np.where(vm, scale * rng.standard_normal(vm.shape), 0.0),
            "p": np.where(pm, scale * rng.standard_normal(pm.shape), 0.0)}


def _t(state):
    return stokes_state_from_numpy(state, device="cpu", dtype=torch.float64)


def _frozen(p, lib):
    d = len(DIMS)
    return (lib.ones(DIMS), lib.zeros(DIMS), lib.zeros(DIMS + (d, d)))


@pytest.fixture(scope="module")
def shifted():
    """The mass-shifted linear saddle Jacobian of both packages, assembled
    in blocks of 32 (the last padded cyclically), and the JAX package's
    regularized inverse of its matrix."""
    jp, tp = _problems(**SHIFTED)
    jlin = _frozen(jp, jnp)
    tlin = tuple(torch.from_numpy(np.array(a)) for a in jlin)
    JA, _ = jdense.assemble_dense(lambda w: jp.jacobian_action(None, jlin, w),
                                  jp.zero_state(), block=32)
    TA, _ = tdense.assemble_dense(lambda w: tp.jacobian_action(None, tlin, w),
                                  tp.zero_state(), block=32)
    free, nulls = tp._dense_free_and_nulls()
    JAinv = jdense.regularized_inverse(JA, free=free, null_vecs=nulls)
    return jp, tp, jlin, tlin, JA, TA, free, nulls, JAinv


def test_assembled_shifted_saddle_matches_jax(shifted):
    jp, tp, _, tlin, JA, TA, *_ = shifted
    assert JA.shape == TA.shape == (108, 108)
    assert _rel(TA, JA) <= 1e-13
    # column j is the action on the j-th unit state: the shift sits on the
    # free velocity rows only
    e = torch.zeros(108, dtype=torch.float64)
    e[40] = 1.0
    _, unravel = tdense._ravel(tp.zero_state(), torch.float64)
    col = tdense._ravel(tp.jacobian_action(None, tlin, unravel(e)), torch.float64)[0]
    assert torch.equal(torch.as_tensor(TA[:, 40]), col)


def test_free_mask_and_null_vector_match_jax(shifted):
    """The port's free dofs and null vector equal the JAX package's
    ravel_pytree of its masks (make_dense_pc, stokes.py)."""
    from jax.flatten_util import ravel_pytree

    jp, tp, *_ = shifted
    free, nulls = tp._dense_free_and_nulls()
    jfree = np.asarray(ravel_pytree(
        {"v": jnp.where(jp.vel_mask, 1.0, 0.0) * jnp.ones(DIMS + (2,)),
         "p": jnp.where(jp.p_mask, 1.0, 0.0)})[0]) != 0.0
    jnull = np.asarray(ravel_pytree({"v": jnp.zeros(DIMS + (2,)),
                                     "p": jnp.where(jp.p_mask, 1.0, 0.0)})[0])
    np.testing.assert_array_equal(free, jfree)
    assert len(nulls) == 1
    np.testing.assert_array_equal(nulls[0], jnull)


def test_regularized_inverse_matches_jax(shifted):
    _, _, _, _, JA, _, free, nulls, JAinv = shifted
    np.testing.assert_array_equal(tdense.regularized_inverse(JA, free=free, null_vecs=nulls),
                                  JAinv)
    # and on the device path, working precision, the same numbers
    dev = tdense.regularized_inverse_device(torch.from_numpy(np.array(JA)), free=free,
                                            null_vecs=nulls)
    assert _rel(dev, JAinv) <= 1e-11
    # the fixed dofs decouple to identity rows and columns
    fixed = np.flatnonzero(~free)
    np.testing.assert_array_equal(JAinv[np.ix_(fixed, fixed)], np.eye(len(fixed)))


def test_dense_pc_applies_match_jax(shifted):
    jp, tp, jlin, tlin, JA, _, free, nulls, JAinv = shifted
    r = _state(tp, 3)
    _, junravel = jax.flatten_util.ravel_pytree(jp.zero_state())
    rj = {k: jnp.asarray(v) for k, v in r.items()}
    for transpose in (False, True):
        want = jdense.dense_apply(JAinv, junravel, transpose=transpose)(rj)
        got = dense_apply_from_numpy(JAinv, tp.zero_state(), device="cpu",
                                     dtype=torch.float64, transpose=transpose)(_t(r))
        for k in ("v", "p"):
            assert _rel(got[k], want[k]) <= 1e-13, (transpose, k)
    # the port's own make_dense_pc, host and device factors
    want = jdense.dense_apply(JAinv, junravel)(rj)
    want_t = jdense.dense_apply(JAinv, junravel, transpose=True)(rj)
    for factor in ("host", "device"):
        setup, fwd, adj = tp.make_dense_pc(lin_state=tlin, factor=factor, block=40)
        st = setup(None, tlin)
        for got, ref in ((fwd(st, _t(r)), want), (adj(st, _t(r)), want_t)):
            for k in ("v", "p"):
                assert _rel(got[k], ref[k]) <= 1e-10, (factor, k)
    with pytest.raises(ValueError, match="factor"):
        tp.make_dense_pc(lin_state=tlin, factor="gpu")


def test_dense_pc_var_matches_jax():
    """make_dense_pc_var at a seeded variable-eta (power-law)
    linearization."""
    jp, tp = _problems(**POWER_LAW)
    x = _state(tp, 8, 0.5)
    _, jlin = jax.jit(jp.make_residual(jp.params_at(1)))({k: jnp.asarray(v)
                                                         for k, v in x.items()})
    tlin = linearization_from_numpy(jlin, device="cpu", dtype=torch.float64)
    jsetup, japply, jadj = jp.make_dense_pc_var()
    tsetup, tapply, tadj = tp.make_dense_pc_var()
    jst, tst = jax.jit(lambda lin: jsetup(None, lin))(jlin), tsetup(None, tlin)
    assert _rel(tst, jst) <= 1e-10
    r = _state(tp, 9)
    rj = {k: jnp.asarray(v) for k, v in r.items()}
    for jf, tf in ((japply, tapply), (jadj, tadj)):
        want, got = jf(jst, rj), tf(tst, _t(r))
        for k in ("v", "p"):
            assert _rel(got[k], want[k]) <= 1e-10, k


def test_steady_solve_refuses_mass_shift():
    """The JAX package's ValueError: the steady residual has no mass term."""
    tp = StokesProblem(Grid(DIMS, device="cpu"), StokesConfig(**SHIFTED))
    for fn in (tp.solve, lambda: tp.solve_family([tp.params_at(1)])):
        with pytest.raises(ValueError, match="UNSTEADY"):
            fn()
    # and a shift takes fastdiag or mg only
    bad = StokesProblem(Grid(DIMS, device="cpu"), StokesConfig(pcvel="jacobi", **SHIFTED))
    with pytest.raises(ValueError, match="fastdiag\\|mg"):
        bad.make_pc()


@pytest.mark.parametrize("pcvel", ["fastdiag", "mg"])
def test_shifted_velocity_pc_matches_jax(pcvel):
    jp, tp = _problems(pcvel=pcvel, **SHIFTED)
    jlin = _frozen(jp, jnp)
    tlin = tuple(torch.from_numpy(np.array(a)) for a in jlin)
    r = _state(tp, 4)["v"]
    js, ja = jp.make_vel_pc()
    ts, ta = tp.make_vel_pc()
    want = jax.jit(lambda lin, r: ja(js(lin), r))(jlin, jnp.asarray(r))
    assert _rel(ta(ts(tlin), torch.as_tensor(r)), want) <= 1e-12


def test_k1_under_vmap():
    """chebdiff's route for a tensor batched by torch.func.vmap: K1's
    vmap rule folds the batch into the rows (the plain version on the
    CPU), over a batch axis at any position."""
    u = torch.randn(7, 5, 6, 9, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    for in_dims in (0, 1, 2):
        got = torch.func.vmap(lambda x: chebdiff(x, -1, method="kernel"), in_dims=in_dims)(u)
        want = cuda_cheb.chebdiff_last_ref(u.movedim(in_dims, 0))
        assert torch.allclose(got, want, rtol=0, atol=1e-13)
    # nested vmaps reach the op once per level
    got = torch.func.vmap(torch.func.vmap(cuda_cheb.chebdiff_last))(u)
    assert torch.allclose(got, cuda_cheb.chebdiff_last_ref(u), rtol=0, atol=1e-13)
