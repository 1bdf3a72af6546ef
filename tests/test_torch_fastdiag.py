"""The port's FD surrogate stencil and fast-diagonalization solver against
the JAX package's, with factors and coefficients carried across by
spectral_tpu_torch.utils.interop so both apply identical numbers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectral_tpu.grid import Grid as JGrid
from spectral_tpu.ops.fastdiag import FastDiagSolver as JFastDiag
from spectral_tpu.ops.stencil import poisson_fd_stencil as j_stencil
from spectral_tpu_torch.grid import Grid
from spectral_tpu_torch.ops.fastdiag import FastDiagSolver
from spectral_tpu_torch.ops.stencil import poisson_fd_stencil
from spectral_tpu_torch.utils.interop import (fastdiag_from_numpy, grid_from_spec,
                                              stencil_from_numpy)

F64 = torch.float64
DIMS = [(10, 9, 8), (12, 11)]


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


@pytest.mark.parametrize("dims", DIMS)
def test_stencil_matches_jax(dims):
    js = j_stencil(JGrid(dims))
    ts = poisson_fd_stencil(Grid(dims, device="cpu"))
    # the host assembly is the same float64 numpy code: bitwise
    np.testing.assert_array_equal(ts.center.numpy(), np.asarray(js.center))
    carried = stencil_from_numpy(np.asarray(js.center),
                                 [np.asarray(a) for a in js.lower],
                                 [np.asarray(a) for a in js.upper],
                                 device="cpu", dtype=F64)
    x = np.random.default_rng(0).standard_normal(dims)
    ref = np.asarray(js.apply(jnp.asarray(x)))
    # relative 1e-12: shifted products, summed in the same order
    assert _rel(carried.apply(torch.from_numpy(x)).numpy(), ref) <= 1e-12
    assert _rel(ts.apply(torch.from_numpy(x)).numpy(), ref) <= 1e-12
    np.testing.assert_array_equal(ts.as_dense_np(), js.as_dense_np())


@pytest.mark.parametrize("dims", DIMS)
@pytest.mark.parametrize("kw,runtime_shift", [
    ({}, None),
    ({"shift": 2.5}, None),
    ({}, 0.75),
    ({"neumann_axes": (0,)}, None),
])
def test_fastdiag_apply_matches_jax(dims, kw, runtime_shift):
    jfd = JFastDiag.build(JGrid(dims), **kw)
    g = grid_from_spec(dims, device="cpu", dtype=F64)
    tfd = fastdiag_from_numpy(g, [np.asarray(a) for a in jfd.V],
                              [np.asarray(a) for a in jfd.Vinv],
                              np.asarray(jfd.lam_sum), jfd.shift_const,
                              jfd.neumann_fold, dtype=F64)
    own = FastDiagSolver.build(g, **kw)
    r = np.random.default_rng(1).standard_normal(dims)
    ref = np.asarray(jfd.apply(jnp.asarray(r), shift=runtime_shift))
    # relative 1e-12: the same factors applied by per-axis float64 products
    assert _rel(tfd.apply(torch.from_numpy(r), shift=runtime_shift).numpy(), ref) <= 1e-12
    # the port's own host build gives the same factors
    assert _rel(own.apply(torch.from_numpy(r), shift=runtime_shift).numpy(), ref) <= 1e-12


@pytest.mark.parametrize("dims", DIMS)
def test_fastdiag_is_exact_inverse_of_surrogate(dims):
    """The invariant of the JAX package: fastdiag solves the FD surrogate
    exactly.  1e-10 relative: the eigenvector matrices' conditioning."""
    g = Grid(dims, device="cpu")
    S = poisson_fd_stencil(g)
    fd = FastDiagSolver.build(g)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(dims))
    assert _rel(fd.apply(S.apply(x)).numpy(), x.numpy()) <= 1e-10
    assert _rel(S.apply(fd.apply(x)).numpy(), x.numpy()) <= 1e-10


def test_fastdiag_float32_factors():
    g = Grid((10, 9, 8), device="cpu")
    fd = FastDiagSolver.build(g, dtype=torch.float32)
    assert all(v.dtype == torch.float32 for v in fd.V + fd.Vinv)
    r = np.random.default_rng(3).standard_normal(g.dims)
    ref = FastDiagSolver.build(g).apply(torch.from_numpy(r)).numpy()
    got = fd.apply(torch.from_numpy(r.astype(np.float32)))
    assert got.dtype == torch.float32
    # float32 products of O(1)-conditioned factors: 1e-5 relative
    assert _rel(got.numpy(), ref) <= 1e-5
