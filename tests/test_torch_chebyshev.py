"""The port's Chebyshev transforms (spectral_tpu_torch.ops.chebyshev)
against the JAX package's, on the same float64 inputs made with numpy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectral_tpu.ops import chebyshev as jcheb
from spectral_tpu_torch.ops import chebyshev as tcheb

_U = np.random.default_rng(0).standard_normal((9, 12, 7))


def _close(got, ref, rel):
    """Max abs difference relative to max |ref| (an elementwise relative
    test is meaningless at the zeros of a derivative)."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.max(np.abs(got - ref)) / np.max(np.abs(ref))
    assert err <= rel, err


def test_host_builders_identical_to_jax():
    for n in (3, 8, 17):
        np.testing.assert_array_equal(tcheb.cgl_nodes_np(n), jcheb.cgl_nodes_np(n))
        np.testing.assert_array_equal(tcheb.cc_weights_np(n), jcheb.cc_weights_np(n))
        np.testing.assert_array_equal(tcheb.diffmat_np(n), jcheb.diffmat_np(n))


@pytest.mark.parametrize("method", ["matmul", "fft"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_chebdiff_matches_jax(method, axis):
    ref = jcheb.chebdiff(jnp.asarray(_U), axis, method)
    got = tcheb.chebdiff(torch.from_numpy(_U), axis, method)
    assert got.dtype == torch.float64
    # relative 1e-12: the same float64 algorithm; only the summation order
    # of the library products differs (entries of D reach ~n^2/3)
    _close(got.numpy(), ref, 1e-12)
    _close(got.numpy(), jcheb.chebdiff_np(_U, axis), 1e-12)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_auto_and_kernel_methods_on_cpu(axis):
    """On CPU tensors "auto" takes the matmul path and "kernel" the plain
    version of K1 (last axis) or the matmul path (other axes)."""
    u = torch.from_numpy(_U)
    ref = tcheb.chebdiff(u, axis, "matmul")
    # bitwise for auto (the same call); 1e-13 relative for the K1 plain
    # version, which multiplies by D^T instead of contracting D
    np.testing.assert_array_equal(tcheb.chebdiff(u, axis, "auto").numpy(), ref.numpy())
    _close(tcheb.chebdiff(u, axis, "kernel").numpy(), ref.numpy(), 1e-13)


def test_dct_dst_match_jax():
    u = _U[0]
    # relative 1e-13: both are one float64 FFT of the same extension
    _close(tcheb.dct1(torch.from_numpy(u), 1).numpy(), jcheb.dct1(jnp.asarray(u), 1), 1e-13)
    _close(tcheb.dst1(torch.from_numpy(u), 0).numpy(), jcheb.dst1(jnp.asarray(u), 0), 1e-13)


def test_chebdiff_float32_keeps_dtype():
    u = torch.from_numpy(_U.astype(np.float32))
    for method in ("matmul", "fft", "kernel"):
        y = tcheb.chebdiff(u, 2, method)
        assert y.dtype == torch.float32
        # float32 round-off of a derivative (|D| ~ n^2/3): 1e-5 relative
        _close(y.numpy(), jcheb.chebdiff_np(_U, 2), 1e-5)

