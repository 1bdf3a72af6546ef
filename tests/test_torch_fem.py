"""The port's Q1 finite-element module (spectral_tpu_torch.ops.fem), the
colored probes of models/stokes_pc.py, cheb_regrid and
extreme_singular_values against the JAX package on the same numpy-seeded
inputs, on the CPU, in float64.

Every comparison holds the port to the JAX package to the tolerance stated
(relative to the largest entry of the JAX result).  Each JAX function is
compiled once, as one program, except the probes (see below).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectral_tpu.grid import Grid as JGrid
from spectral_tpu.models import stokes_pc as j_stokes_pc
from spectral_tpu.ops import chebyshev as jcheb
from spectral_tpu.ops import fem as jfem
from spectral_tpu.solvers.krylov import extreme_singular_values as j_extreme
from spectral_tpu_torch.grid import Grid
from spectral_tpu_torch.models import stokes_pc
from spectral_tpu_torch.ops import chebyshev as tcheb
from spectral_tpu_torch.ops import fem
from spectral_tpu_torch.solvers.krylov import extreme_singular_values
from spectral_tpu_torch.utils.interop import (coupled_stencil_to_numpy,
                                               linearization_from_numpy)


def _close(got, ref, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    scale = max(float(np.max(np.abs(ref))), 1e-300)
    np.testing.assert_allclose(got / scale, ref / scale, atol=rtol, rtol=0)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _random_linearization(dims, seed=0):
    """(eta, deta, S, velocity mask) as tests/test_fem.py draws them: eta in
    [1, 2), deta O(0.3), a symmetric strain, the boundary faces masked."""
    d = len(dims)
    rng = np.random.default_rng(seed)
    eta = 1.0 + rng.random(dims)
    deta = 0.3 * rng.standard_normal(dims)
    Sr = rng.standard_normal(dims + (d, d))
    S = 0.5 * (Sr + np.swapaxes(Sr, -1, -2))
    vm = np.ones(dims + (d,), bool)
    for ax in range(d):
        sl = [slice(None)] * d
        sl[ax] = 0
        vm[tuple(sl)] = False
        sl[ax] = -1
        vm[tuple(sl)] = False
    return eta, deta, S, vm


@pytest.mark.parametrize("dims", [(9, 8), (6, 7, 5)])
def test_q1_fastdiag_apply_matches_jax(dims):
    """The lumped-mass-scaled exact Q1 solve on a scalar field and on a
    field with a component axis; the boundary passes through."""
    jfd, tfd = jfem.Q1FastDiag.build(JGrid(dims)), fem.Q1FastDiag.build(Grid(dims, device="cpu"))
    rng = np.random.default_rng(len(dims))
    for shape in (dims, dims + (2,)):
        r = rng.standard_normal(shape)
        ref = np.asarray(jax.jit(jfd.apply)(jnp.asarray(r)))
        got = tfd.apply(_t(r))
        _close(got, ref, 1e-12)
        bm = Grid(dims, device="cpu").boundary_mask_np
        np.testing.assert_array_equal(got.numpy()[bm], r[bm])
    assert tfd.lam_sum.dtype == torch.float64
    assert fem.Q1FastDiag.build(Grid(dims, device="cpu"), dtype=torch.float32).V[0].dtype \
        == torch.float32


@pytest.mark.parametrize("dims", [(6, 5), (4, 5, 4)])
def test_assemble_q1_strain_matches_jax_and_oracle(dims):
    """StokesPCSetUp1: the port's 3^d coupled stencil equals the JAX
    package's and the dense element-by-element oracle, with -zeroN/-zeroV
    too (the port's oracle equals the JAX package's in 2-D); apply() and
    diag() agree with the dense matrix."""
    d = len(dims)
    eta, deta, S, vm = _random_linearization(dims)
    tg = Grid(dims, device="cpu")
    lin = linearization_from_numpy((eta, deta, S), device="cpu", dtype=torch.float64)
    for zeroN, zeroV in ((0, 1.0), (5, 2.5)):
        ts = fem.assemble_q1_strain(tg, *lin, torch.as_tensor(vm), zeroN=zeroN, zeroV=zeroV)
        if not zeroN:   # compiled once; the JAX filter numbers free dofs on the host
            js = jax.jit(lambda e, de, s: jfem.assemble_q1_strain(
                JGrid(dims), e, de, s, jnp.asarray(vm)))(eta, deta, S)
            offs, coef = coupled_stencil_to_numpy(ts)
            joffs, jcoef = coupled_stencil_to_numpy(js)
            assert offs == joffs
            for a, b in zip(coef, jcoef):
                _close(a, b, 1e-12)
        dense = ts.as_dense_np()
        _close(dense, fem.q1_strain_dense_np(tg, eta, deta, S, vm, zeroN=zeroN, zeroV=zeroV),
               1e-12)
        x = np.random.default_rng(3).standard_normal(dims + (d,)) * vm
        _close(ts.apply(_t(x)), (dense @ x.reshape(-1)).reshape(x.shape), 1e-12)
        _close(ts.diag(), np.diagonal(dense).reshape(dims + (d,)), 1e-12)
    if d == 2:   # the port's oracle against the JAX package's
        _close(fem.q1_strain_dense_np(tg, eta, deta, S, vm, zeroN=5, zeroV=2.5),
               jfem.q1_strain_dense_np(JGrid(dims), eta, deta, S, vm, zeroN=5, zeroV=2.5),
               1e-12)
    # isoparametric elements on the grid's own (box) nodes are the
    # tensor-product elements
    ts0 = fem.assemble_q1_strain(tg, *lin, torch.as_tensor(vm))
    iso = fem.assemble_q1_strain(tg, *lin, torch.as_tensor(vm), coords=tg.coords_np)
    for a, b in zip(coupled_stencil_to_numpy(iso)[1], coupled_stencil_to_numpy(ts0)[1]):
        _close(a, b, 1e-12)


@pytest.mark.parametrize("dims", [(9, 7), (8, 7)])
def test_colored_probes_match_jax(dims):
    """Both colored probes of one dense random operator: the (2d+1)-point
    stencil of a scalar field (3^d colors) and the upstream d (4d+1)-entry
    coupled pattern of a velocity field (stride-5 lattice), with masked
    rows and columns dropped."""
    d = len(dims)
    size = int(np.prod(dims))
    rng = np.random.default_rng(7)
    A1 = rng.standard_normal((size, size))
    A2 = rng.standard_normal((size * d, size * d))
    vm = _random_linearization(dims)[3]
    jg, tg = JGrid(dims), Grid(dims, device="cpu")

    def j_mv(A, shape):
        return lambda x: (jnp.asarray(A) @ x.reshape(-1)).reshape(shape)

    def t_mv(A, shape):
        return lambda x: (_t(A) @ x.reshape(-1)).reshape(shape)

    vshape = dims + (d,)
    # op by op: the probes repeat one set of operations a color, so this
    # compiles less than one program of every probe
    js = j_stokes_pc.colored_probe_stencil(j_mv(A1, dims), jg)
    jf = j_stokes_pc.colored_probe_stencil_full(j_mv(A2, vshape), jg, jnp.asarray(vm))
    ts = stokes_pc.colored_probe_stencil(t_mv(A1, dims), tg)
    for a, b in zip((ts.center, *ts.lower, *ts.upper), (js.center, *js.lower, *js.upper)):
        _close(a, b, 1e-12)
    tf = stokes_pc.colored_probe_stencil_full(t_mv(A2, vshape), tg, torch.as_tensor(vm))
    offs, coef = coupled_stencil_to_numpy(tf)
    assert offs == coupled_stencil_to_numpy(jf)[0] and len(offs) == 4 * d + 1
    for a, b in zip(coef, coupled_stencil_to_numpy(jf)[1]):
        _close(a, b, 1e-12)


def test_cheb_regrid_matches_jax():
    """Refine and coarsen a field with a trailing component axis; the
    modal transforms round-trip."""
    u = np.random.default_rng(2).standard_normal((7, 9, 3))
    cases = ((11, 13), (5, 6), (7, 12))
    refs = jax.jit(lambda x: [jcheb.cheb_regrid(x, new) for new in cases]
                   + [jcheb.cheb_coefficients(x, 1)])(jnp.asarray(u))
    for new, ref in zip(cases, refs):
        _close(tcheb.cheb_regrid(_t(u), new), ref, 1e-13)
    a = tcheb.cheb_coefficients(_t(u), 1)
    _close(a, refs[-1], 1e-13)
    _close(tcheb.cheb_nodal(a, 1), u, 1e-13)


def test_extreme_singular_values_matches_jax():
    """On a tensor state with a PC, and on a {"v", "p"} state with a
    null-space projection."""
    rng = np.random.default_rng(11)
    A = np.eye(40) + 0.3 * rng.standard_normal((40, 40)) / np.sqrt(40)
    dM = 1.0 + rng.random(40)
    b = rng.standard_normal(40)
    ref = j_extreme(lambda x: jnp.asarray(A) @ x, jnp.asarray(b), m=12,
                    M=lambda r: r / jnp.asarray(dM))
    got = extreme_singular_values(lambda x: _t(A) @ x, _t(b), m=12, M=lambda r: r / _t(dM))
    np.testing.assert_allclose(got, ref, rtol=1e-10)

    B = np.eye(30) + 0.2 * rng.standard_normal((30, 30))
    st = {"v": rng.standard_normal((5, 4)), "p": rng.standard_normal((2, 5))}

    def proj(x):
        return {"v": x["v"], "p": x["p"] - x["p"].mean()}

    def op(x, mod, cat):   # keeps p mean-free, so the projected operator is regular
        y = mod.asarray(B) @ cat([x["p"].reshape(-1), x["v"].reshape(-1)])
        return proj({"p": y[:10].reshape(2, 5), "v": y[10:].reshape(5, 4)})

    ref = j_extreme(lambda x: op(x, jnp, jnp.concatenate),
                    {k: jnp.asarray(v) for k, v in st.items()}, m=12, null_project=proj)
    got = extreme_singular_values(lambda x: op(x, torch, torch.cat),
                                  {k: _t(v) for k, v in st.items()}, m=12, null_project=proj)
    np.testing.assert_allclose(got, ref, rtol=1e-10)
