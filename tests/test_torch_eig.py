"""The port's Krylov-Schur eigensolver (spectral_tpu_torch.solvers.eig)
against the JAX package's and numpy's dense eigenvalues, on the CPU, in
float64.  The same seeded matrices and starting vectors go to both
packages; the JAX package's ``eigs`` runs on its host basis (its device
basis compiles an Arnoldi step a call, and agrees with its host basis to
round-off: tests/test_eig.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectral_tpu.solvers import eig as jeig
from spectral_tpu_torch.solvers import eig as teig
from spectral_tpu_torch.utils.interop import eps_result_to_numpy

TOL = 1e-10   # eigenvalues, relative to the spectral scale


def _matrix(seed: int, n: int = 60):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)) * 0.3 + np.diag(np.linspace(-5.0, 5.0, n))
    return A, rng.standard_normal(n)


def _close(got, want, scale) -> float:
    """Largest distance from an eigenvalue in ``got`` to its nearest in
    ``want`` (conjugate-insensitive), relative to ``scale``."""
    want = np.concatenate([want, np.conj(want)])
    return max(min(abs(g - w) for w in want) for g in got) / scale


@pytest.mark.parametrize("which", ["LR", "SR", "LM", "SM"])
@pytest.mark.parametrize("device_basis", [None, False])
def test_eigs_matches_jax_and_numpy(which, device_basis):
    A, v0 = _matrix(0)
    w = np.linalg.eigvals(A)
    key = teig._sort_key(which)
    want = w[np.argsort(-key(w), kind="stable")][:5]
    At = torch.as_tensor(A)
    res = teig.eigs(lambda v: At @ v, torch.as_tensor(v0), k=4, which=which, m=24, tol=1e-11,
                    device_basis=device_basis)
    Aj = jnp.asarray(A)
    ref = jeig.eigs(lambda v: Aj @ v, jnp.asarray(v0), k=4, which=which, m=24, tol=1e-11,
                    device_basis=False)
    scale = np.abs(w).max()
    assert res.converged and ref.converged
    assert (res.matvecs, res.restarts) == (ref.matvecs, ref.restarts)
    assert _close(res.eigenvalues, want, scale) < TOL
    assert np.abs(res.eigenvalues - ref.eigenvalues).max() / scale < TOL
    assert np.abs(res.eigenvalues_polished - ref.eigenvalues_polished).max() / scale < TOL
    for lam, x in zip(res.eigenvalues, res.eigenvectors):
        assert np.linalg.norm(A @ x - lam * x) / scale < 1e-9


def test_shift_invert_and_complex_pairs():
    """Shift-invert about sigma (a dense solve as the operator) and a real
    matrix with conjugate pairs, each against the JAX package and numpy."""
    rng = np.random.default_rng(1)
    n, sigma = 50, 0.3
    A = np.diag(np.linspace(-4.0, 4.0, n)) + 0.2 * rng.standard_normal((n, n))
    for i in range(0, 8, 2):   # rotation blocks: complex pairs near the top
        A[i, i + 1], A[i + 1, i] = 1.5, -1.5
    v0 = rng.standard_normal(n)
    w = np.linalg.eigvals(A)
    Binv = np.linalg.inv(A - sigma * np.eye(n))
    Bt, Bj = torch.as_tensor(Binv), jnp.asarray(Binv)
    op_t, back = teig.shift_invert(lambda v: Bt @ v, sigma)
    res = teig.eigs(op_t, torch.as_tensor(v0), k=4, which="LM", m=20, tol=1e-11,
                    transform=back)
    op_j, back_j = jeig.shift_invert(lambda v: Bj @ v, sigma)
    ref = jeig.eigs(op_j, jnp.asarray(v0), k=4, which="LM", m=20, tol=1e-11, transform=back_j,
                    device_basis=False)
    scale = np.abs(w).max()
    want = w[np.argsort(np.abs(w - sigma), kind="stable")][:6]
    assert res.converged
    assert _close(res.eigenvalues, want, scale) < TOL
    assert _close(res.eigenvalues, ref.eigenvalues, scale) < TOL
    At, Aj = torch.as_tensor(A), jnp.asarray(A)
    res = teig.eigs(lambda v: At @ v, torch.as_tensor(v0), k=4, which="LR", m=20, tol=1e-11)
    ref = jeig.eigs(lambda v: Aj @ v, jnp.asarray(v0), k=4, which="LR", m=20, tol=1e-11,
                    device_basis=False)
    assert res.converged and np.abs(res.eigenvalues.imag).max() > 0.1
    assert _close(res.eigenvalues, ref.eigenvalues, scale) < TOL
    assert _close(res.eigenvalues, w[np.argsort(-w.real)][:6], scale) < TOL


def test_eigs_dict_state():
    """A {"v", "p"} state flattens in sorted key order, as the JAX
    package's ravel_pytree does: the operator of a dict state has the
    eigenvalues of its flat matrix."""
    A, v0 = _matrix(2, n=36)
    shapes = {"p": (4, 3), "v": (4, 3, 2)}
    At = torch.as_tensor(A)

    def op(x):
        flat = torch.cat([x["p"].reshape(-1), x["v"].reshape(-1)])
        y = At @ flat
        return {"p": y[:12].reshape(shapes["p"]), "v": y[12:].reshape(shapes["v"])}

    x0 = {"p": torch.as_tensor(v0[:12]).reshape(4, 3), "v": torch.as_tensor(v0[12:]).reshape(4, 3, 2)}
    res = teig.eigs(op, x0, k=3, which="LR", m=20, tol=1e-11)
    flat = teig.eigs(lambda v: At @ v, torch.as_tensor(v0), k=3, which="LR", m=20, tol=1e-11)
    w = np.linalg.eigvals(A)
    assert res.converged
    assert np.abs(res.eigenvalues - flat.eigenvalues).max() < 1e-12 * np.abs(w).max()
    assert _close(res.eigenvalues, w[np.argsort(-w.real)][:4], np.abs(w).max()) < TOL


def test_schur_helpers_and_basis_choice(monkeypatch):
    """The ordered real Schur form and its block edges equal the JAX
    package's (both host numpy); the basis lives on the vectors' device
    unless device_basis=False, with no fallback in between."""
    rng = np.random.default_rng(3)
    H = rng.standard_normal((12, 12))
    for which in ("LR", "LM"):
        T, Q = teig._schur_sorted(H, teig._sort_key(which))
        Tj, Qj = jeig._schur_sorted(H, jeig._sort_key(which))
        assert np.array_equal(T, Tj) and np.array_equal(Q, Qj)
        assert np.array_equal(teig._block_edges(T), jeig._block_edges(Tj))
    with pytest.raises(ValueError, match="which must be one of"):
        teig._sort_key("XX")
    used = []
    for cls in (teig._DeviceBasis, teig._HostBasis):
        orig = cls.__init__

        def init(self, *a, _orig=orig, **kw):
            used.append(type(self).__name__)
            _orig(self, *a, **kw)

        monkeypatch.setattr(cls, "__init__", init)
    A, v0 = _matrix(4, n=30)
    At = torch.as_tensor(A)
    for flag in (None, True, False):
        res = teig.eigs(lambda v: At @ v, torch.as_tensor(v0), k=2, m=12, tol=1e-9,
                        device_basis=flag)
        assert res.converged
    assert used == ["_DeviceBasis", "_DeviceBasis", "_HostBasis"]
    out = eps_result_to_numpy(res)
    assert out["matvecs"] == res.matvecs and out["eigenvalues"].shape == (2,)
