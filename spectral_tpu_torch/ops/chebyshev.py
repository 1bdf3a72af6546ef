"""Chebyshev-Gauss-Lobatto (CGL) spectral differentiation on torch tensors.

Counterpart of ``spectral_tpu/ops/chebyshev.py``.  The host builders
(nodes, quadrature weights, the float64 transform oracle and the dense
differentiation matrix) are numpy and identical to the JAX package's, so
both packages apply the same matrices bit for bit.

Execution paths of ``chebdiff``:

- ``"matmul"``: the dense (n x n) differentiation matrix contracted along
  ``axis`` with ``torch.tensordot`` (a library product; in the JAX package
  this product is left to XLA, outside any Pallas kernel).
- ``"fft"``: DCT-I / DST-I through ``torch.fft.rfft`` of the even / odd
  extension, the algorithm of the reference's ChebD1Mult.
- ``"kernel"``: the hand-written CUDA kernel K1
  (``ops.cuda_cheb.chebdiff_last``) for the last axis; other axes take the
  matmul path.  A tensor that needs a graph or is wrapped by
  ``torch.func`` goes through K1's autograd pair: under ``vmap`` one
  launch for the batch, under ``jvp`` one for the primal and one for the
  tangent, and in every backward the transposed product K1^T.  It is the
  port's name for the JAX package's ``"pallas"``.
- ``"auto"``: the production switch.  Under ``production_path() ==
  "kernel"`` (the default) a last-axis derivative of a CUDA tensor with
  ``n <= K1_MAX_N`` goes to K1; otherwise ``n <= MATMUL_MAX_N`` takes the
  matmul path and larger ``n`` the fft path.  ``set_production_path``
  switches last-axis derivatives between K1 and the matmul path.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# Above this size the O(n^2) matmul form loses to the O(n log n) FFT form
# (the JAX package's threshold, kept so both packages pick the same path).
MATMUL_MAX_N = 512

# The path chebdiff(method="auto") takes for last-axis derivatives of CUDA
# tensors: "kernel" (K1) or "matmul".
_PRODUCTION_LAST_AXIS = "kernel"


def set_production_path(last_axis: str) -> None:
    """Select the path chebdiff(method="auto") takes for LAST-axis
    derivatives: "kernel" (K1, the default; "pallas", the JAX package's
    name, is taken as "kernel") or "matmul" (``torch.tensordot``).  The
    JAX package defaults to "matmul"; here K1 is the production path, and
    "matmul" routes every automatic last-axis derivative of the process
    away from it.  Other axes, CPU tensors and explicit methods are
    unaffected."""
    global _PRODUCTION_LAST_AXIS
    if last_axis not in ("kernel", "matmul", "pallas"):
        raise ValueError(f"unknown path {last_axis!r}")
    _PRODUCTION_LAST_AXIS = "kernel" if last_axis == "pallas" else last_axis


def production_path() -> str:
    return _PRODUCTION_LAST_AXIS


# ---------------------------------------------------------------------------
# Host-side numpy builders (copies of the JAX package's ops/chebyshev.py ones)
# ---------------------------------------------------------------------------

def cgl_nodes_np(n: int, dtype=np.float64) -> np.ndarray:
    """CGL nodes x_i = cos(i*pi/(n-1)), i = 0..n-1 (decreasing from +1 to -1)."""
    if n < 2:
        raise ValueError(f"need at least 2 nodes, got {n}")
    i = np.arange(n, dtype=np.float64)
    return np.cos(i * np.pi / (n - 1)).astype(dtype)


def cgl_nodes(n: int, dtype: torch.dtype = torch.float64,
              device: torch.device | str = "cuda") -> torch.Tensor:
    """CGL nodes as a tensor, cast from the float64 host nodes."""
    return torch.as_tensor(cgl_nodes_np(n), dtype=dtype, device=device)


def cc_weights_np(n: int) -> np.ndarray:
    """Clenshaw-Curtis quadrature weights on the n CGL nodes of [-1, 1],
    ordered like ``cgl_nodes_np``; symmetric, positive, sum to 2."""
    if n < 2:
        raise ValueError(f"need at least 2 nodes, got {n}")
    N = n - 1
    k = np.arange(n, dtype=np.float64)
    w = np.ones(n)
    for j in range(1, N // 2 + 1):
        b = 1.0 if 2 * j == N else 2.0
        w -= b * np.cos(2.0 * j * k * np.pi / N) / (4.0 * j * j - 1.0)
    w *= 2.0 / N
    w[0] *= 0.5
    w[-1] *= 0.5
    return w


def _dct1_np(u: np.ndarray, axis: int) -> np.ndarray:
    """Unnormalized DCT-I (FFTW REDFT00)."""
    u = np.moveaxis(u, axis, -1)
    n = u.shape[-1]
    ext = np.concatenate([u, u[..., -2:0:-1]], axis=-1)  # even extension, length 2N
    W = np.fft.rfft(ext, axis=-1).real[..., :n]
    return np.moveaxis(W, -1, axis)


def _dst1_np(b: np.ndarray, axis: int) -> np.ndarray:
    """Unnormalized DST-I (FFTW RODFT00) of length M."""
    b = np.moveaxis(b, axis, -1)
    m = b.shape[-1]
    z = np.zeros(b.shape[:-1] + (2 * (m + 1),), dtype=b.dtype)
    z[..., 1 : m + 1] = b
    z[..., m + 2 :] = -b[..., ::-1]
    S = -np.fft.rfft(z, axis=-1).imag[..., 1 : m + 1]
    return np.moveaxis(S, -1, axis)


def chebdiff_np(u: np.ndarray, axis: int = 0) -> np.ndarray:
    """Numpy float64 reference of the CGL derivative along ``axis``
    (forward DCT-I, coefficient scaling, backward DST-I, chain-rule
    division, closed-form endpoint rows)."""
    u = np.moveaxis(np.asarray(u, dtype=np.float64), axis, -1)
    n = u.shape[-1]
    N = n - 1
    W = _dct1_np(u, -1)
    k = np.arange(n, dtype=np.float64)
    y = np.empty_like(u)
    if N >= 2:
        Wk = W[..., 1:N] * k[1:N]
        i = np.arange(1, N, dtype=np.float64)
        y[..., 1:N] = _dst1_np(Wk, -1) / (2.0 * N * np.sin(i * np.pi / N))
        k2W = W[..., 1:N] * k[1:N] ** 2
        sgn = (-1.0) ** (k[1:N] + 1.0)
        y[..., 0] = 0.5 * N * W[..., N] + k2W.sum(-1) / N
        y[..., N] = (sgn * k2W).sum(-1) / N + 0.5 * ((-1.0) ** (N + 1)) * N * W[..., N]
    else:  # n == 2: derivative of the linear interpolant
        y[..., 0] = 0.5 * N * W[..., N]
        y[..., N] = 0.5 * ((-1.0) ** (N + 1)) * N * W[..., N]
    return np.moveaxis(y, -1, axis)


@functools.lru_cache(maxsize=None)
def diffmat_np(n: int) -> np.ndarray:
    """Dense (n x n) CGL differentiation matrix, float64, built by applying
    the transform algorithm to the identity.  Callers must not mutate it."""
    return np.ascontiguousarray(chebdiff_np(np.eye(n), axis=0))


@functools.lru_cache(maxsize=None)
def diffmat(n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The differentiation matrix as a tensor, cast from float64 once per
    (n, dtype, device).  A read-only constant shared by all callers."""
    return torch.from_numpy(diffmat_np(n)).to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# Transforms on tensors
# ---------------------------------------------------------------------------

def dct1(u: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Unnormalized DCT-I along ``axis``."""
    u = torch.movedim(u, axis, -1)
    n = u.shape[-1]
    ext = torch.cat([u, torch.flip(u[..., 1:-1], dims=(-1,))], dim=-1)
    W = torch.fft.rfft(ext, dim=-1).real[..., :n].to(u.dtype)
    return torch.movedim(W, -1, axis)


def dst1(b: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Unnormalized DST-I along ``axis``."""
    b = torch.movedim(b, axis, -1)
    m = b.shape[-1]
    zero = torch.zeros(b.shape[:-1] + (1,), dtype=b.dtype, device=b.device)
    z = torch.cat([zero, b, zero, -torch.flip(b, dims=(-1,))], dim=-1)
    S = (-torch.fft.rfft(z, dim=-1).imag[..., 1 : m + 1]).to(b.dtype)
    return torch.movedim(S, -1, axis)


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A float64 host constant cast to ``like``'s dtype on its device."""
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def _chebdiff_fft(u: torch.Tensor, axis: int) -> torch.Tensor:
    """FFT path of the derivative; same algorithm as chebdiff_np."""
    u = torch.movedim(u, axis, -1)
    n = u.shape[-1]
    N = n - 1
    W = dct1(u, -1)
    if N >= 2:
        k = _const(np.arange(1, N, dtype=np.float64), u)
        Wk = W[..., 1:N] * k
        i = np.arange(1, N, dtype=np.float64)
        scale = _const(1.0 / (2.0 * N * np.sin(i * np.pi / N)), u)
        interior = dst1(Wk, -1) * scale
        k2W = Wk * k
        sgn = _const((-1.0) ** np.arange(2, N + 1, dtype=np.float64), u)
        y0 = 0.5 * N * W[..., N] + k2W.sum(-1) / N
        yN = (sgn * k2W).sum(-1) / N + 0.5 * ((-1.0) ** (N + 1)) * N * W[..., N]
        y = torch.cat([y0[..., None], interior, yN[..., None]], dim=-1)
    else:
        y0 = 0.5 * N * W[..., N]
        yN = 0.5 * ((-1.0) ** (N + 1)) * N * W[..., N]
        y = torch.cat([y0[..., None], yN[..., None]], dim=-1)
    return torch.movedim(y, -1, axis)


def _chebdiff_matmul(u: torch.Tensor, axis: int) -> torch.Tensor:
    """Dense-matmul path: contract the differentiation matrix along ``axis``
    (a library product at full float32 precision, see the package policy)."""
    axis = axis % u.ndim
    D = diffmat(u.shape[axis], u.dtype, u.device)
    if axis == 0:
        # y[i, ...] = sum_j D[i, j] u[j, ...]
        return torch.tensordot(D, u, dims=([1], [0]))
    y = torch.tensordot(u, D, dims=([axis], [1]))
    # the contracted axis is removed; the new one lands last
    if axis == u.ndim - 1:
        return y
    return torch.movedim(y, -1, axis)


def chebdiff(u: torch.Tensor, axis: int = 0, method: str = "auto") -> torch.Tensor:
    """Derivative along ``axis`` of a rank-r tensor sampled on CGL nodes.

    Args:
      u: values on the tensor-product CGL grid; any rank, other axes batch.
      axis: which axis to differentiate.
      method: "auto" | "matmul" | "fft" | "kernel" (K1 on the last axis).
    """
    from spectral_tpu_torch.ops import cuda_cheb

    n = u.shape[axis]
    if n < 2:
        raise ValueError(f"axis {axis} has extent {n}; need >= 2")
    last = axis % u.ndim == u.ndim - 1
    if method == "auto":
        if n > MATMUL_MAX_N:
            method = "fft"
        elif (last and u.is_cuda and n <= cuda_cheb.K1_MAX_N
              and _PRODUCTION_LAST_AXIS == "kernel"):
            method = "kernel"
        else:
            method = "matmul"
    if method == "kernel":
        if last:   # K1, or its autograd pair where u needs a graph
            return cuda_cheb.chebdiff_last(u.contiguous())
        method = "matmul"  # K1 streams the minor axis only
    if method == "matmul":
        return _chebdiff_matmul(u, axis)
    if method == "fft":
        return _chebdiff_fft(u, axis)
    raise ValueError(f"unknown method {method!r}")


def gradient(u: torch.Tensor, ndim: int, method: str = "auto") -> list[torch.Tensor]:
    """[d/dx_0 u, ..., d/dx_{ndim-1} u]; axes beyond ndim are batch axes."""
    return [chebdiff(u, axis=i, method=method) for i in range(ndim)]


# ---------------------------------------------------------------------------
# Coefficient space: modal <-> nodal transforms and spectral regridding
# ---------------------------------------------------------------------------

def cheb_coefficients(u: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Chebyshev modal coefficients a_k of nodal values along ``axis``:
    u = sum_k a_k T_k(x) with a_k = W_k / (N c_k), c_0 = c_N = 2 (DCT-I)."""
    u = torch.movedim(u, axis, -1)
    n = u.shape[-1]
    c = np.ones(n)
    c[0] = c[-1] = 2.0
    a = dct1(u, -1) / _const((n - 1) * c, u)
    return torch.movedim(a, -1, axis)


def cheb_nodal(a: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inverse of cheb_coefficients: the Chebyshev series at the CGL nodes
    (DCT-I is self-inverse up to scaling)."""
    a = torch.movedim(a, axis, -1)
    c = np.ones(a.shape[-1])
    c[0] = c[-1] = 2.0
    u = dct1(a * _const(c, a) / 2.0, -1)
    return torch.movedim(u, -1, axis)


def cheb_eval(a: torch.Tensor, x, axis: int = -1) -> torch.Tensor:
    """The Chebyshev series with coefficients ``a`` (along ``axis``) at
    points x in [-1, 1], in the matmul form T_k(x) = cos(k arccos x): one
    product at full precision (the package's policy keeps TF32 off)."""
    a = torch.movedim(a, axis, -1)
    k = torch.arange(a.shape[-1], dtype=a.dtype, device=a.device)
    xt = torch.as_tensor(x, dtype=a.dtype, device=a.device)
    T = torch.cos(k[None, :] * torch.arccos(xt)[:, None])
    return torch.movedim(torch.tensordot(a, T, dims=([-1], [1])), -1, axis)


def cheb_pad_matrices_np(n: int, m: int) -> tuple[np.ndarray, np.ndarray]:
    """(U, D) dealiasing transfer pair between CGL grids of n and m >= n
    nodes: ``U`` (m, n) interpolates nodal values onto the fine grid
    (Chebyshev coefficient zero-pad, exact), ``D`` (n, m) projects fine
    nodal values back by coefficient truncation.  D @ U = I.  Products
    evaluated as D @ ((U u) * (U v)) are alias-free when
    m - 1 >= ceil(3 (n - 1) / 2) (the 3/2 rule)."""
    if m < n:
        raise ValueError(f"padding needs m >= n, got {m} < {n}")
    jn = np.arange(n)
    jm = np.arange(m)
    Sn = np.cos(np.pi * np.outer(jn, jn) / (n - 1))   # values = S @ coeffs
    Sm = np.cos(np.pi * np.outer(jm, jm) / (m - 1))
    An = np.linalg.inv(Sn)                            # nodal -> coeffs
    Am = np.linalg.inv(Sm)
    return Sm[:, :n] @ An, Sn @ Am[:n, :]


def cheb_regrid(u: torch.Tensor, new_dims: tuple[int, ...]) -> torch.Tensor:
    """Spectral interpolation of nodal values onto another CGL tensor grid:
    per axis, the modal transform, a coefficient zero-pad (refine) or
    truncation (coarsen), and the inverse transform; exact for fields the
    coarser grid resolves.  Trailing component axes (beyond
    ``len(new_dims)``) batch through, so velocity fields regrid directly.
    Grid sequencing warm-starts a fine solve from a coarse one with it."""
    for ax, n_new in enumerate(new_dims):
        n_old, n_new = u.shape[ax], int(n_new)
        if n_new == n_old:
            continue
        a = cheb_coefficients(u, ax)
        if n_new > n_old:
            pad = list(a.shape)
            pad[ax] = n_new - n_old
            a = torch.cat([a, a.new_zeros(pad)], dim=ax)
        else:
            a = a.narrow(ax, 0, n_new)
        u = cheb_nodal(a, ax)
    return u
