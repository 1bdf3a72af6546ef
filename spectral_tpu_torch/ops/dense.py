"""Dense exact-operator direct solves (the ``-pc_type lu`` role for
matrix-free operators).

Counterpart of ``spectral_tpu/ops/dense.py``.  A matrix-free operator has
no assembled matrix to factor, so the reference preconditions with
assembled low-order surrogates.  At the grid sizes spectral collocation
uses (10^3-10^4 unknowns) the TRUE operator can be assembled instead, by
applying it to blocks of identity columns under ``torch.func.vmap``,
factored once (float64 numpy on the host, or ``torch.linalg.inv`` in
working precision on the device), and every later application of the
inverse is one ``torch.matmul``.

The flat order is the Krylov solvers' ``_ravel``: a dict state's leaves
concatenated in sorted key order ("p" then "v" for a Stokes state), the
order of the JAX package's ``ravel_pytree``, so the two packages' matrices
compare entry by entry.  Eager PyTorch has no trace, so the JAX package's
in-trace variants (``assemble_dense_traced``, ``regularized_inverse_traced``)
are the device versions here (``StokesProblem.make_dense_pc_var`` calls
them).
"""

from __future__ import annotations

import numpy as np
import torch

from spectral_tpu_torch.solvers.krylov import _ravel


def assemble_dense_device(apply_tree, example, *, block: int = 1024):
    """Dense matrix of a LINEAR operator on the example's device, in its
    working precision, by application to identity blocks.

    Args:
      apply_tree: w -> A w, linear, a tensor or a dict of tensors of the
        same structure as ``example``; it must run under ``torch.func.vmap``.
      example: a tensor or a dict of tensors defining the flat order.
      block: identity columns per vmapped application (bounds peak memory),
        at most n; the last block is padded cyclically, so every block has
        one shape (the JAX package's rule, which shares one compiled
        program between the blocks).

    Returns:
      (A, unravel): ``A`` an (n, n) tensor with A[i, j] = (A e_j)_i, and the
      unravel of the flat order.
    """
    flat0, unravel = _ravel(example, _leaf(example).dtype)
    n = int(flat0.shape[0])
    dtype, dev = flat0.dtype, flat0.device
    block = min(block, n)
    action = torch.func.vmap(lambda e: _ravel(apply_tree(unravel(e)), dtype)[0])
    AT = torch.empty((n, n), dtype=dtype, device=dev)   # row j: A e_j
    rows = torch.arange(block, device=dev)
    for s in range(0, n, block):
        E = torch.zeros((block, n), dtype=dtype, device=dev)
        E[rows, (rows + s) % n] = 1.0
        k = min(block, n - s)
        AT[s:s + k] = action(E)[:k]
    return AT.T, unravel


def _leaf(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else x[sorted(x)[0]]


def assemble_dense(apply_tree, example, *, block: int = 1024):
    """``assemble_dense_device`` fetched to the host: (A as a float64 numpy
    array, unravel)."""
    A, unravel = assemble_dense_device(apply_tree, example, block=block)
    return A.cpu().numpy().astype(np.float64), unravel


def regularized_inverse(A, *, free=None, null_vecs=(), dtype=np.float64) -> np.ndarray:
    """Host float64 inverse of ``A`` restricted to the free dofs, with
    rank-one shifts along known null vectors.

    ``free`` (bool (n,)): fixed dofs get decoupled identity rows and
    columns, so the inverse is a no-op there.  ``null_vecs``: directions
    spanning the operator's null space (the constant-pressure mode,
    stokes.C:1006-1025); each adds ``|A|_inf e e^T`` so the factorization
    is nonsingular, and callers project the null component off."""
    A = np.array(A, dtype=dtype)
    if free is not None:
        fixed = ~np.asarray(free, bool)
        A[fixed, :] = 0.0
        A[:, fixed] = 0.0
        ii = np.where(fixed)[0]
        A[ii, ii] = 1.0
    if len(null_vecs):
        scale = np.linalg.norm(A, np.inf)
        for e in null_vecs:
            e = np.asarray(e, dtype)
            e = e / np.linalg.norm(e)
            A = A + scale * np.outer(e, e)
    return np.linalg.inv(A)


def regularized_inverse_device(A: torch.Tensor, *, free=None, null_vecs=()) -> torch.Tensor:
    """``regularized_inverse`` in A's dtype on A's device
    (``torch.linalg.inv``, an LU factorization there)."""
    if free is not None:
        free = torch.as_tensor(np.asarray(free, bool), device=A.device)
        keep = free[:, None] & free[None, :]
        A = torch.where(keep, A, 0.0) + torch.diag((~free).to(A.dtype))
    if len(null_vecs):
        scale = torch.linalg.matrix_norm(A, ord=float("inf"))
        for e in null_vecs:
            e = torch.as_tensor(np.asarray(e, np.float64), dtype=A.dtype, device=A.device)
            e = e / torch.linalg.vector_norm(e)
            A = A + scale * torch.outer(e, e)
    return torch.linalg.inv(A)


def dense_apply(Ainv, unravel, *, transpose: bool = False):
    """r -> unravel(Ainv @ ravel(r)), one ``torch.matmul`` in r's dtype.

    ``Ainv`` is a tensor or a host numpy array (moved to the device and
    cast to r's dtype once per dtype).  ``transpose`` applies Ainv^T, the
    exact inverse of the transposed operator (the adjoint solve's PC)."""
    cache = {}

    def matrix(like: torch.Tensor) -> torch.Tensor:
        key = (like.dtype, like.device)
        M = cache.get(key)
        if M is None:
            M = torch.as_tensor(Ainv).to(device=like.device, dtype=like.dtype)
            M = cache[key] = M.T if transpose else M
        return M

    def apply(r):
        rf, _ = _ravel(r, _leaf(r).dtype)
        return unravel(torch.matmul(matrix(rf), rf))

    return apply
