"""Small tensor-algebra helpers shared by the tensor-product solvers.

Counterpart of ``spectral_tpu/ops/tensorops.py``.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def apply_axis_matmul(M: torch.Tensor, x: torch.Tensor, axis: int) -> torch.Tensor:
    """y = contract M (m_out, m_in) with x along ``axis`` (a batched
    library product at full float32 precision, see the package policy)."""
    xm = torch.movedim(x, axis, -1)
    return torch.movedim(torch.matmul(xm, M.T), -1, axis)


def stencil_dense_indices(dims: tuple[int, ...]) -> tuple[np.ndarray, np.ndarray]:
    """Static (rows, cols) that scatter stencil coefficient fields into a
    dense matrix, ordered [center, lower_0.., lower_d-1, upper_0..].

    Off-grid neighbours are clamped onto the diagonal; their coefficients
    are zero by construction, so the scatter must ACCUMULATE (an assignment
    would overwrite the diagonal with those zeros)."""
    size = math.prod(dims)
    strides = [math.prod(dims[j + 1:]) for j in range(len(dims))]
    flat = np.arange(size)
    idx = np.indices(dims).reshape(len(dims), -1)
    rows = [flat]
    cols = [flat]
    for ax in range(len(dims)):
        rows.append(flat)
        cols.append(np.where(idx[ax] > 0, flat - strides[ax], flat))
    for ax in range(len(dims)):
        rows.append(flat)
        cols.append(np.where(idx[ax] < dims[ax] - 1, flat + strides[ax], flat))
    return np.concatenate(rows), np.concatenate(cols)


def stencil_to_dense(stencil, dims: tuple[int, ...]) -> torch.Tensor:
    """Densify a StencilOp on its device, in its dtype (small grids and
    coarse levels)."""
    rows, cols = stencil_dense_indices(dims)
    c = stencil.center
    vals = torch.cat([c.reshape(-1)]
                     + [stencil.lower[ax].reshape(-1) for ax in range(len(dims))]
                     + [stencil.upper[ax].reshape(-1) for ax in range(len(dims))])
    size = math.prod(dims)
    A = torch.zeros((size, size), dtype=vals.dtype, device=vals.device)
    index = (torch.as_tensor(rows, device=vals.device),
             torch.as_tensor(cols, device=vals.device))
    # out of place, so a family's setup can map it over the batch
    return A.index_put(index, vals, accumulate=True)
