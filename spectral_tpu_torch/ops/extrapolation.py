"""Boundary polynomial extrapolation as static per-axis matrices.

Counterpart of ``spectral_tpu/ops/extrapolation.py``.  The reference
reduces the pressure order (``StokesPressureReduceOrder``,
stokes.C:1028-1080, with Neville's ``polyInterp``, util.C:129-144): each
boundary-face pressure value is overwritten by the Lagrange extrapolation
of its interior pencil, last axis first.  That is a fixed linear map per
axis: an (n x n) matrix E, the identity with its two boundary rows
replaced by interior-node Lagrange weights, built on the host in float64
and applied as a product along each axis.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def lagrange_weights_np(nodes: np.ndarray, x: float) -> np.ndarray:
    """w_j = prod_{k!=j} (x - z_k)/(z_j - z_k): interpolate f(x) = sum w_j f(z_j)."""
    n = len(nodes)
    w = np.ones(n)
    for j in range(n):
        for k in range(n):
            if k != j:
                w[j] *= (x - nodes[k]) / (nodes[j] - nodes[k])
    return w


@functools.lru_cache(maxsize=None)
def _reduce_matrix_np(nodes_key: tuple) -> np.ndarray:
    z = np.asarray(nodes_key)
    n = len(z)
    E = np.eye(n)
    E[0, :] = 0.0
    E[-1, :] = 0.0
    E[0, 1:-1] = lagrange_weights_np(z[1:-1], z[0])
    E[-1, 1:-1] = lagrange_weights_np(z[1:-1], z[-1])
    return E


@functools.lru_cache(maxsize=None)
def _reduce_matrix_t(nodes_key: tuple, dtype: torch.dtype,
                     device: torch.device) -> torch.Tensor:
    """E^T cast from float64 once per (nodes, dtype, device); read-only."""
    return torch.from_numpy(_reduce_matrix_np(nodes_key).T.copy()).to(
        device=device, dtype=dtype)


def reduce_order_matrix(nodes: np.ndarray, dtype: torch.dtype = torch.float64,
                        device: torch.device | str = "cpu") -> torch.Tensor:
    """E for ``nodes`` as a tensor in ``dtype`` on ``device``."""
    return torch.from_numpy(_reduce_matrix_np(tuple(float(v) for v in nodes))).to(
        device=device, dtype=dtype)


def pressure_reduce_order(p: torch.Tensor, nodes_1d: tuple[np.ndarray, ...]) -> torch.Tensor:
    """Replace every boundary-face value by interior extrapolation, axis by
    axis from the last axis to the first (matching stokes.C:1042-1074), in
    p's dtype on p's device."""
    for ax in reversed(range(len(nodes_1d))):
        ET = _reduce_matrix_t(tuple(float(v) for v in nodes_1d[ax]), p.dtype, p.device)
        p = torch.movedim(torch.matmul(torch.movedim(p, ax, -1), ET), -1, ax)
    return p
