"""General 1-D coordinate maps for tensor-product grids.

Counterpart of ``spectral_tpu/ops/mapping.py``: a per-axis map x = phi(xi)
carries the physical node positions and the chain-rule weights
d(xi)/d(x) at the nodes.  Tensor products of 1-D maps keep every operator
separable, so the FD surrogates, fast diagonalization and multigrid
hierarchies work off the physical nodes, while spectral derivatives
multiply by the weight field.  Everything here is host float64 numpy; the
maps are hashable tuples, so a Grid carrying them stays a frozen key.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from spectral_tpu_torch.ops.chebyshev import _dct1_np, cgl_nodes_np, chebdiff_np


def _interp_cgl_np(values: np.ndarray, x_eval: np.ndarray) -> np.ndarray:
    """Chebyshev interpolation of CGL-sampled values at arbitrary points of
    [-1, 1], float64."""
    v = np.asarray(values, dtype=np.float64)
    n = len(v)
    N = n - 1
    W = _dct1_np(v, 0)
    c = np.ones(n)
    c[0] = c[-1] = 2.0
    a = W / (N * c)
    T = np.cos(np.outer(np.arccos(np.clip(x_eval, -1.0, 1.0)), np.arange(n)))
    return T @ a


@dataclasses.dataclass(frozen=True)
class AxisMap:
    """x = phi(xi) along one axis: physical nodes and d(xi)/d(x) weights."""

    x: tuple[float, ...]   # physical node positions (CGL image, decreasing)
    w: tuple[float, ...]   # 1 / phi'(xi) at the nodes

    @property
    def n(self) -> int:
        return len(self.x)

    @staticmethod
    def affine(a: float, b: float, n: int) -> "AxisMap":
        """[-1, 1] -> [a, b]; constant weight 2/(b - a)."""
        z = cgl_nodes_np(n)
        c, h = 0.5 * (a + b), 0.5 * (b - a)
        return AxisMap(tuple(float(v) for v in c + h * z), tuple([2.0 / (b - a)] * n))

    @staticmethod
    def tanh_cluster(a: float, b: float, n: int, beta: float = 2.0) -> "AxisMap":
        """x = c + h tanh(beta xi) / tanh(beta): more clustering at both ends
        on top of the CGL distribution (boundary layers)."""
        z = cgl_nodes_np(n)
        c, h = 0.5 * (a + b), 0.5 * (b - a)
        x = c + h * np.tanh(beta * z) / np.tanh(beta)
        dxdxi = h * beta / np.tanh(beta) / np.cosh(beta * z) ** 2
        return AxisMap(tuple(float(v) for v in x), tuple(float(v) for v in 1.0 / dxdxi))

    @staticmethod
    def kte(a: float, b: float, n: int, alpha: float = 0.99) -> "AxisMap":
        """Kosloff-Tal-Ezer, x = c + h arcsin(alpha xi) / arcsin(alpha):
        spreads the CGL endpoints toward uniform spacing (relaxes the
        O(1/n^2) explicit time-step limit)."""
        z = cgl_nodes_np(n)
        c, h = 0.5 * (a + b), 0.5 * (b - a)
        x = c + h * np.arcsin(alpha * z) / np.arcsin(alpha)
        dxdxi = h * alpha / (np.arcsin(alpha) * np.sqrt(1.0 - (alpha * z) ** 2))
        return AxisMap(tuple(float(v) for v in x), tuple(float(v) for v in 1.0 / dxdxi))

    def restrict(self, n_c: int) -> "AxisMap":
        """The same map on a coarser CGL grid (multigrid levels): x(xi)
        interpolated spectrally at the coarse nodes, the weights re-derived
        from the coarse coordinate, the endpoints pinned exactly."""
        x_c = _interp_cgl_np(np.asarray(self.x), cgl_nodes_np(n_c))
        x_c[0], x_c[-1] = self.x[0], self.x[-1]
        return AxisMap.from_nodes(x_c)

    @staticmethod
    def from_nodes(x_nodes) -> "AxisMap":
        """Any strictly monotone node set sampled on the CGL image: the
        weights come from differentiating the coordinate spectrally."""
        x = np.asarray(x_nodes, dtype=np.float64)
        dxdxi = chebdiff_np(x, 0)
        if not (np.all(dxdxi < 0) or np.all(dxdxi > 0)):
            raise ValueError("node map must be strictly monotone")
        return AxisMap(tuple(float(v) for v in x), tuple(float(v) for v in 1.0 / dxdxi))
