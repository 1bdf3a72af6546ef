"""Tensor-product CGL grid with static boundary masks.

Counterpart of ``spectral_tpu/grid.py``.  Every field keeps the full grid
shape and the interior/boundary structure is a boolean mask, so "scatters"
are elementwise ``torch.where``.  Host-side geometry (nodes, chain-rule
factors) stays numpy float64; the tensors a solve uses (masks, coordinates)
are built once on the grid's ``device`` in the grid's ``dtype``.

Conventions (as in the JAX package): coordinates per axis are CGL nodes
cos(i*pi/(n-1)), decreasing from +1 (index 0) to -1 (index n-1); a
"global" vector carries zeros at Dirichlet entries.
"""

from __future__ import annotations

import dataclasses
import math
from functools import cached_property

import numpy as np
import torch

from spectral_tpu_torch.ops.chebyshev import cc_weights_np, cgl_nodes_np


@dataclasses.dataclass(frozen=True)
class Grid:
    """A d-dimensional tensor-product CGL grid on ``device`` in ``dtype``.

    ``intervals`` maps each axis affinely from [-1, 1] onto [a, b] (node 0
    sits at b); ``maps`` gives each axis a general ``ops.mapping.AxisMap``
    (physical nodes and per-node weights).  Spectral derivatives pick up
    the chain-rule factor through ``apply_dif_weight``; the physical nodes
    flow into every ``nodes_1d`` consumer (FD stencils, fast
    diagonalization, Q1 FEM, multigrid).

    ``device`` defaults to ``cuda``: without CUDA the constructor raises
    rather than running on the host; pass ``device="cpu"`` for that.
    """

    dims: tuple[int, ...]
    intervals: tuple[tuple[float, float], ...] | None = None
    maps: tuple | None = None
    device: torch.device | str = "cuda"
    dtype: torch.dtype = torch.float64

    def __post_init__(self):
        object.__setattr__(self, "dims", tuple(int(n) for n in self.dims))
        object.__setattr__(self, "device", torch.device(self.device))
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Grid(device='cuda'): CUDA is not available "
                               "(pass device='cpu' to run on the host)")
        if any(n < 3 for n in self.dims):
            raise ValueError(f"every axis needs >= 3 nodes, got {self.dims}")
        if self.intervals is not None and self.maps is not None:
            raise ValueError("pass intervals OR maps, not both")
        if self.maps is not None:
            object.__setattr__(self, "maps", tuple(self.maps))
            if len(self.maps) != len(self.dims):
                raise ValueError("need one AxisMap per axis")
            if any(m.n != n for m, n in zip(self.maps, self.dims)):
                raise ValueError("AxisMap lengths must match dims")
        if self.intervals is not None:
            if len(self.intervals) != len(self.dims):
                raise ValueError("need one (a, b) interval per axis")
            if any(b <= a for a, b in self.intervals):
                raise ValueError("intervals must satisfy a < b")
            object.__setattr__(self, "intervals",
                               tuple((float(a), float(b))
                                     for a, b in self.intervals))

    @property
    def ndim(self) -> int:
        return len(self.dims)

    @property
    def size(self) -> int:
        return math.prod(self.dims)

    @cached_property
    def nodes_1d(self) -> tuple[np.ndarray, ...]:
        if self.maps is not None:
            return tuple(np.asarray(m.x) for m in self.maps)
        ref = [cgl_nodes_np(n) for n in self.dims]
        if self.intervals is None:
            return tuple(ref)
        out = []
        for (a, b), z in zip(self.intervals, ref):
            c, h = 0.5 * (a + b), 0.5 * (b - a)
            out.append(c + h * z)
        return tuple(out)

    @cached_property
    def deriv_scale_np(self) -> np.ndarray:
        """Per-axis constant chain-rule factor d(xi)/d(x) = 2/(b - a) (1.0
        unmapped, and on general maps, whose weights are per node:
        ``dif_weight_np``)."""
        if self.intervals is None:
            return np.ones(len(self.dims))
        return np.asarray([2.0 / (b - a) for a, b in self.intervals])

    def deriv_scale(self, axis: int) -> float:
        if self.maps is not None:
            raise ValueError("general maps have per-node weights; use apply_dif_weight")
        return float(self.deriv_scale_np[axis])

    def dif_weight_np(self, axis: int):
        """Chain-rule weight of a spectral first derivative along ``axis``:
        None (identity), a float (affine interval) or an (n,) float64 array
        (general map)."""
        if self.maps is not None:
            return np.asarray(self.maps[axis].w)
        if self.intervals is None:
            return None
        return float(self.deriv_scale_np[axis])

    @cached_property
    def _weights(self) -> dict:
        return {}

    def _dif_weight_t(self, axis: int, dtype: torch.dtype,
                      device: torch.device, sl: slice = slice(None)) -> torch.Tensor:
        """A general map's (n,) weight as a tensor (its ``sl`` block along
        the axis, a slab's), built once per axis, block, dtype and device."""
        key = (axis, sl.start, sl.stop, dtype, device)
        w = self._weights.get(key)
        if w is None:
            w = self._weights[key] = torch.as_tensor(np.asarray(self.maps[axis].w)[sl],
                                                     dtype=dtype, device=device)
        return w

    def apply_dif_weight(self, v: torch.Tensor, axis: int,
                         sl: slice = slice(None)) -> torch.Tensor:
        """v * d(xi)/d(x) along ``axis`` (broadcast over every other axis,
        trailing component axes included); identity on unmapped grids.
        ``sl``: the block of the axis that v holds (a slab of a sharded
        grid), the whole axis by default."""
        if self.maps is not None:
            w = self._dif_weight_t(axis, v.dtype, v.device, sl)
            shape = [1] * v.ndim
            shape[axis] = w.shape[0]
            return v * w.reshape(shape)
        if self.intervals is None:
            return v
        return v * float(self.deriv_scale_np[axis])

    def apply_dif_weight_np(self, v: np.ndarray, axis: int) -> np.ndarray:
        """``apply_dif_weight`` on a host numpy array."""
        w = self.dif_weight_np(axis)
        if w is None:
            return v
        if np.ndim(w) == 0:
            return v * w
        shape = [1] * v.ndim
        shape[axis] = len(w)
        return v * w.reshape(shape)

    @cached_property
    def quad_weights_1d_np(self) -> tuple[np.ndarray, ...]:
        """Per-axis Clenshaw-Curtis weights on the physical nodes: the
        reference weights divided by the chain-rule factor d(xi)/d(x).
        Exact for the nodal interpolant along each axis."""
        out = []
        for ax, n in enumerate(self.dims):
            w = cc_weights_np(n)
            wd = self.dif_weight_np(ax)
            if wd is not None:
                w = w / np.asarray(wd)
            out.append(w)
        return tuple(out)

    @cached_property
    def quad_weights_np(self) -> np.ndarray:
        """Tensor-product quadrature weights over the full grid (float64)."""
        W = np.ones(self.dims)
        for ax, w in enumerate(self.quad_weights_1d_np):
            shape = [1] * self.ndim
            shape[ax] = len(w)
            W = W * w.reshape(shape)
        return W

    @cached_property
    def coords_np(self) -> np.ndarray:
        """(dims..., d) float64 coordinate array."""
        mesh = np.meshgrid(*self.nodes_1d, indexing="ij")
        return np.stack(mesh, axis=-1)

    @cached_property
    def coords(self) -> torch.Tensor:
        return torch.as_tensor(self.coords_np, dtype=self.dtype,
                               device=self.device)

    @cached_property
    def boundary_mask_np(self) -> np.ndarray:
        """(dims...) bool: node lies on any face."""
        m = np.zeros(self.dims, dtype=bool)
        for ax in range(self.ndim):
            sl0 = [slice(None)] * self.ndim
            sl1 = [slice(None)] * self.ndim
            sl0[ax] = 0
            sl1[ax] = -1
            m[tuple(sl0)] = True
            m[tuple(sl1)] = True
        return m

    @cached_property
    def boundary_mask(self) -> torch.Tensor:
        return torch.as_tensor(self.boundary_mask_np, device=self.device)

    @cached_property
    def interior_mask(self) -> torch.Tensor:
        return torch.as_tensor(~self.boundary_mask_np, device=self.device)

    @cached_property
    def normal_np(self) -> np.ndarray:
        """(dims..., d) outward unit normal on the boundary, zero inside,
        float64.  util.C:70-82 convention: +1 on the index-0 face (x=+1),
        -1 on the last face; normalized at edges and corners."""
        n = np.zeros(self.dims + (self.ndim,))
        for ax in range(self.ndim):
            sl0 = [slice(None)] * self.ndim + [ax]
            sl1 = [slice(None)] * self.ndim + [ax]
            sl0[ax] = 0
            sl1[ax] = -1
            n[tuple(sl0)] = 1.0
            n[tuple(sl1)] = -1.0
        norm = np.linalg.norm(n, axis=-1, keepdims=True)
        with np.errstate(invalid="ignore", divide="ignore"):
            n = np.where(norm > 0, n / np.where(norm > 0, norm, 1.0), 0.0)
        return n

    @cached_property
    def normal(self) -> torch.Tensor:
        return torch.as_tensor(self.normal_np, dtype=self.dtype, device=self.device)

    @property
    def num_boundary(self) -> int:
        return int(self.boundary_mask_np.sum())

    @property
    def num_interior(self) -> int:
        return self.size - self.num_boundary

    def census(self) -> str:
        return (f"DOF distribution: {self.size:8d} local "
                f"{self.num_interior:8d} global {self.num_boundary:8d} dirichlet")

    def _mask_for(self, mask: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        if u.ndim > self.ndim:  # trailing component axes
            return mask.reshape(mask.shape + (1,) * (u.ndim - self.ndim))
        return mask

    def zero_boundary(self, u: torch.Tensor) -> torch.Tensor:
        """Keep interior values, zero the boundary."""
        return torch.where(self._mask_for(self.interior_mask, u), u,
                           torch.zeros((), dtype=u.dtype, device=u.device))

    def set_boundary(self, u: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
        """Overwrite boundary entries with ``values``."""
        return torch.where(self._mask_for(self.boundary_mask, u), values, u)
