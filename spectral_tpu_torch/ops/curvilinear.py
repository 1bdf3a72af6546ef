"""Full curvilinear coordinate transforms (non-tensor-product maps).

Counterpart of ``spectral_tpu/ops/curvilinear.py``: a smooth invertible
map x = Phi(xi) from the reference cube onto a curved domain, with the
metric precomputed spectrally on the grid.  The Jacobian d x_i / d xi_j
comes from Chebyshev-differentiating the coordinate fields themselves
(host float64 numpy), and the conservative Laplacian

    Lap_x u = (1/detJ) sum_i D_xi_i ( A_ij D_xi_j u ),   A = detJ Jinv Jinv^T

is 2d derivative passes (``chebdiff``: kernel K1 on the last axis of a
CUDA tensor) and elementwise metric multiplies.  Every field keeps the
full grid shape.  The device copies of the metric fields are made once
per (dtype, device) and cached on the map.

The preconditioner surrogate keeps the separable part (the coefficients
A_ll at the nodes, cross terms dropped), assembled by the same
variable-coefficient stencil as the flat paths and solved by multigrid.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Callable

import numpy as np
import torch

from spectral_tpu_torch.grid import Grid
from spectral_tpu_torch.ops.chebyshev import chebdiff, chebdiff_np


@dataclasses.dataclass(frozen=True, eq=False)
class CurvilinearMap:
    """x = Phi(xi) on the CGL grid: physical coordinates and metric fields,
    float64 numpy.

    coords: (dims..., d)     physical node positions;
    detJ:   (dims...)        |Jacobian determinant| (one-signed);
    Acoef:  (dims..., d, d)  detJ * Jinv @ Jinv^T (the flux metric);
    Jinv:   (dims..., d, d)  d xi_i / d x_j.
    """

    grid: Grid
    coords: np.ndarray
    detJ: np.ndarray
    Acoef: np.ndarray
    Jinv: np.ndarray

    @staticmethod
    def build(grid: Grid, phi: Callable[[np.ndarray], np.ndarray]) -> "CurvilinearMap":
        """phi: (dims..., d) reference coordinates -> (dims..., d) physical.
        The Jacobian is the spectral derivative of the coordinate fields
        (exact to round-off for maps the grid resolves)."""
        d = grid.ndim
        ref = grid.coords_np
        x = np.asarray(phi(ref), dtype=np.float64)
        if x.shape != ref.shape:
            raise ValueError("phi must map (dims..., d) -> (dims..., d)")
        # J[..., i, j] = d x_i / d xi_j
        J = np.stack([np.stack([chebdiff_np(x[..., i], j) for j in range(d)], axis=-1)
                      for i in range(d)], axis=-2)
        detJ = np.linalg.det(J)
        if not (np.all(detJ > 0) or np.all(detJ < 0)):
            raise ValueError("map is not invertible on the grid (detJ changes sign)")
        Jinv = np.linalg.inv(J)
        A = np.abs(detJ)[..., None, None] * (Jinv @ np.swapaxes(Jinv, -1, -2))
        return CurvilinearMap(grid=grid, coords=x, detJ=np.abs(detJ), Acoef=A, Jinv=Jinv)

    @cached_property
    def cofactor(self) -> np.ndarray:
        """(dims..., d, d) cofactor field detJ * Jinv[l, j]: the flux
        weights of the conservative (Piola) form,
        div_x F = (1/detJ) sum_l d_xi_l (cofactor[l, j] F_j).

        Free-stream preserving: the discrete geometric conservation law
        sum_l D_l cofactor[l, j] == 0 holds to round-off, so a constant
        field has zero discrete Piola divergence even where the grid does
        not resolve the map.  In 2-D the entries are single coordinate
        derivatives (the adjugate); in 3-D the product detJ * Jinv aliases
        and is replaced by the Thomas-Lombard curl form
            C[l,j] = D_m(x_p D_n x_q) - D_n(x_p D_m x_q),
        (j,p,q), (l,m,n) cyclic, whose mixed D_m D_n x_q terms cancel
        exactly.  d >= 4 keeps the product form."""
        d = self.grid.ndim
        if d == 1:
            return np.ones(self.grid.dims + (1, 1))
        x = self.coords
        # the curl/adjugate forms give the SIGNED detJ * Jinv; the stored
        # convention is |detJ| * Jinv, so an orientation-reversing map takes
        # one global sign (detJ is one-signed)
        sgn = np.sign(np.linalg.det(self.Jinv.reshape(-1, d, d)[0]))
        C = np.zeros(self.grid.dims + (d, d))
        if d == 2:
            for l in range(2):
                for j in range(2):
                    C[..., l, j] = (-1.0) ** (j + l) * chebdiff_np(x[..., 1 - j], 1 - l)
            return sgn * C
        if d == 3:
            cyc = {0: (1, 2), 1: (2, 0), 2: (0, 1)}
            for j in range(3):
                p, q = cyc[j]
                for l in range(3):
                    m, n = cyc[l]
                    C[..., l, j] = (chebdiff_np(x[..., p] * chebdiff_np(x[..., q], n), m)
                                    - chebdiff_np(x[..., p] * chebdiff_np(x[..., q], m), n))
            return sgn * C
        return self.detJ[..., None, None] * self.Jinv

    def boundary_normal(self) -> np.ndarray:
        """(dims..., d) physical outward unit normal on the boundary, zero
        inside: the face xi_ax = const has normal grad_x(xi_ax) = Jinv[ax, :],
        so n_phys ~ sum_ax n_ref[ax] Jinv[ax, :], normalized (edges and
        corners combine faces as the reference convention does)."""
        n = np.einsum("...aj,...a->...j", self.Jinv, self.grid.normal_np)
        norm = np.linalg.norm(n, axis=-1, keepdims=True)
        return np.where(norm > 0, n / np.where(norm > 0, norm, 1.0), 0.0)

    @cached_property
    def _fields(self) -> dict:
        return {}

    def field(self, name: str, dtype: torch.dtype,
              device: torch.device | str | None = None, slab=None) -> torch.Tensor:
        """The float64 field ``name`` (coords, detJ, Acoef, Jinv, cofactor)
        as a tensor in ``dtype`` on ``device`` (the grid's by default),
        made once per (dtype, device); with ``slab`` (``parallel.slab``)
        cut to this process' slab, once per slab.  The metric contractions
        are pointwise, so a slab's fields serve its operators."""
        device = torch.device(device or self.grid.device)
        key = (name, dtype, device, id(slab))
        got = self._fields.get(key)
        if got is None:
            a = np.asarray(getattr(self, name))
            t = torch.as_tensor(a if slab is None else slab.local_np(a), dtype=dtype,
                                device=device)
            got = self._fields[key] = (t, slab)
        return got[0]

    def laplacian(self, u: torch.Tensor, slab=None) -> torch.Tensor:
        """Physical Laplacian of a field on the mapped grid (conservative
        form), in u's dtype on u's device.  With ``slab``
        (``parallel.slab.Slab``) u is this process' slab: the derivatives
        go through the pencil exchange and the fields are cut to the slab."""
        d = self.grid.ndim
        dif = chebdiff if slab is None else slab.dif()
        A = self.field("Acoef", u.dtype, u.device, slab)
        grads = [dif(u, j) for j in range(d)]
        y = torch.zeros_like(u)
        for i in range(d):
            flux = sum(A[..., i, j] * grads[j] for j in range(d))
            y = y + dif(flux, i)
        return y / self.field("detJ", u.dtype, u.device, slab)

    def pc_coeffs(self, eta: torch.Tensor | None = None,
                  dtype: torch.dtype | None = None) -> dict:
        """The coefficient fields of the separable metric surrogate
        (``metric_surrogate_builder``), in ``dtype`` (eta's, else the
        grid's); they restrict down a multigrid hierarchy with ``eta``."""
        d = self.grid.ndim
        if dtype is None:
            dtype = eta.dtype if eta is not None else self.grid.dtype
        device = eta.device if eta is not None else self.grid.device
        A = self.field("Acoef", dtype, device)
        out = {f"metric_a{ax}": A[..., ax, ax].contiguous() for ax in range(d)}
        out["metric_detJ"] = self.field("detJ", dtype, device)
        if eta is not None:
            out["eta"] = eta
        return out


def _metric_caxes(grid: Grid, coeffs: dict, d: int):
    eta = coeffs.get("eta")
    if eta is None:
        detJ = coeffs["metric_detJ"]
        eta = torch.ones(grid.dims, dtype=detJ.dtype, device=detJ.device)
    return [eta * coeffs[f"metric_a{ax}"] for ax in range(d)]


def metric_surrogate_builder(d: int, neumann_axes: tuple = ()):
    """Multigrid stencil builder of the separable metric surrogate
    -(1/detJ) d_l(eta A_ll d_l .) (cross terms dropped), from
    ``CurvilinearMap.pc_coeffs`` (with an optional "eta" field): the one
    surrogate of the curved Poisson, elliptic, heat and Stokes
    preconditioners.  ``neumann_axes``: axes whose end faces carry
    zero-flux rows, their couplings eliminated into the adjacent centers
    on every level (``ops/stencil.py``)."""
    from spectral_tpu_torch.ops.stencil import anisotropic_fd_stencil

    def builder(grid, coeffs):
        return anisotropic_fd_stencil(grid, _metric_caxes(grid, coeffs, d),
                                      row_scale=1.0 / coeffs["metric_detJ"],
                                      neumann_axes=neumann_axes)

    return builder


def metric_surrogate_folds(grid: Grid, coeffs: dict, neumann_axes: tuple) -> dict:
    """The finest level's zero-flux fold data of the metric surrogate,
    {ax: (h_lo, f_lo, h_hi, f_hi)}, f_* the scaled face-coupling fields on
    the face-adjacent interior slices
    (``anisotropic_fd_stencil(with_folds=True)``)."""
    from spectral_tpu_torch.ops.stencil import anisotropic_fd_stencil

    _, folds = anisotropic_fd_stencil(grid, _metric_caxes(grid, coeffs, grid.ndim),
                                      row_scale=1.0 / coeffs["metric_detJ"],
                                      neumann_axes=neumann_axes, with_folds=True)
    return folds


def named_map(spec: str):
    """The parametric maps of the CLI's ``-map`` flag:

    - ``bump:a``        sinusoidal perturbation of the box, amplitude ``a``
                        (alternating-sign components; any dimension);
    - ``shear:a``       linear shear x0 += a * x1 (constant metric);
    - ``annulus:r0:r1`` 2-D quarter-annulus sector, radii r0 < r1.

    Returns phi: (dims..., d) -> (dims..., d) for ``CurvilinearMap.build``
    and the models' ``phi=``; None for the empty spec."""
    if not spec:
        return None
    parts = spec.split(":")
    name, args = parts[0], [float(v) for v in parts[1:]]
    if name == "bump":
        a = args[0] if args else 0.08

        def phi(xi):
            d = xi.shape[-1]
            bump = np.ones(xi.shape[:-1])
            for ax in range(d):
                bump = bump * np.sin(np.pi * xi[..., ax])
            return np.stack([xi[..., ax] + ((-1.0) ** ax) * a * bump for ax in range(d)],
                            axis=-1)

        return phi
    if name == "shear":
        a = args[0] if args else 0.3

        def phi(xi):
            out = [xi[..., ax].copy() for ax in range(xi.shape[-1])]
            out[0] = out[0] + a * xi[..., 1]
            return np.stack(out, axis=-1)

        return phi
    if name == "annulus":
        r0, r1 = (args + [1.0, 2.0])[:2]
        if not 0 < r0 < r1:
            raise ValueError("annulus needs 0 < r0 < r1")

        def phi(xi):
            if xi.shape[-1] != 2:
                raise ValueError("annulus map is 2-D")
            r = r0 + (r1 - r0) * 0.5 * (xi[..., 0] + 1.0)
            th = 0.25 * np.pi * 0.5 * (xi[..., 1] + 1.0)
            return np.stack([r * np.cos(th), r * np.sin(th)], axis=-1)

        return phi
    raise ValueError(f"unknown map {name!r} (bump|shear|annulus)")
