"""Velocity-block preconditioner matrices for Stokes.

Counterpart of ``spectral_tpu/models/stokes_pc.py``.  The reference
assembles the sparse velocity surrogate ``MatVVPC`` four ways (``-pcvel``,
stokes.C:159-174); this package carries the eta-weighted
finite-difference Laplacian (StokesPCSetUp0, stokes.C:1159-1241), with the
one-sided rows of mixed/Neumann nodes, and the nodal Jacobian of
``-pcvel 3`` (StokesPCSetUp3: ``torch.func.jacfwd`` of the nodal residual
where the reference tapes it with CppAD), both as a ``StencilOp`` of
coefficient fields, and the colored probes of ``-pcvel 2`` (StokesPCSetUp2)
that extract a stencil from the matrix-free velocity block.
"""

from __future__ import annotations

import itertools
from typing import Callable

import numpy as np
import torch

from spectral_tpu_torch.grid import Grid
from spectral_tpu_torch.ops.stencil import StencilOp, _bcast_axis, anisotropic_fd_stencil, shift


def velocity_fd_stencil(grid: Grid, eta: torch.Tensor, *,
                        scaleN: float = 1.0,
                        nm_mask: torch.Tensor | None = None,
                        nm_onehot: torch.Tensor | None = None,
                        normal: torch.Tensor | None = None,
                        alpha: torch.Tensor | None = None,
                        caxes=None, row_scale=None,
                        nscale: torch.Tensor | None = None,
                        ref_normal: torch.Tensor | None = None) -> StencilOp:
    """StokesPCSetUp0 (stokes.C:1159-1241): component-decoupled
    eta-weighted FD Laplacian with arithmetic-mean midpoint coefficients;
    mixed/Neumann rows (``nm_mask``, principal axis ``nm_onehot``) become
    one-sided differences toward the inward neighbour along that axis,
    scaled by scaleN (plus ``alpha`` on the diagonal for sliding).
    ``ref_normal`` picks the inward side (defaults to ``normal``; the two
    coincide on flat domains; on a curved domain it is the reference
    cube's normal: the inward neighbour is a fact of the grid's topology).
    Runs in eta's dtype on eta's device.

    Curved domains: ``caxes`` / ``row_scale`` switch the interior rows to
    the anisotropic metric coefficients eta * A_ll with the 1/detJ row
    scale, and ``nscale`` (per node) scales the one-sided traction rows by
    |(Jinv n)_ax|, the physical normal derivative pulled back to the
    principal reference axis."""
    d = grid.ndim
    S = anisotropic_fd_stencil(grid, caxes if caxes is not None else [eta] * d,
                               row_scale=row_scale)
    if nm_mask is None or normal is None:
        return S
    if nscale is not None:
        eta = eta * nscale   # scales only the one-sided traction rows below
    dtype, device = eta.dtype, eta.device
    if ref_normal is None:
        ref_normal = normal
    center = S.center
    lowers, uppers = list(S.lower), list(S.upper)
    for ax in range(d):
        z = grid.nodes_1d[ax]
        inv_p = np.zeros(len(z))   # 1/(z_i - z_{i+1}): step toward +index
        inv_m = np.zeros(len(z))
        inv_p[:-1] = 1.0 / (z[:-1] - z[1:])
        inv_m[1:] = 1.0 / (z[1:] - z[:-1])
        inv_p = torch.as_tensor(_bcast_axis(inv_p, ax, d), dtype=dtype, device=device)
        inv_m = torch.as_tensor(_bcast_axis(inv_m, ax, d), dtype=dtype, device=device)
        on_ax = nm_mask & (nm_onehot[..., ax] > 0)
        # normal > 0 <-> index-0 face <-> inward neighbour at +1 index
        sel_p = on_ax & (ref_normal[..., ax] > 0)
        sel_m = on_ax & (ref_normal[..., ax] < 0)
        diag_row = scaleN * eta * torch.where(sel_p, inv_p, inv_m)
        if alpha is not None:
            diag_row = diag_row + alpha
        center = torch.where(sel_p | sel_m, diag_row, center)
        uppers[ax] = torch.where(sel_p, -scaleN * eta * inv_p, uppers[ax])
        lowers[ax] = torch.where(sel_m, -scaleN * eta * inv_m, lowers[ax])
        # a mixed row couples only along its principal axis
        for ax2 in range(d):
            if ax2 != ax:
                lowers[ax2] = torch.where(on_ax, 0.0, lowers[ax2])
                uppers[ax2] = torch.where(on_ax, 0.0, uppers[ax2])
        uppers[ax] = torch.where(sel_m, 0.0, uppers[ax])
        lowers[ax] = torch.where(sel_p, 0.0, lowers[ax])
    return StencilOp(center, tuple(lowers), tuple(uppers))


def nodal_jacfwd_stencil(grid: Grid, eta: torch.Tensor, *,
                         caxes=None, row_scale=None) -> StencilOp:
    """StokesPCSetUp3 (stokes.C:1601-1708, QUALITY=2): the per-node
    Jacobian of the eta-weighted flux-form FD residual on the (2d+1)-point
    neighbourhood [center, (minus, plus) per axis], by
    ``torch.func.jacfwd`` under ``torch.func.vmap`` over the nodes.  Its
    rows are the stencil coefficients, so it equals velocity_fd_stencil.
    Runs in eta's dtype on eta's device.  ``caxes`` (per-axis coefficient
    fields, eta * A_ll on a curved domain) and ``row_scale`` (1/detJ) make
    it the nodal residual of the anisotropic metric form (the curved
    -pcvel 3)."""
    d = grid.ndim
    dtype, device = eta.dtype, eta.device
    if caxes is None:
        caxes = [eta] * d
    idxM, idxP, idx = [], [], []
    for ax in range(d):
        z = grid.nodes_1d[ax]
        n = len(z)
        a, b, c = np.zeros(n), np.zeros(n), np.zeros(n)
        a[1:-1] = 1.0 / (z[1:-1] - z[:-2])
        b[1:-1] = 1.0 / (z[2:] - z[1:-1])
        c[1:-1] = 2.0 / (z[2:] - z[:-2])
        for out, v in ((idxM, a), (idxP, b), (idx, c)):
            out.append(torch.as_tensor(np.broadcast_to(_bcast_axis(v, ax, d), grid.dims).copy(),
                                       dtype=dtype, device=device))
    etaM = [0.5 * (shift(caxes[ax], ax, -1) + caxes[ax]) for ax in range(d)]
    etaP = [0.5 * (shift(caxes[ax], ax, +1) + caxes[ax]) for ax in range(d)]
    rs = (torch.ones(grid.dims, dtype=dtype, device=device) if row_scale is None
          else row_scale.to(dtype))

    def nodal_residual(vel, iM, iP, ix, eM, eP, rs):
        """vel: the (2d+1,) neighbourhood [v0, vM_0, vP_0, vM_1, ...];
        the rest: this node's per-axis coefficients and row scale."""
        r = 0.0
        for ax in range(d):
            vM_ = iM[ax] * (vel[0] - vel[1 + 2 * ax])
            vP_ = iP[ax] * (vel[2 + 2 * ax] - vel[0])
            r = r - ix[ax] * (eP[ax] * vP_ - eM[ax] * vM_)
        return rs * r   # residual[i] -= idx*(eP*vP - eM*vM), stokes.C:1681

    jac = torch.func.jacfwd(nodal_residual)   # (2d+1,) coefficient row a node
    zero = torch.zeros(2 * d + 1, dtype=dtype, device=device)

    def flat(fs):
        return torch.stack([f.reshape(-1) for f in fs], dim=0)

    rows = torch.func.vmap(lambda *g: jac(zero, *g), in_dims=(1, 1, 1, 1, 1, 0))(
        flat(idxM), flat(idxP), flat(idx), flat(etaM), flat(etaP), rs.reshape(-1))
    rows = rows.reshape(grid.dims + (2 * d + 1,))
    interior = grid.interior_mask.to(device)
    center = torch.where(interior, rows[..., 0], 1.0)
    lowers = tuple(torch.where(interior & shift(interior, ax, -1), rows[..., 1 + 2 * ax], 0.0)
                   for ax in range(d))
    uppers = tuple(torch.where(interior & shift(interior, ax, +1), rows[..., 2 + 2 * ax], 0.0)
                   for ax in range(d))
    return StencilOp(center, lowers, uppers)


def colored_probe_stencil(matvec: Callable, grid: Grid,
                          dtype: torch.dtype | None = None) -> StencilOp:
    """StokesPCSetUp2 replacement: the (2d+1)-point stencil of a
    matrix-free operator, probed with striped (colored) basis vectors in
    ``dtype`` (default: the grid's) on the grid's device, the MatFDColoring
    analog (stokes.C:1503-1507) with exact matvecs instead of finite
    differences.  Distance-2 striping per axis (3^d colors) isolates each
    node's row.  As the reference documents (README:60-61), subsampling
    the spectral matrix this way is a poor preconditioner; it is kept for
    parity and as a validation tool."""
    d = grid.ndim
    dims = grid.dims
    dtype = dtype or grid.dtype
    dev = grid.device
    idx = np.indices(dims)
    color = sum(idx[ax] % 3 * 3**ax for ax in range(d))
    cols = [matvec(torch.as_tensor(color == c, dtype=dtype, device=dev))
            for c in range(3**d)]

    def coef(offset_ax: int | None, s: int) -> torch.Tensor:
        """A[r, r + o] sits in the probe of color(r + o), at row r."""
        shifted = color if offset_ax is None else np.roll(color, -s, axis=offset_ax)
        out = torch.zeros(dims, dtype=cols[0].dtype, device=dev)
        for c, col in enumerate(cols):
            out = torch.where(torch.as_tensor(shifted == c, device=dev), col, out)
        return out

    interior = grid.interior_mask.to(dev)
    lowers = tuple(torch.where(interior & shift(interior, ax, -1), coef(ax, -1), 0.0)
                   for ax in range(d))
    uppers = tuple(torch.where(interior & shift(interior, ax, +1), coef(ax, +1), 0.0)
                   for ax in range(d))
    return StencilOp(torch.where(interior, coef(None, 0), 1.0), lowers, uppers)


def colored_probe_stencil_full(matvec: Callable, grid: Grid, vel_mask: torch.Tensor,
                               dtype: torch.dtype | None = None):
    """StokesPCSetUp2 with the upstream sparsity pattern (stokes.C:1477-1497):
    per velocity row, the couplings to all d components at the node itself
    and at its +-1 and +-2 neighbours along every axis, d (4d+1) entries a
    row, probed from the matrix-free VV operator in ``dtype`` (default: the
    grid's).

    Coloring: a stride-5 lattice per axis (5^d colors x d component
    probes; the MatGetColoring/MatFDColoringApply analog,
    stokes.C:1503-1507).  Two nodes of one color differ by >= 5 along some
    axis while every pattern offset is along one axis with |s| <= 2, so
    every response entry is attributable.  Rows and columns at non-free
    dofs are dropped.  Returns the (4d+1)-offset coupled stencil
    (``ops.fem.Q1StrainStencil``)."""
    from spectral_tpu_torch.ops.fem import Q1StrainStencil

    d = grid.ndim
    dims = grid.dims
    dtype = dtype or grid.dtype
    dev = vel_mask.device
    offsets = [(0,) * d]
    for ax in range(d):
        for s in (-1, 1, -2, 2):
            off = [0] * d
            off[ax] = s
            offsets.append(tuple(off))
    idx = np.indices(dims)
    maskf = vel_mask.to(dtype)
    coef = {off: torch.zeros(dims + (d, d), dtype=dtype, device=dev) for off in offsets}
    for cvec in itertools.product(range(5), repeat=d):
        lat = torch.as_tensor(np.all(np.stack([idx[ax] % 5 == cvec[ax] for ax in range(d)]),
                                     axis=0), device=dev)
        for b in range(d):
            v = torch.zeros(dims + (d,), dtype=dtype, device=dev)
            v[..., b] = lat.to(dtype)
            y = matvec(v * maskf)          # non-free columns dropped
            for off in offsets:
                sel = lat                  # the rows whose probed column is n + off
                for ax, o in enumerate(off):
                    if o:
                        sel = shift(sel, ax, o)
                C = coef[off]
                C[..., :, b] = torch.where(sel[..., None], y, C[..., :, b])
    return Q1StrainStencil(offsets=tuple(offsets),
                           coef=tuple(coef[o] * maskf[..., :, None] for o in offsets))
