"""Velocity-block preconditioner matrices for Stokes.

Counterpart of ``spectral_tpu/models/stokes_pc.py``.  The reference
assembles the sparse velocity surrogate ``MatVVPC`` four ways (``-pcvel``,
stokes.C:159-174); this package carries the eta-weighted
finite-difference Laplacian (StokesPCSetUp0, stokes.C:1159-1241), with the
one-sided rows of mixed/Neumann nodes, and the nodal Jacobian of
``-pcvel 3`` (StokesPCSetUp3: ``torch.func.jacfwd`` of the nodal residual
where the reference tapes it with CppAD), both as a ``StencilOp`` of
coefficient fields.  The colored probes (``-pcvel 2``) raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import numpy as np
import torch

from spectral_tpu_torch.grid import Grid
from spectral_tpu_torch.ops.stencil import StencilOp, _bcast_axis, anisotropic_fd_stencil, shift


def _curvilinear(name: str):
    return NotImplementedError(f"{name}: curved domains are not ported yet "
                               "(ROADMAP.md queue 1, item 6: curvilinear)")


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
    coincide on flat domains).  Runs in eta's dtype on eta's device; the
    curved-domain arguments (``caxes``, ``row_scale``, ``nscale``) raise."""
    if caxes is not None or row_scale is not None or nscale is not None:
        raise _curvilinear("velocity_fd_stencil(caxes/row_scale/nscale)")
    d = grid.ndim
    S = anisotropic_fd_stencil(grid, [eta] * d)
    if nm_mask is None or normal is None:
        return S
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
    Runs in eta's dtype on eta's device; ``caxes``/``row_scale`` (curved
    domains) raise."""
    if caxes is not None or row_scale is not None:
        raise _curvilinear("nodal_jacfwd_stencil(caxes/row_scale)")
    d = grid.ndim
    dtype, device = eta.dtype, eta.device
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
    etaM = [0.5 * (shift(eta, ax, -1) + eta) for ax in range(d)]
    etaP = [0.5 * (shift(eta, ax, +1) + eta) for ax in range(d)]

    def nodal_residual(vel, iM, iP, ix, eM, eP):
        """vel: the (2d+1,) neighbourhood [v0, vM_0, vP_0, vM_1, ...];
        the rest: this node's per-axis coefficients."""
        r = 0.0
        for ax in range(d):
            vM_ = iM[ax] * (vel[0] - vel[1 + 2 * ax])
            vP_ = iP[ax] * (vel[2 + 2 * ax] - vel[0])
            r = r - ix[ax] * (eP[ax] * vP_ - eM[ax] * vM_)
        return r   # residual[i] -= idx*(eP*vP - eM*vM), stokes.C:1681

    jac = torch.func.jacfwd(nodal_residual)   # (2d+1,) coefficient row a node
    zero = torch.zeros(2 * d + 1, dtype=dtype, device=device)

    def flat(fs):
        return torch.stack([f.reshape(-1) for f in fs], dim=0)

    rows = torch.func.vmap(lambda *g: jac(zero, *g), in_dims=1)(
        flat(idxM), flat(idxP), flat(idx), flat(etaM), flat(etaP))
    rows = rows.reshape(grid.dims + (2 * d + 1,))
    interior = grid.interior_mask.to(device)
    center = torch.where(interior, rows[..., 0], 1.0)
    lowers = tuple(torch.where(interior & shift(interior, ax, -1), rows[..., 1 + 2 * ax], 0.0)
                   for ax in range(d))
    uppers = tuple(torch.where(interior & shift(interior, ax, +1), rows[..., 2 + 2 * ax], 0.0)
                   for ax in range(d))
    return StencilOp(center, lowers, uppers)


def _unported(name: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported yet (ROADMAP.md queue 1, item 3d: probed PCs)")

    fn.__name__ = name
    return fn


colored_probe_stencil = _unported("colored_probe_stencil")
colored_probe_stencil_full = _unported("colored_probe_stencil_full")
