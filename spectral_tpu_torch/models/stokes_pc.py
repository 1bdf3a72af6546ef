"""Velocity-block preconditioner matrices for Stokes.

Counterpart of ``spectral_tpu/models/stokes_pc.py``.  The reference
assembles the sparse velocity surrogate ``MatVVPC`` four ways (``-pcvel``,
stokes.C:159-174); this package carries the default and recommended one,
the eta-weighted finite-difference Laplacian (StokesPCSetUp0,
stokes.C:1159-1241), as a ``StencilOp`` of coefficient fields.  The nodal
Jacobian (``-pcvel 3``) and the colored probes (``-pcvel 2``) raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import torch

from spectral_tpu_torch.grid import Grid
from spectral_tpu_torch.ops.stencil import StencilOp, anisotropic_fd_stencil


def velocity_fd_stencil(grid: Grid, eta: torch.Tensor) -> StencilOp:
    """StokesPCSetUp0 (stokes.C:1159-1241) on all-Dirichlet boundaries:
    component-decoupled eta-weighted FD Laplacian with arithmetic-mean
    midpoint coefficients.  Runs in eta's dtype on eta's device.  The
    one-sided rows at mixed/Neumann nodes wait with the mixed velocity
    PC (ROADMAP.md queue 1, item 3c)."""
    return anisotropic_fd_stencil(grid, [eta] * grid.ndim)


def _unported(name: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported yet (ROADMAP.md queue 1, item 3c)")

    fn.__name__ = name
    return fn


nodal_jacfwd_stencil = _unported("nodal_jacfwd_stencil")
colored_probe_stencil = _unported("colored_probe_stencil")
colored_probe_stencil_full = _unported("colored_probe_stencil_full")
