"""The flagship's forward step, the counterpart of ``__graft_entry__.py::entry``.

    from spectral_tpu_torch.graft_entry import entry
    forward, (x,) = entry()          # 32^3 on the CUDA device
    out = forward(x)                 # {"F": residual, "JF": J(x) F}

The step is the Stokes saddle-point model's hot compute path: the
nonlinear residual (the strain tensor by Chebyshev derivatives, the
power-law rheology, the viscous, pressure and divergence blocks) and one
Jacobian action, in float64 unless asked otherwise.  The JAX package's
multi-chip dry run has no counterpart here: the port's mesh is
``torch.distributed`` processes (``parallel/``), which ``chip_smoke.py``
phase 17 drives through the sharded Newton solve.
"""

from __future__ import annotations

import torch


def entry(dims: tuple[int, ...] = (32, 32, 32), device: torch.device | str | None = None,
          dtype: torch.dtype = torch.float64):
    """(forward, example_args) at ``dims`` on ``device`` (default: CUDA,
    which must be available; pass "cpu" for the host), in ``dtype``."""
    from spectral_tpu_torch.grid import Grid
    from spectral_tpu_torch.models.stokes import StokesConfig, StokesProblem

    cfg = StokesConfig(exact=2, rheology=1, exponent=3.0, regularization=1e-2)
    p = StokesProblem(Grid(tuple(dims), device=device or "cuda", dtype=dtype), cfg)
    residual = p.make_residual(p.params_at(cfg.cont))

    def forward(x):
        F, lin_state = residual(x)
        return {"F": F, "JF": p.jacobian_action(x, lin_state, F)}

    return forward, (p.zero_state(),)
