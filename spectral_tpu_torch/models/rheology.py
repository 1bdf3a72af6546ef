"""Rheology models: effective viscosity eta(gamma) and its derivative.

Counterpart of ``spectral_tpu/models/rheology.py`` (StokesRheologyLinear /
StokesRheologyPower, stokes.C:1919-1944, selected by ``-rheology``).  Each
rheology is a vectorized function of the strain-rate second invariant
gamma in gamma's dtype.  Parameters are Python floats, which never promote
a tensor, so a float32 path stays float32 and a float64 path float64; or
0-d tensors (the adjoint tier differentiates with respect to them), which
do not promote a gamma of the same kind either.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.utils._pytree as pytree


@dataclasses.dataclass(frozen=True)
class PowerLawParams:
    """-hardness / -exponent / -eps / -gamma0 (stokes.C:413-416).

    A registered pytree, so ``torch.func`` can differentiate with respect
    to it and return a gradient of the same structure: fields may be floats
    or 0-d tensors."""

    hardness: float = 1.0
    exponent: float = 1.0
    regularization: float = 1.0  # -eps
    gamma0: float = 1.0


pytree.register_dataclass(PowerLawParams)


def rheology_linear(gamma: torch.Tensor, params: PowerLawParams):
    """eta = 1, eta' = 0 (stokes.C:1919-1926)."""
    return torch.ones_like(gamma), torch.zeros_like(gamma)


def rheology_power(gamma: torch.Tensor, params: PowerLawParams):
    """eta = hardness * (eps + gamma/gamma0)^((1-n)/(2n)), analytic eta'
    (stokes.C:1929-1944)."""
    if not any(isinstance(getattr(params, f.name), torch.Tensor)
               for f in dataclasses.fields(params)):
        n = float(params.exponent)
        base = float(params.regularization) + gamma / float(params.gamma0)
        p = (1.0 - n) / (2.0 * n)
        eta = float(params.hardness) * base**p
        if abs(n) <= 1e-5:             # degenerate-exponent guard
            return eta, torch.zeros_like(gamma)
        deta = float(params.hardness) * p / float(params.gamma0) * base ** (p - 1.0)
        return eta, deta
    # tensor parameters: a safe where, so a degenerate exponent gives
    # deta = 0 instead of inf/NaN (and a finite gradient)
    n = params.exponent
    if not isinstance(n, torch.Tensor):
        n = torch.tensor(float(n), dtype=torch.float64, device=gamma.device)
    base = params.regularization + gamma / params.gamma0
    ok = torch.abs(n) > 1e-5
    n_safe = torch.where(ok, n, 1.0)
    p = (1.0 - n_safe) / (2.0 * n_safe)
    eta = params.hardness * base**p
    deta = torch.where(ok, params.hardness * p / params.gamma0 * base ** (p - 1.0), 0.0)
    return eta, deta


RHEOLOGIES = {0: rheology_linear, 1: rheology_power,
              "linear": rheology_linear, "power": rheology_power}
