"""Solver library: Krylov methods, the SNES family, FAS, eigenvalues,
time stepping, adjoints and optimization (the JAX package's exports)."""

from spectral_tpu_torch.solvers.types import ConvergedReason, SolveResult
from spectral_tpu_torch.solvers.adjoint import implicit_gradient, implicit_hvp
from spectral_tpu_torch.solvers.fas import FASSolver
from spectral_tpu_torch.solvers.krylov import (KSPConfig, ksp_solve, gmres, fgmres,
                                               cg, block_gmres, chebyshev, minres)
from spectral_tpu_torch.solvers.eig import EPSResult, eigs, shift_invert
from spectral_tpu_torch.solvers.optimize import (OptimizeConfig, OptimizeResult,
                                                 lbfgs_minimize, newton_cg_minimize)
from spectral_tpu_torch.solvers.ts import (TSConfig, integrate_adaptive,
                                           pseudo_transient_solve, rollout_bdf2)

__all__ = [
    "EPSResult",
    "eigs",
    "shift_invert",
    "OptimizeConfig",
    "OptimizeResult",
    "lbfgs_minimize",
    "newton_cg_minimize",
    "TSConfig",
    "integrate_adaptive",
    "pseudo_transient_solve",
    "rollout_bdf2",
    "implicit_gradient",
    "implicit_hvp",
    "ConvergedReason",
    "SolveResult",
    "KSPConfig",
    "ksp_solve",
    "gmres",
    "fgmres",
    "cg",
    "block_gmres",
    "chebyshev",
    "minres",
    "FASSolver",
]
