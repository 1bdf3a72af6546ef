"""spectral-tpu on PyTorch: the Chebyshev spectral-collocation Poisson path
on an NVIDIA GPU, with hand-written CUDA kernels for its two hot transforms.

The package mirrors the layout of ``spectral_tpu`` (``grid.py``, ``ops/``,
``solvers/``, ``models/``, ``utils/``, ``cli/``), so the counterpart of
each JAX module is found by its path.  It imports ``torch`` and never
``jax``.

Precision policy (the analogue of ``Precision.HIGHEST`` everywhere in the
JAX package): float32 matrix products and convolutions run in full IEEE
float32, never TF32.  TF32 keeps about three decimal digits, which would
put a floor on the spectral accuracy the method exists for.  The policy is
set once, here, when the package is imported.

The package exports the JAX package's names (``__all__``), the classes
among them imported at first use.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from spectral_tpu_torch.ops.chebyshev import cgl_nodes, chebdiff, diffmat  # noqa: E402

__version__ = "0.1.0"

# the JAX package's exports, by the same names
__all__ = ["cgl_nodes", "chebdiff", "diffmat", "Grid", "PoissonModel",
           "EllipticModel", "StokesProblem", "StokesConfig", "HeatModel", "UnsteadyStokes",
           "ConvectionModel", "ConvectionConfig",
           "CurvilinearPoisson", "CurvilinearMap", "named_map", "cheb_regrid",
           "KSPConfig", "NewtonConfig", "block_gmres", "implicit_gradient",
           "implicit_hvp", "extreme_singular_values",
           "TSConfig", "integrate_adaptive", "rollout_bdf2",
           "pseudo_transient_solve",
           "OptimizeConfig", "lbfgs_minimize", "newton_cg_minimize",
           "__version__"]

_LAZY = {
    "Grid": ("spectral_tpu_torch.grid", "Grid"),
    "PoissonModel": ("spectral_tpu_torch.models.poisson", "PoissonModel"),
    "EllipticModel": ("spectral_tpu_torch.models.elliptic", "EllipticModel"),
    "StokesProblem": ("spectral_tpu_torch.models.stokes", "StokesProblem"),
    "StokesConfig": ("spectral_tpu_torch.models.stokes", "StokesConfig"),
    "HeatModel": ("spectral_tpu_torch.models.heat", "HeatModel"),
    "UnsteadyStokes": ("spectral_tpu_torch.models.stokes_unsteady", "UnsteadyStokes"),
    "ConvectionModel": ("spectral_tpu_torch.models.convection", "ConvectionModel"),
    "ConvectionConfig": ("spectral_tpu_torch.models.convection", "ConvectionConfig"),
    "CurvilinearPoisson": ("spectral_tpu_torch.models.curvilinear", "CurvilinearPoisson"),
    "CurvilinearMap": ("spectral_tpu_torch.ops.curvilinear", "CurvilinearMap"),
    "named_map": ("spectral_tpu_torch.ops.curvilinear", "named_map"),
    "cheb_regrid": ("spectral_tpu_torch.ops.chebyshev", "cheb_regrid"),
    "KSPConfig": ("spectral_tpu_torch.solvers.krylov", "KSPConfig"),
    "NewtonConfig": ("spectral_tpu_torch.solvers.newton", "NewtonConfig"),
    "block_gmres": ("spectral_tpu_torch.solvers.krylov", "block_gmres"),
    "implicit_gradient": ("spectral_tpu_torch.solvers.adjoint", "implicit_gradient"),
    "implicit_hvp": ("spectral_tpu_torch.solvers.adjoint", "implicit_hvp"),
    "extreme_singular_values": ("spectral_tpu_torch.solvers.krylov",
                                "extreme_singular_values"),
    "TSConfig": ("spectral_tpu_torch.solvers.ts", "TSConfig"),
    "integrate_adaptive": ("spectral_tpu_torch.solvers.ts", "integrate_adaptive"),
    "rollout_bdf2": ("spectral_tpu_torch.solvers.ts", "rollout_bdf2"),
    "pseudo_transient_solve": ("spectral_tpu_torch.solvers.ts", "pseudo_transient_solve"),
    "OptimizeConfig": ("spectral_tpu_torch.solvers.optimize", "OptimizeConfig"),
    "lbfgs_minimize": ("spectral_tpu_torch.solvers.optimize", "lbfgs_minimize"),
    "newton_cg_minimize": ("spectral_tpu_torch.solvers.optimize", "newton_cg_minimize"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'spectral_tpu_torch' has no attribute {name!r}")
