"""Preconditioner protocol and registry, the counterpart of PETSc's PC.

Counterpart of ``spectral_tpu/solvers/pc.py``.  A preconditioner is a
function ``r -> z`` (PCApply); a *setup* builds it from problem state
(PCSetUp).  The registry keys follow ``-pc_type``:

- "none"   : identity (PCNONE, nk.c:112)
- "jacobi" : diagonal scaling (PCJACOBI; the Schur PC, stokes.C:330-331,
             and the shell PC of shell.c:171-268)
- "shell"  : any user callable (PCSHELL)

The models build their strong PCs (fastdiag, multigrid, the Stokes saddle
tree) themselves; this module only defines the protocol, so the solvers
stay decoupled from the problems.
"""

from __future__ import annotations

from typing import Any, Callable

from spectral_tpu_torch.utils.tree import tree_map

Preconditioner = Callable[[Any], Any]  # r -> z
PCSetup = Callable[..., Preconditioner]

_REGISTRY: dict[str, PCSetup] = {}


def register_pc(name: str, setup: PCSetup) -> None:
    _REGISTRY[name] = setup


def pc_setup(name: str, *args, **kwargs) -> Preconditioner:
    if name not in _REGISTRY:
        raise KeyError(f"unknown pc type {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](*args, **kwargs)


def available_pcs() -> list[str]:
    return sorted(_REGISTRY)


def pc_none() -> Preconditioner:
    return lambda r: r


def pc_jacobi(diag) -> Preconditioner:
    """Diagonal scaling z = r / diag; ``diag`` is a tensor, or a dict (a
    ``{"v", "p"}`` state) or sequence of tensors matching r."""
    return lambda r: tree_map(lambda ri, di: ri / di, r, diag)


def pc_shell(fn: Preconditioner) -> Preconditioner:
    return fn


register_pc("none", lambda *a, **k: pc_none())
register_pc("jacobi", pc_jacobi)
register_pc("shell", pc_shell)
