"""Solver result types (counterpart of ``spectral_tpu/solvers/types.py``).

Convergence is returned as data the caller inspects, as PETSc's
KSPGetIterationNumber / KSPGetConvergedReason / residual history.
"""

from __future__ import annotations

import dataclasses
import enum

import torch


class ConvergedReason(enum.IntEnum):
    """Subset of PETSc's KSPConvergedReason / SNESConvergedReason codes
    (the same codes as the JAX package)."""

    ITERATING = 0
    CONVERGED_RTOL = 2
    CONVERGED_ATOL = 3
    CONVERGED_ITS = 4
    CONVERGED_SNORM_RELATIVE = 5
    DIVERGED_NULL = -2
    DIVERGED_ITS = -3
    DIVERGED_DTOL = -4
    DIVERGED_NANORINF = -5
    DIVERGED_LINE_SEARCH = -6
    DIVERGED_TR_DELTA = -7
    DIVERGED_INDEFINITE_PC = -8

    @staticmethod
    def describe(code: int) -> str:
        try:
            return ConvergedReason(int(code)).name
        except ValueError:
            return f"UNKNOWN({code})"


@dataclasses.dataclass
class SolveResult:
    """Result of a linear iterative solve.

    Attributes:
      x: solution tensor (on the solve's device, in its dtype).
      iters: total iteration count.
      reason: ConvergedReason code.
      rnorm: final residual norm used by the convergence test.
      history: residual-norm history, fixed length, padded with -1
        (a host tensor in the solve's dtype).
    """

    x: torch.Tensor
    iters: int
    reason: int
    rnorm: float
    history: torch.Tensor

    def reason_str(self) -> str:
        return ConvergedReason.describe(int(self.reason))

    def history_list(self) -> list[float]:
        return [float(v) for v in self.history.tolist() if v >= 0.0]
