"""Debug and fail-fast facilities.

Counterpart of ``spectral_tpu/utils/debug.py``.  The reference guards
correctness with CHKERRQ chains and SETERRQ input validation (SURVEY.md
section 5.2).  What remains to catch here is NaN propagation and silent
divergence:

- ``enable_fail_fast()`` raises at the first operation that produces a NaN
  (the JAX package's ``jax_debug_nans``);
- every solver returns a ConvergedReason and never raises on divergence
  (SNESGetConvergedReason, elliptic.C:223-226);
- ``check_finite`` checks an invariant explicitly at a layer boundary.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from spectral_tpu_torch.utils.tree import leaves, leaves_with_path

# operators whose output is uninitialized memory, which may hold NaN bits
_UNINITIALIZED = ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided")


class _NanCheck(TorchDispatchMode):
    """Checks the floating outputs of every operator, as it returns."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in _UNINITIALIZED:
            return out
        for t in leaves(out if isinstance(out, (tuple, list)) else [out]):
            if (isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex())
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(
                    f"invalid value (nan) encountered in {func.overloadpacket.__name__}")
        return out


_mode: _NanCheck | None = None


def enable_fail_fast(debug_nans: bool = True) -> None:
    """With ``debug_nans``, every operator of this thread raises
    FloatingPointError, naming itself, when an output holds a NaN;
    ``False`` turns the check off.  ``torch.autograd.set_detect_anomaly``
    covers the backward pass only; this covers every operator, forward and
    backward.  It reads every output on the host, so on a CUDA device it
    synchronizes after every operator, as ``jax_debug_nans`` does: a
    debugging aid, never a production setting."""
    global _mode
    if debug_nans and _mode is None:
        _mode = _NanCheck()
        _mode.__enter__()
    elif not debug_nans and _mode is not None:
        _mode.__exit__(None, None, None)
        _mode = None


def check_finite(tree, where: str = "") -> None:
    """Host-side invariant check (use sparingly; it synchronizes): raises
    FloatingPointError naming the first leaf, by its path, that holds a
    non-finite value."""
    for path, leaf in leaves_with_path(tree):
        if not bool(torch.isfinite(torch.as_tensor(leaf)).all()):
            raise FloatingPointError(f"non-finite values at {where}{path}")
