"""ASCII grid printers: debug output as the reference prints it.

Counterpart of ``spectral_tpu/utils/printing.py``.  ``vec_print2`` mirrors
VecPrint2 (elliptic.C:681-698): a field printed as an oriented 2-D grid,
columns running from high x-index to low (x = +1 sits at index 0, so +x
reads to the right).
"""

from __future__ import annotations

import numpy as np


def vec_print2(v, m: int, n: int, name: str, components: str = "", file=None) -> None:
    """Print the leading (m, n[, F]) block of ``v`` (numpy or a CPU tensor)
    like VecPrint2."""
    x = np.asarray(v)
    if x.ndim == 2:
        x = x[..., None]
    F = x.shape[-1]
    comp = components or "?" * F
    lines = []
    for f in range(F):
        for j in range(n):
            row = "".join(f"{x[i, j, f]:12.3e}" for i in range(m - 1, -1, -1))
            lines.append(f"{name:>14s} {comp[f]}: {row}")
        if f < F - 1:
            lines.append("-----------")
    print("\n".join(lines), file=file)
