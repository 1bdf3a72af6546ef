#!/usr/bin/env python3
"""Time the kernels at the shapes their paths give them, in one checkout.

    python3 k3_sweep.py [ROOT]

Imports spectral_tpu_torch from ROOT (default: this checkout) and builds
its kernels there, so that two commits can be compared on one card in one
session: unpack the other commit into a directory that .gitignore lists
(``git archive <commit> | tar -x -C build/parent``) and run, in turns,
``k3_sweep.py build/parent``, ``k3_sweep.py``, ``k3_sweep.py``,
``k3_sweep.py build/parent``.  Prints the card's name and power limit, then
one JSON line: the checkout and, as [device_ms, call_ms] (chip_smoke.py's
``device_ms`` and ``call_ms``):

- K3's six sweep cases at u of (1,048,576, 64) float32 (phase 5);
- K1 at the shapes the solves give it, at the dense assembly's batch
  (1024, 16, 16, 16) float64 and at (256, 64, 64, 64) float32, and
  ``torch.matmul`` on the same inputs (phase 1); at the solve shapes also
  ``chebyshev.chebdiff`` on the last axis, the route the solves call
  (its checks before K1's launch);
- K2 at 64^3 with the boundary mask in float32 and float64 (phase 2).

Without CUDA it exits non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import chip_smoke

# (shape, dtype name) of K1's timed cases: the solves' shapes, then cheb_matvec's
K1_CASES = (((64, 64, 64), "float64"), ((32, 32, 32), "float32"), ((32, 32, 32), "float64"),
            ((12,) * 5, "float32"), ((12,) * 5, "float64"), ((20, 20, 20), "float64"),
            ((1024, 16, 16, 16), "float64"), ((256, 64, 64, 64), "float32"))


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("k3_sweep: CUDA is not available; this runs on the GPU only", file=sys.stderr)
        return 1
    root = Path(argv[0] if argv else Path(__file__).parent).resolve()
    sys.path.insert(0, str(root))
    from spectral_tpu_torch.grid import Grid
    from spectral_tpu_torch.ops import chebyshev, cuda_cheb

    if not Path(cuda_cheb.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {cuda_cheb.__file__}, not the checkout at {root}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0])
    gen = torch.Generator(device="cuda")

    def randn(shape, dtype, seed):
        gen.manual_seed(seed)
        return torch.randn(shape, generator=gen, device="cuda", dtype=dtype)

    u = randn((1 << 20, 64), torch.float32, 98)
    k3 = {f"pack={p} blk={b}": t for (p, b), t in chip_smoke.k3_sweep_ms(cuda_cheb, u).items()}
    del u
    k1 = {}
    for shape, dname in K1_CASES:
        u = randn(shape, getattr(torch, dname), 0)
        dt = cuda_cheb._diffmat_t(shape[-1], None, u.dtype, u.device)
        k1[f"{shape} {dname}"] = {
            "k1": chip_smoke.both_ms(lambda: cuda_cheb.chebdiff_last(u)),
            "matmul": chip_smoke.both_ms(lambda: torch.matmul(u, dt))}
        if len(shape) < 4:   # a solve's shape: the route it calls
            k1[f"{shape} {dname}"]["chebdiff"] = chip_smoke.both_ms(
                lambda: chebyshev.chebdiff(u, u.ndim - 1))
        del u
    k2 = {}
    mask = Grid((64, 64, 64), device="cuda").boundary_mask
    for dtype in (torch.float32, torch.float64):
        u = randn((64, 64, 64), dtype, 2)
        k2[f"(64, 64, 64) bmask {str(dtype)[6:]}"] = chip_smoke.both_ms(
            lambda: cuda_cheb.laplacian3d(u, mask))
    print(json.dumps({"root": str(root), "device": torch.cuda.get_device_name(0),
                      "k3": k3, "k1": k1, "k2": k2}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
