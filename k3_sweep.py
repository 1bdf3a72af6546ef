#!/usr/bin/env python3
"""Time K3's six sweep cases (chip_smoke.py phase 5) in one checkout.

    python3 k3_sweep.py [ROOT]

Imports spectral_tpu_torch from ROOT (default: this checkout) and builds
its kernels there, so that two commits can be compared on one card in one
session: unpack the other commit into a directory that .gitignore lists
(``git archive <commit> | tar -x -C build/parent``) and run, in turns,
``k3_sweep.py build/parent``, ``k3_sweep.py``, ``k3_sweep.py``,
``k3_sweep.py build/parent``.  Prints the card's name and power limit, then
one JSON line: the checkout, and K3's median ms at u of (1,048,576, 64)
float32 for each packing and row tile (CUDA events, as chip_smoke.py
times).  Without CUDA it exits non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import chip_smoke


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("k3_sweep: CUDA is not available; this runs on the GPU only", file=sys.stderr)
        return 1
    root = Path(argv[0] if argv else Path(__file__).parent).resolve()
    sys.path.insert(0, str(root))
    from spectral_tpu_torch.ops import cuda_cheb

    if not Path(cuda_cheb.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {cuda_cheb.__file__}, not the checkout at {root}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(98)
    u = torch.randn((1 << 20, 64), generator=gen, device="cuda")
    ms = chip_smoke.k3_sweep_ms(cuda_cheb, u)
    print(json.dumps({"root": str(root), "device": torch.cuda.get_device_name(0),
                      "ms": {f"pack={p} blk={b}": t for (p, b), t in ms.items()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
