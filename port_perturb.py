#!/usr/bin/env python3
"""The port's ``stokes`` CLI from perturbed starts: how far its Krylov
counts and error move with the round-off of the start, beside the JAX
package's (``stokes_oracle.py perturb_probed``).

    python3 port_perturb.py [--seeds a-b] [extra CLI options]

README:43 at 20^3 with ``-pcvel 2`` (damped Jacobi on the probed velocity
block) in float64 on the card, from the zero state plus masked normal noise
of 1e-13 (seeds 0-15, or a to b) and of 1e-11 (seed 0), as
``stokes_oracle.py`` perturbs the JAX package's start.  Prints the card's
name and power limit, then one JSON line a run: the Newton and Krylov
counts, the reason and the error (``chip_smoke.parse_cli``).  Extra
options are appended to the command line (``-device cpu -dim 6,6,6`` for a
quick check on the host).
"""

from __future__ import annotations

import json
import subprocess
import sys

from chip_smoke import STOKES_README43, parse_cli, run_cli


def main(argv: list[str]) -> int:
    import numpy as np
    import torch

    from spectral_tpu_torch.cli.main import main as cli_main
    from spectral_tpu_torch.models.stokes import StokesProblem

    seeds = range(16)
    if "--seeds" in argv:
        i = argv.index("--seeds")
        lo, hi = map(int, argv[i + 1].split("-"))
        seeds, argv = range(lo, hi + 1), argv[:i] + argv[i + 2:]
    if "-device" not in argv:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60).stdout.strip(), flush=True)
    orig_zero = StokesProblem.zero_state
    for size, seed in [(1e-13, s) for s in seeds] + [(1e-11, 0)]:
        def zero(self, dtype=None, size=size, seed=seed):
            z = orig_zero(self, dtype)
            noise = np.random.default_rng(seed).standard_normal(tuple(z["v"].shape))
            return {"v": self.mask_v(z["v"] + size * torch.from_numpy(noise).to(z["v"])),
                    "p": z["p"]}

        StokesProblem.zero_state = zero
        try:
            rc, out = run_cli(cli_main, ["stokes", *STOKES_README43, "-pcvel", "2", *argv])
        finally:
            StokesProblem.zero_state = orig_zero
        got = parse_cli(out)
        print(json.dumps({"perturb": size, "seed": seed, "rc": rc, "newton": got.get("newton"),
                          "krylov": got.get("krylov"), "reasons": got["reasons"],
                          "error": got["error"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
