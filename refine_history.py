#!/usr/bin/env python3
"""Defect-correction histories of the JAX package and the port, side by
side, on the CPU: the elliptic32 and elliptic5d configurations of
``bench.py`` (float32 Newton, then float64 residuals with float32 linear
solves; x64 off, as the bench runs).

    JAX_PLATFORMS=cpu python3 refine_history.py [--only 32|5d]

For each package it prints one JSON line: the float32 Newton count and
Krylov counts, and for every refinement iterate k (``max_refine=k``, so
each iterate comes from the public ``solve_refined``) the relative
residual ||F(x_k)|| / ||b|| and the max error |x_k - u|.  The ratio
error / relative residual is what a gate on the error may assume at a
given residual tolerance.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

CONFIGS = {
    "32": dict(dims=(32, 32, 32), gamma=1.0, exact=0, pc_type="mg3", ew=True),
    "5d": dict(dims=(12,) * 5, gamma=0.0, exact=2, pc_type="fastdiag", ew=False),
}
STEPS = 4   # refinement iterates 0..STEPS


def history(model, cfg, newton_config) -> dict:
    u, b, d = model.setup_problem_np(exact=cfg["exact"])
    kw = dict(rtol=0.0, pc_type=cfg["pc_type"])
    if newton_config is not None:
        kw["newton"] = newton_config
    rows, head = [], None
    for k in range(STEPS + 1):
        x, info = model.solve_refined(b, d, max_refine=k, **kw)
        res32 = info["newton32"]
        head = {"newton": int(res32.iters), "krylov": [int(i) for i in res32.ksp_iters]}
        rows.append({"k": k, "rel_residual": info["rel_residual"],
                     "error": float(np.max(np.abs(np.asarray(x) - u))),
                     "inner_iters": info["refine_inner_iters"]})
    return {**head, "iterates": rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=sorted(CONFIGS))
    args = ap.parse_args()

    import jax

    jax.config.update("jax_enable_x64", False)
    from spectral_tpu.grid import Grid as JGrid
    from spectral_tpu.models.elliptic import EllipticModel as JElliptic
    from spectral_tpu.solvers.newton import NewtonConfig as JNewtonConfig
    from spectral_tpu_torch.grid import Grid
    from spectral_tpu_torch.models.elliptic import EllipticModel
    from spectral_tpu_torch.solvers.newton import NewtonConfig

    ew = dict(rtol=3e-5, max_it=30, ksp_ew=True, ew_etamax=0.5, pc_lag=2)
    for name, cfg in CONFIGS.items():
        if args.only and name != args.only:
            continue
        sides = {
            "jax": (JElliptic(JGrid(cfg["dims"]), gamma=cfg["gamma"]),
                    JNewtonConfig(**ew) if cfg["ew"] else None),
            "port": (EllipticModel(Grid(cfg["dims"], device="cpu"), gamma=cfg["gamma"]),
                     NewtonConfig(**ew) if cfg["ew"] else None),
        }
        for side, (model, nc) in sides.items():
            print(json.dumps({"config": name, "package": side,
                              **history(model, cfg, nc)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
