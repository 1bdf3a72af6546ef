"""Solver-tuning tour on one nonlinear elliptic problem: Eisenstat-Walker
forcing, multigrid cycle strength, grid sequencing and condition
estimates.

Counterpart of ``examples/solver_tuning_demo.py``, in float64 (the tour
compares solver behaviour at rtol 1e-10).  Each section prints an A/B so
the effect of one knob shows in isolation, and checks it.

    python -m spectral_tpu_torch.examples.solver_tuning_demo [-n 24] [-device cuda|cpu]

Exit code 0 when every section's check holds, 2 when one does not.
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    import numpy as np
    import torch

    from spectral_tpu_torch.cli.main import _setup
    from spectral_tpu_torch.grid import Grid
    from spectral_tpu_torch.models.elliptic import EllipticModel
    from spectral_tpu_torch.ops.chebyshev import cheb_regrid
    from spectral_tpu_torch.solvers.krylov import KSPConfig, extreme_singular_values
    from spectral_tpu_torch.solvers.newton import NewtonConfig
    from spectral_tpu_torch.utils.options import Options

    opts = Options(argv if argv is not None else sys.argv[1:])
    device, _ = _setup(opts)
    n = opts.get_int("n", 24)
    ksp = KSPConfig(type="fgmres", rtol=1e-10, max_it=300)
    failed = []

    def check(cond: bool, what: str) -> None:
        if not cond:
            failed.append(what)

    def solve(model, b, d, newton, pc, x0=None):
        res = model.solve(b, d, x0, ksp=ksp, newton=newton, pc_type=pc)
        check(int(res.reason) > 0, f"{pc}: {res.reason_str()}")
        return res

    def model_at(dims):   # eta(u) = 1 + u^2
        return EllipticModel(Grid(dims, device=device, dtype=torch.float64), gamma=1.0,
                             exponent=2.0)

    m = model_at((n, n))
    u, b, d = m.setup_problem(exact=0, cos_scale=1.0)

    # 1) Eisenstat-Walker forcing: the same Newton path, far fewer Krylov iterations
    tight = solve(m, b, d, NewtonConfig(rtol=1e-10), "mg")
    ew = solve(m, b, d, NewtonConfig(rtol=1e-10, ksp_ew=True), "mg")
    print(f"[1] forcing      tight: {int(tight.iters)} Newton / "
          f"{sum(tight.ksp_iters)} Krylov   EW: {int(ew.iters)} / {sum(ew.ksp_iters)}")
    check(sum(ew.ksp_iters) < sum(tight.ksp_iters), "[1] EW saves no Krylov iteration")

    # 2) multigrid cycle strength: mg1 (one V-cycle) and mg2 (the default)
    #    against the assembled-LU floor
    lu = solve(m, b, d, NewtonConfig(rtol=1e-10), "lu")
    mg1 = solve(m, b, d, NewtonConfig(rtol=1e-10), "mg1")
    print(f"[2] PC strength  LU: {sum(lu.ksp_iters)} Krylov   mg1: "
          f"{sum(mg1.ksp_iters)}   mg2: {sum(tight.ksp_iters)}")
    check(sum(tight.ksp_iters) <= 1.2 * sum(lu.ksp_iters), "[2] mg2 over 1.2x LU")

    # 3) grid sequencing: a warm start from the regridded half-size solution
    nc = n // 2
    mc = model_at((nc, nc))
    _, bc, dc = mc.setup_problem(exact=0, cos_scale=1.0)
    rc = solve(mc, bc, dc, NewtonConfig(rtol=1e-10), "mg")
    x0 = m.grid.zero_boundary(cheb_regrid(mc.grid.set_boundary(rc.x, dc), (n, n)))
    warm = solve(m, b, d, NewtonConfig(rtol=1e-10), "mg", x0=x0)
    print(f"[3] sequencing   cold: {int(tight.iters)} Newton / "
          f"{sum(tight.ksp_iters)} Krylov   warm: {int(warm.iters)} / {sum(warm.ksp_iters)}")
    check(int(warm.iters) < int(tight.iters), "[3] the warm start saves no Newton step")

    # 4) the condition estimate of the preconditioned Jacobian at the solution
    #    (KSPComputeExtremeSingularValues): a strong PC keeps it near 1.  The
    #    probe lies in the interior: boundary rows are the operator's null
    #    space on full-grid vectors, where a full-grid probe reports smin = 0
    F, lin = m.make_residual(b, d)(tight.x)
    pcs, pca = m.make_pc("mg")
    st = pcs(tight.x, lin)
    probe = m.grid.zero_boundary(torch.ones(m.grid.dims, dtype=torch.float64, device=device))
    smax, smin = extreme_singular_values(lambda w: m.jacobian_action(tight.x, lin, w), probe,
                                         m=30, M=lambda r: pca(st, r))
    print(f"[4] conditioning sigma_max {smax:.3f}  sigma_min {smin:.3f}  "
          f"cond {smax / smin:.2f} (preconditioned)")
    check(smax / smin < 50, "[4] condition number over 50")

    err = float(torch.max(torch.abs(ew.x - u)))
    print(f"solution error {err:.2e}")
    check(bool(np.isfinite(err)) and err < 1e-8, "solution error over 1e-8")
    print("solver_tuning_demo OK" if not failed else f"solver_tuning_demo FAILED: {failed}")
    return 0 if not failed else 2


if __name__ == "__main__":
    raise SystemExit(main())
