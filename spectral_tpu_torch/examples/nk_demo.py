"""Didactic example: matrix-free Newton-Krylov with separate Jacobian and PC.

Counterpart of ``examples/nk_demo.py``, the analog of the reference's nk.c:
the 1-D problem u'' + u^2 = f with different operators for the Jacobian
(tridiagonal; with ``-snes_mf`` a jvp) and the preconditioner (its diagonal
only, nk.c:264-268), a user line search, and the residual history
(-rhistory, nk.c:129-170).

    python -m spectral_tpu_torch.examples.nk_demo [-n 32] [-snes_mf] [-user_precond]
        [-user_linesearch] [-rhistory] [-device cuda|cpu]

Exit code 0 when Newton converged to u = x^3 (within 1e-3), 2 when not.
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    import numpy as np
    import torch

    from spectral_tpu_torch.cli.main import _setup
    from spectral_tpu_torch.solvers.krylov import KSPConfig
    from spectral_tpu_torch.solvers.newton import NewtonConfig, newton_solve
    from spectral_tpu_torch.utils.options import Options

    opts = Options(argv if argv is not None else sys.argv[1:])
    device, dtype = _setup(opts)
    n = opts.get_int("n", 32)
    use_mf = opts.has("snes_mf")          # JFNK by jvp (the -snes_mf analog)
    user_pc = opts.has("user_precond")
    rhistory = opts.has("rhistory")

    xg = np.linspace(0.0, 1.0, n)
    f = torch.as_tensor(6.0 * xg + (xg + 1e-12) ** 6, dtype=dtype, device=device)  # nk.c:144-149
    d = float((n - 1) ** 2)
    one = torch.ones(1, dtype=dtype, device=device)

    def residual(u):
        interior = d * (u[:-2] - 2.0 * u[1:-1] + u[2:]) + u[1:-1] ** 2 - f[1:-1]
        F = torch.cat([u[:1], interior, u[-1:] - 1.0])
        diag = torch.cat([one, -2.0 * d + 2.0 * u[1:-1], one])
        return F, diag

    jac = None
    if not use_mf:
        def jac(u, lin_state, w):  # the explicit tridiagonal Jacobian (nk.c:264-268)
            interior = d * (w[:-2] - 2.0 * w[1:-1] + w[2:]) + 2.0 * u[1:-1] * w[1:-1]
            return torch.cat([w[:1], interior, w[-1:]])

    pc_setup = pc_apply = None
    if user_pc:
        pc_setup = lambda x, lin: lin            # noqa: E731
        pc_apply = lambda diag, r: r / diag      # noqa: E731

    line_search = "bt"
    if opts.has("user_linesearch"):
        # the user line-search hook (FormLineSearch, nk.c:185-200): a full
        # step, always accepted, with its own norm bookkeeping
        def line_search(residual_fn, x, dx, fnorm):
            xn = x - dx
            Fn, lst = residual_fn(xn)
            fnn = float(torch.linalg.vector_norm(Fn))
            return xn, Fn, lst, fnn, bool(np.isfinite(fnn))

    rtol = 1e-10 if dtype == torch.float64 else 1e-5
    res = newton_solve(
        residual, torch.full((n,), 0.5, dtype=dtype, device=device), jacobian_action=jac,
        pc_setup=pc_setup, pc_apply=pc_apply,
        ksp=KSPConfig(type="gmres", rtol=rtol, max_it=500),
        config=NewtonConfig(rtol=rtol, max_it=20, line_search=line_search))
    print(f"Newton iterations = {res.iters} ({res.reason_str()})")
    err = float(torch.max(torch.abs(res.x - torch.as_tensor(xg ** 3, dtype=dtype,
                                                             device=device))))
    print(f"max error vs u=x^3: {err:.2e}")
    if rhistory:
        print("fnorm history:", ["%.3e" % v for v in res.fnorm_history])
        print("KSP iterations per step:", list(res.ksp_iters))
    return 0 if res.reason > 0 and err < 1e-3 else 2


if __name__ == "__main__":
    raise SystemExit(main())
