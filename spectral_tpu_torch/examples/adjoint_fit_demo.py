"""Demo: parameter estimation by adjoint gradient descent.

Counterpart of ``examples/adjoint_fit_demo.py``.  Recovers the power-law
hardness of a Stokes flow from an observed velocity field: each iterate is
one forward Newton solve and one adjoint solve (``adjoint_gradient``, the
transposed saddle system under the transposed nested PC), which give the
exact gradient of the misfit whatever the number of parameters.  The
default is a secant iteration on dmisfit/dh = 0; ``-opt lbfgs`` runs
``lbfgs_minimize`` over the parameter pytree.  Each forward solve starts
from the last one's state, the observation's included (the JAX demo
starts each from zero): Newton then takes a few steps where it took a
dozen, to the same tolerance, and the misfit and its gradient do not
depend on where Newton started.

    python -m spectral_tpu_torch.examples.adjoint_fit_demo [-n 8] [-steps 6]
        [-opt secant|lbfgs] [-device cuda|cpu] [-f32]

Exit code 0 when the recovered hardness is within 0.02 of the true 1.6,
2 when it is not.
"""

from __future__ import annotations

import sys


def fit_problem(n: int, device, dtype, newton_rtol: float):
    """The demo's StokesProblem: the n x n power law (exponent 2, eps
    1e-2) on the fastdiag velocity PC, Newton to ``newton_rtol``."""
    from spectral_tpu_torch.grid import Grid
    from spectral_tpu_torch.models.stokes import StokesConfig, StokesProblem
    from spectral_tpu_torch.solvers.newton import NewtonConfig

    cfg = StokesConfig(exact=1, boundary=0, rheology=1, exponent=2.0, regularization=1e-2,
                       pcvel="fastdiag", newton=NewtonConfig(rtol=newton_rtol, max_it=50))
    return StokesProblem(Grid((n, n), device=device, dtype=dtype), cfg)


def main(argv=None) -> int:
    import torch

    from spectral_tpu_torch.cli.main import _setup
    from spectral_tpu_torch.models.rheology import PowerLawParams
    from spectral_tpu_torch.utils.options import Options

    opts = Options(argv if argv is not None else sys.argv[1:])
    device, dtype = _setup(opts)
    n = opts.get_int("n", 8)
    steps = opts.get_int("steps", 6)
    # float32 cannot reach the float64 default tolerance
    rtol = 1e-8 if dtype == torch.float64 else 1e-4
    p = fit_problem(n, device, dtype, rtol)
    cfg = p.config

    last = {}

    def solve(hardness: float):
        th = PowerLawParams(hardness, cfg.exponent, cfg.regularization, cfg.gamma0)
        out = p.solve(last.get("x"), params=th)
        assert int(out.reason) > 0
        last["x"] = out.x
        return th, out.x

    # the synthetic observation at the true hardness
    true_h = 1.6
    _, x_obs = solve(true_h)
    v_obs = x_obs["v"]

    def qoi(x, th):
        return 0.5 * torch.sum((x["v"] - v_obs) ** 2)

    if opts.get_string("opt", "secant") == "lbfgs":
        # the optimizer route (solvers/optimize.py): L-BFGS over the
        # parameter pytree, one forward Newton and one adjoint solve each
        from spectral_tpu_torch.solvers.optimize import OptimizeConfig, lbfgs_minimize

        def value_and_grad(th):
            _, xs = solve(float(th["h"]))
            params = PowerLawParams(th["h"], cfg.exponent, cfg.regularization, cfg.gamma0)
            grad, res = p.adjoint_gradient(qoi, xs, params)
            assert int(res.reason) > 0
            return float(qoi(xs, params)), {"h": grad.hardness}

        print(f"target hardness = {true_h}; starting from 1.0 (L-BFGS)")
        # gtol matched to the solves' tolerance: chasing the gradient below
        # their noise floor only churns line searches
        out = lbfgs_minimize(value_and_grad,
                             {"h": torch.tensor(1.0, dtype=torch.float64, device=device)},
                             OptimizeConfig(gtol=0.5 * rtol, max_it=steps + 20, monitor=True))
        h = float(out.x["h"])
        ok = abs(h - true_h) < 0.02
        print(f"recovered hardness = {h:.6f} (true {true_h})  "
              f"{'OK' if ok else 'NOT CONVERGED'}  "
              f"[{out.nfev} solves, {out.reason_str()}]")
        return 0 if ok else 2

    h = 1.0
    h_prev = g_prev = None
    print(f"target hardness = {true_h}; starting from {h}")
    for it in range(steps):
        th, xs = solve(h)
        grad, res = p.adjoint_gradient(qoi, xs, th)
        g = float(grad.hardness)
        mis = float(qoi(xs, th))
        print(f"  step {it}: hardness = {h:.6f}  misfit = {mis:.3e}  "
              f"dmisfit/dh = {g:.3e}  (adjoint iters {int(res.iters)})")
        if mis < 1e-12 or abs(g) < 1e-14:
            break
        if g_prev is None:
            step = -0.3 * g / max(abs(g), 1e-30)  # a probe step of size 0.3
        else:
            step = -g * (h - h_prev) / (g - g_prev)  # secant on g = 0
        h_prev, g_prev = h, g
        h = h + step
    ok = abs(h - true_h) < 0.02
    print(f"recovered hardness = {h:.6f} (true {true_h})  "
          f"{'OK' if ok else 'NOT CONVERGED'}")
    return 0 if ok else 2


if __name__ == "__main__":
    raise SystemExit(main())
