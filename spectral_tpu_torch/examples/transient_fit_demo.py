"""Demo: parameter estimation through time by transient-adjoint descent.

Counterpart of ``examples/transient_fit_demo.py``.  Recovers the
power-law hardness of an unsteady Stokes flow from the velocity observed
at the final time only: each iterate is one forward theta-scheme rollout
(a Newton saddle solve a step) and one reverse adjoint sweep (one
transposed mass-shifted saddle solve a step,
``UnsteadyStokes.adjoint_gradient``), the exact misfit gradient whatever
the number of parameters, in a secant iteration on dJ/dh = 0.

    python -m spectral_tpu_torch.examples.transient_fit_demo [-n 8] [-steps 2]
        [-iters 10] [-device cuda|cpu] [-f32]

Exit code 0 when the recovered hardness is within 0.05 of the true 1.6,
2 when it is not.
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    import dataclasses

    import numpy as np
    import torch

    from spectral_tpu_torch.cli.main import _setup
    from spectral_tpu_torch.grid import Grid
    from spectral_tpu_torch.models.stokes import StokesConfig
    from spectral_tpu_torch.models.stokes_unsteady import UnsteadyStokes
    from spectral_tpu_torch.solvers.krylov import KSPConfig
    from spectral_tpu_torch.solvers.newton import NewtonConfig
    from spectral_tpu_torch.utils.options import Options

    opts = Options(argv if argv is not None else sys.argv[1:])
    device, dtype = _setup(opts)
    n = opts.get_int("n", 8)
    steps = opts.get_int("steps", 2)
    f64 = dtype == torch.float64
    rtol = 1e-11 if f64 else 1e-5
    cfg0 = StokesConfig(
        exact=1, boundary=0, rheology=1, exponent=3.0, regularization=1e-1, hardness=1.0,
        pcvel="mg", outer_ksp=KSPConfig(type="fgmres", rtol=rtol, max_it=400, restart=100),
        newton=NewtonConfig(rtol=rtol, max_it=20))
    grid = Grid((n, n), device=device, dtype=dtype)
    dt = 0.1
    times = np.arange(steps + 1) * dt

    def model_at(hardness: float) -> UnsteadyStokes:
        return UnsteadyStokes(grid, dataclasses.replace(cfg0, hardness=hardness), dt=dt,
                              theta=0.5)

    # forcing and boundary data are built once (independent of the
    # parameters, as the adjoint assumes) from the hardness-1 model's
    # manufactured solution
    base = model_at(1.0)
    u0, s_of_t, f_of_t, _, _ = base.manufactured(omega=1.0)

    true_h = 1.6
    v_obs, _, _ = model_at(true_h).rollout(u0, times, s_of_t, f_of_t)
    print(f"observed final state generated at hardness = {true_h}")

    def misfit(v):
        return 0.5 * torch.sum((v - v_obs) ** 2)

    # a secant iteration on the scalar optimality condition dJ/dh = 0;
    # every gradient is an exact transient-adjoint evaluation
    h, h_prev, g_prev = 1.0, None, None
    for it in range(opts.get_int("iters", 10)):
        m = model_at(h)
        traj, _, _ = m.rollout(u0, times, s_of_t, f_of_t, keep_trajectory=True)
        J = float(misfit(traj[-1]))
        grad, _ = m.adjoint_gradient(misfit, traj, times, s_of_t, f_of_t)
        g = float(grad.hardness)
        print(f"iter {it:2d}: hardness = {h:.6f}  misfit = {J:.3e}  dJ/dh = {g:+.3e}")
        if J < (1e-16 if f64 else 1e-8) or abs(g) < 1e-16:
            break
        if g_prev is None:
            step = 0.1 if g < 0 else -0.1         # bootstrap the secant
        else:
            denom = g - g_prev
            if abs(denom) < 1e-30:   # float32 gradient quantization near the optimum
                break
            step = -g * (h - h_prev) / denom
        h_prev, g_prev = h, g
        h = h + step
    err = abs(h - true_h)
    print(f"recovered hardness = {h:.6f}  (true {true_h}, error {err:.2e})")
    return 0 if err < 5e-2 else 2


if __name__ == "__main__":
    raise SystemExit(main())
