"""Demo: non-Newtonian Stokes flow in a quarter-annulus sector.

Counterpart of ``examples/curved_domain_demo.py`` (coordinate transforms
are the reference's "FIXME", stokes.C:587-738): the saddle-point system in
curvilinear metric form, a lid-driven power-law flow on the curved domain,
solved by Newton and nested FGMRES with the metric-aware multigrid
velocity PC, then, with ``-output_vtk``, written as legacy VTK with the
physical node positions (``stokes_annulus.vtk`` in the working directory;
ParaView shows the annulus).

    python -m spectral_tpu_torch.examples.curved_domain_demo [-n 14] [-exponent 3]
        [-snes_monitor] [-output_vtk] [-device cuda|cpu]

Exit code 0 when every continuation step converged, 2 when not.
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    import torch

    from spectral_tpu_torch.cli.main import _setup
    from spectral_tpu_torch.grid import Grid
    from spectral_tpu_torch.models.stokes import StokesConfig, StokesProblem
    from spectral_tpu_torch.ops.curvilinear import named_map
    from spectral_tpu_torch.solvers.newton import NewtonConfig
    from spectral_tpu_torch.utils.options import Options

    opts = Options(argv if argv is not None else sys.argv[1:])
    device, dtype = _setup(opts)
    n = opts.get_int("n", 14)
    exponent = opts.get_real("exponent", 3.0)
    rtol = 1e-8 if dtype == torch.float64 else 1e-4
    cfg = StokesConfig(exact=0, boundary=3, rheology=1, exponent=exponent,
                       regularization=1e-3, cont=2, pcvel="mg",
                       newton=NewtonConfig(rtol=rtol, max_it=40))
    p = StokesProblem(Grid((n, n), device=device, dtype=dtype), cfg,
                      phi=named_map("annulus:1:2"))
    print(p.census())
    results = p.solve_continuation(monitor=opts.has("snes_monitor"))
    for i, r in enumerate(results):
        print(f"continuation step {i}: {int(r.iters)} Newton iterations, "
              f"reason {r.reason_str()}, |F| = {float(r.fnorm):.3e}")
    print(f"Continuation steps: Newton {[int(r.iters) for r in results]}  "
          f"Krylov {[[int(k) for k in r.ksp_iters] for r in results]}")
    if opts.has("output_vtk"):
        from spectral_tpu_torch.utils.vtk import write_stokes_vtk
        write_stokes_vtk(p, results[-1].x, "stokes_annulus.vtk")
        print("wrote stokes_annulus.vtk (physical annulus coordinates)")
    return 0 if all(int(r.reason) > 0 for r in results) else 2


if __name__ == "__main__":
    raise SystemExit(main())
