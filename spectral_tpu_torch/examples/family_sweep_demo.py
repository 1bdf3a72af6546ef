"""Demo: a parameter sweep solved as one family, on a mapped domain.

Counterpart of ``examples/family_sweep_demo.py`` (no reference analog):
the Stokes problem on [0, 2] x [0, 1] (the reference hardcodes [-1, 1]^d)
and a sweep over power-law exponents solved by one batched Newton loop
(``StokesProblem.solve_family``): every Krylov step applies the operator
and the nested PC to the B states together.

    python -m spectral_tpu_torch.examples.family_sweep_demo [-n 12] [-B 6]
        [-device cuda|cpu]

Exit code 0 when every member converged, 2 when not.
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    import torch

    from spectral_tpu_torch.cli.main import _setup
    from spectral_tpu_torch.grid import Grid
    from spectral_tpu_torch.models.rheology import PowerLawParams
    from spectral_tpu_torch.models.stokes import StokesConfig, StokesProblem
    from spectral_tpu_torch.solvers.newton import NewtonConfig
    from spectral_tpu_torch.utils.options import Options

    opts = Options(argv if argv is not None else sys.argv[1:])
    device, dtype = _setup(opts)
    n = opts.get_int("n", 12)
    B = opts.get_int("B", 6)
    # float32 cannot reach the float64 default tolerance
    rtol = 1e-8 if dtype == torch.float64 else 1e-4
    p = StokesProblem(Grid((n, n), intervals=((0.0, 2.0), (0.0, 1.0)), device=device,
                           dtype=dtype),
                      StokesConfig(exact=2, rheology=1, newton=NewtonConfig(rtol=rtol, max_it=30)))
    family = [PowerLawParams(hardness=1.0, exponent=1.0 + 0.4 * b, regularization=1e-2,
                             gamma0=1.0) for b in range(B)]
    res = p.solve_family(family)
    print(f"family of {B} power-law exponents on [0,2]x[0,1], n={n}:")
    for b, th in enumerate(family):
        print(f"  exponent {th.exponent:4.1f}: {res.reason_str(b):<16}"
              f" in {int(res.iters[b]):2d} Newton steps,"
              f" fnorm {float(res.fnorm[b]):.2e}")
    print(f"Newton steps: {[int(i) for i in res.iters]}")
    return 0 if (res.reason > 0).all() else 2


if __name__ == "__main__":
    raise SystemExit(main())
