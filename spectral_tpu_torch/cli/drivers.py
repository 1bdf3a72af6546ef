"""Driver implementations: output format mirrors the reference executables
(and the JAX package's drivers)."""

from __future__ import annotations

import numpy as np
import torch

from spectral_tpu_torch.utils.options import Options


def _print_unused(opts: Options) -> None:
    left = opts.unused()
    if left:
        print(f"WARNING! There are options you set that were not used: {left}")


def cheb_main(opts: Options, *, device: torch.device, dtype: torch.dtype) -> int:
    """Transform self-test (cheb.c:16-135): apply the 1-D and rank-3
    derivative operators to exp-type functions with known derivatives."""
    from spectral_tpu_torch.ops.chebyshev import cgl_nodes_np, chebdiff

    m1 = opts.get_int("m1", 5)
    m = opts.get_int("m", 8)
    n = opts.get_int("n", 7)
    p = opts.get_int("p", 1)
    d = opts.get_int("d", 0)

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    x = cgl_nodes_np(m1)
    if m1 >= 3:
        err = float(torch.max(torch.abs(chebdiff(dev(np.exp(x)), 0) - dev(np.exp(x)))))
        print(f"Norm of error {err:e}")

    dims = [m, n, p]
    xs = [cgl_nodes_np(k) if k > 1 else np.zeros(1) for k in dims]
    X = np.meshgrid(*xs, indexing="ij")
    u2 = dev(sum(np.exp(g) for g in X))
    du2 = chebdiff(u2, axis=d)
    err2 = float(torch.max(torch.abs(du2 - dev(np.exp(X[d])))))
    print(f"Norm of error {err2:e}")
    _print_unused(opts)
    return 0


def _domain_intervals(opts, ndim):
    """-domain a0,b0,a1,b1,... : per-axis physical intervals."""
    vals = opts.get_real_array("domain", ())
    if not vals:
        return None
    if len(vals) != 2 * ndim:
        raise SystemExit(f"-domain needs {2 * ndim} values (a,b per axis)")
    return tuple((vals[2 * i], vals[2 * i + 1]) for i in range(ndim))


def poisson_main(opts: Options, *, device: torch.device, dtype: torch.dtype) -> int:
    """Linear Poisson solve (poisson.c:33-175), flat domain.  Exit code 0
    when the solve converged, 2 when it did not."""
    from spectral_tpu_torch.grid import Grid
    from spectral_tpu_torch.models.poisson import PoissonModel
    from spectral_tpu_torch.solvers.krylov import KSPConfig

    m = opts.get_int("m", 8)
    n = opts.get_int("n", 7)
    p = opts.get_int("p", 1)
    dims = (m, n) if p == 1 else (m, n, p)
    if opts.get_string("map", ""):
        raise NotImplementedError(
            "poisson -map (curved domains) is not ported yet "
            "(ROADMAP.md queue 1, item 6: curvilinear)")
    ksp = opts.ksp_config("", KSPConfig(type="gmres", rtol=1e-7, max_it=500))
    model = PoissonModel(Grid(dims, intervals=_domain_intervals(opts, len(dims)),
                              device=device, dtype=dtype))
    u, f = model.exact_solution()
    b = model.rhs(u, f)
    res = model.solve(b, ksp=ksp, pc_type=opts.pc_type("", "fastdiag"))
    err = float(torch.max(torch.abs(res.x - u)))
    print(f"Norm of error {err:e} iterations {int(res.iters)}")
    _print_unused(opts)
    return 0 if int(res.reason) > 0 else 2
