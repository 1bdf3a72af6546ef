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


def _max_rel(a: np.ndarray, ref: np.ndarray) -> float:
    """max |a / ref| over the entries where ref != 0 (nan-safe)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = a / np.where(ref != 0, ref, np.inf)
    return float(np.nanmax(np.abs(rel)))


def elliptic_main(opts: Options, *, device: torch.device, dtype: torch.dtype) -> int:
    """Nonlinear elliptic driver (elliptic.C:117-246), flat domain, Newton
    with a line search.  Exit code 0 when Newton converged, 2 when not."""
    from spectral_tpu_torch.grid import Grid
    from spectral_tpu_torch.models.elliptic import EllipticModel
    from spectral_tpu_torch.solvers.krylov import KSPConfig
    from spectral_tpu_torch.solvers.newton import NewtonConfig
    from spectral_tpu_torch.utils.printing import vec_print2

    dims = opts.get_int_array("dim", (8, 6))
    debug = opts.get_int("debug", 0)
    exact = opts.get_int("exact", 0)
    gamma = opts.get_real("gamma", 0.0)
    exponent = opts.get_real("exponent", 2.0)
    cos_scale = opts.get_real("cos_scale", 1.0)

    print(f"Elliptic problem  dims = [{','.join(map(str, dims))}]"
          f"    gamma = {gamma:f}    exponent = {exponent:8f}")
    if opts.get_string("map", ""):
        raise NotImplementedError("elliptic -map (curved domains) is not ported yet "
                                  "(ROADMAP.md queue 1, item 6: curvilinear)")
    snes_type = opts.get_string("snes_type", "newtonls")
    if snes_type not in ("newtonls", "newton"):
        raise NotImplementedError(f"-snes_type {snes_type} is not ported yet "
                                  "(ROADMAP.md queue 1, item 2)")
    if opts.get_int("snes_grid_sequence", 0) > 0:
        raise NotImplementedError("-snes_grid_sequence is not ported yet "
                                  "(ROADMAP.md queue 1, item 2: cheb_regrid)")
    if opts.has("ksp_compute_singularvalues"):
        raise NotImplementedError("-ksp_compute_singularvalues is not ported yet "
                                  "(ROADMAP.md queue 1, item 2: extreme_singular_values)")

    model = EllipticModel(Grid(dims, intervals=_domain_intervals(opts, len(dims)),
                               device=device, dtype=dtype),
                          gamma=gamma, exponent=exponent)
    g = model.grid
    print(g.census())
    u, b, dirichlet = model.setup_problem(exact=exact, cos_scale=cos_scale)

    # CHECK_EXACT (elliptic.C:193-209)
    F = model.make_residual(b, dirichlet)(u)[0].cpu().numpy()
    print(f"{'Norm of exact residual':<25}: abs = {np.max(np.abs(F)):8e}   "
          f"rel = {_max_rel(F, b.cpu().numpy()):8e}")

    ksp = opts.ksp_config("", KSPConfig(type="fgmres", rtol=1e-5, max_it=500))
    # float32 cannot reach the float64 default tolerance: follow the dtype
    newton = opts.newton_config(NewtonConfig(
        rtol=1e-8 if dtype == torch.float64 else 1e-5, max_it=50))
    res = model.solve(b, dirichlet, ksp=ksp, newton=newton,
                      pc_type=opts.pc_type("", "fastdiag"))

    x = res.x.cpu().numpy()
    if debug >= 2:
        vec_print2(x[1:-1, 1:-1], dims[0] - 2, dims[1] - 2, "computed u")
    u_np = u.cpu().numpy()
    err = x - u_np
    print(f"Number of nonlinear iterations = {res.iters}")
    print(f"Reason for solver termination: {res.reason_str()}")
    print(f"{'Norm of error':<25}: abs = {np.max(np.abs(err)):8e}   "
          f"rel = {_max_rel(err, u_np):8e}")
    if debug >= 1:
        print(f"KSP iterations per Newton step: {res.ksp_iters}")
    if opts.has("snes_monitor") or opts.has("rhistory"):
        for i, fn in enumerate(res.fnorm_history):
            print(f"{i:3d} SNES fnorm history {fn:.12e}")
    if opts.has("ksp_monitor"):
        for i, rn in enumerate(res.ksp_history_last):
            print(f"{i:5d} KSP Residual norm {rn:.12e}")
    _print_unused(opts)
    return 0 if res.reason > 0 else 2
