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
    from spectral_tpu_torch.ops.chebyshev import cheb_regrid
    from spectral_tpu_torch.solvers.krylov import KSPConfig, extreme_singular_values
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
    intervals = _domain_intervals(opts, len(dims))

    def make_model(dims_l):
        return EllipticModel(Grid(dims_l, intervals=intervals, device=device, dtype=dtype),
                             gamma=gamma, exponent=exponent)

    model = make_model(tuple(dims))
    g = model.grid
    print(g.census())
    u, b, dirichlet = model.setup_problem(exact=exact, cos_scale=cos_scale)

    # CHECK_EXACT (elliptic.C:193-209)
    residual = model.make_residual(b, dirichlet)
    F = residual(u)[0].cpu().numpy()
    print(f"{'Norm of exact residual':<25}: abs = {np.max(np.abs(F)):8e}   "
          f"rel = {_max_rel(F, b.cpu().numpy()):8e}")

    ksp = opts.ksp_config("", KSPConfig(type="fgmres", rtol=1e-5, max_it=500))
    # float32 cannot reach the float64 default tolerance: follow the dtype
    newton = opts.newton_config(NewtonConfig(
        rtol=1e-8 if dtype == torch.float64 else 1e-5, max_it=50))
    pc = opts.pc_type("", "fastdiag")
    x0 = None
    gseq = opts.get_int("snes_grid_sequence", 0)
    if gseq > 0:
        # -snes_grid_sequence k (PETSc SNESSetGridSequence): solve the same
        # problem on k successively coarser grids, each finer level
        # warm-started from the spectrally regridded coarse solution
        levels = _sequence_levels(dims, gseq, floor=5)
        for i, dl in enumerate(levels):
            ml = make_model(dl)
            _, bl, drl = ml.setup_problem(exact=exact, cos_scale=cos_scale)
            rl = ml.solve(bl, drl, x0=x0, ksp=ksp, newton=newton, pc_type=pc)
            print(f"  grid sequence level {dl}: {int(rl.iters)} Newton / "
                  f"{int(np.sum(np.asarray(rl.ksp_iters)))} Krylov, "
                  f"reason {rl.reason_str()}")
            nxt = levels[i + 1] if i + 1 < len(levels) else tuple(dims)
            x0 = Grid(nxt, intervals=intervals, device=device, dtype=dtype).zero_boundary(
                cheb_regrid(ml.grid.set_boundary(rl.x, drl), nxt))
    res = model.solve(b, dirichlet, x0=x0, ksp=ksp, newton=newton, pc_type=pc)

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
    if opts.has("ksp_compute_singularvalues"):
        pcs, pca = model.make_pc(pc, dtype=b.dtype)
        Ff, lin_state = residual(res.x)
        pc_state = pcs(res.x, lin_state) if pcs else None
        _print_singular_values(extreme_singular_values(
            lambda w: model.jacobian_action(res.x, lin_state, w), Ff,
            M=(lambda r: pca(pc_state, r)) if pca else None))
    _print_unused(opts)
    return 0 if res.reason > 0 else 2


def _sequence_levels(dims, k: int, floor: int) -> list[tuple[int, ...]]:
    """The coarser grids of -snes_grid_sequence k, coarsest first: (n - 1) /
    2^l + 1 nodes an axis for l = k..1, at least ``floor``; a level equal
    to ``dims`` or to a coarser one (deep sequences hit the floor) is
    dropped, so each warm start has the next level's shape."""
    levels = []
    for lvl in range(k, 0, -1):
        dl = tuple(max(floor, ((n - 1) >> lvl) + 1) for n in dims)
        if dl != tuple(dims) and dl not in levels:
            levels.append(dl)
    return levels


def _print_singular_values(extremes) -> None:
    """-ksp_compute_singularvalues: the Arnoldi estimate of the
    preconditioned Jacobian's extreme singular values at the solution."""
    smax, smin = extremes
    print(f"Iteratively computed extreme singular values: "
          f"max {smax:9.6e} min {smin:9.6e} cond {smax / max(smin, 1e-300):9.6e}")


def _pcvel_option(opts: Options) -> str:
    """-pcvel: the reference's ints 0-3 (stokes.C:159-174) plus 4 = the
    eta-aware multigrid; a string names a family directly."""
    raw = opts.get_string("pcvel", "0")
    table = {"0": "fastdiag", "1": "q1fem", "2": "probed", "3": "nodal", "4": "mg"}
    return table.get(raw, raw)


# stokes driver options whose code is not ported yet, with their ROADMAP item
_STOKES_NOT_PORTED = {
    "map": "item 6: curvilinear",
    "checkpoint_dir": "item 8: utils/checkpoint.py",
    "output_vtk": "item 8: utils/vtk.py",
    "log_summary": "item 8: utils/profiling.py",
}


def stokes_main(opts: Options, *, device: torch.device, dtype: torch.dtype) -> int:
    """Stokes driver (stokes.C:119-253) with continuation, flat domain.
    Prints the JAX driver's lines, then the Newton and Krylov counts of
    every continuation step; with -snes_grid_sequence, also those of the
    coarse level's continuation (``Continuation steps on level ...``, a line
    the JAX driver does not print).  Exit code 0 when the last Newton solve
    converged, 2 when it did not."""
    from spectral_tpu_torch.grid import Grid
    from spectral_tpu_torch.models.stokes import StokesConfig, StokesProblem
    from spectral_tpu_torch.ops.chebyshev import cheb_regrid
    from spectral_tpu_torch.solvers.krylov import KSPConfig, extreme_singular_values
    from spectral_tpu_torch.solvers.newton import NewtonConfig
    from spectral_tpu_torch.utils.printing import vec_print2

    if opts.has("fused") and opts.get_string("checkpoint_dir", ""):
        raise SystemExit("-fused and -checkpoint_dir are mutually exclusive (fused runs "
                         "have no host loop to checkpoint)")
    for key, item in _STOKES_NOT_PORTED.items():
        if opts.has(key):
            raise NotImplementedError(
                f"stokes -{key} is not ported yet (ROADMAP.md queue 1, {item})")
    dims = opts.get_int_array("dim", (8, 6))
    debug = opts.get_int("debug", 0)
    cfg = StokesConfig(
        exact=opts.get_int("exact", 0),
        boundary=opts.get_int("boundary", 0),
        rheology=opts.get_int("rheology", 0),
        hardness=opts.get_real("hardness", 1.0),
        exponent=opts.get_real("exponent", 1.0),
        regularization=opts.get_real("eps", 1.0),
        gamma0=opts.get_real("gamma0", 1.0),
        cont0=opts.get_int("cont0", 0),
        cont=opts.get_int("cont", 1),
        scaleM=opts.get_real("scaleM", 1.0),
        scaleN=opts.get_real("scaleN", 1.0),
        zeroN=opts.get_int("zeroN", 0),
        zeroV=opts.get_real("zeroV", 1.0),
        pcvel=_pcvel_option(opts),
        pcvel_smoother=opts.get_string("pcvel_smoother", "chebyshev"),
        tbc=opts.get_int("tbc", 0),
        traction_p=bool(opts.get_int("traction_p", 0)),
        mixed_tang=bool(opts.get_int("mixed_tang", 0)),
        saddle=opts.get_int("pc_saddle_type", 0),
        outer_ksp=opts.ksp_config("", KSPConfig(type="fgmres", rtol=1e-5,
                                                max_it=500, restart=50)),
        vel_ksp=opts.ksp_config("vel_", KSPConfig(type="gmres", rtol=1e-5,
                                                  max_it=10000, restart=30)),
        svel_ksp=opts.ksp_config("svel_", KSPConfig(type="gmres", rtol=1e-5,
                                                    max_it=10000, restart=30)),
        schur_ksp=opts.ksp_config("schur_", KSPConfig(type="gmres", rtol=1e-5,
                                                      max_it=10000, restart=30)),
        # float32 cannot reach the float64 default tolerance: follow the dtype
        newton=opts.newton_config(NewtonConfig(
            rtol=1e-8 if dtype == torch.float64 else 1e-5, max_it=50)),
        cont_predictor=opts.get_string("cont_predictor", "none"),
    )
    print(f"Stokes problem  dim = [{','.join(map(str, dims))}]")
    print(f"  hardness = {cfg.hardness:f}    exponent = {cfg.exponent:8f}"
          f"    regularization = {cfg.regularization:8f}    gamma0 = {cfg.gamma0:8f}")
    intervals = _domain_intervals(opts, len(dims))

    def make_p(dims_l):
        return StokesProblem(Grid(dims_l, intervals=intervals, device=device, dtype=dtype), cfg)

    p = make_p(tuple(dims))
    print(p.census())

    # exact residual check (stokes.C:191-205)
    residual = p.make_residual(p.params_at(cfg.cont))
    xex = p.exact_state()
    F, _ = residual(xex)

    def amax(t):
        return max(float(torch.max(torch.abs(t["v"]))), float(torch.max(torch.abs(t["p"]))))

    print(f"Norm of solution {amax(xex):9.3e}  norm of forcing {amax(p.force):9.3e}"
          f"  norm of residual {amax(F):9.3e}")

    def _uvp_print2(state, name):
        """VecPrint2 of a (v, p) state's interior as the reference does
        (m-2, n-2, 'uvp'); on d > 2 grids the axis-2 midplane."""
        v, pr = (np.asarray(a.cpu().numpy() if isinstance(a, torch.Tensor) else a)
                 for a in (state["v"], state["p"]))
        if v.ndim > 3:
            mid = v.shape[2] // 2
            v, pr = v[:, :, mid], pr[:, :, mid]
        field = np.concatenate([v, pr[..., None]], axis=-1)[1:-1, 1:-1]
        comp = "uvw"[:field.shape[-1] - 1] + "p"
        vec_print2(field, dims[0] - 2, dims[1] - 2, name, comp)

    if debug >= 1:
        _uvp_print2(xex, "exact global")
        _uvp_print2(F, "exact residual")
    if debug >= 2:
        coords = p.grid.coords_np
        if coords.ndim > 3:
            coords = coords[:, :, coords.shape[2] // 2]
        vec_print2(coords[..., :2], dims[0], dims[1], "coordinates", "xy")
        _uvp_print2(p.force_np, "exact forcing")
        for idx in np.argwhere(p.nm_mask_np):
            t = tuple(int(i) for i in idx)
            kind = "MIXED" if bool(p.mixed_mask_np[t]) else "NEUMANN"
            print(f"boundary type {kind}, index = {t}, "
                  f"normal = {p.normal_np[t].tolist()}")

    monitor = opts.has("snes_monitor")
    gseq = opts.get_int("snes_grid_sequence", 0)
    if gseq > 0:
        # -snes_grid_sequence k: the whole continuation on the coarsest grid
        # only, then the finer grids at
        # the final parameters, each from the regridded, masked state
        seq = _sequence_levels(dims, gseq, floor=6)
        x0 = None
        for i, dl in enumerate(seq):
            pl = make_p(dl)
            if x0 is None:
                coarse = pl.solve_continuation(monitor=monitor)
                print(f"Continuation steps on level {dl}: Newton "
                      f"{[int(r.iters) for r in coarse]}  "
                      f"Krylov {[[int(k) for k in r.ksp_iters] for r in coarse]}")
                rl = coarse[-1]
            else:
                rl = pl.solve(x0, monitor=monitor)
            nxt = seq[i + 1] if i + 1 < len(seq) else tuple(dims)
            pn = make_p(nxt) if nxt != tuple(dims) else p
            x0 = {"v": pn.mask_v(cheb_regrid(rl.x["v"], nxt)),
                  "p": pn.mask_p(cheb_regrid(rl.x["p"], nxt))}
            print(f"  grid sequence level {dl}: {int(rl.iters)} Newton / "
                  f"{int(np.sum(np.asarray(rl.ksp_iters)))} Krylov, "
                  f"reason {rl.reason_str()}")
        results = [p.solve(x0, monitor=monitor)]
    elif opts.has("fused"):
        # -fused: solve_continuation_fused (make_fused_newton's rules, the
        # JAX package's single-dispatch solve); no monitor
        results = p.solve_continuation_fused()
        for i, r in enumerate(results):
            print(f"  [fused {i}/{len(results) - 1}] {int(r.iters)} Newton / "
                  f"{int(np.sum(np.asarray(r.ksp_iters)))} Krylov, reason {r.reason_str()}")
    else:
        results = p.solve_continuation(monitor=monitor)
    res = results[-1]
    if monitor and res.lin_state is not None:
        eta = res.lin_state[0]
        print(f"Minimum eta = {float(torch.min(eta)):9.3e}   "
              f"Maximum eta = {float(torch.max(eta)):9.3e}")
    err = p.error_vs_exact(res.x)
    if debug >= 1:
        pm = p.p_mask_np
        dp = np.where(pm, res.x["p"].cpu().numpy() - p.exact_p_np, 0.0)
        dp -= np.where(pm, dp.sum() / max(pm.sum(), 1), 0.0)
        _uvp_print2({"v": res.x["v"].cpu().numpy() - p.exact_v_np, "p": dp}, "final error")
    print(f"Number of nonlinear iterations = {res.iters}")
    print(f"Reason for solver termination: {res.reason_str()}")
    print(f"{'Norm of error':<25}: abs = {err:8e}")
    print(f"Continuation steps: Newton {[int(r.iters) for r in results]}  "
          f"Krylov {[[int(k) for k in r.ksp_iters] for r in results]}")
    if opts.has("ksp_monitor"):
        for i, rn in enumerate(res.ksp_history_last):
            print(f"{i:5d} KSP Residual norm {rn:.12e}")
    if opts.has("ksp_compute_singularvalues"):
        Ff, lin_state = residual(res.x)
        pcs, pca = p.make_pc()
        pc_state = pcs(res.x, lin_state)
        _print_singular_values(extreme_singular_values(
            lambda w: p.jacobian_action(res.x, lin_state, w), Ff,
            M=lambda r: pca(pc_state, r), null_project=p.null_project))
    _print_unused(opts)
    return 0 if res.reason > 0 else 2
