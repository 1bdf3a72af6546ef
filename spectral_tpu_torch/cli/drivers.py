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
    """Linear Poisson solve (poisson.c:33-175); ``-map`` solves on a curved
    domain (CurvilinearPoisson, the manufactured u = prod cos(pi x_j / 2)
    at the physical nodes, multigrid PC by default).  Exit code 0 when the
    solve converged, 2 when it did not."""
    from spectral_tpu_torch.grid import Grid
    from spectral_tpu_torch.models.poisson import PoissonModel
    from spectral_tpu_torch.solvers.krylov import KSPConfig

    m = opts.get_int("m", 8)
    n = opts.get_int("n", 7)
    p = opts.get_int("p", 1)
    dims = (m, n) if p == 1 else (m, n, p)
    map_spec = opts.get_string("map", "")
    ksp = opts.ksp_config("", KSPConfig(type="gmres", rtol=1e-7, max_it=500))
    if map_spec:
        from spectral_tpu_torch.models.curvilinear import CurvilinearPoisson
        from spectral_tpu_torch.ops.curvilinear import named_map

        if _domain_intervals(opts, len(dims)) is not None:
            raise SystemExit("-map and -domain are mutually exclusive")
        cp = CurvilinearPoisson(Grid(dims, device=device, dtype=dtype), named_map(map_spec))
        print(f"  curvilinear domain: -map {map_spec}")
        d = len(dims)

        def u_fn(x):
            return np.prod(np.cos(0.5 * np.pi * x), axis=-1)

        u, b = cp.manufactured(u_fn, lambda x: -d * (0.5 * np.pi) ** 2 * u_fn(x))
        res = cp.solve(b, ksp=ksp, pc_type=opts.pc_type("", "mg"))
        err = float(torch.max(torch.abs(res.x - u)))
        print(f"Norm of error {err:e} iterations {int(res.iters)}")
        _print_unused(opts)
        return 0 if int(res.reason) > 0 else 2
    model = PoissonModel(Grid(dims, intervals=_domain_intervals(opts, len(dims)),
                              device=device, dtype=dtype))
    u, f = model.exact_solution()
    b = model.rhs(u, f)
    res = model.solve(b, ksp=ksp, pc_type=opts.pc_type("", "fastdiag"))
    err = float(torch.max(torch.abs(res.x - u)))
    print(f"Norm of error {err:e} iterations {int(res.iters)}")
    _print_unused(opts)
    return 0 if int(res.reason) > 0 else 2


def _snes_solve(opts: Options, model, make_model, b, dirichlet, x0, *, ksp, newton, pc):
    """-snes_type dispatch (PETSc SNESSetType): ``newtonls`` (default),
    ``newtontr``, ``qn``, ``anderson``, ``ngmres``, ``fas``, with the
    family knobs under their PETSc names (-snes_tr_delta0/_eta1-3,
    -snes_qn_m, -snes_anderson_m/_beta, -snes_ngmres_m/_beta) and
    -npc_snes_type newtonls composing NGMRES with one loose Newton step
    (-npc_ksp_rtol, -npc_ksp_max_it).  A non-Newton result is adapted to
    NewtonResult, so the driver's lines and exit code stay uniform."""
    import dataclasses

    from spectral_tpu_torch.solvers import newton as snes
    from spectral_tpu_torch.solvers.newton import NewtonConfig, NewtonResult

    snes_type = opts.get_string("snes_type", "newtonls")
    if snes_type in ("newtonls", "newton"):
        return model.solve(b, dirichlet, x0=x0, ksp=ksp, newton=newton, pc_type=pc)
    residual = model.make_residual(b, dirichlet)
    x0 = torch.zeros_like(b) if x0 is None else x0
    pcs, pca = model.make_pc(pc, dtype=b.dtype)
    if snes_type in ("newtontr", "tr"):
        return snes.newton_tr_solve(
            residual, x0, jacobian_action=model.jacobian_action, pc_setup=pcs, pc_apply=pca,
            ksp=ksp, config=newton, delta0=opts.get_real("snes_tr_delta0", 0.2),
            eta1=opts.get_real("snes_tr_eta1", 1e-3), eta2=opts.get_real("snes_tr_eta2", 0.25),
            eta3=opts.get_real("snes_tr_eta3", 0.75))
    if snes_type == "qn":
        return snes.quasi_newton_solve(residual, x0, m=opts.get_int("snes_qn_m", 10),
                                       pc_setup=pcs, pc_apply=pca, config=newton)
    if snes_type == "anderson":
        return snes.anderson_solve(residual, x0, m=opts.get_int("snes_anderson_m", 5),
                                   beta=opts.get_real("snes_anderson_beta", 0.2),
                                   pc_setup=pcs, pc_apply=pca, config=newton)
    if snes_type == "ngmres":
        npc = None
        if opts.get_string("npc_snes_type", "") in ("newtonls", "newton"):
            inner_ksp = dataclasses.replace(ksp, rtol=opts.get_real("npc_ksp_rtol", 0.3),
                                            max_it=opts.get_int("npc_ksp_max_it", 5))
            inner_cfg = NewtonConfig(max_it=1, rtol=0.0, atol=0.0, line_search="basic")

            def npc(x):   # one loose inexact-Newton step an outer iteration
                return snes.newton_solve(residual, x, jacobian_action=model.jacobian_action,
                                         pc_setup=pcs, pc_apply=pca, ksp=inner_ksp,
                                         config=inner_cfg).x
        return snes.ngmres_solve(residual, x0, m=opts.get_int("snes_ngmres_m", 5), npc=npc,
                                 beta=opts.get_real("snes_ngmres_beta", 0.2),
                                 pc_setup=pcs, pc_apply=pca, config=newton)
    if snes_type == "fas":
        from spectral_tpu_torch.solvers.fas import FASSolver

        r = FASSolver(make_model, model.grid.dims, b, dirichlet).solve(
            x0=x0, rtol=newton.rtol, atol=newton.atol, max_cycles=newton.max_it)
        return NewtonResult(x=r.x, iters=r.iters, reason=r.reason, fnorm=r.rnorm,
                            fnorm_history=r.history, ksp_iters=[0] * r.iters)
    raise SystemExit(f"unknown -snes_type {snes_type!r} "
                     "(newtonls|newtontr|qn|anderson|ngmres|fas)")


def _max_rel(a: np.ndarray, ref: np.ndarray) -> float:
    """max |a / ref| over the entries where ref != 0 (nan-safe)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = a / np.where(ref != 0, ref, np.inf)
    return float(np.nanmax(np.abs(rel)))


def elliptic_main(opts: Options, *, device: torch.device, dtype: torch.dtype) -> int:
    """Nonlinear elliptic driver (elliptic.C:117-246), Newton with a line
    search or another -snes_type (_snes_solve); ``-map`` solves on a
    curved domain (the metric form, multigrid PC by default).  Exit code 0
    when the solve converged, 2 when not."""
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
    map_spec = opts.get_string("map", "")
    intervals = _domain_intervals(opts, len(dims))
    if map_spec and intervals is not None:
        raise SystemExit("-map and -domain are mutually exclusive")
    phi = None
    if map_spec:
        from spectral_tpu_torch.ops.curvilinear import named_map
        phi = named_map(map_spec)

    def make_model(dims_l):
        return EllipticModel(Grid(dims_l, intervals=intervals, device=device, dtype=dtype),
                             gamma=gamma, exponent=exponent, phi=phi)

    model = make_model(tuple(dims))
    if map_spec:
        print(f"  curvilinear domain: -map {map_spec}")
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
    pc = opts.pc_type("", "mg" if map_spec else "fastdiag")
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
    res = _snes_solve(opts, model, make_model, b, dirichlet, x0, ksp=ksp, newton=newton, pc=pc)

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


def stokes_config(opts: Options, dtype: torch.dtype):
    """The StokesConfig of a ``stokes`` command line (without -map's
    pcvel default), as the driver builds it."""
    from spectral_tpu_torch.models.stokes import StokesConfig
    from spectral_tpu_torch.solvers.krylov import KSPConfig
    from spectral_tpu_torch.solvers.newton import NewtonConfig

    return StokesConfig(
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


def stokes_main(opts: Options, *, device: torch.device, dtype: torch.dtype) -> int:
    """Stokes driver (stokes.C:119-253) with continuation; ``-map`` solves
    on a curved domain (the metric-aware multigrid velocity PC unless
    -pcvel is given).  Prints the JAX driver's lines, then the Newton and Krylov counts of
    every continuation step; with -snes_grid_sequence, also those of the
    coarse level's continuation (``Continuation steps on level ...``, a line
    the JAX driver does not print).  ``-checkpoint_dir`` saves each
    continuation step (of the coarse level under -snes_grid_sequence) and
    resumes after the last one saved.  ``-output_vtk`` writes
    stokes.vtk, ``-log_summary`` prints the SNESSolve phase's time.  Exit
    code 0 when the last Newton solve converged, 2 when it did not."""
    from spectral_tpu_torch.grid import Grid
    from spectral_tpu_torch.models.stokes import StokesConfig, StokesProblem
    from spectral_tpu_torch.ops.chebyshev import cheb_regrid
    from spectral_tpu_torch.solvers.krylov import KSPConfig, extreme_singular_values
    from spectral_tpu_torch.solvers.newton import NewtonConfig
    from spectral_tpu_torch.utils.printing import vec_print2
    from spectral_tpu_torch.utils.profiling import PhaseTimer

    ckpt_dir = opts.get_string("checkpoint_dir", "") or None
    if opts.has("fused") and ckpt_dir:
        raise SystemExit("-fused and -checkpoint_dir are mutually exclusive (fused runs "
                         "have no host loop to checkpoint)")
    dims = opts.get_int_array("dim", (8, 6))
    debug = opts.get_int("debug", 0)
    cfg = stokes_config(opts, dtype)
    print(f"Stokes problem  dim = [{','.join(map(str, dims))}]")
    print(f"  hardness = {cfg.hardness:f}    exponent = {cfg.exponent:8f}"
          f"    regularization = {cfg.regularization:8f}    gamma0 = {cfg.gamma0:8f}")
    intervals = _domain_intervals(opts, len(dims))
    map_spec = opts.get_string("map", "")
    phi = None
    if map_spec:
        import dataclasses

        from spectral_tpu_torch.ops.curvilinear import named_map
        if intervals is not None:
            raise SystemExit("-map and -domain are mutually exclusive")
        if not opts.has("pcvel"):
            # fastdiag is metric-blind: the metric multigrid by default
            cfg = dataclasses.replace(cfg, pcvel="mg")
        phi = named_map(map_spec)

    def make_p(dims_l):
        return StokesProblem(Grid(dims_l, intervals=intervals, device=device, dtype=dtype), cfg,
                             phi=phi)

    p = make_p(tuple(dims))
    if map_spec:
        print(f"  curvilinear domain: -map {map_spec}")
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
        coords = p.coords_phys_np
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
    timer = PhaseTimer(device)
    with timer.phase("SNESSolve"):
        if gseq > 0:
            # -snes_grid_sequence k: the whole continuation on the coarsest
            # grid only (it carries the checkpoints), then the finer grids
            # at the final parameters, each from the regridded, masked state
            seq = _sequence_levels(dims, gseq, floor=6)
            x0 = None
            for i, dl in enumerate(seq):
                pl = make_p(dl)
                if x0 is None:
                    coarse = pl.solve_continuation(monitor=monitor, checkpoint_dir=ckpt_dir)
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
                      f"{int(np.sum(np.asarray(rl.ksp_iters)))} Krylov, reason {rl.reason_str()}")
            results = [p.solve(x0, monitor=monitor)]
        elif opts.has("fused"):
            # -fused: solve_continuation_fused (make_fused_newton's rules,
            # the JAX package's single-dispatch solve); no monitor
            results = p.solve_continuation_fused()
            for i, r in enumerate(results):
                print(f"  [fused {i}/{len(results) - 1}] {int(r.iters)} Newton / "
                      f"{int(np.sum(np.asarray(r.ksp_iters)))} Krylov, reason {r.reason_str()}")
        else:
            results = p.solve_continuation(monitor=monitor, checkpoint_dir=ckpt_dir)
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
    if opts.has("output_vtk"):
        from spectral_tpu_torch.utils.vtk import write_stokes_vtk
        write_stokes_vtk(p, res.x, "stokes.vtk")
        print("wrote stokes.vtk")
    if opts.has("log_summary"):
        print(timer.summary())
    _print_unused(opts)
    return 0 if res.reason > 0 else 2


def heat_main(opts: Options, *, device: torch.device, dtype: torch.dtype) -> int:
    """Time-dependent diffusion driver (models/heat.py):

    heat -dim 16,16 -dt 0.01 -nsteps 20 [-theta 0.5] [-ts_type theta|bdf2]
        [-ts_adapt [-ts_rtol 1e-5 -ts_atol 1e-9 -ts_dt0 dt -ts_max_steps N -ts_monitor]]
        [-map bump:0.08]

    Decays u0 = prod cos(pi x_j / 2) and prints the max error against the
    analytic decay; with ``-map``, relaxes from zero toward the harmonic
    x^2 - y^2 held on the curved domain's boundary and prints the error
    against it.  Exit code 0 when the error is under 1, 2 when not."""
    from spectral_tpu_torch.grid import Grid
    from spectral_tpu_torch.models.heat import HeatModel

    dims = opts.get_int_array("dim", (16, 16))
    dt = opts.get_real("dt", 0.01)
    nsteps = opts.get_int("nsteps", 20)
    theta = opts.get_real("theta", 0.5)
    map_spec = opts.get_string("map", "")
    print(f"Heat problem  dims = [{','.join(map(str, dims))}]  dt = {dt}"
          f"  theta = {theta}  steps = {nsteps}")
    if map_spec:
        from spectral_tpu_torch.ops.curvilinear import named_map
        from spectral_tpu_torch.solvers.krylov import KSPConfig

        if _domain_intervals(opts, len(dims)) is not None:
            raise SystemExit("-map and -domain are mutually exclusive")
        g = Grid(dims, device=device, dtype=dtype)
        m = HeatModel(g, dt=dt, theta=theta, phi=named_map(map_spec),
                      ksp=KSPConfig(type="gmres", rtol=1e-11, max_it=200))
        print(f"  curvilinear domain: -map {map_spec}")
        xp = m.cmap.coords
        harm = torch.as_tensor(xp[..., 0] ** 2 - xp[..., 1] ** 2, dtype=dtype, device=device)
        z = torch.zeros(g.dims, dtype=dtype, device=device)
        u = m.rollout(z, z, torch.where(g.boundary_mask, harm, z), nsteps)
        err = float(torch.max(torch.abs(g.zero_boundary(u - harm))))
        print(f"Norm of error vs analytic decay {err:e} (harmonic steady state)")
        _print_unused(opts)
        return 0 if err < 1.0 else 2
    ts_type = opts.get_string("ts_type", "theta")
    ts_adapt = opts.get_bool("ts_adapt", False)
    g = Grid(dims, intervals=_domain_intervals(opts, len(dims)), device=device, dtype=dtype)
    m = HeatModel(g, dt=dt, theta=theta)
    u0 = g.zero_boundary(torch.prod(torch.cos(0.5 * np.pi * g.coords), dim=-1))
    z = torch.zeros_like(u0)
    T_end = dt * nsteps
    if ts_adapt:
        # adaptive variable-step BDF2 over the same horizon (TSAdapt role)
        from spectral_tpu_torch.solvers.ts import TSConfig, integrate_adaptive
        cfg = TSConfig(rtol=opts.get_real("ts_rtol", 1e-5),
                       atol=opts.get_real("ts_atol", 1e-9),
                       dt0=opts.get_real("ts_dt0", dt),
                       max_steps=opts.get_int("ts_max_steps", 10_000),
                       monitor=opts.get_bool("ts_monitor", False))
        u, info = integrate_adaptive(m, u0, 0.0, T_end, z, z, cfg)
        print(f"  ts_adapt: {info['steps']} accepted steps, "
              f"{info['rejects']} rejected, dt "
              f"{min(info['dts']):.3g} .. {max(info['dts']):.3g}")
    elif ts_type == "bdf2":
        from spectral_tpu_torch.solvers.ts import rollout_bdf2
        u = rollout_bdf2(m, u0, z, z, dt, nsteps)
    elif ts_type == "theta":
        u = m.rollout(u0, z, z, nsteps)
    else:
        raise SystemExit(f"unknown -ts_type {ts_type!r} (theta|bdf2)")
    lam = g.ndim * (0.5 * np.pi) ** 2
    exact = u0.cpu().numpy() * np.exp(-lam * T_end)
    err = float(np.max(np.abs(u.cpu().numpy() - exact)))
    print(f"Norm of error vs analytic decay {err:e}")
    _print_unused(opts)
    return 0 if err < 1.0 else 2


def ustokes_config(opts: Options, dtype: torch.dtype, curved: bool = False):
    """The StokesConfig of a ``ustokes`` command line, as the driver builds
    it (``curved``: a -map run, whose pcvel defaults to mg)."""
    from spectral_tpu_torch.models.stokes import StokesConfig
    from spectral_tpu_torch.solvers.krylov import KSPConfig
    from spectral_tpu_torch.solvers.newton import NewtonConfig

    return StokesConfig(
        exact=opts.get_int("exact", 1), boundary=0,
        rheology=opts.get_int("rheology", 0),
        hardness=opts.get_real("hardness", 1.0),
        exponent=opts.get_real("exponent", 1.0),
        regularization=opts.get_real("eps", 1.0),
        gamma0=opts.get_real("gamma0", 1.0),
        pcvel=opts.get_string("pcvel", "mg" if curved else "fastdiag"),
        # -saddle_pc dense|dense-device: the exact inverse of the fixed
        # mass-shifted step operator (one matmul an apply)
        saddle_pc=opts.get_string("saddle_pc", "schur"),
        outer_ksp=opts.ksp_config("", KSPConfig(type="fgmres", rtol=1e-9,
                                                max_it=400, restart=100)),
        # float32 cannot reach the float64 default tolerance: follow the dtype
        newton=opts.newton_config(NewtonConfig(
            rtol=1e-8 if dtype == torch.float64 else 1e-5, max_it=25)))


def unsteady_stokes_main(opts: Options, *, device: torch.device, dtype: torch.dtype) -> int:
    """Time-dependent Stokes driver (models/stokes_unsteady.py):

    ustokes -dim 12,12 -dt 0.05 -nsteps 10 [-theta 0.5] [-scheme theta|bdf2]
        [-omega 1.0] [-exact 1] [-pcvel fastdiag|mg] [-saddle_pc schur|dense|dense-device]
        [-rheology 1 -exponent 3] [-no_scan] [-map bump:0.05]

    Integrates the manufactured solution u0(x) cos(omega t) (u0 the steady
    exact solution) and prints the JAX driver's lines (the outer
    iterations' min and max over the steps, the end-time error, the time
    integration's), then every step's count.  Exit code 0 when the error is
    finite and under 1e-2, 2 when not."""
    from spectral_tpu_torch.grid import Grid
    from spectral_tpu_torch.models.stokes import StokesConfig
    from spectral_tpu_torch.models.stokes_unsteady import UnsteadyStokes
    from spectral_tpu_torch.solvers.krylov import KSPConfig
    from spectral_tpu_torch.solvers.newton import NewtonConfig

    dims = opts.get_int_array("dim", (12, 12))
    dt = opts.get_real("dt", 0.05)
    nsteps = opts.get_int("nsteps", 10)
    if nsteps < 1:
        raise SystemExit("-nsteps must be >= 1")
    theta = opts.get_real("theta", 0.5)
    omega = opts.get_real("omega", 1.0)
    map_spec = opts.get_string("map", "")
    phi = None
    if map_spec:
        from spectral_tpu_torch.ops.curvilinear import named_map
        phi = named_map(map_spec)
    cfg = ustokes_config(opts, dtype, bool(map_spec))
    scheme = opts.get_string("scheme", "theta")
    print(f"Unsteady Stokes  dim = [{','.join(map(str, dims))}]  dt = {dt}"
          f"  scheme = {scheme}" + ("" if scheme == "bdf2" else f"  theta = {theta}")
          + f"  omega = {omega}  steps = {nsteps}"
          + (f"  map = {map_spec}" if map_spec else ""))
    m = UnsteadyStokes(Grid(dims, device=device, dtype=dtype), cfg, dt=dt, theta=theta,
                       phi=phi, scheme=scheme)
    print(m.problem.census())
    u0, s_of_t, f_of_t, u_of_t, _ = m.manufactured(omega=omega)
    times = np.arange(nsteps + 1) * dt
    scan = m._linear and not opts.has("no_scan")
    if scan and scheme == "bdf2" and nsteps >= 2:
        ss = [s_of_t(t) for t in times[1:]]
        f1s = torch.stack([f_of_t(t) for t in times[2:]])
        fbar0 = 0.5 * f_of_t(times[1]) + 0.5 * f_of_t(times[0])
        v, pres, its = m.rollout_scan_bdf2(u0, ss, f1s, fbar0)
    elif scan and scheme == "theta":
        # the linear path over precomputed per-step data (rollout_scan)
        ss = [s_of_t(t) for t in times[1:]]
        fbars = torch.stack([theta * f_of_t(t1) + (1.0 - theta) * f_of_t(t0)
                             for t0, t1 in zip(times[:-1], times[1:])])
        v, pres, its = m.rollout_scan(u0, ss, fbars)
    else:
        v, pres, its = m.rollout(u0, times, s_of_t, f_of_t)
    its = [int(i) for i in its]
    err = float(torch.max(torch.abs(v - u_of_t(times[-1]))))
    print(f"Outer iterations per step: min {min(its)}  max {max(its)}")
    print(f"Norm of error            : abs = {err:e} (time-integration)")
    if opts.has("output_vtk"):
        from spectral_tpu_torch.utils.vtk import write_stokes_vtk
        write_stokes_vtk(m.problem, {"v": m.problem.mask_v(v), "p": pres}, "ustokes.vtk",
                         bc_scale=s_of_t(times[-1]))
        print("Wrote ustokes.vtk")
    # a line the JAX driver does not print: the count of every step
    print(f"Outer iterations each step: {its}")
    _print_unused(opts)
    return 0 if np.isfinite(err) and err < 1e-2 else 2


def convection_config(opts: Options):
    """The ConvectionConfig of a ``convection`` command line, as the driver
    builds it."""
    from spectral_tpu_torch.models.convection import ConvectionConfig
    from spectral_tpu_torch.solvers.krylov import KSPConfig

    return ConvectionConfig(
        Ra=opts.get_real("ra", 1e4),
        dt=opts.get_real("dt", 5e-4),
        theta=opts.get_real("theta", 0.5),
        velocity_bc=opts.get_string("bc", "freeslip"),
        side_bc=opts.get_string("sides", "insulated"),
        eta_contrast=opts.get_real("eta_contrast", 1.0),
        heating=opts.get_real("heating", 0.0),
        tbc=opts.get_int("tbc", 0) if opts.has("tbc") else None,
        pcvel=opts.get_string("pcvel", "fastdiag"),
        stokes_pc=opts.get_string("stokes_pc", "nested"),
        # -dealias 1 = the 3/2 rule; -dealias 2.0 etc. = an explicit ratio
        dealias=(False if not opts.has("dealias")
                 else (lambda r: True if r in (0.0, 1.0) else r)(opts.get_real("dealias", 1.0))),
        stokes_ksp=opts.ksp_config("", KSPConfig(type="fgmres", rtol=1e-7, max_it=150,
                                                 restart=60)))


def convection_main(opts: Options, *, device: torch.device, dtype: torch.dtype) -> int:
    """Coupled Boussinesq convection driver (models/convection.py):
    infinite-Prandtl Rayleigh-Benard on the box, marched to steady state
    with the Nusselt / Vrms diagnostics:

    convection -dim 16,16 -ra 1e4 -dt 5e-4 -bc freeslip -sides insulated -steady_tol 1e-3
        [-stokes_pc nested|dense|dense-device] [-nsteps N | -newton | -accel | -ts_adapt]
        [-stability 1|2|3] [-eta_contrast c] [-heating H] [-dealias 1] [-aspect L]

    (the Blankenbach case 1a configuration; published Nu = 4.884409, Vrms
    = 42.864947).  Prints the JAX driver's lines.  ``-accel`` is the
    Anderson-accelerated steady state (-accel_m, -chunk, -steady_tol,
    -max_steps, -warmup).  ``-output_vtk`` writes convection.vtk with the
    temperature as an extra scalar; ``-map`` is not an option of this driver (the JAX driver's neither):
    it is reported as unused.  Exit code 0 when the run converged, 2 when
    it did not."""
    from spectral_tpu_torch.models.convection import ConvectionConfig, ConvectionModel
    from spectral_tpu_torch.solvers.krylov import KSPConfig
    from spectral_tpu_torch.solvers.newton import NewtonConfig

    dims = opts.get_int_array("dim", (16, 16))
    cfg = convection_config(opts)
    aspect = opts.get_real("aspect", 1.0)
    m = ConvectionModel.box(dims, cfg, aspect=aspect, device=device, dtype=dtype)
    print(f"Convection  dim = [{','.join(map(str, dims))}]  Ra = {cfg.Ra}"
          f"  dt = {cfg.dt}  theta = {cfg.theta}  bc = {cfg.velocity_bc}"
          f"/{cfg.side_bc}  aspect = {aspect}")
    print(m.stokes.census())
    if opts.has("stability"):
        # -stability 1: the critical Rayleigh number; 2: also the growth
        # rates nearest 0 at the configured Ra (about the steady base when
        # heating meets conducting sidewalls); 3: growth rates about the
        # steady convecting state (steady_newton base)
        level = opts.get_int("stability", 1)
        ok = True
        has_conduction_branch = m._conduction_base_is_equilibrium
        if has_conduction_branch:
            ra_c, resc = m.critical_rayleigh(k=2, m=opts.get_int("eps_ncv", 20),
                                             tol=opts.get_real("eps_tol", 1e-9))
            print(f"Critical Rayleigh number Ra_c = {ra_c:.6f}  "
                  f"(converged: {resc.converged}, {resc.matvecs} operator "
                  f"applications)   Ra/Ra_c = {cfg.Ra / ra_c:.4f}")
            ok = resc.converged and np.isfinite(ra_c)
        else:
            print("No conduction branch (internal heating + conducting "
                  "sidewalls drive a base flow at every Ra): growth rates "
                  "are computed about the steady base state")
        if level >= 2 or not has_conduction_branch:
            base = None
            if level >= 3:
                Tb, xb, binfo = m.steady_newton(
                    m.conductive_state(amp=opts.get_real("amp", 0.05)),
                    warmup=opts.get_int("warmup", 150),
                    newton=NewtonConfig(rtol=1e-9, max_it=20, ksp_ew=True))
                print(f"Steady base: Nu = {binfo['nu_top']:.6f}  "
                      f"converged: {binfo['converged']}")
                ok = ok and binfo["converged"]
                base = (Tb, xb)
            res = m.stability_eigenvalues(k=opts.get_int("eps_nev", 3),
                                          m=opts.get_int("eps_ncv", 20),
                                          tol=opts.get_real("eps_tol", 1e-7), base=base)
            lams = ", ".join(f"{z.real:+.6f}{z.imag:+.2e}j" for z in res.eigenvalues)
            about = ("steady convecting state" if level >= 3
                     else ("steady base state" if not has_conduction_branch
                           else "conduction state"))
            print(f"Growth rates nearest 0 at Ra = {cfg.Ra} "
                  f"(about the {about}): [{lams}]  "
                  f"(converged: {res.converged})")
            verdict = "UNSTABLE" if max(z.real for z in res.eigenvalues) > 0 else "stable"
            print(f"The {about} is {verdict}")
            ok = ok and res.converged
        _print_unused(opts)
        return 0 if ok else 2
    T0 = m.conductive_state(amp=opts.get_real("amp", 0.05))
    nsteps = opts.get_int("nsteps", 0)
    if nsteps:
        T, _, x = m.rollout(T0, nsteps)
        info = {"steps": nsteps, **m._diagnostics(T, x), "converged": True}
    elif opts.has("newton"):
        # direct Newton-Krylov steady state (exact coupled Jacobian, one
        # Stokes solve a Krylov iteration)
        T, x, info = m.steady_newton(
            T0, warmup=opts.get_int("warmup", 150),
            newton=NewtonConfig(rtol=opts.get_real("snes_rtol", 1e-9),
                                max_it=opts.get_int("snes_max_it", 20),
                                ksp_ew=True, monitor=opts.has("monitor")))
        print(f"Newton: {int(info['newton'].iters)} steps, Krylov "
              f"{[int(i) for i in info['newton'].ksp_iters]}, "
              f"|R| = {info['rate']:.3e}")
    elif opts.has("accel"):
        # Anderson acceleration over the chunked time stepper (AA(m) with
        # the stepper as the nonlinear preconditioner)
        chunk = opts.get_int("chunk", 10)
        T, x, info = m.steady_accelerated(
            T0, m=opts.get_int("accel_m", 5), chunk=chunk,
            tol=opts.get_real("steady_tol", 1e-3),
            max_iters=opts.get_int("max_steps", 3000) // max(chunk, 1),
            warmup=opts.get_int("warmup", 100), monitor=opts.has("monitor"))
    elif opts.has("ts_adapt"):
        # variable-step marching (error controller, ringing and stall caps)
        T, x, info = m.march_adaptive(
            T0, max_steps=opts.get_int("max_steps", 3000),
            tol=opts.get_real("steady_tol", 1e-3),
            rtol=opts.get_real("ts_rtol", 3e-3),
            dt0=opts.get_real("ts_dt0", cfg.dt),
            monitor=opts.has("monitor"))
        print(f"  ts_adapt: {info['steps']} accepted / "
              f"{info['rejects']} rejected, dt {min(info['dts']):.3g}"
              f" .. {max(info['dts']):.3g}")
    else:
        T, x, info = m.march_to_steady(
            T0, max_steps=opts.get_int("max_steps", 3000),
            tol=opts.get_real("steady_tol", 1e-3),
            chunk=opts.get_int("chunk", 50),
            monitor=opts.has("monitor"))
    print(f"Steps: {info['steps']}   converged: {info['converged']}")
    print(f"Nu(top) = {info['nu_top']:.6f}   Nu(bottom) = "
          f"{info['nu_bottom']:.6f}   Nu(volume) = "
          f"{float(m.nusselt_volume(T, x)):.6f}")
    print(f"Vrms = {info['vrms']:.6f}")
    if opts.has("output_vtk"):
        from spectral_tpu_torch.utils.vtk import write_stokes_vtk
        write_stokes_vtk(m.stokes, x, "convection.vtk", extra_scalars={"temperature": T})
        print("Wrote convection.vtk")
    _print_unused(opts)
    return 0 if info["converged"] and np.isfinite(info["nu_top"]) else 2
