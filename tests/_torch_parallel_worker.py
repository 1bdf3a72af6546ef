"""Worker of tests/test_torch_parallel.py: one gloo process of a 4-process
CPU mesh that runs every case of the port's pencil mesh on the slabs of
the inputs the parent made, gathers the results, and puts them (rank 0's)
on the parent's queue as numpy arrays.  Imports no JAX."""

import numpy as np
import torch
import torch.distributed as dist


def _cases(inp: dict) -> dict:
    from spectral_tpu_torch.grid import Grid
    from spectral_tpu_torch.models.elliptic import EllipticModel
    from spectral_tpu_torch.models.poisson import PoissonModel
    from spectral_tpu_torch.models.stokes import StokesConfig, StokesProblem
    from spectral_tpu_torch.ops import cuda_cheb
    from spectral_tpu_torch.ops.stencil import StencilOp, poisson_fd_stencil
    from spectral_tpu_torch.parallel import (chebdiff_pencil, chebdiff_pencil2,
                                             chebdiff_pencil_pipelined, gather_tensor,
                                             halo_shift, make_mesh, shard_tensor,
                                             stencil_apply_sharded)
    from spectral_tpu_torch.solvers.krylov import KSPConfig

    f64 = torch.float64
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    out = {}
    mesh = make_mesh({"x": 4})
    one = {0: "x"}

    def sh(a, m=mesh, am=one):
        return shard_tensor(a, m, am)

    def ga(a, m=mesh, am=one):
        return gather_tensor(a, m, am).numpy()

    for ax in range(3):
        out[f"pencil {ax}"] = ga(chebdiff_pencil(sh(t["u3"]), ax, mesh))
    for ch in (2, 4):
        out[f"pipelined {ch}"] = ga(chebdiff_pencil_pipelined(sh(t["u8"]), 0, mesh, chunks=ch))
    out["pipelined 2-D"] = ga(chebdiff_pencil_pipelined(sh(t["u2"]), 0, mesh, chunks=2))
    out["pipelined unsharded"] = ga(chebdiff_pencil_pipelined(sh(t["u8"]), 1, mesh, chunks=2))
    for s in (-1, 1):
        for ax in (0, 1):
            out[f"halo {s} {ax}"] = ga(halo_shift(sh(t["xh"]), ax, s, mesh))
    S = poisson_fd_stencil(Grid((16, 9), device="cpu", dtype=f64))
    Sl = StencilOp(sh(S.center), tuple(sh(a) for a in S.lower), tuple(sh(a) for a in S.upper))
    out["stencil"] = ga(stencil_apply_sharded(Sl, sh(t["xs"]), mesh))
    mesh2 = make_mesh({"x": 2, "y": 2})
    two = {0: "x", 1: "y"}
    for ax in range(3):
        out[f"pencil2 {ax}"] = ga(chebdiff_pencil2(sh(t["u4"], mesh2, two), ax, mesh2, two),
                                  mesh2, two)
    ksp = KSPConfig(type="gmres", rtol=1e-10, max_it=100)

    def kernel_refused(*a, **k):
        raise AssertionError("K2 offered a slab")

    k2 = cuda_cheb.laplacian3d
    cuda_cheb.laplacian3d = kernel_refused   # method="kernel" must keep off K2
    try:
        for name, dims, kw, m, am in (
                ("poisson 1-axis", (16, 16), {}, mesh, one),
                ("poisson 2x2", (8, 8, 8), {"axis_map": two}, mesh2, two),
                ("poisson pipelined", (16, 12, 8), {"pipeline_chunks": 2}, mesh, one)):
            pm = PoissonModel(Grid(dims, device="cpu", dtype=f64), method="kernel", mesh=m, **kw)
            res = pm.solve(pm.local(t[f"b {name}"]), ksp=ksp)
            out[f"{name} x"] = ga(res.x, m, am)
            out[f"{name} iters"] = np.asarray(res.iters)
    finally:
        cuda_cheb.laplacian3d = k2
    g = Grid((16, 12), device="cpu", dtype=f64)
    em = EllipticModel(g, gamma=1.0, mesh=mesh)
    F, lin = em.make_residual(sh(t["eb"]), sh(t["ed"]))(sh(t["eu"]))
    out["elliptic F"] = ga(F)
    out["elliptic Jw"] = ga(em.jacobian_action(sh(t["eu"]), lin, sh(t["eu"])))
    sp = StokesProblem(g, StokesConfig(exact=2), mesh=mesh)
    x = {"v": sh(t["sv"]), "p": sh(t["sp"])}
    F, lin = sp.make_residual(sp.params_at(1))(x)
    Jw = sp.jacobian_action(x, lin, x)
    for k in ("v", "p"):
        out[f"stokes F {k}"] = ga(F[k])
        out[f"stokes Jw {k}"] = ga(Jw[k])
    out["comm_path"] = np.asarray(mesh.comm_path)
    out["staged"] = np.asarray(sorted(mesh.staged))
    _solves(out, t, mesh, mesh2)
    return out


def _solves(out: dict, t: dict, mesh, mesh2) -> None:
    """The sharded solves: Poisson with every PC and on a mapped grid, a
    data-parallel batch, the full Stokes Newton solve (one axis, 2 x 2,
    curved, pipelined, traction rows), the elliptic Newton solve, the
    unsteady step, the convection step and step_dt, the zero-flux fastdiag
    apply.  Each records its counts and its gathered result."""
    import time

    from spectral_tpu_torch.grid import Grid
    from spectral_tpu_torch.models.convection import ConvectionConfig, ConvectionModel
    from spectral_tpu_torch.models.elliptic import EllipticModel
    from spectral_tpu_torch.models.poisson import PoissonModel
    from spectral_tpu_torch.models.stokes import StokesConfig, StokesProblem
    from spectral_tpu_torch.models.stokes_unsteady import UnsteadyStokes
    from spectral_tpu_torch.ops.curvilinear import named_map
    from spectral_tpu_torch.ops.fastdiag import FastDiagSolver
    from spectral_tpu_torch.ops.mapping import AxisMap
    from spectral_tpu_torch.parallel.slab import Slab
    from spectral_tpu_torch.solvers.krylov import KSPConfig
    from spectral_tpu_torch.solvers.newton import NewtonConfig

    f64 = torch.float64
    slab = Slab.of(mesh)
    secs = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        fn()
        secs[name] = time.perf_counter() - t0

    def poisson():
        ksp = KSPConfig(type="gmres", rtol=1e-10, max_it=300)
        for pc in ("jacobi", "mg", "lu", "none"):
            pm = PoissonModel(Grid((16, 16), device="cpu", dtype=f64), mesh=mesh)
            r = pm.solve(pm.local(t["b poisson 1-axis"]), ksp=ksp, pc_type=pc)
            out[f"poisson {pc} x"], out[f"poisson {pc} iters"] = slab.gather(r.x).numpy(), r.iters
        from spectral_tpu_torch.models.curvilinear import CurvilinearPoisson

        cp = CurvilinearPoisson(Grid((16, 12), device="cpu", dtype=f64),
                                named_map("annulus:1:2"), mesh=mesh)
        u, b = cp.manufactured(lambda x: np.sin(x[..., 0]) * x[..., 1],
                               lambda x: -np.sin(x[..., 0]) * x[..., 1])
        for pc in ("mg", "jacobi"):
            r = cp.solve(cp.local(b), pc_type=pc)
            out[f"curved poisson {pc} x"] = slab.gather(r.x).numpy()
            out[f"curved poisson {pc} iters"] = r.iters
        maps = (AxisMap.tanh_cluster(0.0, 2.0, 16, 1.5), AxisMap.kte(-1.0, 1.0, 16, 0.9))
        for pc in ("fastdiag", "mg"):
            pm = PoissonModel(Grid((16, 16), maps=maps, device="cpu", dtype=f64), mesh=mesh)
            b = pm.rhs(*pm.exact_solution())
            r = pm.solve(pm.local(b), ksp=ksp, pc_type=pc)
            out[f"poisson mapped {pc} x"] = slab.gather(r.x).numpy()
            out[f"poisson mapped {pc} iters"] = r.iters

    def dp():   # the batch cut over the mesh's axis: a member a process
        pd = PoissonModel(Grid((12, 12), device="cpu", dtype=f64))
        b1 = pd.rhs(*pd.exact_solution())
        for name, sc in (("dp", t["dp scales"]), ("dp vmap", torch.arange(1.0, 5.0, dtype=f64))):
            r = KSPConfig(type="gmres", rtol=1e-10, max_it=200).solve_batched(
                pd.operator, sc[:, None, None] * b1[None], M=pd.build_pc("fastdiag"), mesh=mesh)
            out[f"{name} x"], out[f"{name} iters"] = r.x.numpy(), r.iters
        out["dp u"] = pd.exact_solution()[0].numpy()

    def stokes():
        cfg = StokesConfig(exact=2, cont0=1)
        for name, dims, c, kw, am in (
                ("1-axis", (12, 12), cfg, dict(mesh=mesh), None),
                ("2x2", (12, 12, 8), cfg, dict(mesh=mesh2, axis_map={0: "x", 1: "y"}),
                 {0: "x", 1: "y"}),
                ("curved", (12, 12), StokesConfig(exact=1, pcvel="mg"),
                 dict(mesh=mesh, phi=named_map("bump:0.07")), None),
                ("pipelined", (12, 12, 8), cfg, dict(mesh=mesh, pipeline_chunks=2), None),
                ("tbc", (12, 12), StokesConfig(exact=1, boundary=3, tbc=1, traction_p=True),
                 dict(mesh=mesh), None)):
            p = StokesProblem(Grid(dims, device="cpu", dtype=f64), c, **kw)
            r = p.solve()
            out[f"stokes {name} v"] = p.slab.gather(r.x["v"]).numpy()
            out[f"stokes {name} iters"] = np.asarray([r.iters] + list(r.ksp_iters))

    def elliptic():
        g = Grid((16, 12), device="cpu", dtype=f64)
        em = EllipticModel(g, gamma=1.0, mesh=mesh)
        u, b, d = EllipticModel(g, gamma=1.0).setup_problem(exact=0)
        for pc in ("fastdiag", "jacobi", "mg"):
            r = em.solve(em.local(b), em.local(d), pc_type=pc,
                         newton=NewtonConfig(rtol=1e-10, max_it=20))
            out[f"elliptic {pc} x"] = slab.gather(r.x).numpy()
            out[f"elliptic {pc} iters"] = np.asarray([r.iters] + list(r.ksp_iters))
        ep = EllipticModel(g, gamma=1.0, mesh=mesh, phi=named_map("bump:0.08"))
        u, b, d = EllipticModel(g, gamma=1.0, phi=named_map("bump:0.08")).setup_problem(exact=0)
        r = ep.solve(ep.local(b), ep.local(d), pc_type="mg")
        out["elliptic curved x"] = slab.gather(r.x).numpy()
        out["elliptic curved iters"] = np.asarray([r.iters] + list(r.ksp_iters))

    def steps():
        ucfg = StokesConfig(exact=1, boundary=0, pcvel="fastdiag",
                            outer_ksp=KSPConfig(type="fgmres", rtol=1e-10, max_it=200,
                                                restart=100))
        um = UnsteadyStokes(Grid((12, 12), device="cpu", dtype=f64), ucfg, dt=0.05, theta=0.5,
                            mesh=mesh)
        u0, sf, ff, _, _ = um.manufactured(omega=1.0)
        v, pr, it, _ = um.step(u0, sf(0.05), 0.5 * ff(0.05) + 0.5 * ff(0.0))
        out.update({"unsteady v": slab.gather(v).numpy(), "unsteady p": slab.gather(pr).numpy(),
                    "unsteady iters": np.asarray([it])})
        r = torch.from_numpy(np.random.default_rng(7).standard_normal((12, 12)))
        for nm in (0, 1):
            fd = FastDiagSolver.build(Grid((12, 12), device="cpu", dtype=f64), shift=1.0,
                                      neumann_axes=(nm,))
            out[f"neumann fastdiag {nm}"] = slab.gather(fd.apply(slab.local(r),
                                                                 slab=slab)).numpy()
        out["neumann r"] = r.numpy()

    def convection():
        ccfg = ConvectionConfig(Ra=5e3, dt=1e-3, velocity_bc="freeslip", side_bc="insulated",
                                stokes_ksp=KSPConfig(type="fgmres", rtol=1e-10, max_it=150,
                                                     restart=60))
        cm = ConvectionModel.unit_box((12, 12), ccfg, device="cpu", mesh=mesh)
        T0 = cm.conductive_state(amp=0.05)
        x0 = cm.solve_stokes(T0, cm.stokes.zero_state())
        carry = (T0, cm.advection(cm.velocity_full(x0.x), T0), x0.x)   # init_carry
        T1, _, x1 = cm.step(*carry)
        Td, Nd, _ = cm.step_dt(*carry, 7e-4, 0.8)
        out.update({"convection T0": slab.gather(T0).numpy(),
                    "convection T": slab.gather(T1).numpy(),
                    "convection v": slab.gather(x1["v"]).numpy(),
                    "convection Tdt": slab.gather(Td).numpy(),
                    "convection Ndt": slab.gather(Nd).numpy(),
                    "convection iters": np.asarray([x0.iters]),
                    "convection nu": np.asarray([float(cm.nusselt_top(T1)),
                                                 float(cm.vrms(x1))])})

    for name, fn in (("poisson", poisson), ("dp", dp), ("stokes", stokes),
                     ("elliptic", elliptic), ("steps", steps), ("convection", convection)):
        timed(name, fn)
    out["seconds"] = secs


def run(rank: int, world: int, store: str, inp: dict, queue) -> None:
    import traceback

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                                world_size=world)
        out = _cases(inp)
        if rank == 0:
            queue.put(out)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        queue.put({"error": np.asarray(traceback.format_exc())})
        raise
