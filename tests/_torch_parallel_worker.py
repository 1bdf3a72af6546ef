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
    return out


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
