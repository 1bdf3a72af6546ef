"""Worker of tests/test_torch_parallel.py's two-process test: one process
of a 2-process gloo run brought up by the port's
``parallel.mesh.initialize_distributed`` (a FileStore rendezvous), which
solves the 16x16 Poisson problem on its slab of a mesh {"x": 2} and
checks it against its own one-process solve: the same iteration count
and matching slabs.  Imports no JAX.

Usage: python _torch_dist_worker.py <rank> <world size> <store file>
"""

import sys

import torch


def main() -> int:
    rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    from spectral_tpu_torch.grid import Grid
    from spectral_tpu_torch.models.poisson import PoissonModel
    from spectral_tpu_torch.parallel import initialize_distributed, make_mesh
    from spectral_tpu_torch.solvers.krylov import KSPConfig

    torch.set_num_threads(1)
    initialize_distributed(backend="gloo", init_method=f"file://{store}",
                           world_size=world, rank=rank)
    initialize_distributed(backend="gloo", init_method=f"file://{store}",
                           world_size=world, rank=rank)   # a no-op the second time
    import torch.distributed as dist

    if dist.get_world_size() != world:
        print(f"FAIL: world size {dist.get_world_size()} != {world}")
        return 1
    g = Grid((16, 16), device="cpu", dtype=torch.float64)
    ref = PoissonModel(g)
    u, f = ref.exact_solution()
    b = ref.rhs(u, f)
    ksp = KSPConfig(type="gmres", rtol=1e-10, max_it=100)
    res_ref = ref.solve(b, ksp=ksp)
    m = PoissonModel(g, mesh=make_mesh({"x": world}))
    res = m.solve(m.local(b), ksp=ksp)
    ok = res.iters == res_ref.iters and bool(
        torch.allclose(res.x, m.local(res_ref.x), rtol=0, atol=1e-9))
    print(f"DIST-{'OK' if ok else 'FAIL'} rank={rank} iters={res.iters} "
          f"ref_iters={res_ref.iters}", flush=True)
    dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
