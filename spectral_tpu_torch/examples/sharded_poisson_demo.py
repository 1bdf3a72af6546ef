"""Demo: the 3-D Poisson solve on a process mesh, through ``parallel/``.

Counterpart of ``examples/sharded_poisson_demo.py``.  The grid's leading
axes are cut over a ``torch.distributed`` mesh of gloo processes (4: the
2 x 2 mesh ("x", "y"); 2: ("x",); 1: a mesh of one, in this process);
each process holds its slab, derivatives along a cut axis go through the
pencil all_to_all, and the GMRES inner products are summed over the mesh.
The iteration count equals the one-process solve's, which the demo runs
beside it.  The processes share the device (on one GPU, gloo stages the
CUDA tensors through host memory).

    python -m spectral_tpu_torch.examples.sharded_poisson_demo [-np 4] [-dim 16,16,16]
        [-device cuda|cpu]

Exit code 0 when the sharded solve took the one-process count and its
error is the one-process error (within 1e-10), 2 when not.
"""

from __future__ import annotations

import sys

MESHES = {1: ({"x": 1}, None), 2: ({"x": 2}, None), 4: ({"x": 2, "y": 2}, {0: "x", 1: "y"})}


def _solve(dims, device, mesh=None, axis_map=None):
    """(iterations, max error) of the GMRES / fastdiag solve, the field
    gathered from the slabs on a mesh."""
    import torch

    from spectral_tpu_torch.grid import Grid
    from spectral_tpu_torch.models.poisson import PoissonModel
    from spectral_tpu_torch.solvers.krylov import KSPConfig

    m = PoissonModel(Grid(dims, device=device, dtype=torch.float64), mesh=mesh,
                     axis_map=axis_map)
    u, f = m.exact_solution()
    res = m.solve(m.local(m.rhs(u, f)), ksp=KSPConfig(type="gmres", rtol=1e-10, max_it=100))
    return int(res.iters), float(torch.max(torch.abs(m.gather(res.x) - u)))


def _rank(rank: int, world: int, store: str, dims, device: str, queue) -> None:
    """One process of the mesh: puts (rank, iterations, error) or (rank,
    None, traceback) on ``queue``."""
    import traceback

    import torch.distributed as dist

    try:
        from spectral_tpu_torch.parallel import make_mesh

        dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                                world_size=world)
        axes, axis_map = MESHES[world]
        iters, err = _solve(dims, device, make_mesh(axes), axis_map)
        queue.put((rank, iters, err))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))
        raise


def _spawn(world: int, dims, device: str) -> tuple[int, float]:
    """Rank 0's (iterations, error) from ``world`` spawned processes."""
    import os
    import tempfile

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank, args=(r, world, os.path.join(tmp, "store"), dims,
                                                 device, queue)) for r in range(world)]
        try:
            for pr in procs:
                pr.start()
            got = [queue.get(timeout=600) for _ in range(world)]
            for pr in procs:
                pr.join(timeout=60)
        finally:
            for pr in procs:
                if pr.pid is not None and pr.is_alive():
                    pr.kill()
                    pr.join()
    failed = [f"rank {r}: {err}" for r, iters, err in got if iters is None]
    if failed:
        raise RuntimeError("\n".join(failed))
    return next((iters, err) for r, iters, err in got if r == 0)


def main(argv=None) -> int:
    from spectral_tpu_torch.cli.main import _setup
    from spectral_tpu_torch.parallel import make_mesh
    from spectral_tpu_torch.utils.options import Options

    opts = Options(argv if argv is not None else sys.argv[1:])
    device, _ = _setup(opts)
    world = opts.get_int("np", 4)
    if world not in MESHES:
        raise SystemExit(f"-np {world}: one of {sorted(MESHES)}")
    dims = tuple(opts.get_int_array("dim", (16, 16, 16)))
    axes, axis_map = MESHES[world]
    iters1, err1 = _solve(dims, device)
    if world == 1:
        iters, err = _solve(dims, device, make_mesh(axes), axis_map)
    else:
        iters, err = _spawn(world, dims, str(device))
    print(f"mesh {axes}  grid {dims}  device {device}")
    print(f"iterations {iters}  error {err:.2e}  (one process: iterations {iters1}, "
          f"error {err1:.2e})")
    return 0 if iters == iters1 and abs(err - err1) <= 1e-10 else 2


if __name__ == "__main__":
    raise SystemExit(main())
