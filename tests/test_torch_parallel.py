"""The port's pencil mesh (ROADMAP item 7b) in 4 gloo processes on the CPU,
against the JAX package, float64.

One spawn of 4 processes (``_torch_parallel_worker.py``, a FileStore
rendezvous under tmp_path) runs every case on its slabs and returns the
gathered results; the module fixture holds them.  The pencil cases are
compared with the JAX package's own sharded functions on the
8-virtual-device CPU mesh (conftest); the pipelined pencil, the halo, the
stencil (whose sharded JAX programs compile for 5-6 s each) and the
models with its single-device results: the sharded Poisson solves take
the single-device iteration counts.  A second test brings up two processes
with ``initialize_distributed``, as tests/test_distributed.py does.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp

from spectral_tpu.grid import Grid as JGrid
from spectral_tpu.models.elliptic import EllipticModel as JElliptic
from spectral_tpu.models.poisson import PoissonModel as JPoisson
from spectral_tpu.models.stokes import StokesConfig as JStokesConfig
from spectral_tpu.models.stokes import StokesProblem as JStokes
from spectral_tpu.ops.chebyshev import chebdiff as j_chebdiff
from spectral_tpu.ops.stencil import poisson_fd_stencil as j_fd_stencil
from spectral_tpu.ops.stencil import shift as j_shift
from spectral_tpu.parallel.mesh import make_mesh as j_make_mesh
from spectral_tpu.parallel.pencil import chebdiff_pencil as j_pencil
from spectral_tpu.parallel.pencil import chebdiff_pencil2 as j_pencil2
from spectral_tpu.solvers.krylov import KSPConfig as JKSP
from spectral_tpu_torch.parallel import make_mesh

WORLD = 4
POISSON = {"poisson 1-axis": (16, 16), "poisson 2x2": (8, 8, 8),
           "poisson pipelined": (16, 12, 8)}


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    inp = {"u3": rng.standard_normal((16, 12, 5)), "u8": rng.standard_normal((16, 12, 8)),
           "u2": rng.standard_normal((12, 8)), "u4": rng.standard_normal((8, 12, 16)),
           "xh": rng.standard_normal((16, 7)), "xs": rng.standard_normal((16, 9))}
    for name, dims in POISSON.items():
        m = JPoisson(JGrid(dims))
        inp[f"b {name}"] = np.array(m.rhs(*m.exact_solution()))
    eu, eb, ed = JElliptic(JGrid((16, 12)), gamma=1.0).setup_problem(exact=0)
    inp.update(eu=np.array(eu), eb=np.array(eb), ed=np.array(ed))
    x = JStokes(JGrid((16, 12)), JStokesConfig(exact=2)).exact_state()
    inp.update(sv=np.array(x["v"]), sp=np.array(x["p"]))
    return inp


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """(inputs, the port's gathered results) from one 4-process run."""
    import _torch_parallel_worker as worker

    inp = _inputs()
    store = str(tmp_path_factory.mktemp("gloo") / "store")
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=worker.run, args=(r, WORLD, store, inp, queue))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        out = queue.get(timeout=600)
        for p in procs:
            p.join(timeout=120)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    assert "error" not in out, str(out["error"])
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return inp, out


def _close(got, want, atol):
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("case", ["pencil", "pipelined", "pencil2", "halo", "stencil"])
def test_pencil_and_halo_match_jax(port, case):
    inp, out = port
    if case == "pencil":   # an unsharded axis and the sharded one
        mesh = j_make_mesh({"x": 4})
        u = jnp.asarray(inp["u3"])
        for ax in range(3):
            _close(out[f"pencil {ax}"], j_pencil(u, ax, mesh), 1e-11)
    elif case == "pipelined":   # 2 and 4 chunks, the 2-D and unsharded fallbacks
        u = jnp.asarray(inp["u8"])
        for ch in (2, 4):
            _close(out[f"pipelined {ch}"], j_chebdiff(u, 0), 1e-11)
        _close(out["pipelined 2-D"], j_chebdiff(jnp.asarray(inp["u2"]), 0), 1e-11)
        _close(out["pipelined unsharded"], j_chebdiff(u, 1), 1e-11)
    elif case == "pencil2":   # a 2 x 2 mesh over grid axes 0 and 1
        mesh2 = j_make_mesh({"x": 2, "y": 2})
        u = jnp.asarray(inp["u4"])
        for ax in range(3):
            _close(out[f"pencil2 {ax}"], j_pencil2(u, ax, mesh2, {0: "x", 1: "y"}), 1e-11)
    elif case == "halo":   # zero fill at the global ends, exactly
        x = jnp.asarray(inp["xh"])
        for s in (-1, 1):
            for ax in (0, 1):
                _close(out[f"halo {s} {ax}"], j_shift(x, ax, s), 0.0)
    else:
        S = j_fd_stencil(JGrid((16, 9)))
        _close(out["stencil"], S.apply(jnp.asarray(inp["xs"])), 1e-12)


@pytest.mark.parametrize("name", list(POISSON))
def test_sharded_poisson_solve_matches_jax(port, name):
    """PoissonModel(mesh=) on one axis, on a 2 x 2 mesh and with the
    pipelined exchange, ``method="kernel"`` never reaching K2 (the worker
    makes K2 raise): the single-device iteration count and solution."""
    inp, out = port
    jm = JPoisson(JGrid(POISSON[name]))
    ref = jm.solve(jnp.asarray(inp[f"b {name}"]), ksp=JKSP(type="gmres", rtol=1e-10, max_it=100))
    assert int(out[f"{name} iters"]) == int(ref.iters)
    _close(out[f"{name} x"], ref.x, 1e-9)


def test_sharded_elliptic_and_stokes_match_jax(port):
    """The elliptic and Stokes residual and Jacobian action on slabs
    against the JAX package's single-device ones (the JAX tests' sizes and
    tolerances)."""
    inp, out = port
    jm = JElliptic(JGrid((16, 12)), gamma=1.0)
    u = jnp.asarray(inp["eu"])
    F, lin = jax.jit(jm.make_residual(jnp.asarray(inp["eb"]), jnp.asarray(inp["ed"])))(u)
    _close(out["elliptic F"], F, 1e-10)
    _close(out["elliptic Jw"], jm.jacobian_action(u, lin, u), 1e-9)
    jp = JStokes(JGrid((16, 12)), JStokesConfig(exact=2))
    x = {"v": jnp.asarray(inp["sv"]), "p": jnp.asarray(inp["sp"])}
    F, lin = jax.jit(jp.make_residual(jp.params_at(1)))(x)
    Jw = jp.jacobian_action(x, lin, x)
    for k in ("v", "p"):
        _close(out[f"stokes F {k}"], F[k], 1e-11)
    _close(out["stokes Jw v"], Jw["v"], 1e-10)
    _close(out["stokes Jw p"], Jw["p"], 1e-10)


def test_mesh_comm_path_follows_backend(port):
    """A mesh built as a user builds it (no device argument) on gloo
    stages the point-to-point exchange for CUDA tensors; the CPU slabs of
    the cases above went through it as they are.  A mesh of one process
    stages nothing."""
    _, out = port
    assert [str(s) for s in out["staged"]] == ["sendrecv"]
    assert str(out["comm_path"]) == ("gloo; CUDA tensors staged through pinned host memory: "
                                     "sendrecv")
    one = make_mesh({"x": 1})
    assert one.staged == frozenset() and one.comm_path == "none, tensors as they are"


def test_two_process_initialize_distributed_poisson(tmp_path):
    """Two OS processes brought up by ``initialize_distributed`` (gloo,
    FileStore rendezvous) solve the sharded Poisson problem at the
    one-process iteration count."""
    worker = os.path.join(os.path.dirname(__file__), "_torch_dist_worker.py")
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, worker, str(i), "2", store],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "DIST-OK" in text, f"process {i}:\n{text[-3000:]}"
    its = [[ln for ln in text.splitlines() if "DIST-OK" in ln][0].split("iters=")[1]
           for text in outs]
    assert its[0] == its[1]
