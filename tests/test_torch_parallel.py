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

The sharded solves (ROADMAP item 7c) run in the same spawn: each holds
the port on slabs to the JAX package's single-device result of the JAX
test it mirrors (``tests/test_parallel.py``, whose own assertions show
sharded equal to single device), with the counts equal and x within the
JAX test's tolerance.  The single-device JAX solves that would not fit
the CPU budget live are ``stokes_oracle.py parallel``'s, recorded in
``tests/data/torch_parallel_oracle.npz``.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp

from spectral_tpu.ops.fastdiag import FastDiagSolver as JFastDiag
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
ORACLE_NPZ = os.path.join(os.path.dirname(__file__), "data", "torch_parallel_oracle.npz")
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
    inp["dp scales"] = np.random.default_rng(3).uniform(0.5, 2.0, size=4)
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


@pytest.fixture(scope="module")
def oracle():
    return np.load(ORACLE_NPZ)


def _counts(out, oracle, key):
    assert np.asarray(out[f"{key} iters"]).tolist() == oracle[f"{key} iters"].tolist(), key


@pytest.mark.parametrize("pc", ["jacobi", "mg", "lu", "none", "mapped fastdiag",
                                "mapped mg"])
def test_sharded_poisson_every_pc_matches_jax(port, oracle, pc):
    """PoissonModel(mesh=) with every build_pc type (multigrid with its
    coarse levels replicated, dense LU replicated) and on a mapped grid
    (the chain-rule weights cut to the slab): the single-device JAX
    count and solution (JAX test_parallel.py:65's tolerance); the curved
    annulus Poisson on slabs (CurvilinearPoisson(mesh=)) at the
    single-device JAX count, x to 1e-11 (the curved tolerance)."""
    _, out = port
    key = f"poisson {pc}" if not pc.startswith("mapped") else f"poisson mapped {pc[7:]}"
    assert int(out[f"{key} iters"]) == int(oracle[f"{key} iters"][0])
    _close(out[f"{key} x"], oracle[f"{key} x"], 1e-9)
    if pc in ("mg", "jacobi"):
        key = f"curved poisson {pc}"
        assert int(out[f"{key} iters"]) == int(oracle[f"{key} iters"][0])
        _close(out[f"{key} x"], oracle[f"{key} x"], 1e-11)


def test_sharded_data_parallel_batches_match_jax(port, oracle):
    """solve_batched(mesh=) cuts the batch over the mesh axis (JAX
    test_parallel.py:87 and :365): per-member counts equal the unsharded
    JAX batch's, x to 1e-12; the dp batch of scales 1-4 is u * s."""
    _, out = port
    _counts(out, oracle, "dp")
    _close(out["dp x"], oracle["dp x"], 1e-12)
    u = out["dp u"]
    for i, s in enumerate([1.0, 2.0, 3.0, 4.0]):
        _close(out["dp vmap x"][i], u * s, 1e-7)


@pytest.mark.parametrize("case,atol", [("1-axis", 1e-12), ("2x2", 1e-9), ("curved", 1e-11),
                                       ("pipelined", 1e-8), ("tbc", 1e-11)])
def test_sharded_stokes_newton_solve_matches_jax(port, oracle, case, atol):
    """The full sharded Stokes Newton solve with its nested PC on slabs
    (JAX test_parallel.py:243, :267, :292, :394 at their sizes and
    tolerances; the pipelined run is :394's (12, 12, 8), whose
    single-device solve is 2 x 2's): the single-device Newton and FGMRES
    counts and velocity.  "tbc": Neumann rows with the line and
    traction-block corrections on a mesh."""
    _, out = port
    ref = "2x2" if case == "pipelined" else case
    assert out[f"stokes {case} iters"].tolist() == oracle[f"stokes {ref} iters"].tolist()
    _close(out[f"stokes {case} v"], oracle[f"stokes {ref} v"], atol)


@pytest.mark.parametrize("pc", ["fastdiag", "jacobi", "mg"])
def test_sharded_elliptic_newton_solve_matches_jax(port, oracle, pc):
    """JAX test_parallel.py:221 carried on to a full sharded Newton solve
    with the model's PC on slabs: the single-device counts, x to 1e-9;
    and the curved (phi=) mg solve on a mesh at the single-device JAX
    Newton and FGMRES counts, x to 1e-11."""
    _, out = port
    _counts(out, oracle, f"elliptic {pc}")
    _close(out[f"elliptic {pc} x"], oracle[f"elliptic {pc} x"], 1e-9)
    _counts(out, oracle, "elliptic curved")
    _close(out["elliptic curved x"], oracle["elliptic curved x"], 1e-11)


def test_sharded_unsteady_step_and_neumann_fastdiag_match_jax(port, oracle):
    """The unsteady CN step on slabs (JAX test_parallel.py:423: count
    equal, v and p to 1e-9) and the zero-flux fastdiag apply along the
    sharded and the unsharded axis (:489, against the JAX apply live, to
    1e-12: the mask/roll form on slabs)."""
    _, out = port
    _counts(out, oracle, "unsteady")
    _close(out["unsteady v"], oracle["unsteady v"], 1e-9)
    _close(out["unsteady p"], oracle["unsteady p"], 1e-9)
    r = jnp.asarray(out["neumann r"])
    for nm in (0, 1):
        fd = JFastDiag.build(JGrid((12, 12)), shift=1.0, neumann_axes=(nm,))
        _close(out[f"neumann fastdiag {nm}"], fd.apply(r), 1e-12)


def test_sharded_convection_step_matches_jax(port, oracle):
    """The coupled convection step and the traced-dt step on slabs (JAX
    test_parallel.py:454 and :515): the Stokes count of the cold solve, T
    to 1e-9, v to 1e-8; step_dt's T to 1e-9 and N to 1e-8."""
    _, out = port
    _close(out["convection T0"], oracle["convection T0"], 1e-14)
    _counts(out, oracle, "convection")
    _close(out["convection T"], oracle["convection T"], 1e-9)
    _close(out["convection v"], oracle["convection v"], 1e-8)
    _close(out["convection Tdt"], oracle["convection Tdt"], 1e-9)
    _close(out["convection Ndt"], oracle["convection Ndt"], 1e-8)
