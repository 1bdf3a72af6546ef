"""The port's Poisson main path end to end against the JAX package: the
model solve, mixed-precision refinement (host loop and device loop), the
CLI, and the package's hygiene (no jax, precision policy, no silent CPU)."""

import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectral_tpu.cli.drivers import poisson_main as j_poisson_main
from spectral_tpu.grid import Grid as JGrid
from spectral_tpu.models.poisson import PoissonModel as JPoisson
from spectral_tpu.ops.chebyshev import diffmat_np
from spectral_tpu.ops.fastdiag import FastDiagSolver as JFastDiag
from spectral_tpu.solvers.krylov import KSPConfig as JKSP
from spectral_tpu.solvers.refinement import refine_solve as j_refine_solve
from spectral_tpu.utils.options import Options as JOptions
from spectral_tpu_torch.cli.main import main as t_main
from spectral_tpu_torch.grid import Grid
from spectral_tpu_torch.models.poisson import PoissonModel
from spectral_tpu_torch.solvers.krylov import KSPConfig
from spectral_tpu_torch.solvers.refinement import (build_fused_refiner, refine_solve,
                                                   refine_solve_fused)
from spectral_tpu_torch.solvers.types import ConvergedReason

ROOT = Path(__file__).resolve().parent.parent
N = 12


def test_poisson_solve_matches_jax():
    jm = JPoisson(JGrid((N, N, N)))
    ju, jf = jm.exact_solution()
    jres = jm.solve(jm.rhs(ju, jf))
    jerr = float(jnp.max(jnp.abs(jres.x - ju)))
    tm = PoissonModel(Grid((N, N, N), device="cpu"))
    tu, tf = tm.exact_solution()
    tres = tm.solve(tm.rhs(tu, tf))
    terr = float(torch.max(torch.abs(tres.x - tu)))
    assert tres.iters == int(jres.iters) == 7
    assert tres.reason == int(jres.reason) == ConvergedReason.CONVERGED_RTOL
    # the discretisation error at 12^3 is ~1e-10; the two solves agree on
    # it to 1e-12 absolute (rtol 1e-10 solves of the same system)
    assert abs(terr - jerr) <= 1e-12, (terr, jerr)


def test_kernel_operator_matches_composed_and_jax():
    """method="kernel" (K2's plain version on CPU) and the composed path
    (K1's plain version on the last axis) against the JAX operator."""
    g = Grid((N, 10, 8), intervals=((0.0, 2.0), (-1.0, 1.0), (-3.0, 1.0)),
             device="cpu")
    jg = JGrid(g.dims, intervals=g.intervals)
    x = np.random.default_rng(5).standard_normal(g.dims)
    ref = np.asarray(JPoisson(jg).operator(jnp.asarray(x)))
    scale = np.max(np.abs(ref))
    for method in ("auto", "kernel"):
        got = PoissonModel(g, method=method).operator(torch.from_numpy(x)).numpy()
        # scale-normalised 1e-11: D2 precombined vs D applied twice
        np.testing.assert_allclose(got / scale, ref / scale, atol=1e-11, rtol=0)


def _jax_refine(dims):
    """The bench_poisson64 recipe at a small size: float32 inner GMRES with
    a float32 fastdiag PC, float64 host residuals through dense D^2."""
    jg = JGrid(dims)
    jm = JPoisson(jg)
    M = JFastDiag.build(jg, dtype=jnp.float32)
    ksp = JKSP(type="gmres", rtol=1e-6, max_it=60, restart=30)
    inner_jit = jax.jit(lambda r: ksp.solve(jm.operator, r, M=M))

    def inner(r32):
        res = inner_jit(r32)
        return res.x, res.iters

    return inner


def _host_A_hi(dims):
    bm = JGrid(dims).boundary_mask_np
    n = dims[0]
    D2T = (diffmat_np(n) @ diffmat_np(n)).T.copy()

    def A_hi(x):  # float64 on the host, numpy in and out
        y = np.zeros_like(x)
        for ax in range(3):
            z = np.moveaxis(x, ax, -1)
            y -= np.moveaxis((z.reshape(-1, n) @ D2T).reshape(z.shape), -1, ax)
        return np.where(bm, x, y)

    return A_hi


def test_refinement_matches_jax():
    dims = (N, N, N)
    g = Grid(dims, device="cpu")
    u = np.prod(np.cos(0.5 * np.pi * g.coords_np), axis=-1)
    b = np.where(g.boundary_mask_np, u, 3.0 * (0.5 * np.pi) ** 2 * u)
    A_hi = _host_A_hi(dims)
    jout = j_refine_solve(A_hi, _jax_refine(dims), b, rtol=1e-10, max_refine=8)

    tm = PoissonModel(g, method="kernel")
    M = tm.build_pc("fastdiag", dtype=torch.float32)
    ksp = KSPConfig(type="gmres", rtol=1e-6, max_it=60, restart=30)

    def inner(r32):
        res = ksp.solve(tm.operator, r32, M=M)
        assert res.x.dtype == torch.float32
        return res.x, res.iters

    host = refine_solve(A_hi, inner, b, device="cpu", rtol=1e-10, max_refine=8)
    dev = refine_solve_fused(tm.operator, inner, torch.from_numpy(b),
                             rtol=1e-10, max_refine=8)
    again = build_fused_refiner(tm.operator, inner, max_refine=8)(
        torch.from_numpy(b), rtol=1e-10)
    bnorm = np.linalg.norm(b)
    for out in (host, dev, again):
        assert out.reason == ConvergedReason.CONVERGED_RTOL
        assert out.refine_steps == jout.refine_steps
        # float32 inner solves sum in another order: +-2 iterations
        assert abs(out.inner_iters - jout.inner_iters) <= 2
        assert out.rnorm / bnorm <= 1e-10
        x = out.x.numpy() if isinstance(out.x, torch.Tensor) else out.x
        assert np.max(np.abs(x - u)) <= 1e-9  # the 12^3 discretisation error
    assert dev.x.dtype == torch.float64


def test_fused_refinement_rejects_a_widening_inner_solve():
    tm = PoissonModel(Grid((8, 8, 8), device="cpu"))
    b = torch.ones((8, 8, 8), dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        refine_solve_fused(tm.operator, lambda r: (r.double(), 1), b)


def _iterations(text: str) -> int:
    return int(re.search(r"iterations (\d+)", text).group(1))


def test_cli_poisson_matches_jax_cli(capsys):
    args = ["-m", str(N), "-n", str(N), "-p", str(N), "-ksp_rtol", "1e-10"]
    assert j_poisson_main(JOptions(args)) == 0
    jout = capsys.readouterr().out
    assert t_main(["poisson", *args, "-device", "cpu"]) == 0
    tout = capsys.readouterr().out
    assert _iterations(tout) == _iterations(jout) == 7
    assert "WARNING" not in tout


def test_cli_cheb_runs(capsys):
    assert t_main(["cheb", "-m1", "9", "-m", "8", "-n", "7", "-p", "6", "-d", "1",
                   "-device", "cpu"]) == 0
    errs = [float(v) for v in re.findall(r"Norm of error (\S+)", capsys.readouterr().out)]
    assert len(errs) == 2 and max(errs) < 1e-3


def test_lu_pc_iteration_count_equals_fastdiag():
    """fastdiag and dense LU solve the same surrogate exactly, so the
    Krylov counts agree (the JAX package's lu cross-check)."""
    m = PoissonModel(Grid((N, N, N), device="cpu"))
    u, f = m.exact_solution()
    b = m.rhs(u, f)
    its = {pc: m.solve(b, pc_type=pc).iters for pc in ("fastdiag", "lu")}
    assert its["lu"] == its["fastdiag"] == 7


def test_mg_pc_matches_jax():
    """pc_type "mg" (two residual-corrected V-cycles an apply): the JAX
    package's iteration count and converged reason."""
    dims = (12, 12)
    jm = JPoisson(JGrid(dims))
    ju, jf = jm.exact_solution()
    jres = jm.solve(jm.rhs(ju, jf), pc_type="mg")
    tm = PoissonModel(Grid(dims, device="cpu"))
    tu, tf = tm.exact_solution()
    tres = tm.solve(tm.rhs(tu, tf), pc_type="mg")
    assert tres.iters == int(jres.iters)
    assert tres.reason == int(jres.reason) == ConvergedReason.CONVERGED_RTOL
    assert float(torch.max(torch.abs(tres.x - tu))) <= 1e-9


def test_unported_paths_raise():
    g = Grid((8, 8), device="cpu")
    # mesh= runs on slabs with every PC, mapped grids too
    # (tests/test_torch_parallel.py); an unknown PC raises
    from spectral_tpu_torch.ops.mapping import AxisMap
    from spectral_tpu_torch.parallel import make_mesh

    mesh1 = make_mesh({"x": 1})
    with pytest.raises(ValueError, match="unknown pc_type"):
        PoissonModel(g, mesh=mesh1).build_pc("ilu")
    pm = PoissonModel(Grid((8, 8), maps=(AxisMap.affine(0.0, 1.0, 8),) * 2, device="cpu"),
                      mesh=mesh1)
    assert pm.build_pc("mg") is not None
    # axis maps and -map run (tests/test_torch_curvilinear.py); a map per
    # axis, and -map excludes -domain, as in the JAX package
    with pytest.raises(ValueError, match="one AxisMap per axis"):
        Grid((8, 8), maps=(AxisMap.affine(0.0, 1.0, 8),), device="cpu")
    with pytest.raises(SystemExit, match="mutually exclusive"):
        t_main(["poisson", "-m", "8", "-n", "8", "-map", "bump:0.1", "-domain", "0,1,0,1",
                "-device", "cpu"])


def test_device_cuda_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_main(["poisson", "-m", "8", "-n", "8"])


def test_precision_policy_is_set():
    """Importing the package sets full-float32 products (no TF32)."""
    import spectral_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_package_never_imports_jax():
    """Import every module of the port in a fresh interpreter; neither jax
    nor the JAX package may be loaded.  Also scan the sources, which
    catches imports inside functions."""
    code = ("import importlib, pkgutil, sys, spectral_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, 'spectral_tpu_torch.'):\n"
            "    if not m.name.endswith('__main__'):\n"
            "        importlib.import_module(m.name)\n"
            "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
            "       or k == 'spectral_tpu' or k.startswith('spectral_tpu.')]\n"
            "print('LOADED', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout
    pat = re.compile(r"^\s*(import jax|from jax|import spectral_tpu\b(?!_torch)"
                     r"|from spectral_tpu(\.| )(?!_torch))", re.M)
    for src in list((ROOT / "spectral_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        assert not pat.search(src.read_text()), src


def test_mapped_poisson_solve_matches_jax():
    """Grid(maps=...) through the Poisson model (2-D, tanh-clustered and
    Kosloff-Tal-Ezer axes): the fastdiag solve on the physical nodes has
    the JAX solve's count and error."""
    from spectral_tpu.ops.mapping import AxisMap as JAxisMap
    from spectral_tpu_torch.ops.mapping import AxisMap

    dims = (14, 12)

    def maps(pkg):
        return (pkg.tanh_cluster(0.0, 2.0, dims[0], 1.5), pkg.kte(0.0, 1.0, dims[1], 0.9))

    jm = JPoisson(JGrid(dims, maps=maps(JAxisMap)))
    ju, jf = jm.exact_solution()
    jres = jm.solve(jm.rhs(ju, jf))
    tm = PoissonModel(Grid(dims, maps=maps(AxisMap), device="cpu"))
    tu, tf = tm.exact_solution()
    tres = tm.solve(tm.rhs(tu, tf))
    assert tres.iters == int(jres.iters) and tres.reason == int(jres.reason)
    assert abs(float(torch.max(torch.abs(tres.x - tu))) - float(jnp.max(jnp.abs(jres.x - ju)))) \
        <= 1e-12
