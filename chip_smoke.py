#!/usr/bin/env python3
"""Smoke test of the PyTorch port (spectral_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, holds each
against its plain PyTorch version on the card, then drives the Poisson
main path at its real size (64^3, rtol 1e-10) through the entry points a
user calls:

  0. identify the card; build the kernels (timed);
  1. K1 chebdiff_last_kernel against chebdiff_last_ref;
  2. K2 laplacian3d_kernel against laplacian3d_ref;
  3. main path A: the CLI, ``poisson -m 64 -n 64 -p 64 -ksp_rtol 1e-10``
     in float64 (K1 on the last axis of the composed operator);
  4. main path B: mixed-precision refinement at 64^3, float32 GMRES on the
     fused Laplacian (K2) with a float32 fastdiag PC, float64 residuals,
     through ``refine_solve`` and ``refine_solve_fused``.

Every phase raises on failure.  Before the last line it prints the kernels
as JSON (launch counts from phases 3-4 only, errors and median times from
phases 1-2); the last line is {"ok": true, "device": {...}}.  Without CUDA
it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import statistics
import subprocess
import sys
import time

SOURCE = "spectral_tpu_torch/csrc/cheb_kernels.cu"
REPLACES = {"chebdiff_last_kernel": "spectral_tpu/ops/pallas_cheb.py:34",
            "laplacian3d_kernel": "spectral_tpu/ops/pallas_cheb.py:81"}
BOUND = {"float32": 1e-5, "float64": 1e-12}   # max |kernel - plain| / max |plain|


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps: int = 15, inner: int = 5) -> float:
    """Median device milliseconds per call, from CUDA events around
    ``inner`` back-to-back calls, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def timed_twice(run, warm_reps: int = 2):
    """(result, first_s, best_warm_s): the first call pays one-time costs
    (library handles, allocator growth, constant uploads); the best warm
    call is the solve time."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    best, out = float("inf"), None
    for _ in range(warm_reps):
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return out, first, best


def compare(name, kernel, plain, u, case) -> dict:
    import torch

    got = kernel()
    ref = plain()
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got).all()), f"{name} {case}: non-finite output")
    abs_err = float(torch.max(torch.abs(got - ref)))
    rel = abs_err / float(torch.max(torch.abs(ref)))
    dtype = str(u.dtype).replace("torch.", "")
    require(rel <= BOUND[dtype], f"{name} {case}: error {rel:.3e} > {BOUND[dtype]:.0e}")
    return {"case": case, "dtype": dtype, "rel_err": rel, "max_abs_err": abs_err,
            "ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this test runs on the GPU only",
              file=sys.stderr)
        return 1
    import numpy as np

    from spectral_tpu_torch.cli.main import main as cli_main
    from spectral_tpu_torch.grid import Grid
    from spectral_tpu_torch.models.poisson import PoissonModel
    from spectral_tpu_torch.ops import _build, cuda_cheb
    from spectral_tpu_torch.ops.chebyshev import diffmat_np
    from spectral_tpu_torch.solvers.krylov import KSPConfig
    from spectral_tpu_torch.solvers.refinement import refine_solve, refine_solve_fused

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)

    def randn(shape, dtype, seed):
        gen.manual_seed(seed)
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    # -- phase 0: identify, build -------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    t0 = time.perf_counter()
    lib_path, compile_s = _build.build()
    _build.load_library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in lib_path.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln] if lib_path.with_suffix(".log").exists() else []
    print("phase0 " + json.dumps({
        "device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": build_s, "nvcc_s": compile_s, "ptxas": ptxas}))

    # -- phase 1: K1 against its plain version --------------------------------
    k1 = []
    k1_cases = [((3, 10, 16), None), ((7, 12), None), ((5, 12), 0.25),
                ((11, 10), None), ((4, 9, 128), None), ((64, 64, 64), None)]
    for dtype in (torch.float32, torch.float64):
        for seed, (shape, scale) in enumerate(k1_cases):
            u = randn(shape, dtype, seed)
            k1.append(compare("K1", lambda: cuda_cheb.chebdiff_last(u, scale),
                              lambda: cuda_cheb.chebdiff_last_ref(u, scale), u,
                              f"{shape} scale={scale}"))
    u = randn((256, 64, 64, 64), torch.float32, 99)   # the cheb_matvec shape
    k1.append(compare("K1", lambda: cuda_cheb.chebdiff_last(u),
                      lambda: cuda_cheb.chebdiff_last_ref(u), u, "(256, 64, 64, 64)"))
    del u
    print("phase1 K1 " + json.dumps(k1))

    # -- phase 2: K2 against its plain version --------------------------------
    k2 = []
    for dtype in (torch.float32, torch.float64):
        u = randn((12, 10, 8), dtype, 1)
        k2.append(compare("K2", lambda: cuda_cheb.laplacian3d(u),
                          lambda: cuda_cheb.laplacian3d_ref(u), u, "(12, 10, 8)"))
        for dims, scales in (((8, 8, 8), None), ((64, 64, 64), (0.25, 1.0, 4.0)),
                             ((64, 64, 64), None)):
            u = randn(dims, dtype, 2)
            mask = Grid(dims, device=dev).boundary_mask
            k2.append(compare("K2", lambda: cuda_cheb.laplacian3d(u, mask, scales),
                              lambda: cuda_cheb.laplacian3d_ref(u, mask, scales), u,
                              f"{dims} bmask scales={scales}"))
    print("phase2 K2 " + json.dumps(k2))

    # -- the main path: counts start from zero here ---------------------------
    cuda_cheb.reset_launch_counts()

    # -- phase 3: main path A, the CLI in float64 -----------------------------
    argv = ["poisson", "-m", "64", "-n", "64", "-p", "64", "-ksp_rtol", "1e-10"]

    def run_cli():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(argv)
        return rc, buf.getvalue()

    (rc, out), first_s, warm_s = timed_twice(run_cli)
    m = re.search(r"Norm of error (\S+) iterations (\d+)", out)
    require(rc == 0 and m is not None, f"CLI failed (rc {rc}): {out!r}")
    err, iters = float(m.group(1)), int(m.group(2))
    require(err <= 1e-10, f"CLI error {err:.3e} > 1e-10")
    k1_after_a = cuda_cheb.LAUNCHES["chebdiff_last_kernel"]
    require(k1_after_a > 0, "the CLI path did not launch K1")
    print("phase3 " + json.dumps({"cli": " ".join(argv), "iterations": iters, "error": err,
                                  "first_s": first_s, "solve_s": warm_s,
                                  "k1_launches": k1_after_a}))

    # -- phase 4: main path B, mixed precision at 64^3 -------------------------
    n = 64
    g = Grid((n, n, n), device=dev, dtype=torch.float64)
    model = PoissonModel(g, method="kernel")
    M = model.build_pc("fastdiag", dtype=torch.float32)
    ksp = KSPConfig(type="gmres", rtol=1e-6, max_it=60, restart=30)

    def inner(r32):
        res = ksp.solve(model.operator, r32, M=M)
        return res.x, res.iters

    u64 = np.prod(np.cos(0.5 * np.pi * g.coords_np), axis=-1)
    b = np.where(g.boundary_mask_np, u64, 3.0 * (0.5 * np.pi) ** 2 * u64)
    bnorm = float(np.linalg.norm(b))
    bm = g.boundary_mask_np
    D2T = (diffmat_np(n) @ diffmat_np(n)).T.copy()

    def A_hi(x):  # float64 on the host, as the JAX package's bench does
        y = np.zeros_like(x)
        for ax in range(3):
            z = np.moveaxis(x, ax, -1)
            y -= np.moveaxis((z.reshape(-1, n) @ D2T).reshape(z.shape), -1, ax)
        return np.where(bm, x, y)

    k2_before = cuda_cheb.LAUNCHES["laplacian3d_kernel"]
    b_dev = torch.from_numpy(b).to(dev)
    runs = {
        "refine_solve": lambda: refine_solve(A_hi, inner, b, device=dev, rtol=1e-10,
                                             max_refine=8),
        "refine_solve_fused": lambda: refine_solve_fused(model.operator, inner, b_dev,
                                                         rtol=1e-10, max_refine=8),
    }
    phase4 = {}
    for name, run in runs.items():
        out, first_s, warm_s = timed_twice(run)
        x = out.x.cpu().numpy() if isinstance(out.x, torch.Tensor) else out.x
        err = float(np.max(np.abs(x - u64)))
        rel = out.rnorm / bnorm
        require(out.reason > 0 and rel <= 1e-10, f"{name}: rel residual {rel:.3e}")
        require(15 <= out.inner_iters <= 30, f"{name}: {out.inner_iters} inner iterations")
        # the JAX package's own bench_poisson64 reaches 1.067e-13 here (CPU,
        # float64): the 64^3 spectral solution's distance from the exact one
        require(err <= 2e-13, f"{name}: error {err:.3e} > 2e-13")
        phase4[name] = {"refine_steps": out.refine_steps, "inner_iters": out.inner_iters,
                        "rel_residual": rel, "error": err, "first_s": first_s,
                        "solve_s": warm_s}
    k2_launches = cuda_cheb.LAUNCHES["laplacian3d_kernel"] - k2_before
    require(k2_launches > 0, "the mixed-precision path did not launch K2")
    phase4["k2_launches"] = k2_launches
    print("phase4 " + json.dumps(phase4))

    counts = dict(cuda_cheb.LAUNCHES)
    k1_main = next(c for c in k1 if c["case"] == "(64, 64, 64) scale=None"
                   and c["dtype"] == "float64")
    k2_main = next(c for c in k2 if c["case"] == "(64, 64, 64) bmask scales=None"
                   and c["dtype"] == "float32")
    kernels = []
    for name, c in (("chebdiff_last_kernel", k1_main), ("laplacian3d_kernel", k2_main)):
        require(counts[name] > 0, f"{name} was not launched by the main path")
        kernels.append({"name": name, "route": "cuda", "source": SOURCE,
                        "replaces": REPLACES[name], "launches": counts[name],
                        "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                        "plain_ms": c["plain_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
