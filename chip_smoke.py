#!/usr/bin/env python3
"""Smoke test of the PyTorch port (spectral_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, holds each
against its plain PyTorch version on the card, then drives the port's
paths at their real sizes through the entry points a user calls:

  0. identify the card; build the kernels (timed), no spill in any instance;
  1. K1 chebdiff_last_kernel against chebdiff_last_ref, bit equality
     recorded; at the paths' shapes also torch.matmul, K1's launch (tile
     rows, blocks) and computed occupancy, and each kernel's own duration;
  2. K2 (laplacian3d_plane_kernel and laplacian3d_x_kernel, one C call)
     against laplacian3d_ref, boundary rows equal to u, on fields the plane
     pass takes tiled and unpadded; at 64^3 each pass against its own plain
     version, its launch, occupancy and duration;
  3. Poisson path A: the CLI, ``poisson -m 64 -n 64 -p 64 -ksp_rtol 1e-10``
     in float64 (K1 on the last axis of the composed operator);
  4. Poisson path B: mixed-precision refinement at 64^3, float32 GMRES on
     the fused Laplacian (K2) with a float32 fastdiag PC, float64
     residuals, through ``refine_solve`` and ``refine_solve_fused``;
  5. the K3 sweep (the counterpart of benchmarks/exp_pallas.py::main): K3
     against its plain version on ragged shapes, both of its branches
     (bulk copies; the synchronous copy for shapes a bulk copy cannot
     take), then every row-tile height x packing at u of (1,048,576, 64)
     float32 in both branches (the path: one call each), then timed, with
     the ring depths;
  6. the elliptic CLI in float64: ``-dim 12,12,12,12,12 -exact 2
     -pc_type fastdiag`` and ``-dim 32,32,32 -gamma 1 -pc_type mg3``,
     gated on the JAX package's CPU oracle;
  7. mixed-precision Newton: ``EllipticModel.solve_refined`` and
     ``solve_refined_fused`` in the elliptic32 configuration, and
     ``solve_refined`` on the 5-D problem;
  8. the Stokes flagship, gated on STOKES_ORACLE: the ``stokes`` CLI in
     float64 on README:43 (linear) and README:52 (power law, -cont 4) at
     20^3, ``__graft_entry__.entry()``'s forward step at 32^3 (residual and
     one Jacobian action, float64 and float32), and
     ``StokesProblem.solve_refined`` in bench.py's stokes20 configurations
     (K1 on the pressure's last axis in every path);
  9. the rest of the Stokes flagship, gated on STOKES_ORACLE: (a) the
     ``stokes`` CLI in float64 with Neumann boundaries, the physical
     traction rows with the traction-block correction at 20^3 and the
     reference's pressure-free rows at 12^3; (b) the mixed and Neumann
     configurations of the JAX package's tests at 16^2 (line-relaxed
     traction rows on fastdiag and on a V-cycle, tbc); (c) README:52 with
     the line-smoothed eta-aware multigrid at 20^3; (d) the fused tier,
     ``solve_refined_fused`` in bench.py's stokes20 configurations (the
     power law with ``fused_continuation``);
 10. the CLI in float64, gated on PHASE10_ORACLE: (a) README:43 at 20^3
     with the Q1 FEM, separable-Q1 and probed velocity PCs (``-pcvel 1``,
     ``q1sep``, ``2``); (b) README:52 with ``-pcvel 1``; (c) the elliptic
     32^3 solve with ``-pc_type q1fem``; (d) grid sequencing, the 32^3
     mg3 elliptic solve over two coarser levels and README:52 with its
     continuation on (10, 10, 10); (e) ``-ksp_compute_singularvalues`` on
     the 5-D elliptic solve and README:43;
 11. the CLI in float64, gated on UNSTEADY_ORACLE: (a) ``heat`` at 64^3,
     Crank-Nicolson, BDF2 and ``-ts_adapt`` (CG on the spectral Laplacian,
     K1); (b) ``ustokes`` at 20^3, linear CN and BDF2 and the power law
     (a Newton loop a step); (c) the dense tier, ``-saddle_pc
     dense-device`` at 16^3 and ``dense`` (a host float64 inverse) at
     12^3, K1 under ``torch.func.vmap`` in the assembly (phase 1 holds K1
     to its plain version at that batched shape, bit for bit);
 12. thermal convection in float64, gated on CONVECTION_ORACLE: (a)
     Blankenbach case 1a through the ``convection`` CLI, marched to steady
     state on the dense saddle PC, 10 steps on the nested tree, 20 with the
     3/2-rule advection, and ``-ts_adapt``; (b) its direct Newton steady
     state (``-newton``); (c) ``-stability 2``, the critical Rayleigh number
     and growth rates by the Krylov-Schur eigensolver; (d) the Busse et al.
     square cell at (14, 14, 12) through ``steady_newton`` on the saddle
     inverse factored on the card (K1 under vmap in its assembly), held to
     BUSSE_LADDER.json; (e) variable viscosity on the lagged dense PC and
     the eta-aware nested tree;
 13. the differentiable tier in float64: (a) K1 in reverse mode (the
     autograd pair, K1^T = the kernel with s D as its right factor) against
     a plain pair of torch.matmul products at every path shape, in float32
     at 20^3 and under vmap at the batched shapes, K1^T timed, K2 refusing
     a graph; (b) ``StokesProblem.adjoint_gradient`` at README:52's 20^3
     state under the nested ``make_pc(adjoint=True)``, against central
     differences and the JAX adjoint count; (c) ``rollout_diff`` at
     Blankenbach 1a (100 steps; gradients in Ra and T0 against central
     differences, checkpointed equal to plain, the checkpointed backward's
     memory growth) and at 12e's variable viscosity (the contrast); (d) the
     transient adjoint at 11b's power law, full and checkpointed, against
     central differences; (e) the ported ``adjoint_fit_demo -opt lbfgs -n
     32`` and ``implicit_hvp`` against differences of ``implicit_gradient``;
 14. the solver families in float64, gated on SOLVERS_ORACLE: (a) the
     elliptic CLI at 32^3 mg3 with each ``-snes_type`` (newtontr, qn,
     anderson, ngmres, ngmres with a loose Newton step, fas); (b) the
     Poisson CLI at 64^3 with ``-ksp_type bcgs``, ``richardson`` and
     ``chebyshev`` (its own bounds and ``-ksp_chebyshev_eigenvalues``),
     and MINRES on a saddle system of a 64^3 field's size (K1 and K1^T);
     (c) Newton with ``NewtonConfig(recycle=8)`` at 32^3 and README:52's
     continuation with recycling; (d) Blankenbach 1a by Anderson
     acceleration (``convection -accel``);
 15. curved domains in float64, gated on CURVED_ORACLE: (a) the 64^3
     Poisson model on tensor-product axis maps (``Grid(maps=...)``,
     fastdiag and multigrid on the restricted maps; K1, never K2); (b) the
     ``poisson`` CLI with ``-map``; (c) the ``elliptic`` CLI with ``-map``
     (README:69, 32^3 mg3), ``solve_refined`` with float32 inner solves and
     FAS on the metric form; (d) the ``stokes`` CLI with ``-map``
     (README:68, the 3-D bump, the 3-D power law), bench.py's curved trio,
     the 20^2 parity pair, the nodal and q1fem velocity PCs; (e) the
     curved-Neumann cell in float64 and through ``solve_refined_fused``
     (float32 inner solves, error <= 1e-5); (f) the ``heat`` CLI with
     ``-map``; (g) unsteady Stokes on a curved domain.  Phase 1 holds K1
     bit for bit at every shape these paths give it (K1_CURVED_SHAPES).
 16. batched and parallel solves in float64, gated on FAMILY_ORACLE (the
     JAX package's counts, ``stokes_oracle.py family``) and on the card's
     own sequential solves: (a) bench.py's stokes_family8 (8 power-law
     exponents at 16^2) through ``solve_family``, its warm time against
     bench.py's baseline (8 x one warm solve of member 7) and the sum of
     the 8 warm solves, 2 repeats; (b) the curved family (annulus 10^2,
     the metric multigrid); (c) ``family_rollout`` of 4 manufactured
     members at 11b's 20^3 CN configuration; (d) ``solve_batched`` and
     ``block_gmres`` on phase 3's 64^3 Poisson operator with 8 seeded
     right-hand sides; (e) two gloo processes sharing the card
     (``parallel/``): the pencil and the halo at 64^3, the sharded 64^3
     Poisson solve (phase 3's 3 iterations; K2 at 0 launches, K1 on the
     slabs), the elliptic and Stokes residual and Jacobian action.  Phase 1
     holds K1 bit for bit at the batched shapes, directly and under
     ``torch.func.vmap`` (K1_FAMILY_SHAPES), and at the slab shapes
     (K1_SLAB_SHAPES).
 17. sharded solves in float64, gloo processes sharing the card, each
     held to the card's one-process run of the same configuration (see
     ``P17_RUNS``): (a) README:43 at 20^3 on {"x": 2}; (b) the same on
     {"x": 2, "y": 2}, four processes; (c) the curved 14^3 Stokes of 15d;
     (d) the elliptic 32^3 mg3 Newton solve; (e) two CN steps of 11b's
     ustokes and three Blankenbach 1a convection steps; (f) 16d's batch of
     8 cut over the mesh.  Every process's K1 launches count (K2 must stay
     at 0); phase 1 holds K1 at the slab shapes (K1_SLAB_SHAPES).
 18. the utilities in float64: (a) README:52 through the ``stokes`` CLI
     with ``-checkpoint_dir``, ``-output_vtk`` and ``-log_summary``, then
     resumed after its last two steps' files are deleted, its stokes.vtk
     held to the one the port writes on the CPU from the card's final
     state; (b) 12a's ``-ts_adapt`` march with checkpoints, resumed from
     step 200; (c) ``graft_entry.entry()`` at 32^3 on the K1 and the
     matmul production paths, held to each other; (d) ``trace_summary``
     of a warm continuation step; (e) the six ported examples.  Phase 1
     holds K1 at the examples' shapes (K1_EXAMPLE_SHAPES, K1_FAMILY_SHAPES).

``python3 chip_smoke.py --phases 3,8-15,13b-d`` runs phase 0 and the
phases listed in this process (a check run: no kernels line, no result
line).  With no argument every phase runs, as the smoke test is meant to
run: phases 0-2, 5 and 13a first, alone on the card (they time the
kernels), then the paths in eight worker processes at once
(``WORKER_GROUPS``), which report their launch counts back (the
processes of phases 16e and 17 report theirs to their worker).  The workers'
path times are taken while the others run; ``--serial`` runs every phase
in this process, for path times taken alone.

Each path (phases 3-18) is driven with the launch counts set to 0 just
before it and read just after (K1's forward and transposed launches also
by shape), and times nothing inside it (a call captured in a CUDA graph counts once and launches at
every replay); every phase raises on failure.  A timed comparison gives
each side two times: ``device_ms`` (a CUDA graph of 20 calls, replayed
between events) as ``ms`` and ``call_ms`` (the host clock over 100 calls
and one synchronize).  Before the last line it prints the kernels as JSON
(launches summed over the paths, errors and device times from the
comparisons; K2 as its two passes; K1^T as its own row); the last line is {"ok": true,
"device": {...}}.  Without CUDA it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import re
import statistics
import subprocess
import sys
import time

SOURCE = "spectral_tpu_torch/csrc/cheb_kernels.cu"
REPLACES = {"chebdiff_last_kernel": "spectral_tpu/ops/pallas_cheb.py:34",
            "laplacian3d_plane_kernel": "spectral_tpu/ops/pallas_cheb.py:81",
            "laplacian3d_x_kernel": "spectral_tpu/ops/pallas_cheb.py:81",
            "chebdiff_packed_kernel": "benchmarks/exp_pallas.py:32"}
BOUND = {"float32": 1e-5, "float64": 1e-12}   # max |kernel - plain| / max |plain|
# The shapes the paths give K1: 64^3 (the Poisson CLI), 32^3 and 12^5 (the
# elliptic paths, float64 in phase 6, float32 and float64 in phase 7; the
# Stokes forward step, phase 8), 20^3 (the Stokes CLI in float64, and
# solve_refined's float32 inner solves, phase 8; phase 9's 20^3 paths),
# (16, 16) and (12, 12, 12) (phase 9's 2-D mixed solves and the 12^3
# Neumann CLI, float64), the coarse levels of phase 10's grid sequencing,
# K1_GSEQ_SHAPES, and phase 12's convection shapes, K1_CONV_SHAPES (float64;
# K1 is bit for bit its plain version at both sets, a gate)
K1_GSEQ_SHAPES = ((8, 8, 8), (10, 10, 10), (16, 16, 16))
K1_CONV_SHAPES = ((12, 12), (14, 14, 12))
# the dense assemblies' batches of one-hot states: 1024 at 16^3 (phase 11c)
# and at (14, 14, 12) (phase 12d), 512 at 16^2 (phase 12e's lagged refresh);
# K1 bit for bit its plain version on each, directly and under vmap
K1_BATCHED_SHAPES = ((1024, 16, 16, 16), (1024, 14, 14, 12), (512, 16, 16))
# phase 14's new shapes: FAS's coarsest level at 32^3 and the MINRES
# system's velocity block (K1 and K1^T)
K1_SOLVER_SHAPES = ((5, 5, 5), (64, 64, 48))
K1_PATH_SHAPES = ((64, 64, 64), (32, 32, 32), (12,) * 5, (20, 20, 20), (16, 16),
                  (12, 12, 12)) + K1_GSEQ_SHAPES + K1_CONV_SHAPES + K1_SOLVER_SHAPES
# phase 15's shapes (the curved paths), float32 and float64: K1 bit for
# bit its plain version at each in float64, a gate, and timed there
# (float32 within BOUND); phase 15 requires every (shape, dtype) it
# launches K1 on to be here or in K1_PATH_SHAPES
K1_CURVED_SHAPES = ((8, 8), (13, 13), (14, 14), (17, 17), (18, 18), (20, 20), (25, 25),
                    (32, 32), (14, 14, 14), (24, 24, 24))
# phase 16's shapes: the families' batches (K1's vmap rule, one launch a
# batch: family8 (8, 16, 16), the curved family (3, 10, 10), the rollout
# family (4, 20, 20, 20), the batched 64^3 Poisson (8, 64, 64, 64)), held
# bit for bit directly and under vmap; the slabs of 16e's two processes
# and the curved family's sequential solve, held as the curved shapes are
K1_FAMILY_SHAPES = ((8, 16, 16), (3, 10, 10), (4, 20, 20, 20), (8, 64, 64, 64),
                    (4, 64, 64, 64), (3, 12, 12))
# phase 17's slabs: README:43 on {"x": 2} and on 2 x 2, the curved 14^3,
# the elliptic 32^3, Blankenbach's 16^2 (and 17f's batch of 4 a process)
K1_SLAB_SHAPES = ((32, 64, 64), (8, 12), (10, 10), (10, 20, 20), (10, 10, 20), (7, 14, 14),
                  (16, 32, 32), (8, 16))
# phase 18's examples' shape beyond these (solver_tuning_demo's 24^2; its
# family_sweep_demo batch (3, 12, 12) is in K1_FAMILY_SHAPES), held as the
# curved shapes are
K1_EXAMPLE_SHAPES = ((24, 24),)
K3_SCALE = 1.0 / 64**2   # exp_pallas.py:33 folds 1/n^2 into D^T
# K3's ragged cases, each in float32 and float64: (rows, n, pack, row tile,
# offset of u2d in its storage).  n % 4 == 0 goes by bulk copies (n = 12:
# lanes past D^T's 12 columns); the last row tile of (257, 64) is one
# pencil; n = 10, n = 9 (k padded in shared memory) and views one element
# into their storage take the synchronous copy.
K3_CASES = ((1, 64, 1, 32, 0), (37, 64, 2, 64, 0), (100, 64, 1, 128, 0), (1003, 64, 2, 32, 0),
            (515, 64, 1, 64, 0), (333, 64, 2, 128, 0), (257, 64, 1, 128, 0), (70, 12, 3, 32, 0),
            (70, 10, 3, 32, 0), (45, 9, 2, 64, 0), (515, 64, 1, 64, 1), (333, 64, 2, 128, 1))
DTYPE_C = {"torch.float32": "float", "torch.float64": "double"}   # ptxas instance names
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s; the card's FLOP/s for the
# type, float32 outside the tensor cores (TF32 is another type), float64 on
# its float64 tensor cores (the FMA pipes the kernels use give 34e12)
HBM_BYTES_S = 3.35e12
PEAK_FLOP_S = {"float32": 67e12, "float64": 67e12}
# K2 fields whose padded plane does not fit in shared memory: the plane
# pass stages them unpadded
K2_UNPADDED = {"float32": (3, 22, 230), "float64": (4, 118, 118)}
# The JAX package's elliptic CLI on the CPU in float64 (spectral_tpu.cli
# elliptic -platform cpu, the same options): Newton count, Krylov counts
# per Newton step, max error.
ELLIPTIC_ORACLE = {
    "5d": (["-dim", "12,12,12,12,12", "-exact", "2", "-pc_type", "fastdiag",
            "-ksp_rtol", "1e-10", "-debug", "1"], 1, [11], 2.017631e-11),
    "32^3 mg3": (["-dim", "32,32,32", "-exact", "0", "-gamma", "1", "-pc_type", "mg3",
                  "-snes_rtol", "1e-10", "-debug", "1"], 5, [6, 7, 7, 6, 7], 2.512879e-12),
}
# The mixed-precision elliptic runs (bench.py's bench_elliptic32 and
# bench_elliptic5d), rtol 1e-10; profile_port.py profiles the same runs.
# Bands around the JAX package's CPU oracle (6 Newton and 27 Krylov at
# 32^3, 17 Krylov in 5-D): float32 Newton at rtol 3e-5 runs at the float32
# floor, where iterates that differ in round-off take later steps that
# differ by more (at 32^3 on the CPU the JAX package takes 6 Newton steps
# and the port 5, refine_history.py), so Newton within 2 of the oracle and
# total Krylov within a factor 2.  Error gates: 5-D, the 5e-13 of the
# oracle's 2.27e-13; 32^3, 0.3 x the run's own rel residual, because
# refinement stops at the first iterate with rel residual <= 1e-10 and the
# error follows that residual: refine_history.py gives error / rel
# residual 0.02-0.23 over every iterate above the round-off floor, in both
# packages.  The oracle's 5.6e-16 comes from a first step that stopped at
# rel 1.88e-10, just over the tolerance, and so took a second one; the
# port's first step reaches 4.1e-11 and stops at error 5.5e-12.
EW_NEWTON = dict(rtol=3e-5, max_it=30, ksp_ew=True, ew_etamax=0.5, pc_lag=2)
ELLIPTIC_REFINED = {
    "32^3 solve_refined": dict(dims=(32, 32, 32), gamma=1.0, exact=0, entry="solve_refined",
                               pc_type="mg3", ew=True, newton=(4, 8), krylov=(14, 54),
                               max_error=lambda rel: 0.3 * rel),
    "32^3 solve_refined_fused": dict(dims=(32, 32, 32), gamma=1.0, exact=0,
                                     entry="solve_refined_fused", pc_type="mg3", ew=True,
                                     newton=(4, 8), krylov=(14, 54),
                                     max_error=lambda rel: 0.3 * rel),
    "5d solve_refined": dict(dims=(12,) * 5, gamma=0.0, exact=2, entry="solve_refined",
                             pc_type="fastdiag", ew=False, newton=(1, 4), krylov=(9, 34),
                             max_error=lambda rel: 5e-13),
}


def refined_runs(dev) -> dict:
    """name -> (run, exact solution) for each of ELLIPTIC_REFINED on
    ``dev``; the runs on one grid share one model, and so its
    preconditioner caches."""
    import functools

    from spectral_tpu_torch.grid import Grid
    from spectral_tpu_torch.models.elliptic import EllipticModel
    from spectral_tpu_torch.solvers.newton import NewtonConfig

    models, runs = {}, {}
    for name, spec in ELLIPTIC_REFINED.items():
        key = (spec["dims"], spec["gamma"])
        if key not in models:
            models[key] = EllipticModel(Grid(spec["dims"], device=dev), gamma=spec["gamma"])
        u, b, d = models[key].setup_problem_np(exact=spec["exact"])
        kw = dict(rtol=1e-10, pc_type=spec["pc_type"])
        if spec["ew"]:
            kw["newton"] = NewtonConfig(**EW_NEWTON)
        runs[name] = (functools.partial(getattr(models[key], spec["entry"]), b, d, **kw), u)
    return runs


# The Stokes flagship (phase 8).  STOKES_ORACLE: the JAX package on the CPU
# in float64 (``python3 stokes_oracle.py``, its stokes driver with the same
# options; the forward step by __graft_entry__.entry(); solve_refined with
# x64 off, as bench.py runs it).  "newton" and "krylov" are per continuation
# step.  Krylov gates: README:43, 14 +- 3.  README:52's counts move with the
# summation order: the JAX package itself, started from the zero state plus
# masked noise of 1e-13 (seeds 0-7) or 1e-11 (seed 0), takes the counts in
# "perturbed" (stokes_oracle.py perturb), 689-871 in all against the
# oracle's 656, with the same Newton counts and error; the fifth
# continuation step's second Newton step alone takes 72-151.  So each
# Krylov count, and the total, is held within max(3, 10%) of the range
# that the oracle and those nine runs span (stokes_krylov_range).
STOKES_README43 = ["-exact", "2", "-cont0", "1", "-schur_ksp_max_it", "3", "-vel_ksp_max_it",
                   "4", "-svel_ksp_type", "preonly", "-ksp_type", "fgmres", "-dim", "20,20,20",
                   "-ksp_rtol", "1e-10"]
STOKES_README52 = ["-exact", "2", "-cont", "4", "-rheology", "1", "-eps", "1e-4", "-exponent",
                   "3", "-schur_ksp_max_it", "3", "-vel_ksp_max_it", "4", "-svel_ksp_type",
                   "preonly", "-ksp_type", "fgmres", "-dim", "20,20,20"]
CLI43_SOLVER = ["-cont0", "1", "-schur_ksp_max_it", "3", "-vel_ksp_max_it", "4",
                "-svel_ksp_type", "preonly", "-ksp_type", "fgmres", "-ksp_rtol", "1e-10"]
STOKES_NEUMANN3D = {
    "tbc 20^3": ["-exact", "1", "-boundary", "1", "-traction_p", "1", "-tbc", "1",
                 "-dim", "20,20,20", *CLI43_SOLVER],
    "free 12^3": ["-exact", "2", "-boundary", "1", "-dim", "12,12,12", *CLI43_SOLVER],
}
STOKES_ORACLE = {
    "README:43": dict(argv=STOKES_README43, newton=[1], krylov=[[14]], error=2.792477e-07),
    "README:52": dict(argv=STOKES_README52, newton=[2, 3, 3, 4, 5],
                      krylov=[[4, 11], [17, 12, 16], [21, 18, 24], [37, 21, 18, 27],
                              [171, 74, 36, 41, 108]], error=6.057082e-01,
                      perturbed=[  # 1e-13, seeds 0-7, then 1e-11, seed 0
                          [[4, 11], [16, 12, 15], [22, 16, 18], [35, 34, 36, 22],
                           [149, 144, 39, 39, 120]],
                          [[4, 11], [16, 13, 14], [25, 16, 17], [65, 21, 36, 29],
                           [120, 105, 58, 37, 102]],
                          [[4, 11], [16, 12, 16], [21, 21, 19], [37, 21, 23, 24],
                           [166, 117, 52, 57, 141]],
                          [[4, 11], [16, 12, 14], [21, 21, 20], [60, 20, 20, 22],
                           [158, 121, 57, 54, 116]],
                          [[4, 11], [16, 12, 14], [23, 17, 18], [39, 22, 18, 32],
                           [205, 149, 58, 54, 152]],
                          [[4, 11], [16, 12, 15], [21, 20, 19], [60, 46, 25, 51],
                           [119, 151, 26, 68, 207]],
                          [[4, 11], [15, 12, 14], [22, 17, 16], [52, 23, 19, 21],
                           [160, 79, 51, 81, 131]],
                          [[4, 11], [17, 12, 15], [22, 19, 22], [45, 19, 21, 30],
                           [131, 151, 35, 64, 110]],
                          [[4, 11], [16, 13, 17], [23, 21, 20], [42, 22, 22, 30],
                           [207, 72, 70, 29, 110]]]),
    # ||F|| and ||J F|| over both fields at zero_state(), entry()'s 32^3 step
    "entry": {"F": 48593.71024072187, "JF": 66963687.40182088},
    # solve_refined: the JAX package stops at rel 3.19e-13 with error 2.94e-14
    # (linear) and at rel 4.31e-12 with error 0.6057081634662875 (power law);
    # the port on the CPU at 3.22e-13 / 1.37e-13 and 4.35e-12 / 0.6057081634662824
    "refined linear": dict(rel=3.194402332219898e-13, error=2.9405057785374996e-14),
    "refined powerlaw": dict(rel=4.313229162342449e-12, error=0.6057081634662875),
    # phase 9 (stokes_oracle.py neumann3d, mixed2d, line52, fused).  9a: the
    # stokes CLI, Krylov counts from its continuation results; at 16^3 and
    # 20^3 the JAX package stagnates on the pressure-free rows, so they run
    # at 12^3.  9b: tests/test_stokes.py's solver settings at 16^2, with
    # the JAX test's own bounds (max_krylov, max_error).  Boundary 2's
    # Krylov counts are chaotic: the JAX package started from the zero
    # state plus masked noise of 1e-13 (seeds 0-7) or 1e-11 (seed 0)
    # takes the counts in "perturbed" (stokes_oracle.py perturb2d), 186-288
    # with fastdiag (over its test's bound of 260 in four of nine runs)
    # and 199-370 with the multigrid, at the same Newton count and an
    # error within 1e-3 relative; they are held to that range as README:52
    # is (stokes_krylov_range), and the error to 1e-3 relative.  9c:
    # test_stokes_20cubed_powerlaw_fixture's configuration.  9d: the JAX
    # package's float32 stages (x64 off), printed beside the port's.
    "neumann tbc 20^3": dict(argv=STOKES_NEUMANN3D["tbc 20^3"], newton=[1], krylov=[[35]],
                             reasons=["CONVERGED_RTOL"], error=3.573403e-07),
    "neumann free 12^3": dict(argv=STOKES_NEUMANN3D["free 12^3"], newton=[1], krylov=[[280]],
                              reasons=["CONVERGED_RTOL"], error=4.779435e-07),
    "mixed boundary 2": dict(newton=[1], krylov=[[193]], reasons=["CONVERGED_RTOL"],
                             error=37.59593473349248,
                             perturbed=[[[k]] for k in (195, 234, 195, 270, 186, 288, 272,
                                                        274, 199)]),
    "mixed boundary 5": dict(newton=[1], krylov=[[107]], reasons=["CONVERGED_RTOL"],
                             error=2.649785391106718e-09, max_error=1e-7),
    "mixed boundary 6 tbc": dict(newton=[1], krylov=[[34]], reasons=["CONVERGED_RTOL"],
                                 error=2.2434321067521523e-09, max_krylov=45, max_error=1e-4),
    "mixed boundary 2 mg": dict(newton=[1], krylov=[[284]], reasons=["CONVERGED_RTOL"],
                                error=37.59119298474984,
                                perturbed=[[[k]] for k in (276, 296, 199, 370, 336, 284, 281,
                                                           353, 299)]),
    "line52": dict(newton=[1, 3, 3, 4, 5],
                   krylov=[[9], [17, 15, 17], [21, 24, 24], [27, 26, 23, 25], [28, 26, 22, 24, 28]],
                   total=356, error=0.6057081634662841, max_krylov=35),
    "fused linear": dict(refine_steps=3, refine_inner=27, rel=3.94099115084575e-13,
                         error=5.22528405016006e-12),
    "fused powerlaw": dict(newton=[3, 8, 8, 18, 13], refine_steps=3, refine_inner=60,
                           rel=1.5326435677810032e-12, error=0.6057081634662976),
}


# Phase 10: the Q1 and probed velocity PCs, the elliptic q1fem PC, grid
# sequencing and the singular-value estimate, through the CLI in float64.
# PHASE10_ORACLE: the JAX package on the CPU in float64 (``python3
# stokes_oracle.py q1`` for the stokes lines; the elliptic lines from
# ``python -m spectral_tpu.cli elliptic -platform cpu`` with the same
# options: 32^3 q1fem 5 Newton, [5, 27, 23, 21, 24], 1.461442e-12; 32^3
# mg3 with -snes_grid_sequence 2: (8, 8, 8) 5 Newton / 30 Krylov
# CONVERGED_RTOL, (16, 16, 16) 3 / 22 CONVERGED_SNORM_RELATIVE, then 1
# Newton, [5], CONVERGED_SNORM_RELATIVE, 1.015854e-14; 12^5 fastdiag with
# -ksp_compute_singularvalues 1 Newton, [11], 2.017631e-11, max
# 4.350312e+00 min 2.039389e+00 cond 2.133145e+00).  "krylov" per Newton
# step, "levels" (name, Newton, total Krylov, reason) per coarse level.
# Two phase 10 numbers are chaotic in the JAX package itself, so they are
# held to the range of the oracle and of its runs from the zero state plus
# masked noise of 1e-13 (seeds 0-31) and 1e-11 (seed 0), listed here in
# that order (``stokes_oracle.py perturb_probed`` / ``perturb_sv``, with
# ``--seeds 8-31`` for the later seeds): README:43 with -pcvel 2, whose
# velocity PC is damped Jacobi on a probe of the spectral block (the
# oracle's 177, the perturbed runs 131-284 FGMRES, error 4.7e-8 to
# 1.9e-7), and README:43's singular-value estimate, an Arnoldi process on
# a preconditioner made of inner Krylov solves, which are not linear in
# their right-hand side (max 1.0255-1.0436, min 0.1613-0.1946, cond
# 5.327-6.410).  (FGMRES iterations, error) for -pcvel 2:
PROBED_PERTURBED = (
    (229, 1.283599e-07), (284, 9.830109e-08), (138, 8.403683e-08), (205, 1.460282e-07),
    (131, 1.08005e-07), (186, 1.765694e-07), (172, 9.140188e-08), (171, 8.753442e-08),
    (183, 1.090935e-07), (164, 7.359899e-08), (263, 9.880046e-08), (193, 1.918811e-07),
    (161, 7.808826e-08), (245, 1.72741e-07), (210, 6.26025e-08), (229, 1.29524e-07),
    (172, 9.419474e-08), (166, 4.724459e-08), (167, 1.164688e-07), (151, 6.84912e-08),
    (197, 9.341033e-08), (251, 1.359379e-07), (149, 1.190675e-07), (243, 9.878804e-08),
    (218, 9.256733e-08), (168, 7.552276e-08), (176, 1.088767e-07), (176, 1.154514e-07),
    (199, 1.36192e-07), (200, 1.194251e-07), (186, 1.529564e-07), (191, 1.38634e-07),
    (211, 1.023488e-07))
# The port's own -pcvel 2 runs on the card from the same starts
# (``port_perturb.py --seeds 0-31``, one NVIDIA H100 80GB HBM3 at 700.00 W:
# 126-284 FGMRES, error 3.8e-8 to 2.1e-7): the port sums in another order
# than the JAX package, which moves the count as the perturbations do, so
# the gate spans both samples.
PROBED_PORT_PERTURBED = (
    (270, 1.230527e-07), (195, 9.308136e-08), (227, 1.663084e-07), (231, 1.565741e-07),
    (246, 1.334379e-07), (177, 1.784516e-07), (195, 9.772304e-08), (186, 1.497986e-07),
    (168, 9.769574e-08), (126, 6.818642e-08), (179, 9.340613e-08), (164, 1.488553e-07),
    (149, 7.819824e-08), (201, 5.407805e-08), (135, 1.184235e-07), (173, 9.560712e-08),
    (218, 2.113956e-07), (191, 1.090683e-07), (204, 4.861964e-08), (242, 1.373415e-07),
    (243, 9.747777e-08), (205, 3.81223e-08), (246, 1.227107e-07), (187, 8.729575e-08),
    (163, 7.133147e-08), (153, 7.649024e-08), (284, 1.256316e-07), (174, 8.253841e-08),
    (172, 1.11041e-07), (227, 1.866481e-07), (247, 1.544126e-07), (151, 6.412307e-08),
    (155, 5.889017e-08))
SV_PERTURBED = (
    (1.033252, 0.1725587, 5.987829), (1.039419, 0.1889093, 5.50221),
    (1.034763, 0.1919162, 5.391743), (1.030782, 0.1750039, 5.890052),
    (1.030869, 0.1794238, 5.745444), (1.033347, 0.1776454, 5.816912),
    (1.029336, 0.1784973, 5.766674), (1.034182, 0.1616036, 6.3995),
    (1.034584, 0.1685767, 6.13717), (1.043619, 0.1866787, 5.590458),
    (1.040809, 0.1639339, 6.348956), (1.031233, 0.1716592, 6.007442),
    (1.030307, 0.1735329, 5.937246), (1.025539, 0.1648593, 6.220695),
    (1.037212, 0.1695712, 6.116674), (1.026147, 0.178943, 5.73449),
    (1.029324, 0.1628493, 6.320716), (1.034025, 0.1613185, 6.409834),
    (1.038488, 0.1754374, 5.919419), (1.036547, 0.1945737, 5.327272),
    (1.03077, 0.1751807, 5.884039), (1.038849, 0.1793885, 5.791056),
    (1.031279, 0.16486, 6.255482), (1.032203, 0.1767674, 5.83933),
    (1.030607, 0.1715896, 6.006233), (1.028176, 0.1648021, 6.238853),
    (1.031055, 0.1894598, 5.442079), (1.03001, 0.1659584, 6.206437),
    (1.031827, 0.1717262, 6.008556), (1.036696, 0.1810062, 5.727405),
    (1.039012, 0.1803839, 5.760003), (1.037784, 0.1862119, 5.573138),
    (1.029448, 0.1729441, 5.952489))
PHASE10_ORACLE = {
    "10a q1fem README:43": dict(argv=["stokes", *STOKES_README43, "-pcvel", "1"], newton=[1],
                                krylov=[[47]], reasons=["CONVERGED_RTOL"], error=3.679132e-07),
    "10a q1sep README:43": dict(argv=["stokes", *STOKES_README43, "-pcvel", "q1sep"],
                                newton=[1], krylov=[[38]], reasons=["CONVERGED_RTOL"],
                                error=3.78899e-07),
    "10a probed README:43": dict(argv=["stokes", *STOKES_README43, "-pcvel", "2"], newton=[1],
                                 krylov=[[177]], reasons=["CONVERGED_RTOL"], error=1.645493e-07,
                                 perturbed=[[[k]] for k, _ in
                                            PROBED_PERTURBED + PROBED_PORT_PERTURBED],
                                 perturbed_errors=[e for _, e in
                                                   PROBED_PERTURBED + PROBED_PORT_PERTURBED]),
    "10b q1fem README:52": dict(argv=["stokes", *STOKES_README52, "-pcvel", "1"],
                                newton=[2, 3, 3, 4, 5],
                                krylov=[[9, 35], [37, 32, 45], [33, 43, 52], [26, 24, 27, 33],
                                        [34, 25, 29, 32, 60]], total=576, error=6.057082e-01),
    "10c elliptic 32^3 q1fem": dict(argv=["elliptic", "-dim", "32,32,32", "-exact", "0",
                                          "-gamma", "1", "-pc_type", "q1fem", "-snes_rtol",
                                          "1e-10", "-debug", "1"],
                                    newton=[5], krylov=[[5, 27, 23, 21, 24]],
                                    reasons=["CONVERGED_RTOL"], error=1.461442e-12),
    "10d elliptic 32^3 mg3 gseq 2": dict(
        argv=["elliptic", *ELLIPTIC_ORACLE["32^3 mg3"][0], "-snes_grid_sequence", "2"],
        levels=[("(8, 8, 8)", 5, 30, "CONVERGED_RTOL"),
                ("(16, 16, 16)", 3, 22, "CONVERGED_SNORM_RELATIVE")],
        newton=[1], krylov=[[5]], reasons=["CONVERGED_SNORM_RELATIVE"], error=1.015854e-14,
        max_error=1e-13),
    "10d gseq README:52": dict(
        argv=["stokes", *STOKES_README52, "-snes_grid_sequence", "1"],
        coarse_newton=[2, 3, 3, 4, 4],
        coarse_krylov=[[4, 9], [9, 9, 10], [12, 11, 11], [18, 14, 15, 16], [22, 16, 19, 22]],
        coarse_total=217, newton=[22],
        krylov=[[30, 63, 43, 41, 41, 45, 43, 37, 53, 44, 107, 31, 33, 47, 54, 91, 52, 60, 29,
                 52, 56, 58]], reasons=["CONVERGED_RTOL"], error=6.057082e-01),
    "10e elliptic 5d singular values": dict(
        argv=["elliptic", *ELLIPTIC_ORACLE["5d"][0], "-ksp_compute_singularvalues"],
        newton=[1], krylov=[[11]], reasons=["CONVERGED_RTOL"], error=2.017631e-11,
        singular_values=(4.350312e+00, 2.039389e+00, 2.133145e+00)),
    "10e singular values README:43": dict(
        argv=["stokes", *STOKES_README43, "-ksp_compute_singularvalues"], newton=[1],
        krylov=[[14]], reasons=["CONVERGED_RTOL"], error=2.792477e-07,
        singular_values=(1.033295e+00, 1.621493e-01, 6.372493e+00),
        perturbed_sv=SV_PERTURBED),
}


def parse_cli(out: str) -> dict:
    """The counts, reasons, error, grid-sequence levels and singular values
    a stokes or elliptic CLI run printed."""
    got = {}
    mc = re.search(r"Continuation steps: Newton (\[.*\])  Krylov (\[.*\])", out)
    if mc:   # stokes: the last solve's (or the continuation's) counts
        got["newton"], got["krylov"] = json.loads(mc.group(1)), json.loads(mc.group(2))
    else:    # elliptic: one Newton solve
        mn = re.search(r"Number of nonlinear iterations = (\d+)", out)
        mk = re.search(r"KSP iterations per Newton step: (\[.*\])", out)
        if mn and mk:
            got["newton"], got["krylov"] = [int(mn.group(1))], [json.loads(mk.group(1))]
    mr = re.search(r"Reason for solver termination: (\S+)", out)
    me = re.search(r"Norm of error\s*: abs = (\S+)", out)
    got["reasons"] = [mr.group(1)] if mr else None
    got["error"] = float(me.group(1)) if me else None
    got["levels"] = [(m.group(1), int(m.group(2)), int(m.group(3)), m.group(4))
                     for m in re.finditer(r"grid sequence level (\(.*?\)): (\d+) Newton / "
                                          r"(\d+) Krylov, reason (\S+)", out)]
    mcc = re.search(r"Continuation steps on level \(.*?\): Newton (\[.*\])  Krylov (\[.*\])", out)
    if mcc:
        got["coarse_newton"], got["coarse_krylov"] = json.loads(mcc.group(1)), \
            json.loads(mcc.group(2))
    ms = re.search(r"extreme singular values: max (\S+) min (\S+) cond (\S+)", out)
    got["singular_values"] = tuple(map(float, ms.groups())) if ms else None
    return got


def phase10_ok(name: str, got: dict) -> str | None:
    """Why a phase 10 run misses PHASE10_ORACLE[name]'s gates, or None:
    Newton counts equal; 10a, 10c, 10e: the reason equal, each Krylov count
    within max(3, 10%) of the range of the oracle and its perturbed runs
    (10c: within 2 a step), the error within 2x of that range (10c: at
    most 2x); 10b: every continuation step converged, the total within
    20%, the error to 1e-6; 10d: each level's Newton count and reason
    equal and its Krylov total within max(3, 10%) (README:52: the coarse
    continuation's Newton counts equal, its total within 20%), the fine
    solve's Krylov total within max(3, 10%), the error at most max_error
    (README:52: to 1e-6); singular values within 1e-4 relative of the
    range of the oracle and its perturbed runs."""
    spec = PHASE10_ORACLE[name]
    newton, krylov, err = got.get("newton"), got.get("krylov"), got["error"]
    if newton != spec["newton"] or [len(k) for k in krylov] != newton:
        return f"Newton {newton} ({krylov}), oracle {spec['newton']}"
    if "total" in spec:   # 10b
        total = sum(map(sum, krylov))
        if not all(r.startswith("CONVERGED") for r in got["reasons"]):
            return f"reason {got['reasons']}"
        if abs(total - spec["total"]) > 0.2 * spec["total"]:
            return f"total Krylov {total}, oracle {spec['total']} (20%)"
        if abs(err - spec["error"]) > 1e-6 * spec["error"]:
            return f"error {err:.6e}, oracle {spec['error']:.6e} (1e-6 relative)"
        return None
    if got["reasons"] != spec["reasons"]:
        return f"reason {got['reasons']}, oracle {spec['reasons']}"
    if "coarse_newton" in spec:   # 10d README:52
        ctotal, ftotal = sum(map(sum, got["coarse_krylov"])), sum(map(sum, krylov))
        otot = sum(map(sum, spec["krylov"]))
        if got["coarse_newton"] != spec["coarse_newton"]:
            return f"coarse Newton {got['coarse_newton']}, oracle {spec['coarse_newton']}"
        if abs(ctotal - spec["coarse_total"]) > 0.2 * spec["coarse_total"]:
            return f"coarse total Krylov {ctotal}, oracle {spec['coarse_total']} (20%)"
        if not _within(ftotal, otot, otot):
            return f"fine total Krylov {ftotal}, oracle {otot} (max(3, 10%))"
        if abs(err - spec["error"]) > 1e-6 * spec["error"]:
            return f"error {err:.6e}, oracle {spec['error']:.6e} (1e-6 relative)"
        return None
    if "levels" in spec:          # 10d elliptic
        if [lv[:2] + lv[3:] for lv in got["levels"]] != [lv[:2] + lv[3:] for lv in spec["levels"]]:
            return f"levels {got['levels']}, oracle {spec['levels']}"
        for lv, ov in zip(got["levels"], spec["levels"]):
            if not _within(lv[2], ov[2], ov[2]):
                return f"level {lv[0]}: {lv[2]} Krylov, oracle {ov[2]} (max(3, 10%))"
        total, otot = sum(krylov[0]), sum(spec["krylov"][0])
        if not _within(total, otot, otot):
            return f"Krylov {krylov}, oracle {spec['krylov']} (max(3, 10%))"
        return None if err <= spec["max_error"] else \
            f"error {err:.6e} > {spec['max_error']:.0e}"
    if name.startswith("10c"):
        if any(abs(a - b) > 2 for a, b in zip(krylov[0], spec["krylov"][0])):
            return f"Krylov {krylov}, oracle {spec['krylov']} (within 2 a step)"
    else:   # max(3, 10%) beyond the range of the oracle and its perturbed runs
        (lo, hi), _ = stokes_krylov_range({"perturbed": [], **spec})
        if any(not _within(k, a, b) for got_k, ls, hs in zip(krylov, lo, hi)
               for k, a, b in zip(got_k, ls, hs)):
            return f"Krylov {krylov}, the runs span {lo}..{hi} (max(3, 10%) beyond)"
    errs = [spec["error"], *spec.get("perturbed_errors", [])]
    elo = 0.0 if name.startswith("10c") else min(errs) / 2
    if not elo <= err <= 2 * max(errs):
        return f"error {err:.6e}, the runs span {min(errs):.6e}..{max(errs):.6e} (within 2x)"
    if "singular_values" in spec:   # 1e-4 relative beyond the JAX runs' range
        sv = got["singular_values"]
        runs = [spec["singular_values"], *spec.get("perturbed_sv", [])]
        if sv is None or any(not min(r) * (1 - 1e-4) <= v <= max(r) * (1 + 1e-4)
                             for v, r in zip(sv, zip(*runs))):
            return f"singular values {sv}, the JAX runs span {runs} (1e-4 relative beyond)"
    return None


def phase10(cli_main, path) -> dict:
    """Phase 10: every PHASE10_ORACLE run through the CLI, gated on it;
    the 32^3 elliptic runs (10c, 10d) a first and a warm call, the rest one
    call each (the script's time limit).  ``path(name, fn, kernels)`` runs
    fn as a counted path."""
    out = {}
    for name, spec in PHASE10_ORACLE.items():
        warm = 1 if name.startswith(("10c", "10d elliptic")) else 0
        ((rc, text), first_s, warm_s), counts = path(
            name, lambda: timed_twice(lambda: run_cli(cli_main, spec["argv"]),
                                      warm_reps=warm), ["chebdiff_last_kernel"])
        require(rc == 0, f"{name} failed (rc {rc}): {text[-3000:]!r}")
        got = parse_cli(text)
        why = phase10_ok(name, got)
        require(why is None, f"{name}: {why}")
        out[name] = {"cli": " ".join(spec["argv"]), **got, "first_s": first_s,
                     "solve_s": warm_s, "k1_launches": counts["chebdiff_last_kernel"]}
    return out


# Phase 11: the dense tier, time stepping, heat and unsteady Stokes,
# through the CLI in float64.  UNSTEADY_ORACLE: the JAX package on the CPU
# in float64 (``python3 stokes_oracle.py unsteady``: its heat and ustokes
# drivers with the same options; the power law's per-step counts from
# UnsteadyStokes.rollout).  The heat lines it printed:
#   heat -dim 64,64,64 -dt 0.01 -nsteps 20
#     Norm of error vs analytic decay 1.535308e-04
#   heat -dim 64,64,64 -dt 0.01 -nsteps 20 -ts_type bdf2
#     Norm of error vs analytic decay 6.126108e-04
#   heat -dim 64,64,64 -dt 0.01 -nsteps 20 -ts_adapt
#     ts_adapt: 46 accepted steps, 4 rejected, dt 0.000598 .. 0.00548
#     Norm of error vs analytic decay 1.335599e-04
# (the default 16^2 run's 7.267423e-05 is tests/test_torch_heat.py's).
# Gates: heat errors to 1e-5 relative (-ts_adapt: 1e-4, its counts equal,
# its dt range to the 3 printed digits); ustokes outer min and max within
# 1 (dense: equal); the power law's count at each step within max(3, 10%)
# of the range of the oracle and its 8 runs from starts perturbed by 1e-13
# (``stokes_oracle.py perturb_unsteady``), its error to 1e-5 relative; the
# dense runs' errors to 1e-2 relative.  Changed criterion (ROADMAP queue
# 3): the linear CN and BDF2 errors move with the summation order (each
# step's FGMRES stops at rtol 1e-9 of a right-hand side of size sigma |v|,
# sigma 40 and 30, which leaves ~1e-7 of solve error a step beside the
# time integration's 1.5e-6): from starts perturbed by 1e-13 the JAX
# package takes CN 1.447e-06 .. 1.561e-06 (oracle 1.596369e-06) and BDF2
# 5.258e-06 .. 5.397e-06 (oracle 5.300682e-06), seeds 0-15 each, the port
# on the CPU 1.451447e-06 and 5.329930e-06.  So each is held within 1e-2
# relative of the range its oracle and perturbed runs span.
HEAT64 = ["-dim", "64,64,64", "-dt", "0.01", "-nsteps", "20"]
USTOKES20 = ["-dim", "20,20,20", "-dt", "0.05"]
UNSTEADY_ORACLE = {
    "11a heat 64^3 cn": dict(argv=["heat", *HEAT64], error=1.535308e-04, rtol=1e-5),
    "11a heat 64^3 bdf2": dict(argv=["heat", *HEAT64, "-ts_type", "bdf2"], error=6.126108e-04,
                               rtol=1e-5),
    "11a heat 64^3 adapt": dict(argv=["heat", *HEAT64, "-ts_adapt"], error=1.335599e-04,
                                rtol=1e-4, accepted=46, rejected=4, dt=(0.000598, 0.00548)),
    "11b ustokes 20^3 cn": dict(
        argv=["ustokes", *USTOKES20, "-nsteps", "10"], outer=(18, 20), error=1.596369e-06,
        rtol=1e-2, warm=0, perturbed_errors=(
            1.489344e-06, 1.559899e-06, 1.473492e-06, 1.503197e-06, 1.447232e-06,
            1.495369e-06, 1.513686e-06, 1.506643e-06, 1.484984e-06, 1.561074e-06,
            1.498722e-06, 1.493145e-06, 1.534897e-06, 1.469913e-06, 1.481198e-06,
            1.486751e-06)),
    "11b ustokes 20^3 bdf2": dict(
        argv=["ustokes", *USTOKES20, "-nsteps", "10", "-scheme", "bdf2"], outer=(17, 18),
        error=5.300682e-06, rtol=1e-2, warm=0, perturbed_errors=(
            5.376331e-06, 5.370763e-06, 5.295032e-06, 5.328956e-06, 5.333727e-06,
            5.28572e-06, 5.309365e-06, 5.275203e-06, 5.295776e-06, 5.312573e-06,
            5.295936e-06, 5.283946e-06, 5.257911e-06, 5.318776e-06, 5.397492e-06,
            5.332955e-06)),
    "11b ustokes 20^3 powerlaw": dict(
        argv=["ustokes", *USTOKES20, "-nsteps", "5", "-rheology", "1", "-exponent", "3"],
        per_step=[43, 61, 61, 77, 74], error=7.428252e-07, rtol=1e-5, warm=0,
        perturbed=([42, 59, 59, 77, 72], [43, 60, 59, 77, 71], [42, 61, 59, 76, 74],
                   [41, 62, 59, 78, 73], [42, 62, 59, 78, 73], [42, 61, 58, 78, 73],
                   [42, 61, 60, 75, 74], [42, 61, 59, 78, 70])),
    "11c ustokes 16^3 dense-device": dict(
        argv=["ustokes", "-dim", "16,16,16", "-dt", "0.05", "-nsteps", "10", "-saddle_pc",
              "dense-device"], outer=(1, 1), error=1.462653e-06, rtol=1e-2,
        batched="(1024, 16, 16, 16) float64"),
    "11c ustokes 12^3 dense": dict(
        argv=["ustokes", "-dim", "12,12,12", "-dt", "0.05", "-nsteps", "10", "-saddle_pc",
              "dense"], outer=(1, 1), error=1.388043e-06, rtol=1e-2, warm=0,
        batched="(1024, 12, 12, 12) float64"),
}


def parse_unsteady(out: str) -> dict:
    """The error and counts a heat or ustokes CLI run printed."""
    got = {}
    me = re.search(r"Norm of error.*?([-+\d.]+e[-+]\d+)", out)
    got["error"] = float(me.group(1)) if me else None
    ma = re.search(r"ts_adapt: (\d+) accepted steps, (\d+) rejected, dt (\S+) \.\. (\S+)", out)
    if ma:
        got.update(accepted=int(ma.group(1)), rejected=int(ma.group(2)),
                   dt=(float(ma.group(3)), float(ma.group(4))))
    mo = re.search(r"Outer iterations per step: min (\d+)  max (\d+)", out)
    if mo:
        got["outer"] = (int(mo.group(1)), int(mo.group(2)))
    ms = re.search(r"Outer iterations each step: (\[.*\])", out)
    if ms:
        got["per_step"] = json.loads(ms.group(1))
    return got


def phase11_ok(name: str, got: dict) -> str | None:
    """Why a phase 11 run misses UNSTEADY_ORACLE[name]'s gates, or None
    (the gates are listed above the table)."""
    spec = UNSTEADY_ORACLE[name]
    err = got["error"]
    if err is None or not math.isfinite(err):
        return f"error {err}"
    if "accepted" in spec:
        if (got.get("accepted"), got.get("rejected"), got.get("dt")) != \
                (spec["accepted"], spec["rejected"], spec["dt"]):
            return (f"ts_adapt {got.get('accepted')} / {got.get('rejected')}, dt {got.get('dt')}; "
                    f"oracle {spec['accepted']} / {spec['rejected']}, dt {spec['dt']}")
    if "outer" in spec:
        slack = 0 if spec["outer"] == (1, 1) else 1
        if got.get("outer") is None or any(abs(a - b) > slack
                                           for a, b in zip(got["outer"], spec["outer"])):
            return f"outer min/max {got.get('outer')}, oracle {spec['outer']} (within {slack})"
    if "per_step" in spec:
        runs = [spec["per_step"], *spec["perturbed"]]
        ks = got.get("per_step") or []
        if len(ks) != len(spec["per_step"]) or any(
                not _within(k, min(r), max(r)) for k, r in zip(ks, zip(*runs))):
            return f"per step {ks}, the runs span {list(zip(*runs))} (max(3, 10%) beyond)"
    errs = [spec["error"], *spec.get("perturbed_errors", ())]
    lo, hi = min(errs) * (1 - spec["rtol"]), max(errs) * (1 + spec["rtol"])
    if not lo <= err <= hi:
        return f"error {err:.6e} outside {lo:.6e} .. {hi:.6e}"
    return None


def phase11(cli_main, path, k1_shapes) -> dict:
    """Phase 11: every UNSTEADY_ORACLE run through the CLI, gated on it,
    a first and a warm call each (one call where ``warm`` is 0); the dense
    runs must launch K1 on their batched assembly shape."""
    out = {}
    for name, spec in UNSTEADY_ORACLE.items():
        ((rc, text), first_s, warm_s), counts = path(
            name, lambda: timed_twice(lambda: run_cli(cli_main, spec["argv"]),
                                      warm_reps=spec.get("warm", 1)), ["chebdiff_last_kernel"])
        require(rc == 0, f"{name} failed (rc {rc}): {text[-3000:]!r}")
        got = parse_unsteady(text)
        why = phase11_ok(name, got)
        require(why is None, f"{name}: {why}")
        if "batched" in spec:
            require(k1_shapes[name].get(spec["batched"], 0) > 0,
                    f"{name}: K1 was not launched on the assembly's {spec['batched']}")
        out[name] = {"cli": " ".join(spec["argv"]), **got, "first_s": first_s,
                     "solve_s": warm_s, "k1_launches": counts["chebdiff_last_kernel"],
                     "k1_launches_by_shape": k1_shapes[name]}
    return out


# Phase 12: thermal convection and the Krylov-Schur eigensolver in float64.
# CONVECTION_ORACLE: the JAX package on the CPU in float64 (``python3
# stokes_oracle.py convection``: its convection driver on the same command
# lines, with the full-precision diagnostics of each run and the
# eigenvalues captured as it ran; the printed Nu(volume)).  12a:
# Blankenbach case 1a marched with the dense saddle PC (bench.py's), its
# steps within one chunk (50) of the oracle's, where they agree its
# diagnostics within 1e-6 relative of the oracle's, and Nu(top) and Vrms
# within 1% of the published 4.884409 and 42.864947; 10 steps on the
# nested tree (tbc 1) and 20 with the 3/2-rule advection, Nu and Vrms to
# 1e-8; -ts_adapt (tests/test_convection.py's adaptive case), accepted and
# rejected steps within max(3, 10%), the dt range within 10%, Nu within
# 2e-3.  12b: -newton on 12a's line, the Newton count equal, each Krylov
# count within max(3, 10%), Nu and Vrms within 1e-8 of the oracle's and 1%
# of the published values.  12c: -stability 2 at 12x12, Ra 2000: Ra_c
# within 1e-6 relative of 8 pi^4 (tests/test_eig.py:189), converged, its
# operator applications and the growth rates' within max(3, 10%) of the
# oracle's, the growth rates within 1e-6 of the oracle's, the same verdict.
BLANKENBACH = ["-dim", "16,16", "-ra", "1e4", "-dt", "5e-4", "-bc", "freeslip", "-sides",
               "insulated"]
PUBLISHED_1A = {"nu": 4.884409, "vrms": 42.864947}   # Blankenbach et al. (1989), case 1a
CONVECTION_ORACLE = {
    "12a blankenbach": dict(
        argv=["convection", *BLANKENBACH, "-steady_tol", "1e-3", "-stokes_pc", "dense"],
        steps=600, nu_top=4.891431405541178, nu_bottom=4.891431405541168, nu_volume=4.884664,
        vrms=42.8665163561841, rtol=1e-6, published=True),
    "12a nested": dict(
        argv=["convection", *BLANKENBACH, "-nsteps", "10"], nu_top=1.1123120618510973,
        nu_bottom=1.1123120521316372, nu_volume=2.368198, vrms=24.914237533123497, rtol=1e-8),
    "12a dealias": dict(
        argv=["convection", "-dim", "12,12", "-ra", "1e4", "-dt", "5e-4", "-bc", "freeslip",
              "-sides", "insulated", "-nsteps", "20", "-stokes_pc", "dense", "-dealias", "1"],
        nu_top=2.1631584295610016, nu_bottom=2.1631584295609967, nu_volume=10.030181,
        vrms=65.41113107379206, rtol=1e-8, warm=1),
    "12a adapt": dict(
        argv=["convection", "-ts_adapt", "-dim", "12,12", "-ra", "5e3", "-dt", "1e-3",
              "-ts_dt0", "2e-5", "-steady_tol", "1e-4", "-stokes_pc", "dense"],
        accepted=377, rejected=1, dt=(2e-05, 0.00219), nu_top=3.8051115171546765),
    "12b newton": dict(
        argv=["convection", *BLANKENBACH, "-steady_tol", "1e-3", "-stokes_pc", "dense",
              "-newton"],
        newton=5, krylov=[4, 12, 12, 20, 28], nu_top=4.891494051655885,
        nu_bottom=4.891494051656955, vrms=42.86685725327048, rtol=1e-8, published=True),
    "12c stability": dict(
        argv=["convection", "-stability", "2", "-dim", "12,12", "-ra", "2000", "-stokes_pc",
              "dense"],
        ra_c_matvecs=22, growth=[-9.869604401559814, -16.925454704631253, 30.921383023053693],
        growth_matvecs=23, verdict="UNSTABLE"),
}
# 12d: the Busse et al. (1994) square cell at bench.py::bench_convection3d's
# width through the model API: (14, 14, 12), Ra 3e4, rigid top and bottom,
# insulated free-slip sidewalls, aspect (1.5, 1.5), the saddle inverse
# factored on the card (n = 9,408), steady_newton(warmup=300, rtol 1e-7)
# as tests/test_convection.py:407 runs it; held to BUSSE_LADDER.json's
# "seed" (the JAX package on the CPU, 327 s): Nu and Vrms within 1e-3
# relative, Nu(bottom) within 1e-3 of Nu(top), the x-y symmetry error under
# 1e-5.  12e: bench.py::bench_convection_var_eta's configuration (16^2, Ra
# 2e3, dt 2e-4, contrast 10, lag 25) for VAR_ETA_STEPS steps on the lagged
# dense PC and on the eta-aware nested tree (``stokes_oracle.py
# convection``'s var_eta): Nu within 1e-8 of the oracle's on both, the
# outer count of a fresh solve at the rolled state within max(3, 10%).
BUSSE_SEED = {"nu": 3.2733793704775707, "vrms": 39.01461680873072}
VAR_ETA_STEPS = 6   # 12 before phase 13 came; 6 keeps the script within its time limit
VAR_ETA_ORACLE = {"dense": dict(nu=1.0031108168580676, fresh_outer=1),
                  "nested": dict(nu=1.0031108185866369, fresh_outer=32)}


def _max10(k: int, ref: int) -> bool:
    return abs(k - ref) <= max(3, 0.1 * ref)


def phase12_ok(name: str, got: dict) -> str | None:
    """Why a phase 12 CLI run misses CONVECTION_ORACLE[name]'s gates, or
    None (the gates are listed above the table)."""
    spec = CONVECTION_ORACLE[name]
    if "steps" in spec:
        if abs(got["steps"] - spec["steps"]) > 50:
            return f"steps {got['steps']}, oracle {spec['steps']} (one chunk, 50)"
    if "rtol" in spec and ("steps" not in spec or got["steps"] == spec["steps"]):
        for key in ("nu_top", "nu_bottom", "vrms"):
            if abs(got[key] - spec[key]) > spec["rtol"] * abs(spec[key]):
                return f"{key} {got[key]!r}, oracle {spec[key]!r} ({spec['rtol']:.0e})"
        # printed to 6 decimals by both drivers
        if "nu_volume" in spec and abs(got["nu_volume"] - spec["nu_volume"]) > max(
                spec["rtol"] * spec["nu_volume"], 1.5e-6):
            return f"Nu(volume) {got['nu_volume']}, oracle {spec['nu_volume']}"
    if spec.get("published"):
        for key, ref in (("nu_top", PUBLISHED_1A["nu"]), ("vrms", PUBLISHED_1A["vrms"])):
            if abs(got[key] - ref) > 1e-2 * ref:
                return f"{key} {got[key]!r}, published {ref} (1%)"
    if "accepted" in spec:
        if not (_max10(got["accepted"], spec["accepted"])
                and _max10(got["rejected"], spec["rejected"])):
            return (f"ts_adapt {got['accepted']} / {got['rejected']}, "
                    f"oracle {spec['accepted']} / {spec['rejected']}")
        if any(abs(a - b) > 0.1 * b for a, b in zip(got["dt"], spec["dt"])):
            return f"dt range {got['dt']}, oracle {spec['dt']} (10%)"
        if abs(got["nu_top"] - spec["nu_top"]) > 2e-3 * spec["nu_top"]:
            return f"Nu {got['nu_top']!r}, oracle {spec['nu_top']!r} (2e-3)"
    if "newton" in spec:
        if got["newton"] != spec["newton"] or len(got["krylov"]) != len(spec["krylov"]) or \
                not all(_max10(k, r) for k, r in zip(got["krylov"], spec["krylov"])):
            return (f"Newton {got['newton']} Krylov {got['krylov']}, oracle {spec['newton']} "
                    f"{spec['krylov']} (max(3, 10%))")
    if "growth" in spec:
        ra_c_exact = 8.0 * math.pi ** 4
        if not got["ra_c_converged"] or abs(got["ra_c"] - ra_c_exact) > 1e-6 * ra_c_exact:
            return f"Ra_c {got['ra_c']!r} (converged {got['ra_c_converged']}), 8 pi^4 (1e-6)"
        if not (_max10(got["ra_c_matvecs"], spec["ra_c_matvecs"])
                and _max10(got["growth_matvecs"], spec["growth_matvecs"])):
            return (f"operator applications {got['ra_c_matvecs']} / {got['growth_matvecs']}, "
                    f"oracle {spec['ra_c_matvecs']} / {spec['growth_matvecs']}")
        if not got["growth_converged"] or len(got["growth"]) != len(spec["growth"]) or any(
                abs(a - b) > 1e-6 for a, b in zip(sorted(got["growth"]), sorted(spec["growth"]))):
            return f"growth rates {got['growth']}, oracle {spec['growth']} (1e-6)"
        if got["verdict"] != spec["verdict"]:
            return f"verdict {got['verdict']}, oracle {spec['verdict']}"
    return None


@contextlib.contextmanager
def captured_continuation():
    """The problem and results of the last ``StokesProblem.
    solve_continuation`` a run makes (the stokes CLI's), in ``got``."""
    from spectral_tpu_torch.models.stokes import StokesProblem

    got = {}
    orig = StokesProblem.solve_continuation

    def cont(self, *a, **kw):
        got["problem"], got["results"] = self, orig(self, *a, **kw)
        return got["results"]

    StokesProblem.solve_continuation = cont
    try:
        yield got
    finally:
        StokesProblem.solve_continuation = orig


@contextlib.contextmanager
def captured_convection():
    """Capture what a convection CLI run computes, at full precision: the
    diagnostics of its march, rollout or Newton solve (and that solve's
    counts), its critical Rayleigh number and growth rates."""
    from spectral_tpu_torch.models.convection import ConvectionModel as M

    got = {}
    orig = {k: getattr(M, k) for k in ("rollout", "march_to_steady", "march_adaptive",
                                       "steady_newton", "critical_rayleigh",
                                       "stability_eigenvalues")}

    def diag(m, T, x):
        got.update(m._diagnostics(T, x), nu_volume=float(m.nusselt_volume(T, x)))

    def rollout(self, *a, **kw):
        T, N, x = orig["rollout"](self, *a, **kw)
        diag(self, T, x)
        return T, N, x

    def marcher(key):
        def run(self, *a, **kw):
            T, x, info = orig[key](self, *a, **kw)
            diag(self, T, x)
            got.update(steps=info["steps"], converged=info["converged"])
            if key == "march_adaptive":
                got.update(accepted=info["steps"], rejected=info["rejects"],
                           dt=(min(info["dts"]), max(info["dts"])))
            if key == "steady_newton":
                got.update(newton=int(info["newton"].iters),
                           krylov=[int(k) for k in info["newton"].ksp_iters],
                           stokes_solves_lower_bound=info["steps"])
            return T, x, info
        return run

    def critical_rayleigh(self, *a, **kw):
        ra_c, res = orig["critical_rayleigh"](self, *a, **kw)
        got.update(ra_c=float(ra_c), ra_c_converged=bool(res.converged),
                   ra_c_matvecs=int(res.matvecs))
        return ra_c, res

    def stability_eigenvalues(self, *a, **kw):
        res = orig["stability_eigenvalues"](self, *a, **kw)
        growth = [float(z.real) for z in res.eigenvalues]
        got.update(growth=growth, growth_converged=bool(res.converged),
                   growth_matvecs=int(res.matvecs),
                   verdict="UNSTABLE" if max(growth) > 0 else "stable")
        return res

    patched = {"rollout": rollout, "critical_rayleigh": critical_rayleigh,
               "stability_eigenvalues": stability_eigenvalues,
               **{k: marcher(k) for k in ("march_to_steady", "march_adaptive", "steady_newton")}}
    for k, fn in patched.items():
        setattr(M, k, fn)
    try:
        yield got
    finally:
        for k, fn in orig.items():
            setattr(M, k, fn)


def busse_model(dev):
    """12d's model and initial temperature (bench.py::bench_convection3d)."""
    import numpy as np
    import torch

    from spectral_tpu_torch.models.convection import ConvectionConfig, ConvectionModel
    from spectral_tpu_torch.solvers.krylov import KSPConfig

    cfg = ConvectionConfig(Ra=3e4, dt=2e-4, velocity_bc="rigid", side_bc="insulated",
                           stokes_pc="dense-device",
                           stokes_ksp=KSPConfig(type="fgmres", rtol=1e-7, max_it=200,
                                                restart=80))
    m = ConvectionModel.box((14, 14, 12), cfg, aspect=(1.5, 1.5), device=dev)
    x, y, z = (m.grid.coords_np[..., i] for i in range(3))
    T0 = (1.0 - z) + 0.05 * (np.cos(np.pi * x / 1.5) + np.cos(np.pi * y / 1.5)) * np.sin(np.pi * z)
    return m, torch.as_tensor(T0, dtype=torch.float64, device=dev)


def busse_newton():
    from spectral_tpu_torch.solvers.newton import NewtonConfig
    return NewtonConfig(rtol=1e-7, max_it=25, ksp_ew=True)


def var_eta_model(dev, stokes_pc: str):
    """12e's model (bench.py::bench_convection_var_eta's configuration)."""
    from spectral_tpu_torch.models.convection import ConvectionConfig, ConvectionModel
    from spectral_tpu_torch.solvers.krylov import KSPConfig

    cfg = ConvectionConfig(Ra=2e3, dt=2e-4, velocity_bc="freeslip", side_bc="insulated",
                           eta_contrast=10.0, stokes_pc=stokes_pc, stokes_pc_lag=25,
                           stokes_ksp=KSPConfig(type="fgmres", rtol=1e-6, max_it=120,
                                                restart=60))
    return ConvectionModel.unit_box((16, 16), cfg, device=dev)


def phase12(cli_main, path, k1_shapes) -> dict:
    """Phase 12: every CONVECTION_ORACLE run through the CLI (first call;
    a warm call too where ``warm`` is 1), then the Busse cell (12d, one
    call after the set-up) and the variable-viscosity
    rollouts (12e, one call each with the model's set-up inside it)
    through the model API; K1 launches by shape for each path."""
    import numpy as np
    import torch

    K1 = "chebdiff_last_kernel"
    dev = torch.device("cuda")
    out = {}

    def record(name, counts, first_s, warm_s, **rec):
        out[name] = {**rec, "first_s": first_s, "warm_s": warm_s,
                     "k1_launches": counts[K1], "k1_launches_by_shape": k1_shapes[name]}

    for name, spec in CONVECTION_ORACLE.items():
        with captured_convection() as got:
            ((rc, text), first_s, warm_s), counts = path(
                name, lambda: timed_twice(lambda: run_cli(cli_main, spec["argv"]),
                                          warm_reps=spec.get("warm", 0)), [K1])
        require(rc == 0, f"{name} failed (rc {rc}): {text[-3000:]!r}")
        why = phase12_ok(name, got)
        require(why is None, f"{name}: {why}")
        record(name, counts, first_s, warm_s, cli=" ".join(spec["argv"]), **got)
    # 12d: the Busse square cell through the model API: the model's set-up
    # (the saddle inverse's assembly and factorization on the card), then
    # steady_newton once (the script's time limit: no warm call)
    name = "12d busse"
    solves = {"solve_stokes": 0, "_stability_dv": 0}

    def busse():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m, T0 = busse_model(dev)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        for key in solves:
            def counted(*a, _key=key, _fn=getattr(m, key), **kw):
                solves[_key] += 1
                return _fn(*a, **kw)
            setattr(m, key, counted)
        return setup_s, timed_twice(lambda: m.steady_newton(T0, warmup=300,
                                                            newton=busse_newton()), warm_reps=0)

    (setup_s, ((T, x, info), first_s, warm_s)), counts = path(name, busse, [K1])
    Tn = T.cpu().numpy()
    sym = float(np.abs(Tn - np.swapaxes(Tn, 0, 1)).max())
    nu, nu_b, vrms = info["nu_top"], info["nu_bottom"], info["vrms"]
    require(info["converged"], f"{name}: Newton did not converge ({info['newton'].reason_str()})")
    require(abs(nu - BUSSE_SEED["nu"]) <= 1e-3 * BUSSE_SEED["nu"],
            f"{name}: Nu {nu!r}, BUSSE_LADDER.json {BUSSE_SEED['nu']!r} (1e-3)")
    require(abs(vrms - BUSSE_SEED["vrms"]) <= 1e-3 * BUSSE_SEED["vrms"],
            f"{name}: Vrms {vrms!r}, BUSSE_LADDER.json {BUSSE_SEED['vrms']!r} (1e-3)")
    require(abs(nu_b - nu) <= 1e-3 * nu, f"{name}: Nu(bottom) {nu_b!r}, Nu(top) {nu!r}")
    require(sym < 1e-5, f"{name}: x-y symmetry error {sym:.3e} >= 1e-5")
    require(k1_shapes[name].get("(1024, 14, 14, 12) float64", 0) > 0,
            f"{name}: K1 was not launched on the assembly's (1024, 14, 14, 12) float64")
    record(name, counts, first_s, warm_s, setup_s=setup_s, nu_top=nu, nu_bottom=nu_b,
           vrms=vrms, symmetry=sym,
           newton=int(info["newton"].iters), krylov=[int(k) for k in info["newton"].ksp_iters],
           stokes_solves_lower_bound=info["steps"], stokes_solves=solves,
           converged=info["converged"])
    del T, x, info
    torch.cuda.empty_cache()
    # 12e: variable viscosity, the lagged dense PC and the eta-aware nested tree
    for pc, spec in VAR_ETA_ORACLE.items():
        name = f"12e var eta {pc}"

        def run():
            m = var_eta_model(dev, pc)
            T, _, x = m.rollout(m.conductive_state(amp=0.05), VAR_ETA_STEPS)
            return T, float(m.nusselt_top(T)), m.solve_stokes(T, m.stokes.zero_state()).iters

        ((T, nu, fresh), first_s, _), counts = path(
            name, lambda: timed_twice(run, warm_reps=0), [K1])
        require(abs(nu - spec["nu"]) <= 1e-8 * spec["nu"],
                f"{name}: Nu {nu!r}, oracle {spec['nu']!r} (1e-8)")
        require(_max10(int(fresh), spec["fresh_outer"]),
                f"{name}: fresh outer {fresh}, oracle {spec['fresh_outer']} (max(3, 10%))")
        if pc == "dense":
            require(k1_shapes[name].get("(512, 16, 16) float64", 0) > 0,
                    f"{name}: K1 was not launched on the refresh's (512, 16, 16) float64")
        record(name, counts, first_s, None, steps=VAR_ETA_STEPS, nu_top=nu,
               fresh_outer=int(fresh))
    return out


# Phase 13: the differentiable tier in float64 at full width.  13a: K1 in
# reverse mode (the autograd pair _K1 / _K1T) against a plain pair of
# torch.matmul products (PlainK1 below), at every K1_PATH_SHAPES shape in
# float64, at (20, 20, 20) float32 and under torch.func.vmap at
# K1_BATCHED_SHAPES: torch.func.vjp, torch.autograd.grad of a
# requires_grad tensor, jvp-of-vjp and vmap-of-vjp, bit for bit where the
# forward is (float64), else within BOUND; K1^T timed as phase 1 times
# K1; K2 refuses a graph.  13b: StokesProblem.adjoint_gradient at
# README:52's converged 20^3 state (phase 8's CLI run, captured; the
# continuation through the API when phase 8 did not run), under the
# nested make_pc(adjoint=True):
# the adjoint FGMRES converges, its count within max(3, 10%) of the range
# of ADJOINT52_ORACLE (the JAX package's count from the zero start and
# from nine perturbed ones, 120-151, ``stokes_oracle.py adjoint52`` and
# ``perturb_adjoint52``; the port's CPU runs took 129 and 135), and the hardness
# component within 1e-4 relative of central differences (h 1e-4) of two
# Newton solves started at x* with rtol 1e-12 (tests/test_adjoint.py:94).
# 13c: rollout_diff at Blankenbach 1a (16^2, Ra 1e4, dt 5e-4, free slip,
# insulated, the dense PC; the Stokes and heat solves at rtol 1e-10 and
# 1e-12, as tests/test_convection.py:237 runs them, so the primal's
# finite differences are smooth): 100 steps from conductive_state(0.05),
# loss Nu(top) + 1e-2 Vrms, the gradient in Ra and a seeded T0 direction
# within 1e-3 of central differences; then at 33 and 97 steps
# checkpoint=True equal to False to 1e-8 and, from 33 to 97 steps, the
# growth of max_memory_allocated over the backward at least 3x smaller
# checkpointed; then 12e's
# variable-viscosity configuration (contrast 10, the dense PC refactored
# each solve, rtol as above) for 12 steps, the contrast gradient through
# _stokes_solve_diff's operator term within 1e-3 (h 1e-3).  13d: the
# transient adjoint at 11b's power law (20^3, dt 0.05, 5 CN steps,
# exponent 3, the ustokes driver's defaults; the finite differences' two
# rollouts take Newton to rtol 1e-12, tests/test_stokes_unsteady.py:151's),
# qoi sum(v_N^2):
# adjoint_gradient equal to adjoint_gradient_checkpointed to 1e-7,
# forward_steps == 2N, the hardness component within 1e-5 of central
# differences (h 1e-6).  13e: the ported adjoint_fit_demo -opt lbfgs -n 32
# (exit 0: hardness 1.6 within 0.02), and implicit_hvp on its problem
# (32^2, hardness 1.3, qoi sum(v^2)/2, the hardness direction) within
# 1e-6 (max(1, |fd|)) of central differences (h 1e-5) of implicit_gradient
# (tests/test_adjoint.py:199).  ADJOINT52_ORACLE: the JAX count from the
# zero start, then from starts perturbed by 1e-13 (seeds 0-7) and 1e-11
# (seed 0), on the CPU in float64.
ADJOINT52_ORACLE = {"iters": 120, "perturbed": (143, 126, 122, 143, 123, 134, 151, 131, 127)}


def plain_k1_pair():
    """(K1, K1^T) as plain torch.matmul products with the kernel pair's
    structure (each one's backward the other, jvp itself, a generated vmap
    rule): the oracle phase 13a holds the kernel pair to."""
    import torch

    from spectral_tpu_torch.ops import cuda_cheb

    class PlainK1(torch.autograd.Function):
        generate_vmap_rule = True

        @staticmethod
        def forward(u):
            return cuda_cheb.chebdiff_last_ref(u)

        @staticmethod
        def setup_context(ctx, inputs, output):
            pass

        @staticmethod
        def backward(ctx, g):
            return PlainK1T.apply(g)

        @staticmethod
        def jvp(ctx, t):
            return PlainK1.apply(t)

    class PlainK1T(torch.autograd.Function):
        generate_vmap_rule = True

        @staticmethod
        def forward(g):
            return cuda_cheb.chebdiff_last_t_ref(g)

        @staticmethod
        def setup_context(ctx, inputs, output):
            pass

        @staticmethod
        def backward(ctx, u_bar):
            return PlainK1.apply(u_bar)

        @staticmethod
        def jvp(ctx, t):
            return PlainK1T.apply(t)

    return PlainK1.apply, PlainK1T.apply


def phase13a(dev) -> tuple[list, list]:
    """13a: (the cases' records, K1^T's timed comparisons)."""
    import torch

    from spectral_tpu_torch.ops import cuda_cheb
    from spectral_tpu_torch.ops.chebyshev import chebdiff

    k1p, _ = plain_k1_pair()

    def seeded(shape, dtype, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn(shape, generator=g, device=dev, dtype=dtype)

    def through(k1):   # nonlinear, so jvp-of-vjp has a non-zero answer
        return lambda x: k1(x) * k1(x) * k1(torch.sin(x))

    kernel = through(lambda x: chebdiff(x, -1))
    plain = through(k1p)
    rows = []
    cases = ([(s, torch.float64, False) for s in K1_PATH_SHAPES]
             + [((20, 20, 20), torch.float32, False)]
             + [(s, torch.float64, True) for s in K1_BATCHED_SHAPES])
    for seed, (shape, dtype, batched) in enumerate(cases):
        u, ct, tan = (seeded(shape, dtype, 200 + 3 * seed + i) for i in range(3))
        dname = str(dtype)[6:]
        fwd_bitwise = bool(torch.equal(cuda_cheb.chebdiff_last(u), cuda_cheb.chebdiff_last_ref(u)))
        cuda_cheb.reset_launch_counts()
        got = {}
        if batched:
            got["vmap_of_vjp"] = [torch.func.vmap(
                lambda z, f=f: torch.func.vjp(f, z)[1](z)[0])(u) for f in (kernel, plain)]
            got["vjp"] = [torch.func.vjp(lambda x: chebdiff(x, -1), u)[1](ct)[0],
                          cuda_cheb.chebdiff_last_t_ref(ct)]
        else:
            got["vjp"] = [torch.func.vjp(lambda x: chebdiff(x, -1), u)[1](ct)[0],
                          cuda_cheb.chebdiff_last_t_ref(ct)]
            x = u.clone().requires_grad_()
            got["autograd_grad"] = [torch.autograd.grad(chebdiff(x, -1), x, ct)[0],
                                    got["vjp"][1]]
            got["jvp_of_vjp"] = [torch.func.jvp(
                lambda z, f=f: torch.func.vjp(f, z)[1](ct)[0], (u,), (tan,))[1]
                for f in (kernel, plain)]
        torch.cuda.synchronize()
        launches = dict(cuda_cheb.LAUNCHES)
        k1t = {f"{tuple(s)} {str(d)[6:]}": c
               for (s, d), c in cuda_cheb.K1T_LAUNCHES_BY_SHAPE.items()}
        require(sum(k1t.values()) > 0, f"13a {shape} {dname}: no K1^T launch")
        rec = {"case": f"{shape} {dname}" + (" under vmap" if batched else ""),
               "forward_bitwise": fwd_bitwise, "k1_launches": launches["chebdiff_last_kernel"],
               "k1t_launches_by_shape": k1t}
        for name, (a, b) in got.items():
            require(bool(torch.isfinite(a).all()), f"13a {shape} {name}: non-finite")
            bitwise = bool(torch.equal(a, b))
            rel = float(torch.max(torch.abs(a - b)) / torch.max(torch.abs(b)))
            if fwd_bitwise and dtype == torch.float64:
                require(bitwise, f"13a {shape} {name}: not bit for bit the matmul path "
                                 f"(rel {rel:.3e}) where the forward is")
            require(rel <= BOUND[dname], f"13a {shape} {name}: error {rel:.3e}")
            rec[name] = {"bitwise": bitwise, "rel_err": rel}
        rows.append(rec)
        del u, ct, tan, got
    # K2 refuses a graph
    u3 = seeded((12, 10, 8), torch.float64, 299).requires_grad_()
    try:
        cuda_cheb.laplacian3d(u3)
    except RuntimeError as e:
        require("reverse mode" in str(e), f"13a K2 refused with {e!r}")
    else:
        raise RuntimeError("13a: K2 took a tensor that needs a graph")
    # K1^T timed beside torch.matmul(g, s D) and its bound (the bytes of K1)
    timed = []
    for shape, dtype in (((256, 64, 64, 64), torch.float32), ((20, 20, 20), torch.float64)):
        g = seeded(shape, dtype, 390)
        n, dname = shape[-1], str(dtype)[6:]
        c = compare("K1T", lambda: cuda_cheb.chebdiff_last_t(g),
                    lambda: cuda_cheb.chebdiff_last_t_ref(g), g, f"{shape} K1^T")
        D = cuda_cheb._diffmat(n, None, dtype, dev)
        c["library_ms"], c["library_call_ms"] = both_ms(lambda: torch.matmul(g, D))
        c["bound_ms"], c["bound_by"] = bound(2 * g.numel() * g.element_size()
                                             + n * n * g.element_size(), 2 * n * g.numel(),
                                             dname)
        c["kernel_ms"] = kernel_ms(lambda: cuda_cheb.chebdiff_last_t(g))
        timed.append(c)
        del g
    return rows, timed


def stokes52(dev):
    """README:52's StokesProblem at 20^3 in float64 through the API (the
    stokes driver's configuration for STOKES_README52): 13b's problem when
    phase 8 did not run."""
    import torch

    from spectral_tpu_torch.grid import Grid
    from spectral_tpu_torch.models.stokes import StokesConfig, StokesProblem
    from spectral_tpu_torch.solvers.krylov import KSPConfig
    from spectral_tpu_torch.solvers.newton import NewtonConfig

    cfg = StokesConfig(exact=2, rheology=1, regularization=1e-4, exponent=3.0, cont=4,
                       outer_ksp=KSPConfig(type="fgmres", rtol=1e-5, max_it=500, restart=50),
                       vel_ksp=KSPConfig(type="gmres", rtol=1e-5, max_it=4, restart=30),
                       svel_ksp=KSPConfig(type="preonly", rtol=1e-5, max_it=10000, restart=30),
                       schur_ksp=KSPConfig(type="gmres", rtol=1e-5, max_it=3, restart=30),
                       newton=NewtonConfig(rtol=1e-8, max_it=50))
    return StokesProblem(Grid((20, 20, 20), device=dev, dtype=torch.float64), cfg)


def blankenbach_diff(dev, **extra):
    """13c's model: Blankenbach 1a (16^2, Ra 1e4, dt 5e-4, free slip,
    insulated sides, the dense PC), the solves at rtol 1e-10 / 1e-12."""
    from spectral_tpu_torch.models.convection import ConvectionConfig, ConvectionModel
    from spectral_tpu_torch.solvers.krylov import KSPConfig

    cfg = ConvectionConfig(**{**dict(Ra=1e4, dt=5e-4, velocity_bc="freeslip",
                                     side_bc="insulated", stokes_pc="dense"), **extra},
                           stokes_ksp=KSPConfig(type="fgmres", rtol=1e-10, max_it=200,
                                                restart=80),
                           temp_ksp=KSPConfig(type="cg", rtol=1e-12, max_it=120))
    return ConvectionModel.unit_box((16, 16), cfg, device=dev)


def unsteady_powerlaw(dev, hardness: float = 1.0, newton_rtol: float = 1e-8):
    """13d's model: phase 11b's power law (20^3, dt 0.05, CN, exponent 3,
    the ustokes driver's defaults: outer FGMRES rtol 1e-9, Newton rtol
    1e-8; the finite differences take Newton to 1e-12)."""
    import torch

    from spectral_tpu_torch.grid import Grid
    from spectral_tpu_torch.models.stokes import StokesConfig
    from spectral_tpu_torch.models.stokes_unsteady import UnsteadyStokes
    from spectral_tpu_torch.solvers.krylov import KSPConfig
    from spectral_tpu_torch.solvers.newton import NewtonConfig

    cfg = StokesConfig(exact=1, boundary=0, rheology=1, hardness=hardness, exponent=3.0,
                       regularization=1.0, pcvel="fastdiag",
                       outer_ksp=KSPConfig(type="fgmres", rtol=1e-9, max_it=400, restart=100),
                       newton=NewtonConfig(rtol=newton_rtol, max_it=25))
    return UnsteadyStokes(Grid((20, 20, 20), device=dev, dtype=torch.float64), cfg, dt=0.05,
                          theta=0.5)


def timed_once(fn):
    """(result, seconds) of one call of fn, synchronized: the first or a
    warm call, as the caller records it."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


K1_NAME = "chebdiff_last_kernel"
PARTS13 = frozenset("abcde")   # phase 13's runs, 13a-13e
PARTS16 = frozenset(f"16{c}" for c in "abcde")   # phase 16's runs, 16a-16e
PARTS = PARTS13 | PARTS16 | frozenset(f"17{c}" for c in "abcdef")


class Phase13:
    """Phase 13's runs (see above), each a path with its own counts: K1's
    forward and transposed launches by shape in every record."""

    def __init__(self, path, k1_shapes, k1t_shapes, readme52=None):
        import torch

        self.path, self.k1_shapes, self.k1t_shapes = path, k1_shapes, k1t_shapes
        self.readme52 = readme52   # phase 8's (problem, continuation results), if it ran
        self.dev = torch.device("cuda")
        self.out = {}

    def timed_path(self, name, fn):
        """fn as a counted path that must launch K1, timed by one call:
        ((result, seconds), launch counts)."""
        return self.path(name, lambda: timed_once(fn), [K1_NAME])

    def record(self, name, counts, **rec):
        self.out[name] = {**rec, "k1_launches": counts["chebdiff_last_kernel"],
                          "k1_launches_by_shape": self.k1_shapes[name],
                          "k1t_launches_by_shape": self.k1t_shapes[name]}
        require(sum(self.k1t_shapes[name].values()) > 0, f"{name}: no K1^T launch")

    def run(self, parts=PARTS13) -> tuple[dict, list | None]:
        """The runs named in ``parts`` (letters of 13a-13e): (records, K1^T's
        timed cases from 13a, or None without it)."""
        k1t_timed = None
        if "a" in parts:
            t0 = time.perf_counter()
            rows, k1t_timed = phase13a(self.dev)
            self.out["13a k1 reverse mode"] = {"cases": rows, "k1t_timed": k1t_timed,
                                               "seconds": time.perf_counter() - t0}
        for part, run in (("b", self.stokes_adjoint), ("c", self.rollout_diff),
                          ("d", self.transient_adjoint), ("e", self.fit_and_hvp)):
            if part in parts:
                t0 = time.perf_counter()
                run()
                self.out[run.__name__ + " seconds"] = time.perf_counter() - t0
        return self.out, k1t_timed

    def stokes_adjoint(self):
        """13b: the steady Stokes adjoint at README:52."""
        import dataclasses

        import torch

        from spectral_tpu_torch.models.stokes import StokesProblem
        from spectral_tpu_torch.utils.interop import power_law_params_from_numpy, pytree_to_numpy

        if self.readme52 is not None:   # phase 8's converged state
            (p, res), cont_s = self.readme52, None
        else:
            p = stokes52(self.dev)
            (res, cont_s), _ = self.timed_path("13b continuation", p.solve_continuation)
        require(all(r.reason > 0 for r in res), "13b: the continuation did not converge")
        xs, th = res[-1].x, p.params_at(p.config.cont)
        theta = power_law_params_from_numpy(th, device=self.dev)

        def qoi(x, _):
            return torch.sum(x["v"] ** 2)

        name = "13b stokes adjoint README:52"
        ((grad, ares), adj_s), counts = self.timed_path(
            name, lambda: p.adjoint_gradient(qoi, xs, theta))
        lo = min(ADJOINT52_ORACLE["iters"], *ADJOINT52_ORACLE["perturbed"])
        hi = max(ADJOINT52_ORACLE["iters"], *ADJOINT52_ORACLE["perturbed"])
        require(ares.reason > 0,
                f"{name}: the adjoint FGMRES did not converge ({ares.reason_str()})")
        require(lo - max(3, 0.1 * lo) <= ares.iters <= hi + max(3, 0.1 * hi),
                f"{name}: {ares.iters} adjoint iterations, JAX range {lo}-{hi} (max(3, 10%))")
        pf = StokesProblem(p.grid, dataclasses.replace(
            p.config, newton=dataclasses.replace(p.config.newton, rtol=1e-12)))
        h = 1e-4

        def fd_solves():
            qs, its = [], []
            for s in (1.0, -1.0):
                r = pf.solve(xs, params=dataclasses.replace(th, hardness=th.hardness + s * h))
                # rtol 1e-12 of a start this close is at the round-off floor: a
                # line search that stalls there (1e-10 of the start) has converged
                require(r.reason > 0 or r.fnorm <= 1e-10 * r.fnorm_history[0],
                        f"{name}: the FD solve did not converge ({r.reason_str()}, "
                        f"{r.fnorm_history})")
                qs.append(float(qoi(r.x, None)))
                its.append((r.iters, r.ksp_iters, r.reason_str()))
            return (qs[0] - qs[1]) / (2 * h), its

        ((fd, fd_its), fd_s), _ = self.timed_path(name + " fd", fd_solves)
        g_h = float(grad.hardness)
        require(abs(g_h - fd) <= 1e-4 * abs(fd), f"{name}: hardness {g_h!r}, FD {fd!r} (1e-4)")
        self.record(name, counts, continuation_s=cont_s, adjoint_first_s=adj_s, fd_s=fd_s,
                    newton=[r.iters for r in res], adjoint_iters=ares.iters,
                    adjoint_reason=ares.reason_str(), jax_iters=ADJOINT52_ORACLE,
                    grad=pytree_to_numpy(grad), fd_hardness=fd,
                    fd_rel=abs(g_h - fd) / abs(fd), fd_newton=fd_its)
        self.out[name]["fd_k1_launches_by_shape"] = self.k1_shapes[name + " fd"]
        del p, pf, res, xs
        torch.cuda.empty_cache()

    def rollout_diff(self):
        """13c: rollout_diff at Blankenbach 1a, then 12e's variable viscosity."""
        import numpy as np
        import torch

        m = blankenbach_diff(self.dev)
        T0 = m.conductive_state(amp=0.05)
        dT = torch.as_tensor(np.random.default_rng(3).standard_normal(m.grid.dims) * 0.01,
                             device=self.dev)

        def loss_of(Ra, t, n=100, ck=False):
            T, x = m.rollout_diff(T0 + t * dT, n, Ra=Ra, checkpoint=ck)
            return m.nusselt_top(T) + 1e-2 * m.vrms(x)

        def f64(v, grad=False):
            return torch.tensor(v, dtype=torch.float64, device=self.dev, requires_grad=grad)

        def gradients(ck):
            args = [f64(1e4, True), f64(0.0, True)]
            loss = loss_of(*args, ck=ck)
            return float(loss.detach()), [float(g) for g in torch.autograd.grad(loss, args)]

        name = "13c rollout_diff blankenbach"
        ((loss, g), first_s), counts = self.timed_path(name, lambda: gradients(False))

        def fd_primal():
            with torch.no_grad():
                return [(float(loss_of(f64(1e4 + 1.0), f64(0.0)))
                         - float(loss_of(f64(1e4 - 1.0), f64(0.0)))) / 2.0,
                        (float(loss_of(f64(1e4), f64(1e-4)))
                         - float(loss_of(f64(1e4), f64(-1e-4)))) / 2e-4]

        (fd, fd_s), _ = self.timed_path(name + " fd", fd_primal)
        for a, b, what in zip(g, fd, ("Ra", "T0")):
            require(abs(a - b) <= 1e-3 * abs(b), f"{name}: {what} gradient {a!r}, FD {b!r} (1e-3)")

        def mem_growth(n, ck):
            """(peak bytes over the run and its backward, d loss / d Ra)."""
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            Ra = f64(1e4, True)
            g_ra = float(torch.autograd.grad(loss_of(Ra, f64(0.0), n, ck), Ra)[0])
            torch.cuda.synchronize()
            return torch.cuda.max_memory_allocated() - base, g_ra

        def memory():
            return {ck: [mem_growth(n, ck) for n in (33, 97)] for ck in (False, True)}

        # the checkpointed runs: their memory, and their gradient against the plain
        # loop's at 33 and 97 steps
        (mem, mem_s), _ = self.timed_path(name + " checkpointed", memory)
        for (_, a), (_, b), n in zip(mem[True], mem[False], (33, 97)):
            require(abs(a - b) <= 1e-8 * abs(b),
                    f"{name}: {n} steps, checkpointed d/dRa {a!r}, plain {b!r} (1e-8)")
        grow = {ck: v[1][0] - v[0][0] for ck, v in mem.items()}
        require(grow[False] > 0 and grow[True] < grow[False] / 3.0,
                f"{name}: memory growth 33 -> 97 steps {grow[True]} checkpointed, "
                f"{grow[False]} plain (need 3x less)")
        self.record(name, counts, steps=100, loss=loss, grad={"Ra": g[0], "T0": g[1]},
                    fd={"Ra": fd[0], "T0": fd[1]},
                    fd_rel=[abs(a - b) / abs(b) for a, b in zip(g, fd)],
                    first_s=first_s, fd_s=fd_s,
                    checkpointed={str(k): [{"steps": n, "peak_bytes": m_, "d_dRa": g_}
                    for n, (m_, g_) in zip((33, 97), v)]
                    for k, v in mem.items()},
                    memory_growth={"plain": grow[False], "checkpointed": grow[True]},
                    checkpointed_s=mem_s)
        self.out[name]["checkpointed_k1t_launches_by_shape"] = \
            self.k1t_shapes[name + " checkpointed"]
        del m
        mv = blankenbach_diff(self.dev, Ra=2e3, dt=2e-4, eta_contrast=10.0)
        Tv = mv.conductive_state(amp=0.05)

        def loss_c(c):
            T, x = mv.rollout_diff(Tv, 12, contrast=c)
            return mv.nusselt_top(T) + 1e-2 * mv.vrms(x)

        name = "13c rollout_diff var eta"

        def grad_c():
            c = f64(10.0, True)
            return float(torch.autograd.grad(loss_c(c), c)[0])

        (gc, first_s), counts = self.timed_path(name, grad_c)
        with torch.no_grad():
            fdc = (float(loss_c(f64(10.0 + 1e-3))) - float(loss_c(f64(10.0 - 1e-3)))) / 2e-3
        require(abs(gc - fdc) <= 1e-3 * abs(fdc), f"{name}: contrast {gc!r}, FD {fdc!r} (1e-3)")
        self.record(name, counts, steps=12, grad_contrast=gc, fd_contrast=fdc,
                    fd_rel=abs(gc - fdc) / abs(fdc), first_s=first_s)
        del mv
        torch.cuda.empty_cache()

    def transient_adjoint(self):
        """13d: the transient adjoint at 11b's power law."""
        import numpy as np
        import torch

        from spectral_tpu_torch.utils.interop import pytree_to_numpy

        um = unsteady_powerlaw(self.dev)
        u0, s_of_t, f_of_t, _, _ = um.manufactured(omega=1.0)
        N = 5
        times = np.arange(N + 1) * 0.05

        def qoi_v(v):
            return torch.sum(v * v)

        def full():
            traj, _, its = um.rollout(u0, times, s_of_t, f_of_t, keep_trajectory=True)
            grad, adj = um.adjoint_gradient(qoi_v, traj, times, s_of_t, f_of_t)
            return grad, adj, its

        name = "13d transient adjoint"
        ((grad, adj, fwd_its), first_s), counts = self.timed_path(name, full)
        ((grad_ck, info), ck_s), _ = self.timed_path(
            name + " checkpointed",
            lambda: um.adjoint_gradient_checkpointed(qoi_v, u0, times, s_of_t, f_of_t))
        gf, gc = pytree_to_numpy(grad), pytree_to_numpy(grad_ck)
        for k in gf:
            require(abs(gf[k] - gc[k]) <= 1e-7 * max(abs(gf[k]), 1.0),
                    f"{name}: {k} {gf[k]!r} full, {gc[k]!r} checkpointed (1e-7)")
        require(info["forward_steps"] == 2 * N, f"{name}: forward_steps {info['forward_steps']}")

        def J(hard):
            m = unsteady_powerlaw(self.dev, hard, newton_rtol=1e-12)
            v, _, _ = m.rollout(u0, times, s_of_t, f_of_t)
            return float(qoi_v(v))

        (fd, fd_s), _ = self.timed_path(name + " fd",
                                        lambda: (J(1.0 + 1e-6) - J(1.0 - 1e-6)) / 2e-6)
        require(abs(fd - gf["hardness"]) <= 1e-5 * abs(fd),
                f"{name}: hardness {gf['hardness']!r}, FD {fd!r} (1e-5)")
        self.record(name, counts, steps=N, forward_iters=fwd_its, adjoint_iters=adj,
                    checkpointed=info, grad=gf, grad_checkpointed=gc, fd_hardness=fd,
                    fd_rel=abs(fd - gf["hardness"]) / abs(fd), first_s=first_s,
                    checkpointed_first_s=ck_s, fd_s=fd_s)
        self.out[name]["checkpointed_k1t_launches_by_shape"] = \
            self.k1t_shapes[name + " checkpointed"]
        del um
        torch.cuda.empty_cache()

    def fit_and_hvp(self):
        """13e: the L-BFGS fit and one Hessian-vector product."""
        import torch

        from spectral_tpu_torch.examples import adjoint_fit_demo
        from spectral_tpu_torch.models.rheology import PowerLawParams
        from spectral_tpu_torch.solvers.adjoint import implicit_hvp
        from spectral_tpu_torch.solvers.krylov import KSPConfig
        from spectral_tpu_torch.utils.interop import power_law_params_from_numpy, pytree_to_numpy

        name = "13e adjoint_fit_demo lbfgs"
        ((rc, text), first_s), counts = self.timed_path(name, lambda: run_cli(
            adjoint_fit_demo.main, ["-opt", "lbfgs", "-n", "32", "-device", "cuda"]))
        mm = re.search(r"recovered hardness = (\S+) .*\[(\d+) solves, (\S+)\]", text)
        require(rc == 0 and mm is not None, f"{name}: exit {rc}: {text[-2000:]!r}")
        self.record(name, counts, recovered=float(mm.group(1)), solves=int(mm.group(2)),
                    reason=mm.group(3), first_s=first_s, lines=text.splitlines()[-3:])
        p = adjoint_fit_demo.fit_problem(32, self.dev, torch.float64, newton_rtol=1e-13)

        def qoi_fit(x, _):   # no observation: one cold solve fewer
            return 0.5 * torch.sum(x["v"] ** 2)

        def residual(xG, th_):
            F, _ = p.make_residual(th_)(xG)
            return {"v": F["v"], "p": p.project_p(F["p"])}

        ksp = KSPConfig(type="fgmres", rtol=1e-12, max_it=400, restart=100)

        def params(hard):
            return power_law_params_from_numpy(PowerLawParams(hard, 2.0, 1e-2, 1.0),
                                               device=self.dev)

        def grad_at(hard, x0=None):
            r = p.solve(x0, params=PowerLawParams(hard, 2.0, 1e-2, 1.0))
            # rtol 1e-13 reaches the round-off floor: a line search that
            # stalls there (1e-10 of the start) has converged
            require(r.reason > 0 or r.fnorm <= 1e-10 * r.fnorm_history[0],
                    f"13e: the solve at hardness {hard} did not converge ({r.reason_str()})")
            g_, a_ = p.adjoint_gradient(qoi_fit, r.x, params(hard), ksp=ksp)
            require(a_.reason > 0, f"13e: the adjoint at hardness {hard} did not converge")
            return r.x, g_, a_

        def hvp():
            xs_, _, a_ = grad_at(1.3)
            pc_setup, pc_apply = p.make_pc()
            apc_setup, apc_apply = p.make_pc(adjoint=True)
            with torch.no_grad():
                _, lin = p.make_residual(PowerLawParams(1.3, 2.0, 1e-2, 1.0))(xs_)
            fs, as_ = pc_setup(xs_, lin), apc_setup(xs_, lin)
            v = power_law_params_from_numpy(PowerLawParams(1.0, 0.0, 0.0, 0.0), device=self.dev)
            Hv, rt, ra = implicit_hvp(residual, qoi_fit, xs_, params(1.3), a_.x, v, ksp=ksp,
                                      M=lambda r: pc_apply(fs, r), Mt=lambda r: apc_apply(as_, r),
                                      null_project=p.null_project)
            require(rt.reason > 0 and ra.reason > 0, "13e: an HVP solve did not converge")
            return xs_, Hv, rt.iters, ra.iters

        name = "13e implicit_hvp"
        ((xs, Hv, t_its, a_its), first_s), counts = self.timed_path(name, hvp)
        h = 1e-5

        def fd_grad():
            gp, gm = (pytree_to_numpy(grad_at(1.3 + s * h, xs)[1]) for s in (1.0, -1.0))
            return {k: (gp[k] - gm[k]) / (2 * h) for k in gp}

        (fd, fd_s), _ = self.timed_path(name + " fd", fd_grad)
        hv = pytree_to_numpy(Hv)
        for k in hv:
            require(abs(hv[k] - fd[k]) <= 1e-6 * max(1.0, abs(fd[k])),
                    f"{name}: H v {k} {hv[k]!r}, FD {fd[k]!r} (1e-6)")
        self.record(name, counts, hvp=hv, fd=fd, tangent_iters=t_its, second_adjoint_iters=a_its,
                    first_s=first_s, fd_s=fd_s)


# Phase 14: the solver families in float64 at full width, gated on
# SOLVERS_ORACLE: the JAX package on the CPU in float64
# (``stokes_oracle.py solvers``), with the runs from perturbed starts
# (``stokes_oracle.py solvers_perturbed``: masked normal noise of 1e-13,
# seeds 0-7, and 1e-11, seed 0, on the start) for the counts held by range.
# 14a: the elliptic CLI in phase 6's 32^3 mg3 configuration with each
# -snes_type: the reason equal, the iteration count (and newtontr's Krylov
# count each step, and the total) within max(3, 10%) of the range the
# oracle and its perturbed runs span (newtontr: the oracle's alone, since
# its first radius is delta0 ||x0||, which a perturbed start changes), the
# error within 2x.  QN stops at CONVERGED_SNORM_RELATIVE with error 3.6e-6
# in the JAX package (its secant step stalls at this size with the default
# memory of 10): the card must end the same way.  14b: the Poisson CLI at
# 64^3 (phase 3's configuration) with -ksp_type bcgs, richardson (the
# unscaled step diverges on the fastdiag-preconditioned spectrum, up to
# 4.85: the JAX package reaches a non-finite norm at 278 iterations, exit
# code 2 here), chebyshev with its own bounds and with
# -ksp_chebyshev_eigenvalues 0.5,5: iterations within max(3, 10%), the
# reason equal, the error within 2x; MINRES on MINRES_SHAPES' saddle
# system, count and reason, error within 2x.  14c: the elliptic 32^3
# Newton with NewtonConfig(recycle=8), its counts as 14a's; README:52 at
# 20^3 through solve_continuation with recycle=8, the Newton count of each
# continuation step and the total FGMRES count within max(3, 10%) of the
# range of the oracle and its perturbed runs (1005-2362 against the plain
# run's 656: the deflation is neutral to negative under the nested PC), the
# error within 1e-6 of STOKES_ORACLE's.  14d: Blankenbach 1a by Anderson
# acceleration through the CLI (-accel): the steps within max(3, 10%), Nu
# and Vrms within 1e-8.
SOLVERS_ELLIPTIC32 = ["-dim", "32,32,32", "-exact", "0", "-gamma", "1", "-pc_type", "mg3",
                      "-snes_rtol", "1e-10", "-debug", "1"]
SOLVERS_POISSON64 = ["-m", "64", "-n", "64", "-p", "64", "-ksp_rtol", "1e-10"]
MINRES_SHAPES = ((64, 64, 48), (64, 64, 16))
SOLVERS_ORACLE = {
    "14a newtontr": dict(opts=["-snes_type", "newtontr"], newton=(11, 11),
                         krylov=[6, 6, 6, 6, 6, 6, 7, 7, 7, 7, 7], reason="CONVERGED_RTOL",
                         error=1.327827e-13),
    "14a qn": dict(opts=["-snes_type", "qn"], newton=(21, 21),
                   reason="CONVERGED_SNORM_RELATIVE", error=3.620405e-06),
    "14a anderson": dict(opts=["-snes_type", "anderson"], newton=(26, 27),
                         reason="CONVERGED_RTOL", error=8.473222e-13),
    "14a ngmres": dict(opts=["-snes_type", "ngmres"], newton=(17, 17), reason="CONVERGED_RTOL",
                       error=2.781209e-11),
    "14a ngmres npc": dict(opts=["-snes_type", "ngmres", "-npc_snes_type", "newtonls"],
                           newton=(11, 11), reason="CONVERGED_RTOL", error=2.049916e-12),
    "14a fas": dict(opts=["-snes_type", "fas"], newton=(10, 10), reason="CONVERGED_RTOL",
                    error=1.451061e-13),
    "14b bcgs": dict(opts=["-ksp_type", "bcgs"], iters=2, reason=2, error=3.058664e-14),
    "14b richardson": dict(opts=["-ksp_type", "richardson"], iters=278, reason=-5, error=None),
    "14b chebyshev": dict(opts=["-ksp_type", "chebyshev"], iters=63, reason=2,
                          error=9.129919e-13),
    "14b chebyshev bounds": dict(opts=["-ksp_type", "chebyshev", "-ksp_chebyshev_eigenvalues",
                                       "0.5,5"], iters=37, reason=2, error=2.510214e-13),
    "14b minres": dict(iters=47, reason=2, error=2.5733578601361273e-09),
    "14c recycle elliptic": dict(newton=(5, 5), krylov=[6, 7, 7, 7, 9], total=(36, 36),
                                 reason="CONVERGED_RTOL", error=2.020605904817785e-13),
    "14c recycle README:52": dict(newton=([2, 3, 3, 4, 5], [2, 3, 3, 4, 6]), total=(1005, 2362),
                                  oracle_total=1116, plain_total=656, error=6.057082e-01),
    "14d accel": dict(argv=["convection", *BLANKENBACH, "-steady_tol", "1e-3", "-stokes_pc",
                            "dense", "-accel"], steps=(220, 220), anderson=12,
                      nu_top=4.891502993347097, nu_bottom=4.891502993347054,
                      vrms=42.86692654112723),
}


@contextlib.contextmanager
def captured_returns(owner, name: str):
    """The return values of every call of ``owner.name`` made inside the
    block, in a list."""
    got, orig = [], getattr(owner, name)

    def wrapped(*a, **kw):
        got.append(orig(*a, **kw))
        return got[-1]

    setattr(owner, name, wrapped)
    try:
        yield got
    finally:
        setattr(owner, name, orig)


def minres_factors(shapes=MINRES_SHAPES, seed: int = 14):
    """14b's MINRES system as numpy factors, the one definition that this
    script, tests/test_torch_gpu.py and stokes_oracle.py build it from: the
    saddle family of tests/test_krylov.py::test_minres_spd_preconditioner_
    indefinite_operator on the state {"v": shapes[0], "p": shapes[1]}
    (at MINRES_SHAPES the size of a 64^3 field).  The velocity block is
    S = s^2 D^T D + 0.1 I on v's last axis (D the Chebyshev matrix of its
    length, s = 1 / ||D||_2), SPD; B v = v G^T with G normal / sqrt(nv);
    K = [[S, B^T], [B, 0]] is symmetric and indefinite; the PC is
    diag(S)^-1 on v and I on p, SPD.  Returns (D, s, G, diag(S), x*)."""
    import numpy as np

    from spectral_tpu_torch.ops.chebyshev import diffmat_np

    rng = np.random.default_rng(seed)
    nv, npp = shapes[0][-1], shapes[1][-1]
    D = diffmat_np(nv)
    s = 1.0 / np.linalg.norm(D, 2)
    G = rng.standard_normal((npp, nv)) / np.sqrt(float(nv))
    diag = s * s * np.sum(D * D, axis=0) + 0.1
    xstar = {"v": rng.standard_normal(shapes[0]), "p": rng.standard_normal(shapes[1])}
    return D, s, G, diag, xstar


def minres_system(dev, shapes=MINRES_SHAPES, seed: int = 14):
    """minres_factors' system on ``dev``, S applied through K1 and K1^T.
    Returns (K, M, x*)."""
    import torch

    from spectral_tpu_torch.ops import cuda_cheb

    _, s, G, diag, xstar = minres_factors(shapes, seed)
    G, dinv = torch.as_tensor(G, device=dev), torch.as_tensor(1.0 / diag, device=dev)
    xs = {k: torch.as_tensor(v, device=dev) for k, v in xstar.items()}

    def K(x):
        Sv = cuda_cheb.chebdiff_last_t(cuda_cheb.chebdiff_last(x["v"], s), s) + 0.1 * x["v"]
        return {"v": Sv + x["p"] @ G, "p": x["v"] @ G.T}

    return K, (lambda r: {"v": r["v"] * dinv, "p": r["p"]}), xs


def parse_elliptic(out: str) -> dict:
    """The elliptic CLI's counts, reason and error."""
    mn = re.search(r"Number of nonlinear iterations = (\d+)", out)
    mr = re.search(r"Reason for solver termination: (\S+)", out)
    mk = re.search(r"KSP iterations per Newton step: \[([\d, ]*)\]", out)
    me = re.search(r"Norm of error\s*: abs = (\S+)", out)
    require(mn and mr and mk and me, f"elliptic output not parsed: {out[-2000:]!r}")
    return {"newton": int(mn.group(1)), "reason": mr.group(1),
            "krylov": [int(k) for k in mk.group(1).split(",") if k.strip()],
            "error": float(me.group(1))}


def phase14_newton_ok(name: str, got: dict) -> str | None:
    """Why a 14a or 14c elliptic solve misses SOLVERS_ORACLE[name]'s gates
    (listed above the table), or None."""
    spec = SOLVERS_ORACLE[name]
    if got["reason"] != spec["reason"]:
        return f"reason {got['reason']}, oracle {spec['reason']}"
    if not _within(got["newton"], *spec["newton"]):
        return f"{got['newton']} iterations, the JAX runs span {spec['newton']} (max(3, 10%))"
    if "krylov" in spec:
        kr = spec["krylov"]
        if len(got["krylov"]) != got["newton"] or any(
                not _within(k, r, r) for k, r in zip(got["krylov"], kr)):
            return f"Krylov {got['krylov']}, oracle {kr} (max(3, 10%) each)"
        lo, hi = spec.get("total", (sum(kr), sum(kr)))
        if not _within(sum(got["krylov"]), lo, hi):
            return f"total Krylov {sum(got['krylov'])}, the JAX runs span {lo}..{hi}"
    if got["error"] > 2 * spec["error"]:
        return f"error {got['error']:.6e} > 2 x {spec['error']:.6e}"
    return None


def phase14(cli_main, path, k1_shapes) -> dict:
    """Phase 14 (see above): every path counted, K1 required on each, timed
    by one call (14b's short solves also warm), K1 launches by shape."""
    import dataclasses

    import torch

    from spectral_tpu_torch.grid import Grid
    from spectral_tpu_torch.models.convection import ConvectionModel
    from spectral_tpu_torch.models.elliptic import EllipticModel
    from spectral_tpu_torch.models.poisson import PoissonModel
    from spectral_tpu_torch.models.stokes import StokesProblem
    from spectral_tpu_torch.solvers.krylov import KSPConfig, minres
    from spectral_tpu_torch.solvers.newton import NewtonConfig

    K1 = "chebdiff_last_kernel"
    dev = torch.device("cuda")
    out = {}

    def record(name, counts, first_s, warm_s=None, **rec):
        out[name] = {**rec, "first_s": first_s, "warm_s": warm_s,
                     "k1_launches": counts[K1], "k1_launches_by_shape": k1_shapes[name]}

    # 14a: the elliptic CLI with each -snes_type
    for name, spec in SOLVERS_ORACLE.items():
        if not name.startswith("14a"):
            continue
        argv = ["elliptic", *SOLVERS_ELLIPTIC32, *spec["opts"]]
        ((rc, text), first_s, _), counts = path(
            name, lambda: timed_twice(lambda: run_cli(cli_main, argv), warm_reps=0), [K1])
        got = parse_elliptic(text)
        require(rc == (0 if spec["reason"].startswith("CONVERGED") else 2),
                f"{name}: exit code {rc}")
        why = phase14_newton_ok(name, got)
        require(why is None, f"{name}: {why}")
        record(name, counts, first_s, cli=" ".join(argv), **got)
    # 14b: the Poisson CLI with each Krylov type, then MINRES directly
    for name, spec in SOLVERS_ORACLE.items():
        if not name.startswith("14b") or "opts" not in spec:
            continue
        argv = ["poisson", *SOLVERS_POISSON64, *spec["opts"]]
        with captured_returns(PoissonModel, "solve") as solves:
            ((rc, text), first_s, warm_s), counts = path(
                name, lambda: timed_twice(lambda: run_cli(cli_main, argv), warm_reps=1), [K1])
        m = re.search(r"Norm of error (\S+) iterations (\d+)", text)
        require(m is not None, f"{name}: output not parsed: {text[-2000:]!r}")
        err, iters, reason = float(m.group(1)), int(m.group(2)), int(solves[-1].reason)
        require(rc == (0 if spec["reason"] > 0 else 2), f"{name}: exit code {rc}")
        require(reason == spec["reason"], f"{name}: reason {reason}, oracle {spec['reason']}")
        require(_within(iters, spec["iters"], spec["iters"]),
                f"{name}: {iters} iterations, oracle {spec['iters']} (max(3, 10%))")
        if spec["error"] is not None:
            require(err <= 2 * spec["error"], f"{name}: error {err:.6e} > 2 x {spec['error']:.6e}")
        record(name, counts, first_s, warm_s, cli=" ".join(argv), iterations=iters,
               reason=reason, error=err)
        del solves[:]
    name = "14b minres"
    spec = SOLVERS_ORACLE[name]
    K, M, xs = minres_system(dev)
    b = K(xs)
    (res, first_s, warm_s), counts = path(
        name, lambda: timed_twice(lambda: minres(K, b, M=M, rtol=1e-10, max_it=2000),
                                  warm_reps=1), [K1])
    err = max(float(torch.max(torch.abs(res.x[k] - xs[k]))) for k in xs)
    require(res.reason == spec["reason"], f"{name}: reason {res.reason}, oracle {spec['reason']}")
    require(_within(res.iters, spec["iters"], spec["iters"]),
            f"{name}: {res.iters} iterations, oracle {spec['iters']} (max(3, 10%))")
    require(err <= 2 * spec["error"], f"{name}: error {err:.6e} > 2 x {spec['error']:.6e}")
    shape = f"{MINRES_SHAPES[0]} float64"
    require(k1_shapes[name].get(shape, 0) > 0, f"{name}: K1 was not launched on {shape}")
    record(name, counts, first_s, warm_s, iterations=res.iters, reason=res.reason,
           error=err, rnorm=res.rnorm)
    del K, M, xs, b, res
    # 14c: recycling, the elliptic Newton and README:52's continuation
    name = "14c recycle elliptic"
    spec = SOLVERS_ORACLE[name]
    em = EllipticModel(Grid((32, 32, 32), device=dev), gamma=1.0)
    u, b, d = em.setup_problem(exact=0)
    (r, first_s, _), counts = path(name, lambda: timed_twice(lambda: em.solve(
        b, d, ksp=KSPConfig(type="fgmres", rtol=1e-5, max_it=500),
        newton=NewtonConfig(rtol=1e-10, max_it=50, recycle=8), pc_type="mg3"),
        warm_reps=0), [K1])
    got = {"newton": r.iters, "reason": r.reason_str(), "krylov": [int(k) for k in r.ksp_iters],
           "error": float(torch.max(torch.abs(r.x - u)))}
    why = phase14_newton_ok(name, got)
    require(why is None, f"{name}: {why}")
    require(r.recycle_U.dtype == torch.float64 and tuple(r.recycle_U.shape) == (8, 32 ** 3),
            f"{name}: the harvest is {r.recycle_U.dtype} {tuple(r.recycle_U.shape)}")
    record(name, counts, first_s, **got)
    del em, u, b, d, r
    name = "14c recycle README:52"
    spec = SOLVERS_ORACLE[name]
    p52 = stokes52(dev)
    p = StokesProblem(p52.grid, dataclasses.replace(
        p52.config, newton=dataclasses.replace(p52.config.newton, recycle=8)))
    (results, first_s, _), counts = path(
        name, lambda: timed_twice(p.solve_continuation, warm_reps=0), [K1])
    newton = [int(r.iters) for r in results]
    krylov = [[int(k) for k in r.ksp_iters] for r in results]
    total = sum(map(sum, krylov))
    err = p.error_vs_exact(results[-1].x)
    lo, hi = spec["newton"]
    require(len(newton) == len(lo) and all(_within(k, a, c) for k, a, c in zip(newton, lo, hi)),
            f"{name}: Newton {newton}, the JAX runs span {lo}..{hi} (max(3, 10%))")
    require(all(r.reason > 0 for r in results), f"{name}: a continuation step did not converge")
    require(_within(total, *spec["total"]),
            f"{name}: total FGMRES {total}, the JAX runs span {spec['total']} (max(3, 10%))")
    require(abs(err - spec["error"]) <= 1e-6 * spec["error"],
            f"{name}: error {err:.6e}, oracle {spec['error']:.6e} (1e-6 relative)")
    require(all(r.recycle_U is not None and r.recycle_U.dtype == torch.float64 for r in results),
            f"{name}: a harvest is missing or not float64")
    record(name, counts, first_s, newton=newton, krylov=krylov, total_krylov=total, error=err,
           oracle_total=spec["oracle_total"], plain_total_jax=spec["plain_total"])
    del p52, p, results
    torch.cuda.empty_cache()
    # 14d: Blankenbach 1a by Anderson acceleration over the time stepper
    name = "14d accel"
    spec = SOLVERS_ORACLE[name]
    with captured_returns(ConvectionModel, "steady_accelerated") as runs:
        ((rc, text), first_s, _), counts = path(
            name, lambda: timed_twice(lambda: run_cli(cli_main, spec["argv"]), warm_reps=0),
            [K1])
    require(rc == 0 and runs, f"{name} failed (rc {rc}): {text[-3000:]!r}")
    _, _, info = runs[-1]
    require(info["converged"], f"{name}: not converged")
    require(_within(info["steps"], *spec["steps"]),
            f"{name}: {info['steps']} steps, oracle {spec['steps']} (max(3, 10%))")
    for key in ("nu_top", "nu_bottom", "vrms"):
        require(abs(info[key] - spec[key]) <= 1e-8 * abs(spec[key]),
                f"{name}: {key} {info[key]!r}, oracle {spec[key]!r} (1e-8)")
    record(name, counts, first_s, cli=" ".join(spec["argv"]), steps=info["steps"],
           nu_top=info["nu_top"], nu_bottom=info["nu_bottom"], vrms=info["vrms"],
           rate=info["rate"])
    return out


# Phase 15: curved domains in float64, gated on CURVED_ORACLE, the JAX
# package's CPU numbers (``python3 stokes_oracle.py curved``).  Counts are
# held within max(3, 10%) of the oracle's, errors within 2x.  15a:
# PoissonModel(method="kernel") on the 64^3 grid with tensor-product axis
# maps (tanh_cluster beta 1.5 on [0, 2], kte 0.9 and affine on [0, 1]),
# fastdiag to rtol 1e-10; multigrid there is refused by both packages (the
# 4-node level's restricted tanh map is not monotone), so mg runs with beta
# 1.4; K1 launched, both K2 passes never.  15b: the poisson CLI with
# -map.  15c: the elliptic CLI with -map (README:69 and the 32^3 mg3
# line), EllipticModel.solve_refined at 16^2 (float32 inner solves) to rel
# 1e-10, FASSolver at 25^2 to rtol 1e-8.  15d: the stokes CLI (README:68
# without -output_vtk; the 3-D bump with its interior divergence under
# the JAX test's 1e-5; the 3-D power law), bench.py's bench_stokes_curved
# trio with the 8 -> 14 error decay, the 20^2 parity pair (annulus total
# <= 1.3 x flat + 1), -pcvel nodal and q1fem at 14^2.  15e: the
# curved-Neumann cell through the CLI in float64, then the same problem
# through solve_refined_fused (float32 inner solves): error <= 1e-5 and
# within 2x of the float64 run's.  15f: the heat CLI with -map.  15g:
# UnsteadyStokes on bump:0.05 at 20^2, 5 CN steps: per-step counts, the
# error, the end state's divergence under 1e-5.
CURVED_ORACLE = {
    "15a fastdiag": dict(beta=1.5, pc="fastdiag", iters=29, error=3.29820615263543e-11),
    "15a mg": dict(beta=1.4, pc="mg", iters=37, error=3.224960090641993e-10),
    "15b poisson bump 32^3": dict(argv=["poisson", "-m", "32", "-n", "32", "-p", "32", "-map",
                                        "bump:0.08", "-ksp_rtol", "1e-10"],
                                  iters=17, error=4.147116e-11),
    "15b poisson annulus 32^2": dict(argv=["poisson", "-m", "32", "-n", "32", "-map",
                                           "annulus:1:2", "-ksp_rtol", "1e-10"],
                                     iters=18, error=2.444878e-11),
    "15c elliptic README:69": dict(argv=["elliptic", "-dim", "16,16", "-exact", "0", "-gamma",
                                         "1", "-map", "bump:0.08", "-debug", "1"],
                                   newton=5, krylov=[10, 10, 10, 10, 10],
                                   reason="CONVERGED_RTOL", error=1.848473e-05),
    "15c elliptic 32^3 mg3": dict(argv=["elliptic", "-dim", "32,32,32", "-gamma", "1",
                                        "-pc_type", "mg3", "-map", "bump:0.08", "-debug", "1"],
                                  newton=5, krylov=[11, 10, 10, 9, 9], reason="CONVERGED_RTOL",
                                  error=8.46419e-11),
    # the float32 Newton stalls at the float32 floor in both packages
    # (DIVERGED_LINE_SEARCH after 17 steps in the JAX package, x64 off): its
    # count is recorded, not gated; one refine step of 9 inner iterations
    "15c refined": dict(newton32=17, refine_steps=1, refine_inner=9,
                        rel_residual=2.129398866733665e-11, error=1.8484729354617535e-05),
    "15c fas": dict(cycles=18, error=1.8828828052264157e-08),
    "15d stokes README:68": dict(argv=["stokes", "-exact", "1", "-dim", "16,16", "-map",
                                       "annulus:1:2"],
                                 newton=[2, 1], krylov=[[1, 2], [2]], error=9.928272e-10),
    "15d stokes 3d": dict(argv=["stokes", "-exact", "1", "-dim", "14,14,14", "-map",
                                "bump:0.06"],
                          newton=[2, 1], krylov=[[1, 2], [2]], error=0.0008260673,
                          divergence=1.8564568086358869e-06),
    "15d stokes powerlaw 3d": dict(argv=["stokes", "-exact", "0", "-boundary", "3",
                                         "-rheology", "1", "-exponent", "3", "-eps", "1e-3",
                                         "-cont", "2", "-dim", "10,10,10", "-map", "bump:0.05"],
                                   newton=[2, 5, 4], krylov=[[1, 2], [2, 1, 1, 1, 1], [2, 1, 1, 1]],
                                   error=6.547426),
    "15d bench annulus 8": dict(n=8, map="annulus:1:2", bench=True, krylov=12,
                                error=0.001893565857368884),
    "15d bench annulus 14": dict(n=14, map="annulus:1:2", bench=True, krylov=14,
                                 error=5.5505740448325014e-08),
    "15d bench flat 14": dict(n=14, map=None, bench=True, krylov=14,
                              error=1.3519470447309612e-07),
    "15d parity annulus 20": dict(n=20, map="annulus:1:2", krylov=15,
                                  error=4.63514052029268e-07),
    "15d parity flat 20": dict(n=20, map=None, krylov=14, error=9.532784459032051e-08),
    "15d nodal 14": dict(n=14, map="bump:0.08", pcvel="nodal", krylov=15,
                         error=0.0019300491057475527),
    "15d q1fem 14": dict(n=14, map="bump:0.08", pcvel="q1fem", krylov=30,
                         error=0.0019300130983110897),
    "15e neumann": dict(argv=["stokes", "-exact", "1", "-boundary", "1", "-tbc", "1",
                              "-traction_p", "1", "-dim", "20,20", "-map", "bump:0.06",
                              "-ksp_type", "fgmres", "-ksp_rtol", "1e-10"],
                        newton=[1, 1], krylov=[[3], [3]], error=3.67588e-06),
    "15e fused": dict(refine_steps=2, refine_inner=4, error=3.739108642264455e-06),
    "15f heat README:70": dict(argv=["heat", "-dim", "18,18", "-dt", "0.5", "-theta", "1",
                                     "-nsteps", "30", "-map", "bump:0.08"], error=6.211846e-10),
    "15f heat 24^3": dict(argv=["heat", "-dim", "24,24,24", "-theta", "0.5", "-nsteps", "10",
                                "-map", "bump:0.08"], error=0.7024017),
    "15g ustokes": dict(per_step=[14, 14, 14, 14, 14], error=7.326903775639604e-07,
                        divergence=8.970676276367682e-07),
}


@contextlib.contextmanager
def captured_selves(owner, name: str):
    """(self, return value) of every call of ``owner.name`` made inside the
    block, in a list."""
    got, orig = [], getattr(owner, name)

    def wrapped(self, *a, **kw):
        got.append((self, orig(self, *a, **kw)))
        return got[-1][1]

    setattr(owner, name, wrapped)
    try:
        yield got
    finally:
        setattr(owner, name, orig)


def _err_ok(name: str, err: float, ref: float) -> None:
    require(math.isfinite(err) and err <= 2 * ref, f"{name}: error {err:.6e} > 2 x {ref:.6e}")


def _counts_ok(name: str, got, ref) -> None:
    """Nested lists of counts, each within max(3, 10%) of the oracle's."""
    if isinstance(ref, list):
        require(isinstance(got, list) and len(got) == len(ref),
                f"{name}: counts {got}, oracle {ref}")
        for g, r in zip(got, ref):
            _counts_ok(name, g, r)
        return
    require(_within(int(got), ref, ref), f"{name}: count {got}, oracle {ref} (max(3, 10%))")


def parse_stokes(out: str) -> dict:
    """The stokes CLI's error and its continuation counts."""
    me = re.search(r"Norm of error\s*: abs = (\S+)", out)
    mc = re.search(r"Continuation steps: Newton (\[[\d, ]*\])  Krylov (\[.*\])", out)
    require(me and mc, f"stokes output not parsed: {out[-2000:]!r}")
    return {"error": float(me.group(1)), "newton": json.loads(mc.group(1)),
            "krylov": json.loads(mc.group(2))}


def phase15(cli_main, path, k1_shapes) -> dict:
    """Phase 15 (see above): every path counted, K1 required on each and
    every (shape, dtype) it took held bit for bit in phase 1
    (K1_CURVED_SHAPES); a first and, below ~2 s, a warm call."""
    import numpy as np
    import torch

    from spectral_tpu_torch.grid import Grid
    from spectral_tpu_torch.models.elliptic import EllipticModel
    from spectral_tpu_torch.models.poisson import PoissonModel
    from spectral_tpu_torch.models.stokes import StokesConfig, StokesProblem
    from spectral_tpu_torch.models.stokes_unsteady import UnsteadyStokes
    from spectral_tpu_torch.ops.curvilinear import named_map
    from spectral_tpu_torch.ops.mapping import AxisMap
    from spectral_tpu_torch.ops.multigrid import Multigrid
    from spectral_tpu_torch.solvers.fas import FASSolver
    from spectral_tpu_torch.solvers.krylov import KSPConfig
    from spectral_tpu_torch.solvers.newton import NewtonConfig

    K1 = "chebdiff_last_kernel"
    K2 = ("laplacian3d_plane_kernel", "laplacian3d_x_kernel")
    dev = torch.device("cuda")
    spec_of = CURVED_ORACLE
    out = {}
    held = {f"{s} {dt}" for s in K1_CURVED_SHAPES + K1_PATH_SHAPES for dt in ("float32", "float64")}
    unheld = set()

    def record(name, counts, first_s, warm_s=None, **rec):
        seen = k1_shapes[name]
        unheld.update(set(seen) - held)
        out[name] = {**rec, "first_s": first_s, "warm_s": warm_s, "k1_launches": counts[K1],
                     "k1_launches_by_shape": seen}

    def cli(name, warm):
        spec = spec_of[name]
        ((rc, text), first_s, warm_s), counts = path(
            name, lambda: timed_twice(lambda: run_cli(cli_main, spec["argv"]), warm_reps=warm),
            [K1])
        require(rc == 0, f"{name} failed (rc {rc}): {text[-3000:]!r}")
        return text, counts, first_s, warm_s

    # 15a: the tensor-product axis maps at 64^3
    n = 64
    for name in ("15a fastdiag", "15a mg"):
        spec = spec_of[name]
        maps = (AxisMap.tanh_cluster(0.0, 2.0, n, spec["beta"]), AxisMap.kte(0.0, 1.0, n, 0.9),
                AxisMap.affine(0.0, 1.0, n))
        model = PoissonModel(Grid((n, n, n), maps=maps, device=dev), method="kernel")
        u, f = model.exact_solution()
        b = model.rhs(u, f)
        ksp = KSPConfig(type="gmres", rtol=1e-10, max_it=200)
        (res, first_s, warm_s), counts = path(
            name, lambda: timed_twice(lambda: model.solve(b, ksp=ksp, pc_type=spec["pc"]),
                                      warm_reps=1), [K1])
        require(all(counts[k] == 0 for k in K2), f"{name}: K2 launched on a mapped grid")
        err = float(torch.max(torch.abs(res.x - u)))
        require(res.reason > 0, f"{name}: reason {res.reason}")
        _counts_ok(name, res.iters, spec["iters"])
        _err_ok(name, err, spec["error"])
        record(name, counts, first_s, warm_s, beta=spec["beta"], iterations=res.iters,
               error=err, k2_launches=[counts[k] for k in K2])
    try:   # multigrid on beta 1.5: refused, as in the JAX package
        Multigrid.build(Grid((n, n, n), maps=(
            AxisMap.tanh_cluster(0.0, 2.0, n, 1.5), AxisMap.kte(0.0, 1.0, n, 0.9),
            AxisMap.affine(0.0, 1.0, n)), device=dev))
        require(False, "15a: multigrid on tanh beta 1.5 built; the JAX package refuses it")
    except ValueError as e:
        require("monotone" in str(e), f"15a: {e}")
        out["15a mg beta 1.5"] = {"refused": str(e)}
    del model, u, f, b, res
    torch.cuda.empty_cache()
    # 15b: the poisson CLI with -map
    for name in ("15b poisson bump 32^3", "15b poisson annulus 32^2"):
        spec = spec_of[name]
        text, counts, first_s, warm_s = cli(name, 1)
        m = re.search(r"Norm of error (\S+) iterations (\d+)", text)
        require(m is not None, f"{name}: output not parsed: {text[-2000:]!r}")
        err, iters = float(m.group(1)), int(m.group(2))
        _counts_ok(name, iters, spec["iters"])
        _err_ok(name, err, spec["error"])
        record(name, counts, first_s, warm_s, cli=" ".join(spec["argv"]), iterations=iters,
               error=err)
    # 15c: the elliptic CLI with -map, solve_refined, FAS
    for name in ("15c elliptic README:69", "15c elliptic 32^3 mg3"):
        spec = spec_of[name]
        text, counts, first_s, warm_s = cli(name, 1 if "69" in name else 0)
        got = parse_elliptic(text)
        require(got["reason"] == spec["reason"], f"{name}: reason {got['reason']}")
        _counts_ok(name, got["newton"], spec["newton"])
        _counts_ok(name, got["krylov"], spec["krylov"])
        _err_ok(name, got["error"], spec["error"])
        record(name, counts, first_s, warm_s, cli=" ".join(spec["argv"]), **got)
    name = "15c refined"
    spec = spec_of[name]
    em = EllipticModel(Grid((16, 16), device=dev), gamma=1.0, exponent=2.0,
                       phi=named_map("bump:0.08"))
    u, b, dr = em.setup_problem_np(exact=0)
    ((x, info), first_s, warm_s), counts = path(
        name, lambda: timed_twice(lambda: em.solve_refined(b, dr, rtol=1e-10, pc_type="mg"),
                                  warm_reps=1), [K1])
    err = float(np.max(np.abs(x - u)))
    require(info["rel_residual"] <= 1e-10, f"{name}: rel residual {info['rel_residual']:.3e}")
    _counts_ok(name, info["refine_steps"], spec["refine_steps"])
    _counts_ok(name, info["refine_inner_iters"], spec["refine_inner"])
    _err_ok(name, err, spec["error"])
    require(any(k.endswith("float32") for k in k1_shapes[name]),
            f"{name}: K1 took no float32 inner solve")
    record(name, counts, first_s, warm_s, newton32=int(info["newton32"].iters),
           newton32_reason=info["newton32"].reason_str(), refine_steps=info["refine_steps"],
           refine_history=info["refine_history"], refine_inner=info["refine_inner_iters"],
           rel_residual=info["rel_residual"], error=err)
    name = "15c fas"
    spec = spec_of[name]

    def factory(dims):
        return EllipticModel(Grid(dims, device=dev), gamma=1.0, exponent=2.0,
                             phi=named_map("bump:0.08"))

    fm = factory((25, 25))
    u, b, d = fm.setup_problem(exact=0, cos_scale=1.0)
    (r, first_s, _), counts = path(name, lambda: timed_twice(
        lambda: FASSolver(factory, (25, 25), b, d).solve(rtol=1e-8, max_cycles=60),
        warm_reps=0), [K1])
    err = float(torch.max(torch.abs(r.x - u)))
    require(r.reason > 0, f"{name}: reason {r.reason}")
    _counts_ok(name, r.iters, spec["cycles"])
    _err_ok(name, err, spec["error"])
    record(name, counts, first_s, cycles=r.iters, error=err)
    # 15d: the stokes CLI with -map (the divergence of the problem's own
    # solution), the bench trio, the parity pair, the nodal and q1fem PCs
    for name in ("15d stokes README:68", "15d stokes 3d", "15d stokes powerlaw 3d"):
        spec = spec_of[name]
        with captured_selves(StokesProblem, "solve_continuation") as runs:
            text, counts, first_s, warm_s = cli(name, 0)
        got = parse_stokes(text)
        _counts_ok(name, got["newton"], spec["newton"])
        _counts_ok(name, got["krylov"], spec["krylov"])
        _err_ok(name, got["error"], spec["error"])
        p, results = runs[-1]
        div = float(torch.max(torch.abs(p.divergence(results[-1].x["v"], with_dirichlet=True))))
        if "divergence" in spec:
            require(div <= 1e-5, f"{name}: interior divergence {div:.3e} > 1e-5")
        record(name, counts, first_s, warm_s, cli=" ".join(spec["argv"]), **got, divergence=div,
               oracle_divergence=spec.get("divergence"))
        del runs, p, results
    totals = {}
    for name in ("15d bench annulus 8", "15d bench annulus 14", "15d bench flat 14",
                 "15d parity annulus 20", "15d parity flat 20", "15d nodal 14", "15d q1fem 14"):
        spec = spec_of[name]
        kw = dict(pcvel=spec.get("pcvel", "mg"))
        if spec.get("bench"):
            kw["newton"] = NewtonConfig(rtol=1e-4, max_it=25)
        p = StokesProblem(Grid((spec["n"], spec["n"]), device=dev), StokesConfig(exact=1, **kw),
                          phi=named_map(spec["map"]) if spec["map"] else None)
        (r, first_s, warm_s), counts = path(name, lambda: timed_twice(p.solve, warm_reps=1),
                                            [K1])
        err = float(p.error_vs_exact(r.x))
        total = int(sum(int(k) for k in r.ksp_iters))
        require(r.reason > 0, f"{name}: reason {r.reason}")
        _counts_ok(name, total, spec["krylov"])
        _err_ok(name, err, spec["error"])
        totals[name] = total
        record(name, counts, first_s, warm_s, newton=int(r.iters), krylov=total, error=err)
    decay = out["15d bench annulus 8"]["error"] / out["15d bench annulus 14"]["error"]
    out["15d bench decay 8 -> 14"] = decay
    a, f = totals["15d parity annulus 20"], totals["15d parity flat 20"]
    require(a <= 1.3 * f + 1, f"15d parity: annulus {a} > 1.3 x flat {f} + 1")
    # 15e: the curved-Neumann cell in float64, then solve_refined_fused
    name = "15e neumann"
    spec = spec_of[name]
    with captured_selves(StokesProblem, "solve_continuation") as runs:
        text, counts, first_s, warm_s = cli(name, 0)
    got = parse_stokes(text)
    _counts_ok(name, got["newton"], spec["newton"])
    _counts_ok(name, got["krylov"], spec["krylov"])
    _err_ok(name, got["error"], spec["error"])
    record(name, counts, first_s, cli=" ".join(spec["argv"]), **got)
    err64 = got["error"]
    p = runs[-1][0]
    del runs
    name = "15e fused"
    spec = spec_of[name]
    ((x, info), first_s, _), counts = path(
        name, lambda: timed_twice(lambda: p.solve_refined_fused(rtol=1e-10), warm_reps=0), [K1])
    err = float(p.error_vs_exact(x))
    require(err <= 1e-5, f"{name}: float32-inner error {err:.3e} > 1e-5")
    require(err <= 2 * err64, f"{name}: error {err:.3e} > 2 x the float64 run's {err64:.3e}")
    _err_ok(name, err, spec["error"])
    require(any(k.endswith("float32") for k in k1_shapes[name]),
            f"{name}: K1 took no float32 inner solve")
    record(name, counts, first_s, refine_steps=info["refine_steps"],
           refine_history=info["refine_history"], refine_inner=info["refine_inner_iters"],
           rel_residual=info["rel_residual"], error=err, error_float64_run=err64)
    del p, x
    # 15f: the heat CLI with -map
    for name in ("15f heat README:70", "15f heat 24^3"):
        spec = spec_of[name]
        text, counts, first_s, warm_s = cli(name, 0)
        m = re.search(r"Norm of error vs analytic decay (\S+)", text)
        require(m is not None, f"{name}: output not parsed: {text[-2000:]!r}")
        err = float(m.group(1))
        _err_ok(name, err, spec["error"])
        record(name, counts, first_s, cli=" ".join(spec["argv"]), error=err)
    # 15g: unsteady Stokes on a curved domain
    name = "15g ustokes"
    spec = spec_of[name]
    cfg = StokesConfig(exact=1, boundary=0, pcvel="mg",
                       outer_ksp=KSPConfig(type="fgmres", rtol=1e-9, max_it=400, restart=100))
    m = UnsteadyStokes(Grid((20, 20), device=dev), cfg, dt=0.05, theta=0.5,
                       phi=named_map("bump:0.05"))
    u0, s, f, u_t, _ = m.manufactured(omega=1.0)
    times = np.arange(6) * 0.05
    ((v, _, its), first_s, _), counts = path(
        name, lambda: timed_twice(lambda: m.rollout(u0, times, s, f), warm_reps=0), [K1])
    per_step = [int(i) for i in its]
    err = float(torch.max(torch.abs(v - u_t(times[-1]))))
    div = float(torch.max(torch.abs(m._div_full(v))))
    _counts_ok(name, per_step, spec["per_step"])
    _err_ok(name, err, spec["error"])
    require(div <= 1e-5, f"{name}: divergence {div:.3e} > 1e-5")
    record(name, counts, first_s, per_step=per_step, error=err, divergence=div,
           oracle_divergence=spec["divergence"])
    require(not unheld, f"phase 15: K1 launched on {sorted(unheld)}, which phase 1 does not "
                        "hold (add them to K1_CURVED_SHAPES)")
    return out


# phase 16: the JAX package's Newton counts of the families (stokes_oracle.py
# family, CPU oracle): bench.py's stokes_family8 at 16^2 and the curved family
FAMILY_ORACLE = {"family8": [1, 5, 8, 9, 12, 11, 18, 17], "curved10": [7, 18, 10]}
# 3 warm repeats: the speed-up is reported as a spread (median, min, max)
FAMILY_REPEATS = 3


def _phase16e_rank(rank: int, store: str, queue) -> None:
    """One of phase 16e's two processes: a gloo mesh {"x": 2} over one card,
    each process holding its slab of axis 0.  The unsharded references run
    first, uncounted; then the sharded runs, with the launch counts set to
    0 before them and read after (the parent adds them to the path's); then
    the timings.  Puts (rank, record) on ``queue``."""
    import traceback

    import torch
    import torch.distributed as dist

    try:
        dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank,
                                world_size=2)
        from spectral_tpu_torch.grid import Grid
        from spectral_tpu_torch.models.elliptic import EllipticModel
        from spectral_tpu_torch.models.poisson import PoissonModel
        from spectral_tpu_torch.models.stokes import StokesConfig, StokesProblem
        from spectral_tpu_torch.ops import cuda_cheb
        from spectral_tpu_torch.ops.chebyshev import chebdiff
        from spectral_tpu_torch.ops.stencil import shift
        from spectral_tpu_torch.parallel import (chebdiff_pencil, gather_tensor, halo_shift,
                                                 make_mesh, shard_tensor)
        from spectral_tpu_torch.solvers.krylov import KSPConfig

        dev = torch.device("cuda")
        f64 = torch.float64
        mesh = make_mesh({"x": 2})
        amap = {0: "x"}
        sh = lambda t: shard_tensor(t, mesh, amap)   # noqa: E731
        ga = lambda t: gather_tensor(t, mesh, amap)   # noqa: E731
        u = torch.randn((64, 64, 64), generator=torch.Generator(device=dev).manual_seed(16),
                        device=dev, dtype=f64)
        ksp = KSPConfig(type="gmres", rtol=1e-10, max_it=200)
        g64 = Grid((64, 64, 64), device=dev, dtype=f64)
        p_one = PoissonModel(g64)
        p_sh = PoissonModel(g64, method="kernel", mesh=mesh)   # K2 guarded off the slabs
        ue, fe = p_one.exact_solution()
        b = p_one.rhs(ue, fe)
        g2 = Grid((16, 12), device=dev, dtype=f64)
        e_one, e_sh = EllipticModel(g2, gamma=1.0), EllipticModel(g2, gamma=1.0, mesh=mesh)
        eu, eb, ed = e_one.setup_problem(exact=0)
        s_one = StokesProblem(g2, StokesConfig(exact=2))
        s_sh = StokesProblem(g2, StokesConfig(exact=2), mesh=mesh)
        sx = s_one.exact_state()
        sxl = {k: sh(v) for k, v in sx.items()}
        # references, one process, uncounted
        ref_dif = {ax: chebdiff(u, ax) for ax in (0, 2)}
        ref_shift = {s: shift(u, 0, s) for s in (-1, 1)}
        ref_solve = p_one.solve(b, ksp=ksp)
        eF, elin = e_one.make_residual(eb, ed)(eu)
        eJ = e_one.jacobian_action(eu, elin, eu)
        sF, slin = s_one.make_residual(s_one.params_at(1))(sx)
        sJ = s_one.jacobian_action(sx, slin, sx)
        torch.cuda.synchronize()
        dist.barrier()
        # the sharded runs, counted
        cuda_cheb.reset_launch_counts()
        ul = sh(u)
        got_dif = {ax: chebdiff_pencil(ul, ax, mesh) for ax in (0, 2)}
        got_shift = {s: halo_shift(ul, 0, s, mesh) for s in (-1, 1)}
        res = p_sh.solve(p_sh.local(b), ksp=ksp)
        eFs, elins = e_sh.make_residual(sh(eb), sh(ed))(sh(eu))
        eJs = e_sh.jacobian_action(sh(eu), elins, sh(eu))
        sFs, slins = s_sh.make_residual(s_sh.params_at(1))(sxl)
        sJs = s_sh.jacobian_action(sxl, slins, sxl)
        torch.cuda.synchronize()
        launches = dict(cuda_cheb.LAUNCHES)
        by_shape = {f"{tuple(sp)} {str(dt)[6:]}": c
                    for (sp, dt), c in cuda_cheb.K1_LAUNCHES_BY_SHAPE.items()}

        def err(a, ref):
            return float(torch.max(torch.abs(ga(a) - ref)))

        def rel(a, ref):
            return err(a, ref) / float(torch.max(torch.abs(ref)))

        rec = {"comm_path": mesh.comm_path, "launches": launches, "k1_launches_by_shape": by_shape,
               "pencil_rel_err": {f"axis {ax}": rel(got_dif[ax], ref_dif[ax]) for ax in (0, 2)},
               "halo_err": {f"shift {s}": err(got_shift[s], ref_shift[s]) for s in (-1, 1)},
               "poisson_iters": res.iters, "poisson_iters_one_process": ref_solve.iters,
               "poisson_reason": res.reason, "poisson_x_err": err(res.x, ref_solve.x),
               "elliptic_F_err": err(eFs, eF), "elliptic_J_err": err(eJs, eJ),
               "stokes_F_err": max(err(sFs[k], sF[k]) for k in ("v", "p")),
               "stokes_J_err": max(err(sJs[k], sJ[k]) for k in ("v", "p"))}

        def per_call(fn, reps):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / reps

        bl = p_sh.local(b)
        rec["times_s"] = {
            "pencil_axis0_sharded": per_call(lambda: chebdiff_pencil(ul, 0, mesh), 20),
            "pencil_axis0_one_process": per_call(lambda: chebdiff(u, 0), 20),
            "poisson_apply_sharded": per_call(lambda: p_sh.operator(bl), 20),
            "poisson_apply_one_process": per_call(lambda: p_one.operator(b), 20),
            "poisson_solve_sharded": per_call(lambda: p_sh.solve(bl, ksp=ksp), 3),
            "poisson_solve_one_process": per_call(lambda: p_one.solve(b, ksp=ksp), 3)}
        queue.put((rank, rec))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))
        raise


def phase16(path, k1_shapes, launches, parts=PARTS16) -> dict:
    """Phase 16 (see above), the runs in ``parts`` ("16a"..."16e"): every
    family path counted, K1 required on each; every K1 (shape, dtype) it
    takes, 16e's processes included, held in phase 1."""
    import os
    import tempfile

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from spectral_tpu_torch.grid import Grid
    from spectral_tpu_torch.models.poisson import PoissonModel
    from spectral_tpu_torch.models.rheology import PowerLawParams
    from spectral_tpu_torch.models.stokes import StokesConfig, StokesProblem
    from spectral_tpu_torch.models.stokes_unsteady import UnsteadyStokes
    from spectral_tpu_torch.ops.curvilinear import named_map
    from spectral_tpu_torch.solvers.krylov import KSPConfig, block_gmres
    from spectral_tpu_torch.solvers.newton import NewtonConfig

    K1 = "chebdiff_last_kernel"
    K2 = ("laplacian3d_plane_kernel", "laplacian3d_x_kernel")
    dev = torch.device("cuda")
    f64 = torch.float64
    out = {}
    t_part = [time.perf_counter()]

    def vdiff(a, b):
        return float(torch.max(torch.abs(a - b)))

    def done(name, rec):   # each run's line as it ends, with its seconds
        now = time.perf_counter()
        out[name] = {**rec, "seconds": now - t_part[0]}
        t_part[0] = now
        print("phase16 " + json.dumps({name: out[name]}), flush=True)

    if "16a" in parts:
        # bench.py's stokes_family8: a short warm-up (one Newton step of two
        # members), then FAMILY_REPEATS warm repeats of the family and the 8
        # sequential solves; the first repeat is the counted path and gated
        name = "16a family8"
        cfg = StokesConfig(exact=2, rheology=1, newton=NewtonConfig(rtol=1e-4, max_it=25))
        grid = Grid((16, 16), device=dev, dtype=f64)
        fam = [PowerLawParams(1.0, 1.0 + 0.25 * i, 1e-2, 1.0) for i in range(8)]
        warm = StokesProblem(grid, dataclasses.replace(cfg, newton=NewtonConfig(max_it=1)))
        warm.solve_family(fam[6:])
        warm.solve(params=fam[7])
        p = StokesProblem(grid, cfg)
        (res, t_fam), counts = path(name, lambda: timed_once(lambda: p.solve_family(fam)), [K1])
        iters = [int(i) for i in res.iters]
        require(bool((res.reason > 0).all()), f"{name}: reasons {res.reason.tolist()}")
        require(iters == FAMILY_ORACLE["family8"],
                f"{name}: Newton {iters}, JAX family {FAMILY_ORACLE['family8']}")
        def sequential():   # (results, warm seconds) of the 8 solves
            runs = [timed_once(lambda f=f: p.solve(params=f)) for f in fam]
            return [r for r, _ in runs], [t for _, t in runs]

        (seq, ts), _ = path(name + " sequential", sequential, [K1])
        dv = [vdiff(res.x["v"][b], seq[b].x["v"]) for b in range(8)]
        require([r.iters for r in seq] == iters,
                f"{name}: sequential Newton {[r.iters for r in seq]}")
        require(max(dv) <= 1e-10, f"{name}: members off their sequential solves by {dv}")
        repeats = []
        for rep in range(FAMILY_REPEATS):
            if rep:
                t_fam = timed_once(lambda: p.solve_family(fam))[1]
                ts = [timed_once(lambda f=f: p.solve(params=f))[1] for f in fam]
            repeats.append({"family_s": t_fam, "member7_s": ts[7], "sum8_s": sum(ts),
                            "speedup_vs_8x_member7": 8 * ts[7] / t_fam,
                            "speedup_vs_sum8": sum(ts) / t_fam})

        def spread(key):
            v = [r[key] for r in repeats]
            return {"median": statistics.median(v), "min": min(v), "max": max(v)}

        done(name, {"newton": iters, "oracle": FAMILY_ORACLE["family8"],
                    "krylov": res.ksp_iters.T.tolist(), "v_vs_sequential": dv,
                    "repeats": repeats,
                    "speedup_vs_8x_member7": spread("speedup_vs_8x_member7"),
                    "speedup_vs_sum8": spread("speedup_vs_sum8"),
                    "k1_launches": counts[K1], "k1_launches_by_shape": k1_shapes[name],
                    "sequential_k1_launches_by_shape": k1_shapes[name + " sequential"]})
        del p, res, seq

    if "16b" in parts:
        # 16b: the curved family
        name = "16b curved family"
        cfg = StokesConfig(exact=0, boundary=3, rheology=1, regularization=1e-3, pcvel="mg",
                           newton=NewtonConfig(rtol=1e-8, max_it=40))
        p = StokesProblem(Grid((10, 10), device=dev, dtype=f64), cfg,
                          phi=named_map("annulus:1:2"))
        params = [PowerLawParams(1.0, e, 1e-3, 1.0) for e in (1.5, 2.0, 2.5)]
        (res, first_s), counts = path(name, lambda: timed_once(lambda: p.solve_family(params)),
                                      [K1])
        iters = [int(i) for i in res.iters]
        require(bool((res.reason > 0).all()) and iters == FAMILY_ORACLE["curved10"],
                f"{name}: Newton {iters} {res.reason.tolist()}, "
                f"JAX family {FAMILY_ORACLE['curved10']}")
        (seq, seq_s), _ = path(name + " sequential",
                               lambda: timed_once(lambda: p.solve(params=params[1])), [K1])
        d1 = max(vdiff(res.x[k][1], seq.x[k]) for k in ("v", "p"))
        require(seq.iters == iters[1] and d1 <= 1e-10,
                f"{name}: member 1 {seq.iters} Newton, {d1:.3e} off its sequential solve")
        done(name, {"newton": iters, "oracle": FAMILY_ORACLE["curved10"],
                    "member1_vs_sequential": d1, "first_s": first_s,
                    "sequential_member1_s": seq_s, "k1_launches": counts[K1],
                    "k1_launches_by_shape": k1_shapes[name]})
        del p, res, seq

    if "16c" in parts:
        # 16c: family_rollout, 4 manufactured members at 11b's 20^3 CN configuration
        name = "16c family_rollout"
        cfg = StokesConfig(exact=1, boundary=0, pcvel="fastdiag",
                           outer_ksp=KSPConfig(type="fgmres", rtol=1e-9, max_it=400, restart=100))
        m = UnsteadyStokes(Grid((20, 20, 20), device=dev, dtype=f64), cfg, dt=0.05, theta=0.5)
        times = np.arange(11) * 0.05
        omegas = (0.5, 1.0, 2.0, 4.0)
        v0s, sss, fbs, exact = [], [], [], []
        for om in omegas:
            u0, sf, ff, uf, _ = m.manufactured(omega=om)
            v0s.append(u0)
            sss.append(torch.tensor([sf(t) for t in times[1:]], dtype=f64))
            fbs.append(torch.stack([m.theta * ff(t1) + (1 - m.theta) * ff(t0)
                                    for t0, t1 in zip(times[:-1], times[1:])]))
            exact.append(uf(times[-1]))
        ((vs, ps, its), first_s), counts = path(name, lambda: timed_once(lambda: m.family_rollout(
            torch.stack(v0s), torch.stack(sss), torch.stack(fbs))), [K1])
        (seq, seq_s), _ = path(name + " members", lambda: timed_once(
            lambda: [m.rollout_scan(v0s[b], sss[b], fbs[b]) for b in range(4)]), [K1])
        # the same rollouts from starts moved by 1e-14: how far round-off alone
        # moves a member at this tolerance (ROADMAP queue 3)
        gen = torch.Generator(device=dev).manual_seed(161)
        pert = [m.rollout_scan(v0s[b] + m.problem.mask_v(1e-14 * torch.randn(
            v0s[b].shape, generator=gen, device=dev, dtype=f64)), sss[b], fbs[b]) for b in range(4)]
        per_member, own = its.tolist(), [r[2].tolist() for r in seq]
        moved = [r[2].tolist() for r in pert]
        dv = [vdiff(vs[b], seq[b][0]) for b in range(4)]
        dv_pert = [vdiff(pert[b][0], seq[b][0]) for b in range(4)]
        dp = [vdiff(ps[b], seq[b][1]) for b in range(4)]
        dp_pert = [vdiff(pert[b][1], seq[b][1]) for b in range(4)]
        # a step's count moves by one under the perturbation, and so does the
        # family's; v and p within 4x the perturbation's largest move
        steps = [abs(a - b) for fm, om_ in zip(per_member, own) for a, b in zip(fm, om_)]
        require(max(steps) <= 1, f"{name}: counts {per_member}, members' own {own}")
        require(max(dv) <= 4 * max(dv_pert) + 1e-12,
                f"{name}: v off the members' own rollouts by {dv}, perturbed starts by {dv_pert}")
        require(max(dp) <= 4 * max(dp_pert) + 1e-12,
                f"{name}: p off the members' own rollouts by {dp}, perturbed starts by {dp_pert}")
        done(name, {"iters": per_member, "members_own_iters": own, "perturbed_iters": moved,
                    "v_vs_members": dv, "perturbed_v_vs_members": dv_pert,
                    "p_vs_members": dp, "perturbed_p_vs_members": dp_pert,
                    "error": [vdiff(vs[b], exact[b]) for b in range(4)],
                    "members_own_error": [vdiff(seq[b][0], exact[b]) for b in range(4)],
                    "first_s": first_s, "members_sequential_s": seq_s, "k1_launches": counts[K1],
                    "k1_launches_by_shape": k1_shapes[name]})
        del m, vs, ps, seq, pert, v0s, fbs

    if "16d" in parts:
        # 16d: solve_batched and block_gmres on phase 3's 64^3 Poisson operator
        g = Grid((64, 64, 64), device=dev, dtype=f64)
        model = PoissonModel(g)
        M = model.build_pc("fastdiag")
        ksp = KSPConfig(type="gmres", rtol=1e-10, max_it=200)
        Bm = torch.randn((8, 64, 64, 64), generator=torch.Generator(device=dev).manual_seed(160),
                         device=dev, dtype=f64)
        name = "16d solve_batched"
        (rb, t_b), counts = path(name, lambda: timed_once(
            lambda: ksp.solve_batched(model.operator, Bm, M=M)), [K1])
        (singles, t_s), _ = path("16d single solves", lambda: timed_once(
            lambda: [ksp.solve(model.operator, Bm[i], M=M) for i in range(8)]), [K1])
        require(rb.iters.tolist() == [r.iters for r in singles] and bool((rb.reason > 0).all()),
                f"{name}: counts {rb.iters.tolist()}, single {[r.iters for r in singles]}")
        dx = max(vdiff(rb.x[i], singles[i].x) for i in range(8))
        done(name, {"iters": rb.iters.tolist(), "x_vs_single": dx, "batched_s": t_b,
                    "single_sum_s": t_s, "k1_launches": counts[K1],
                    "k1_launches_by_shape": k1_shapes[name]})
        name = "16d block_gmres"
        (rk, t_k), counts = path(name, lambda: timed_once(
            lambda: block_gmres(model.operator, Bm, M=M, rtol=1e-10, max_it=200, restart=30)), [K1])
        R = Bm - torch.stack([model.operator(rk.x[i]) for i in range(8)])
        rel_pc = [float(torch.linalg.vector_norm(M(R[i])) / torch.linalg.vector_norm(M(Bm[i])))
                  for i in range(8)]
        rel = [float(torch.linalg.vector_norm(R[i]) / torch.linalg.vector_norm(Bm[i]))
               for i in range(8)]
        # the gate is the residual the solvers' rtol holds (left-preconditioned,
        # as GMRES's); the unpreconditioned one is recorded beside the single
        # solves' own, which the same rtol leaves at the same level
        rel_single = [float(torch.linalg.vector_norm(Bm[i] - model.operator(singles[i].x))
                            / torch.linalg.vector_norm(Bm[i])) for i in range(8)]
        require(rk.reason > 0 and max(rel_pc) <= 1e-10,
                f"{name}: reason {rk.reason}, true preconditioned residuals {rel_pc}")
        done(name, {"block_steps": rk.iters, "operator_applications": 8 * rk.iters,
                    "single_operator_applications": sum(r.iters for r in singles),
                    "true_rel_residual_preconditioned": rel_pc, "true_rel_residual": rel,
                    "single_true_rel_residual": rel_single,
                    "block_s": t_k, "k1_launches": counts[K1],
                    "k1_launches_by_shape": k1_shapes[name]})
        del model, M, Bm, rb, singles, rk, R

    if "16e" in parts:
        # 16e: two gloo processes sharing the card
        name = "16e two processes"
        ctx = mp.get_context("spawn")
        queue = ctx.Queue()
        recs = {}
        with tempfile.TemporaryDirectory() as tmp:
            procs = [ctx.Process(target=_phase16e_rank, args=(r, os.path.join(tmp, "store"), queue))
                     for r in range(2)]
            try:
                for pr in procs:
                    pr.start()
                for _ in range(2):
                    rank, rec = queue.get(timeout=600)
                    recs[rank] = rec
                for pr in procs:
                    pr.join(timeout=60)
            finally:
                for pr in procs:
                    if pr.is_alive():
                        pr.kill()
                    pr.join()
        for rank, rec in recs.items():
            require("error" not in rec, f"{name}: rank {rank}: {rec.get('error')}")
        for rank in (0, 1):
            rec = recs[rank]
            for k, v in rec["launches"].items():
                launches[k] += v
            k1_shapes[f"16e rank {rank}"] = rec["k1_launches_by_shape"]
            require(rec["launches"][K1] > 0, f"{name}: rank {rank} launched no K1")
            require(all(rec["launches"][k] == 0 for k in K2), f"{name}: K2 launched on a slab")
        r0 = recs[0]
        require(max(r0["pencil_rel_err"].values()) <= 1e-12 and
                max(r0["halo_err"].values()) == 0.0, f"{name}: pencil/halo {r0}")
        require(r0["poisson_iters"] == r0["poisson_iters_one_process"] == 3
                and r0["poisson_x_err"] <= 1e-9, f"{name}: Poisson {r0}")
        require(max(r0[k] for k in ("elliptic_F_err", "elliptic_J_err", "stokes_F_err",
                                    "stokes_J_err")) <= 1e-10, f"{name}: residuals {r0}")
        done(name, {**{k: v for k, v in r0.items() if k not in ("launches",)},
                    "k2_launches": [sum(recs[r]["launches"][k] for k in K2) for r in (0, 1)],
                    "times_s_rank1": recs[1]["times_s"]})

    held = {f"{s} float64" for s in K1_PATH_SHAPES + K1_CURVED_SHAPES + K1_SLAB_SHAPES
            + K1_FAMILY_SHAPES + K1_BATCHED_SHAPES}
    seen = {k for n, by in k1_shapes.items() if n.startswith("16") for k in by}
    require(seen <= held, f"phase 16: K1 launched on {sorted(seen - held)}, which phase 1 "
                          "does not hold (add them to K1_FAMILY_SHAPES or K1_SLAB_SHAPES)")
    return out


def stokes_krylov_range(spec: dict):
    """Per Newton step, and in total, the least and the most Krylov
    iterations among the oracle's run and its perturbed runs."""
    runs = [spec["krylov"], *spec["perturbed"]]
    lo = [list(map(min, zip(*steps))) for steps in zip(*runs)]
    hi = [list(map(max, zip(*steps))) for steps in zip(*runs)]
    totals = [sum(map(sum, r)) for r in runs]
    return (lo, hi), (min(totals), max(totals))


def _within(k: int, lo: int, hi: int) -> bool:
    return lo - max(3, 0.1 * lo) <= k <= hi + max(3, 0.1 * hi)


def stokes_cli_ok(name: str, newton, krylov, err) -> str | None:
    """Why a stokes CLI run misses STOKES_ORACLE[name]'s gates, or None."""
    spec = STOKES_ORACLE[name]
    if newton != spec["newton"]:
        return f"Newton {newton}, oracle {spec['newton']}"
    if name == "README:43":
        if abs(krylov[0][0] - 14) > 3:
            return f"Krylov {krylov}, oracle 14 +- 3"
        if err > 2 * spec["error"]:
            return f"error {err:.6e} > 2 x {spec['error']:.6e}"
        return None
    if [len(k) for k in krylov] != newton:
        return f"Krylov {krylov}: not one count a Newton step"
    (lo, hi), (tot_lo, tot_hi) = stokes_krylov_range(spec)
    for i, (got, a, b) in enumerate(zip(krylov, lo, hi)):
        if any(not _within(k, kl, kh) for k, kl, kh in zip(got, a, b)):
            return (f"Krylov {got} in continuation step {i}, the JAX runs span "
                    f"{a}..{b} (max(3, 10%) beyond)")
    total = sum(map(sum, krylov))
    if not _within(total, tot_lo, tot_hi):
        return f"total Krylov {total}, the JAX runs span {tot_lo}..{tot_hi} (max(3, 10%) beyond)"
    if abs(err - spec["error"]) > 1e-6 * spec["error"]:
        return f"error {err:.6e}, oracle {spec['error']:.6e} (1e-6 relative)"
    return None


def stokes_phase9_ok(name: str, newton, krylov, reasons, err) -> str | None:
    """Why a phase 9a/9b solve misses STOKES_ORACLE[name]'s gates, or None:
    Newton counts and reasons equal, each Krylov count within max(3, 10%)
    of the oracle's (of the range its perturbed runs span, where it has
    them), the error within 2x (within 1e-3 relative where the oracle has
    perturbed runs: boundary 2's error is its distance from a field that
    does not meet its boundary conditions, about 37.6 wherever the solve
    lands, and the JAX package's perturbed runs keep it within 1e-3
    relative), and the JAX test's own bounds where it has them."""
    spec = STOKES_ORACLE[name]
    if newton != spec["newton"] or reasons != spec["reasons"]:
        return f"Newton {newton} {reasons}, oracle {spec['newton']} {spec['reasons']}"
    (lo, hi), _ = stokes_krylov_range({"perturbed": [], **spec})
    if [len(k) for k in krylov] != newton or any(
            not _within(k, a, b) for got, ls, hs in zip(krylov, lo, hi)
            for k, a, b in zip(got, ls, hs)):
        return f"Krylov {krylov}, the JAX runs span {lo}..{hi} (max(3, 10%) beyond)"
    if "perturbed" in spec:
        if not abs(err - spec["error"]) <= 1e-3 * spec["error"]:
            return f"error {err:.10e}, oracle {spec['error']:.10e} (within 1e-3 relative)"
    elif not spec["error"] / 2 <= err <= 2 * spec["error"]:
        return f"error {err:.6e}, oracle {spec['error']:.6e} (within 2x)"
    if max(map(max, krylov)) > spec.get("max_krylov", float("inf")):
        return f"Krylov {krylov} over the JAX test's {spec['max_krylov']}"
    if err >= spec.get("max_error", float("inf")):
        return f"error {err:.6e} over the JAX test's {spec['max_error']:.0e}"
    return None


def stokes_mixed_runs(dev) -> dict:
    """name -> problem for phase 9b: tests/test_stokes.py's mixed and
    Neumann configurations at 16^2 in float64 on ``dev``."""
    from spectral_tpu_torch.grid import Grid
    from spectral_tpu_torch.models.stokes import StokesConfig, StokesProblem
    from spectral_tpu_torch.solvers.krylov import KSPConfig
    from spectral_tpu_torch.solvers.newton import NewtonConfig

    b2 = dict(exact=2, boundary=2, cont0=1,
              outer_ksp=KSPConfig(type="fgmres", rtol=1e-8, max_it=400, restart=100),
              newton=NewtonConfig(rtol=1e-8, max_it=10))
    man = dict(exact=1, traction_p=True, newton=NewtonConfig(rtol=1e-10, max_it=20),
               outer_ksp=KSPConfig(type="fgmres", rtol=1e-12, max_it=800, restart=200))
    cfgs = {"mixed boundary 2": b2,
            "mixed boundary 5": dict(man, boundary=5),
            "mixed boundary 6 tbc": dict(man, boundary=6, tbc=1, outer_ksp=KSPConfig(
                type="fgmres", rtol=1e-12, max_it=400, restart=200)),
            "mixed boundary 2 mg": dict(b2, pcvel="mg")}
    return {name: StokesProblem(Grid((16, 16), device=dev),
                                StokesConfig(**cfg)) for name, cfg in cfgs.items()}


def stokes_line52(dev):
    """README:52 with the line-smoothed eta-aware multigrid velocity PC and
    6-step velocity GMRES at 20^3 in float64 (phase 9c)."""
    from spectral_tpu_torch.grid import Grid
    from spectral_tpu_torch.models.stokes import StokesConfig, StokesProblem
    from spectral_tpu_torch.solvers.krylov import KSPConfig

    cfg = StokesConfig(exact=2, rheology=1, cont=4, regularization=1e-4, exponent=3.0,
                       pcvel="mg", pcvel_smoother="line",
                       vel_ksp=KSPConfig(type="gmres", rtol=1e-5, max_it=6, restart=6))
    return StokesProblem(Grid((20, 20, 20), device=dev), cfg)


def stokes_refined_runs(dev) -> dict:
    """name -> problem for solve_refined in bench.py's bench_stokes20_linear
    and bench_stokes20_powerlaw configurations on ``dev``."""
    from spectral_tpu_torch.grid import Grid
    from spectral_tpu_torch.models.stokes import StokesConfig, StokesProblem
    from spectral_tpu_torch.solvers.krylov import KSPConfig
    from spectral_tpu_torch.solvers.newton import NewtonConfig

    cfgs = {"refined linear": StokesConfig(exact=2, cont0=1),
            "refined powerlaw": StokesConfig(
                exact=2, rheology=1, cont=4, regularization=1e-4, exponent=3.0, pcvel="mg",
                outer_ksp=KSPConfig(type="fgmres", rtol=1e-5, max_it=120, restart=60),
                newton=NewtonConfig(rtol=2e-4, max_it=30, ksp_ew=True))}
    return {name: StokesProblem(Grid((20, 20, 20), device=dev), cfg)
            for name, cfg in cfgs.items()}


def stokes_forward(dev, dtype):
    """graft_entry.entry()'s forward step at 32^3 in ``dtype`` on ``dev``:
    the residual at zero_state() and one Jacobian action on it; returns a
    function of no arguments giving (F, J F)."""
    from spectral_tpu_torch.graft_entry import entry

    forward, (x0,) = entry(device=dev, dtype=dtype)

    def step():
        y = forward(x0)
        return y["F"], y["JF"]

    return step


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def device_ms(fn, calls: int = 20, reps: int = 15) -> float:
    """Median device milliseconds per call: ``calls`` calls captured once
    in a CUDA graph, the graph replayed ``reps`` times between CUDA events.
    The host issues one replay, so its cost per call does not show.  The
    launch counters see the warm-up and the captured calls, not the
    replays: no counted path times."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm up (builds, caches) off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def call_ms(fn, calls: int = 100, reps: int = 11) -> float:
    """Median milliseconds per call on the host's clock over ``calls``
    calls followed by one synchronize: what a caller waits, host and device
    together."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0) / calls)
    return statistics.median(times)


def kernel_ms(fn, calls: int = 20) -> dict:
    """Milliseconds per call of each kernel ``fn`` launches, by kernel
    name, from torch.profiler over ``calls`` calls after a warm-up: the
    kernels' own durations, without the gaps between launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "", e.key):
            e.device_time_total / 1e3 / calls
            for e in prof.key_averages() if e.device_time_total > 0}


def both_ms(fn) -> tuple[float, float]:
    """(device_ms, call_ms) of ``fn``."""
    return device_ms(fn), call_ms(fn)


def timed_twice(run, warm_reps: int = 2):
    """(result, first_s, best_warm_s): the first call pays one-time costs
    (library handles, allocator growth, constant uploads); the best warm
    call is the solve time (None with no warm call)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    best = None
    for _ in range(warm_reps):
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        best = t if best is None else min(best, t)
    return out, first, best


def compare(name, kernel, plain, u, case, timed=True) -> dict:
    import torch

    got = kernel()
    ref = plain()
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got).all()), f"{name} {case}: non-finite output")
    abs_err = float(torch.max(torch.abs(got - ref)))
    rel = abs_err / float(torch.max(torch.abs(ref)))
    dtype = str(u.dtype).replace("torch.", "")
    require(rel <= BOUND[dtype], f"{name} {case}: error {rel:.3e} > {BOUND[dtype]:.0e}")
    out = {"case": case, "dtype": dtype, "rel_err": rel, "max_abs_err": abs_err,
           "bitwise": bool(torch.equal(got, ref))}
    if timed:   # ms, plain_ms: device time; *call_ms: the caller's time a call
        out["ms"], out["call_ms"] = both_ms(kernel)
        out["plain_ms"], out["plain_call_ms"] = both_ms(plain)
    return out


def bound(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes
    over the HBM rate and the operations over the peak rate for dtype."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / PEAK_FLOP_S[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def blocks_per_sm(registers: int, grid: dict) -> int:
    """Blocks an SM holds, computed from a kernel's registers a thread
    (ptxas) and its launch (threads a block, dynamic shared memory): the
    fewest allowed by the 64K registers (a warp takes them in units of 256),
    the 228 KB of shared memory (1 KB reserved a block) and 2048 threads."""
    warps = -(-grid["threads"] // 32)
    warp_regs = -(-registers * 32 // 256) * 256
    return min(65536 // (warps * warp_regs), 233472 // (grid["smem"] + 1024),
               2048 // grid["threads"], 32)


def ptxas_report(log: str) -> dict:
    """kernel instance -> registers and spill bytes, from ``nvcc -Xptxas -v``."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            k = re.search(r"(chebdiff_last_kernel|laplacian3d_plane_kernel|laplacian3d_x_kernel"
                          r"|chebdiff_packed_kernel)"
                          r"I(.*?)EEv", m.group(1))
            args = ["float" if f == "f" else "double" if f == "d" else num or
                    ("true" if b == "1" else "false")
                    for num, b, f in re.findall(r"Li(\d+)E|Lb([01])E|([fd])", k.group(2))]
            cur = out.setdefault(f"{k.group(1)}<{', '.join(args)}>", {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and cur is not None:
            cur.update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return out


def k3_sweep_ms(cuda_cheb, u) -> dict:
    """(pack, row tile) -> K3's (device_ms, call_ms) on u (M, 64) viewed as
    (M / pack, 64 pack): the six cases of the sweep.  k3_sweep.py times
    them in other checkouts."""
    out = {}
    for pack in (1, 2):
        u2d = u.view(-1, 64 * pack)
        for blk in (32, 64, 128):
            out[(pack, blk)] = both_ms(lambda: cuda_cheb.chebdiff_packed(u2d, pack, K3_SCALE, blk))
    return out


def run_cli(cli_main, argv) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    return rc, buf.getvalue()


# -- phase 17: sharded solves, gloo processes sharing the one card ------------
# Each run is built as one process builds it (the CLI's own configuration
# builders) and then with a mesh; the worker runs the one-process
# reference on the card, then spawns the ranks, which run the sharded
# form with the launch counts and the exchange counters set to 0 before
# it and read after.  Gates: the one-process run's counts, and its fields
# to 1e-9 relative (17f: the batch's per-member counts, x to 1e-12), except
# where round-off alone moves them: README:43's pressure carries spurious
# modes that a start moved by 1e-14 changes by ~100% (12^3, on the CPU),
# and such a start moves an FGMRES count by one, as it does the 20^3 CN
# step's (ROADMAP queue 3).  There (17a, 17b, 17e's unsteady steps) the one-process run is
# repeated from a start moved by 1e-14: the sharded Krylov counts lie
# within max(3, 10%) of the two runs' range (the repo's rule), the Newton
# counts equal, v within 4x the perturbed run's move (or 1e-9), and the
# pressure is held by the one-process residual (the Newton residual, or
# the last CN step's) evaluated at the gathered sharded state: its norm
# within 4x the larger of the two one-process runs' own, and 17a/17b's
# error within 2x theirs.
P17_RUNS = {   # run -> (mesh axes, axis_map)
    "17a": ({"x": 2}, None), "17b": ({"x": 2, "y": 2}, {0: "x", 1: "y"}),
    "17c": ({"x": 2}, None), "17d": ({"x": 2}, None), "17e": ({"x": 2}, None),
    "17f": ({"x": 2}, None)}
PARTS17 = frozenset(P17_RUNS)
USTOKES_STEPS = 2


def _p17_fields(out: dict, slab) -> dict:
    """The global fields of a run's result (gathered on a mesh)."""
    import torch

    return {k: (slab.gather(v) if slab is not None else v).cpu()
            for k, v in out.items() if isinstance(v, torch.Tensor)}


def _on(a, dev):
    """A gathered host array as a float64 tensor on ``dev``."""
    import torch
    return torch.as_tensor(a, dtype=torch.float64, device=dev)


def p17_run(run: str, dev, mesh=None, axis_map=None, perturb: float = 0.0) -> dict:
    """One phase-17 configuration, in one process (mesh None) or on this
    process' slab: its counts, errors and global fields.  ``perturb``
    moves the start (17a-c's zero state, 17e's initial velocity) by that
    much seeded masked noise (in one process)."""
    import numpy as np
    import torch

    from spectral_tpu_torch.cli.drivers import convection_config, stokes_config, ustokes_config
    from spectral_tpu_torch.grid import Grid
    from spectral_tpu_torch.models.convection import ConvectionModel
    from spectral_tpu_torch.models.elliptic import EllipticModel
    from spectral_tpu_torch.models.poisson import PoissonModel
    from spectral_tpu_torch.models.stokes import StokesProblem
    from spectral_tpu_torch.models.stokes_unsteady import UnsteadyStokes
    from spectral_tpu_torch.ops.curvilinear import named_map
    from spectral_tpu_torch.solvers.krylov import KSPConfig
    from spectral_tpu_torch.solvers.newton import NewtonConfig, _norm
    from spectral_tpu_torch.utils.options import Options

    f64 = torch.float64
    kw = {} if mesh is None else dict(mesh=mesh, axis_map=axis_map)
    gen = torch.Generator(device=dev).manual_seed(15)

    def noise(t):
        return perturb * torch.randn(t.shape, generator=gen, device=dev, dtype=t.dtype)

    if run in ("17a", "17b", "17c"):
        if run == "17c":   # "15d stokes 3d": the curved default, the metric multigrid
            argv = CURVED_ORACLE["15d stokes 3d"]["argv"][1:]
            cfg = dataclasses.replace(stokes_config(Options(argv), f64), pcvel="mg")
            p = StokesProblem(Grid((14, 14, 14), device=dev), cfg, phi=named_map("bump:0.06"),
                              **kw)
        else:
            p = StokesProblem(Grid((20, 20, 20), device=dev),
                              stokes_config(Options(STOKES_README43), f64), **kw)
        if perturb:   # solve_continuation's loop from the moved start
            z = p.zero_state()
            x = {"v": p.mask_v(noise(z["v"])), "p": p.mask_p(noise(z["p"]))}
            res = []
            for i in range(p.config.cont0, p.config.cont + 1):
                res.append(p.solve(x, params=p.params_at(i)))
                x = res[-1].x
        else:
            res = p.solve_continuation()
        x = res[-1].x
        div = p.divergence(x["v"], with_dirichlet=True)
        div = torch.max(torch.abs(div)).reshape(1)
        if mesh is not None:
            div = mesh.allmax(div)
        out = {"newton": [r.iters for r in res], "krylov": [r.ksp_iters for r in res],
               "error": p.error_vs_exact(x), "divergence": float(div), "v": x["v"],
               "p": p.project_p(x["p"])}
        out = {**out, **_p17_fields(out, p.slab)}
        if mesh is None:   # the Newton residual's norm at a gathered state
            params = p.params_at(p.config.cont)

            def fnorm_at(v, pr):
                F = p.make_residual(params)({"v": _on(v, dev), "p": _on(pr, dev)})[0]
                return float(_norm({"v": F["v"], "p": p.project_p(F["p"])}))

            out["fnorm_at"] = fnorm_at
        return out
    if run == "17d":   # the elliptic CLI's 32^3 mg3 configuration
        m = EllipticModel(Grid((32, 32, 32), device=dev), gamma=1.0, **kw)
        u, b, d = EllipticModel(Grid((32, 32, 32), device=dev), gamma=1.0).setup_problem(exact=0)
        if mesh is not None:
            u, b, d = m.local(u), m.local(b), m.local(d)
        r = m.solve(b, d, ksp=KSPConfig(type="fgmres", rtol=1e-5, max_it=500),
                    newton=NewtonConfig(rtol=1e-10, max_it=50), pc_type="mg3")
        err = torch.max(torch.abs(r.x - u)).reshape(1)
        if mesh is not None:
            err = mesh.allmax(err)
        out = {"newton": r.iters, "krylov": r.ksp_iters, "error": float(err), "x": r.x}
        return {**out, **_p17_fields(out, m.slab)}
    if run == "17e":
        # two CN steps at 11b's 20^3 configuration, then two convection
        # steps and one step_dt at 12a's Blankenbach 16^2 configuration
        cfg = ustokes_config(Options(USTOKES20), f64)
        us = UnsteadyStokes(Grid((20, 20, 20), device=dev), cfg, dt=0.05, **kw)
        u0, s_of_t, f_of_t, _, _ = us.manufactured()
        if perturb:
            u0 = u0 + us.problem.mask_v(noise(u0))
        times = np.arange(USTOKES_STEPS + 1) * 0.05
        fbars = [0.5 * f_of_t(t1) + 0.5 * f_of_t(t0) for t0, t1 in zip(times[:-1], times[1:])]
        s_last = float(s_of_t(times[-1]))
        v0, _, its = us.rollout_scan(u0, [s_of_t(t) for t in times[1:-1]], fbars[:-1])
        v, pr, it, _ = us.step(v0, s_last, fbars[-1])
        its = [*its.tolist(), int(it)]
        ccfg = convection_config(Options(BLANKENBACH))
        m = ConvectionModel.box((16, 16), ccfg, device=dev, **kw)
        with captured_returns(ConvectionModel, "solve_stokes") as solves:
            carry = m.init_carry(m.conductive_state(amp=0.05))
            for _ in range(2):
                carry = m.step(*carry)
            T, N, x = m.step_dt(*carry, 4e-4, 0.8)
        out = {"ustokes_outer": [int(i) for i in its], "conv_krylov": [int(s.iters) for s in solves],
               "nu_top": float(m.nusselt_top(T)), "vrms": float(m.vrms(x)),
               "us_v0": v0, "us_v": v, "us_p": pr, "T": T, "N": N, "xv": x["v"]}
        out = {**out, **_p17_fields(out, us.problem.slab)}
        if mesh is None:   # the last CN step's residual norm at a gathered state
            params = us.problem.params_at(us.problem.config.cont)

            def us_fnorm_at(v_0, v_1, p_1):
                F = us._step_residual({"v": _on(v_1, dev), "p": _on(p_1, dev) / us.theta},
                                      _on(v_0, dev), params, s_last, fbars[-1])[0]
                return float(_norm(F))

            out["us_fnorm_at"] = us_fnorm_at
        return out
    if run == "17f":   # 16d's 8 right-hand sides, the batch cut over the mesh
        model = PoissonModel(Grid((64, 64, 64), device=dev, dtype=f64))
        M = model.build_pc("fastdiag")
        Bm = torch.randn((8, 64, 64, 64), generator=torch.Generator(device=dev).manual_seed(160),
                         device=dev, dtype=f64)
        r = KSPConfig(type="gmres", rtol=1e-10, max_it=200).solve_batched(
            model.operator, Bm, M=M, mesh=mesh)
        return {"iters": r.iters.tolist(), "reason": r.reason.tolist(), "x": r.x.cpu()}
    raise ValueError(run)


def _phase17_rank(rank: int, world: int, store: str, axes: dict, axis_map, runs, queue):
    """One gloo process of phase 17 on the one card: each run of ``runs``
    on this process' slab, its K1 launches (by shape) and exchanges
    counted.  Puts (rank, run, record) on ``queue`` as each run ends, rank
    0's with the gathered fields."""
    import traceback

    import torch
    import torch.distributed as dist

    try:
        dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                                world_size=world)
        from spectral_tpu_torch.ops import cuda_cheb
        from spectral_tpu_torch.parallel import make_mesh
        from spectral_tpu_torch.parallel.mesh import EXCHANGES

        dev = torch.device("cuda")
        mesh = make_mesh(axes)
        for run in runs:
            dist.barrier()
            cuda_cheb.reset_launch_counts()
            EXCHANGES.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = p17_run(run, dev, mesh, axis_map)
            torch.cuda.synchronize()
            rec = {"seconds": time.perf_counter() - t0, "launches": dict(cuda_cheb.LAUNCHES),
                   "k1_launches_by_shape": {f"{tuple(sp)} {str(dt)[6:]}": c for (sp, dt), c
                                            in cuda_cheb.K1_LAUNCHES_BY_SHAPE.items()},
                   "exchanges": dict(EXCHANGES)}
            rec["out"] = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                          for k, v in out.items() if rank == 0 or not isinstance(v, torch.Tensor)}
            queue.put((rank, run, rec))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        queue.put((rank, None, {"error": traceback.format_exc()}))
        raise


def _spawn17(world: int, axes: dict, axis_map, runs) -> dict:
    """Run ``runs`` in ``world`` gloo processes; {rank: {run: record}}.  A
    run may take up to 600 s; a rank's failure ends the phase."""
    import os
    import tempfile

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    recs = {r: {} for r in range(world)}
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_phase17_rank,
                             args=(r, world, os.path.join(tmp, "store"), axes, axis_map, runs,
                                   queue)) for r in range(world)]
        try:
            for pr in procs:
                pr.start()
            for _ in range(world * len(runs)):
                rank, run, rec = queue.get(timeout=600)
                require("error" not in rec, f"phase 17: rank {rank}: {rec.get('error')}")
                recs[rank][run] = rec
            for pr in procs:
                pr.join(timeout=60)
        finally:
            for pr in procs:
                if pr.pid is None:   # never started
                    continue
                if pr.is_alive():
                    pr.kill()
                pr.join()
    return recs


def _rel(a, ref) -> float:
    import numpy as np
    a, ref = np.asarray(a), np.asarray(ref)
    return float(np.max(np.abs(a - ref)) / max(float(np.max(np.abs(ref))), 1e-300))


def phase17(path, k1_shapes, launches, parts=PARTS17) -> dict:
    """Phase 17 (see above), the runs in ``parts``: the one-process
    references on the card (counted as their own paths), then the sharded
    runs in gloo processes (17b in four, the rest in two), every rank's K1
    launches added to the path's and K2 held at 0; a K1 (shape, dtype) the
    slabs take that phase 1 does not hold is held here, bit for bit."""
    import numpy as np
    import torch

    from spectral_tpu_torch.ops import cuda_cheb

    dev = torch.device("cuda")
    K1 = "chebdiff_last_kernel"
    K2 = ("laplacian3d_plane_kernel", "laplacian3d_x_kernel")
    out = {}
    refs = {}
    def host(rec):
        return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
                for k, v in rec.items()}

    perturbed = {}
    for run in sorted(parts):
        if run == "17b" and "17a" in refs:
            refs[run], perturbed[run] = refs["17a"], perturbed["17a"]
            continue
        (ref, t), _ = path(f"phase17 {run} one process",
                           lambda: timed_once(lambda: p17_run(run, dev)), [K1])
        refs[run] = {**host(ref), "seconds": t}
        if run in ("17a", "17b", "17e"):   # round-off's own move
            perturbed[run] = host(p17_run(run, dev, perturb=1e-14))

    def krylov_ok(got, ref, pert) -> bool:   # within max(3, 10%) of the range
        lo, hi = min(ref, pert), max(ref, pert)
        return lo - max(3, math.ceil(0.1 * hi)) <= got <= hi + max(3, math.ceil(0.1 * hi))

    def flat(k):
        return [int(i) for row in k for i in (row if isinstance(row, list) else [row])]
    groups = [(4, {"x": 2, "y": 2}, {0: "x", 1: "y"}, ["17b"]),
              (2, {"x": 2}, None, [r for r in sorted(parts) if r != "17b"])]
    held = {f"{s} float64" for s in K1_PATH_SHAPES + K1_CURVED_SHAPES + K1_SLAB_SHAPES
            + K1_FAMILY_SHAPES + K1_BATCHED_SHAPES}
    for world, axes, amap, runs in groups:
        runs = [r for r in runs if r in parts]
        if not runs:
            continue
        recs = _spawn17(world, axes, amap, runs)
        for run in runs:
            name = f"phase17 {run}"
            ref, got = refs[run], recs[0][run]["out"]
            for rank in range(world):
                rec = recs[rank][run]
                for k, v in rec["launches"].items():
                    launches[k] += v
                k1_shapes[f"{name} rank {rank}"] = rec["k1_launches_by_shape"]
                require(rec["launches"][K1] > 0, f"{name}: rank {rank} launched no K1")
                require(all(rec["launches"][k] == 0 for k in K2),
                        f"{name}: K2 launched on a slab (rank {rank})")
            if run in ("17a", "17b", "17c"):
                dv, dp = _rel(got["v"], ref["v"]), _rel(got["p"], ref["p"])
                de = abs(got["error"] - ref["error"]) / ref["error"]
                dd = abs(got["divergence"] - ref["divergence"]) / max(ref["divergence"], 1e-300)
                rec = dict(newton=got["newton"], krylov=got["krylov"], error=got["error"],
                           divergence=got["divergence"], v_rel=dv, p_rel=dp, error_rel=de,
                           divergence_rel=dd, one_process=[ref["newton"], ref["krylov"],
                                                           ref["error"]])
                counts = f"{got['newton']} {got['krylov']}, one process {ref['newton']} " \
                         f"{ref['krylov']}"
                if run == "17c":
                    require(got["newton"] == ref["newton"] and got["krylov"] == ref["krylov"],
                            f"{name}: counts {counts}")
                    require(max(dv, dp, de, dd) <= 1e-9,
                            f"{name}: v {dv:.3e} p {dp:.3e} error {de:.3e} divergence {dd:.3e}")
                else:
                    pt = perturbed[run]
                    mv, mp = _rel(pt["v"], ref["v"]), _rel(pt["p"], ref["p"])
                    require(got["newton"] == ref["newton"] and all(
                        krylov_ok(g, r, q) for g, r, q in zip(
                            flat(got["krylov"]), flat(ref["krylov"]), flat(pt["krylov"]))),
                        f"{name}: counts {counts}, perturbed {pt['krylov']}")
                    # p is held by the one-process residual at the gathered
                    # state (v, p): within 4x the larger of the one-process
                    # runs' own, which round-off cannot move past the solve's
                    # tolerance (a wrong pressure's gradient leaves it O(1))
                    fn = {k: ref["fnorm_at"](d["v"], d["p"])
                          for k, d in (("sharded", got), ("one", ref), ("perturbed", pt))}
                    require(dv <= max(1e-9, 4 * mv),
                            f"{name}: v {dv:.3e}, perturbed {mv:.3e}")
                    require(fn["sharded"] <= 4 * max(fn["one"], fn["perturbed"]),
                            f"{name}: residual at the sharded state {fn}")
                    require(got["error"] <= 2 * max(ref["error"], pt["error"]),
                            f"{name}: error {got['error']:.6e}, one process {ref['error']:.6e},"
                            f" perturbed {pt['error']:.6e}")
                    rec.update(perturbed=[pt["krylov"], pt["error"]], v_move=mv, p_move=mp,
                               fnorm=fn, counts_equal=got["krylov"] == ref["krylov"])
            elif run == "17d":
                require(got["newton"] == ref["newton"] and got["krylov"] == ref["krylov"],
                        f"{name}: counts {got['newton']} {got['krylov']}, one process "
                        f"{ref['newton']} {ref['krylov']}")
                rec = dict(newton=got["newton"], krylov=got["krylov"], error=got["error"],
                           x_rel=_rel(got["x"], ref["x"]))
            elif run == "17e":
                pt = perturbed[run]
                require(got["conv_krylov"] == ref["conv_krylov"] and all(
                    krylov_ok(g, r, q) for g, r, q in zip(
                        got["ustokes_outer"], ref["ustokes_outer"], pt["ustokes_outer"])),
                        f"{name}: counts {got['ustokes_outer']} {got['conv_krylov']}, one "
                        f"process {ref['ustokes_outer']} {ref['conv_krylov']}, perturbed "
                        f"{pt['ustokes_outer']}")
                rels = {k: _rel(got[k], ref[k]) for k in ("us_v", "us_p", "T", "N", "xv")}
                moves = {k: _rel(pt[k], ref[k]) for k in ("us_v", "us_p")}
                # the unsteady p as 17a's: the last step's one-process residual
                fn = {k: ref["us_fnorm_at"](d["us_v0"], d["us_v"], d["us_p"])
                      for k, d in (("sharded", got), ("one", ref), ("perturbed", pt))}
                require(rels["us_v"] <= max(1e-9, 4 * moves["us_v"])
                        and max(rels[k] for k in ("T", "N", "xv")) <= 1e-9,
                        f"{name}: fields {rels}, perturbed {moves}")
                require(fn["sharded"] <= 4 * max(fn["one"], fn["perturbed"]),
                        f"{name}: the last CN step's residual at the sharded state {fn}")
                rec = dict(ustokes_outer=got["ustokes_outer"], conv_krylov=got["conv_krylov"],
                           one_process=[ref["ustokes_outer"], ref["conv_krylov"]],
                           perturbed=pt["ustokes_outer"], nu_top=got["nu_top"], vrms=got["vrms"],
                           field_rel=rels, unsteady_move=moves, unsteady_fnorm=fn,
                           nu_rel=abs(got["nu_top"] - ref["nu_top"]) / ref["nu_top"])
            else:
                require(got["iters"] == ref["iters"] and all(r > 0 for r in got["reason"]),
                        f"{name}: counts {got['iters']}, the unsharded batch {ref['iters']}")
                dx = _rel(got["x"], ref["x"])
                require(dx <= 1e-12, f"{name}: x {dx:.3e} off the unsharded batch")
                rec = dict(iters=got["iters"], x_rel=dx,
                           bitwise=bool(np.array_equal(got["x"], ref["x"])))
            ex = recs[0][run]["exchanges"]
            outer = (sum(sum(k) for k in rec["krylov"]) if run in ("17a", "17b", "17c")
                     else None)
            rec.update(seconds=recs[0][run]["seconds"], one_process_s=ref["seconds"],
                       processes=world, exchanges_rank0=ex,
                       exchanges_per_outer=(None if not outer
                                            else {k: v / outer for k, v in ex.items()}),
                       k1_launches=[recs[r][run]["launches"][K1] for r in range(world)],
                       k2_launches=[sum(recs[r][run]["launches"][k] for k in K2)
                                    for r in range(world)],
                       k1_launches_by_shape=recs[0][run]["k1_launches_by_shape"])
            out[run] = rec
            print(f"{name} " + json.dumps(rec))
    # a slab shape phase 1 does not hold: held here, bit for bit in float64
    seen = {k for n, by in k1_shapes.items() if n.startswith("phase17") for k in by}
    extra = {}
    for key in sorted(seen - held):
        shape = tuple(int(s) for s in key.split(")")[0].strip("(").split(",") if s.strip())
        dt = getattr(torch, key.split()[-1])
        u = torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(17),
                        device=dev, dtype=dt)
        got = cuda_cheb.chebdiff_last(u)
        ref = cuda_cheb.chebdiff_last_ref(u)
        extra[key] = bool(torch.equal(got, ref)) if dt == torch.float64 else _rel(
            got.cpu(), ref.cpu())
        require(extra[key] is True or (dt != torch.float64 and extra[key] <= BOUND["float32"]),
                f"phase 17: K1 {key} not its plain version ({extra[key]})")
    out["k1_held_in_phase17"] = extra
    return out


# -- phase 18: the utilities -----------------------------------------------------
# 18a: README:52 (phase 8's power law, -cont 4, 20^3) through the stokes CLI
# with -checkpoint_dir, -output_vtk and -log_summary, held to STOKES_ORACLE
# as phase 8 holds it; its last two steps' files deleted, the run again:
# it solves those two steps alone, their Newton counts the full run's,
# their Krylov counts within max(3, 10%) of the range of the JAX runs and
# the card's full run, the error the oracle's.  The fields the VTK writer
# computes from the card's final state (read from the checkpoint) on the
# card, in float64 before formatting, are held to those it computes on the
# CPU from the same state: each within 1e-12 of its section's largest.  The
# stokes.vtk the CLI wrote is held to the file the port writes on the CPU
# from that state: the same header lines and counts of values, and each
# printed value at most one unit apart in the last of its 7 digits (a
# round-off on either side of a printed rounding; the fields gate is the
# one that bounds the values).  The native formatter must be in use, and
# -log_summary's SNESSolve total within 10% of the host time of the run.
# 18b: 12a's -ts_adapt march at 12^2 with checkpoint_every=50, then
# resumed from its step 200: the step counter
# carried on, only the remaining steps marched, accepted and rejected
# steps within max(3, 10%) of the full run's, Nu within 1e-6 relative.
# 18c: graft_entry.entry() at 32^3 under set_production_path("kernel") and
# ("matmul"): F and J F within 1e-12 relative of each other and of the
# oracle's norms, K1 launched on the kernel path and not on the matmul
# path, each forward's warm time by CUDA events.  18d: trace_summary of a
# warm Newton solve of 18a's last continuation step (the problem built and
# the step-3 state read before the trace starts): device busy time, event
# count, idle share, beside the same solve's untraced wall in the resumed
# run (between its step-3 and step-4 checkpoint files).  18e: the six
# examples, each exiting 0.
P18_MARCH_ARGV = CONVECTION_ORACLE["12a adapt"]["argv"][1:]
P18_EXAMPLES = {   # module -> argv (default depth; family_sweep at 3 members)
    "shell_demo": [], "nk_demo": ["-user_precond", "-rhistory"],
    "curved_domain_demo": ["-output_vtk"], "family_sweep_demo": ["-B", "3"],
    "solver_tuning_demo": [], "sharded_poisson_demo": ["-np", "4"]}


def vtk_sections(path) -> list:
    """[(header lines, values), ...] of a legacy VTK file."""
    import numpy as np

    sections, head, vals = [], [], []
    for line in open(path).read().splitlines():
        try:
            vals.extend(float(t) for t in line.split())
        except ValueError:
            if vals:
                sections.append((head, np.asarray(vals)))
                head, vals = [], []
            head.append(line)
    sections.append((head, np.asarray(vals)))
    return sections


def vtk_agree(path, ref_path) -> dict:
    """18a's comparison of two VTK files' text (see above): the same header
    lines and counts of values, no value more than one unit apart in its
    last printed digit; the count of values and of those one unit apart."""
    import numpy as np

    got, ref = vtk_sections(path), vtk_sections(ref_path)
    require([h for h, _ in got] == [h for h, _ in ref], f"{path}: other lines than {ref_path}")
    n = last_digit = 0
    for (head, a), (_, b) in zip(got, ref):
        require(a.shape == b.shape, f"{path}: {head}: {a.shape} values, {b.shape} on the CPU")
        unit = 10.0 ** (np.floor(np.log10(np.maximum(np.abs(b), 1e-300))) - 6)
        d = np.abs(a - b)
        require(bool(np.all(d <= 1.0000001 * unit)),
                f"{path}: {head}: a printed value more than one unit off the CPU's")
        n, last_digit = n + b.size, last_digit + int(np.count_nonzero(d))
    return {"values": n, "last_digit_units": last_digit}


def phase18(cli_main, path, k1_shapes) -> dict:
    """Phase 18 (above): the utilities on the card; raises on a failed gate."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from spectral_tpu_torch.cli.drivers import convection_config, stokes_config
    from spectral_tpu_torch.grid import Grid
    from spectral_tpu_torch.models.convection import ConvectionModel
    from spectral_tpu_torch.models.stokes import StokesProblem
    from spectral_tpu_torch.ops import chebyshev
    from spectral_tpu_torch.utils import checkpoint as ckpt
    from spectral_tpu_torch.utils import native
    from spectral_tpu_torch.utils.options import Options
    from spectral_tpu_torch.utils.profiling import trace_summary
    from spectral_tpu_torch.utils.vtk import stokes_vtk_fields, write_stokes_vtk

    out = {}
    dev = torch.device("cuda")
    tmp = tempfile.mkdtemp(prefix="chip_smoke18-")
    try:
        # -- 18a: README:52 with checkpoints, VTK output and -log_summary ------
        argv = ["stokes", *STOKES_README52, "-checkpoint_dir", "ck", "-output_vtk",
                "-log_summary"]

        def cli(name):
            with contextlib.chdir(tmp):
                (got, host_s), counts = path(f"phase18 {name}",
                                             lambda: timed_once(lambda: run_cli(cli_main, argv)),
                                             [K1_NAME])
            rc, text = got
            mc = re.search(r"Continuation steps: Newton (\[.*\])  Krylov (\[.*\])", text)
            me = re.search(r"Norm of error\s*: abs = (\S+)", text)
            ms = re.search(r"^SNESSolve +1 +(\S+) ", text, re.M)
            require(rc == 0 and mc and me and ms and "wrote stokes.vtk" in text,
                    f"18a {name} failed (rc {rc}): {text!r}")
            return {"newton": json.loads(mc.group(1)), "krylov": json.loads(mc.group(2)),
                    "error": float(me.group(1)), "snes_solve_s": float(ms.group(1)),
                    "host_s": host_s, "k1_launches": counts[K1_NAME],
                    "k1_launches_by_shape": k1_shapes[f"phase18 {name}"]}

        full = cli("README:52 checkpointed")
        why = stokes_cli_ok("README:52", full["newton"], full["krylov"], full["error"])
        require(why is None, f"18a: {why}")
        require(abs(full["snes_solve_s"] - full["host_s"]) <= 0.1 * full["host_s"],
                f"18a: SNESSolve {full['snes_solve_s']} s, the run {full['host_s']:.3f} s (10%)")
        require(native.available(), "18a: the native IO runtime did not build")
        cdir = os.path.join(tmp, "ck")
        cfg = stokes_config(Options(STOKES_README52), torch.float64)
        p_cpu = StokesProblem(Grid((20, 20, 20), device="cpu"), cfg)
        p_card = StokesProblem(Grid((20, 20, 20), device=dev), cfg)
        x_cpu = ckpt.load_state(cdir, 4, p_cpu.zero_state())
        on_card = stokes_vtk_fields(p_card, ckpt.load_state(cdir, 4, p_card.zero_state()))
        on_cpu = stokes_vtk_fields(p_cpu, x_cpu)
        rel = {k: float(np.abs(on_card[k] - b).max() / max(np.abs(b).max(), 1e-300))
               for k, b in on_cpu.items()}
        require(max(rel.values()) <= 1e-12, f"18a: the VTK fields on the card against the "
                                            f"CPU's (1e-12 of each one's largest): {rel}")
        write_stokes_vtk(p_cpu, x_cpu, os.path.join(tmp, "cpu.vtk"))
        full["vtk"] = {"fields_rel": rel, **vtk_agree(os.path.join(tmp, "stokes.vtk"),
                                                      os.path.join(tmp, "cpu.vtk"))}
        out["README:52 checkpointed"] = full
        for step in (3, 4):
            for suffix in (".npz", ".npz.json"):
                os.remove(os.path.join(cdir, f"step_{step:04d}{suffix}"))
        resumed = cli("README:52 resumed")
        spec = STOKES_ORACLE["README:52"]
        require(resumed["newton"] == full["newton"][-2:],
                f"18a resumed: Newton {resumed['newton']}, the full run's {full['newton'][-2:]}")
        runs = [spec["krylov"], *spec["perturbed"], full["krylov"]]
        for i, got in zip((3, 4), resumed["krylov"]):
            for j, k in enumerate(got):
                lo, hi = min(r[i][j] for r in runs), max(r[i][j] for r in runs)
                require(_within(k, lo, hi), f"18a resumed: Krylov {got} in step {i}, the runs "
                                            f"span {lo}..{hi} (max(3, 10%) beyond)")
        require(abs(resumed["error"] - spec["error"]) <= 1e-6 * spec["error"],
                f"18a resumed: error {resumed['error']!r}, oracle {spec['error']!r}")
        out["README:52 resumed"] = resumed

        # -- 18d: trace_summary of a warm solve, the last step from step 3 ---------
        # The same solve untraced is the resumed run's last step: the time
        # between its step-3 and step-4 checkpoint files (the step-4 save,
        # ~0.2 MB, included).
        untraced_s = (os.stat(os.path.join(cdir, "step_0004.npz")).st_mtime_ns
                      - os.stat(os.path.join(cdir, "step_0003.npz")).st_mtime_ns) / 1e9
        x3 = ckpt.load_state(cdir, 3, p_card.zero_state())
        solved = {}
        trace = trace_summary(lambda: solved.update(
            res=p_card.solve(x3, params=p_card.params_at(cfg.cont))))
        require(solved["res"].iters == full["newton"][-1] and trace["device_event_count"] > 0,
                f"18d: {solved['res'].iters} Newton iterations (the CLI's "
                f"{full['newton'][-1]}), {trace}")
        trace["idle_share"] = 1.0 - trace["device_busy_ms"] / trace["wall_ms"]
        # the profiler slows the host, not the card: the busy time over the
        # untraced wall is the idle share of the solve as it runs untraced
        trace["untraced_ms"] = untraced_s * 1e3
        trace["idle_share_untraced"] = 1.0 - trace["device_busy_ms"] / trace["untraced_ms"]
        print("phase18 trace " + json.dumps(trace))
        out["trace"] = {k: trace[k] for k in ("wall_ms", "untraced_ms", "device_busy_ms",
                                              "device_event_count", "idle_share",
                                              "idle_share_untraced")}

        # -- 18b: the adaptive march, checkpointed and resumed ----------------------
        m = ConvectionModel.box((12, 12), convection_config(Options(P18_MARCH_ARGV)), device=dev)
        T0 = m.conductive_state(amp=0.05)
        march = dict(max_steps=3000, tol=1e-4, rtol=3e-3, dt0=2e-5)
        mdir = os.path.join(tmp, "march")
        (_, _, info), counts = path("phase18 march", lambda: m.march_adaptive(
            T0, checkpoint=mdir, checkpoint_every=50, **march), [K1_NAME])
        ref = CONVECTION_ORACLE["12a adapt"]
        require(_max10(info["steps"], ref["accepted"]) and _max10(info["rejects"], ref["rejected"]),
                f"18b: {info['steps']} / {info['rejects']}, oracle {ref['accepted']} / "
                f"{ref['rejected']}")
        for f in os.listdir(mdir):
            if int(re.match(r"step_(\d+)", f).group(1)) > 200:
                os.remove(os.path.join(mdir, f))
        (_, _, rinfo), rcounts = path("phase18 march resumed", lambda: m.march_adaptive(
            T0, checkpoint=mdir, checkpoint_every=50, resume=True, **march), [K1_NAME])
        require(len(rinfo["dts"]) == rinfo["steps"] - 200,
                f"18b: {len(rinfo['dts'])} steps marched to reach {rinfo['steps']} from 200")
        require(_max10(rinfo["steps"], info["steps"]) and _max10(rinfo["rejects"], info["rejects"]),
                f"18b resumed: {rinfo['steps']} / {rinfo['rejects']}, the full run "
                f"{info['steps']} / {info['rejects']}")
        require(abs(rinfo["nu_top"] - info["nu_top"]) <= 1e-6 * abs(info["nu_top"]),
                f"18b resumed: Nu {rinfo['nu_top']!r}, the full run {info['nu_top']!r}")
        out["march"] = {k: {"steps": i["steps"], "rejects": i["rejects"], "nu_top": i["nu_top"],
                            "k1_launches": c[K1_NAME],
                            "k1_launches_by_shape": k1_shapes[f"phase18 {k}"]}
                        for k, i, c in (("march", info, counts), ("march resumed", rinfo, rcounts))}

        # -- 18c: the graft entry on both production paths ------------------------
        from spectral_tpu_torch.graft_entry import entry

        fields = {}
        try:
            for mode in ("kernel", "matmul"):
                chebyshev.set_production_path(mode)
                forward, (x,) = entry()
                y, counts = path(f"phase18 entry {mode}", lambda: forward(x), [])
                require((counts[K1_NAME] > 0) == (mode == "kernel"),
                        f"18c {mode}: {counts[K1_NAME]} K1 launches")
                fields[mode] = {f"{k} {c}": t for k, yk in y.items() for c, t in yk.items()}
                forward(x)
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(10):
                    forward(x)
                end.record()
                end.synchronize()
                norms = {k: float(torch.sqrt(sum(torch.sum(t ** 2) for t in yk.values())))
                         for k, yk in y.items()}
                rel = max(abs(v / STOKES_ORACLE["entry"][k] - 1.0) for k, v in norms.items())
                require(rel <= 1e-12, f"18c {mode}: norms {norms}, oracle {STOKES_ORACLE['entry']}")
                out[f"entry {mode}"] = {"warm_ms": start.elapsed_time(end) / 10,
                                        "k1_launches": counts[K1_NAME],
                                        "k1_launches_by_shape": k1_shapes[f"phase18 entry {mode}"]}
        finally:
            chebyshev.set_production_path("kernel")
        diff = max(float(torch.max(torch.abs(fields["kernel"][k] - t)) / torch.max(torch.abs(t)))
                   for k, t in fields["matmul"].items())
        require(diff <= 1e-12, f"18c: the kernel and matmul paths {diff:.3e} apart (1e-12)")
        out["entry kernel"]["rel_to_matmul"] = diff

        # -- 18e: the examples ---------------------------------------------------
        import importlib

        for name, extra in P18_EXAMPLES.items():
            mod = importlib.import_module(f"spectral_tpu_torch.examples.{name}")
            with contextlib.chdir(tmp):
                (got, seconds), counts = path(
                    f"phase18 {name}", lambda: timed_once(lambda: run_cli(mod.main, extra)), [])
            rc, text = got
            require(rc == 0, f"18e {name}: exit {rc}: {text!r}")
            for line in text.splitlines():
                print(f"phase18 {name}: {line}")
            out[name] = {"seconds": seconds, "k1_launches": counts[K1_NAME],
                         "k1_launches_by_shape": k1_shapes[f"phase18 {name}"]}
        held = {f"{s} float64" for s in K1_PATH_SHAPES + K1_CURVED_SHAPES + K1_FAMILY_SHAPES
                + K1_EXAMPLE_SHAPES}
        seen = {k for n, by in k1_shapes.items() if n.startswith("phase18") for k in by}
        require(seen <= held, f"phase 18: K1 launched on {sorted(seen - held)}, which phase 1 "
                              "does not hold (add them to K1_EXAMPLE_SHAPES)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


ALL_PHASES = frozenset(range(19))
# The full run: phases 0-2, 5 and 13a in this process, so that their kernel
# timings have the card to themselves, then the paths in worker processes
# run at once, one a group.  The paths are host-bound (the card idles 91-99%
# in each, PERF.md section 3), so the groups share the card and the cores
# with little loss; they are balanced by the seconds of a serial run.
PARENT_PHASES = "1-2,5,13a"
WORKER_GROUPS = ("8-9", "13e", "3-4,6-7,11,13b-d", "10,12,14", "15", "16a", "16b-e,18", "17")
# The workers end within this many seconds of the script's start.
WORKER_DEADLINE_S = 1100.0
USAGE = "usage: chip_smoke.py [--serial | --phases 1,3,8-18,13b-d,16a,17b]"


def parse_phases(spec: str) -> tuple[frozenset, frozenset]:
    """``3,8-14,13b-d,16a`` -> (phases, runs of phases 13 and 16: 13's by
    letter, 16's as "16a"..."16e"): phase 0, the build, always; 9 brings 8,
    whose solutions 9d reuses; 13 alone is 13a-13e, 16 alone 16a-16e."""
    want, parts = {0}, set()
    for part in spec.split(","):
        m = re.fullmatch(r"(13|16|17)([a-f])(?:-([a-f]))?", part)
        if m:
            want.add(int(m.group(1)))
            lo, hi = m.group(2), m.group(3) or m.group(2)
            parts.update(c if m.group(1) == "13" else m.group(1) + c
                         for c in ("abcdef" if m.group(1) == "17" else "abcde")
                         if lo <= c <= hi)
            continue
        lo, _, hi = part.partition("-")
        span = range(int(lo), int(hi or lo) + 1)
        want.update(span)
        if 13 in span:
            parts.update(PARTS13)
        if 16 in span:
            parts.update(PARTS16)
        if 17 in span:
            parts.update(f"17{c}" for c in "abcdef")
    if 9 in want:
        want.add(8)
    unknown = want - ALL_PHASES
    if unknown:
        raise SystemExit(f"chip_smoke.py: no phase {sorted(unknown)}")
    return frozenset(want), frozenset(parts)


def parse_args(argv: list[str]) -> tuple[frozenset, frozenset, str]:
    """(phases, the runs of phases 13 and 16, mode): no argument is the full run
    ("full": the paths in concurrent workers), ``--serial`` the full run in
    this process, ``--phases`` a check run, ``--worker --phases`` one
    worker of the full run."""
    if not argv:
        return ALL_PHASES, PARTS, "full"
    if argv == ["--serial"]:
        return ALL_PHASES, PARTS, "serial"
    mode = "check"
    if argv[:1] == ["--worker"]:
        mode, argv = "worker", argv[1:]
    if len(argv) != 2 or argv[0] != "--phases":
        raise SystemExit(USAGE)
    return (*parse_phases(argv[1]), mode)


def run_workers(groups, deadline_s: float) -> list[dict]:
    """Run ``chip_smoke.py --worker --phases <group>`` for every group at
    once, each with its share of the cores for host threads; stop them all
    when one fails or the deadline passes.  Prints each worker's phase
    lines and passes its standard error on, in the order of ``groups``;
    returns each one's summary (its launch counts and K1's by shape)."""
    import os
    import tempfile

    threads = str(max(1, len(os.sched_getaffinity(0)) // len(groups)))
    env = {**os.environ, "OMP_NUM_THREADS": threads, "MKL_NUM_THREADS": threads,
           "OPENBLAS_NUM_THREADS": threads}
    script = os.path.abspath(__file__)
    end = time.monotonic() + deadline_s
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        try:
            for i, group in enumerate(groups):
                out = open(os.path.join(tmp, f"{i}.out"), "w+")
                err = open(os.path.join(tmp, f"{i}.err"), "w+")
                proc = subprocess.Popen([sys.executable, script, "--worker", "--phases", group],
                                        stdout=out, stderr=err, env=env,
                                        cwd=os.path.dirname(script))
                procs.append((group, proc, out, err))
            while any(p.poll() is None for _, p, _, _ in procs):
                if time.monotonic() > end or any(p.poll() for _, p, _, _ in procs):
                    break
                time.sleep(0.5)
        finally:
            for _, p, _, _ in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        summaries, failed = [], []
        for group, p, out, err in procs:
            out.seek(0)
            err.seek(0)
            lines, err_text = out.read().splitlines(), err.read()
            out.close()
            err.close()
            sys.stderr.write(err_text)
            for line in lines:
                if line.startswith("phase") and not line.startswith("phase0 "):
                    print(line)
            summary = [json.loads(line[7:]) for line in lines if line.startswith("worker ")]
            if p.returncode != 0 or not summary:
                failed.append(f"worker {group}: exit {p.returncode}: {err_text[-3000:]}")
            else:
                summaries.append(summary[0])
        require(not failed, "\n".join(failed))
        return summaries


def main(argv: list[str] | None = None) -> int:
    t_start = time.monotonic()
    phases, parts, mode = parse_args(sys.argv[1:] if argv is None else argv)
    if mode == "full":   # this process's share; the rest go to the workers
        phases, parts = parse_phases(PARENT_PHASES)
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
    ptxas = ptxas_report(lib_path.with_suffix(".log").read_text())
    # K1: float, double x cp.async or not; K2: float, double x the plane pass
    # (tiled or unpadded) and the x pass; K3: 12
    for prefix, count in (("chebdiff_last_kernel", 4), ("laplacian3d_plane_kernel", 4),
                          ("laplacian3d_x_kernel", 2), ("chebdiff_packed_kernel", 12)):
        instances = {k: v for k, v in ptxas.items() if k.startswith(prefix + "<")}
        require(len(instances) == count,
                f"ptxas reported {len(instances)} {prefix} instances, not {count}")
        for k, v in instances.items():
            require(v.get("spill_stores") == 0 and v.get("spill_loads") == 0, f"{k} spills: {v}")
    print("phase0 " + json.dumps({
        "device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": build_s, "nvcc_s": compile_s, "ptxas": ptxas}))

    # -- phase 1: K1 against its plain version --------------------------------
    if 1 in phases:
        t_phase = time.perf_counter()
        k1 = []
        # small and ragged cases, then the shapes the paths give K1
        k1_cases = [((3, 10, 16), None), ((7, 12), None), ((5, 12), 0.25),
                    ((11, 10), None), ((4, 9, 128), None)] + [(s, None) for s in K1_PATH_SHAPES]
        k1_curved = [(s, None) for s in K1_CURVED_SHAPES + K1_SLAB_SHAPES + K1_EXAMPLE_SHAPES
                     if s not in K1_PATH_SHAPES]
        for dtype in (torch.float32, torch.float64):
            for seed, (shape, scale) in enumerate(k1_cases):
                u = randn(shape, dtype, seed)
                k1.append(compare("K1", lambda: cuda_cheb.chebdiff_last(u, scale),
                                  lambda: cuda_cheb.chebdiff_last_ref(u, scale), u,
                                  f"{shape} scale={scale}"))
                if shape in K1_GSEQ_SHAPES + K1_CONV_SHAPES and dtype == torch.float64:
                    require(k1[-1]["bitwise"], f"K1 {shape} float64: not bit for bit its plain version")
                if shape in K1_PATH_SHAPES:   # a path's shape: its bound and library call
                    n = shape[-1]
                    dt = cuda_cheb._diffmat_t(n, None, dtype, dev)
                    k1[-1]["library_ms"], k1[-1]["library_call_ms"] = both_ms(
                        lambda: torch.matmul(u, dt))
                    k1[-1]["bound_ms"], k1[-1]["bound_by"] = bound(
                        2 * u.numel() * u.element_size() + dt.numel() * dt.element_size(),
                        2 * n * u.numel(), k1[-1]["dtype"])
                    k1[-1]["kernel_ms"] = kernel_ms(lambda: cuda_cheb.chebdiff_last(u, scale))
                    k1[-1]["library_kernel_ms"] = kernel_ms(lambda: torch.matmul(u, dt))
                    grid = cuda_cheb.chebdiff_last_grid(u)
                    regs = ptxas[f"chebdiff_last_kernel<{DTYPE_C[str(dtype)]}, true>"]["registers"]
                    k1[-1].update(grid=grid, registers=regs, blocks_per_sm=blocks_per_sm(regs, grid))
            # phase 15's shapes: bit for bit in float64, timed there with
            # the bound and torch.matmul; float32 within BOUND (the plain
            # product sums in another order there), untimed.  cuBLAS takes
            # another kernel for a stack of few rows ((8, 8): 1.6e-16 off):
            # there K1 is held bit for bit against the plain product of the
            # same rows stacked eight deep
            for seed, (shape, scale) in enumerate(k1_curved):
                u = randn(shape, dtype, 50 + seed)
                f64 = dtype == torch.float64
                k1.append(compare("K1", lambda: cuda_cheb.chebdiff_last(u, scale),
                                  lambda: cuda_cheb.chebdiff_last_ref(u, scale), u,
                                  f"{shape} curved", timed=f64))
                if f64:
                    n = shape[-1]
                    dt = cuda_cheb._diffmat_t(n, None, dtype, dev)
                    k1[-1]["library_ms"], k1[-1]["library_call_ms"] = both_ms(
                        lambda: torch.matmul(u, dt))
                    k1[-1]["bound_ms"], k1[-1]["bound_by"] = bound(
                        2 * u.numel() * 8 + n * n * 8, 2 * n * u.numel(), "float64")
                if f64 and not k1[-1]["bitwise"]:
                    rows = u.reshape(-1, shape[-1])
                    ref = cuda_cheb.chebdiff_last_ref(torch.cat([rows] * 8), scale)
                    k1[-1]["bitwise_stacked"] = bool(torch.equal(
                        cuda_cheb.chebdiff_last(u, scale), ref[:len(rows)].reshape(shape)))
                    require(k1[-1]["bitwise_stacked"],
                            f"K1 {shape} float64: not bit for bit its plain version")
        u = randn((256, 64, 64, 64), torch.float32, 99)   # the cheb_matvec shape
        k1.append(compare("K1", lambda: cuda_cheb.chebdiff_last(u),
                          lambda: cuda_cheb.chebdiff_last_ref(u), u, "(256, 64, 64, 64)"))
        k1[-1]["grid"] = cuda_cheb.chebdiff_last_grid(u)
        dt = cuda_cheb._diffmat_t(64, None, torch.float32, dev)
        k1[-1]["library_ms"], k1[-1]["library_call_ms"] = both_ms(lambda: torch.matmul(u, dt))
        k1[-1]["bound_ms"], k1[-1]["bound_by"] = bound(2 * u.numel() * 4 + 64 * 64 * 4,
                                                       2 * 64 * u.numel(), "float32")
        del u
        # the dense assemblies' batched shapes (phases 11c, 12d, 12e): K1 bit for
        # bit its plain version, on the tensor and under torch.func.vmap (one launch)
        from spectral_tpu_torch.ops.chebyshev import chebdiff

        for seed, shape in enumerate(K1_BATCHED_SHAPES + K1_FAMILY_SHAPES):
            u = randn(shape, torch.float64, 100 + seed)
            k1.append(compare("K1", lambda: cuda_cheb.chebdiff_last(u),
                              lambda: cuda_cheb.chebdiff_last_ref(u), u, f"{shape} batched"))
            cuda_cheb.reset_launch_counts()
            got = torch.func.vmap(lambda x: chebdiff(x, -1))(u)
            require(cuda_cheb.LAUNCHES["chebdiff_last_kernel"] == 1, "K1 under vmap: not one launch")
            require(k1[-1]["bitwise"] and torch.equal(got, cuda_cheb.chebdiff_last_ref(u)),
                    f"K1 {shape} float64: not bit for bit its plain version")
            n = shape[-1]
            dt = cuda_cheb._diffmat_t(n, None, torch.float64, dev)
            k1[-1]["vmap_bitwise"] = True
            k1[-1]["library_ms"], k1[-1]["library_call_ms"] = both_ms(lambda: torch.matmul(u, dt))
            k1[-1]["bound_ms"], k1[-1]["bound_by"] = bound(2 * u.numel() * 8 + n * n * 8,
                                                           2 * n * u.numel(), "float64")
            del u, got
        print("phase1 K1 " + json.dumps(k1))
        print(f"phase1 seconds {time.perf_counter() - t_phase:.3f}")

    # -- phase 2: K2 against its plain version --------------------------------
    if 2 in phases:
        t_phase = time.perf_counter()
        k2 = []
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype)[6:]
            u = randn((12, 10, 8), dtype, 1)
            k2.append(compare("K2", lambda: cuda_cheb.laplacian3d(u),
                              lambda: cuda_cheb.laplacian3d_ref(u), u, "(12, 10, 8)"))
            # non-cubic fields with sizes not all multiples of 4 (ny * nz = 99: the
            # x pass's scalar copies and stores) and a field the plane pass takes
            # unpadded, untimed
            for dims, scales, timed in (((20, 12, 10), (0.25, 1.0, 4.0), False),
                                        ((13, 11, 9), None, False),
                                        ((64, 48, 40), (2.0, 0.5, 1.0), False),
                                        (K2_UNPADDED[dname], (0.5, 2.0, 1.0), False),
                                        ((8, 8, 8), None, True),
                                        ((64, 64, 64), (0.25, 1.0, 4.0), True),
                                        ((64, 64, 64), None, True)):
                u = randn(dims, dtype, 2)
                mask = Grid(dims, device=dev).boundary_mask
                k2.append(compare("K2", lambda: cuda_cheb.laplacian3d(u, mask, scales),
                                  lambda: cuda_cheb.laplacian3d_ref(u, mask, scales), u,
                                  f"{dims} bmask scales={scales}", timed=timed))
                got = cuda_cheb.laplacian3d(u, mask, scales)
                require(torch.equal(got[mask], u[mask]), f"K2 {dims}: boundary rows are not u")
                grid = cuda_cheb.laplacian3d_grid(u)
                tiled = cuda_cheb.laplacian3d_plane_tiled(dims, u.element_size())
                require(grid["plane"]["tiled"] == tiled == (dims != K2_UNPADDED[dname]),
                        f"K2 {dims} {dname}: plane pass tiled {grid['plane']['tiled']}")
                k2[-1]["plane_tiled"] = tiled
                if not timed:
                    continue
                for name, g in grid.items():
                    inst = DTYPE_C[str(dtype)] + (", true" if name == "plane" else "")
                    regs = ptxas[f"laplacian3d_{name}_kernel<{inst}>"]["registers"]
                    g.update(registers=regs, blocks_per_sm=blocks_per_sm(regs, g))
                own = kernel_ms(lambda: cuda_cheb.laplacian3d(u, mask, scales))
                # each pass against its own plain version, on the same inputs
                d2x, d2y, d2zt = cuda_cheb._d2_ops(dims, cuda_cheb._scales3(scales), dtype, dev)
                t, y = cuda_cheb._laplacian3d(u, mask, scales)
                nx, ny, nz = dims
                pts, isz = u.numel(), u.element_size()
                passes = {  # output, plain version, bytes moved, FLOPs
                    "plane": (t, lambda: torch.matmul(u, d2zt) + torch.matmul(d2y, u),
                              2 * pts * isz + (ny * ny + nz * nz) * isz, 2 * (ny + nz) * pts),
                    "x": (y, lambda: torch.where(mask, u, -(t + torch.tensordot(d2x, u,
                                                                                dims=([1], [0])))),
                          pts * (3 * isz + 1) + nx * nx * isz, 2 * nx * pts)}
                for name, (out, plain, nbytes, flops) in passes.items():
                    ref = plain()
                    abs_err = float(torch.max(torch.abs(out - ref)))
                    rel = abs_err / float(torch.max(torch.abs(ref)))
                    require(rel <= BOUND[dname], f"K2 {dims} {name} pass: error {rel:.3e}")
                    kname = f"laplacian3d_{name}_kernel"
                    passes[name] = dict(zip(("bound_ms", "bound_by"), bound(nbytes, flops, dname)),
                                        case=f"{k2[-1]['case']}, {name} pass", dtype=dname,
                                        rel_err=rel, max_abs_err=abs_err, library_ms=None,
                                        ms=sum(v for k, v in own.items() if k.startswith(kname + "<")),
                                        plain_ms=device_ms(plain))
                del t, y, ref
                k2[-1].update(grid=grid, kernel_ms=own, passes=passes)
                # u read, y written, the mask read, three operators; 2 (nx + ny + nz) FLOP a point
                k2[-1]["bound_ms"], k2[-1]["bound_by"] = bound(
                    pts * (2 * isz + 1) + (nx * nx + ny * ny + nz * nz) * isz,
                    2 * (nx + ny + nz) * pts, dname)
        print("phase2 K2 " + json.dumps(k2))
        print(f"phase2 seconds {time.perf_counter() - t_phase:.3f}")

    # Each path runs with the counts set to 0 just before it and is read
    # just after; the kernels line sums the paths.  K1's launches by shape
    # and dtype, per path: k1_shapes[path name].
    # K1's transposed launches (its reverse mode, K1^T) count under K1's
    # name and, by shape, in k1t_shapes[path name].
    launches = {name: 0 for name in cuda_cheb.LAUNCHES}
    readme52 = None   # phase 8's README:52 (problem, continuation), phase 13b's state
    k1_shapes, k1t_shapes = {}, {}

    def path(name, fn, kernels):
        cuda_cheb.reset_launch_counts()
        out = fn()
        counts = dict(cuda_cheb.LAUNCHES)
        for shapes, seen in ((k1_shapes, cuda_cheb.K1_LAUNCHES_BY_SHAPE),
                             (k1t_shapes, cuda_cheb.K1T_LAUNCHES_BY_SHAPE)):
            shapes[name] = {f"{tuple(shape)} {str(dtype)[6:]}": c
                            for (shape, dtype), c in seen.items()}
        for k in kernels:
            require(counts[k] > 0, f"{name}: the path did not launch {k}")
        for k, v in counts.items():
            launches[k] += v
        return out, counts

    K1, K3 = "chebdiff_last_kernel", "chebdiff_packed_kernel"
    K2P, K2X = "laplacian3d_plane_kernel", "laplacian3d_x_kernel"

    # -- phase 3: Poisson path A, the CLI in float64 --------------------------
    if 3 in phases:
        t_phase = time.perf_counter()
        argv = ["poisson", "-m", "64", "-n", "64", "-p", "64", "-ksp_rtol", "1e-10"]
        ((rc, out), first_s, warm_s), counts = path(
            "phase3", lambda: timed_twice(lambda: run_cli(cli_main, argv)), [K1])
        m = re.search(r"Norm of error (\S+) iterations (\d+)", out)
        require(rc == 0 and m is not None, f"CLI failed (rc {rc}): {out!r}")
        err, iters = float(m.group(1)), int(m.group(2))
        require(err <= 1e-10, f"CLI error {err:.3e} > 1e-10")
        print("phase3 " + json.dumps({"cli": " ".join(argv), "iterations": iters, "error": err,
                                      "first_s": first_s, "solve_s": warm_s,
                                      "k1_launches": counts[K1],
                                      "k1_launches_by_shape": k1_shapes["phase3"],
                                      "seconds": time.perf_counter() - t_phase}))

    # -- phase 4: Poisson path B, mixed precision at 64^3 ---------------------
    if 4 in phases:
        t_phase = time.perf_counter()
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

        b_dev = torch.from_numpy(b).to(dev)
        runs = {
            "refine_solve": lambda: refine_solve(A_hi, inner, b, device=dev, rtol=1e-10,
                                                 max_refine=8),
            "refine_solve_fused": lambda: refine_solve_fused(model.operator, inner, b_dev,
                                                             rtol=1e-10, max_refine=8),
        }

        def poisson_b():
            phase = {}
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
                phase[name] = {"refine_steps": out.refine_steps, "inner_iters": out.inner_iters,
                               "rel_residual": rel, "error": err, "first_s": first_s,
                               "solve_s": warm_s}
            return phase

        phase4, counts = path("phase4", poisson_b, [K2P, K2X])
        phase4["k2_launches"] = {K2P: counts[K2P], K2X: counts[K2X]}
        phase4["seconds"] = time.perf_counter() - t_phase
        print("phase4 " + json.dumps(phase4))
        del g, model, M, b_dev

    # -- phase 5: the K3 sweep (exp_pallas.py::main) --------------------------
    if 5 in phases:
        t_phase = time.perf_counter()
        k3 = []
        for dtype in (torch.float32, torch.float64):
            branches = set()
            for seed, (rows, n, pack, blk, off) in enumerate(K3_CASES):
                u = randn((off + rows * n * pack,), dtype, 10 + seed)[off:].view(rows, n * pack)
                branch = "bulk" if cuda_cheb.chebdiff_packed_bulk(u, pack) else "sync"
                branches.add(branch)
                k3.append(compare("K3", lambda: cuda_cheb.chebdiff_packed(u, pack, K3_SCALE, blk),
                                  lambda: cuda_cheb.chebdiff_packed_ref(u, pack, K3_SCALE), u,
                                  f"({rows}, {n * pack}) pack={pack} blk={blk} offset={off}",
                                  timed=False))
                k3[-1]["branch"] = branch
            require(branches == {"bulk", "sync"}, f"K3 {dtype}: branches taken {branches}")
        print("phase5 K3 " + json.dumps(k3))
        u = randn((1 << 20, 64), torch.float32, 98)   # 256 x 64^3 dofs, exp_pallas.py main
        dofs = u.numel()
        dt = cuda_cheb._diffmat_t(64, K3_SCALE, torch.float32, dev)
        library_ms, library_call_ms = both_ms(lambda: torch.matmul(u, dt))
        k3_bound = bound(2 * dofs * 4 + 64 * 64 * 4, 2 * 64 * dofs, "float32")
        # the same values one element into a buffer: K3's synchronous branch
        u_sync = torch.empty(dofs + 1, device=dev, dtype=torch.float32)[1:].view_as(u)
        u_sync.copy_(u)
        sweep, stages = {}, {}

        def k3_sweep():   # the path: every case once in each branch, checked
            for pack in (1, 2):
                u2d, s2d = u.view(-1, 64 * pack), u_sync.view(-1, 64 * pack)
                ref = cuda_cheb.chebdiff_packed_ref(u2d, pack, K3_SCALE)
                for blk in cuda_cheb.K3_BLOCK_ROWS:
                    c = {"case": f"(1048576, 64) as ({dofs // (64 * pack)}, {64 * pack}) "
                                 f"pack={pack} blk={blk}", "dtype": "float32"}
                    for branch, x in (("bulk", u2d), ("sync", s2d)):
                        require(cuda_cheb.chebdiff_packed_bulk(x, pack) == (branch == "bulk"),
                                f"K3 sweep pack={pack} blk={blk}: not the {branch} branch")
                        got = cuda_cheb.chebdiff_packed(x, pack, K3_SCALE, blk)
                        abs_err = float(torch.max(torch.abs(got - ref)))
                        rel = abs_err / float(torch.max(torch.abs(ref)))
                        require(rel <= BOUND["float32"],
                                f"K3 sweep pack={pack} blk={blk} {branch}: error {rel:.3e}")
                        key = "" if branch == "bulk" else "sync_"
                        c.update({f"{key}rel_err": rel, f"{key}max_abs_err": abs_err})
                    sweep[(pack, blk)] = c

        _, counts = path("phase5", k3_sweep, [K3])
        # timed after the path
        for (pack, blk), c in sweep.items():
            u2d, s2d = u.view(-1, 64 * pack), u_sync.view(-1, 64 * pack)
            c["plain_ms"] = device_ms(lambda: cuda_cheb.chebdiff_packed_ref(u2d, pack, K3_SCALE))
            c["sync_ms"] = device_ms(lambda: cuda_cheb.chebdiff_packed(s2d, pack, K3_SCALE, blk))
            # the ring depth: every cap up to what fits (the wrapper takes K3_MAX_STAGES)
            fit = cuda_cheb.chebdiff_packed_stages(64, pack, blk, 4, max_stages=1 << 20)
            stages[f"pack={pack} blk={blk}"] = {
                "fit": fit, "default": cuda_cheb.chebdiff_packed_stages(64, pack, blk, 4),
                "ms": {str(k): device_ms(lambda: cuda_cheb._chebdiff_packed(
                    u2d, pack, K3_SCALE, blk, k))
                       for k in sorted({1, 2, 3, 4, 6, 8, 12, 16, 24, fit}) if k <= fit}}
        del u_sync
        for key, (ms, call) in k3_sweep_ms(cuda_cheb, u).items():
            sweep[key].update(ms=ms, call_ms=call, gdofs=dofs / ms / 1e6)
        # occupancy computed from ptxas's registers and the shared memory taken:
        # blocks an SM by the 64K registers (9 warps a block, each taking
        # registers in units of 256) and by the 228 KB of shared memory (1 KB
        # reserved a block)
        for (pack, blk), c in sweep.items():
            regs = ptxas[f"chebdiff_packed_kernel<float, {blk}, true>"]["registers"]
            smem = cuda_cheb.chebdiff_packed_smem_bytes(64, pack, blk, 4)
            c.update(library_ms=library_ms, bound_ms=k3_bound[0], bound_by=k3_bound[1],
                     registers=regs, smem=smem,
                     stages=cuda_cheb.chebdiff_packed_stages(64, pack, blk, 4),
                     blocks_per_sm=blocks_per_sm(regs, {"threads": 288, "smem": smem}))
        print("phase5 sweep " + json.dumps({"library_gdofs": dofs / library_ms / 1e6,
                                            "library_ms": library_ms,
                                            "library_call_ms": library_call_ms,
                                            "k3_launches": counts[K3],
                                            "cases": list(sweep.values()), "stages": stages,
                                            "seconds": time.perf_counter() - t_phase}))
        del u, u2d, s2d
        torch.cuda.empty_cache()

    # -- phase 6: the elliptic CLI in float64, gated on the CPU oracle --------
    if 6 in phases:
        t_phase = time.perf_counter()
        phase6 = {}
        for name, (opts, newton_its, krylov, error) in ELLIPTIC_ORACLE.items():
            argv = ["elliptic", *opts]
            ((rc, out), first_s, warm_s), counts = path(
                f"phase6 {name}", lambda: timed_twice(lambda: run_cli(cli_main, argv),
                                                      warm_reps=1), [K1])
            mn = re.search(r"Number of nonlinear iterations = (\d+)", out)
            mk = re.search(r"KSP iterations per Newton step: \[([\d, ]*)\]", out)
            me = re.search(r"Norm of error\s*: abs = (\S+)", out)
            require(rc == 0 and mn and mk and me, f"elliptic {name} failed (rc {rc}): {out!r}")
            its = int(mn.group(1))
            kits = [int(k) for k in mk.group(1).split(",")]
            err = float(me.group(1))
            require(its == newton_its, f"elliptic {name}: {its} Newton steps, oracle {newton_its}")
            require(len(kits) == len(krylov) and all(abs(a - b) <= 1 for a, b in zip(kits, krylov)),
                    f"elliptic {name}: Krylov {kits}, oracle {krylov} (within 1 each)")
            require(err <= 2 * error, f"elliptic {name}: error {err:.3e} > 2 x {error:.3e}")
            phase6[name] = {"cli": " ".join(argv), "newton": its, "krylov": kits, "error": err,
                            "first_s": first_s, "solve_s": warm_s, "k1_launches": counts[K1],
                            "k1_launches_by_shape": k1_shapes[f"phase6 {name}"]}
        phase6["seconds"] = time.perf_counter() - t_phase
        print("phase6 " + json.dumps(phase6))

    # -- phase 7: mixed-precision Newton (float32 Newton, float64 refinement) --
    if 7 in phases:
        # gates and bands: ELLIPTIC_REFINED
        t_phase = time.perf_counter()
        phase7 = {}
        for name, (run, u_np) in refined_runs(dev).items():
            spec = ELLIPTIC_REFINED[name]
            ((x, info), first_s, warm_s), counts = path(
                f"phase7 {name}", lambda: timed_twice(run, warm_reps=1), [K1])
            res32 = info["newton32"]
            total = sum(res32.ksp_iters) + info["refine_inner_iters"]
            err = float(np.max(np.abs(x - u_np)))
            rel = info["rel_residual"]
            max_err = spec["max_error"](rel)
            require(res32.reason > 0, f"{name}: float32 Newton did not converge ({res32.reason_str()})")
            require(rel <= 1e-10, f"{name}: rel residual {rel:.3e} > 1e-10")
            require(err <= max_err, f"{name}: error {err:.3e} > {max_err:.3e}")
            require(spec["newton"][0] <= res32.iters <= spec["newton"][1],
                    f"{name}: {res32.iters} Newton steps outside {spec['newton']}")
            require(spec["krylov"][0] <= total <= spec["krylov"][1],
                    f"{name}: {total} Krylov iterations outside {spec['krylov']}")
            phase7[name] = {"newton": res32.iters, "krylov": res32.ksp_iters,
                            "refine_inner": info["refine_inner_iters"], "total_krylov": total,
                            "refine_history": info["refine_history"], "rel_residual": rel,
                            "error": err, "max_error": max_err, "first_s": first_s,
                            "solve_s": warm_s, "k1_launches": counts[K1],
                            "k1_launches_by_shape": k1_shapes[f"phase7 {name}"]}
        phase7["seconds"] = time.perf_counter() - t_phase
        print("phase7 " + json.dumps(phase7))

    # -- phase 8: Stokes on the card (STOKES_ORACLE) --------------------------
    if 8 in phases:
        t_phase = time.perf_counter()
        phase8 = {}
        for name in ("README:43", "README:52"):   # 8a, 8b: the CLI in float64
            argv = ["stokes", *STOKES_ORACLE[name]["argv"]]
            with captured_continuation() as got:   # 13b differentiates at README:52's
                ((rc, out), first_s, warm_s), counts = path(
                    f"phase8 {name}", lambda: timed_twice(lambda: run_cli(cli_main, argv),
                                                          warm_reps=int(name == "README:43")),
                    [K1])
            if name == "README:52":
                readme52 = (got["problem"], got["results"])
            mc = re.search(r"Continuation steps: Newton (\[.*\])  Krylov (\[.*\])", out)
            mr = re.search(r"Reason for solver termination: (\S+)", out)
            me = re.search(r"Norm of error\s*: abs = (\S+)", out)
            require(rc == 0 and mc and mr and me, f"stokes {name} failed (rc {rc}): {out!r}")
            newton, krylov = json.loads(mc.group(1)), json.loads(mc.group(2))
            err = float(me.group(1))
            require(mr.group(1) == "CONVERGED_RTOL", f"stokes {name}: {mr.group(1)}")
            why = stokes_cli_ok(name, newton, krylov, err)
            require(why is None, f"stokes {name}: {why}")
            phase8[name] = {"cli": " ".join(argv), "newton": newton, "krylov": krylov,
                            "total_krylov": sum(map(sum, krylov)), "reason": mr.group(1),
                            "error": err, "first_s": first_s, "solve_s": warm_s,
                            "k1_launches": counts[K1],
                            "k1_launches_by_shape": k1_shapes[f"phase8 {name}"]}
        # 8c: entry()'s forward step at 32^3, float64 then float32
        for dtype, gate in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
            name = f"entry {str(dtype)[6:]}"
            forward = stokes_forward(dev, dtype)
            (F, JF), counts = path(f"phase8 {name}", forward, [K1])
            norms = {k: float(torch.sqrt(sum(torch.sum(t.double() ** 2) for t in y.values())))
                     for k, y in (("F", F), ("JF", JF))}
            rel = {k: abs(v / STOKES_ORACLE["entry"][k] - 1.0) for k, v in norms.items()}
            require(all(torch.isfinite(t).all() for y in (F, JF) for t in y.values()),
                    f"{name}: non-finite output")
            require(F["v"].shape == (32, 32, 32, 3) and JF["p"].shape == (32, 32, 32),
                    f"{name}: shapes {F['v'].shape}, {JF['p'].shape}")
            require(max(rel.values()) <= gate, f"{name}: norms {norms}, rel {rel} > {gate}")
            phase8[name] = {"norms": norms, "rel_err": rel, "k1_launches": counts[K1],
                            "k1_launches_by_shape": k1_shapes[f"phase8 {name}"]}
            # timed after the path
            phase8[name]["device_ms"], phase8[name]["call_ms"] = both_ms(forward)
            del F, JF
        # 8d: mixed precision, float32 continuation and Newton, float64 host residuals
        refined_x = {}   # 9d holds the fused power law to this solution
        for name, prob in stokes_refined_runs(dev).items():
            ((x, info), first_s, warm_s), counts = path(
                f"phase8 {name}", lambda: timed_twice(lambda: prob.solve_refined(rtol=1e-10),
                                                      warm_reps=0),
                [K1])
            rel, err = info["rel_residual"], prob.error_vs_exact(x)
            ref = STOKES_ORACLE[name]["error"]
            require(rel <= 1e-10, f"{name}: rel residual {rel:.3e} > 1e-10")
            if name == "refined linear":
                # the float64 floor of the discrete problem (STOKES_ORACLE): 7x the
                # port's CPU value, far under the 2.8e-7 an unrefined rtol 1e-10 solve leaves
                require(err <= 1e-12, f"{name}: error {err:.3e} > 1e-12")
            else:
                require(abs(err - ref) <= 1e-6 * ref, f"{name}: error {err!r}, oracle {ref!r}")
            refined_x[name] = x
            res = info["continuation"]
            phase8[name] = {"newton": [r.iters for r in res], "krylov": [r.ksp_iters for r in res],
                            "reasons": [r.reason_str() for r in res],
                            "refine_history": info["refine_history"],
                            "refine_inner": info["refine_inner_iters"], "rel_residual": rel,
                            "error": err, "first_s": first_s, "solve_s": warm_s,
                            "k1_launches": counts[K1],
                            "k1_launches_by_shape": k1_shapes[f"phase8 {name}"]}
        phase8["seconds"] = time.perf_counter() - t_phase
        print("phase8 " + json.dumps(phase8))

    # -- phase 9: the rest of the Stokes flagship (STOKES_ORACLE) -------------
    if 9 in phases:
        t_phase = time.perf_counter()
        phase9 = {}

        def record(name, counts, first_s, warm_s, **out):
            phase9[name] = {**out, "first_s": first_s, "solve_s": warm_s,
                            "k1_launches": counts[K1],
                            "k1_launches_by_shape": k1_shapes[f"phase9 {name}"]}

        for name in ("neumann tbc 20^3", "neumann free 12^3"):   # 9a: the CLI in float64
            argv = ["stokes", *STOKES_ORACLE[name]["argv"]]
            ((rc, out), first_s, warm_s), counts = path(
                f"phase9 {name}", lambda: timed_twice(lambda: run_cli(cli_main, argv),
                                                      warm_reps=0), [K1])
            mc = re.search(r"Continuation steps: Newton (\[.*\])  Krylov (\[.*\])", out)
            mr = re.search(r"Reason for solver termination: (\S+)", out)
            me = re.search(r"Norm of error\s*: abs = (\S+)", out)
            require(rc == 0 and mc and mr and me, f"stokes {name} failed (rc {rc}): {out!r}")
            newton, krylov = json.loads(mc.group(1)), json.loads(mc.group(2))
            err = float(me.group(1))
            why = stokes_phase9_ok(name, newton, krylov, [mr.group(1)], err)
            require(why is None, f"stokes {name}: {why}")
            record(name, counts, first_s, warm_s, cli=" ".join(argv), newton=newton, krylov=krylov,
                   reason=mr.group(1), error=err, oracle_krylov=STOKES_ORACLE[name]["krylov"])
        # 9b: the API in float64 at 16^2, one call each (the script's time limit)
        for name, prob in stokes_mixed_runs(dev).items():
            (res, first_s, warm_s), counts = path(
                f"phase9 {name}", lambda: timed_twice(prob.solve, warm_reps=0), [K1])
            err = prob.error_vs_exact(res.x)
            why = stokes_phase9_ok(name, [res.iters], [res.ksp_iters], [res.reason_str()], err)
            require(why is None, f"stokes {name}: {why}")
            record(name, counts, first_s, warm_s, newton=res.iters, krylov=res.ksp_iters,
                   reason=res.reason_str(), error=err, oracle_krylov=STOKES_ORACLE[name]["krylov"])
        # 9c: README:52 with the line-smoothed multigrid, the API in float64, one
        # call (~100 s; the script stays under 600 s with phase 10)
        name, spec, prob = "line52", STOKES_ORACLE["line52"], stokes_line52(dev)
        (res, first_s, warm_s), counts = path(
            f"phase9 {name}", lambda: timed_twice(prob.solve_continuation, warm_reps=0), [K1])
        newton, krylov = [r.iters for r in res], [r.ksp_iters for r in res]
        total, err = sum(map(sum, krylov)), prob.error_vs_exact(res[-1].x)
        require(all(r.reason > 0 for r in res), f"{name}: {[r.reason_str() for r in res]}")
        require(newton == spec["newton"], f"{name}: Newton {newton}, oracle {spec['newton']}")
        require(max(map(max, krylov)) <= spec["max_krylov"],
                f"{name}: Krylov {krylov}, a step over the JAX test's {spec['max_krylov']}")
        require(abs(total - spec["total"]) <= 0.2 * spec["total"],
                f"{name}: total Krylov {total}, oracle {spec['total']} (20%)")
        require(abs(err - spec["error"]) <= 1e-6 * spec["error"],
                f"{name}: error {err!r}, oracle {spec['error']!r} (1e-6 relative)")
        record(name, counts, first_s, warm_s, newton=newton, krylov=krylov, total_krylov=total,
               reasons=[r.reason_str() for r in res], error=err, oracle_krylov=spec["krylov"])
        del prob, res
        # 9d: the fused tier in bench.py's stokes20 configurations (phase 8d's gates)
        for name, prob in stokes_refined_runs(dev).items():
            fname = name.replace("refined", "fused")
            ((x, info), first_s, warm_s), counts = path(
                f"phase9 {fname}", lambda: timed_twice(lambda: prob.solve_refined_fused(
                    rtol=1e-10, fused_continuation=fname == "fused powerlaw"),
                    warm_reps=int(fname == "fused linear")), [K1])
            rel, err = info["rel_residual"], prob.error_vs_exact(x)
            require(rel <= 1e-10, f"{fname}: rel residual {rel:.3e} > 1e-10")
            dv = None
            if fname == "fused linear":
                # from zero, the last refine step leaves rel ~3e-13 and error ~5e-12
                # (the JAX package's own 5.2e-12, STOKES_ORACLE): within 2x of it
                ref = STOKES_ORACLE[fname]["error"]
                require(err <= 2 * ref, f"{fname}: error {err:.3e} > 2 x {ref:.3e}")
            else:
                ref = STOKES_ORACLE[name]["error"]
                require(abs(err - ref) <= 1e-6 * ref, f"{fname}: error {err!r}, oracle {ref!r}")
                # the JAX test's rule (tests/test_refined_fused.py:137-139)
                dv = float(np.max(np.abs(x["v"] - refined_x[name]["v"])))
                require(dv <= 1e-7, f"{fname}: velocity {dv:.3e} off phase 8d's solve_refined")
            res = info["continuation"]
            record(fname, counts, first_s, warm_s, newton=[r.iters for r in res],
                   krylov=[r.ksp_iters for r in res], reasons=[r.reason_str() for r in res],
                   refine_steps=info["refine_steps"], refine_history=info["refine_history"],
                   refine_inner=info["refine_inner_iters"], rel_residual=rel, error=err,
                   velocity_vs_refined=dv, oracle=STOKES_ORACLE[fname])
        phase9["seconds"] = time.perf_counter() - t_phase
        print("phase9 " + json.dumps(phase9))

    # -- phase 10: Q1 and probed PCs, grid sequencing, singular values ---------
    if 10 in phases:
        t_phase = time.perf_counter()
        phase10_out = phase10(cli_main, path)
        for name, rec in phase10_out.items():
            rec["k1_launches_by_shape"] = k1_shapes[name]
        phase10_out["seconds"] = time.perf_counter() - t_phase
        print("phase10 " + json.dumps(phase10_out))

    # -- phase 11: the dense tier, time stepping, heat and unsteady Stokes -----
    if 11 in phases:
        t_phase = time.perf_counter()
        phase11_out = phase11(cli_main, path, k1_shapes)
        phase11_out["seconds"] = time.perf_counter() - t_phase
        print("phase11 " + json.dumps(phase11_out))

    # -- phase 12: thermal convection and the Krylov-Schur eigensolver ----------
    if 12 in phases:
        t_phase = time.perf_counter()
        phase12_out = phase12(cli_main, path, k1_shapes)
        phase12_out["seconds"] = time.perf_counter() - t_phase
        print("phase12 " + json.dumps(phase12_out))

    # -- phase 13: the differentiable tier --------------------------------------
    if 13 in phases:
        t_phase = time.perf_counter()
        phase13_out, k1t_timed = Phase13(path, k1_shapes, k1t_shapes, readme52).run(
            parts & PARTS13)
        phase13_out["seconds"] = time.perf_counter() - t_phase
        print("phase13 " + json.dumps(phase13_out))

    # -- phase 14: the solver families ----------------------------------------------
    if 14 in phases:
        t_phase = time.perf_counter()
        phase14_out = phase14(cli_main, path, k1_shapes)
        phase14_out["seconds"] = time.perf_counter() - t_phase
        print("phase14 " + json.dumps(phase14_out))

    # -- phase 15: curved domains ----------------------------------------------------
    if 15 in phases:
        t_phase = time.perf_counter()
        phase15_out = phase15(cli_main, path, k1_shapes)
        phase15_out["seconds"] = time.perf_counter() - t_phase
        print("phase15 " + json.dumps(phase15_out))

    # -- phase 16: batched and parallel solves -----------------------------------
    if 16 in phases:
        t_phase = time.perf_counter()
        phase16(path, k1_shapes, launches, parts)   # prints a line a run
        print("phase16 " + json.dumps({"seconds": time.perf_counter() - t_phase}))

    # -- phase 17: sharded solves -------------------------------------------------
    if 17 in phases:
        t_phase = time.perf_counter()
        phase17_out = phase17(path, k1_shapes, launches, parts & PARTS17)
        phase17_out["seconds"] = time.perf_counter() - t_phase
        print("phase17 " + json.dumps(phase17_out))

    # -- phase 18: the utilities ----------------------------------------------------
    if 18 in phases:
        t_phase = time.perf_counter()
        phase18_out = phase18(cli_main, path, k1_shapes)
        phase18_out["seconds"] = time.perf_counter() - t_phase
        print("phase18 " + json.dumps(phase18_out))

    if mode == "worker":   # the parent adds these to its own
        print("worker " + json.dumps({"launches": launches, "k1t_shapes": k1t_shapes}))
        return 0
    if mode == "check":   # no kernels line, no result
        print(f"chip_smoke: phases {sorted(phases)} only; no result", file=sys.stderr)
        return 0
    if mode == "full":
        for summary in run_workers(WORKER_GROUPS,
                                   WORKER_DEADLINE_S - (time.monotonic() - t_start)):
            for name, count in summary["launches"].items():
                launches[name] += count
            k1t_shapes.update(summary["k1t_shapes"])
    # -- the kernels line ------------------------------------------------------
    k1_main = next(c for c in k1 if c["case"] == "(64, 64, 64) scale=None"
                   and c["dtype"] == "float64")
    k2_main = next(c for c in k2 if c["case"] == "(64, 64, 64) bmask scales=None"
                   and c["dtype"] == "float32")["passes"]   # no PyTorch call computes either
    k3_main = min(sweep.values(), key=lambda c: c["ms"])
    kernels = []
    for name, c in ((K1, k1_main), (K2P, k2_main["plane"]), (K2X, k2_main["x"]), (K3, k3_main)):
        require(launches[name] > 0, f"{name} was not launched by its path")
        kernels.append({"name": name, "route": "cuda", "source": SOURCE,
                        "replaces": REPLACES[name], "launches": launches[name],
                        "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                        "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                        "bound_by": c["bound_by"], "library_ms": c["library_ms"],
                        "case": f"{c['case']} {c['dtype']}"})
    # K1^T: the same kernel with s D as its right factor, its launches those
    # of the reverse-mode passes (phase 13), timed at (256,64,64,64) f32
    k1t_main = k1t_timed[0]
    k1t_launches = sum(sum(v.values()) for v in k1t_shapes.values())
    require(k1t_launches > 0, "K1^T was not launched by its paths")
    kernels.append({"name": K1 + " (K1^T, reverse mode)", "route": "cuda", "source": SOURCE,
                    "replaces": REPLACES[K1], "launches": k1t_launches,
                    "max_abs_err": k1t_main["max_abs_err"], "ms": k1t_main["ms"],
                    "plain_ms": k1t_main["plain_ms"], "bound_ms": k1t_main["bound_ms"],
                    "bound_by": k1t_main["bound_by"], "library_ms": k1t_main["library_ms"],
                    "case": f"{k1t_main['case']} {k1t_main['dtype']}"})
    print(json.dumps({"kernels": kernels}))
    print(f"chip_smoke: {time.monotonic() - t_start:.1f} s in all", file=sys.stderr)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
