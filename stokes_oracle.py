#!/usr/bin/env python3
"""The JAX package's Stokes numbers on the CPU: the oracle that
``chip_smoke.py`` phases 8 and 9 (``STOKES_ORACLE``) hold the port to.

    JAX_PLATFORMS=cpu python3 stokes_oracle.py [section ...]

Sections (all by default), each one JSON line:

- ``cli43``, ``cli52``: README:43 (linear) and README:52 (power law)
  through the JAX package's ``stokes`` driver at 20^3 in float64: Newton
  and Krylov counts per continuation step, reason, error, seconds;
- ``perturb``: README:52 again from a zero state plus masked normal noise
  of 1e-13 (seeds 0-7) and 1e-11 (seed 0): how far the Krylov counts move
  under a round-off size change of the start (the Newton counts and the
  error do not move);
- ``entry``: ``__graft_entry__.entry()``'s forward step at 32^3, the
  2-norms over both fields of F and of J F, float64 and float32;
- ``refined``: ``solve_refined`` in ``bench.py``'s
  ``bench_stokes20_linear`` and ``bench_stokes20_powerlaw``
  configurations, x64 off (float32 device arithmetic, as the bench runs);
- ``neumann3d``: README:43's solver options with Neumann boundaries
  (``-boundary 1``) through the ``stokes`` driver in float64: the
  physical-traction rows with the traction-block correction at 20^3
  (``-exact 1 -traction_p 1 -tbc 1``) and the reference's pressure-free
  rows at 12^3 (``-exact 2``; at 16^3 and above the JAX package
  stagnates on them);
- ``mixed2d``: the mixed and Neumann configurations of
  ``tests/test_stokes.py`` at 16^2 in float64 (boundary 2; boundary 5
  and 6 with ``traction_p``, boundary 6 with ``tbc=1``; boundary 2 with
  the multigrid velocity PC): counts, reasons, error;
- ``perturb2d``: the two boundary-2 solves of ``mixed2d`` again from a
  zero state plus masked normal noise of 1e-13 (seeds 0-7) and 1e-11
  (seed 0): their Krylov counts move with the round-off of the start;
- ``line52``: README:52 through ``solve_continuation`` with the
  line-smoothed eta-aware multigrid velocity PC
  (``test_stokes_20cubed_powerlaw_fixture``'s configuration, float64);
- ``fused``: ``solve_refined_fused`` in ``bench.py``'s
  ``bench_stokes20_fused`` and ``bench_stokes20_powerlaw_fused``
  configurations, x64 off for the float32 stages;
- ``q1``: the Q1 and probed velocity PCs, grid sequencing and the
  singular-value estimate through the ``stokes`` driver at 20^3 in
  float64: README:43 with ``-pcvel 1``, ``-pcvel q1sep`` and ``-pcvel 2``,
  README:52 with ``-pcvel 1`` and with ``-snes_grid_sequence 1`` (the
  continuation on the coarse level, then the 20^3 solve, whose own counts
  are in ``final_solve``), README:43 with ``-ksp_compute_singularvalues``
  (its printed extremes in ``singular_values``);
- ``q1cpu8``: README:43 at 8x8 with ``-pcvel 1``, ``q1sep`` and ``2``,
  the counts, error and printed lines that
  ``tests/test_torch_stokes_q1.py`` holds the port's CLI to;
- ``perturb_probed``, ``perturb_sv``, ``perturb_q1fem52``,
  ``perturb_gseq52``: README:43 with ``-pcvel 2``, README:43 with
  ``-ksp_compute_singularvalues``, README:52 with ``-pcvel 1`` and with
  ``-snes_grid_sequence 1``, each from a zero state plus masked normal
  noise of 1e-13 (seeds 0-7) and 1e-11 (seed 0), as ``perturb`` runs
  README:52; ``--seeds a-b`` runs the perturbed sections from 1e-13
  noise of seeds a to b instead (more samples of a wide spread).
- ``convection``: the JAX package's ``convection`` driver in float64 on
  the command lines of ``chip_smoke.py``'s phase 12 (``CONVECTION``:
  Blankenbach case 1a marched with the dense saddle PC, 10 steps on the
  nested one, the 3/2-rule advection, ``-ts_adapt``, ``-newton``,
  ``-stability 2``): the printed lines, the numbers they carry, and the
  eigenvalues, matrix-vector counts and Newton history captured as it runs;
  then bench.py's variable-viscosity configuration (``var_eta``);
- ``convcpu8``: four of the convection driver's command lines at 8x8
  (``-nsteps``, ``-newton``, ``-stability 1``, 15 steps of ``-ts_adapt``), the printed lines and
  full-precision numbers that ``tests/test_torch_convection.py`` holds
  the port's CLI to, then ``-newton`` from initial temperatures perturbed
  by 1e-13 (seeds 0-7).
- ``adjoint``: the differentiable tier at the sizes of the JAX package's
  own tests, the gradients and adjoint counts that
  ``tests/test_torch_adjoint.py`` holds the port to:
  ``test_stokes_adjoint_gradient_preconditioned`` (10x10, the gradient
  in every PowerLawParams field and the adjoint FGMRES count),
  ``test_transient_adjoint_matches_finite_differences`` (8x8, 3 CN
  steps), ``test_checkpointed_adjoint_bounded_memory`` (8x8, 12 steps,
  both adjoints and the checkpointed one's info) and
  ``test_rollout_diff_adjoint_gradients`` (8x8, 3 steps, contrast 3, the
  nested PC: the gradient in Ra, the contrast and a T0 direction);
- ``adjoint52``: README:52 through the ``stokes`` driver at 20^3 in
  float64, then ``adjoint_gradient`` of sum(v^2) at its converged state in
  the final PowerLawParams (the nested ``make_pc(adjoint=True)``): the
  gradient and the adjoint FGMRES count that ``chip_smoke.py`` phase 13b
  holds the port's count to; ``perturb_adjoint52`` the same from the
  perturbed starts of ``perturb`` (the forward counts move with them, and
  so does the adjoint count).
- ``solvers``: the paths of ``chip_smoke.py``'s phase 14 (``SOLVERS_ORACLE``):
  the elliptic driver in phase 6's 32^3 mg3 configuration with each
  ``-snes_type``, the Poisson driver at 64^3 with each short-recurrence
  Krylov type, MINRES on ``chip_smoke.py``'s ``minres_factors`` saddle system, Newton
  with ``NewtonConfig(recycle=8)`` at 32^3, README:52's continuation with
  recycling, and Blankenbach 1a by Anderson acceleration (``-accel``),
  ~5 min; ``solvers_perturbed`` the counts phase 14 gates by range, from
  perturbed starts (1e-13, seeds 0-7; 1e-11, seed 0), ~35 min;
- ``recycle12``: the recycled Stokes pair at 12^3 that
  ``tests/test_torch_gpu.py`` holds the card to, from the zero state and
  from perturbed starts; a few minutes.
- ``curved``: the paths of ``chip_smoke.py``'s phase 15 (``CURVED_ORACLE``):
  the mapped 64^3 Poisson solves, the ``poisson``, ``elliptic``,
  ``stokes`` and ``heat`` command lines with ``-map``, the refined and
  FAS elliptic solves, bench.py's curved Stokes trio, the 20^2 parity
  pair, the nodal and q1fem velocity PCs, the curved-Neumann cell (the
  command line and ``solve_refined_fused``) and the unsteady rollout;
  ``CURVED_PARTS`` splits it into parts a process can take
  (``python3 -c 'import stokes_oracle as s; ...'``); ``curvedcpu`` the
  lines of ``CURVED_CPU``'s small command lines (stokes and ustokes with
  ``-map``), which ``tests/test_torch_curvilinear.py`` holds the port's
  CLI to.
- ``family``: the batched solves of ROADMAP item 7a (``solve_family``
  flat and curved at 10^2, ``family_rollout`` at 10^2, bench.py's
  family8 at 16^2): Newton counts and reasons (``FAMILY_ORACLE`` of
  ``chip_smoke.py`` phase 16, ``tests/test_torch_family.py``) and the 10^2
  solutions, written to ``tests/data/torch_family_oracle.npz``.
- ``parallel``: the single-device results of the JAX package's sharded
  tests (``tests/test_parallel.py``, which show sharded equal to single
  device) whose live run would not fit the CPU test budget: the 12^2
  Stokes solve, 2 x 2's (12, 12, 8), the curved 12^2 with the metric
  multigrid, the curved annulus Poisson (16 x 12, mg and jacobi), the
  elliptic 16 x 12 Newton solve (fastdiag, jacobi, mg, and mg on
  ``bump:0.08``), the unsteady step, the convection step and the traced-dt step; counts and
  solutions, written to ``tests/data/torch_parallel_oracle.npz``
  (``tests/test_torch_parallel.py``).
- ``march``: the checkpointed adaptive march at 8x8 (``MARCH``, the dense
  saddle PC): 20 steps saving every 10, the step-20 files kept in
  ``tests/data/torch_march_checkpoint/``, then the run resumed from them
  to step 40: its counts, steps and temperature, written to
  ``tests/data/torch_march_oracle.npz`` (``tests/test_torch_utils.py``);
  ~10 s.
- ``clioutputs``: the JAX drivers with the output options at 8x8
  (``CLI_OUTPUTS``): ``stokes`` with ``-checkpoint_dir``, ``-output_vtk``
  and ``-log_summary``, then resumed after deleting its last step;
  ``ustokes`` and ``convection`` with ``-output_vtk``.  Their printed
  lines (the SNESSolve row's times left out), continuation counts,
  checkpoint metas and VTK files, written to
  ``tests/data/torch_cli_outputs/`` (``tests/test_torch_utils.py``);
  ~45 s, nearly all of it compiles.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

README43 = ["-exact", "2", "-cont0", "1", "-schur_ksp_max_it", "3", "-vel_ksp_max_it", "4",
            "-svel_ksp_type", "preonly", "-ksp_type", "fgmres", "-dim", "20,20,20",
            "-ksp_rtol", "1e-10"]
README52 = ["-exact", "2", "-cont", "4", "-rheology", "1", "-eps", "1e-4", "-exponent", "3",
            "-schur_ksp_max_it", "3", "-vel_ksp_max_it", "4", "-svel_ksp_type", "preonly",
            "-ksp_type", "fgmres", "-dim", "20,20,20"]


def _counts(results) -> dict:
    return {"newton": [int(r.iters) for r in results],
            "krylov": [[int(k) for k in r.ksp_iters] for r in results],
            "reasons": [r.reason_str() for r in results]}


def run_cli(argv, perturb: float = 0.0, seed: int = 0) -> dict:
    """The JAX stokes driver on ``argv``; its continuation results, and
    the last Newton solve it ran (``final_solve``: the fine solve of a grid
    sequence), are captured as it runs.  ``perturb`` adds masked normal
    noise of that size (from ``seed``) to the zero state the continuation
    starts from."""
    from spectral_tpu.cli.drivers import stokes_main
    from spectral_tpu.models.stokes import StokesProblem
    from spectral_tpu.utils.options import Options

    captured, solves = [], []
    orig_cont, orig_zero = StokesProblem.solve_continuation, StokesProblem.zero_state
    orig_solve = StokesProblem.solve

    def cont(self, *a, **kw):
        captured.extend(orig_cont(self, *a, **kw))
        return captured

    def solve(self, *a, **kw):
        solves.append(orig_solve(self, *a, **kw))
        return solves[-1]

    def zero(self):
        z = orig_zero(self)
        if not perturb:
            return z
        rng = np.random.default_rng(seed)
        return {"v": self.mask_v(z["v"] + perturb * jnp.asarray(
            rng.standard_normal(z["v"].shape))), "p": z["p"]}

    StokesProblem.solve_continuation, StokesProblem.zero_state = cont, zero
    StokesProblem.solve = solve
    try:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = stokes_main(Options(argv))
        seconds = time.perf_counter() - t0
    finally:
        StokesProblem.solve_continuation, StokesProblem.zero_state = orig_cont, orig_zero
        StokesProblem.solve = orig_solve
    out = buf.getvalue()
    err = float(out.split("Norm of error")[1].split("abs =")[1].split()[0])
    sv = [ln.split()[-5::2] for ln in out.splitlines()
          if ln.startswith("Iteratively computed extreme singular values")]
    return {"argv": " ".join(argv), "rc": rc, "perturb": perturb, "seed": seed,
            **_counts(captured),
            "total_krylov": sum(sum(k) for k in _counts(captured)["krylov"]),
            "final_solve": _counts(solves[-1:]),
            "singular_values": dict(zip(("max", "min", "cond"), map(float, sv[0])))
            if sv else None,
            "error": err, "seconds": seconds, "lines": out.splitlines()}


def entry_norms() -> dict:
    """||F|| and ||J F|| of entry()'s forward step at zero_state()."""
    from __graft_entry__ import entry

    out = {}
    for name, x64 in (("float64", True), ("float32", False)):
        with jax.enable_x64(x64):
            fn, args = entry()
            y = jax.jit(fn)(*args)
            nrm = lambda t: float(np.sqrt(sum(np.sum(np.asarray(a, np.float64) ** 2)  # noqa: E731
                                              for a in jax.tree_util.tree_leaves(t))))
            out[name] = {"F": nrm(y["F"]), "JF": nrm(y["JF"])}
    return out


def refined() -> dict:
    """solve_refined in the two bench configurations, x64 off."""
    from spectral_tpu.grid import Grid
    from spectral_tpu.models.stokes import StokesConfig, StokesProblem
    from spectral_tpu.solvers.krylov import KSPConfig
    from spectral_tpu.solvers.newton import NewtonConfig

    cfgs = {"linear": dict(exact=2, cont0=1),
            "powerlaw": dict(exact=2, rheology=1, cont=4, regularization=1e-4, exponent=3.0,
                             pcvel="mg",
                             outer_ksp=KSPConfig(type="fgmres", rtol=1e-5, max_it=120,
                                                 restart=60),
                             newton=NewtonConfig(rtol=2e-4, max_it=30, ksp_ew=True))}
    out = {}
    for name, kw in cfgs.items():
        with jax.enable_x64(False):
            p = StokesProblem(Grid((20, 20, 20)), StokesConfig(**kw))
            t0 = time.perf_counter()
            x, info = p.solve_refined(rtol=1e-10)
            seconds = time.perf_counter() - t0
        pm = np.asarray(p.p_mask)
        dp = np.where(pm, x["p"] - p.exact_p_np, 0.0)
        dp -= np.where(pm, dp.sum() / pm.sum(), 0.0)
        err = max(float(np.max(np.abs(x["v"] - p.exact_v_np))), float(np.max(np.abs(dp))))
        out[name] = {**_counts(info["continuation"]), "refine_history": info["refine_history"],
                     "refine_inner": info["refine_inner_iters"],
                     "rel_residual": info["rel_residual"], "error": err, "seconds": seconds}
    return out


CLI43_SOLVER = ["-cont0", "1", "-schur_ksp_max_it", "3", "-vel_ksp_max_it", "4",
                "-svel_ksp_type", "preonly", "-ksp_type", "fgmres", "-ksp_rtol", "1e-10"]
NEUMANN3D = {
    "tbc 20^3": ["-exact", "1", "-boundary", "1", "-traction_p", "1", "-tbc", "1",
                 "-dim", "20,20,20", *CLI43_SOLVER],
    "free 12^3": ["-exact", "2", "-boundary", "1", "-dim", "12,12,12", *CLI43_SOLVER],
}


def _mixed_configs() -> dict:
    """name -> StokesConfig keywords of the 16^2 mixed/Neumann solves
    (tests/test_stokes.py:382, :409, :458; boundary 2 on a V-cycle)."""
    from spectral_tpu.solvers.krylov import KSPConfig
    from spectral_tpu.solvers.newton import NewtonConfig

    b2 = dict(exact=2, boundary=2, cont0=1,
              outer_ksp=KSPConfig(type="fgmres", rtol=1e-8, max_it=400, restart=100),
              newton=NewtonConfig(rtol=1e-8, max_it=10))
    man = dict(outer_ksp=KSPConfig(type="fgmres", rtol=1e-12, max_it=800, restart=200),
               newton=NewtonConfig(rtol=1e-10, max_it=20))
    return {"boundary 2": b2,
            "boundary 5": dict(exact=1, boundary=5, traction_p=True, **man),
            "boundary 6 tbc": dict(exact=1, boundary=6, traction_p=True, tbc=1,
                                   **dict(man, outer_ksp=KSPConfig(
                                       type="fgmres", rtol=1e-12, max_it=400, restart=200))),
            "boundary 2 mg": dict(b2, pcvel="mg")}


def mixed2d(names=None, starts=((0.0, 0),)) -> list:
    """The 16^2 solves ``names`` (all by default), each from the zero
    state plus masked normal noise of each (size, seed) in ``starts``."""
    from spectral_tpu.grid import Grid
    from spectral_tpu.models.stokes import StokesConfig, StokesProblem

    out = []
    for name, kw in _mixed_configs().items():
        if names and name not in names:
            continue
        p = StokesProblem(Grid((16, 16)), StokesConfig(**kw))
        for perturb, seed in starts:
            z = p.zero_state()
            rng = np.random.default_rng(seed)
            x0 = {"v": p.mask_v(z["v"] + perturb * jnp.asarray(
                rng.standard_normal(z["v"].shape))), "p": z["p"]}
            t0 = time.perf_counter()
            res = p.solve(x0)
            seconds = time.perf_counter() - t0
            out.append({"name": name, "perturb": perturb, "seed": seed, **_counts([res]),
                        "error": float(p.error_vs_exact(res.x)), "seconds": seconds})
    return out


def line52() -> dict:
    from spectral_tpu.grid import Grid
    from spectral_tpu.models.stokes import StokesConfig, StokesProblem
    from spectral_tpu.solvers.krylov import KSPConfig

    cfg = StokesConfig(exact=2, rheology=1, cont=4, regularization=1e-4, exponent=3.0,
                       pcvel="mg", pcvel_smoother="line",
                       vel_ksp=KSPConfig(type="gmres", rtol=1e-5, max_it=6, restart=6))
    p = StokesProblem(Grid((20, 20, 20)), cfg)
    t0 = time.perf_counter()
    results = p.solve_continuation()
    seconds = time.perf_counter() - t0
    c = _counts(results)
    return {**c, "total_krylov": sum(map(sum, c["krylov"])),
            "error": float(p.error_vs_exact(results[-1].x)), "seconds": seconds}


def fused() -> dict:
    """solve_refined_fused in the two bench configurations, x64 off for
    the float32 stages (the refinement switches it on itself)."""
    from spectral_tpu.grid import Grid
    from spectral_tpu.models.stokes import StokesConfig, StokesProblem
    from spectral_tpu.solvers.krylov import KSPConfig
    from spectral_tpu.solvers.newton import NewtonConfig

    cfgs = {"linear": (dict(exact=2, cont0=1), False),
            "powerlaw": (dict(exact=2, rheology=1, cont=4, regularization=1e-4, exponent=3.0,
                              pcvel="mg",
                              outer_ksp=KSPConfig(type="fgmres", rtol=1e-5, max_it=120,
                                                  restart=60),
                              newton=NewtonConfig(rtol=2e-4, max_it=30, ksp_ew=True)), True)}
    out = {}
    for name, (kw, fc) in cfgs.items():
        with jax.enable_x64(False):
            p = StokesProblem(Grid((20, 20, 20)), StokesConfig(**kw))
            t0 = time.perf_counter()
            x, info = p.solve_refined_fused(rtol=1e-10, fused_continuation=fc)
            seconds = time.perf_counter() - t0
        pm = np.asarray(p.p_mask)
        dp = np.where(pm, x["p"] - p.exact_p_np, 0.0)
        dp -= np.where(pm, dp.sum() / pm.sum(), 0.0)
        err = max(float(np.max(np.abs(x["v"] - p.exact_v_np))), float(np.max(np.abs(dp))))
        out[name] = {**_counts(info["continuation"]), "refine_history": info["refine_history"],
                     "refine_steps": info["refine_steps"],
                     "refine_inner": info["refine_inner_iters"],
                     "rel_residual": info["rel_residual"], "error": err, "seconds": seconds}
    return out


Q1_STOKES = {
    "README:43 pcvel 1": [*README43, "-pcvel", "1"],
    "README:43 pcvel q1sep": [*README43, "-pcvel", "q1sep"],
    "README:43 pcvel 2": [*README43, "-pcvel", "2"],
    "README:52 pcvel 1": [*README52, "-pcvel", "1"],
    "README:52 grid sequence 1": [*README52, "-snes_grid_sequence", "1"],
    "README:43 singular values": [*README43, "-ksp_compute_singularvalues"],
}
# README:43's options at 8x8: what tests/test_torch_stokes_q1.py holds the
# port's stokes CLI to (Q1_CPU8 there)
Q1_CPU8 = {f"README:43 8x8 pcvel {p}":
           [*README43[:-4], "-dim", "8,8", "-ksp_rtol", "1e-10", "-pcvel", p]
           for p in ("1", "q1sep", "2")}


SEEDS = None   # --seeds a-b: the perturbed sections' 1e-13 starts from seeds a..b only


def perturbed(argv):
    """``argv`` from the zero state plus masked noise of 1e-13 (seeds 0-7)
    and 1e-11 (seed 0), or of 1e-13 from SEEDS, one run at a time; the
    compiled programs of a run are dropped after it (each run compiles its
    own)."""
    starts = ([(1e-13, seed) for seed in range(8)] + [(1e-11, 0)] if SEEDS is None
              else [(1e-13, seed) for seed in SEEDS])
    for size, seed in starts:
        yield run_cli(argv, size, seed)
        jax.clear_caches()


# The heat and ustokes command lines of UNSTEADY_ORACLE (chip_smoke.py)
HEAT = {
    "heat 16^2": ["-dim", "16,16", "-dt", "0.01", "-nsteps", "20"],
    "heat 64^3 cn": ["-dim", "64,64,64", "-dt", "0.01", "-nsteps", "20"],
    "heat 64^3 bdf2": ["-dim", "64,64,64", "-dt", "0.01", "-nsteps", "20", "-ts_type", "bdf2"],
    "heat 64^3 adapt": ["-dim", "64,64,64", "-dt", "0.01", "-nsteps", "20", "-ts_adapt"],
}
USTOKES20 = ["-dim", "20,20,20", "-dt", "0.05"]
USTOKES = {
    "ustokes 12^2": ["-dim", "12,12", "-dt", "0.05", "-nsteps", "10"],
    "ustokes 20^3 cn": [*USTOKES20, "-nsteps", "10"],
    "ustokes 20^3 bdf2": [*USTOKES20, "-nsteps", "10", "-scheme", "bdf2"],
    "ustokes 20^3 powerlaw": [*USTOKES20, "-nsteps", "5", "-rheology", "1", "-exponent", "3"],
    "ustokes 16^3 powerlaw bdf2": ["-dim", "16,16,16", "-dt", "0.05", "-nsteps", "5",
                                   "-rheology", "1", "-exponent", "3", "-scheme", "bdf2"],
    "ustokes 16^3 dense-device": ["-dim", "16,16,16", "-dt", "0.05", "-nsteps", "10",
                                  "-saddle_pc", "dense-device"],
    "ustokes 12^3 dense": ["-dim", "12,12,12", "-dt", "0.05", "-nsteps", "10",
                           "-saddle_pc", "dense"],
    "ustokes 12^3 cn": ["-dim", "12,12,12", "-dt", "0.05", "-nsteps", "10"],
    "ustokes 12^3 no_scan": ["-dim", "12,12,12", "-dt", "0.05", "-nsteps", "10", "-no_scan"],
}


def run_unsteady(name, argv, perturb: float = 0.0, seed: int = 0) -> dict:
    """The JAX heat or ustokes driver on ``argv``: its error and printed
    counts, and the per-step outer counts of every ``UnsteadyStokes.rollout``
    it ran.  ``perturb`` adds masked normal noise of that size (from
    ``seed``) to the unknowns of the manufactured start."""
    from spectral_tpu.cli.drivers import heat_main, unsteady_stokes_main
    from spectral_tpu.models.stokes_unsteady import UnsteadyStokes
    from spectral_tpu.utils.options import Options

    rollouts = []
    orig_roll, orig_man = UnsteadyStokes.rollout, UnsteadyStokes.manufactured

    def roll(self, *a, **kw):
        out = orig_roll(self, *a, **kw)
        rollouts.append([int(i) for i in out[2]])
        return out

    def man(self, omega=1.0):
        u0, *rest = orig_man(self, omega)
        if perturb:
            rng = np.random.default_rng(seed)
            u0 = u0 + perturb * self.problem.mask_v(jnp.asarray(rng.standard_normal(u0.shape)))
        return (u0, *rest)

    UnsteadyStokes.rollout, UnsteadyStokes.manufactured = roll, man
    try:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = (heat_main if name.startswith("heat") else unsteady_stokes_main)(Options(argv))
        seconds = time.perf_counter() - t0
    finally:
        UnsteadyStokes.rollout, UnsteadyStokes.manufactured = orig_roll, orig_man
    out = buf.getvalue()
    err = float(re.search(r"Norm of error.*?([-+\d.]+e[-+]\d+)", out).group(1))
    row = {"name": name, "argv": " ".join(argv), "rc": rc, "perturb": perturb, "seed": seed,
           "error": err, "seconds": seconds}
    m = re.search(r"ts_adapt: (\d+) accepted steps, (\d+) rejected, dt (\S+) \.\. (\S+)", out)
    if m:
        row.update(accepted=int(m.group(1)), rejected=int(m.group(2)),
                   dt_min=float(m.group(3)), dt_max=float(m.group(4)))
    m = re.search(r"Outer iterations per step: min (\d+)  max (\d+)", out)
    if m:
        row.update(outer_min=int(m.group(1)), outer_max=int(m.group(2)))
    if rollouts:
        row["per_step"] = rollouts[-1]
    return row


def unsteady():
    """Every HEAT and USTOKES row, then perturbed_unsteady()."""
    for name, argv in {**HEAT, **USTOKES}.items():
        yield run_unsteady(name, argv)
        jax.clear_caches()
    yield from perturbed_unsteady()


def perturbed_unsteady():
    """The 20^3 power-law rollout from perturbed starts (SEEDS, or 0-7),
    then the 20^3 linear CN and BDF2 rollouts (SEEDS, or 0-15), one run
    at a time."""
    for name, seeds in (("ustokes 20^3 powerlaw", range(8)), ("ustokes 20^3 cn", range(16)),
                        ("ustokes 20^3 bdf2", range(16))):
        for seed in (SEEDS if SEEDS is not None else seeds):
            yield run_unsteady(name, USTOKES[name], 1e-13, seed)
            jax.clear_caches()


# The convection command lines of CONVECTION_ORACLE (chip_smoke.py phase 12)
BLANKENBACH = ["-dim", "16,16", "-ra", "1e4", "-dt", "5e-4", "-bc", "freeslip", "-sides",
               "insulated"]
CONVECTION = {
    "12a blankenbach": [*BLANKENBACH, "-steady_tol", "1e-3", "-stokes_pc", "dense"],
    "12a nested": [*BLANKENBACH, "-nsteps", "10"],
    "12a dealias": ["-dim", "12,12", "-ra", "1e4", "-dt", "5e-4", "-bc", "freeslip", "-sides",
                    "insulated", "-nsteps", "20", "-stokes_pc", "dense", "-dealias", "1"],
    "12a adapt": ["-ts_adapt", "-dim", "12,12", "-ra", "5e3", "-dt", "1e-3", "-ts_dt0", "2e-5",
                  "-steady_tol", "1e-4", "-stokes_pc", "dense"],
    "12b newton": [*BLANKENBACH, "-steady_tol", "1e-3", "-stokes_pc", "dense", "-newton"],
    "12c stability": ["-stability", "2", "-dim", "12,12", "-ra", "2000", "-stokes_pc", "dense"],
}
# what tests/test_torch_convection.py holds the port's CLI to
CONVECTION_CPU8 = {
    "8x8 nsteps": ["-dim", "8,8", "-nsteps", "10", "-stokes_pc", "dense"],
    "8x8 newton": ["-dim", "8,8", "-newton", "-warmup", "50", "-stokes_pc", "dense"],
    "8x8 stability": ["-dim", "8,8", "-stability", "1", "-stokes_pc", "dense"],
    "8x8 adapt": ["-ts_adapt", "-dim", "8,8", "-ra", "5e3", "-dt", "1e-3", "-ts_dt0", "2e-5",
                  "-max_steps", "15", "-stokes_pc", "dense"],
}
VAR_ETA_STEPS = 6   # phase 12e's rollout length


def run_convection(name, argv, perturb: float = 0.0, seed: int = 0) -> dict:
    """The JAX convection driver on ``argv``: its printed lines and the
    numbers they carry, with every EPSResult and NewtonResult it made and
    the full-precision diagnostics of its run (``info``) captured as it
    ran.  ``perturb`` adds masked normal noise of that size (from
    ``seed``) to the initial temperature."""
    from spectral_tpu.cli.drivers import convection_main
    from spectral_tpu.models.convection import ConvectionModel
    from spectral_tpu.solvers import eig, newton
    from spectral_tpu.utils.options import Options

    eps, newtons, infos, andersons = [], [], [], []
    orig_eigs, orig_newton, orig_anderson = eig.eigs, newton.newton_solve, newton.anderson_solve
    M = ConvectionModel
    marchers = ("march_to_steady", "march_adaptive", "steady_newton", "steady_accelerated")
    orig = {k: getattr(M, k) for k in (*marchers, "rollout", "conductive_state")}

    def eigs(*a, **kw):
        eps.append(orig_eigs(*a, **kw))
        return eps[-1]

    def newton_solve(*a, **kw):
        newtons.append(orig_newton(*a, **kw))
        return newtons[-1]

    def anderson_solve(*a, **kw):
        andersons.append(orig_anderson(*a, **kw))
        return andersons[-1]

    def marcher(key):
        def run(self, *a, **kw):
            T, x, info = orig[key](self, *a, **kw)
            infos.append({k: float(info[k]) for k in ("nu_top", "nu_bottom", "vrms")})
            return T, x, info
        return run

    def rollout(self, *a, **kw):
        T, N, x = orig["rollout"](self, *a, **kw)
        infos.append({"nu_top": float(self.nusselt_top(T)),
                      "nu_bottom": float(self.nusselt_bottom(T)), "vrms": float(self.vrms(x))})
        return T, N, x

    def conductive_state(self, *a, **kw):
        T = orig["conductive_state"](self, *a, **kw)
        if perturb:
            noise = np.random.default_rng(seed).standard_normal(T.shape)
            T = T + perturb * self.grid.zero_boundary(jnp.asarray(noise))
        return T

    eig.eigs, newton.newton_solve, newton.anderson_solve = eigs, newton_solve, anderson_solve
    for key in marchers:
        setattr(M, key, marcher(key))
    M.rollout, M.conductive_state = rollout, conductive_state
    try:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = convection_main(Options(argv))
        seconds = time.perf_counter() - t0
    finally:
        eig.eigs, newton.newton_solve = orig_eigs, orig_newton
        newton.anderson_solve = orig_anderson
        for key, fn in orig.items():
            setattr(M, key, fn)
    out = buf.getvalue()
    row = {"name": name, "argv": " ".join(argv), "rc": rc, "perturb": perturb, "seed": seed,
           "seconds": seconds, "lines": out.splitlines(), "info": infos[-1] if infos else None}
    for key, pat in (("steps", r"Steps: (\d+)"), ("nu", r"Nu\(top\) = (\S+)"),
                     ("nu_bottom", r"Nu\(bottom\) = (\S+)"),
                     ("nu_volume", r"Nu\(volume\) = (\S+)"), ("vrms", r"Vrms = (\S+)"),
                     ("ra_c", r"Ra_c = (\S+)")):
        m = re.search(pat, out)
        if m:
            row[key] = (int if key == "steps" else float)(m.group(1))
    m = re.search(r"ts_adapt: (\d+) accepted / (\d+) rejected, dt (\S+) \.\. (\S+)", out)
    if m:
        row.update(accepted=int(m.group(1)), rejected=int(m.group(2)),
                   dt_min=float(m.group(3)), dt_max=float(m.group(4)))
    if newtons:
        r = newtons[-1]
        row.update(newton=int(r.iters), krylov=[int(k) for k in np.asarray(r.ksp_iters)],
                   fnorm=float(r.fnorm), reason=int(r.reason))
    if andersons:
        r = andersons[-1]
        row.update(anderson_iters=int(r.iters), anderson_reason=int(r.reason),
                   anderson_fnorm=[float(f) for f in r.fnorm_history])
    row["eps"] = [{"eigenvalues": [[float(z.real), float(z.imag)] for z in r.eigenvalues],
                   "polished": None if r.eigenvalues_polished is None else
                   [[float(z.real), float(z.imag)] for z in r.eigenvalues_polished],
                   "matvecs": int(r.matvecs), "restarts": int(r.restarts),
                   "converged": bool(r.converged)} for r in eps]
    return row


def var_eta() -> dict:
    """bench.py's bench_convection_var_eta configuration (16^2, Ra 2e3, dt
    2e-4, contrast 10, lag 25), VAR_ETA_STEPS steps with the lagged dense
    PC and with the eta-aware nested tree: Nu, Vrms, and the outer count of
    a fresh solve at the rolled state."""
    from spectral_tpu.models.convection import ConvectionConfig, ConvectionModel
    from spectral_tpu.solvers.krylov import KSPConfig

    row = {"name": "12e var eta", "steps": VAR_ETA_STEPS}
    for pc in ("dense", "nested"):
        cfg = ConvectionConfig(Ra=2e3, dt=2e-4, velocity_bc="freeslip", side_bc="insulated",
                               eta_contrast=10.0, stokes_pc=pc, stokes_pc_lag=25,
                               stokes_ksp=KSPConfig(type="fgmres", rtol=1e-6, max_it=120,
                                                    restart=60))
        m = ConvectionModel.unit_box((16, 16), cfg)
        t0 = time.perf_counter()
        T, _, x = m.rollout(m.conductive_state(amp=0.05), VAR_ETA_STEPS)
        row[pc] = {"nu": float(m.nusselt_top(T)), "vrms": float(m.vrms(x)),
                   "fresh_outer": int(m.solve_stokes(T, m.stokes.zero_state()).iters),
                   "seconds": time.perf_counter() - t0}
        jax.clear_caches()
    return row


def convection():
    for name, argv in CONVECTION.items():
        yield run_convection(name, argv)
        jax.clear_caches()
    yield var_eta()


def convcpu8():
    """CONVECTION_CPU8's lines, then "8x8 newton" from initial
    temperatures perturbed by 1e-13 (seeds 0-7; SEEDS with --seeds): its
    Krylov counts move with the round-off of the start."""
    for name, argv in CONVECTION_CPU8.items():
        r = run_convection(name, argv)
        yield dict(r, printed=r["lines"])
    for seed in (SEEDS if SEEDS is not None else range(8)):
        yield run_convection("8x8 newton", CONVECTION_CPU8["8x8 newton"], 1e-13, seed)
        jax.clear_caches()


# The paths of chip_smoke.py phase 14 (SOLVERS_ORACLE): the elliptic CLI in
# phase 6's 32^3 configuration with each -snes_type, the Poisson CLI at 64^3
# with each Krylov type, MINRES on chip_smoke.py's saddle system, recycling,
# and Blankenbach case 1a by Anderson acceleration.
ELLIPTIC32 = ["-dim", "32,32,32", "-exact", "0", "-gamma", "1", "-pc_type", "mg3",
              "-snes_rtol", "1e-10", "-debug", "1"]
SNES14 = {
    "newtontr": ["-snes_type", "newtontr"],
    "qn": ["-snes_type", "qn"],
    "anderson": ["-snes_type", "anderson"],
    "ngmres": ["-snes_type", "ngmres"],
    "ngmres npc": ["-snes_type", "ngmres", "-npc_snes_type", "newtonls"],
    "fas": ["-snes_type", "fas"],
}
POISSON64 = ["-m", "64", "-n", "64", "-p", "64", "-ksp_rtol", "1e-10"]
KSP14 = {
    "bcgs": ["-ksp_type", "bcgs"],
    "richardson": ["-ksp_type", "richardson"],
    "chebyshev": ["-ksp_type", "chebyshev"],
    "chebyshev bounds": ["-ksp_type", "chebyshev", "-ksp_chebyshev_eigenvalues", "0.5,5"],
}
ACCEL = [*BLANKENBACH, "-steady_tol", "1e-3", "-stokes_pc", "dense", "-accel"]


def run_elliptic(name, argv, perturb: float = 0.0, seed: int = 0) -> dict:
    """The JAX elliptic driver on ``argv``: the counts, reason, error and
    fnorm history of the solve it ran.  ``perturb`` starts the solve from
    masked normal noise of that size (from ``seed``) instead of zero."""
    from spectral_tpu.cli import drivers
    from spectral_tpu.utils.options import Options

    got, orig = [], drivers._snes_solve

    def snes(opts, model, make_model, b, dirichlet, x0, **kw):
        if perturb:
            noise = np.random.default_rng(seed).standard_normal(model.grid.dims)
            x0 = model.grid.zero_boundary(perturb * jnp.asarray(noise))
        got.append(orig(opts, model, make_model, b, dirichlet, x0, **kw))
        return got[-1]

    drivers._snes_solve = snes
    try:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = drivers.elliptic_main(Options(argv))
        seconds = time.perf_counter() - t0
    finally:
        drivers._snes_solve = orig
    out, r = buf.getvalue(), got[-1]
    return {"name": name, "argv": " ".join(argv), "rc": rc, "perturb": perturb, "seed": seed,
            "newton": int(r.iters), "krylov": [int(k) for k in np.asarray(r.ksp_iters)],
            "reason": r.reason_str(),
            "error": float(re.search(r"Norm of error\s*: abs = (\S+)", out).group(1)),
            "fnorm_history": [float(f) for f in r.fnorm_history], "seconds": seconds,
            "lines": out.splitlines()}


def run_poisson(name, argv) -> dict:
    """The JAX poisson driver on ``argv``: iterations, reason and error."""
    from spectral_tpu.cli.drivers import poisson_main
    from spectral_tpu.models.poisson import PoissonModel
    from spectral_tpu.utils.options import Options

    got, orig = [], PoissonModel.solve

    def solve(self, *a, **kw):
        got.append(orig(self, *a, **kw))
        return got[-1]

    PoissonModel.solve = solve
    try:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = poisson_main(Options(argv))
        seconds = time.perf_counter() - t0
    finally:
        PoissonModel.solve = orig
    out, r = buf.getvalue(), got[-1]
    return {"name": name, "argv": " ".join(argv), "rc": rc, "iters": int(r.iters),
            "reason": int(r.reason), "rnorm": float(r.rnorm),
            "error": float(re.search(r"Norm of error (\S+)", out).group(1)), "seconds": seconds}


def minres64() -> dict:
    """MINRES on chip_smoke.py's minres_factors system (phase 14b), rtol
    1e-10, max_it 2000."""
    from chip_smoke import minres_factors
    from spectral_tpu.solvers.krylov import minres

    D, s, G, diag, xstar = minres_factors()
    sD, Gj, dinv = jnp.asarray(s * D), jnp.asarray(G), jnp.asarray(1.0 / diag)

    def K(x):
        v, p = x["v"], x["p"]
        Sv = (v @ sD.T) @ sD + 0.1 * v
        return {"v": Sv + p @ Gj, "p": v @ Gj.T}

    def M(r):
        return {"v": r["v"] * dinv, "p": r["p"]}

    xs = {k: jnp.asarray(a) for k, a in xstar.items()}
    b = K(xs)
    t0 = time.perf_counter()
    res = jax.jit(lambda bb: minres(K, bb, M=M, rtol=1e-10, max_it=2000))(b)
    err = max(float(jnp.max(jnp.abs(res.x[k] - xs[k]))) for k in xs)
    return {"name": "minres 64^3", "iters": int(res.iters), "reason": int(res.reason),
            "rnorm": float(res.rnorm), "error": err, "seconds": time.perf_counter() - t0}


def recycle_elliptic(perturb: float = 0.0, seed: int = 0) -> dict:
    """ELLIPTIC32's Newton solve through EllipticModel.solve with
    NewtonConfig(recycle=8): counts, reason and error."""
    from spectral_tpu.grid import Grid
    from spectral_tpu.models.elliptic import EllipticModel
    from spectral_tpu.solvers.krylov import KSPConfig
    from spectral_tpu.solvers.newton import NewtonConfig

    m = EllipticModel(Grid((32, 32, 32)), gamma=1.0)
    u, b, d = m.setup_problem(exact=0)
    x0 = None
    if perturb:
        x0 = m.grid.zero_boundary(perturb * jnp.asarray(
            np.random.default_rng(seed).standard_normal(m.grid.dims)))
    t0 = time.perf_counter()
    r = m.solve(b, d, x0=x0, ksp=KSPConfig(type="fgmres", rtol=1e-5, max_it=500),
                newton=NewtonConfig(rtol=1e-10, max_it=50, recycle=8), pc_type="mg3")
    return {"name": "recycle elliptic 32^3", "perturb": perturb, "seed": seed,
            "newton": int(r.iters), "krylov": [int(k) for k in np.asarray(r.ksp_iters)],
            "reason": r.reason_str(), "error": float(jnp.max(jnp.abs(r.x - u))),
            "seconds": time.perf_counter() - t0}


def recycle52(perturb: float = 0.0, seed: int = 0) -> dict:
    """README:52 at 20^3 through StokesProblem.solve_continuation with
    NewtonConfig(recycle=8), the stokes driver's README52 configuration
    otherwise; ``perturb`` as run_cli's."""
    from spectral_tpu.grid import Grid
    from spectral_tpu.models.stokes import StokesConfig, StokesProblem
    from spectral_tpu.solvers.krylov import KSPConfig
    from spectral_tpu.solvers.newton import NewtonConfig

    cfg = StokesConfig(exact=2, rheology=1, regularization=1e-4, exponent=3.0, cont=4,
                       outer_ksp=KSPConfig(type="fgmres", rtol=1e-5, max_it=500, restart=50),
                       vel_ksp=KSPConfig(type="gmres", rtol=1e-5, max_it=4, restart=30),
                       svel_ksp=KSPConfig(type="preonly", rtol=1e-5, max_it=10000,
                                          restart=30),
                       schur_ksp=KSPConfig(type="gmres", rtol=1e-5, max_it=3, restart=30),
                       newton=NewtonConfig(rtol=1e-8, max_it=50, recycle=8))
    p = StokesProblem(Grid((20, 20, 20)), cfg)
    orig_zero = StokesProblem.zero_state

    def zero(self):
        z = orig_zero(self)
        rng = np.random.default_rng(seed)
        return {"v": self.mask_v(z["v"] + perturb * jnp.asarray(
            rng.standard_normal(z["v"].shape))), "p": z["p"]}

    if perturb:
        StokesProblem.zero_state = zero
    try:
        t0 = time.perf_counter()
        results = p.solve_continuation()
        seconds = time.perf_counter() - t0
    finally:
        StokesProblem.zero_state = orig_zero
    row = _counts(results)
    return {"name": "recycle README:52 20^3", "perturb": perturb, "seed": seed, **row,
            "total_krylov": sum(sum(k) for k in row["krylov"]),
            "U_dtype": str(results[-1].recycle_U.dtype), "seconds": seconds}


def recycled_stokes12(perturb: float = 0.0, seed: int = 0) -> dict:
    """KSPConfig.solve_recycled on README:43's Stokes Jacobian at 12^3 (a
    dict state, the constant-pressure null space projected), the nested PC,
    FGMRES rtol 1e-8 restart 30: the first solve from F at the zero state
    with no U, the second from F at a seeded masked state with the first's
    harvest (nkeep 8), and the second plainly; tests/test_torch_gpu.py
    holds the card's second count to these.  ``perturb`` adds masked
    normal noise of that size (from ``seed``) to both states."""
    from spectral_tpu.grid import Grid
    from spectral_tpu.models.stokes import StokesConfig, StokesProblem
    from spectral_tpu.solvers.krylov import KSPConfig

    p = StokesProblem(Grid((12, 12, 12)), StokesConfig(
        exact=2, cont0=1, vel_ksp=KSPConfig(type="gmres", rtol=1e-5, max_it=4),
        svel_ksp=KSPConfig(type="preonly"), schur_ksp=KSPConfig(type="gmres", rtol=1e-5,
                                                                max_it=3)))
    residual = p.make_residual(p.params_at(p.config.cont))
    z = p.zero_state()
    rng = np.random.default_rng(5)
    x1 = {"v": p.mask_v(jnp.asarray(rng.standard_normal(z["v"].shape))),
          "p": p.project_p(jnp.asarray(rng.standard_normal(z["p"].shape)))}
    x0 = z
    if perturb:
        noise = np.random.default_rng(seed).standard_normal(z["v"].shape)
        x0 = {"v": p.mask_v(perturb * jnp.asarray(noise)), "p": z["p"]}
        x1 = {"v": x1["v"] + x0["v"], "p": x1["p"]}
    F0, ls = residual(x0)
    F1, _ = residual(x1)
    pcs, pca = p.make_pc()
    st = pcs(x0, ls)
    ksp = KSPConfig(type="fgmres", rtol=1e-8, max_it=200, restart=30)
    A = lambda w: p.jacobian_action(x0, ls, w)  # noqa: E731
    M = lambda r: pca(st, r)  # noqa: E731
    r1, U = ksp.solve_recycled(A, F0, M=M, null_project=p.null_project, U=None, nkeep=8)
    r2, _ = ksp.solve_recycled(A, F1, M=M, null_project=p.null_project, U=U, nkeep=8)
    plain = ksp.solve(A, F1, M=M, null_project=p.null_project)
    return {"name": "recycle stokes 12^3", "perturb": perturb, "seed": seed,
            "iters": [int(r1.iters), int(r2.iters)], "plain_second": int(plain.iters),
            "reasons": [int(r1.reason), int(r2.reason)], "U_dtype": str(U.dtype),
            "U_shape": list(U.shape)}


def solvers():
    for name, opts in SNES14.items():
        yield run_elliptic(name, [*ELLIPTIC32, *opts])
        jax.clear_caches()
    for name, opts in KSP14.items():
        yield run_poisson(name, [*POISSON64, *opts])
    yield minres64()
    yield recycle_elliptic()
    jax.clear_caches()
    yield recycle52()
    jax.clear_caches()
    yield run_convection("14d accel", ACCEL)


def solvers_perturbed():
    """The counts phase 14 gates by range, from starts perturbed by 1e-13
    (seeds 0-7; SEEDS with --seeds) and 1e-11 (seed 0): the elliptic solves
    of SNES14 and the recycled Newton from masked noise of that size, the
    recycled README:52 from run_cli's perturbed zero state, Blankenbach by
    Anderson from a perturbed initial temperature."""
    starts = ([(1e-13, seed) for seed in range(8)] + [(1e-11, 0)] if SEEDS is None
              else [(1e-13, seed) for seed in SEEDS])
    for size, seed in starts:
        for name, opts in SNES14.items():
            yield run_elliptic(name, [*ELLIPTIC32, *opts], size, seed)
        yield recycle_elliptic(size, seed)
        jax.clear_caches()
        yield run_convection("14d accel", ACCEL, size, seed)
        jax.clear_caches()
    for size, seed in starts:
        yield recycle52(size, seed)
        jax.clear_caches()



def recycle12():
    """recycled_stokes12 from the zero state and from starts perturbed by
    1e-13 (seeds 0-7) and 1e-11 (seed 0): the range tests/test_torch_gpu.py
    holds the card's deflated count to."""
    for size, seed in [(0.0, 0)] + [(1e-13, seed) for seed in range(8)] + [(1e-11, 0)]:
        yield recycled_stokes12(size, seed)
        jax.clear_caches()


def _params_row(th) -> dict:
    return {k: float(getattr(th, k)) for k in ("hardness", "exponent", "regularization",
                                                "gamma0")}


def adjoint() -> list:
    """The gradients and adjoint counts of four of the JAX package's
    adjoint tests, at their sizes and options (see the module docstring)."""
    import dataclasses

    from spectral_tpu.grid import Grid
    from spectral_tpu.models.convection import ConvectionConfig, ConvectionModel
    from spectral_tpu.models.rheology import PowerLawParams
    from spectral_tpu.models.stokes import StokesConfig, StokesProblem
    from spectral_tpu.models.stokes_unsteady import UnsteadyStokes
    from spectral_tpu.solvers.krylov import KSPConfig
    from spectral_tpu.solvers.newton import NewtonConfig

    rows = []
    t0 = time.perf_counter()
    cfg = StokesConfig(exact=1, boundary=0, rheology=1, exponent=2.0, regularization=1e-2,
                       pcvel="fastdiag")
    p = StokesProblem(Grid((10, 10)), cfg)
    th0 = PowerLawParams(1.0, cfg.exponent, cfg.regularization, cfg.gamma0)
    out = p.solve(params=th0)
    grad, res = p.adjoint_gradient(lambda x, th: jnp.sum(x["v"] ** 2), out.x, th0)
    rows.append({"name": "stokes 10x10", "grad": _params_row(grad), "iters": int(res.iters),
                 "reason": int(res.reason), "newton": int(out.iters),
                 "seconds": time.perf_counter() - t0})
    jax.clear_caches()

    cfg0 = StokesConfig(exact=1, boundary=0, rheology=1, exponent=3.0, regularization=1e-1,
                        hardness=1.2, pcvel="mg",
                        outer_ksp=KSPConfig(type="fgmres", rtol=1e-12, max_it=600, restart=150),
                        newton=NewtonConfig(rtol=1e-12, max_it=20))
    qoi = lambda v: jnp.sum(v * v)   # noqa: E731
    for name, dt, n in (("transient 8x8", 0.1, 2), ("checkpointed 8x8", 0.05, 12)):
        t0 = time.perf_counter()
        m0 = UnsteadyStokes(Grid((8, 8)), cfg0, dt=dt, theta=0.5)
        u0, s, f, _, _ = m0.manufactured(omega=1.0)
        times = np.arange(n + 1) * dt
        traj, _, its_f = m0.rollout(u0, times, s, f, keep_trajectory=True)
        grad, its = m0.adjoint_gradient(qoi, traj, times, s, f)
        row = {"name": name, "steps": n, "grad": _params_row(grad), "iters": its,
               "forward_iters": its_f, "qoi": float(qoi(traj[-1]))}
        if name.startswith("checkpointed"):
            grad_ck, info = m0.adjoint_gradient_checkpointed(qoi, u0, times, s, f)
            row.update(grad_ck=_params_row(grad_ck), info=info)
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        jax.clear_caches()

    t0 = time.perf_counter()
    ccfg = ConvectionConfig(Ra=3e3, dt=1e-3, eta_contrast=3.0, velocity_bc="freeslip",
                            side_bc="insulated",
                            stokes_ksp=KSPConfig(type="fgmres", rtol=1e-10, max_it=200,
                                                 restart=80),
                            temp_ksp=KSPConfig(type="cg", rtol=1e-12, max_it=120))
    m = ConvectionModel.unit_box((8, 8), ccfg)
    T0 = m.conductive_state(amp=0.05)
    dT = jnp.asarray(np.random.default_rng(3).standard_normal(m.grid.dims) * 0.01)

    def loss(Ra, c, t):
        T, x = m.rollout_diff(T0 + t * dT, 3, Ra=Ra, contrast=c)
        return m.nusselt_top(T) + 1e-2 * m.vrms(x)

    g = jax.grad(loss, argnums=(0, 1, 2))(3e3, 3.0, 0.0)
    rows.append({"name": "rollout_diff 8x8", "steps": 3, "seed": 3,
                 "loss": float(loss(3e3, 3.0, 0.0)),
                 "grad": {"Ra": float(g[0]), "contrast": float(g[1]), "T0": float(g[2])},
                 "seconds": time.perf_counter() - t0})
    jax.clear_caches()
    return rows


def adjoint52(perturb: float = 0.0, seed: int = 0) -> dict:
    """README:52 at 20^3 through the JAX stokes driver, then the adjoint
    gradient of sum(v^2) at its converged state (nested adjoint PC).
    ``perturb`` adds masked normal noise of that size (from ``seed``) to
    the zero state the continuation starts from."""
    from spectral_tpu.cli.drivers import stokes_main
    from spectral_tpu.models.stokes import StokesProblem
    from spectral_tpu.utils.options import Options

    seen = {}
    orig, orig_zero = StokesProblem.solve_continuation, StokesProblem.zero_state

    def cont(self, *a, **kw):
        seen["p"], seen["res"] = self, orig(self, *a, **kw)
        return seen["res"]

    def zero(self):
        z = orig_zero(self)
        if not perturb:
            return z
        rng = np.random.default_rng(seed)
        return {"v": self.mask_v(z["v"] + perturb * jnp.asarray(
            rng.standard_normal(z["v"].shape))), "p": z["p"]}

    StokesProblem.solve_continuation = cont
    StokesProblem.zero_state = zero
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = stokes_main(Options(README52))
        forward_s = time.perf_counter() - t0
    finally:
        StokesProblem.solve_continuation, StokesProblem.zero_state = orig, orig_zero
    p, res = seen["p"], seen["res"]
    th = p.params_at(p.config.cont)
    t0 = time.perf_counter()
    grad, ares = p.adjoint_gradient(lambda x, t: jnp.sum(x["v"] ** 2), res[-1].x, th)
    return {"name": "adjoint README:52 20^3", "rc": rc, "perturb": perturb, "seed": seed,
            **_counts(res), "params": _params_row(th),
            "qoi": float(jnp.sum(res[-1].x["v"] ** 2)), "grad": _params_row(grad),
            "iters": int(ares.iters), "reason": int(ares.reason), "rnorm": float(ares.rnorm),
            "forward_s": forward_s, "adjoint_s": time.perf_counter() - t0}


def perturbed_adjoint52():
    """adjoint52 from the perturbed starts of ``perturbed`` (SEEDS, or
    1e-13 from seeds 0-7 and 1e-11 from seed 0)."""
    starts = ([(1e-13, seed) for seed in range(8)] + [(1e-11, 0)] if SEEDS is None
              else [(1e-13, seed) for seed in SEEDS])
    for size, seed in starts:
        yield adjoint52(size, seed)
        jax.clear_caches()


# -- phase 15: curved domains -------------------------------------------------
# The JAX package's numbers on chip_smoke.py's phase 15 paths (CURVED_ORACLE
# there), float64: 15a the tensor-product axis maps at 64^3, 15b-15d and
# 15f the command lines, 15c the refined and FAS elliptic solves, 15d the
# bench.py bench_stokes_curved trio (float64 here), the 20^2 parity pair
# and the nodal / q1fem velocity PCs at 14^2, 15e the curved-Neumann cell
# (the command line, then solve_refined_fused of its problem), 15g the
# unsteady rollout.
CURVED_CLI = {
    "15b poisson bump 32^3": ("poisson", ["-m", "32", "-n", "32", "-p", "32", "-map", "bump:0.08",
                                          "-ksp_rtol", "1e-10"]),
    "15b poisson annulus 32^2": ("poisson", ["-m", "32", "-n", "32", "-map", "annulus:1:2",
                                             "-ksp_rtol", "1e-10"]),
    "15c elliptic README:69": ("elliptic", ["-dim", "16,16", "-exact", "0", "-gamma", "1",
                                            "-map", "bump:0.08", "-debug", "1"]),
    "15c elliptic 32^3 mg3": ("elliptic", ["-dim", "32,32,32", "-gamma", "1", "-pc_type", "mg3",
                                           "-map", "bump:0.08", "-debug", "1"]),
    "15d stokes README:68": ("stokes", ["-exact", "1", "-dim", "16,16", "-map", "annulus:1:2"]),
    "15d stokes 3d": ("stokes", ["-exact", "1", "-dim", "14,14,14", "-map", "bump:0.06"]),
    "15d stokes powerlaw 3d": ("stokes", ["-exact", "0", "-boundary", "3", "-rheology", "1",
                                          "-exponent", "3", "-eps", "1e-3", "-cont", "2",
                                          "-dim", "10,10,10", "-map", "bump:0.05"]),
    "15e neumann": ("stokes", ["-exact", "1", "-boundary", "1", "-tbc", "1", "-traction_p", "1",
                               "-dim", "20,20", "-map", "bump:0.06", "-ksp_type", "fgmres",
                               "-ksp_rtol", "1e-10"]),
    "15f heat README:70": ("heat", ["-dim", "18,18", "-dt", "0.5", "-theta", "1", "-nsteps", "30",
                                    "-map", "bump:0.08"]),
    "15f heat 24^3": ("heat", ["-dim", "24,24,24", "-theta", "0.5", "-nsteps", "10",
                               "-map", "bump:0.08"]),
}


def run_curved_cli(name, driver, argv) -> dict:
    """The JAX ``driver`` on ``argv``: the printed lines, the error, and
    the counts of the solves it ran (captured as it runs); a stokes run
    also the interior divergence of its solution."""
    from spectral_tpu.cli import drivers
    from spectral_tpu.models.curvilinear import CurvilinearPoisson
    from spectral_tpu.models.stokes import StokesProblem
    from spectral_tpu.utils.options import Options

    got, problems = [], []
    orig_cp, orig_cont = CurvilinearPoisson.solve, StokesProblem.solve_continuation

    def cp_solve(self, *a, **kw):
        got.append(orig_cp(self, *a, **kw))
        return got[-1]

    def cont(self, *a, **kw):
        problems.append(self)
        got.extend(orig_cont(self, *a, **kw))
        return got

    CurvilinearPoisson.solve, StokesProblem.solve_continuation = cp_solve, cont
    main = {"poisson": drivers.poisson_main, "elliptic": drivers.elliptic_main,
            "stokes": drivers.stokes_main, "heat": drivers.heat_main}[driver]
    try:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = main(Options(argv))
        seconds = time.perf_counter() - t0
    finally:
        CurvilinearPoisson.solve, StokesProblem.solve_continuation = orig_cp, orig_cont
    out = buf.getvalue()
    row = {"name": name, "argv": " ".join([driver, *argv]), "rc": rc, "seconds": seconds,
           "lines": out.splitlines()}
    if driver == "poisson":
        m = re.search(r"Norm of error (\S+) iterations (\d+)", out)
        row.update(error=float(m.group(1)), iters=int(m.group(2)), reason=int(got[-1].reason))
    elif driver == "elliptic":
        row.update(newton=int(re.search(r"nonlinear iterations = (\d+)", out).group(1)),
                   reason=re.search(r"termination: (\S+)", out).group(1),
                   krylov=[int(k) for k in re.search(r"per Newton step: \[([\d, ]*)\]",
                                                     out).group(1).split(",")],
                   error=float(re.search(r"Norm of error\s*: abs = (\S+)", out).group(1)))
    elif driver == "stokes":
        p, res = problems[-1], got[-1]
        div = p.divergence(res.x["v"], with_dirichlet=True)
        row.update(**_counts(got), total_krylov=sum(sum(k) for k in _counts(got)["krylov"]),
                   error=float(re.search(r"Norm of error\s*: abs = (\S+)", out).group(1)),
                   divergence=float(jnp.max(jnp.abs(div))))
    else:
        row["error"] = float(re.search(r"Norm of error vs analytic decay (\S+)", out).group(1))
    return row


def _axis_maps(n: int, beta: float = 1.5):
    from spectral_tpu.ops.mapping import AxisMap

    return (AxisMap.tanh_cluster(0.0, 2.0, n, beta), AxisMap.kte(0.0, 1.0, n, 0.9),
            AxisMap.affine(0.0, 1.0, n))


def curved_axis_maps() -> list:
    """15a: PoissonModel on the mapped 64^3 grid (tanh_cluster beta 1.5,
    kte 0.9, affine), fastdiag; mg there fails to build (the 4-node level's
    restricted tanh map is not monotone, recorded as ``mg_error``), so mg
    runs with beta 1.4, the largest tenth that restricts."""
    from spectral_tpu.grid import Grid
    from spectral_tpu.models.poisson import PoissonModel

    rows = []
    for pc, beta in (("fastdiag", 1.5), ("mg", 1.5), ("mg", 1.4)):
        m = PoissonModel(Grid((64, 64, 64), maps=_axis_maps(64, beta)))
        u, f = m.exact_solution()
        t0 = time.perf_counter()
        try:
            r = m.solve(m.rhs(u, f), pc_type=pc)
        except ValueError as e:
            rows.append({"name": f"15a {pc} beta {beta}", "mg_error": str(e)})
            continue
        rows.append({"name": f"15a {pc} beta {beta}", "iters": int(r.iters),
                     "reason": int(r.reason), "error": float(jnp.max(jnp.abs(r.x - u))),
                     "seconds": time.perf_counter() - t0})
    return rows


def curved_elliptic() -> list:
    """15c: EllipticModel.solve_refined at 16^2 bump:0.08 (pc mg), x64 off
    for its float32 stage, as ``refined`` runs bench.py's; FAS at 25^2
    bump:0.08 to rtol 1e-8."""
    from spectral_tpu.grid import Grid
    from spectral_tpu.models.elliptic import EllipticModel
    from spectral_tpu.ops.curvilinear import named_map
    from spectral_tpu.solvers.fas import FASSolver

    t0 = time.perf_counter()
    with jax.enable_x64(False):
        m = EllipticModel(Grid((16, 16)), gamma=1.0, exponent=2.0, phi=named_map("bump:0.08"))
        u, b, dr = m.setup_problem_np(exact=0)
        x, info = m.solve_refined(b, dr, rtol=1e-10, pc_type="mg")
    rows = [{"name": "15c refined", "newton32": int(info["newton32"].iters),
             "newton32_reason": info["newton32"].reason_str(),
             "refine_history": info["refine_history"],
             "refine_inner": info["refine_inner_iters"],
             "rel_residual": info["rel_residual"], "error": float(np.max(np.abs(x - u))),
             "seconds": time.perf_counter() - t0}]

    def factory(dims):
        return EllipticModel(Grid(dims), gamma=1.0, exponent=2.0, phi=named_map("bump:0.08"))

    fm = factory((25, 25))
    u, b, d = fm.setup_problem(exact=0, cos_scale=1.0)
    t0 = time.perf_counter()
    fas = FASSolver(factory, (25, 25), b, d)
    r = fas.solve(rtol=1e-8, max_cycles=60)
    rows.append({"name": "15c fas", "cycles": int(r.iters), "reason": int(r.reason),
                 "error": float(jnp.max(jnp.abs(r.x - u))), "omega": float(fas.omega),
                 "seconds": time.perf_counter() - t0})
    return rows


def curved_stokes() -> list:
    """15d: bench.py's bench_stokes_curved trio in float64 (annulus 8^2
    and 14^2, flat 14^2: exact 1, pcvel mg, Newton rtol 1e-4), the 20^2
    parity pair (the JAX test's configuration) and the nodal and q1fem
    velocity PCs at 14^2 on bump:0.08."""
    from spectral_tpu.grid import Grid
    from spectral_tpu.models.stokes import StokesConfig, StokesProblem
    from spectral_tpu.ops.curvilinear import named_map
    from spectral_tpu.solvers.newton import NewtonConfig

    def one(name, n, spec, **kw):
        t0 = time.perf_counter()
        p = StokesProblem(Grid((n, n)), StokesConfig(exact=1, **kw),
                          phi=named_map(spec) if spec else None)
        r = p.solve()
        return {"name": name, **_counts([r]), "total_krylov": int(np.sum(r.ksp_iters)),
                "error": float(p.error_vs_exact(r.x)), "seconds": time.perf_counter() - t0}

    bench = dict(pcvel="mg", newton=NewtonConfig(rtol=1e-4, max_it=25))
    return [one("15d bench annulus 8", 8, "annulus:1:2", **bench),
            one("15d bench annulus 14", 14, "annulus:1:2", **bench),
            one("15d bench flat 14", 14, None, **bench),
            one("15d parity annulus 20", 20, "annulus:1:2", pcvel="mg"),
            one("15d parity flat 20", 20, None, pcvel="mg"),
            one("15d nodal 14", 14, "bump:0.08", pcvel="nodal"),
            one("15d q1fem 14", 14, "bump:0.08", pcvel="q1fem")]


def curved_fused() -> dict:
    """15e: StokesProblem.solve_refined_fused of the curved-Neumann
    command line's problem (its configuration as the driver builds it),
    the float32 stages with x64 off, as ``fused`` runs bench.py's."""
    from spectral_tpu.cli import drivers
    from spectral_tpu.models.stokes import StokesProblem
    from spectral_tpu.utils.options import Options

    made = []
    orig = StokesProblem.solve_continuation

    def grab(self, *a, **kw):   # the driver's problem; no solve here
        made.append(self)
        raise RuntimeError("captured")

    StokesProblem.solve_continuation = grab
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            try:
                drivers.stokes_main(Options(CURVED_CLI["15e neumann"][1]))
            except RuntimeError:
                pass
    finally:
        StokesProblem.solve_continuation = orig
    cfg = made[-1].config
    from spectral_tpu.grid import Grid
    from spectral_tpu.ops.curvilinear import named_map

    t0 = time.perf_counter()
    try:
        with jax.enable_x64(False):
            p = StokesProblem(Grid((20, 20)), cfg, phi=named_map("bump:0.06"))
            x, info = p.solve_refined_fused(rtol=1e-10)
    except Exception as e:   # recorded: the reference may not run it
        return {"name": "15e fused", "failed": f"{type(e).__name__}: {e}"[:2000],
                "seconds": time.perf_counter() - t0}
    pm = np.asarray(p.p_mask)
    dp = np.where(pm, x["p"] - p.exact_p_np, 0.0)
    if p.has_p_null:
        dp -= np.where(pm, dp.sum() / pm.sum(), 0.0)
    err = max(float(np.max(np.abs(x["v"] - p.exact_v_np))), float(np.max(np.abs(dp))))
    return {"name": "15e fused", "refine_history": info["refine_history"],
            "refine_steps": info["refine_steps"], "refine_inner": info["refine_inner_iters"],
            "rel_residual": info["rel_residual"], "error": err,
            "seconds": time.perf_counter() - t0}


def curved_unsteady() -> dict:
    """15g: UnsteadyStokes on bump:0.05 at 20^2, CN, dt 0.05, 5 steps (the
    JAX test's configuration at 12^2): error, per-step outer counts, the
    discrete divergence of the end state."""
    from spectral_tpu.grid import Grid
    from spectral_tpu.models.stokes import StokesConfig
    from spectral_tpu.models.stokes_unsteady import UnsteadyStokes
    from spectral_tpu.ops.curvilinear import named_map
    from spectral_tpu.solvers.krylov import KSPConfig

    cfg = StokesConfig(exact=1, boundary=0, pcvel="mg",
                       outer_ksp=KSPConfig(type="fgmres", rtol=1e-9, max_it=400, restart=100))
    t0 = time.perf_counter()
    m = UnsteadyStokes(Grid((20, 20)), cfg, dt=0.05, theta=0.5, phi=named_map("bump:0.05"))
    u0, s, f, u_t, _ = m.manufactured(omega=1.0)
    times = np.arange(6) * 0.05
    v, _, its = m.rollout(u0, times, s, f)
    return {"name": "15g ustokes", "per_step": [int(i) for i in np.asarray(its)],
            "error": float(jnp.max(jnp.abs(v - u_t(times[-1])))),
            "divergence": float(jnp.max(jnp.abs(m._div_full(v)))),
            "seconds": time.perf_counter() - t0}


CURVED_PARTS = {
    "cli": lambda names=None: [run_curved_cli(k, *CURVED_CLI[k]) for k in (names or CURVED_CLI)],
    "axis_maps": curved_axis_maps, "elliptic": curved_elliptic, "stokes": curved_stokes,
    "fused": curved_fused, "unsteady": curved_unsteady,
}


def curved(parts=None):
    """Every CURVED_PARTS entry (or ``parts``), one row a run."""
    for part in parts or CURVED_PARTS:
        out = CURVED_PARTS[part]()
        yield from [out] if isinstance(out, dict) else out
        jax.clear_caches()


# the curved command lines at 8^2 - 10^2 whose printed lines
# tests/test_torch_curvilinear.py holds the port's CLI to
CURVED_CPU = {
    "stokes annulus 8^2": ["stokes", "-exact", "1", "-dim", "8,8", "-map", "annulus:1:2"],
    "ustokes bump 8^2": ["ustokes", "-dim", "8,8", "-dt", "0.05", "-nsteps", "3",
                         "-map", "bump:0.05"],
    "elliptic bump 10^2": ["elliptic", "-dim", "10,10", "-exact", "0", "-gamma", "1",
                           "-map", "bump:0.08", "-debug", "1"],
    "heat bump 10^2": ["heat", "-dim", "10,10", "-dt", "0.5", "-theta", "1", "-nsteps", "5",
                       "-map", "bump:0.08"],
}


def curvedcpu() -> list:
    """CURVED_CPU's command lines through the JAX drivers: the lines they print."""
    from spectral_tpu.cli import drivers
    from spectral_tpu.utils.options import Options

    rows = []
    for name, (driver, *argv) in CURVED_CPU.items():
        main = {"stokes": drivers.stokes_main, "ustokes": drivers.unsteady_stokes_main,
                "elliptic": drivers.elliptic_main, "heat": drivers.heat_main}[driver]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(Options(argv))
        rows.append({"name": name, "rc": rc, "printed": buf.getvalue().splitlines()})
        jax.clear_caches()
    return rows

FAMILY_NPZ = "tests/data/torch_family_oracle.npz"


def family() -> list:
    """The batched solves of item 7a through the JAX package, float64:
    ``solve_family`` at 10^2 (exact 2, power law, exponents 1/2/3 at eps
    1e-2: JAX ``tests/test_stokes.py``'s family), the curved family (the
    annulus sector at 10^2 with the metric multigrid, exponents
    1.5/2.0/2.5: ``tests/test_curvilinear.py``'s), ``family_rollout`` at
    10^2 (three manufactured members, omega 0.5/1/2, four CN steps:
    ``tests/test_stokes_unsteady.py``'s), and bench.py's ``stokes_family8``
    configuration at 16^2 (exponents 1 + 0.25 i, i < 8, Newton rtol 1e-4),
    whose Newton counts ``chip_smoke.py`` phase 16a holds the card's to.
    The 10^2 solutions go to ``FAMILY_NPZ`` for ``tests/test_torch_family.py``."""
    from spectral_tpu.grid import Grid
    from spectral_tpu.models.rheology import PowerLawParams
    from spectral_tpu.models.stokes import StokesConfig, StokesProblem
    from spectral_tpu.models.stokes_unsteady import UnsteadyStokes
    from spectral_tpu.ops.curvilinear import named_map
    from spectral_tpu.solvers.krylov import KSPConfig
    from spectral_tpu.solvers.newton import NewtonConfig

    rows, arrays = [], {}

    def run(name, p, params):
        t0 = time.perf_counter()
        res = p.solve_family(params)
        rows.append({"name": name, "iters": [int(i) for i in res.iters],
                     "reason": [int(r) for r in res.reason],
                     "fnorm": [float(f) for f in res.fnorm],
                     "seconds": time.perf_counter() - t0})
        return res

    res = run("flat10", StokesProblem(Grid((10, 10)), StokesConfig(exact=2, rheology=1)),
              [PowerLawParams(1.0, e, 1e-2, 1.0) for e in (1.0, 2.0, 3.0)])
    arrays.update(flat10_v=np.asarray(res.x["v"]), flat10_p=np.asarray(res.x["p"]))
    cfg = StokesConfig(exact=0, boundary=3, rheology=1, regularization=1e-3, pcvel="mg",
                       newton=NewtonConfig(rtol=1e-8, max_it=40))
    res = run("curved10", StokesProblem(Grid((10, 10)), cfg, phi=named_map("annulus:1:2")),
              [PowerLawParams(1.0, e, 1e-3, 1.0) for e in (1.5, 2.0, 2.5)])
    arrays.update(curved10_v=np.asarray(res.x["v"]), curved10_p=np.asarray(res.x["p"]))
    run("family8", StokesProblem(Grid((16, 16)), StokesConfig(
        exact=2, rheology=1, newton=NewtonConfig(rtol=1e-4, max_it=25))),
        [PowerLawParams(1.0, 1.0 + 0.25 * i, 1e-2, 1.0) for i in range(8)])

    ucfg = StokesConfig(exact=1, boundary=0, pcvel="fastdiag",
                        outer_ksp=KSPConfig(type="fgmres", rtol=1e-10, max_it=300, restart=100))
    m = UnsteadyStokes(Grid((10, 10)), ucfg, dt=0.05, theta=0.5)
    times = np.arange(0.0, 0.2 + 1e-12, 0.05)
    v0s, sss, fbs = [], [], []
    for om in (0.5, 1.0, 2.0):
        u0, sf, ff, _, _ = m.manufactured(omega=om)
        v0s.append(u0)
        sss.append(jnp.asarray([sf(t) for t in times[1:]]))
        fbs.append(jnp.stack([m.theta * ff(t1) + (1 - m.theta) * ff(t0)
                              for t0, t1 in zip(times[:-1], times[1:])]))
    t0 = time.perf_counter()
    vs, ps, its = m.family_rollout(jnp.stack(v0s), jnp.stack(sss), jnp.stack(fbs))
    rows.append({"name": "rollout10", "iters": np.asarray(its).tolist(),
                 "seconds": time.perf_counter() - t0})
    arrays.update(rollout10_v=np.asarray(vs), rollout10_p=np.asarray(ps),
                  rollout10_iters=np.asarray(its))
    np.savez_compressed(FAMILY_NPZ, **arrays)
    return rows


PARALLEL_NPZ = "tests/data/torch_parallel_oracle.npz"


def parallel() -> list:
    """The single-device JAX results the port's sharded solves are held to
    (``PARALLEL_NPZ``): the configurations of ``tests/test_parallel.py``
    at its own sizes, each solved once on one device."""
    from spectral_tpu.grid import Grid
    from spectral_tpu.models.convection import ConvectionConfig, ConvectionModel
    from spectral_tpu.models.elliptic import EllipticModel
    from spectral_tpu.models.stokes import StokesConfig, StokesProblem
    from spectral_tpu.models.stokes_unsteady import UnsteadyStokes
    from spectral_tpu.ops.curvilinear import named_map
    from spectral_tpu.solvers.krylov import KSPConfig
    from spectral_tpu.solvers.newton import NewtonConfig

    from spectral_tpu.models.poisson import PoissonModel
    from spectral_tpu.ops.mapping import AxisMap

    rows, arrays = [], {}
    ksp = KSPConfig(type="gmres", rtol=1e-10, max_it=300)
    pm = PoissonModel(Grid((16, 16)))
    b = pm.rhs(*pm.exact_solution())
    for pc in ("jacobi", "mg", "lu", "none"):
        r = pm.solve(b, ksp=ksp, pc_type=pc)
        arrays[f"poisson {pc} x"] = np.asarray(r.x)
        arrays[f"poisson {pc} iters"] = np.asarray([int(r.iters)])
    mm = PoissonModel(Grid((16, 16), maps=(AxisMap.tanh_cluster(0.0, 2.0, 16, 1.5),
                                           AxisMap.kte(-1.0, 1.0, 16, 0.9))))
    for pc in ("fastdiag", "mg"):
        r = mm.solve(mm.rhs(*mm.exact_solution()), ksp=ksp, pc_type=pc)
        arrays[f"poisson mapped {pc} x"] = np.asarray(r.x)
        arrays[f"poisson mapped {pc} iters"] = np.asarray([int(r.iters)])
    from spectral_tpu.models.curvilinear import CurvilinearPoisson

    t0 = time.perf_counter()
    cp = CurvilinearPoisson(Grid((16, 12)), named_map("annulus:1:2"))
    _, cb = cp.manufactured(lambda x: np.sin(x[..., 0]) * x[..., 1],
                            lambda x: -np.sin(x[..., 0]) * x[..., 1])
    for pc in ("mg", "jacobi"):
        r = cp.solve(cb, pc_type=pc)
        arrays[f"curved poisson {pc} x"] = np.asarray(r.x)
        arrays[f"curved poisson {pc} iters"] = np.asarray([int(r.iters)])
    rows.append({"name": "curved poisson", "iters": [int(arrays[f"curved poisson {pc} iters"][0])
                                                     for pc in ("mg", "jacobi")],
                 "seconds": time.perf_counter() - t0})
    pd = PoissonModel(Grid((12, 12)))
    b1 = pd.rhs(*pd.exact_solution())
    scales = np.random.default_rng(3).uniform(0.5, 2.0, size=4)
    r = KSPConfig(type="gmres", rtol=1e-10, max_it=200).solve_batched(
        pd.operator, jnp.asarray(scales)[:, None, None] * b1[None], M=pd.build_pc("fastdiag"))
    arrays.update({"dp x": np.asarray(r.x), "dp iters": np.asarray(r.iters)})

    def stokes(name, dims, cfg, **kw):
        t0 = time.perf_counter()
        r = StokesProblem(Grid(dims), cfg, **kw).solve()
        rows.append({"name": name, "newton": int(r.iters), "krylov": [int(k) for k in r.ksp_iters],
                     "seconds": time.perf_counter() - t0})
        arrays[f"{name} v"] = np.asarray(r.x["v"])
        arrays[f"{name} iters"] = np.asarray([int(r.iters)] + [int(k) for k in r.ksp_iters])

    cfg = StokesConfig(exact=2, cont0=1)
    stokes("stokes 1-axis", (12, 12), cfg)
    stokes("stokes 2x2", (12, 12, 8), cfg)
    stokes("stokes curved", (12, 12), StokesConfig(exact=1, pcvel="mg"),
           phi=named_map("bump:0.07"))
    stokes("stokes tbc", (12, 12), StokesConfig(exact=1, boundary=3, tbc=1, traction_p=True))
    m = EllipticModel(Grid((16, 12)), gamma=1.0)
    u, b, d = m.setup_problem(exact=0)
    for pc in ("fastdiag", "jacobi", "mg"):
        t0 = time.perf_counter()
        r = m.solve(b, d, pc_type=pc, newton=NewtonConfig(rtol=1e-10, max_it=20))
        rows.append({"name": f"elliptic {pc}", "newton": int(r.iters),
                     "krylov": [int(k) for k in r.ksp_iters],
                     "seconds": time.perf_counter() - t0})
        arrays[f"elliptic {pc} x"] = np.asarray(r.x)
        arrays[f"elliptic {pc} iters"] = np.asarray([int(r.iters)] + [int(k) for k in r.ksp_iters])
    t0 = time.perf_counter()
    mc = EllipticModel(Grid((16, 12)), gamma=1.0, phi=named_map("bump:0.08"))
    u, b, d = mc.setup_problem(exact=0)
    r = mc.solve(b, d, pc_type="mg")
    rows.append({"name": "elliptic curved", "newton": int(r.iters),
                 "krylov": [int(k) for k in r.ksp_iters], "seconds": time.perf_counter() - t0})
    arrays["elliptic curved x"] = np.asarray(r.x)
    arrays["elliptic curved iters"] = np.asarray([int(r.iters)] + [int(k) for k in r.ksp_iters])
    t0 = time.perf_counter()
    ucfg = StokesConfig(exact=1, boundary=0, pcvel="fastdiag",
                        outer_ksp=KSPConfig(type="fgmres", rtol=1e-10, max_it=200, restart=100))
    um = UnsteadyStokes(Grid((12, 12)), ucfg, dt=0.05, theta=0.5)
    u0, sf, ff, _, _ = um.manufactured(omega=1.0)
    v, pr, it, _ = um.step(u0, sf(0.05), 0.5 * ff(0.05) + 0.5 * ff(0.0))
    rows.append({"name": "unsteady", "iters": int(it), "seconds": time.perf_counter() - t0})
    arrays.update({"unsteady v": np.asarray(v), "unsteady p": np.asarray(pr),
                   "unsteady iters": np.asarray([int(it)])})
    t0 = time.perf_counter()
    ccfg = ConvectionConfig(Ra=5e3, dt=1e-3, velocity_bc="freeslip", side_bc="insulated",
                            stokes_ksp=KSPConfig(type="fgmres", rtol=1e-10, max_it=150,
                                                 restart=60))
    cm = ConvectionModel.unit_box((12, 12), ccfg)
    T0 = cm.conductive_state(amp=0.05)
    it0 = int(cm.solve_stokes(T0, cm.stokes.zero_state()).iters)
    carry = cm.init_carry(T0)
    T1, N1, x1 = cm.step(*carry)
    Td, Nd, _ = cm.step_dt(*carry, jnp.asarray(7e-4), jnp.asarray(0.8))
    rows.append({"name": "convection", "iters": it0, "seconds": time.perf_counter() - t0})
    arrays.update({"convection T0": np.asarray(T0), "convection T": np.asarray(T1),
                   "convection v": np.asarray(x1["v"]), "convection Tdt": np.asarray(Td),
                   "convection Ndt": np.asarray(Nd), "convection iters": np.asarray([it0])})
    np.savez_compressed(PARALLEL_NPZ, **arrays)
    return rows


MARCH_NPZ = "tests/data/torch_march_oracle.npz"
MARCH_DIR = "tests/data/torch_march_checkpoint"
MARCH = dict(config=dict(Ra=5e3, dt=1e-3, velocity_bc="freeslip", side_bc="insulated",
                         stokes_pc="dense"),
             dims=(8, 8), amp=0.05, march=dict(tol=1e-12, rtol=3e-3, dt0=2e-5))


def march() -> dict:
    """The JAX package's checkpointed march_adaptive and its resumed run
    (``MARCH_DIR``, ``MARCH_NPZ``)."""
    import os
    import shutil

    from spectral_tpu.models.convection import ConvectionConfig, ConvectionModel

    t0 = time.perf_counter()
    m = ConvectionModel.unit_box(MARCH["dims"], ConvectionConfig(**MARCH["config"]))
    T0 = m.conductive_state(amp=MARCH["amp"])
    shutil.rmtree(MARCH_DIR, ignore_errors=True)
    m.march_adaptive(T0, max_steps=20, checkpoint=MARCH_DIR, checkpoint_every=10,
                     **MARCH["march"])
    for f in ("step_0010.npz", "step_0010.npz.json"):
        os.remove(os.path.join(MARCH_DIR, f))
    work = MARCH_DIR + ".resume"
    shutil.copytree(MARCH_DIR, work)
    T, _, info = m.march_adaptive(T0, max_steps=40, checkpoint=work, resume=True,
                                  **MARCH["march"])
    shutil.rmtree(work)
    np.savez_compressed(MARCH_NPZ, T0=np.asarray(T0), T=np.asarray(T),
                        dts=np.asarray(info["dts"]),
                        counts=np.asarray([info["steps"], info["rejects"]]))
    return {"name": "march", "steps": info["steps"], "rejects": info["rejects"],
            "seconds": time.perf_counter() - t0}


CLI_OUTPUTS_DIR = "tests/data/torch_cli_outputs"
CLI_OUTPUTS = {
    "stokes": ["stokes", "-exact", "2", "-rheology", "1", "-cont", "2", "-eps", "1e-2",
               "-exponent", "3", "-dim", "8,8", "-checkpoint_dir", "ck", "-output_vtk",
               "-log_summary"],
    "ustokes": ["ustokes", "-dim", "8,8", "-nsteps", "2", "-output_vtk"],
    "convection": ["convection", "-dim", "8,8", "-nsteps", "2", "-stokes_pc", "dense",
                   "-output_vtk"],
}


def clioutputs() -> dict:
    """The JAX drivers' output options (``CLI_OUTPUTS``, ``CLI_OUTPUTS_DIR``):
    ``<name>.json`` holds the printed lines (and for stokes the counts and
    the checkpoint metas of the full and the resumed run), ``<name>.vtk``
    the file written (``stokes_resumed.vtk``: the resumed run's)."""
    import os
    import shutil
    import tempfile

    from spectral_tpu.cli.main import main as jmain
    from spectral_tpu.models.stokes import StokesProblem
    from spectral_tpu.utils import checkpoint as ckpt

    captured = []
    orig_cont = StokesProblem.solve_continuation

    def cont(self, *a, **kw):
        res = orig_cont(self, *a, **kw)
        captured.append(_counts(res))
        return res

    def run(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = jmain(argv)
        assert rc == 0, buf.getvalue()
        return [ln for ln in buf.getvalue().splitlines() if not ln.startswith("SNESSolve")]

    t0 = time.perf_counter()
    out = os.path.abspath(CLI_OUTPUTS_DIR)
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    here = os.getcwd()
    StokesProblem.solve_continuation = cont
    try:
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            rows = {}
            for name, argv in CLI_OUTPUTS.items():
                rows[name] = {"argv": argv, "lines": run(argv)}
                shutil.copy(f"{name}.vtk", os.path.join(out, f"{name}.vtk"))
            last = ckpt.latest_step("ck")
            rows["stokes"]["meta"] = [ckpt.load_meta("ck", i) for i in range(last + 1)]
            for f in (f"step_{last:04d}.npz", f"step_{last:04d}.npz.json"):
                os.remove(os.path.join("ck", f))
            os.remove("stokes.vtk")
            rows["stokes"]["resumed_lines"] = run(CLI_OUTPUTS["stokes"])
            shutil.copy("stokes.vtk", os.path.join(out, "stokes_resumed.vtk"))
    finally:
        os.chdir(here)
        StokesProblem.solve_continuation = orig_cont
    rows["stokes"]["counts"], rows["stokes"]["resumed_counts"] = captured
    for name, row in rows.items():
        with open(os.path.join(out, f"{name}.json"), "w") as f:
            json.dump(row, f, indent=1)
    return {"name": "clioutputs", "counts": captured, "seconds": time.perf_counter() - t0}


SECTIONS = {
    "cli43": lambda: run_cli(README43),
    "cli52": lambda: run_cli(README52),
    "perturb": lambda: perturbed(README52),
    "entry": entry_norms,
    "refined": refined,
    "neumann3d": lambda: [dict(run_cli(argv), name=name) for name, argv in NEUMANN3D.items()],
    "mixed2d": mixed2d,
    "perturb2d": lambda: mixed2d(("boundary 2", "boundary 2 mg"),
                                 [(1e-13, seed) for seed in range(8)] + [(1e-11, 0)]),
    "line52": line52,
    "fused": fused,
    "q1": lambda: [dict(run_cli(argv), name=name) for name, argv in Q1_STOKES.items()],
    "q1cpu8": lambda: [dict(r, name=name, printed=r["lines"])
                       for name, r in ((n, run_cli(argv)) for n, argv in Q1_CPU8.items())],
    "perturb_probed": lambda: perturbed(Q1_STOKES["README:43 pcvel 2"]),
    "perturb_sv": lambda: perturbed(Q1_STOKES["README:43 singular values"]),
    "perturb_q1fem52": lambda: perturbed(Q1_STOKES["README:52 pcvel 1"]),
    "perturb_gseq52": lambda: perturbed(Q1_STOKES["README:52 grid sequence 1"]),
    "unsteady": unsteady,
    "perturb_unsteady": perturbed_unsteady,
    "convection": convection,
    "convcpu8": convcpu8,
    "adjoint": adjoint,
    "adjoint52": adjoint52,
    "perturb_adjoint52": perturbed_adjoint52,
    "solvers": solvers,
    "solvers_perturbed": solvers_perturbed,
    "recycle12": recycle12,
    "curved": curved,
    "curvedcpu": curvedcpu,
    "family": family,
    "parallel": parallel,
    "march": march,
    "clioutputs": clioutputs,
}


def main(argv: list[str]) -> int:
    global SEEDS
    if "--seeds" in argv:
        i = argv.index("--seeds")
        lo, hi = map(int, argv[i + 1].split("-"))
        SEEDS, argv = range(lo, hi + 1), argv[:i] + argv[i + 2:]
    for name in argv or list(SECTIONS):
        out = SECTIONS[name]()
        for item in [out] if isinstance(out, dict) else out:
            item = {k: v for k, v in item.items() if k != "lines"}
            print(json.dumps({"section": name, **item}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
