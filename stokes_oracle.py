#!/usr/bin/env python3
"""The JAX package's Stokes numbers on the CPU: the oracle that
``chip_smoke.py`` phase 8 (``STOKES_ORACLE``) holds the port to.

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
  configurations, x64 off (float32 device arithmetic, as the bench runs).
"""

from __future__ import annotations

import contextlib
import io
import json
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
    """The JAX stokes driver on ``argv``; its continuation results are
    captured as it runs.  ``perturb`` adds masked normal noise of that
    size (from ``seed``) to the zero state the continuation starts from."""
    from spectral_tpu.cli.drivers import stokes_main
    from spectral_tpu.models.stokes import StokesProblem
    from spectral_tpu.utils.options import Options

    captured = []
    orig_cont, orig_zero = StokesProblem.solve_continuation, StokesProblem.zero_state

    def cont(self, *a, **kw):
        captured.extend(orig_cont(self, *a, **kw))
        return captured

    def zero(self):
        z = orig_zero(self)
        if not perturb:
            return z
        rng = np.random.default_rng(seed)
        return {"v": self.mask_v(z["v"] + perturb * jnp.asarray(
            rng.standard_normal(z["v"].shape))), "p": z["p"]}

    StokesProblem.solve_continuation, StokesProblem.zero_state = cont, zero
    try:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = stokes_main(Options(argv))
        seconds = time.perf_counter() - t0
    finally:
        StokesProblem.solve_continuation, StokesProblem.zero_state = orig_cont, orig_zero
    out = buf.getvalue()
    err = float(out.split("Norm of error")[1].split("abs =")[1].split()[0])
    return {"argv": " ".join(argv), "rc": rc, "perturb": perturb, "seed": seed,
            **_counts(captured),
            "total_krylov": sum(sum(k) for k in _counts(captured)["krylov"]),
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


SECTIONS = {
    "cli43": lambda: run_cli(README43),
    "cli52": lambda: run_cli(README52),
    "perturb": lambda: ([run_cli(README52, 1e-13, seed) for seed in range(8)]
                        + [run_cli(README52, 1e-11, 0)]),
    "entry": entry_norms,
    "refined": refined,
}


def main(argv: list[str]) -> int:
    for name in argv or list(SECTIONS):
        out = SECTIONS[name]()
        for item in out if isinstance(out, list) else [out]:
            item = {k: v for k, v in item.items() if k != "lines"}
            print(json.dumps({"section": name, **item}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
