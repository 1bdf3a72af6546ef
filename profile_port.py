#!/usr/bin/env python3
"""Where the port's time goes on one GPU: torch.profiler over one warm run
of each elliptic and Stokes path that chip_smoke.py drives (its phases 6
to 10, taken from its tables), of phase 11's heat and linear unsteady
Stokes Crank-Nicolson runs, and of phase 12's Blankenbach march (12a) and
Busse cell (12d).

    python3 profile_port.py [substring ...]

With arguments, only the paths whose names contain one of them.

For each path it prints one JSON line: the host wall time of one
unprofiled warm run and of the profiled run (the profiler traces device
activity only), the device busy time (the sum of the kernel and copy
times on the card, one stream, so nothing overlaps), the idle share 1 -
busy / profiled wall, the number of device operations, and the eight
largest by device time.  A warm-up run comes
first, so set-up caches are warm.  Without CUDA it exits non-zero.
"""

from __future__ import annotations

import json
import sys
import time


def device_ops(prof):
    """(name, count, device microseconds) of every device-side entry."""
    import torch

    out = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        out.append((e.key, e.count, us))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_port: CUDA is not available; this runs on the GPU only",
              file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import (CONVECTION_ORACLE, ELLIPTIC_ORACLE, PHASE10_ORACLE, STOKES_ORACLE,
                            UNSTEADY_ORACLE, busse_model, busse_newton, refined_runs, run_cli,
                            stokes_forward, stokes_line52, stokes_mixed_runs,
                            stokes_refined_runs)
    from spectral_tpu_torch.cli.main import main as cli_main

    def cli(driver, opts):
        def run():
            rc, _ = run_cli(cli_main, [driver, *opts])
            if rc != 0:
                raise RuntimeError(f"{driver} {' '.join(opts)}: exit code {rc}")
        return run

    dev = torch.device("cuda")
    # the paths of chip_smoke.py phases 6 to 10, from its tables
    paths = {f"elliptic CLI {name} f64": cli("elliptic", opts)
             for name, (opts, *_) in ELLIPTIC_ORACLE.items()}
    paths.update({name: run for name, (run, _) in refined_runs(dev).items()})
    paths.update({f"stokes CLI {name} f64": cli("stokes", STOKES_ORACLE[name]["argv"])
                  for name in ("README:43", "README:52")})
    paths["stokes entry 32^3 f64"] = stokes_forward(dev, torch.float64)
    paths.update({f"stokes {name}": (lambda p=p: p.solve_refined(rtol=1e-10))
                  for name, p in stokes_refined_runs(dev).items()})
    paths.update({f"stokes CLI {name} f64": cli("stokes", STOKES_ORACLE[name]["argv"])
                  for name in ("neumann tbc 20^3", "neumann free 12^3")})
    paths.update({f"stokes {name}": p.solve for name, p in stokes_mixed_runs(dev).items()})
    paths["stokes line52"] = stokes_line52(dev).solve_continuation
    paths.update({f"stokes {name.replace('refined', 'fused')}": (
        lambda p=p, fc=name == "refined powerlaw": p.solve_refined_fused(
            rtol=1e-10, fused_continuation=fc))
        for name, p in stokes_refined_runs(dev).items()})
    paths.update({f"phase{name}": cli(spec["argv"][0], spec["argv"][1:])
                  for name, spec in PHASE10_ORACLE.items()})
    # phase 11's heat CN and linear unsteady CN runs
    paths.update({f"phase{name}": cli(UNSTEADY_ORACLE[name]["argv"][0],
                                      UNSTEADY_ORACLE[name]["argv"][1:])
                  for name in ("11a heat 64^3 cn", "11b ustokes 20^3 cn")})
    # phase 12's Blankenbach march and Busse cell (its model built once)
    spec = CONVECTION_ORACLE["12a blankenbach"]
    paths["12a blankenbach"] = cli(spec["argv"][0], spec["argv"][1:])

    def busse():
        if "busse" not in built:
            built["busse"] = busse_model(dev)
        m, T0 = built["busse"]
        m.steady_newton(T0, warmup=300, newton=busse_newton())

    built = {}
    paths["12d busse"] = busse
    wanted = sys.argv[1:]
    for name, run in paths.items():
        if wanted and not any(w in name for w in wanted):
            continue
        run()                                   # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        # device activity only: host-side events add no device time and, on
        # paths of ~10^6 operations, overhead enough to stall the run
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        ops = sorted(device_ops(prof), key=lambda o: -o[2])
        busy = sum(o[2] for o in ops) * 1e-6
        print(json.dumps({
            "path": name, "wall_s": wall, "profiled_wall_s": prof_wall, "device_busy_s": busy,
            "idle_share": 1.0 - busy / prof_wall, "device_ops": sum(o[1] for o in ops),
            "top": [{"name": k[:90], "count": c, "ms": us * 1e-3} for k, c, us in ops[:8]]}),
            flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
