"""spectral-tpu-torch CLI: the reference's driver executables as subcommands.

    spectral-tpu-torch poisson -m 64 -n 64 -p 64 -ksp_rtol 1e-10
    spectral-tpu-torch elliptic -dim 32,32,32 -exact 0 -gamma 1 -pc_type mg3
    spectral-tpu-torch stokes -exact 2 -cont0 1 -schur_ksp_max_it 3 -vel_ksp_max_it 4 \
        -svel_ksp_type preonly -ksp_type fgmres -dim 20,20,20 -ksp_rtol 1e-10
    spectral-tpu-torch heat -dim 64,64,64 -dt 0.01 -nsteps 20 [-ts_type bdf2 | -ts_adapt]
    spectral-tpu-torch ustokes -dim 20,20,20 -dt 0.05 -nsteps 10 [-scheme bdf2]
    spectral-tpu-torch convection -dim 16,16 -ra 1e4 -bc freeslip -sides insulated
    spectral-tpu-torch cheb -m1 9 -m 8 -n 7 -p 6 -d 1

Option names and output format follow the JAX package's CLI.  Float64 is
the default (the reference runs at rtol 1e-10..1e-12); pass -f32 for
float32.  ``-device`` picks the torch device, ``cuda`` by default; without
CUDA that raises rather than running on the host (pass ``-device cpu``).
"""

from __future__ import annotations

import sys

import torch

from spectral_tpu_torch.utils.options import Options

def _setup(opts: Options) -> tuple[torch.device, torch.dtype]:
    device = torch.device(opts.get_string("device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("-device cuda: CUDA is not available "
                           "(pass -device cpu to run on the host)")
    dtype = torch.float32 if opts.has("f32") else torch.float64
    return device, dtype


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd not in ("poisson", "elliptic", "stokes", "heat", "ustokes", "convection", "cheb"):
        print(f"unknown driver {cmd!r}; "
              "one of: poisson elliptic stokes heat ustokes convection cheb")
        return 1
    opts = Options(rest)
    device, dtype = _setup(opts)
    from spectral_tpu_torch.cli import drivers
    if cmd == "poisson":
        return drivers.poisson_main(opts, device=device, dtype=dtype)
    if cmd == "elliptic":
        return drivers.elliptic_main(opts, device=device, dtype=dtype)
    if cmd == "stokes":
        return drivers.stokes_main(opts, device=device, dtype=dtype)
    if cmd == "heat":
        return drivers.heat_main(opts, device=device, dtype=dtype)
    if cmd == "ustokes":
        return drivers.unsteady_stokes_main(opts, device=device, dtype=dtype)
    if cmd == "convection":
        return drivers.convection_main(opts, device=device, dtype=dtype)
    return drivers.cheb_main(opts, device=device, dtype=dtype)


if __name__ == "__main__":
    raise SystemExit(main())
