"""Didactic example: matrix-free stencil operators and a user (shell) Jacobi PC.

Counterpart of ``examples/shell_demo.py``, the analog of the reference's
shell.c: 2nd/4th/6th-order uniform-grid Laplacian stencils applied
matrix-free, preconditioned by a Jacobi "shell" PC from the ``-pc_type``
registry (``solvers/pc.py``), including the ``-munge`` variant that
perturbs the operator and its diagonal (shell.c:284-331).  A MatShell is a
Python closure and a PCShell any callable.

    python -m spectral_tpu_torch.examples.shell_demo [-m 32] [-n 32] [-order 2|4|6]
        [-munge] [-device cuda|cpu]

Prints the unpreconditioned and the Jacobi-shell GMRES counts; exit code 0
when both converged and the solution is within 1e-4 of the exact one, 2
when not.
"""

from __future__ import annotations

import sys

# symmetric high-order second-difference coefficients, truncated at the
# ends as shell.c's index guards do
STENCILS = {
    2: [1.0],                                  # center 2, offs -1
    4: [4.0 / 3.0, -1.0 / 12.0],               # center 2*2.5
    6: [1.5, -3.0 / 20.0, 1.0 / 90.0],         # center 2*49/18
}


def laplacian_2d(order: int = 2, munge: bool = False):
    """(matvec, diag_fn) of shell.c's 2-D stencil operator."""
    import torch

    from spectral_tpu_torch.ops.stencil import shift

    offs = STENCILS[order]
    c0 = {2: 4.0, 4: 2 * 2.5, 6: 2 * 49.0 / 18.0}[order]

    def matvec(x):
        if order == 2:
            four, one = (5.0, 1.25) if munge else (4.0, 1.0)
            y = four * x
            for ax in (0, 1):
                y = y - one * (shift(x, ax, -1) + shift(x, ax, 1))
            return y
        y = c0 * x
        for ax in (0, 1):
            for k, c in enumerate(offs, start=1):
                y = y - c * (shift(x, ax, -k) + shift(x, ax, k))
        return y

    def diag(shape, dtype, device):
        if order == 2:
            d = torch.full(shape, 5.0 if munge else 4.0, dtype=dtype, device=device)
            if munge:  # shell.c:324-327 perturbs the first entries
                d.view(-1)[:3] = torch.tensor([2.0, 5.0, 10.0], dtype=dtype)
            return d
        return torch.full(shape, c0, dtype=dtype, device=device)

    return matvec, diag


def main(argv=None) -> int:
    import numpy as np
    import torch

    from spectral_tpu_torch.cli.main import _setup
    from spectral_tpu_torch.solvers.krylov import gmres
    from spectral_tpu_torch.solvers.pc import pc_setup
    from spectral_tpu_torch.utils.options import Options

    opts = Options(argv if argv is not None else sys.argv[1:])
    device, dtype = _setup(opts)
    m = opts.get_int("m", 32)
    n = opts.get_int("n", 32)
    order = opts.get_int("order", 2)
    munge = opts.has("munge")
    matvec, diag_fn = laplacian_2d(order, munge)

    xstar = torch.as_tensor(np.random.default_rng(0).standard_normal((m, n)),
                            dtype=dtype, device=device)
    b = matvec(xstar)
    rtol = 1e-8 if dtype == torch.float64 else 1e-5
    plain = gmres(matvec, b, rtol=rtol, max_it=2000)
    pc = pc_setup("jacobi", diag_fn((m, n), dtype, device))
    prec = gmres(matvec, b, M=pc, rtol=rtol, max_it=2000)
    err = float(torch.max(torch.abs(prec.x - xstar)))
    print(f"order {order} munge={munge}: unpreconditioned its {int(plain.iters)}, "
          f"jacobi-shell its {int(prec.iters)}, err {err:.2e}")
    ok = plain.reason > 0 and prec.reason > 0 and err < (1e-4 if rtol < 1e-6 else 1e-1)
    return 0 if ok else 2


if __name__ == "__main__":
    raise SystemExit(main())
