"""The port's Q1 and probed velocity preconditioners, the elliptic q1fem
PC, grid sequencing and the singular-value estimate against the JAX
package on the CPU in float64.

The velocity PCs: one apply of each branch of ``_make_vel_pc_base``
(``q1fem``, ``q1sep``, ``probed``, ``probed1``; ``q1fem`` also with
Neumann boundaries and the traction-block correction on top) about the
same seeded linearization, held to the JAX package's to 1e-12 relative to
the largest entry.  Each JAX branch is one jitted program.

The drivers: the port's ``stokes`` CLI on README:43's command line at 8x8
with ``-pcvel 1``, ``q1sep`` and ``2`` is held to the JAX package's
counts and error as ``JAX_PLATFORMS=cpu python3 stokes_oracle.py q1cpu8``
prints them (``Q1_CPU8``; a JAX stokes run compiles its own Newton step
in 3-9 s, so they are not rerun here).  The elliptic CLI at 12x12 with
``-pc_type q1fem -snes_grid_sequence 1`` runs the JAX driver live, in one
module fixture.  Newton counts and reasons are equal.  Krylov counts are
held within 1 where summation order moves them: the Stokes outer FGMRES
(with ``q1sep`` the JAX package itself takes 9 iterations compiled and 10
op by op, from velocity-PC applies that agree to 1e-16), and the last
linear solve of the elliptic Newton solve, run from a residual already
1e-7 of the first to rtol 1e-10 at the float64 round-off floor.  The
error, which follows the last iterate, is held to 1e-4 relative (the
q1sep solves differ by 6e-5); every other printed line agrees to every
digit.
"""

import contextlib
import io
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectral_tpu.cli.drivers import elliptic_main as j_elliptic_main
from spectral_tpu.grid import Grid as JGrid
from spectral_tpu.models.stokes import StokesConfig as JConfig
from spectral_tpu.models.stokes import StokesProblem as JProblem
from spectral_tpu.utils.options import Options as JOptions
from spectral_tpu_torch.cli.main import main as t_main
from spectral_tpu_torch.grid import Grid
from spectral_tpu_torch.models.stokes import StokesConfig, StokesProblem
from spectral_tpu_torch.utils.interop import linearization_from_numpy

CLI_2D_ARGV = ["-exact", "2", "-cont0", "1", "-schur_ksp_max_it", "3", "-vel_ksp_max_it", "4",
               "-svel_ksp_type", "preonly", "-ksp_type", "fgmres", "-dim", "8,8",
               "-ksp_rtol", "1e-10"]
# The JAX package's stokes CLI on CLI_2D_ARGV by -pcvel (stokes_oracle.py q1cpu8):
# Newton counts, Krylov counts per Newton step, error; and the lines it prints
# but the error
Q1_CPU8 = {"1": ([1], [[8]], 1.608813e-05),
           "q1sep": ([1], [[9]], 1.609044e-05),
           "2": ([1], [[6]], 1.608791e-05)}
Q1_CPU8_LINES = [
    "Stokes problem  dim = [8,8]",
    "  hardness = 1.000000    exponent = 1.000000    regularization = 1.000000"
    "    gamma0 = 1.000000",
    "DOF distribution: 108 global   36/64 pressure    72/128 velocity    56 dirichlet    0 mixed",
    "Norm of solution 9.282e-01  norm of forcing 2.290e+00  norm of residual 2.289e-04",
    "Number of nonlinear iterations = 1",
    "Reason for solver termination: CONVERGED_RTOL"]
ELLIPTIC_ARGV = ["-dim", "12,12", "-exact", "0", "-gamma", "1", "-pc_type", "q1fem",
                 "-snes_grid_sequence", "1", "-snes_rtol", "1e-10", "-debug", "1"]


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _error(out):
    return float(out.split("Norm of error")[1].split("abs =")[1].split()[0])


def _fixed(out):
    """The printed lines both drivers share that do not follow the last
    iterate (not the error, not the per-step counts)."""
    return [ln for ln in out.splitlines()
            if not ln.startswith(("Norm of error", "KSP iterations", "Continuation steps"))]


def _close(got, ref, rtol):
    got, ref = got.detach().numpy(), np.asarray(ref)
    scale = max(float(np.max(np.abs(ref))), 1e-300)
    np.testing.assert_allclose(got / scale, ref / scale, atol=rtol, rtol=0)


# -- the velocity PCs -------------------------------------------------------------

PC_DIMS = (8, 7)   # test_torch_fem.py's probe size: in one process the JAX
                   # package's op-by-op probes share their compiled operations
PC_BASE = dict(exact=2, rheology=1, exponent=3.0, regularization=1e-2)
PC_CASES = {"q1fem": dict(pcvel="q1fem"),
            "q1fem boundary 1 tbc 1": dict(pcvel="q1fem", boundary=1, tbc=1),
            "q1sep": dict(pcvel="q1sep"),
            "probed": dict(pcvel="probed"),
            "probed1": dict(pcvel="probed1")}


def _pc_inputs(vel_mask, seed=0):
    """A linearization (eta, deta, S) as tests/test_fem.py draws it (eta
    in [1, 2), deta O(0.3), a symmetric strain) and a residual masked by
    ``vel_mask``."""
    rng = np.random.default_rng(seed)
    d = len(PC_DIMS)
    Sr = rng.standard_normal(PC_DIMS + (d, d))
    lin = (1.0 + rng.random(PC_DIMS), 0.3 * rng.standard_normal(PC_DIMS),
           0.5 * (Sr + np.swapaxes(Sr, -1, -2)))
    return lin, np.where(vel_mask, rng.standard_normal(vel_mask.shape), 0.0)


@pytest.fixture(scope="module")
def jax_vel_pc():
    """case -> (vel_mask, linearization, residual, {"base": the JAX package's
    _make_vel_pc_base apply, "tbc": its make_vel_pc apply where tbc is
    on}), one jitted program a case (the probes: one jitted VV action)."""
    cache = {}

    def get(case):
        if case not in cache:
            jp = JProblem(JGrid(PC_DIMS), JConfig(**PC_BASE, **PC_CASES[case]))
            vm = np.asarray(jp.vel_mask)
            lin, r = _pc_inputs(vm)
            bs, ba = jp._make_vel_pc_base()
            cs, ca = jp.make_vel_pc()

            def apply(lin, r):
                out = {"base": ba(bs(lin), r)}
                if jp.config.tbc:
                    out["tbc"] = ca(cs(lin), r)
                return out

            if jp.config.pcvel.startswith("probed"):
                # op by op about one compiled VV action: the probe repeats one
                # set of operations a color, so this compiles less than one
                # program of every probe
                jp.vv_action = jax.jit(jp.vv_action)
            else:
                apply = jax.jit(apply)
            cache[case] = vm, lin, r, apply(tuple(map(jnp.asarray, lin)), jnp.asarray(r))
        return cache[case]

    return get


@pytest.mark.parametrize("case", sorted(PC_CASES))
def test_velocity_pc_matches_jax(jax_vel_pc, case):
    """One apply of the velocity PC about a power-law linearization: q1fem's
    Q1 assembly, 1/eta scaling and two Richardson corrections on the
    separable-Q1 solve; q1sep's exact solve; the probes' stencils and their
    4 damped-Jacobi sweeps at 0.7 (probed1 a component at a time); with
    Neumann rows, the base apply and the traction-block correction on top.
    Each masked by the problem's velocity mask."""
    vm, lin, r, ref = jax_vel_pc(case)
    tp = StokesProblem(Grid(PC_DIMS, device="cpu"), StokesConfig(**PC_BASE, **PC_CASES[case]))
    assert np.array_equal(tp.vel_mask.numpy(), vm)
    lin_t = linearization_from_numpy(lin, device="cpu", dtype=torch.float64)
    r_t = torch.from_numpy(r)
    bs, ba = tp._make_vel_pc_base()
    _close(ba(bs(lin_t), r_t), ref["base"], 1e-12)
    if "tbc" in ref:
        assert tp.num_mixed > 0
        cs, ca = tp.make_vel_pc()
        _close(ca(cs(lin_t), r_t), ref["tbc"], 1e-12)


# -- the drivers ------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_elliptic():
    """The JAX elliptic driver's output on ELLIPTIC_ARGV."""
    rc, text = _run(j_elliptic_main, JOptions(ELLIPTIC_ARGV))
    assert rc == 0
    return text


@pytest.mark.parametrize("pcvel", sorted(Q1_CPU8))
def test_stokes_cli_q1_and_probed_match_jax(pcvel):
    """README:43's command line at 8x8 with the Q1 FEM (-pcvel 1, the
    strain-coupled assembly on the separable-Q1 solve), the separable Q1
    solve alone and the full colored probe (-pcvel 2): the JAX driver's
    lines, Newton counts equal, Krylov counts within 1, the error to 1e-4
    relative (Q1_CPU8)."""
    newton_ref, krylov_ref, error_ref = Q1_CPU8[pcvel]
    rc, out = _run(t_main, ["stokes", "-device", "cpu", *CLI_2D_ARGV, "-pcvel", pcvel])
    assert rc == 0
    assert _fixed(out) == Q1_CPU8_LINES
    assert abs(_error(out) / error_ref - 1.0) <= 1e-4
    m = re.search(r"Continuation steps: Newton (\[.*\])  Krylov (\[.*\])", out)
    newton, krylov = json.loads(m.group(1)), json.loads(m.group(2))
    assert newton == newton_ref and [len(k) for k in krylov] == newton
    assert all(abs(a - b) <= 1 for ka, kb in zip(krylov, krylov_ref) for a, b in zip(ka, kb)), \
        (krylov, krylov_ref)


def test_elliptic_cli_q1fem_grid_sequence_matches_jax(jax_elliptic):
    """The elliptic CLI at 12x12 with the q1fem PC and one coarser level
    (6x6) of grid sequencing: the level's line equal, the fine solve's
    Newton count and reason equal, its Krylov counts equal but the last
    (within 1), the error to 1e-4 relative."""
    rc, out = _run(t_main, ["elliptic", "-device", "cpu", *ELLIPTIC_ARGV])
    assert rc == 0
    ref = jax_elliptic
    assert _fixed(out) == _fixed(ref)
    assert "grid sequence level (6, 6)" in out
    kits = [json.loads(re.search(r"KSP iterations per Newton step: (\[.*\])", t).group(1))
            for t in (out, ref)]
    assert kits[0][:-1] == kits[1][:-1] and abs(kits[0][-1] - kits[1][-1]) <= 1, kits
    assert abs(_error(out) / _error(ref) - 1.0) <= 1e-4


def test_singular_values_and_zero_filter_run():
    """-ksp_compute_singularvalues prints the estimate after the solve in
    both drivers (extreme_singular_values itself is held to the JAX package
    in test_torch_fem.py), and -zeroN/-zeroV reach the Q1 assembly."""
    for argv in (["stokes", *CLI_2D_ARGV, "-pcvel", "1", "-zeroN", "3", "-zeroV", "2",
                  "-ksp_compute_singularvalues"],
                 ["elliptic", "-dim", "8,8", "-ksp_compute_singularvalues"]):
        rc, out = _run(t_main, [*argv, "-device", "cpu"])
        assert rc == 0 and "WARNING" not in out, out
        m = re.search(r"extreme singular values: max (\S+) min (\S+) cond (\S+)", out)
        smax, smin, cond = map(float, m.groups())
        assert 0 < smin <= smax and abs(cond - smax / smin) <= 1e-5 * cond
