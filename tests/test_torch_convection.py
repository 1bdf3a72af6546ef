"""The port's convection model (spectral_tpu_torch.models.convection) and
its ``convection`` CLI against the JAX package on the same inputs, on the
CPU, in float64, at 8x8.

Each JAX comparison is one compiled program (a step, or the lagged dense
chunk's refresh and step).  The Stokes solves run at outer rtol 1e-12, so
both packages' steps agree to round-off whatever their summation orders.
The CLI runs are held to the JAX CLI's lines and full-precision numbers
recorded by ``stokes_oracle.py convcpu8`` (one JAX CLI run compiles for
4-10 s): CONVECTION_CPU8 below.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectral_tpu.grid import Grid as JGrid
from spectral_tpu.models.convection import ConvectionConfig as JConfig
from spectral_tpu.models.convection import ConvectionModel as JModel
from spectral_tpu.ops.chebyshev import cheb_pad_matrices_np as j_pad
from spectral_tpu.solvers.krylov import KSPConfig as JKSP
from spectral_tpu_torch.cli.main import main as t_main
from spectral_tpu_torch.grid import Grid
from spectral_tpu_torch.models.convection import ConvectionConfig, ConvectionModel
from spectral_tpu_torch.ops.chebyshev import cheb_pad_matrices_np
from spectral_tpu_torch.solvers.krylov import KSPConfig
from spectral_tpu_torch.utils.interop import convection_state_from_numpy, stokes_state_to_numpy

DIMS = (8, 8)
STOKES_KSP = dict(type="fgmres", rtol=1e-12, max_it=100, restart=50)

# stokes_oracle.py convcpu8 (the JAX package's convection driver on the
# CPU in float64): its printed lines after the two set-up lines, and the
# full-precision numbers captured as it ran.  "8x8 newton" from initial
# temperatures perturbed by 1e-13 (seeds 0-7) takes Krylov [5, 8, 11, 17,
# 20] (six seeds) or [5, 8, 11, 15, 22] (two): the last two counts move
# with the round-off of the start ("krylov_range").
CONVECTION_CPU8 = {
    "8x8 nsteps": dict(
        argv=["-dim", "8,8", "-nsteps", "10", "-stokes_pc", "dense"], rc=0,
        lines=["Steps: 10   converged: True",
               "Nu(top) = 1.113463   Nu(bottom) = 1.113463   Nu(volume) = 2.366339",
               "Vrms = 24.914888"],
        nu_top=1.1134626725411718, vrms=24.91488844595508),
    "8x8 newton": dict(
        argv=["-dim", "8,8", "-newton", "-warmup", "50", "-stokes_pc", "dense"], rc=0,
        lines=["Newton: 5 steps, Krylov [5, 8, 11, 17, 20], |R| = 2.215e-08",
               "Steps: 117   converged: True",
               "Nu(top) = 4.566443   Nu(bottom) = 4.566443   Nu(volume) = 5.052967",
               "Vrms = 43.532464"],
        nu_top=4.5664433733250025, vrms=43.53246402830251, newton=5,
        krylov_range=([5, 8, 11, 15, 20], [5, 8, 11, 17, 22])),
    "8x8 stability": dict(
        argv=["-dim", "8,8", "-stability", "1", "-stokes_pc", "dense"], rc=0,
        lines=["Critical Rayleigh number Ra_c = 779.268214  (converged: True, 22 operator "
               "applications)   Ra/Ra_c = 12.8326"],
        mu=0.001283255215892341, matvecs=22),
    # 15 accepted steps of march_adaptive, not converged (exit code 2)
    "8x8 adapt": dict(
        argv=["-ts_adapt", "-dim", "8,8", "-ra", "5e3", "-dt", "1e-3", "-ts_dt0", "2e-5",
              "-max_steps", "15", "-stokes_pc", "dense"], rc=2,
        lines=["  ts_adapt: 15 accepted / 1 rejected, dt 2e-05 .. 0.0022",
               "Steps: 15   converged: False",
               "Nu(top) = 1.089257   Nu(bottom) = 1.089257   Nu(volume) = 1.526545",
               "Vrms = 10.652779"]),
}

def _rel(got, ref) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _pair(dims=DIMS, **cfg):
    """(JAX model, port model) on the unit box with the same configuration."""
    jm = JModel.unit_box(dims, JConfig(stokes_ksp=JKSP(**STOKES_KSP), **cfg))
    tm = ConvectionModel.unit_box(dims, ConvectionConfig(stokes_ksp=KSPConfig(**STOKES_KSP),
                                                         **cfg), device="cpu")
    return jm, tm


def _field(tm, seed: int) -> np.ndarray:
    """A seeded interior field (zero boundary), numpy float64."""
    a = np.random.default_rng(seed).standard_normal(tm.grid.dims)
    return np.where(tm.grid.boundary_mask_np, 0.0, a)


def _cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = t_main(["convection", *argv, "-device", "cpu"])
    return rc, buf.getvalue().splitlines()


def test_quadrature_and_pad_matrices_match_jax():
    """Clenshaw-Curtis weights and the dealiasing transfers are host numpy
    in both packages: equal bit for bit."""
    ivals = ((0.0, 2.0), (1.0, 4.0))
    g, jg = Grid((9, 11), intervals=ivals, device="cpu"), JGrid((9, 11), intervals=ivals)
    assert np.array_equal(g.quad_weights_np, jg.quad_weights_np)
    assert all(np.array_equal(a, b) for a, b in zip(g.quad_weights_1d_np, jg.quad_weights_1d_np))
    assert g.quad_weights_np.sum() == pytest.approx(6.0, abs=1e-12)
    for n, m in ((8, 12), (12, 18), (5, 9)):
        U, D = cheb_pad_matrices_np(n, m)
        Uj, Dj = j_pad(n, m)
        assert np.array_equal(U, Uj) and np.array_equal(D, Dj)
        assert np.abs(D @ U - np.eye(n)).max() < 1e-12
    with pytest.raises(ValueError, match="m >= n"):
        cheb_pad_matrices_np(8, 6)


@pytest.fixture(scope="module")
def nested8():
    """The no-slip, conducting-sidewall model on the nested saddle tree,
    and the JAX step (its body, ConvectionModel.step without heating)
    with its Stokes solve's outer count, one program."""
    jm, tm = _pair(velocity_bc="noslip", side_bc="conducting", Ra=1e4, dt=1e-3)

    @jax.jit
    def step(T, N_prev, x_prev):
        res = jm.solve_stokes(T, x_prev)
        N = jm.advection(jm.velocity_full(res.x), T)
        return (jm.heat.step(T, -(1.5 * N - 0.5 * N_prev), jm.bc_T), N, res.x), res.iters

    return jm, tm, step


@pytest.fixture(scope="module")
def dense8():
    """The free-slip, insulated model (Blankenbach's boundaries) on the
    dense saddle PC, and its jitted JAX step."""
    jm, tm = _pair(velocity_bc="freeslip", side_bc="insulated", Ra=1e4, dt=5e-4,
                   stokes_pc="dense")
    return jm, tm, jax.jit(jm.step)


@pytest.mark.parametrize("case", ["noslip nested", "freeslip dense"])
def test_step_matches_jax(case, nested8, dense8):
    """One coupled step (Stokes solve, AB2 advection, theta diffusion) from
    the same seeded temperature, advection history and warm start."""
    if case == "noslip nested":
        jm, tm, jstep = nested8
        jstep = (lambda f: lambda *a: f(*a)[0])(jstep)
        T0 = tm.conductive_state(amp=0.05, kind="sin").numpy()
    else:
        jm, tm, jstep = dense8
        T0 = tm.conductive_state(amp=0.05).numpy()
    T = T0 + 1e-2 * _field(tm, 1)
    N = 10.0 * _field(tm, 2)
    x = {"v": np.zeros(DIMS + (2,)), "p": np.zeros(DIMS)}
    Tj, Nj, xj = jstep(jnp.asarray(T), jnp.asarray(N), jax.tree.map(jnp.asarray, x))
    Tt, xt_in = convection_state_from_numpy(T, x, device="cpu", dtype=torch.float64)
    Tn, Nn, xn = tm.step(Tt, torch.as_tensor(N), xt_in)
    assert _rel(Tn, Tj) < 1e-11
    assert _rel(Nn, Nj) < 1e-11
    xn_np = stokes_state_to_numpy(xn)
    assert _rel(xn_np["v"], xj["v"]) < 1e-11
    assert _rel(xn_np["p"], xj["p"]) < 1e-11
    if case == "freeslip dense":
        # the diagnostics of the stepped state
        for name in ("nusselt_top", "nusselt_bottom", "vrms"):
            arg = xn if name == "vrms" else Tn
            jarg = xj if name == "vrms" else Tj
            assert float(getattr(tm, name)(arg)) == pytest.approx(
                float(getattr(jm, name)(jarg)), rel=1e-12)
        assert float(tm.nusselt_volume(Tn, xn)) == pytest.approx(
            float(jm.nusselt_volume(Tj, xj)), rel=1e-12)


def test_rollout_matches_jax(nested8):
    """A 10-step rollout on the nested tree: the JAX step ten times from
    the port's initial carry; the outer counts of every step within 1,
    T, Nu and Vrms to 1e-9."""
    jm, tm, jstep = nested8
    T0 = tm.conductive_state(amp=0.05, kind="sin")
    counts = []
    solve = tm.solve_stokes

    def counted(*a, **kw):
        res = solve(*a, **kw)
        counts.append(res.iters)
        return res

    tm.solve_stokes = counted
    try:
        T, _, x = tm.rollout(T0, 10)
        carry = tm.init_carry(T0)
    finally:
        del tm.solve_stokes
    jc = (jnp.asarray(carry[0].numpy()), jnp.asarray(carry[1].numpy()),
          jax.tree.map(jnp.asarray, stokes_state_to_numpy(carry[2])))
    jcounts = []
    for _ in range(10):
        jc, it = jstep(*jc)
        jcounts.append(int(it))
    assert max(abs(a - b) for a, b in zip(counts[1:11], jcounts)) <= 1, (counts, jcounts)
    assert _rel(T, jc[0]) < 1e-9
    assert float(tm.nusselt_top(T)) == pytest.approx(float(jm.nusselt_top(jc[0])), rel=1e-9)
    assert float(tm.vrms(x)) == pytest.approx(float(jm.vrms(jc[2])), rel=1e-9)


def test_dealiased_advection_matches_jax():
    """The 3/2-rule advection (padded products, truncated back) on the
    same velocity and temperature."""
    jm, tm = _pair(dealias=True)
    rng = np.random.default_rng(5)
    v = rng.standard_normal(DIMS + (2,))
    T = tm.conductive_state(amp=0.05).numpy() + 1e-2 * _field(tm, 6)
    got = tm.advection(torch.as_tensor(v), torch.as_tensor(T))
    ref = jm.advection(jnp.asarray(v), jnp.asarray(T))
    assert _rel(got, ref) < 1e-12
    tm._dealias = None   # plain collocation: the aliased modes differ
    assert _rel(got, tm.advection(torch.as_tensor(v), torch.as_tensor(T))) > 1e-6


def test_lagged_dense_chunks_match_jax():
    """Variable viscosity (contrast 10) on the lagged dense PC, refreshed
    every 2 steps: three steps from the same carry, two chunks (the
    factorization assembled and inverted from each chunk-head
    temperature), against the JAX package's refresh and step in the order
    of its _scan_steps."""
    jm, tm = _pair(velocity_bc="freeslip", side_bc="insulated", Ra=2e3, dt=2e-4,
                   eta_contrast=10.0, stokes_pc="dense", stokes_pc_lag=2)
    carry = tm.init_carry(tm.conductive_state(amp=0.05))
    refreshes = []
    refresh = tm._pc_refresh
    tm._pc_refresh = lambda T: refreshes.append(1) or refresh(T)
    out = tm._scan_steps(carry, 3)
    assert len(refreshes) == 2
    jcarry = (jnp.asarray(carry[0].numpy()), jnp.asarray(carry[1].numpy()),
              jax.tree.map(jnp.asarray, stokes_state_to_numpy(carry[2])))
    refresh = jax.jit(lambda T: jm._pc_setup(None, jm._lin_of(T)))
    step = jax.jit(lambda c, pc: jm.step(*c, pc_state=pc))
    ref = jcarry
    for i in range(3):   # JAX's _scan_steps at lag 2: chunks of 2 and 1
        if i % 2 == 0:
            pc = refresh(ref[0])
        ref = step(ref, pc)
    assert _rel(out[0], ref[0]) < 1e-11
    assert _rel(out[2]["v"], ref[2]["v"]) < 1e-10
    # eta(T) and the linearization follow the temperature
    assert _rel(tm._lin_of(out[0])[0], jm._lin_of(ref[0])[0]) < 1e-11


def test_cli_matches_jax(monkeypatch):
    """The port's convection CLI at 8x8 prints the JAX CLI's lines
    (CONVECTION_CPU8), and the model calls behind them give the JAX
    package's full-precision numbers: a 10-step rollout (Nu and Vrms to
    1e-10), the direct Newton steady state (the Newton count equal, the
    Krylov counts within the range the JAX package spans from perturbed
    starts, Nu and Vrms to 1e-8), the critical Rayleigh number (1e-8, the
    operator applications equal) and 15 steps of the adaptive march (its
    accepted and rejected steps and dt range in the printed line)."""
    got = {}
    for key in ("rollout", "steady_newton", "critical_rayleigh"):
        orig = getattr(ConvectionModel, key)

        def wrapped(self, *a, _orig=orig, _key=key, **kw):
            got[_key] = (self, _orig(self, *a, **kw))
            return got[_key][1]

        monkeypatch.setattr(ConvectionModel, key, wrapped)
    for name, spec in CONVECTION_CPU8.items():
        got.clear()
        rc, lines = _cli(spec["argv"])
        assert rc == spec["rc"], (name, lines)
        assert lines[0].startswith("Convection  dim = [8,8]")
        lines, ref = lines[2:], spec["lines"]
        if name == "8x8 newton":
            krylov = [int(k) for k in lines[0].split("Krylov [")[1].split("]")[0].split(",")]
            lo, hi = spec["krylov_range"]
            assert lines[0].startswith(f"Newton: {spec['newton']} steps,")
            assert all(a <= k <= b for a, k, b in zip(lo, krylov, hi)), krylov
            lines, ref = lines[1:], ref[1:]
            info = got["steady_newton"][1][2]
            assert info["converged"] and info["newton"].iters == spec["newton"]
            assert info["steps"] == 50 + sum(krylov) + spec["newton"] + 1
            assert info["nu_top"] == pytest.approx(spec["nu_top"], rel=1e-8)
            assert info["vrms"] == pytest.approx(spec["vrms"], rel=1e-8)
        elif name == "8x8 nsteps":
            m, (T, _, x) = got["rollout"]
            assert float(m.nusselt_top(T)) == pytest.approx(spec["nu_top"], rel=1e-10)
            assert float(m.vrms(x)) == pytest.approx(spec["vrms"], rel=1e-10)
        elif name == "8x8 stability":
            ra_c, res = got["critical_rayleigh"][1]
            assert res.converged and res.matvecs == spec["matvecs"]
            assert ra_c == pytest.approx(1.0 / spec["mu"], rel=1e-8)
        assert lines == ref, name


def test_rollout_diff_checkpointed_gradient_and_saved_bytes():
    """rollout_diff(checkpoint=True) gives the plain loop's gradient (to
    1e-8 relative, the JAX test's gate; here 8x8 on the dense PC, its
    frozen operator differentiated through _stokes_solve_diff_const), and
    its memory grows sublinearly: the bytes autograd keeps outside the
    checkpointed segments, counted by a saved-tensor hook, grow at least
    3x less from 9 to 17 steps than the plain loop's (the CPU counterpart
    of the card's max_memory_allocated gate, phase 13c)."""
    cfg = ConvectionConfig(Ra=3e3, dt=1e-3, velocity_bc="freeslip", side_bc="insulated",
                           stokes_pc="dense",
                           stokes_ksp=KSPConfig(type="fgmres", rtol=1e-8, max_it=120, restart=60),
                           temp_ksp=KSPConfig(type="cg", rtol=1e-10, max_it=80))
    m = ConvectionModel.unit_box(DIMS, cfg, device="cpu")
    T0 = m.conductive_state(amp=0.05)
    m.rollout_diff(T0, 1)   # builds the cached solve (torch.func does not run under hooks)

    def run(n, ck):
        saved = []

        def pack(t):
            saved.append(t.numel() * t.element_size())
            return t

        Ra = torch.tensor(3e3, dtype=torch.float64, requires_grad=True)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            T, _ = m.rollout_diff(T0, n, Ra=Ra, checkpoint=ck)
            loss = m.nusselt_top(T)
        return float(torch.autograd.grad(loss, Ra)[0]), sum(saved)

    (g_plain, b9), (g_ck, c9) = run(9, False), run(9, True)
    assert g_ck == pytest.approx(g_plain, rel=1e-8)
    assert run(9, 3)[0] == pytest.approx(g_plain, rel=1e-8)
    (_, b17), (_, c17) = run(17, False), run(17, True)
    assert b17 - b9 > 0 and c17 - c9 < (b17 - b9) / 3.0, (c17 - c9, b17 - b9)


def test_steady_accelerated_matches_jax(monkeypatch):
    """Anderson acceleration over chunks of 2 coupled steps (AA(3) after 10
    warm-up steps, 6 iterations) on the dense PC at 8x8, Ra 1e4, through
    each package's CLI with -accel: the physical steps taken and the
    convergence flag equal, the temperature to 1e-8 relative, Nu and Vrms
    to 1e-8, the rate (a max over the map's residual) to 1e-6, the printed
    lines equal."""
    from spectral_tpu.cli.drivers import convection_main
    from spectral_tpu.utils.options import Options

    got = {}
    for owner, key in ((ConvectionModel, "torch"), (JModel, "jax")):
        orig = owner.steady_accelerated

        def wrapped(self, *a, _orig=orig, _key=key, **kw):
            got[_key] = _orig(self, *a, **kw)
            return got[_key]

        monkeypatch.setattr(owner, "steady_accelerated", wrapped)
    argv = ["-dim", "8,8", "-accel", "-accel_m", "3", "-chunk", "2", "-warmup", "10",
            "-max_steps", "12", "-stokes_pc", "dense", "-ksp_rtol", "1e-12", "-ksp_max_it", "100",
            "-ksp_gmres_restart", "50"]
    rc, lines = _cli(argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jrc = convection_main(Options(argv))
    (tT, _, tinfo), (jT, _, jinfo) = got["torch"], got["jax"]
    assert rc == jrc == 2 and lines[2] == f"Steps: {jinfo['steps']}   converged: False"
    assert lines == buf.getvalue().splitlines()
    assert tinfo["steps"] == jinfo["steps"] == 10 + 6 * 2
    assert tinfo["converged"] == jinfo["converged"] is False
    assert _rel(tT, jT) <= 1e-8
    for key in ("nu_top", "nu_bottom", "vrms"):
        assert tinfo[key] == pytest.approx(float(jinfo[key]), rel=1e-8), key
    assert tinfo["rate"] == pytest.approx(float(jinfo["rate"]), rel=1e-6)


def test_unported_paths_raise():
    """The checkpointed adaptive march on a mesh waits for ROADMAP item 7d
    (it runs in one process: tests/test_torch_utils.py), and -map, which
    the JAX driver does not read, is reported as an unused option as the
    JAX driver reports it (the Anderson steady state and -accel run:
    test_steady_accelerated_matches_jax)."""
    from spectral_tpu_torch.parallel import make_mesh

    tm = ConvectionModel.unit_box(DIMS, ConvectionConfig(), device="cpu",
                                  mesh=make_mesh({"x": 1}))
    with pytest.raises(NotImplementedError, match="item 7d"):
        tm.march_adaptive(tm.conductive_state(), checkpoint="ckpt")
    # the JAX driver's lines on this run end with the same warning (checked
    # against spectral_tpu.cli.drivers.convection_main when -map was ported)
    argv = ["-dim", "8,8", "-nsteps", "2", "-stokes_pc", "dense"]
    rc, lines = _cli(argv + ["-map", "bump:0.1"])
    assert rc == 0
    assert lines == _cli(argv)[1] + [
        "WARNING! There are options you set that were not used: ['map']"]
    with pytest.raises(ValueError, match="vertical"):
        ConvectionModel(Grid(DIMS, device="cpu"))
    with pytest.raises(ValueError, match="velocity_bc"):
        ConvectionModel.unit_box(DIMS, ConvectionConfig(velocity_bc="slip"), device="cpu")
