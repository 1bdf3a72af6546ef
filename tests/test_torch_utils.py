"""The port's utilities against the JAX package's, on the CPU, in float64:
the -pc_type registry (solvers/pc.py), check_finite and fail-fast
(utils/debug.py), the native IO runtime and its blobs (utils/native.py),
checkpoints in either package's files (utils/checkpoint.py), PhaseTimer
and trace_summary (utils/profiling.py), the VTK writer (utils/vtk.py), the
rest of ops/chebyshev.py, the package exports, the graft entry, the
checkpointed continuation and adaptive march, the CLI's -checkpoint_dir,
-output_vtk and -log_summary, and the examples.  Inputs are made from
numpy seeds; each JAX side runs live.
"""

import contextlib
import io
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spectral_tpu
import spectral_tpu_torch
from chip_smoke import vtk_sections
from spectral_tpu.grid import Grid as JGrid
from spectral_tpu.models.stokes import StokesConfig as JConfig
from spectral_tpu.models.stokes import StokesProblem as JProblem
from spectral_tpu.ops import chebyshev as jcheb
from spectral_tpu.ops.curvilinear import named_map as j_named_map
from spectral_tpu.solvers import pc as jpc
from spectral_tpu.utils import checkpoint as jckpt
from spectral_tpu.utils import debug as jdebug
from spectral_tpu.utils import native as jnative
from spectral_tpu.utils.profiling import PhaseTimer as JPhaseTimer
from spectral_tpu.utils.vtk import write_stokes_vtk as j_write_vtk
from spectral_tpu_torch.cli.main import main as t_main
from spectral_tpu_torch.grid import Grid
from spectral_tpu_torch.models.convection import ConvectionConfig, ConvectionModel
from spectral_tpu_torch.models.stokes import StokesConfig, StokesProblem
from spectral_tpu_torch.ops import chebyshev as tcheb
from spectral_tpu_torch.ops.curvilinear import named_map
from spectral_tpu_torch.solvers import pc as tpc
from spectral_tpu_torch.utils import checkpoint as ckpt
from spectral_tpu_torch.utils import debug, native
from spectral_tpu_torch.utils.profiling import PhaseTimer, trace_summary
from spectral_tpu_torch.utils.vtk import write_stokes_vtk

F64 = torch.float64


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def run(main, argv) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


# -- solvers/pc.py -------------------------------------------------------------

def test_pc_registry_and_jacobi_on_a_dict_state():
    assert tpc.available_pcs() == jpc.available_pcs() == ["jacobi", "none", "shell"]
    rng = np.random.default_rng(0)
    r = {"v": rng.standard_normal((6, 5, 2)), "p": rng.standard_normal((6, 5))}
    d = {"v": 1.0 + rng.random((6, 5, 2)), "p": 1.0 + rng.random((6, 5))}
    z = tpc.pc_setup("jacobi", {k: _t(v) for k, v in d.items()})({k: _t(v) for k, v in r.items()})
    zj = jpc.pc_setup("jacobi", {k: jnp.asarray(v) for k, v in d.items()})(
        {k: jnp.asarray(v) for k, v in r.items()})
    assert list(z) == ["v", "p"]
    for k in r:
        np.testing.assert_array_equal(z[k].numpy(), np.asarray(zj[k]))
    x = _t(r["p"])
    assert tpc.pc_setup("none")(x) is x
    assert tpc.pc_setup("shell", torch.neg)(x).equal(-x)
    msgs = []
    for setup in (tpc.pc_setup, jpc.pc_setup):
        with pytest.raises(KeyError) as e:
            setup("lu")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# -- utils/debug.py ------------------------------------------------------------

@pytest.mark.parametrize("where", ["dict", "tuple", "nested"])
def test_check_finite_names_the_leaf_as_jax_does(where):
    rng = np.random.default_rng(1)
    a, b = rng.standard_normal(4), rng.standard_normal((2, 3))
    bad = a.copy()
    bad[2] = np.nan if where != "tuple" else np.inf
    tree = {"dict": lambda f, t: {"v": f(t), "p": f(b)},
            "tuple": lambda f, t: (f(a), f(t)),
            "nested": lambda f, t: (f(a), f(a), {"v": f(b), "p": f(t)}, f(a))}[where]
    debug.check_finite(tree(_t, a), "ok")
    msgs = []
    for check, f in ((debug.check_finite, _t), (jdebug.check_finite, jnp.asarray)):
        with pytest.raises(FloatingPointError) as e:
            check(tree(f, bad), "step 3 ")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_fail_fast_raises_at_the_first_nan_op_and_is_silent_off():
    x = torch.tensor([1.0, 2.0], dtype=F64)
    try:
        debug.enable_fail_fast()
        torch.empty(1000)   # uninitialized memory is not checked
        y = torch.exp(x)
        with pytest.raises(FloatingPointError, match="encountered in log"):
            torch.log(y - 10.0)
        jdebug.enable_fail_fast()
        with pytest.raises(FloatingPointError):
            jnp.log(jnp.exp(jnp.asarray([1.0, 2.0])) - 10.0)
    finally:
        debug.enable_fail_fast(False)
        jdebug.enable_fail_fast(False)
    assert torch.isnan(torch.log(x - 10.0)).all()


# -- utils/native.py -----------------------------------------------------------

def test_native_formatting_matches_python_and_jax_byte_for_byte():
    assert native.available()
    rng = np.random.default_rng(2)
    rows = rng.standard_normal((7, 3)) * 10.0 ** rng.integers(-20, 20, (7, 3))
    rows[0, 0], rows[1, 1] = 0.0, -0.0
    tensors = rng.standard_normal((4, 3, 3))
    assert native.format_rows(rows) == native.format_rows_py(rows) == jnative.format_rows(rows)
    assert (native.format_tensors(tensors) == native.format_tensors_py(tensors)
            == jnative.format_tensors(tensors))
    assert native.library_path().parent == native.BUILD_DIR   # never csrc/


def test_blobs_written_by_one_package_read_by_the_other(tmp_path, monkeypatch):
    a = np.random.default_rng(3).standard_normal(1000)
    native.write_blob(str(tmp_path / "t.blob"), a)
    np.testing.assert_array_equal(jnative.read_blob(str(tmp_path / "t.blob"), 1000), a)
    jnative.write_blob(str(tmp_path / "j.blob"), a)
    np.testing.assert_array_equal(native.read_blob(str(tmp_path / "j.blob"), 1000), a)
    monkeypatch.setattr(native, "_load", lambda: None)   # the Python path, same bytes
    native.write_blob(str(tmp_path / "p.blob"), a)
    assert (tmp_path / "p.blob").read_bytes() == (tmp_path / "t.blob").read_bytes()
    np.testing.assert_array_equal(native.read_blob(str(tmp_path / "j.blob"), 1000), a)


# -- utils/checkpoint.py -------------------------------------------------------

def _state(rng, kind):
    v, p = rng.standard_normal((5, 4, 2)), rng.standard_normal((5, 4))
    if kind == "dict":
        return {"v": v, "p": p}
    T = rng.standard_normal((5, 4))
    return (T, 2.0 * T, {"v": v, "p": p}, 3.0 * T)   # march_adaptive's carry


@pytest.mark.parametrize("kind", ["dict", "tuple"])
def test_checkpoints_cross_read_with_jax_leaf_order(tmp_path, kind):
    s = _state(np.random.default_rng(4), kind)
    tmap = lambda f, t: ({k: f(t[k]) for k in t} if isinstance(t, dict)   # noqa: E731
                         else tuple(tmap(f, c) for c in t) if isinstance(t, tuple) else f(t))
    ts, js = tmap(_t, s), tmap(jnp.asarray, s)
    meta = {"dt": 1e-3, "dt_stab": 1e300, "steps": 12}
    ckpt.save_state(str(tmp_path / "t"), 12, ts, meta)
    jckpt.save_state(str(tmp_path / "j"), 12, js, meta)
    for d in ("t", "j"):
        with open(tmp_path / d / "step_0012.npz.json") as f:
            side = json.load(f)
        assert side["treedef"] == str(jax.tree_util.tree_structure(js))
        assert side["meta"] == meta and side["step"] == 12
        assert list(np.load(tmp_path / d / "step_0012.npz").files) == [
            f"arr_{i}" for i in range(len(jax.tree_util.tree_leaves(js)))]
    got_t = ckpt.load_state(str(tmp_path / "j"), 12, ts)     # JAX's file, the port reads
    got_j = jckpt.load_state(str(tmp_path / "t"), 12, js)    # the port's file, JAX reads
    for a, b, c in zip(jax.tree_util.tree_leaves(tmap(_np, got_t)),
                       jax.tree_util.tree_leaves(got_j), jax.tree_util.tree_leaves(s)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(np.asarray(b), c)
    assert ckpt.load_meta(str(tmp_path / "j"), 12) == meta


def test_checkpoint_keeps_the_saved_dtype_and_finds_five_digit_steps(tmp_path):
    d = str(tmp_path)
    for step in (3, 9999, 10000):
        ckpt.save_state(d, step, {"x": torch.arange(3, dtype=torch.float32)})
    assert ckpt.latest_step(d) == jckpt.latest_step(d) == 10000
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    y = ckpt.load_state(d, 10000, {"x": torch.zeros(3, dtype=F64)})
    assert y["x"].dtype == torch.float32 and y["x"].tolist() == [0.0, 1.0, 2.0]


# -- utils/profiling.py --------------------------------------------------------

def test_phase_timer_summary_and_trace_summary(tmp_path):
    timers = (PhaseTimer("cpu"), JPhaseTimer())
    for t in timers:
        t.totals.update({"SNESSolve": 1.25, "setup": 0.5})
        t.counts.update({"SNESSolve": 2, "setup": 1})
    assert timers[0].summary() == timers[1].summary()
    t = PhaseTimer("cpu")
    for _ in range(2):
        with t.phase("a", sync=True):
            pass
    assert t.counts["a"] == 2 and t.summary().splitlines()[1].startswith("a ")
    x = torch.ones(128, 128)
    s = trace_summary(lambda: [x @ x for _ in range(3)], trace_dir=str(tmp_path))
    assert s["wall_ms"] > 0 and s["planes"]["/host:CPU"] > 0
    assert s["device_busy_ms"] == 0 and s["device_event_count"] == 0   # no device here
    assert len(list(tmp_path.glob("trace-*.json"))) == 1


# -- ops/chebyshev.py ----------------------------------------------------------

def test_cheb_eval_gradient_and_cgl_nodes_match_jax():
    rng = np.random.default_rng(5)
    u = rng.standard_normal((9, 7, 3))
    x = np.cos(rng.random(11) * np.pi)
    for axis in (0, 1, -1):
        got = tcheb.cheb_eval(_t(u), _t(x), axis=axis).numpy()
        ref = np.asarray(jcheb.cheb_eval(jnp.asarray(u), jnp.asarray(x), axis=axis))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-14 * np.abs(ref).max())
    for g, r in zip(tcheb.gradient(_t(u), 2), jcheb.gradient(jnp.asarray(u), 2)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-14 * np.abs(np.asarray(r)).max())
    np.testing.assert_array_equal(tcheb.cgl_nodes(9, device="cpu").numpy(),
                                  np.asarray(jcheb.cgl_nodes(9)))
    assert tcheb.cgl_nodes(5, torch.float32, "cpu").dtype == torch.float32


def test_production_path_toggle():
    orig = tcheb.production_path()
    assert orig == "kernel"   # the port's default (the JAX package's: "matmul")
    u = _t(np.random.default_rng(6).standard_normal((6, 7)))
    ref = tcheb.chebdiff(u, -1)
    try:
        tcheb.set_production_path("pallas")
        assert tcheb.production_path() == "kernel"
        tcheb.set_production_path("matmul")
        assert tcheb.production_path() == "matmul"
        assert tcheb.chebdiff(u, -1).equal(ref)   # a CPU tensor takes the matmul path
        with pytest.raises(ValueError):
            tcheb.set_production_path("nope")
    finally:
        tcheb.set_production_path(orig)


def test_exports_match_jax():
    assert spectral_tpu_torch.__all__ == spectral_tpu.__all__
    for name in spectral_tpu_torch.__all__:
        assert getattr(spectral_tpu_torch, name) is not None, name
    with pytest.raises(AttributeError):
        spectral_tpu_torch.nope   # noqa: B018


# -- utils/vtk.py --------------------------------------------------------------

def vtk_agrees(path, ref, tol):
    """The VTK file ``path`` has ``ref``'s sections and header lines, and
    each section's values within ``tol`` of that section's largest in
    ``ref``; returns ``path``'s sections."""
    ts, js = vtk_sections(path), vtk_sections(ref)
    assert [h for h, _ in ts] == [h for h, _ in js]
    for (head, a), (_, b) in zip(ts, js):
        assert a.shape == b.shape, head
        if b.size:
            np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max(), err_msg=head)
    return ts


VTK_CASES = {
    "flat": dict(cfg=dict(exact=2, rheology=1, exponent=3.0, regularization=1e-2, cont=2),
                 phi=None, bc_scale=0.7, extra=True),
    "annulus": dict(cfg=dict(exact=0, boundary=3, rheology=1, exponent=3.0,
                             regularization=1e-3, cont=2),
                    phi="annulus:1:2", bc_scale=1.0, extra=False),
}


@pytest.mark.parametrize("case", sorted(VTK_CASES))
def test_vtk_matches_jax(tmp_path, case):
    spec = VTK_CASES[case]
    jp = JProblem(JGrid((8, 8)), JConfig(**spec["cfg"]),
                  phi=None if spec["phi"] is None else j_named_map(spec["phi"]))
    tp = StokesProblem(Grid((8, 8), device="cpu", dtype=F64), StokesConfig(**spec["cfg"]),
                       phi=None if spec["phi"] is None else named_map(spec["phi"]))
    rng = np.random.default_rng(7)
    v, p = rng.standard_normal((8, 8, 2)), rng.standard_normal((8, 8))
    temp = rng.standard_normal((8, 8))
    kw = dict(bc_scale=spec["bc_scale"])
    j_write_vtk(jp, {"v": jp.mask_v(jnp.asarray(v)), "p": jnp.asarray(p)}, str(tmp_path / "j.vtk"),
                extra_scalars={"temperature": jnp.asarray(temp)} if spec["extra"] else None, **kw)
    write_stokes_vtk(tp, {"v": tp.mask_v(_t(v)), "p": _t(p)}, str(tmp_path / "t.vtk"),
                     extra_scalars={"temperature": _t(temp)} if spec["extra"] else None, **kw)
    ts = vtk_agrees(tmp_path / "t.vtk", tmp_path / "j.vtk", 1e-12)
    assert any("SCALARS temperature" in line for h, _ in ts for line in h) == spec["extra"]


# -- the graft entry -----------------------------------------------------------

def test_graft_entry_matches_jax_at_8_cubed():
    from spectral_tpu_torch.graft_entry import entry

    forward, (x,) = entry((8, 8, 8), device="cpu")
    out = forward(x)
    cfg = JConfig(exact=2, rheology=1, exponent=3.0, regularization=1e-2)
    jp = JProblem(JGrid((8, 8, 8)), cfg)
    F, lin = jp.make_residual(jp.params_at(cfg.cont))(jp.zero_state())
    ref = {"F": F, "JF": jp.jacobian_action(jp.zero_state(), lin, F)}
    for k in ("F", "JF"):
        for f in ("v", "p"):
            r = np.asarray(ref[k][f])
            np.testing.assert_allclose(out[k][f].numpy(), r, rtol=0, atol=1e-12 * np.abs(r).max())


# -- the checkpointed continuation and the CLI -----------------------------------

CLI_DIR = os.path.join(os.path.dirname(__file__), "data", "torch_cli_outputs")


def recorded(name):
    """The JAX driver's run of ``name``'s command line at 8x8, as
    ``stokes_oracle.py clioutputs`` recorded it (the three JAX runs cost
    ~45 s of compiles, more than this file's budget)."""
    with open(f"{CLI_DIR}/{name}.json") as f:
        return json.load(f)


def shared_lines(out):
    """The lines both packages' drivers print: without the port's own count
    lines and the SNESSolve row's times, which the recording leaves out."""
    return [ln for ln in out.splitlines() if not ln.startswith(
        ("WARNING", "Continuation steps", "Outer iterations each step", "SNESSolve"))]


def continuation_counts(out):
    m = re.search(r"Continuation steps: Newton (\[.*\])  Krylov (\[.*\])", out)
    assert m, out
    return json.loads(m.group(1)), json.loads(m.group(2))


def test_stokes_cli_checkpoint_vtk_log_summary(tmp_path, monkeypatch):
    """The three options at 8x8 against the JAX driver on the same command
    line: its printed lines, per-step Newton and Krylov counts, checkpoint
    metas, and stokes.vtk within 1e-11 of each section's largest value (the
    two solves' states differ at round-off, ~2e-14 here).  Then the same
    after deleting the last step: the resumed run solves that step alone,
    as the JAX driver's resumed run did.  On the complete directory both
    packages' solve_continuation return [] (the JAX one reads the port's
    files)."""
    ref = recorded("stokes")
    argv = [*ref["argv"], "-device", "cpu"]
    monkeypatch.chdir(tmp_path)
    rc, out = run(t_main, argv)
    assert rc == 0 and shared_lines(out) == ref["lines"], out
    assert re.search(r"^SNESSolve +1 +\d+\.\d{4} +\d+\.\d{4}$", out, re.M)
    assert continuation_counts(out) == (ref["counts"]["newton"], ref["counts"]["krylov"])
    last = ckpt.latest_step("ck")
    metas = [ckpt.load_meta("ck", i) for i in range(last + 1)]
    assert [m.keys() for m in metas] == [m.keys() for m in ref["meta"]]
    for m, r in zip(metas, ref["meta"]):
        assert m["reason"] == r["reason"]
        assert [m["exponent"], m["regularization"]] == pytest.approx(
            [r["exponent"], r["regularization"]], rel=1e-15)
    vtk_agrees("stokes.vtk", f"{CLI_DIR}/stokes.vtk", 1e-11)
    for f in (f"ck/step_{last:04d}.npz", f"ck/step_{last:04d}.npz.json", "stokes.vtk"):
        os.remove(f)
    rc, out = run(t_main, argv)
    assert rc == 0 and shared_lines(out) == ref["resumed_lines"], out
    assert continuation_counts(out) == (ref["resumed_counts"]["newton"],
                                        ref["resumed_counts"]["krylov"])
    vtk_agrees("stokes.vtk", f"{CLI_DIR}/stokes_resumed.vtk", 1e-11)
    cfg = dict(exact=2, rheology=1, cont=2, regularization=1e-2, exponent=3.0)
    p = StokesProblem(Grid((8, 8), device="cpu", dtype=F64), StokesConfig(**cfg))
    assert p.solve_continuation(checkpoint_dir="ck") == []
    assert JProblem(JGrid((8, 8)), JConfig(**cfg)).solve_continuation(checkpoint_dir="ck") == []


@pytest.mark.parametrize("name", ["ustokes", "convection"])
def test_unsteady_and_convection_output_vtk(tmp_path, monkeypatch, name):
    """``-output_vtk`` at 8x8 against the JAX driver on the same command
    line: its printed lines, and the VTK file (convection's with the
    temperature) within 1e-11 of each section's largest value (after the
    steps' Krylov solves the states differ at round-off, ~5e-13 here)."""
    ref = recorded(name)
    monkeypatch.chdir(tmp_path)
    rc, out = run(t_main, [*ref["argv"], "-device", "cpu"])
    assert rc == 0 and shared_lines(out) == ref["lines"], out
    ts = vtk_agrees(f"{name}.vtk", f"{CLI_DIR}/{name}.vtk", 1e-11)
    assert any("SCALARS temperature" in line for h, _ in ts for line in h) == (
        name == "convection")


MARCH_NPZ = "tests/data/torch_march_oracle.npz"
MARCH_DIR = "tests/data/torch_march_checkpoint"


def test_resumed_march_adaptive_matches_jax(tmp_path):
    """``stokes_oracle.py march``: the JAX package marched 20 adaptive
    steps at 8x8 saving every 10, and resumed from its step-20 files to
    step 40 (a live JAX run costs ~10 s of compiles).  The port writes the
    same step-20 files (leaves and meta within 1e-10), and resumed from the
    JAX package's files takes its steps: counts and dts equal, T within
    1e-10."""
    import shutil

    ref = np.load(MARCH_NPZ)
    kw = dict(Ra=5e3, dt=1e-3, velocity_bc="freeslip", side_bc="insulated", stokes_pc="dense")
    m = ConvectionModel.unit_box((8, 8), ConvectionConfig(**kw), device="cpu")
    T0 = m.conductive_state(amp=0.05)
    np.testing.assert_array_equal(T0.numpy(), ref["T0"])
    march = dict(tol=1e-12, rtol=3e-3, dt0=2e-5)
    own = str(tmp_path / "own")
    m.march_adaptive(T0, max_steps=20, checkpoint=own, checkpoint_every=10, **march)
    assert ckpt.latest_step(own) == 20
    like = (T0, T0, m.stokes.zero_state(), T0)
    for a, b in zip(jax.tree_util.tree_leaves(ckpt.load_state(own, 20, like)),
                    jax.tree_util.tree_leaves(ckpt.load_state(MARCH_DIR, 20, like))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-10)
    meta, jmeta = ckpt.load_meta(own, 20), ckpt.load_meta(MARCH_DIR, 20)
    assert meta.keys() == jmeta.keys() and meta["dt_stab"] == 1e300
    np.testing.assert_allclose([meta[k] for k in meta], [jmeta[k] for k in meta], rtol=1e-10)
    work = str(tmp_path / "jax")   # the resumed run saves steps 30 and 40 beside it
    shutil.copytree(MARCH_DIR, work)
    T, _, info = m.march_adaptive(T0, max_steps=40, checkpoint=work, checkpoint_every=10,
                                  resume=True, **march)
    assert [info["steps"], info["rejects"]] == ref["counts"].tolist()
    np.testing.assert_allclose(info["dts"], ref["dts"], rtol=1e-10)
    np.testing.assert_allclose(T.numpy(), ref["T"], rtol=0, atol=1e-10)
    assert ckpt.latest_step(work) == 40


# -- the examples ----------------------------------------------------------------

def test_examples_on_the_cpu(tmp_path, monkeypatch):
    """shell_demo and nk_demo against the JAX examples run live with the
    same options: shell_demo's line equal; nk_demo's Newton line and
    counts equal but the last Krylov count within 1 and the round-off
    sized last fnorm and error within 10x (the repo's rule for the last
    solve of a Newton run, test_torch_stokes.py).  The sharded Poisson
    example on a mesh of one (in this process) against the JAX example's
    solve (examples/sharded_poisson_demo.py) on a mesh of one device, at
    8^3: that script fixes a 2 x 2 mesh of forced host devices, which a
    process whose JAX has started cannot make."""
    from examples import nk_demo as j_nk_demo
    from examples import shell_demo as j_shell_demo
    from spectral_tpu.models.poisson import PoissonModel as JPoisson
    from spectral_tpu.parallel.mesh import make_mesh as j_make_mesh
    from spectral_tpu.solvers.krylov import KSPConfig as JKSPConfig
    from spectral_tpu_torch.examples import nk_demo, sharded_poisson_demo, shell_demo

    monkeypatch.chdir(tmp_path)
    argv = ["-munge"]
    rc, out = run(shell_demo.main, [*argv, "-device", "cpu"])
    jrc, jout = run(j_shell_demo.main, argv)
    assert rc == jrc == 0 and out == jout, (out, jout)

    argv = ["-user_precond", "-rhistory"]
    rc, out = run(nk_demo.main, [*argv, "-device", "cpu"])
    jrc, jout = run(j_nk_demo.main, argv)
    assert rc == jrc == 0, (out, jout)
    (newton, err, fnorms, ksp), (jnewton, jerr, jfnorms, jksp) = (
        o.splitlines() for o in (out, jout))
    assert newton == jnewton and newton.startswith("Newton iterations = ")
    err, jerr = (float(e.split(": ")[1]) for e in (err, jerr))
    assert jerr / 10 <= err <= 10 * jerr
    fnorms, jfnorms, ksp, jksp = (json.loads(ln.split(": ")[1].replace("'", '"'))
                                  for ln in (fnorms, jfnorms, ksp, jksp))
    assert fnorms[:-1] == jfnorms[:-1]
    assert float(jfnorms[-1]) / 10 <= float(fnorms[-1]) <= 10 * float(jfnorms[-1])
    assert ksp[:-1] == jksp[:-1] and abs(ksp[-1] - jksp[-1]) <= 1

    rc, out = run(sharded_poisson_demo.main, ["-device", "cpu", "-np", "1", "-dim", "8,8,8"])
    mesh = j_make_mesh({"x": 1})
    m = JPoisson(JGrid((8, 8, 8)), mesh=mesh, axis_map={0: "x"})
    u, f = m.exact_solution()
    ksp = JKSPConfig(type="gmres", rtol=1e-10, max_it=100)
    M = m.build_pc("fastdiag")
    with mesh:
        res = jax.jit(lambda bb: ksp.solve(m.operator, bb, M=M))(m.rhs(u, f))
    jline = f"iterations {int(res.iters)}  error {float(jnp.max(jnp.abs(res.x - u))):.2e}"
    assert rc == 0 and out.splitlines()[1].startswith(jline + "  "), (out, jline)
