"""The port's optimization layer (spectral_tpu_torch.solvers.optimize:
L-BFGS with and without bounds, trust-region Newton-CG) against the JAX
package's on the cases of tests/test_optimize.py, on the CPU in float64.

Both packages run from the same start on the same objective (each
differentiates its own copy: ``jax.grad`` there, ``torch.func.grad``
here).  The host loops take the same decisions, so the iteration and
evaluation counts and the converged reason are equal, and every iterate
and objective value agrees to 1e-10 (relative to max(1, |value|)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectral_tpu.solvers import optimize as jopt
from spectral_tpu_torch.solvers import optimize as topt
from spectral_tpu_torch.utils.interop import optimize_result_to_numpy

TOL = 1e-10


def _rosen(np_):
    def f(t):
        return (1.0 - t["a"]) ** 2 + 100.0 * (t["b"] - t["a"] * t["a"]) ** 2
    return f


def _bowl(np_):
    def f(t):
        return (t["x"] ** 2 - 1.0) ** 2 + 0.5 * t["y"] ** 2
    return f


def _box(np_):
    def f(t):
        return (t["x"] - 2.0) ** 2 + (t["y"] + 1.0) ** 2
    return f


def _pos(np_):
    def f(t):
        return (t["a"] - 0.5) ** 2 + (t["b"] - 2.0) ** 2
    return f


def _jax_fns(make):
    f = make(jnp)
    grad = jax.grad(f)   # op by op, as tests/test_optimize.py runs it
    # the Hessian-vector product compiled once (Newton-CG calls it most)
    hvp = jax.jit(lambda t, v: jax.jvp(grad, (t,), (v,))[1])
    return (lambda t: (float(f(t)), grad(t))), hvp


def _torch_fns(make):
    f = make(torch)
    return (lambda t: (float(f(t)), torch.func.grad(f)(t)),
            lambda t, v: torch.func.jvp(torch.func.grad(f), (t,), (v,))[1])


def _assert_same(t_res, j_res):
    t, j = optimize_result_to_numpy(t_res), optimize_result_to_numpy(j_res)
    assert (t["iters"], t["nfev"], t["reason"]) == (j["iters"], j["nfev"], j["reason"])
    assert len(t["history"]) == len(j["history"])
    for a, b in zip(t["history"], j["history"]):
        assert abs(a - b) <= TOL * max(1.0, abs(b))
    for k in j["x"]:
        assert abs(t["x"][k] - j["x"][k]) <= TOL * max(1.0, abs(j["x"][k])), k
    assert abs(t["f"] - j["f"]) <= TOL * max(1.0, abs(j["f"]))


CASES = {
    # name: (objective, start, method, config, bounds)
    "lbfgs rosenbrock": (_rosen, {"a": -1.2, "b": 1.0}, "lbfgs",
                         dict(gtol=1e-8, max_it=300), None),
    "newton_cg rosenbrock": (_rosen, {"a": -1.2, "b": 1.0}, "ncg",
                             dict(gtol=1e-8, max_it=100), None),
    "newton_cg negative curvature": (_bowl, {"x": 0.05, "y": 0.8}, "ncg",
                                     dict(gtol=1e-9), None),
    "lbfgs active bounds": (_box, {"x": 0.0, "y": 2.0}, "lbfgs", dict(gtol=1e-10),
                            ({"x": -np.inf, "y": 0.0}, {"x": 1.0, "y": np.inf})),
    "lbfgs scalar bounds": (_pos, {"a": 3.0, "b": 3.0}, "lbfgs", dict(gtol=1e-10),
                            (1e-6, None)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_optimizer_matches_jax(name):
    make, x0, method, cfg, bounds = CASES[name]
    jvg, jhvp = _jax_fns(make)
    tvg, thvp = _torch_fns(make)
    jx0 = {k: jnp.asarray(v) for k, v in x0.items()}
    tx0 = {k: torch.tensor(v, dtype=torch.float64) for k, v in x0.items()}
    if method == "lbfgs":
        j = jopt.lbfgs_minimize(jvg, jx0, jopt.OptimizeConfig(**cfg), bounds=bounds)
        t = topt.lbfgs_minimize(tvg, tx0, topt.OptimizeConfig(**cfg), bounds=bounds)
    else:
        j = jopt.newton_cg_minimize(jvg, jhvp, jx0, jopt.OptimizeConfig(**cfg))
        t = topt.newton_cg_minimize(tvg, thvp, tx0, topt.OptimizeConfig(**cfg))
    assert j.reason > 0 and t.reason > 0, (j.reason_str(), t.reason_str())
    assert t.reason_str() == j.reason_str()
    _assert_same(t, j)


def test_optimizer_helpers():
    """The Steihaug boundary step and the projection on pytrees of tensors."""
    z = {"a": torch.tensor(0.3, dtype=torch.float64)}
    d = {"a": torch.tensor(1.0, dtype=torch.float64)}
    p, tau = topt._to_boundary(z, d, 2.0)
    assert float(p["a"]) == pytest.approx(2.0, abs=1e-15) and tau == pytest.approx(1.7)
    proj = topt._make_project((0.0, {"a": 1.0}))
    assert float(proj({"a": torch.tensor(3.0, dtype=torch.float64)})["a"]) == 1.0
    assert float(proj({"a": torch.tensor(-3.0, dtype=torch.float64)})["a"]) == 0.0
    r = topt.OptimizeResult({"a": z["a"]}, 1.0, 0.0, 1, 1, 3, [1.0])
    assert r.reason_str() == "CONVERGED_ATOL"
