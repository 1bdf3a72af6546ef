"""Adjoint sensitivities: gradients of solution functionals through the
implicit function theorem.

Counterpart of ``spectral_tpu/solvers/adjoint.py``.  For a parameterized
nonlinear system F(x, theta) = 0 with solution x*(theta) and a quantity
of interest q(x, theta),

    dq/dtheta = dq/dtheta|_x  -  lambda^T dF/dtheta,
    where  J^T lambda = dq/dx|_theta,   J = dF/dx at (x*, theta).

- the transposed Jacobian action J^T lambda is a ``torch.func.vjp`` of
  the residual, built once a call and applied at every Krylov iteration
  (a vjp function may be called many times): no operator is formed, and
  its last-axis derivatives run K1^T on a CUDA state;
- the adjoint linear solve is the package's Krylov solve, optionally
  preconditioned: one linear solve a gradient, whatever the number of
  parameters (reverse mode);
- the parameter contraction lambda^T dF/dtheta is a second vjp.

States and parameters are tensors, dicts of tensors (a Stokes state
{"v", "p"}), ``PowerLawParams`` (a registered pytree) or Python floats,
which become 0-d float64 tensors on the state's device (they promote no
state tensor); a gradient has theta's structure, with tensor leaves.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
import torch.utils._pytree as pytree

from spectral_tpu_torch.solvers.krylov import KSPConfig
from spectral_tpu_torch.solvers.types import SolveResult


def _device(x) -> torch.device:
    return pytree.tree_leaves(x)[0].device


def _like(ref, t):
    """t with ref's dict key order (the Krylov solves return a dict state
    in sorted key order; ``torch.func`` wants a cotangent or tangent with
    the structure of its primal)."""
    if isinstance(ref, dict):
        return {k: _like(ref[k], t[k]) for k in ref}
    return t


def transpose_op(fn: Callable, x) -> Callable:
    """w -> (dfn/dx)^T w at x: one ``torch.func.vjp`` of fn, applied as
    often as the caller likes (each application is one backward pass)."""
    out, vjp = torch.func.vjp(fn, x)
    return lambda w: vjp(_like(out, w))[0]


def as_tensors(theta, device: torch.device):
    """theta with every Python number leaf as a 0-d float64 tensor on
    ``device`` (``torch.func`` differentiates tensors only)."""
    return pytree.tree_map(
        lambda a: a if isinstance(a, torch.Tensor)
        else torch.tensor(float(a), dtype=torch.float64, device=device), theta)


def _default_ksp() -> KSPConfig:
    return KSPConfig(type="gmres", rtol=1e-10, max_it=500)


def implicit_gradient(residual: Callable[[Any, Any], Any],
                      qoi: Callable[[Any, Any], torch.Tensor],
                      x_star: Any, theta: Any, *,
                      ksp: KSPConfig | None = None,
                      M: Optional[Callable] = None,
                      null_project: Optional[Callable] = None,
                      ) -> tuple[Any, SolveResult]:
    """Gradient of ``qoi(x*(theta), theta)`` where ``residual(x*, theta) = 0``.

    ``residual(x, theta)`` returns a state shaped like x (zero at x*) and
    must be differentiable by ``torch.func`` in both arguments;
    ``qoi(x, theta)`` a scalar.  ``M`` / ``null_project``: a
    preconditioner and null-space projector for the adjoint solve (J^T's
    null space is the transpose side; for the Stokes constant-pressure mode
    the same projector applies).  Returns (grad_theta with theta's
    structure, the adjoint SolveResult): check ``reason > 0`` before
    trusting the gradient.
    """
    ksp = ksp or _default_ksp()
    theta = as_tensors(theta, _device(x_star))
    gx, gtheta = torch.func.grad(qoi, argnums=(0, 1))(x_star, theta)
    At = transpose_op(lambda x: residual(x, theta), x_star)
    res = ksp.solve(At, gx, M=M, null_project=null_project)
    dF_theta = transpose_op(lambda th: residual(x_star, th), theta)(res.x)
    return pytree.tree_map(torch.sub, gtheta, dF_theta), res


def implicit_hvp(residual: Callable[[Any, Any], Any],
                 qoi: Callable[[Any, Any], torch.Tensor],
                 x_star: Any, theta: Any, lam: Any, v: Any, *,
                 ksp: KSPConfig | None = None,
                 M: Optional[Callable] = None,
                 Mt: Optional[Callable] = None,
                 null_project: Optional[Callable] = None,
                 ) -> tuple[Any, SolveResult, SolveResult]:
    """Hessian-vector product of the reduced objective phi(theta) =
    qoi(x*(theta), theta): returns (H v, tangent SolveResult,
    second-adjoint SolveResult).  Two linear solves a product, whatever
    the number of parameters:

      1. tangent:        J xdot = -F_theta v          (forward operator, M)
      2. second adjoint: J^T lamdot = q_x' - (F_x^T lam)'   (transpose, Mt)
      3. H v = q_theta' - (F_theta^T lam)' - F_theta^T lamdot

    where (.)' is the directional derivative along (xdot, v), a
    ``torch.func.jvp`` of ``torch.func.grad`` and of a vjp (forward over
    reverse); no Hessian is formed.  ``lam`` is the first-order adjoint
    (J^T lam = q_x, the ``x`` of implicit_gradient's SolveResult).  The
    matvec of Newton-CG on PDE-constrained objectives.
    """
    ksp = ksp or _default_ksp()
    dev = _device(x_star)
    theta, v = as_tensors(theta, dev), as_tensors(v, dev)

    # 1. tangent solve: J xdot = -F_theta v
    Fth_v = torch.func.jvp(lambda th: residual(x_star, th), (theta,), (v,))[1]

    def J(w):
        return torch.func.jvp(lambda x: residual(x, theta), (x_star,), (_like(x_star, w),))[1]

    res_t = ksp.solve(J, pytree.tree_map(torch.neg, Fth_v), M=M, null_project=null_project)
    xdot = _like(x_star, res_t.x)

    # 2. directional derivatives of the first-order quantities
    gq = torch.func.grad(qoi, argnums=(0, 1))
    _, (qx_dot, qth_dot) = torch.func.jvp(gq, (x_star, theta), (xdot, v))

    def hF(x, th):
        out, vjp_xth = torch.func.vjp(residual, x, th)
        return vjp_xth(_like(out, lam))          # (F_x^T lam, F_theta^T lam)

    _, (hx_dot, hth_dot) = torch.func.jvp(hF, (x_star, theta), (xdot, v))

    # 3. second adjoint: J^T lamdot = qx_dot - hx_dot
    res_a = ksp.solve(transpose_op(lambda x: residual(x, theta), x_star),
                      pytree.tree_map(torch.sub, qx_dot, hx_dot),
                      M=Mt if Mt is not None else M, null_project=null_project)
    Fth_lamdot = transpose_op(lambda th: residual(x_star, th), theta)(res_a.x)
    Hv = pytree.tree_map(lambda a, b, c: a - b - c, qth_dot, hth_dot, Fth_lamdot)
    return Hv, res_t, res_a


class _LinearSolve(torch.autograd.Function):
    """x = A^-1 b for an operator A that carries no gradient: the forward
    solve runs without a graph (Krylov loops are not differentiated); the
    backward solves A^T lambda = x_bar.  A state's leaves are the inputs
    (a Function tracks tensor arguments only)."""

    @staticmethod
    def forward(solve, tsolve, keys, *leaves):
        x = solve(leaves[0] if keys is None else dict(zip(keys, leaves)))
        return x if keys is None else tuple(x[k] for k in keys)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.tsolve, ctx.keys = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, *x_bar):
        keys = ctx.keys
        lam = ctx.tsolve(x_bar[0] if keys is None else dict(zip(keys, x_bar)))
        return (None, None, None) + ((lam,) if keys is None else tuple(lam[k] for k in keys))


def linear_solve(b, solve: Callable, tsolve: Callable):
    """``solve(b)`` (x = A^-1 b), differentiable in b: the counterpart of
    ``lax.custom_linear_solve``.  ``tsolve(g)`` solves the transposed
    system A^T lambda = g for the backward pass.  b is a tensor or a dict
    of tensors; ``solve`` may warm-start from anything (its inputs are not
    differentiated)."""
    if isinstance(b, torch.Tensor):
        return _LinearSolve.apply(solve, tsolve, None, b)
    keys = sorted(b)
    return dict(zip(keys, _LinearSolve.apply(solve, tsolve, keys, *(b[k] for k in keys))))
