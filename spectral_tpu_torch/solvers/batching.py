"""Batching helpers for parameter families and multi-right-hand-side solves.

The JAX package batches a solve by ``jax.vmap`` of the whole program,
its ``while_loop``s included.  The port's Krylov and Newton loops are
host-driven (Givens rotations on the host, one transfer a step), which
``torch.func.vmap`` cannot wrap; so they are written batched by hand
(``KSPConfig.solve_batched``, ``newton_solve_family``), and only the
loop-free blocks they call (an operator, a residual, a preconditioner
apply without a nested solve) go through ``torch.func.vmap``, where K1's
vmap rule launches once per batch.

``batch_map`` is ``torch.func.vmap`` over pytrees whose leaves need not
all be tensors: non-tensor leaves (None, floats, solver objects) pass
through unbatched, in the inputs and in the outputs.
"""

from __future__ import annotations

import torch
import torch.utils._pytree as pytree


def _is_tensor(a) -> bool:
    return isinstance(a, torch.Tensor)


def batch_map(fn, in_dims=0):
    """``torch.func.vmap(fn)`` over the leading axis of every tensor leaf of
    the positional arguments whose ``in_dims`` entry is 0; arguments with
    ``None`` are closed over unbatched (they may be any object).  Tensor
    leaves of the output carry the batch axis first; non-tensor output
    leaves are returned as the last member's call made them."""

    def wrapped(*args):
        dims = in_dims if isinstance(in_dims, (tuple, list)) else (in_dims,) * len(args)
        pos = [i for i, d in enumerate(dims) if d == 0]
        flat = [pytree.tree_flatten(args[i]) for i in pos]
        tensors = [leaf for leaves, _ in flat for leaf in leaves if _is_tensor(leaf)]
        box = {}

        def inner(*ts):
            it = iter(ts)
            call = list(args)
            for i, (leaves, spec) in zip(pos, flat):
                call[i] = pytree.tree_unflatten(
                    [next(it) if _is_tensor(leaf) else leaf for leaf in leaves], spec)
            leaves, spec = pytree.tree_flatten(fn(*call))
            box["leaves"], box["spec"] = leaves, spec
            return tuple(leaf for leaf in leaves if _is_tensor(leaf))

        outs = iter(torch.func.vmap(inner)(*tensors))
        return pytree.tree_unflatten(
            [next(outs) if _is_tensor(leaf) else leaf for leaf in box["leaves"]],
            box["spec"])

    return wrapped


def member(tree, b: int):
    """Member ``b`` of a batched pytree (every tensor leaf indexed on its
    leading axis)."""
    return pytree.tree_map(lambda a: a[b] if _is_tensor(a) else a, tree)


def where_members(active: torch.Tensor, new, old):
    """Leaf by leaf ``new`` where the (B,) mask ``active`` is set, else
    ``old`` (the frozen members of a batched loop keep their state)."""
    def pick(a, b):
        if not _is_tensor(a):
            return a
        m = active.reshape(active.shape + (1,) * (a.ndim - 1))
        return torch.where(m, a, b)

    return pytree.tree_map(pick, new, old)


def dp_cut(nb: int, mesh, mesh_axis: str) -> slice:
    """This process' block of a batch of ``nb`` members cut over mesh axis
    ``mesh_axis`` (data parallelism, rank order); nb must divide."""
    p, me = mesh.size(mesh_axis), mesh.index(mesh_axis)
    if nb % p:
        raise ValueError(f"batch of {nb} not divisible by mesh axis {mesh_axis!r} size {p}")
    c = nb // p
    return slice(me * c, (me + 1) * c)


def dp_gather(t, mesh, mesh_axis: str, axis: int = 0):
    """The whole batch from every process' block (a tensor or a numpy
    array), concatenated along ``axis`` in rank order."""
    import numpy as np

    if isinstance(t, np.ndarray):
        return dp_gather(torch.from_numpy(np.ascontiguousarray(t)), mesh, mesh_axis,
                         axis).numpy()
    return torch.cat(mesh.all_gather(t.contiguous(), mesh_axis), dim=axis)
