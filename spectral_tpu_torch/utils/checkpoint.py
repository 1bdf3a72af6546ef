"""Checkpoint / resume of solver state.

Counterpart of ``spectral_tpu/utils/checkpoint.py``, in its file layout,
so that each package reads the other's files: ``step_NNNN.npz`` holds the
state's leaves as ``arr_0, arr_1, ...`` in the JAX package's pytree order
(a dict's leaves in sorted key order, a tuple's in its own;
``utils.tree``), and ``step_NNNN.npz.json`` holds ``step``, the structure
(``treedef``, as JAX prints it) and ``meta``.  The reference has no
checkpointing (SURVEY.md section 5.4); the continuation loop and the
adaptive march persist their state with it and resume mid-schedule.  The
JAX package's orbax pair is not ported (orbax is a JAX package).
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np
import torch

from spectral_tpu_torch.utils import tree


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:04d}.npz")


def save_state(directory: str, step: int, x: Any, meta: dict | None = None) -> str:
    """Persist a state (a tensor, or a dict / tuple / list of them) as
    step_<n>.npz plus its sidecar; every leaf is copied to the host in its
    own dtype.  The sidecar is written first and the arrays moved into
    place last, so a step that ``latest_step`` finds is complete."""
    os.makedirs(directory, exist_ok=True)
    arrays = [t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
              for t in tree.leaves(x)]
    path = _path(directory, step)
    with open(path + ".json", "w") as f:
        json.dump({"step": step, "treedef": tree.structure(x), "meta": meta or {}}, f)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, *arrays)
    os.replace(tmp, path)
    return path


def latest_step(directory: str) -> Optional[int]:
    """The largest step saved in ``directory`` (any number of digits), or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(f[len("step_"):-len(".npz")]) for f in os.listdir(directory)
             if f.startswith("step_") and f.endswith(".npz")
             and f[len("step_"):-len(".npz")].isdigit()]
    return max(steps) if steps else None


def load_state(directory: str, step: int, like: Any) -> Any:
    """The state saved at ``step``, in ``like``'s structure: each leaf in
    its saved dtype, on the device of ``like``'s matching leaf (the host
    where that leaf is not a tensor)."""
    with np.load(_path(directory, step)) as data:
        arrays = [data[k] for k in data.files]
    devices = [t.device if isinstance(t, torch.Tensor) else torch.device("cpu")
               for t in tree.leaves(like)]
    if len(arrays) != len(devices):
        raise ValueError(f"step {step} in {directory} holds {len(arrays)} arrays; "
                         f"the structure {tree.structure(like)} needs {len(devices)}")
    return tree.unflatten(like, [torch.from_numpy(a).to(dev)
                                 for a, dev in zip(arrays, devices)])


def load_meta(directory: str, step: int) -> dict:
    with open(_path(directory, step) + ".json") as f:
        return json.load(f).get("meta", {})
