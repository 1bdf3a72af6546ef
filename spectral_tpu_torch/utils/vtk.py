"""Legacy-ASCII VTK writer for Stokes states.

Counterpart of ``spectral_tpu/utils/vtk.py``, section for section.  Mirrors
``StokesStateView`` (stokes.C:1820-1894): a STRUCTURED_GRID file with
coordinates, velocity, pressure, forces, eta, deta and the strain tensor;
boundary values are reconstructed (mixed recovery, Dirichlet insert,
pressure order reduction) before writing (stokes.C:1827-1851).  The fields
are computed on the state's device and copied to the host once; the text
is formatted by the native IO runtime (``utils/native.py``; where it
does not build, its Python path gives the same bytes).
"""

from __future__ import annotations

import numpy as np
import torch

from spectral_tpu_torch.utils import native


def _fmt_rows(arr: np.ndarray, per_line: int) -> str:
    """Rows of ``per_line`` zero-padded %20e values (StokesVecView analog)."""
    flat = arr.reshape(-1, arr.shape[-1]) if arr.ndim > 1 else arr.reshape(-1, 1)
    k = flat.shape[1]
    if k < per_line:
        flat = np.concatenate([flat, np.zeros((len(flat), per_line - k))], axis=1)
    return native.format_rows(flat)


def stokes_vtk_fields(problem, state, *, bc_scale: float = 1.0,
                      extra_scalars=None) -> dict[str, np.ndarray]:
    """The fields ``write_stokes_vtk`` writes, by section name, as float64
    host arrays over the nodes: velocity, pressure, vel_force, div_force,
    eta, deta, strain (d x d a node), then ``extra_scalars`` in order.
    They are computed on the state's device and copied to the host once."""
    from spectral_tpu_torch.ops.extrapolation import pressure_reduce_order

    if problem.mesh is not None:
        raise NotImplementedError("write_stokes_vtk on a mesh is not ported yet "
                                  "(ROADMAP.md queue 1, item 7d): gather the state first")
    g = problem.grid
    vL = problem.local_velocity(state["v"], with_dirichlet=True)
    if bc_scale != 1.0:
        vL = torch.where(problem._dirichlet_v, bc_scale * problem._c("bc_vel", vL.dtype), vL)
    pL = pressure_reduce_order(problem.mask_p(state["p"]), g.nodes_1d)
    # the force is not a velocity: reconstruct its removed mixed component
    # homogeneously (no v.n = bc_vnormal datum), Dirichlet display values
    # as upstream (stokes.C:1848-1851 scatters dirichlet into workV[1])
    fv = problem.local_velocity(problem.force["v"], with_dirichlet=True, inhomogeneous=False)
    fp = pressure_reduce_order(problem.force["p"], g.nodes_1d)
    _, (eta, deta, S) = problem.make_residual(problem.params_at(problem.config.cont))(state)
    fields = {"velocity": vL, "pressure": pL, "vel_force": fv, "div_force": fp, "eta": eta,
              "deta": deta, "strain": S,
              **{name: torch.as_tensor(field) for name, field in (extra_scalars or {}).items()}}
    dev = vL.device
    host = torch.cat([t.detach().reshape(-1).to(device=dev, dtype=torch.float64)
                      for t in fields.values()]).cpu().numpy()
    return dict(zip(fields, np.split(host, np.cumsum([t.numel() for t in fields.values()])[:-1])))


def write_stokes_vtk(problem, state, filename: str = "stokes.vtk", *,
                     bc_scale: float = 1.0, extra_scalars=None) -> None:
    """Write the final state like ``-output_vtk`` (stokes.C:238-241).

    ``bc_scale`` scales the reconstructed Dirichlet display values: the
    unsteady driver passes its boundary modulation s(T) so the written
    boundary matches the integrated state (steady states use 1).
    ``extra_scalars``: optional {name: full-grid tensor or array} appended
    as additional SCALARS fields (the convection driver's temperature)."""
    fields = stokes_vtk_fields(problem, state, bc_scale=bc_scale, extra_scalars=extra_scalars)
    g = problem.grid
    d = problem.d
    dims = g.dims
    m, n = dims[0], dims[1]
    p = dims[2] if d > 2 else 1
    nodes = g.size
    coords = problem.coords_phys_np.reshape(nodes, d)
    with open(filename, "w") as f:
        f.write("# vtk DataFile Version 2.0\nStokes Output\nASCII\n"
                "DATASET STRUCTURED_GRID\n")
        f.write(f"DIMENSIONS {m} {n} {p}\nPOINTS {nodes} double\n")
        f.write(_fmt_rows(coords, 3) + "\n")
        f.write(f"\nPOINT_DATA {nodes}\nVECTORS velocity double\n")
        f.write(_fmt_rows(fields.pop("velocity").reshape(nodes, d), 3) + "\n")
        f.write("\nSCALARS pressure double 1\nLOOKUP_TABLE default\n")
        f.write(_fmt_rows(fields.pop("pressure").reshape(nodes), 1) + "\n")
        f.write("\nVECTORS vel_force double\n")
        f.write(_fmt_rows(fields.pop("vel_force").reshape(nodes, d), 3) + "\n")
        for name in ("div_force", "eta", "deta"):
            f.write(f"\nSCALARS {name} double 1\nLOOKUP_TABLE default\n")
            f.write(_fmt_rows(fields.pop(name).reshape(nodes), 1) + "\n")
        f.write("\nTENSORS strain double\n")
        Sfull = np.zeros((nodes, 3, 3))
        Sfull[:, :d, :d] = fields.pop("strain").reshape(nodes, d, d)
        f.write(native.format_tensors(Sfull))
        for name, field in fields.items():   # extra_scalars
            f.write(f"\nSCALARS {name} double 1\nLOOKUP_TABLE default\n")
            f.write(_fmt_rows(field.reshape(nodes), 1) + "\n")
