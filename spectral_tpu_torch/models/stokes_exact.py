"""Stokes exact solutions and boundary-condition registries (host-side numpy).

A copy of ``spectral_tpu/models/stokes_exact.py``, which imports numpy
only; this package keeps its own copy so that it never imports the JAX
package.  Keep the two equal (``tests/test_torch_stokes.py`` holds every
exact solution and boundary function against the original).

Reference: StokesExact0..3 (stokes.C:1946-2034) selected by ``-exact``;
StokesDirichlet/StokesBoundary1..4 (stokes.C:2038-2181) selected by
``-boundary``.  These run once at setup to build static masks and value
fields, so they are plain vectorized numpy (the reference calls per-node C
function pointers during the SetupDomain walk, stokes.C:794).
"""

from __future__ import annotations

import enum
from typing import Callable

import numpy as np


class BdyType(enum.IntEnum):
    DIRICHLET = 0
    NEUMANN = 1
    MIXED = 2
    OUTFLOW = 3


# ---------------------------------------------------------------------------
# Exact solutions: coords (..., d) -> (value (..., d+1), rhs (..., d+1))
# ---------------------------------------------------------------------------

def exact0(coords: np.ndarray):
    """Zero solution and forcing (stokes.C:1947-1959); any dimension."""
    d = coords.shape[-1]
    z = np.zeros(coords.shape[:-1] + (d + 1,))
    return z, z.copy()


def _taylor_velocity(coords):
    x, y = coords[..., 0], coords[..., 1]
    u = np.sin(0.5 * np.pi * x) * np.cos(0.5 * np.pi * y)
    v = -np.cos(0.5 * np.pi * x) * np.sin(0.5 * np.pi * y)
    return u, v


def exact1(coords: np.ndarray):
    """Taylor-vortex-like velocity + cosine/linear pressure (stokes.C:1962-1986)."""
    d = coords.shape[-1]
    if d > 3:
        raise ValueError("exact 1 implemented for d in {2,3} (stokes.C:1969)")
    x, y = coords[..., 0], coords[..., 1]
    u, v = _taylor_velocity(coords)
    p = 0.25 * (np.cos(np.pi * x) + np.cos(np.pi * y)) + 10.0 * (x + y)
    value = np.zeros(coords.shape[:-1] + (d + 1,))
    rhs = np.zeros_like(value)
    value[..., 0] = u
    value[..., 1] = v
    value[..., d] = p
    rhs[..., 0] = (0.5 * np.pi) ** 2 * u - 0.25 * np.pi * np.sin(np.pi * x) + 10.0
    rhs[..., 1] = (0.5 * np.pi) ** 2 * v - 0.25 * np.pi * np.sin(np.pi * y) + 10.0
    return value, rhs


def exact2(coords: np.ndarray):
    """Same velocity, zero pressure (stokes.C:1990-2012)."""
    d = coords.shape[-1]
    if d > 3:
        raise ValueError("exact 2 implemented for d in {2,3} (stokes.C:1997)")
    u, v = _taylor_velocity(coords)
    value = np.zeros(coords.shape[:-1] + (d + 1,))
    rhs = np.zeros_like(value)
    value[..., 0] = u
    value[..., 1] = v
    rhs[..., 0] = (0.5 * np.pi) ** 2 * u
    rhs[..., 1] = (0.5 * np.pi) ** 2 * v
    return value, rhs


def exact3(coords: np.ndarray):
    """Simple shear u = y + 1 (stokes.C:2015-2034), 2-D."""
    d = coords.shape[-1]
    if d != 2:
        raise ValueError("exact 3 is 2-D only (stokes.C:2021)")
    value = np.zeros(coords.shape[:-1] + (d + 1,))
    rhs = np.zeros_like(value)
    value[..., 0] = coords[..., 1] + 1.0
    return value, rhs


EXACT_SOLUTIONS: dict[int, Callable] = {0: exact0, 1: exact1, 2: exact2, 3: exact3}


# ---------------------------------------------------------------------------
# Boundary functions (vectorized over boundary nodes)
#   bf(coords (k,d), normals (k,d), exact, *, phys_coords=None,
#      phys_normals=None) -> (types (k,), vel_values (k,d), alpha (k,))
# For NEUMANN rows vel_values carries the traction; for MIXED, the extra
# traction (and alpha the sliding coefficient).
#
# Curvilinear domains (models/stokes.py phi=...): face CLASSIFICATION uses
# ``coords``/``normals`` in REFERENCE coordinates (a face of the mapped
# domain is the image of a reference face), while exact-solution VALUES and
# tractions are evaluated at ``phys_coords`` with ``phys_normals`` (defaults:
# same as coords/normals, the unmapped case).  The driven profiles of
# boundary 3/4 are parameterized by the reference coordinate — on a mapped
# domain that *defines* the lid/inflow data along the curved face.
# ---------------------------------------------------------------------------

def _exact_strain_traction(coords, normals, exact, eps=1e-7):
    """epsilon(u_exact) . n via centered finite differences of the exact
    velocity (stokes.C:2063-2083)."""
    k, d = coords.shape
    grad = np.zeros((k, d, d))  # grad[:, j, i] = d u_j / d x_i
    for i in range(d):
        dxp = coords.copy()
        dxp[:, i] += eps
        dxm = coords.copy()
        dxm[:, i] -= eps
        wp = exact(dxp)[0][..., :d]
        wm = exact(dxm)[0][..., :d]
        grad[:, :, i] = (wp - wm) / (2.0 * eps)
    strain = 0.5 * (grad + np.swapaxes(grad, 1, 2))
    return np.einsum("kij,kj->ki", strain, normals)


def _exact_full_traction(coords, normals, exact):
    """PHYSICAL traction (eta eps(u) - p I) . n of the exact solution
    (eta = 1 for the linear exact-solution rheology).  Used when the
    operator's Neumann rows carry the full traction (-traction_p): unlike
    the reference's pressure-free rows (stokes.C:1083-1110, and its 'Eeek
    ... huge impact on conditioning' comment at :1101), these rows SEE the
    pressure, so the discrete problem determines the pressure constant and
    loses the spurious near-null boundary-pressure modes."""
    d = coords.shape[-1]
    p = exact(coords)[0][..., d]
    return _exact_strain_traction(coords, normals, exact) - p[:, None] * normals


def boundary0(coords, normals, exact, *, phys_coords=None, phys_normals=None,
              full_traction=False):
    """Dirichlet from the exact solution everywhere (stokes.C:2038-2048)."""
    k, d = coords.shape
    pc = coords if phys_coords is None else phys_coords
    types = np.full(k, BdyType.DIRICHLET, dtype=np.int32)
    values = exact(pc)[0][..., :d]
    return types, values, np.zeros(k)


def _surface_mask(coords):
    d = coords.shape[-1]
    inside = np.zeros(len(coords), dtype=bool)
    for i in range(d - 1):
        inside |= np.abs(coords[:, i]) < 0.999
    return (coords[:, d - 1] > 0.999) & inside


def boundary1(coords, normals, exact, *, phys_coords=None, phys_normals=None,
              full_traction=False):
    """Neumann (exact traction) on the top surface, Dirichlet elsewhere
    (stokes.C:2051-2089).  README:64-66 flags this as ill-conditioned.
    With ``full_traction`` the data is the physical (pressure-including)
    traction, matching the -traction_p operator rows."""
    k, d = coords.shape
    pc = coords if phys_coords is None else phys_coords
    pn = normals if phys_normals is None else phys_normals
    types, values, alpha = boundary0(coords, normals, exact,
                                     phys_coords=phys_coords,
                                     phys_normals=phys_normals)
    surf = _surface_mask(coords)
    if surf.any():
        types[surf] = BdyType.NEUMANN
        traction = _exact_full_traction if full_traction \
            else _exact_strain_traction
        values[surf] = traction(pc[surf], pn[surf], exact)
    return types, values, alpha


def boundary2(coords, normals, exact, *, phys_coords=None, phys_normals=None,
              full_traction=False):
    """boundary1 + MIXED (sliding, alpha=1, zero flux) at the bed
    (stokes.C:2092-2134).  README:66-67: correctness uncertain upstream."""
    k, d = coords.shape
    types, values, alpha = boundary1(coords, normals, exact,
                                     phys_coords=phys_coords,
                                     phys_normals=phys_normals,
                                     full_traction=full_traction)
    bed = coords[:, d - 1] < -0.999
    types[bed] = BdyType.MIXED
    values[bed] = 0.0
    alpha[bed] = 1.0
    return types, values, alpha


def boundary3(coords, normals, exact, *, phys_coords=None, phys_normals=None,
              full_traction=False):
    """Lid/channel-driven Dirichlet profile (stokes.C:2137-2163)."""
    k, d = coords.shape
    types = np.full(k, BdyType.DIRICHLET, dtype=np.int32)
    values = np.zeros((k, d))
    c1, c2 = coords[:, d - 2], coords[:, d - 1]
    prof = np.ones(k)
    prof = np.where(c2 > 0.999, 0.5 * (3.0 - c1), prof)
    prof = np.where(c2 < -0.999, 0.5 * (1.0 + c1), prof)
    prof = np.where(c1 < -0.999, 1.0 + c2, prof)
    values[:, d - 2] = prof
    return types, values, np.zeros(k)


def boundary4(coords, normals, exact, *, phys_coords=None, phys_normals=None,
              full_traction=False):
    """Inflow parabola + OUTFLOW + Neumann lid (stokes.C:2166-2181).  The
    lid/outflow data is model-chosen (zero), not exact-derived, so
    ``full_traction`` changes only its interpretation: zero FULL traction
    is the standard do-nothing outflow condition."""
    k, d = coords.shape
    types = np.full(k, BdyType.DIRICHLET, dtype=np.int32)
    values = np.zeros((k, d))
    c1, c2 = coords[:, d - 2], coords[:, d - 1]
    inflow = c1 < -0.999
    outflow = ~inflow & (c1 > 0.999)
    lid = c2 > 0.999
    values[inflow, d - 2] = 1.0 - 0.25 * (c2[inflow] - 1.0) ** 2
    types[outflow] = BdyType.OUTFLOW
    values[lid & ~inflow & ~outflow, d - 2] = 1.0
    # the lid override keeps whatever value was assigned (stokes.C:2176-2179)
    types[lid] = BdyType.NEUMANN
    return types, values, np.zeros(k)


def _manufactured_bed(coords, normals, exact, phys_coords, phys_normals,
                      full_traction, project):
    """Shared scaffolding for boundaries 5/6: boundary1's faces with the
    bed switched to MIXED (alpha = 1) and ALL bed data manufactured from
    the exact solution — load rows eps(u).n + alpha*u (tangentially
    projected when ``project``) plus the inhomogeneous no-penetration
    constraint v.n = u_exact.n.  Returns (types, values, alpha, vnormal)."""
    k, d = coords.shape
    pc = coords if phys_coords is None else phys_coords
    pn = normals if phys_normals is None else phys_normals
    types, values, alpha = boundary1(coords, normals, exact,
                                     phys_coords=phys_coords,
                                     phys_normals=phys_normals,
                                     full_traction=full_traction)
    bed = coords[:, d - 1] < -0.999
    vnormal = np.zeros(k)
    if bed.any():
        types[bed] = BdyType.MIXED
        alpha[bed] = 1.0
        n = pn[bed]
        u = exact(pc[bed])[0][..., :d]
        load = _exact_strain_traction(pc[bed], n, exact) + u
        if project:
            load = load - np.einsum("kj,kj->k", load, n)[:, None] * n
        values[bed] = load
        vnormal[bed] = np.einsum("kj,kj->k", u, n)
    return types, values, alpha, vnormal


def boundary5(coords, normals, exact, *, phys_coords=None, phys_normals=None,
              full_traction=False):
    """Manufactured sliding bed (beyond the reference): boundary2's
    geometry — Neumann top, MIXED (alpha = 1) bed, Dirichlet sides — with
    ALL data manufactured from the exact solution, so the mixed-BC
    machinery is VERIFIABLE: bed rows carry
    t_j = (eps(u).n)_j + alpha*u_j (the operator's mixed rows are
    pressure-free regardless of full_traction, matching
    StokesMixedApply), and the no-penetration constraint becomes the
    inhomogeneous v.n = u_exact.n.  Upstream's boundary 2 is
    unverifiable ('correctness uncertain', README:66-67) because its
    zero bed data is inconsistent with every exact solution.  Returns a
    4-tuple: (types, values, alpha, vnormal)."""
    return _manufactured_bed(coords, normals, exact, phys_coords,
                             phys_normals, full_traction, project=False)


def boundary6(coords, normals, exact, *, phys_coords=None, phys_normals=None,
              full_traction=False):
    """Manufactured Navier-slip bed (beyond the reference): boundary2's
    geometry with the PHYSICAL sliding condition — tangentially projected
    mixed rows P_t(eps(u).n + alpha*u) = P_t(data) plus the inhomogeneous
    no-penetration constraint v.n = u_exact.n.  Because P_t = I - n n^T
    annihilates the normal direction, the pressure's share of the true
    traction (-p n) drops out exactly, so the pressure-free strain
    traction used here is NOT an approximation (unlike boundary 2's
    full-component rows, the root of upstream's 'correctness uncertain',
    README:66-67).  Requires the operator's -mixed_tang rows
    (auto-enabled by StokesProblem for this boundary).  Returns a 4-tuple
    (types, values, alpha, vnormal)."""
    return _manufactured_bed(coords, normals, exact, phys_coords,
                             phys_normals, full_traction, project=True)


def boundary7(coords, normals, exact, *, phys_coords=None, phys_normals=None,
              full_traction=False):
    """Free-slip box (beyond the reference): every face is MIXED with
    alpha = 0 and zero data — v.n = 0 (normal component eliminated by the
    mixed machinery, stokes.C:836-851) plus zero TANGENTIAL traction via
    the tangentially-projected rows (-mixed_tang, auto-enabled): P_t
    annihilates the pressure's -p n share of the traction exactly, so the
    impermeable stress-free wall is imposed without the pressure entering
    the boundary rows.  Corners/edges (nodes on >= 2 faces, where the
    normal is ambiguous and free-slip on both faces forces v = 0) are
    Dirichlet zero.  The Rayleigh-Benard / Blankenbach benchmark regime
    (models/convection.py)."""
    k, d = coords.shape
    # face count from the index-based reference normal (grid.normal_np):
    # one nonzero component on a face, >= 2 at edges/corners — robust on
    # interval-mapped grids where coords are physical, not [-1, 1]
    nfaces = (np.abs(normals) > 1e-12).sum(axis=1)
    types = np.full(k, BdyType.MIXED, dtype=np.int32)
    types[nfaces >= 2] = BdyType.DIRICHLET
    values = np.zeros((k, d))
    return types, values, np.zeros(k)


def boundary8(coords, normals, exact, *, phys_coords=None, phys_normals=None,
              full_traction=False):
    """Rigid-lid convection box (beyond the reference): Dirichlet v = 0 on
    the VERTICAL (last-axis) faces, free-slip (MIXED alpha = 0, zero
    tangential traction — boundary7's rows) on the sidewalls, edges/
    corners Dirichlet.  The rigid-boundary Rayleigh-Benard regime: the
    sidewalls are the planform's symmetry planes, so this is exactly the
    Busse et al. (1994) 3-D benchmark box (models/convection.py
    velocity_bc='rigid'); the infinite-layer critical Rayleigh number
    1707.762 (Chandrasekhar) is the onset oracle."""
    k, d = coords.shape
    nfaces = (np.abs(normals) > 1e-12).sum(axis=1)
    types = np.full(k, BdyType.MIXED, dtype=np.int32)
    types[np.abs(normals[:, d - 1]) > 1e-12] = BdyType.DIRICHLET
    types[nfaces >= 2] = BdyType.DIRICHLET
    values = np.zeros((k, d))
    return types, values, np.zeros(k)


BOUNDARY_FUNCS: dict[int, Callable] = {
    0: boundary0, 1: boundary1, 2: boundary2, 3: boundary3, 4: boundary4,
    5: boundary5, 6: boundary6, 7: boundary7, 8: boundary8,
}
