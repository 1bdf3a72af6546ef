"""Q1 finite-element rediscretization on the CGL grid (the -pcvel 1 analog).

Counterpart of ``spectral_tpu/ops/fem.py`` on flat domains.  On a tensor
grid the Q1 Laplacian is separable,
    A = sum_j M_0 (x) ... K_j ... (x) M_{d-1},
with per-axis 1-D P1 stiffness K_j and consistent mass M_j tridiagonals, so
``Q1FastDiag`` solves it exactly by generalized fast diagonalization: each
axis' K_j v = lambda M_j v is solved once on the host (``scipy.linalg.eigh``
in float64, M-orthonormal V), and the apply is per-axis ``torch.matmul``
products with the factors cast to the caller's dtype on its device.

``assemble_q1_strain`` is the strain-coupled, eta/eta'-aware Q1 element
assembly of StokesPCSetUp1 (stokes.C:1244-1456): tensor-product Gauss
quadrature, cell-constant eta/deta/strain Newton term, lumped-mass row
scaling and -zeroN/-zeroV filtering, assembled into a 3^d-offset,
(d x d)-component coupled stencil (``Q1StrainStencil``) whose apply is one
batched product over the shifted copies of its input.  The einsums and
products run in the fields' dtype under the package's precision policy
(no TF32).  ``q1_strain_dense_np`` is its
dense element-by-element oracle.  Isoparametric (curved) elements raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import operator

import numpy as np
import torch

from spectral_tpu_torch.grid import Grid
from spectral_tpu_torch.ops.stencil import shift
from spectral_tpu_torch.ops.tensorops import apply_axis_matmul


def fem1d_matrices_np(z: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """1-D P1 stiffness and consistent-mass tridiagonals on interior nodes.

    Nodes z decreasing (CGL order); element sizes h_i = |z_i - z_{i+1}|;
    Dirichlet ends eliminated:
      K_ii = 1/h_{i-1} + 1/h_i,  K_{i,i+-1} = -1/h
      M_ii = (h_{i-1} + h_i)/3,  M_{i,i+-1} = h/6
    """
    h = np.abs(np.diff(z))
    m = len(z) - 2
    K = np.zeros((m, m))
    M = np.zeros((m, m))
    for a in range(m):
        i = a + 1  # global node index
        K[a, a] = 1.0 / h[i - 1] + 1.0 / h[i]
        M[a, a] = (h[i - 1] + h[i]) / 3.0
        if a + 1 < m:
            K[a, a + 1] = K[a + 1, a] = -1.0 / h[i]
            M[a, a + 1] = M[a + 1, a] = h[i] / 6.0
    return K, M


def q1_dense_np(grid: Grid) -> np.ndarray:
    """Dense interior Q1 Laplacian (test oracle): Kronecker-sum structure."""
    d = grid.ndim
    mats = [fem1d_matrices_np(grid.nodes_1d[ax]) for ax in range(d)]
    total = functools.reduce(operator.mul, [len(m[0]) for m in mats])
    A = np.zeros((total, total))
    for j in range(d):
        term = np.ones((1, 1))
        for k in range(d):
            term = np.kron(term, mats[k][0] if k == j else mats[k][1])
        A += term
    return A


@dataclasses.dataclass(frozen=True)
class Q1FastDiag:
    """Exact solver of the tensor-product Q1 FEM Laplacian (interior dofs).

    Generalized fast diagonalization: V_j^T K_j V_j = Lambda_j,
    V_j^T M_j V_j = I, so A^{-1} f = (kron V_j) [ (kron V_j)^T f / sum Lambda ].
    """

    grid: Grid
    V: tuple[torch.Tensor, ...]
    VT: tuple[torch.Tensor, ...]
    lam_sum: torch.Tensor
    lump: torch.Tensor

    @staticmethod
    def build(grid: Grid, dtype: torch.dtype | None = None) -> "Q1FastDiag":
        """Solve each axis' generalized eigenproblem on the host in float64
        and cast the factors once to ``dtype`` (default: the grid's) on the
        grid's device."""
        import scipy.linalg

        dtype = dtype or grid.dtype

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=grid.device)

        Vs, VTs, lams, lumps = [], [], [], []
        for ax in range(grid.ndim):
            K, M = fem1d_matrices_np(grid.nodes_1d[ax])
            w, V = scipy.linalg.eigh(K, M)  # V^T M V = I
            Vs.append(t(V))
            VTs.append(t(V.T))
            lams.append(w)
            lumps.append(M.sum(axis=1))
        interior_shape = tuple(n - 2 for n in grid.dims)
        lam = np.zeros(interior_shape)
        lump = np.ones(interior_shape)
        for ax, w in enumerate(lams):
            shape = [1] * grid.ndim
            shape[ax] = len(w)
            lam = lam + w.reshape(shape)
            lump = lump * lumps[ax].reshape(shape)
        return Q1FastDiag(grid, tuple(Vs), tuple(VTs), t(lam), t(lump))

    @staticmethod
    def _trail(field: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """``field`` with size-1 axes appended for ``like``'s component axes."""
        return field.reshape(field.shape + (1,) * (like.ndim - field.ndim))

    def solve_interior(self, f: torch.Tensor) -> torch.Tensor:
        w = f
        for ax in range(self.grid.ndim):
            w = apply_axis_matmul(self.VT[ax], w, ax)  # V^T f along axis
        w = w / self._trail(self.lam_sum, w)
        for ax in range(self.grid.ndim):
            w = apply_axis_matmul(self.V[ax], w, ax)
        return w

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        """Full-grid PC apply: the interior exact solve of the
        lumped-mass-scaled Q1 matrix (the reference row-scales by
        1/massLump so the weak form matches the collocation strong form,
        stokes.C:1449-1450): P = Lump^{-1} A, so P^{-1} r = A^{-1} (Lump r).
        Boundary entries pass through; trailing axes are components."""
        inner = tuple([slice(1, -1)] * self.grid.ndim)
        ri = r[inner].to(self.lump.dtype)
        out = r.clone()
        out[inner] = self.solve_interior(ri * self._trail(self.lump, ri)).to(r.dtype)
        return out

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        return self.apply(r)


# ---------------------------------------------------------------------------
# Strain-coupled Q1 element assembly (StokesPCSetUp1 analog)
# ---------------------------------------------------------------------------

def q1_quadrature_np(order: int = 3):
    """Gauss-Legendre quadrature and Q1 hat-function tables on [-1, 1]:
    (weights (order,), basis (2, order), deriv (2, order)), basis[t][q] the
    hat anchored at corner t (-1 for t=0, +1 for t=1) at point q, deriv its
    reference-cell derivative (+-0.5); the tables of stokes.C:1250-1262."""
    xi, w = np.polynomial.legendre.leggauss(order)
    basis = np.stack([(1.0 - xi) / 2.0, (1.0 + xi) / 2.0])
    deriv = np.stack([np.full(order, -0.5), np.full(order, 0.5)])
    return w, basis, deriv


@dataclasses.dataclass(frozen=True)
class Q1StrainStencil:
    """3^d-offset (or any offset set), (d, d)-component coupled stencil:
    the container of the strain-coupled Q1 velocity matrix (the reference's
    AIJ MatVVPC).  coef[k] has shape dims + (d, d) for offsets[k].

    apply: y[n, a] = sum_k sum_b coef[k][n, a, b] * x[n + offsets[k], b],
    with x zero beyond the grid.  The apply gathers the shifted copies of
    x from one zero-padded copy into dims + (K d,) and contracts them with
    the coefficients, laid out once as dims + (d, K d), in one batched
    product.
    """

    offsets: tuple
    coef: tuple

    @functools.cached_property
    def _rows(self) -> torch.Tensor:
        """The coefficients as dims + (d, K d): row a of node n holds
        coef[k][n, a, :] for every offset k in turn."""
        return torch.cat(self.coef, dim=-1).contiguous()

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        d = len(self.offsets[0])
        dims = x.shape[:d]
        r = max(abs(o) for off in self.offsets for o in off)
        xp = x.new_zeros(tuple(n + 2 * r for n in dims) + x.shape[d:])
        xp[tuple(slice(r, r + n) for n in dims)] = x
        xs = torch.cat([xp[tuple(slice(r + o, r + o + n) for o, n in zip(off, dims))]
                        for off in self.offsets], dim=-1)
        return torch.matmul(self._rows, xs[..., None])[..., 0]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(x)

    def diag(self) -> torch.Tensor:
        """(dims, d) diagonal (offset 0, a == b)."""
        C0 = self.coef[self.offsets.index((0,) * len(self.offsets[0]))]
        return torch.diagonal(C0, dim1=-2, dim2=-1)

    def as_dense_np(self) -> np.ndarray:
        """Materialize as a dense (size*d, size*d) float64 matrix over
        (node, comp) C-order flattening (tests only)."""
        coefs = [c.detach().cpu().numpy().astype(np.float64) for c in self.coef]
        dims = coefs[0].shape[:-2]
        d = coefs[0].shape[-1]
        size = int(np.prod(dims))
        A = np.zeros((size * d, size * d))
        idx = np.arange(size).reshape(dims)
        for off, C in zip(self.offsets, coefs):
            if any(n <= abs(o) for n, o in zip(dims, off)):
                continue
            src = tuple(slice(max(o, 0), n + min(o, 0)) for n, o in zip(dims, off))
            dst = tuple(slice(max(-o, 0), n - max(o, 0)) for n, o in zip(dims, off))
            rows = idx[dst].ravel()
            cols = idx[src].ravel()
            block = C[dst].reshape(-1, d, d)
            for a in range(d):
                for b in range(d):
                    A[rows * d + a, cols * d + b] += block[:, a, b]
        return A


def _bcast_np(a: np.ndarray, axis: int, dims: tuple) -> np.ndarray:
    shape = [1] * len(dims)
    shape[axis] = len(a)
    return a.reshape(shape)


def _outer_np(per_axis: list, dims: tuple) -> np.ndarray:
    out = np.ones(dims)
    for ax, a in enumerate(per_axis):
        out = out * _bcast_np(a, ax, dims)
    return out


def _reference_tables_np(d: int, order: int):
    """(corners, B (T, Q) basis products, G (d, T, Q) reference gradients,
    W (Q,) quadrature weight products) of the Q1 reference cell."""
    w1, b1, d1 = q1_quadrature_np(order)
    corners = list(itertools.product((0, 1), repeat=d))
    quads = list(itertools.product(range(order), repeat=d))
    B = np.zeros((len(corners), len(quads)))
    G = np.zeros((d, len(corners), len(quads)))
    for ti, t in enumerate(corners):
        for qi, q in enumerate(quads):
            B[ti, qi] = np.prod([b1[t[k], q[k]] for k in range(d)])
            for i in range(d):
                g = d1[t[i], q[i]]
                for k in range(d):
                    if k != i:
                        g *= b1[t[k], q[k]]
                G[i, ti, qi] = g
    W = np.array([float(np.prod([w1[q[k]] for k in range(d)])) for q in quads])
    return corners, B, G, W


def assemble_q1_strain(grid: Grid, eta: torch.Tensor, deta: torch.Tensor,
                       S: torch.Tensor, vel_mask: torch.Tensor, *,
                       zeroN: int = 0, zeroV: float = 1.0,
                       order: int = 3, coords=None) -> Q1StrainStencil:
    """StokesPCSetUp1 (stokes.C:1244-1456), any d, in eta's dtype on its
    device.

    The element loop becomes einsums over the element grid: for every
    element (the cell with origin node el) the 2^d x 2^d x d x d
    Newton-linearized viscous element matrix

        Ae[t,a; r,b] = sum_q w_q |J| ( eta_el * E(t,a):D(r,b)
                                       + deta_el * (E:S_el)(D:S_el) )

    with eta/deta/strain constant on the cell (their origin-node values,
    stokes.C:1345), E/D the symmetrized strain basis tensors and order-3
    tensor-product Gauss quadrature, is scatter-added into a 3^d-offset
    coupled stencil.  Rows and columns at non-free velocity dofs are
    dropped; the element mass is lumped and the result row-scaled by
    1/lump (stokes.C:1412-1418, 1449-1450); -zeroN/-zeroV filters the
    first zeroN free dofs symmetrically (stokes.C:1420-1432).

    ``coords`` ((dims..., d) physical node positions) switches to
    isoparametric Q1 elements for curved domains: the geometry Jacobian
    J_g(q, el) = sum_t x[el+t] (x) grad_ref(hat_t)(q) at every quadrature
    point, the test gradients transformed by its inverse and |det J_g(q)|
    in every quadrature weight (the lumped mass included)."""
    d = grid.ndim
    dims = grid.dims
    edims = tuple(n - 1 for n in dims)
    dtype, dev = eta.dtype, eta.device
    corners, B, G, W = _reference_tables_np(d, order)
    T, Q = len(corners), len(W)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    sl0 = tuple(slice(0, -1) for _ in range(d))
    eta_el, deta_el, S_el = eta[sl0], deta[sl0], S[sl0]
    Me = Me_el = None
    if coords is None:
        # tensor-product cells: diagonal geometry Jacobian J_ii = 0.5 (x_{el+1}
        # - x_el) per axis (signed), constant per cell
        Me = np.einsum("q,tq,rq->tr", W, B, B)  # element mass (x |J|)
        Jd = [0.5 * (grid.nodes_1d[ax][1:] - grid.nodes_1d[ax][:-1]) for ax in range(d)]
        inv2h = torch.stack([t(_bcast_np(1.0 / Jd[ax], ax, edims)).expand(edims)
                             for ax in range(d)])
        Jdet = t(np.abs(_outer_np(Jd, edims)))
        # real-coordinate test gradients: dtest[i, t, q, el] = G[i,t,q] / J_ii
        dtest = t(G).reshape((d, T, Q) + (1,) * d) * inv2h[:, None, None]
        Wq = t(W).reshape((Q,) + (1,) * d)        # |J| applied at the end
    else:
        # isoparametric cells: J_g[q, el, i, j] = sum_t x[el+t, i] G[j, t, q]
        xphys = t(coords)
        xc = torch.stack([xphys[tuple(slice(tc[ax], tc[ax] + edims[ax]) for ax in range(d))]
                          for tc in corners])     # (T, edims, d)
        Gt = t(G)
        Jg = torch.einsum("t...i,jtq->q...ij", xc, Gt)   # (Q, edims, d, d)
        Jg_inv = torch.linalg.inv(Jg)
        # dtest[i, t, q, el] = sum_j G[j,t,q] Jg_inv[q, el, j, i]
        dtest = torch.einsum("jtq,q...ji->itq...", Gt, Jg_inv)
        Wq = t(W).reshape((Q,) + (1,) * d) * torch.abs(torch.linalg.det(Jg))
        Me_el = torch.einsum("q...,tq,rq->tr...", Wq, t(B), t(B))
        Jdet = torch.ones(edims, dtype=dtype, device=dev)   # |J| is in Wq and Me_el
    # eta term: 0.5 (delta_ab sum_i dtest_i dtrial_i + dtest_b dtrial_a)
    Adot = torch.einsum("q...,itq...,irq...->tr...", Wq, dtest, dtest)
    P = torch.einsum("q...,btq...,arq...->tarb...", Wq, dtest, dtest)
    # Newton term: zhat[a,t,q] = sum_i dtest_i S_el[a,i]
    zh = torch.einsum("itq...,...ai->atq...", dtest, S_el)
    ZH = torch.einsum("q...,atq...,brq...->tarb...", Wq, zh, zh)
    Ae = (eta_el * (0.5 * (torch.einsum("tr...,ab->tarb...", Adot, t(np.eye(d))) + P))
          + deta_el * ZH) * Jdet

    maskf = vel_mask.to(dtype)
    # scatter-add the element blocks into the 3^d coupled stencil, and lump
    offsets = [tuple(o) for o in itertools.product((-1, 0, 1), repeat=d)]
    coef = {off: torch.zeros(dims + (d, d), dtype=dtype, device=dev) for off in offsets}
    lump = torch.zeros(dims + (d,), dtype=dtype, device=dev)
    for ti, tc in enumerate(corners):
        row_sl = tuple(slice(tc[ax], tc[ax] + edims[ax]) for ax in range(d))
        acc = torch.zeros(edims + (1,), dtype=dtype, device=dev)
        for ri, rc in enumerate(corners):
            off = tuple(rc[ax] - tc[ax] for ax in range(d))
            col_sl = tuple(slice(rc[ax], rc[ax] + edims[ax]) for ax in range(d))
            colm = maskf[col_sl]                       # (edims, d): free columns
            blk = torch.movedim(Ae[ti, :, ri, :], (0, 1), (-2, -1))
            coef[off][row_sl] += blk * colm[..., None, :]   # masked columns dropped
            # lumped mass: the sum over this element's free trial dofs
            me = float(Me[ti, ri]) if Me is not None else Me_el[ti, ri][..., None]
            acc = acc + me * torch.sum(colm, dim=-1, keepdim=True)
        lump[row_sl] += acc * Jdet[..., None]

    # drop masked rows, then row-scale by 1/lump (stokes.C:1449-1450)
    safe_lump = torch.where(vel_mask, lump, 1.0)
    for off in offsets:
        coef[off] = coef[off] * (maskf / safe_lump)[..., :, None]

    if zeroN:
        # -zeroN/-zeroV (stokes.C:1420-1432): the first zeroN free velocity
        # dofs (C-order over (node, comp)) filtered symmetrically; the
        # diagonal takes zeroV once per containing element, then the same
        # 1/lump row scaling
        vm_np = vel_mask.cpu().numpy()
        num = np.full(dims + (d,), -1, dtype=np.int64)
        num[vm_np] = np.arange(int(vm_np.sum()))
        rz = torch.as_tensor((num >= 0) & (num < zeroN), device=dev)
        keep_row = (~rz).to(dtype)
        for off in offsets:
            cz = rz.to(dtype)
            for ax, o in enumerate(off):
                if o:
                    cz = shift(cz, ax, o)
            coef[off] = coef[off] * (keep_row[..., :, None] * (1.0 - cz)[..., None, :])
        nel = np.ones(dims)
        for ax in range(d):
            inner = [slice(None)] * d
            inner[ax] = slice(1, -1)
            nel[tuple(inner)] *= 2.0
        diagv = t(nel)[..., None] * zeroV / safe_lump
        C0 = coef[(0,) * d].clone()
        for a in range(d):
            C0[..., a, a] = torch.where(rz[..., a], diagv[..., a], C0[..., a, a])
        coef[(0,) * d] = C0

    return Q1StrainStencil(offsets=tuple(offsets), coef=tuple(coef[o] for o in offsets))


def q1_strain_dense_np(grid: Grid, eta: np.ndarray, deta: np.ndarray,
                       S: np.ndarray, vel_mask: np.ndarray, *,
                       zeroN: int = 0, zeroV: float = 1.0,
                       order: int = 3, coords=None) -> np.ndarray:
    """Dense oracle of assemble_q1_strain (tests only): the StokesPCSetUp1
    algorithm evaluated element by element and quadrature point by
    quadrature point from the symmetrized strain basis tensors themselves
    (E[t, a] = sym(e_a (x) grad phi_t), Ae += w |J| (eta E:E' + deta
    (E:S)(E':S))), then scattered dof pair by dof pair; independent of the
    factored einsums of the assembly.  ``coords`` switches to isoparametric
    elements (the geometry Jacobian at every quadrature point from the
    physical corner positions)."""
    d = grid.ndim
    dims = grid.dims
    size = int(np.prod(dims))
    w1, b1, d1 = q1_quadrature_np(order)
    corners = list(itertools.product((0, 1), repeat=d))
    quads = list(itertools.product(range(order), repeat=d))
    num = np.full(dims + (d,), -1, dtype=np.int64)
    num[vel_mask] = np.arange(int(vel_mask.sum()))
    A = np.zeros((size * d, size * d))
    lump = np.zeros(size * d)
    flat = np.arange(size).reshape(dims)
    nodes = grid.nodes_1d
    eye = np.eye(d)
    # per corner t and point q: the reference gradient and the basis value
    grad = np.array([[[d1[t[i], q[i]] * np.prod([b1[t[k], q[k]] for k in range(d) if k != i])
                       for i in range(d)] for q in quads] for t in corners])
    basis = np.array([[np.prod([b1[t[k], q[k]] for k in range(d)]) for q in quads]
                      for t in corners])
    wq = np.array([np.prod([w1[q[k]] for k in range(d)]) for q in quads])

    for el in itertools.product(*[range(n - 1) for n in dims]):
        J = np.array([0.5 * (nodes[ax][el[ax] + 1] - nodes[ax][el[ax]]) for ax in range(d)])
        Jdet = abs(float(np.prod(J)))
        eta_e, deta_e, S_e = float(eta[el]), float(deta[el]), S[el]
        Ael = np.zeros((len(corners), d, len(corners), d))
        Mel = np.zeros((len(corners), len(corners)))
        for qi in range(len(quads)):
            if coords is None:
                qw = Jdet * wq[qi]
                g = grad[:, qi] / J                             # (T, d) real gradients
            else:
                Jg = sum(np.outer(np.asarray(coords[tuple(el[ax] + t[ax] for ax in range(d))]),
                                  grad[ti, qi]) for ti, t in enumerate(corners))
                qw = abs(float(np.linalg.det(Jg))) * wq[qi]
                g = grad[:, qi] @ np.linalg.inv(Jg)
            E = 0.5 * (eye[None, :, :, None] * g[:, None, None, :]
                       + g[:, None, :, None] * eye[None, :, None, :])   # E[t, a, i, j]
            ES = np.einsum("taij,ij->ta", E, S_e)
            Ael += qw * (eta_e * np.einsum("taij,rbij->tarb", E, E)
                         + deta_e * ES[:, :, None, None] * ES[None, None])
            Mel += qw * np.outer(basis[:, qi], basis[:, qi])
        # zeroN filtering inside the element (stokes.C:1420-1432)
        rows = {}
        for ti, t in enumerate(corners):
            node = tuple(el[ax] + t[ax] for ax in range(d))
            for a in range(d):
                rows[(ti, a)] = (int(flat[node]) * d + a, int(num[node + (a,)]))
        if zeroN:
            for (ti, a), (gi, ni) in rows.items():
                if 0 <= ni < zeroN:
                    for (rj, b), (gj, nj) in rows.items():
                        if (rj, b) == (ti, a):
                            Ael[ti, a, rj, b] = zeroV
                        else:
                            Ael[ti, a, rj, b] = 0.0
                            Ael[rj, b, ti, a] = 0.0
        for (ti, a), (gi, ni) in rows.items():
            if ni < 0:
                continue
            for (rj, b), (gj, nj) in rows.items():
                if nj < 0:
                    continue
                A[gi, gj] += Ael[ti, a, rj, b]
                lump[gi] += Mel[ti, rj]
    safe = np.where(lump > 0, lump, 1.0)
    return A / safe[:, None]
