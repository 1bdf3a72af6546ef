"""The port's CUDA kernels on the card: each against its plain version, the
launch counters, and the production switch.  Marked ``cuda``; every test
skips without CUDA (decided in the fixture, not at import).  On the card:

    python -m pytest tests/test_torch_gpu.py -m cuda -q -p no:randomly --noconftest
"""

import json

import numpy as np
import pytest
import torch

from spectral_tpu_torch.grid import Grid
from spectral_tpu_torch.models.elliptic import EllipticModel
from spectral_tpu_torch.models.poisson import PoissonModel
from spectral_tpu_torch.ops import chebyshev, cuda_cheb

pytestmark = pytest.mark.cuda

# max |kernel - plain| / max |plain|: both sum n products in the working
# dtype, in different orders
BOUND = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    cuda_cheb.reset_launch_counts()
    return torch.device("cuda")


def _rel(got, ref):
    return float(torch.max(torch.abs(got - ref)) / torch.max(torch.abs(ref)))


def _randn(shape, dtype, device, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,scale", [((3, 10, 16), None), ((7, 12), None),
                                         ((5, 12), 0.25), ((13, 10), None),
                                         ((2, 3, 128), None),
                                         ((1000, 64), None),
                                         ((32, 32, 32), None),    # the 32^3 elliptic paths
                                         ((12,) * 5, None)])      # the 5-D elliptic paths
def test_k1_matches_plain(cuda, dtype, shape, scale):
    u = _randn(shape, dtype, cuda, 0)
    got = cuda_cheb.chebdiff_last(u, scale)
    assert _rel(got, cuda_cheb.chebdiff_last_ref(u, scale)) <= BOUND[dtype]
    assert cuda_cheb.LAUNCHES["chebdiff_last_kernel"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dims,scales", [((12, 10, 8), None),
                                         ((20, 20, 20), (0.25, 1.0, 4.0))])
def test_k2_matches_plain(cuda, dtype, dims, scales):
    u = _randn(dims, dtype, cuda, 1)
    mask = Grid(dims, device=cuda).boundary_mask
    got = cuda_cheb.laplacian3d(u, mask, scales)
    assert _rel(got, cuda_cheb.laplacian3d_ref(u, mask, scales)) <= BOUND[dtype]
    assert torch.equal(got[mask], u[mask])
    assert cuda_cheb.LAUNCHES["laplacian3d_plane_kernel"] == 1
    assert cuda_cheb.LAUNCHES["laplacian3d_x_kernel"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dims,scales", [((20, 12, 10), (0.25, 1.0, 4.0)),
                                         ((64, 48, 40), (2.0, 0.5, 1.0)),
                                         ((13, 11, 9), None),    # ny * nz = 99
                                         ((8, 170, 3), None)])
def test_k2_non_cubic(cuda, dtype, masked, dims, scales):
    """K2's two passes on fields that are not cubes, with sizes that are not
    all multiples of 4 (zero-padded contractions, scalar copies and stores,
    ragged row and column tiles).  (8, 170, 3) in float64 is a field the
    single-pass K2 refused for shared memory and the plane pass takes."""
    u = _randn(dims, dtype, cuda, 8)
    mask = Grid(dims, device=cuda).boundary_mask if masked else None
    got = cuda_cheb.laplacian3d(u, mask, scales)
    assert _rel(got, cuda_cheb.laplacian3d_ref(u, mask, scales)) <= BOUND[dtype]
    if masked:
        assert torch.equal(got[mask], u[mask])
    assert cuda_cheb.LAUNCHES["laplacian3d_plane_kernel"] == 1
    assert cuda_cheb.LAUNCHES["laplacian3d_x_kernel"] == 1


@pytest.mark.parametrize("dtype,dims", [(torch.float64, (4, 118, 118)),
                                        (torch.float32, (3, 22, 230)),
                                        (torch.float64, (5, 100, 7))])
def test_k2_unpadded_plane(cuda, dtype, dims):
    """Fields whose padded plane does not fit in shared memory take the
    unpadded plane pass; the single-pass K2 took (4, 118, 118) and
    (3, 22, 230).  (5, 100, 7) is tiled, against the rule's mirror."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    tiled = cuda_cheb.laplacian3d_plane_tiled(dims, itemsize)
    assert tiled == (dims == (5, 100, 7))
    u = _randn(dims, dtype, cuda, 10)
    grid = cuda_cheb.laplacian3d_grid(u)
    assert grid["plane"]["tiled"] == tiled
    assert grid["plane"]["smem"] <= cuda_cheb.SMEM_LIMIT
    mask = Grid(dims, device=cuda).boundary_mask
    for scales in (None, (0.5, 2.0, 1.0)):
        got = cuda_cheb.laplacian3d(u, mask, scales)
        assert _rel(got, cuda_cheb.laplacian3d_ref(u, mask, scales)) <= BOUND[dtype]
        assert torch.equal(got[mask], u[mask])
    assert cuda_cheb.LAUNCHES["laplacian3d_plane_kernel"] == 2


def _least_busy_rows(extent, most, sms):
    """The C side's least_busy_rows for one copy: the rows a tile, a
    multiple of 4 up to ``most``, that give the busiest SM the fewest rows;
    the larger on a tie."""
    def busiest(rows):
        tiles = -(-extent // rows)
        return -(-tiles // sms) * rows

    return min(range(most, 3, -4), key=busiest)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k1_tile_height_switch(cuda, dtype):
    """Where full tiles would leave resident blocks empty, K1 takes one tile
    a block, smaller at 64^3 (on 132 SMs, 128 tiles of 32 rows, not 64 of
    64; the expected tile follows the card's SM count); from the M whose
    full tiles fill them, the full tile and a persistent grid.  Each side
    of the switch, ragged tails, against the plain version."""
    big = torch.empty((1 << 20, 64), dtype=dtype, device=cuda)
    full = cuda_cheb.chebdiff_last_grid(big)
    full_rows, resident = full["rows"], full["blocks"]
    del big
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    rows64 = _least_busy_rows(64 * 64, full_rows, sms)
    cases = ((64 * 64, "smaller tile"), (full_rows * (resident - 1) - 3, "one tile a block"),
             (full_rows * resident + 3, "persistent"))
    for M, kind in cases:
        u = _randn((M, 64), dtype, cuda, 9)
        grid = cuda_cheb.chebdiff_last_grid(u)
        rows, blocks = grid["rows"], grid["blocks"]
        if kind == "smaller tile":
            assert (rows, blocks) == (rows64, -(-M // rows64)), (M, rows, blocks, sms)
        elif kind == "one tile a block":
            assert rows <= full_rows and blocks == -(-M // rows), (M, rows, blocks)
        else:
            assert (rows, blocks) == (full_rows, resident), (M, rows, blocks)
        got = cuda_cheb.chebdiff_last(u)
        assert _rel(got, cuda_cheb.chebdiff_last_ref(u)) <= BOUND[dtype]
    assert cuda_cheb.LAUNCHES["chebdiff_last_kernel"] == len(cases)


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    with pytest.raises(ValueError, match="n <= 128"):
        cuda_cheb.chebdiff_last(torch.zeros((4, 130), device=cuda))
    with pytest.raises(TypeError, match="float32 or float64"):
        cuda_cheb.chebdiff_last(torch.zeros((4, 8), device=cuda, dtype=torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        cuda_cheb.chebdiff_last(torch.zeros((8, 4), device=cuda).T)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_cheb.laplacian3d(torch.zeros((128, 128, 128), device=cuda,
                                          dtype=torch.float64))
    with pytest.raises(ValueError, match="block_rows"):
        cuda_cheb.chebdiff_packed(torch.zeros((4, 128), device=cuda), 2, block_rows=16)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_cheb.chebdiff_packed(torch.zeros((128, 8), device=cuda).T, 2)
    assert cuda_cheb.LAUNCHES == {"chebdiff_last_kernel": 0, "laplacian3d_plane_kernel": 0,
                                  "laplacian3d_x_kernel": 0, "chebdiff_packed_kernel": 0}


def test_auto_routes_last_axis_to_k1(cuda):
    u = _randn((6, 7, 16), torch.float64, cuda, 2)
    for axis in range(3):
        got = chebyshev.chebdiff(u, axis)
        ref = chebyshev.chebdiff(u.cpu(), axis).to(cuda)
        assert _rel(got, ref) <= 1e-12
    assert cuda_cheb.LAUNCHES["chebdiff_last_kernel"] == 1


def test_poisson_on_card_matches_host(cuda):
    """The 12^3 solve on the card (K1 in the operator) agrees with the same
    solve on the host: same iterations, solutions to 1e-10 relative."""
    res = {}
    for dev in ("cpu", cuda):
        m = PoissonModel(Grid((12, 12, 12), device=dev))
        u, f = m.exact_solution()
        res[str(dev)] = m.solve(m.rhs(u, f))
    host, card = res["cpu"], res[str(cuda)]
    assert card.iters == host.iters == 7, (card.iters, host.iters)
    rel = float(torch.linalg.vector_norm(card.x.cpu() - host.x)
                / torch.linalg.vector_norm(host.x))
    assert rel <= 1e-10, rel
    assert cuda_cheb.LAUNCHES["chebdiff_last_kernel"] > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("M,pack", [(1, 1), (37, 2), (100, 1), (1003, 2), (515, 1)])
@pytest.mark.parametrize("block_rows", [32, 64, 128])
def test_k3_matches_plain(cuda, dtype, M, pack, block_rows):
    """K3 against its plain version (the dense Kronecker product), ragged
    row tails included (no M here is a multiple of the tile but 1)."""
    u = _randn((M, 64 * pack), dtype, cuda, 3)
    s = 1.0 / 64**2
    got = cuda_cheb.chebdiff_packed(u, pack, s, block_rows=block_rows)
    assert _rel(got, cuda_cheb.chebdiff_packed_ref(u, pack, s)) <= BOUND[dtype]
    assert cuda_cheb.LAUNCHES["chebdiff_packed_kernel"] == 1


def test_k3_odd_pencil_length(cuda):
    """n not a multiple of 4 (zero-padded k extent), 3 pencils a row."""
    u = _randn((70, 3 * 10), torch.float64, cuda, 4)
    got = cuda_cheb.chebdiff_packed(u, 3, block_rows=32)
    assert _rel(got, cuda_cheb.chebdiff_packed_ref(u, 3)) <= BOUND[torch.float64]


def _k3_sync_case(name, device):
    """(u2d, pack) that a bulk copy cannot take: n = 10 (k padded in shared
    memory), or a view one element into its storage (not 16-byte aligned)."""
    if name == "n10_pack3":
        return _randn((70, 3 * 10), torch.float32, device, 5), 3
    buf = _randn((515 * 64 + 1,), torch.float32, device, 6)
    return buf[1:].view(515, 64), 1


@pytest.mark.parametrize("name", ["n10_pack3", "misaligned"])
@pytest.mark.parametrize("block_rows", [32, 128])
def test_k3_synchronous_branch(cuda, name, block_rows):
    """K3's producer warp copies the stages itself where a bulk copy cannot."""
    u, pack = _k3_sync_case(name, cuda)
    assert not cuda_cheb.chebdiff_packed_bulk(u, pack)
    got = cuda_cheb.chebdiff_packed(u, pack, 0.5, block_rows=block_rows)
    assert _rel(got, cuda_cheb.chebdiff_packed_ref(u, pack, 0.5)) <= BOUND[torch.float32]
    assert cuda_cheb.LAUNCHES["chebdiff_packed_kernel"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k3_one_pencil_tail(cuda, dtype):
    """An aligned (bulk-copy) case whose last row tile is one pencil: its
    full barrier is armed for 256 (512) bytes, not a whole tile."""
    u = _randn((2 * 128 + 1, 64), dtype, cuda, 7)
    assert cuda_cheb.chebdiff_packed_bulk(u, 1)
    got = cuda_cheb.chebdiff_packed(u, 1, block_rows=128)
    assert _rel(got, cuda_cheb.chebdiff_packed_ref(u, 1)) <= BOUND[dtype]


def test_grid_defaults_to_the_card(cuda):
    g = Grid((8, 8))
    assert g.device.type == "cuda" and g.boundary_mask.device.type == "cuda"
    assert g.coords.device.type == "cuda"


@pytest.mark.parametrize("dims,pc,slack", [((16, 16), "fastdiag", 0), ((12, 12, 12), "mg3", 3)])
def test_elliptic_on_card_matches_host(cuda, dims, pc, slack):
    """The float64 Newton solve on the card, with K1 in every residual and
    Jacobian action (method "auto") and without it (method "matmul"),
    against the same solve on the host: the same Newton count, solutions
    to 1e-10 relative.  The Krylov counts per Newton step are equal at
    16^2; at 12^3 with mg3 each step takes 7-19 iterations to rtol 1e-5
    and the count moves with the summation order (one run: [7, 12, 13, 16,
    19] on the card, [7, 13, 13, 15, 17] on the host), so there each step
    is held within ``slack``.  The counts of the three solves are printed
    (``-rP`` shows them): the "matmul" solve on the card tells a fault of
    K1 from the card's summation order."""
    res = {}
    for dev, method in (("cpu", "auto"), (cuda, "auto"), (cuda, "matmul")):
        cuda_cheb.reset_launch_counts()
        m = EllipticModel(Grid(dims, device=dev), gamma=1.0, method=method)
        _, b, d = m.setup_problem(exact=0)
        res[(str(dev), method)] = r = m.solve(b, d, pc_type=pc)
        k1 = cuda_cheb.LAUNCHES["chebdiff_last_kernel"]
        assert (k1 > 0) == (dev == cuda and method == "auto"), (dev, method, k1)
        print(json.dumps({"dims": dims, "pc": pc, "device": str(dev), "method": method,
                          "newton": r.iters, "krylov": r.ksp_iters, "k1_launches": k1}))
    host = res[("cpu", "auto")]
    for method in ("auto", "matmul"):
        card = res[(str(cuda), method)]
        assert card.iters == host.iters, (method, card.iters, host.iters)
        assert all(abs(a - b) <= slack for a, b in zip(card.ksp_iters, host.ksp_iters)), (
            method, card.ksp_iters, host.ksp_iters)
        rel = float(torch.linalg.vector_norm(card.x.cpu() - host.x)
                    / torch.linalg.vector_norm(host.x))
        assert rel <= 1e-10, (method, rel)


def test_elliptic_refined_on_card(cuda):
    """Mixed precision at 12^3 on the card: float32 Newton + float64
    refinement reach rel residual 1e-10 by both loops."""
    m = EllipticModel(Grid((12, 12, 12), device=cuda), gamma=1.0)
    u, b, d = m.setup_problem_np(exact=0)
    for name in ("solve_refined", "solve_refined_fused"):
        x, info = getattr(m, name)(b, d, rtol=1e-10, pc_type="mg3")
        assert info["rel_residual"] <= 1e-10, (name, info["rel_residual"])
        assert np.max(np.abs(x - u)) <= 1e-6   # 7.68e-7: the 12^3 discretisation error
    assert cuda_cheb.LAUNCHES["chebdiff_last_kernel"] > 0


def _stokes_state(p, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    v = np.where(p.vel_mask_np, scale * rng.standard_normal(p.vel_mask_np.shape), 0.0)
    q = np.where(p.p_mask_np, scale * rng.standard_normal(p.p_mask_np.shape), 0.0)
    return {"v": torch.from_numpy(v), "p": torch.from_numpy(q)}


@pytest.mark.parametrize("rheology", [0, 1])
def test_stokes_residual_and_jacobian_on_card(cuda, rheology):
    """The Stokes residual and Jacobian action at 8^3 on the card (K1 on the
    pressure gradient's last axis) against the port on the host, to 1e-12
    relative to the largest entry."""
    from spectral_tpu_torch.models.stokes import StokesConfig, StokesProblem

    cfg = StokesConfig(exact=2, rheology=rheology, exponent=3.0, regularization=1e-2)
    host = StokesProblem(Grid((8, 8, 8), device="cpu"), cfg)
    card = StokesProblem(Grid((8, 8, 8), device=cuda), cfg)
    x, w = _stokes_state(host, 1, 0.3), _stokes_state(host, 2)
    xc, wc = ({k: v.to(cuda) for k, v in s.items()} for s in (x, w))
    F_h, ls_h = host.make_residual(host.params_at(1))(x)
    cuda_cheb.reset_launch_counts()
    F_c, ls_c = card.make_residual(card.params_at(1))(xc)
    J_h, J_c = host.jacobian_action(x, ls_h, w), card.jacobian_action(xc, ls_c, wc)
    for got, ref in ((F_c, F_h), (J_c, J_h)):
        for k in ("v", "p"):
            assert _rel(got[k].cpu(), ref[k]) <= 1e-12, k
    key = (torch.Size((8, 8, 8)), torch.float64)
    assert cuda_cheb.K1_LAUNCHES_BY_SHAPE.get(key, 0) == 2   # one a pressure gradient


def test_stokes_linear_solve_on_card(cuda):
    """test_linear_stokes_2d's configuration (12x12) on the card: the host's
    Newton and Krylov counts, the solution to 1e-10 relative (over both
    fields: the exact pressure is 0, so the computed one is all solve
    error, 1e-7 of itself between the two summation orders), and K1 on
    every pressure gradient and Schur divergence, (12, 12) float64."""
    from spectral_tpu_torch.models.stokes import StokesConfig, StokesProblem

    res, k1 = {}, {}
    for dev in ("cpu", cuda):
        p = StokesProblem(Grid((12, 12), device=dev), StokesConfig(exact=2, cont0=1))
        cuda_cheb.reset_launch_counts()
        res[str(dev)] = r = p.solve()
        k1[str(dev)] = dict(cuda_cheb.K1_LAUNCHES_BY_SHAPE)
        print(json.dumps({"device": str(dev), "newton": r.iters, "krylov": r.ksp_iters,
                          "error": p.error_vs_exact(r.x),
                          "k1_by_shape": {str(tuple(s)) + " " + str(d): c
                                          for (s, d), c in k1[str(dev)].items()}}))
    host, card = res["cpu"], res[str(cuda)]
    assert card.iters == host.iters == 1 and card.reason == host.reason > 0
    assert card.ksp_iters == host.ksp_iters
    diff = sum(float(torch.sum((card.x[k].cpu() - host.x[k]) ** 2)) for k in ("v", "p"))
    norm = sum(float(torch.sum(host.x[k] ** 2)) for k in ("v", "p"))
    assert (diff / norm) ** 0.5 <= 1e-10, (diff / norm) ** 0.5
    assert k1["cpu"] == {}
    assert set(k1[str(cuda)]) == {(torch.Size((12, 12)), torch.float64)}
    assert k1[str(cuda)][(torch.Size((12, 12)), torch.float64)] > 0


def test_stokes_refined_on_card(cuda):
    """Mixed precision at 10x10 on the card: float32 continuation and inner
    solves (K1 in float32), float64 host residuals, rel residual 1e-10."""
    from spectral_tpu_torch.models.stokes import StokesConfig, StokesProblem

    p = StokesProblem(Grid((10, 10), device=cuda), StokesConfig(exact=2, cont0=1))
    cuda_cheb.reset_launch_counts()
    x, info = p.solve_refined(rtol=1e-10)
    assert info["rel_residual"] <= 1e-10, info["rel_residual"]
    assert cuda_cheb.K1_LAUNCHES_BY_SHAPE.get((torch.Size((10, 10)), torch.float32), 0) > 0


def test_line_solves_on_card(cuda):
    """ops/tridiag.py on the card (batched torch.linalg.inv and matmul,
    the Thomas loop) against the host on the same inputs, with a
    component-dependent mask, to 1e-12 relative in float64."""
    from spectral_tpu_torch.ops import tridiag
    from spectral_tpu_torch.ops.stencil import StencilOp

    rng = np.random.default_rng(7)
    dims = (7, 6, 5)
    lower = [-(0.2 + rng.random(dims)) for _ in dims]
    upper = [-(0.2 + rng.random(dims)) for _ in dims]
    center = 8.5 + rng.random(dims)
    x, b = rng.standard_normal(dims + (3,)), rng.standard_normal(dims + (3,))
    mask = rng.random(dims + (3,)) > 0.3
    out = {}
    for dev in ("cpu", cuda):
        def t(a):
            return torch.as_tensor(a, device=dev)
        S = StencilOp(t(center), tuple(map(t, lower)), tuple(map(t, upper)))
        sv = tridiag.build_line_solvers(S, (0, 1, 2), mask=t(mask))
        out[str(dev)] = (tridiag.line_smooth(S, t(x), t(b), (0, 1, 2), sweeps=2, mask=t(mask),
                                             solvers=sv),
                         tridiag.line_smooth(S, t(x), t(b), (0, 1, 2), sweeps=2, mask=t(mask)),
                         tridiag.thomas(S.lower[1], S.center, S.upper[1], t(b), 1))
    for got, ref in zip(out[str(cuda)], out["cpu"]):
        assert got.device.type == "cuda" and _rel(got.cpu(), ref) <= 1e-12


@pytest.mark.parametrize("pcvel,boundary,tbc", [("fastdiag", 1, 1), ("mg", 2, 0),
                                                ("mg", 2, 1), ("nodal", 0, 0)])
def test_mixed_velocity_pc_on_card(cuda, pcvel, boundary, tbc):
    """One velocity PC apply at 8^3 on the card (line-relaxed traction
    rows, the traction-block LU, the nodal stencil's V-cycle; line
    smoother with nodal) against the host, 1e-11 relative in float64."""
    from spectral_tpu_torch.models.stokes import StokesConfig, StokesProblem

    cfg = StokesConfig(exact=2, rheology=1, exponent=3.0, regularization=1e-2, pcvel=pcvel,
                       boundary=boundary, tbc=tbc,
                       pcvel_smoother="line" if pcvel == "nodal" else "chebyshev")
    out = {}
    for dev in ("cpu", cuda):
        p = StokesProblem(Grid((8, 8, 8), device=dev), cfg)
        x, r = _stokes_state(p, 3, 0.3), _stokes_state(p, 4)
        _, ls = p.make_residual(p.params_at(1))({k: v.to(dev) for k, v in x.items()})
        setup, apply = p.make_vel_pc()
        out[str(dev)] = apply(setup(ls), r["v"].to(dev))
    assert _rel(out[str(cuda)].cpu(), out["cpu"]) <= 1e-11


def test_stokes_refined_fused_on_card(cuda):
    """solve_refined_fused at 12^3 on the card (linear, the whole solve in
    the refinement loop) against the same on the host: rel residual
    <= 1e-10 on both, the solutions within 1e-9, K1 launched in float64
    (the device residual) and float32 (the inner solves)."""
    from spectral_tpu_torch.models.stokes import StokesConfig, StokesProblem

    xs = {}
    for dev in ("cpu", cuda):
        p = StokesProblem(Grid((12, 12, 12), device=dev), StokesConfig(exact=2, cont0=1))
        cuda_cheb.reset_launch_counts()
        xs[str(dev)], info = p.solve_refined_fused(rtol=1e-10)
        print(json.dumps({"device": str(dev), "refine_steps": info["refine_steps"],
                          "inner": info["refine_inner_iters"], "rel": info["rel_residual"],
                          "error": p.error_vs_exact(xs[str(dev)])}))
        assert info["rel_residual"] <= 1e-10, info
    for dt in (torch.float32, torch.float64):
        assert cuda_cheb.K1_LAUNCHES_BY_SHAPE.get((torch.Size((12, 12, 12)), dt), 0) > 0
    for k in ("v", "p"):
        np.testing.assert_allclose(xs[str(cuda)][k], xs["cpu"][k], rtol=0, atol=1e-9)


@pytest.mark.parametrize("shape", [(8, 8, 8), (10, 10, 10), (16, 16, 16)])
def test_k1_grid_sequence_shapes(cuda, shape):
    """K1 at the shapes grid sequencing adds (the coarse levels of the
    32^3 elliptic and 20^3 Stokes runs): bit for bit its plain version in
    float64, 1e-5 relative in float32."""
    for dtype in (torch.float64, torch.float32):
        u = _randn(shape, dtype, cuda, 5)
        got, ref = cuda_cheb.chebdiff_last(u), cuda_cheb.chebdiff_last_ref(u)
        assert torch.equal(got, ref) if dtype == torch.float64 else _rel(got, ref) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_q1_fem_on_card(cuda, dtype):
    """assemble_q1_strain (with -zeroN), Q1StrainStencil.apply and
    Q1FastDiag.apply at 8^3 on the card against the host."""
    from spectral_tpu_torch.ops.fem import Q1FastDiag, assemble_q1_strain

    dims, tol = (8, 8, 8), (1e-12 if dtype == torch.float64 else 1e-5)
    rng = np.random.default_rng(9)
    eta, deta = 1.0 + rng.random(dims), 0.3 * rng.standard_normal(dims)
    Sr = rng.standard_normal(dims + (3, 3))
    S = 0.5 * (Sr + np.swapaxes(Sr, -1, -2))
    vm = ~np.broadcast_to(Grid(dims, device="cpu").boundary_mask_np[..., None], dims + (3,))
    x = rng.standard_normal(dims + (3,))
    out = {}
    for dev in ("cpu", cuda):
        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)
        A = assemble_q1_strain(Grid(dims, device=dev), t(eta), t(deta), t(S),
                               torch.as_tensor(np.ascontiguousarray(vm), device=dev), zeroN=7)
        fd = Q1FastDiag.build(Grid(dims, device=dev), dtype=dtype)
        out[str(dev)] = [*A.coef, A.apply(t(x)), fd.apply(t(x))]
    for got, ref in zip(out[str(cuda)], out["cpu"]):
        assert got.device.type == "cuda" and _rel(got.cpu(), ref) <= tol


def test_colored_probes_on_card(cuda):
    """Both colored probes of the Stokes velocity block at (9, 7) on the
    card against the host, float64."""
    from spectral_tpu_torch.models.stokes import StokesConfig, StokesProblem
    from spectral_tpu_torch.models.stokes_pc import (colored_probe_stencil,
                                                     colored_probe_stencil_full)

    cfg = StokesConfig(exact=2, rheology=1, exponent=3.0, regularization=1e-2)
    out = {}
    for dev in ("cpu", cuda):
        p = StokesProblem(Grid((9, 7), device=dev), cfg)
        x = {k: v.to(dev) for k, v in _stokes_state(p, 3, 0.3).items()}
        _, ls = p.make_residual(p.params_at(1))(x)

        def mv(s):   # the x-component block
            w = torch.zeros((9, 7, 2), dtype=s.dtype, device=s.device)
            w[..., 0] = s
            return p.vv_action(ls, w)[..., 0]

        S1 = colored_probe_stencil(mv, p.grid)
        S2 = colored_probe_stencil_full(lambda w: p.vv_action(ls, w), p.grid, p.vel_mask)
        out[str(dev)] = [S1.center, *S1.lower, *S1.upper, *S2.coef]
    for got, ref in zip(out[str(cuda)], out["cpu"]):
        assert got.device.type == "cuda"
        assert _rel(got.cpu(), ref) <= 1e-12 if float(torch.max(torch.abs(ref))) > 0 \
            else float(torch.max(torch.abs(got))) == 0.0


@pytest.mark.parametrize("pcvel,boundary,tbc", [("q1fem", 0, 0), ("q1sep", 0, 0),
                                                ("probed", 0, 0), ("probed1", 0, 0),
                                                ("q1fem", 1, 1)])
def test_q1_and_probed_velocity_pc_on_card(cuda, pcvel, boundary, tbc):
    """One Q1 or probed velocity PC apply at 8^3 on the card (with the
    traction-block correction on Neumann boundaries for q1fem) against the
    host, 1e-11 relative in float64."""
    from spectral_tpu_torch.models.stokes import StokesConfig, StokesProblem

    cfg = StokesConfig(exact=2, rheology=1, exponent=3.0, regularization=1e-2, pcvel=pcvel,
                       boundary=boundary, tbc=tbc)
    out = {}
    for dev in ("cpu", cuda):
        p = StokesProblem(Grid((8, 8, 8), device=dev), cfg)
        x, r = _stokes_state(p, 3, 0.3), _stokes_state(p, 4)
        _, ls = p.make_residual(p.params_at(1))({k: v.to(dev) for k, v in x.items()})
        setup, apply = p.make_vel_pc()
        out[str(dev)] = apply(setup(ls), r["v"].to(dev))
    assert _rel(out[str(cuda)].cpu(), out["cpu"]) <= 1e-11


# -- the dense tier and time stepping -----------------------------------------------

@pytest.mark.parametrize("shape,in_dims", [((64, 16, 16, 16), 0), ((12, 12, 9, 12), 2)])
def test_k1_under_vmap_matches_plain(cuda, shape, in_dims):
    """K1 under torch.func.vmap (the dense assembly's route): one launch on
    the batch, batch axis first, bit for bit its plain version in float64."""
    u = _randn(shape, torch.float64, cuda, 4)
    got = torch.func.vmap(lambda x: chebyshev.chebdiff(x, -1), in_dims=in_dims)(u)
    phys = u.movedim(in_dims, 0).contiguous()
    assert torch.equal(got, cuda_cheb.chebdiff_last_ref(phys))
    assert cuda_cheb.LAUNCHES["chebdiff_last_kernel"] == 1
    assert cuda_cheb.K1_LAUNCHES_BY_SHAPE == {(phys.shape, torch.float64): 1}


def test_dense_assembly_on_card(cuda):
    """The mass-shifted saddle Jacobian assembled on the card (K1 under
    vmap on the pressure's last axis) against the same assembly on the
    host, and the device inverse's apply against the host float64 one."""
    from spectral_tpu_torch.models.stokes import StokesConfig, StokesProblem
    from spectral_tpu_torch.ops import dense

    cfg = StokesConfig(exact=2, mass_shift=20.0)
    mats = {}
    for dev in ("cpu", cuda):
        p = StokesProblem(Grid((8, 8, 8), device=dev), cfg)
        lin = (torch.ones((8, 8, 8), dtype=torch.float64, device=dev),
               torch.zeros((8, 8, 8), dtype=torch.float64, device=dev),
               torch.zeros((8, 8, 8, 3, 3), dtype=torch.float64, device=dev))
        mats[str(dev)] = p, lin, dense.assemble_dense_device(
            lambda w: p.jacobian_action(None, lin, w), p.zero_state(), block=512)[0]
    A_host, A_card = mats["cpu"][2], mats["cuda"][2].cpu()
    assert _rel(A_card, A_host) <= 1e-13
    assert cuda_cheb.K1_LAUNCHES_BY_SHAPE[(torch.Size((512, 8, 8, 8)), torch.float64)] == 4
    p, lin, _ = mats["cuda"]
    r = {k: v.to(cuda) for k, v in _stokes_state(p, 3).items()}
    outs = [p.make_dense_pc(lin_state=lin, factor=f)[1](None, r) for f in ("host", "device")]
    for k in ("v", "p"):
        assert _rel(outs[1][k], outs[0][k]) <= 1e-9


def test_cg_on_card(cuda):
    """CG on the heat model's implicit operator (K1 in the Laplacian):
    the card's counts and history equal the host's."""
    from spectral_tpu_torch.models.heat import HeatModel
    from spectral_tpu_torch.solvers.krylov import cg

    out = {}
    for dev in ("cpu", cuda):
        m = HeatModel(Grid((24, 24, 24), device=dev), dt=0.01)
        b = _randn((24, 24, 24), torch.float64, dev, 5)
        out[str(dev)] = cg(m.implicit_operator, b, M=m._pc_apply, rtol=1e-10, max_it=100)
    host, card = out["cpu"], out["cuda"]
    assert card.iters == host.iters and card.reason == host.reason
    assert _rel(card.x.cpu(), host.x) <= 1e-10
    assert cuda_cheb.LAUNCHES["chebdiff_last_kernel"] > 0


def test_heat_and_unsteady_steps_on_card(cuda):
    """A heat BDF2 step at 24^3 and a linear unsteady Stokes CN step at
    12^3 on the card against the same steps on the host."""
    from spectral_tpu_torch.models.heat import HeatModel
    from spectral_tpu_torch.models.stokes import StokesConfig
    from spectral_tpu_torch.models.stokes_unsteady import UnsteadyStokes

    heat, us = {}, {}
    for dev in ("cpu", cuda):
        m = HeatModel(Grid((24, 24, 24), device=dev), dt=0.01)
        u0 = _randn((24, 24, 24), torch.float64, dev, 6)
        z = torch.zeros_like(u0)
        heat[str(dev)] = m.step_bdf2_dt(u0, 0.9 * u0, z, z, 0.01, 1.0)
        u = UnsteadyStokes(Grid((12, 12, 12), device=dev), StokesConfig(exact=1), dt=0.05)
        v0, s_of_t, f_of_t, _, _ = u.manufactured()
        us[str(dev)] = u.step(v0, s_of_t(0.05), 0.5 * (f_of_t(0.0) + f_of_t(0.05)))
    assert _rel(heat["cuda"].cpu(), heat["cpu"]) <= 1e-10
    (hv, hp, hits, _), (cv, cp, cits, _) = us["cpu"], us["cuda"]
    assert abs(cits - hits) <= 1
    assert _rel(cv.cpu(), hv) <= 1e-8 and _rel(cp.cpu(), hp) <= 1e-8
    assert cuda_cheb.K1_LAUNCHES_BY_SHAPE[(torch.Size((12, 12, 12)), torch.float64)] > 0


# -- convection and the eigensolver --------------------------------------------------

@pytest.mark.parametrize("shape", [(12, 12), (14, 14, 12), (1024, 14, 14, 12)])
def test_k1_convection_shapes(cuda, shape):
    """K1 at the convection paths' shapes, float64, bit for bit its plain
    version; the batched assembly block also under torch.func.vmap."""
    u = _randn(shape, torch.float64, cuda, 7)
    assert torch.equal(cuda_cheb.chebdiff_last(u), cuda_cheb.chebdiff_last_ref(u))
    if len(shape) == 4:
        cuda_cheb.reset_launch_counts()
        got = torch.func.vmap(lambda x: chebyshev.chebdiff(x, -1))(u)
        assert torch.equal(got, cuda_cheb.chebdiff_last_ref(u))
        assert cuda_cheb.LAUNCHES["chebdiff_last_kernel"] == 1


def test_k1_under_jvp(cuda):
    """K1's forward-mode rule (torch.func.jvp, the variable-viscosity
    stability path): the primal and the tangent each one launch, both
    equal to the plain derivative."""
    u, t = _randn((6, 9, 12), torch.float64, cuda, 8), _randn((6, 9, 12), torch.float64, cuda, 9)
    y, dy = torch.func.jvp(lambda x: chebyshev.chebdiff(x, -1), (u,), (t,))
    assert torch.equal(y, cuda_cheb.chebdiff_last_ref(u))
    assert torch.equal(dy, cuda_cheb.chebdiff_last_ref(t))
    assert cuda_cheb.LAUNCHES["chebdiff_last_kernel"] == 2


@pytest.mark.parametrize("velocity_bc,stokes_pc", [("noslip", "nested"), ("freeslip", "dense")])
def test_convection_step_on_card(cuda, velocity_bc, stokes_pc):
    """One coupled convection step at 12x12 on the card against the same
    step on the host (K1 on the last axis of every derivative)."""
    from spectral_tpu_torch.models.convection import ConvectionConfig, ConvectionModel
    from spectral_tpu_torch.solvers.krylov import KSPConfig

    cfg = ConvectionConfig(velocity_bc=velocity_bc, side_bc="insulated", stokes_pc=stokes_pc,
                           stokes_ksp=KSPConfig(type="fgmres", rtol=1e-12, max_it=100,
                                                restart=50))
    out = {}
    for dev in ("cpu", cuda):
        m = ConvectionModel.unit_box((12, 12), cfg, device=dev)
        T = m.conductive_state(amp=0.05)
        out[str(dev)] = m.step(T, torch.zeros_like(T), m.stokes.zero_state())
    (Th, Nh, xh), (Tc, Nc, xc) = out["cpu"], out["cuda"]
    assert _rel(Tc.cpu(), Th) <= 1e-10 and _rel(Nc.cpu(), Nh) <= 1e-10
    assert _rel(xc["v"].cpu(), xh["v"]) <= 1e-10
    assert cuda_cheb.K1_LAUNCHES_BY_SHAPE[(torch.Size((12, 12)), torch.float64)] > 0


def test_eigs_on_card(cuda):
    """The Krylov-Schur eigensolver with its basis on the card against the
    host basis on the host: the same eigenvalues (1e-10) and the basis
    tensor on the card throughout."""
    from spectral_tpu_torch.solvers import eig

    rng = np.random.default_rng(10)
    A = rng.standard_normal((300, 300)) * 0.3 + np.diag(np.linspace(-5.0, 5.0, 300))
    v0 = rng.standard_normal(300)
    devices = []
    orig = eig._DeviceBasis.expand_step

    def step(self, j):
        devices.append(self.V.device.type)
        return orig(self, j)

    eig._DeviceBasis.expand_step = step
    try:
        Ac = torch.as_tensor(A, device=cuda)
        card = eig.eigs(lambda v: Ac @ v, torch.as_tensor(v0, device=cuda), k=4, m=30, tol=1e-11)
    finally:
        eig._DeviceBasis.expand_step = orig
    Ah = torch.as_tensor(A)
    host = eig.eigs(lambda v: Ah @ v, torch.as_tensor(v0), k=4, m=30, tol=1e-11,
                    device_basis=False)
    assert card.converged and host.converged
    assert devices and set(devices) == {"cuda"}
    assert np.abs(card.eigenvalues - host.eigenvalues).max() <= 1e-10 * 5.0


# -- the differentiable tier: K1 in reverse mode, the adjoints --------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(12, 12, 12), (6, 9, 12), (20, 20, 20), (16, 16)])
def test_k1_reverse_mode_on_card(cuda, dtype, shape):
    """chebdiff's reverse mode on the card (the autograd pair, K1^T = the
    kernel with s D as its right factor): torch.func.vjp and .grad of a
    requires_grad tensor equal the plain g @ (s D) (bit for bit in float64
    where the forward is), jvp-of-vjp the matmul path's within BOUND; each
    transposed launch counted by shape."""
    u, ct, t = (_randn(shape, dtype, cuda, 20 + i) for i in range(3))
    want = cuda_cheb.chebdiff_last_t_ref(ct)
    fwd_bitwise = torch.equal(cuda_cheb.chebdiff_last(u), cuda_cheb.chebdiff_last_ref(u))
    cuda_cheb.reset_launch_counts()
    got = torch.func.vjp(lambda x: chebyshev.chebdiff(x, -1), u)[1](ct)[0]
    x = u.clone().requires_grad_()
    (chebyshev.chebdiff(x, -1) * ct).sum().backward()
    for g in (got, x.grad):
        assert _rel(g, want) <= BOUND[dtype]
        if fwd_bitwise and dtype == torch.float64:
            assert torch.equal(g, want)
    assert cuda_cheb.K1T_LAUNCHES_BY_SHAPE[(torch.Size(shape), dtype)] == 2

    def jvp_of_vjp(d):
        def f(z):
            y = d(z)
            return y * y
        return torch.func.jvp(lambda z: torch.func.vjp(f, z)[1](ct)[0], (u,), (t,))[1]

    assert _rel(jvp_of_vjp(lambda z: chebyshev.chebdiff(z, -1)),
                jvp_of_vjp(lambda z: chebyshev.chebdiff(z, -1, method="matmul"))) <= BOUND[dtype]


def test_k2_refuses_a_graph_on_card(cuda):
    u = _randn((12, 10, 8), torch.float64, cuda, 30)
    with pytest.raises(RuntimeError, match="reverse mode"):
        cuda_cheb.laplacian3d(u.clone().requires_grad_())
    with pytest.raises(RuntimeError, match="reverse mode"):
        torch.func.vmap(cuda_cheb.laplacian3d)(u[None])
    assert cuda_cheb.LAUNCHES["laplacian3d_plane_kernel"] == 0


def test_k1_repeated_launches_are_bitwise_stable(cuda):
    """K1 and K1^T at the 12^3 Poisson test's shape and at (20,20,20) f64,
    2,000 launches each on the same input, every output equal to the first
    (a race in the tile pipeline would show as a changed bit)."""
    for shape in ((12, 12, 12), (20, 20, 20)):
        u = _randn(shape, torch.float64, cuda, 31)
        first, first_t = cuda_cheb.chebdiff_last(u), cuda_cheb.chebdiff_last_t(u)
        same = torch.ones((), dtype=torch.bool, device=cuda)
        for _ in range(2000):
            same &= torch.equal(cuda_cheb.chebdiff_last(u), first)
            same &= torch.equal(cuda_cheb.chebdiff_last_t(u), first_t)
        assert bool(same), shape


def test_stokes_adjoint_on_card_matches_host(cuda):
    """StokesProblem.adjoint_gradient at 10x10 (tests/test_adjoint.py's
    power law, the nested adjoint PC) on the card and on the host from
    the same converged state: the same adjoint count, every gradient field
    to 1e-10 relative."""
    from spectral_tpu_torch.models.rheology import PowerLawParams
    from spectral_tpu_torch.models.stokes import StokesConfig, StokesProblem

    cfg = StokesConfig(exact=1, boundary=0, rheology=1, exponent=2.0, regularization=1e-2,
                       pcvel="fastdiag")
    host = StokesProblem(Grid((10, 10), device="cpu"), cfg)
    th = PowerLawParams(1.0, 2.0, 1e-2, 1.0)
    xs = host.solve(params=th).x
    out = {}
    for dev in ("cpu", cuda):
        p = StokesProblem(Grid((10, 10), device=dev), cfg)
        theta = PowerLawParams(*(torch.tensor(v, dtype=torch.float64, device=dev)
                                 for v in (1.0, 2.0, 1e-2, 1.0)))
        out[str(dev)] = p.adjoint_gradient(lambda x, _: torch.sum(x["v"] ** 2),
                                           {k: v.to(dev) for k, v in xs.items()}, theta)
    (gh, rh), (gc, rc) = out["cpu"], out["cuda"]
    assert rh.reason > 0 and rc.reason > 0 and rc.iters == rh.iters, (rc.iters, rh.iters)
    for f in ("hardness", "exponent", "regularization", "gamma0"):
        a, b = float(getattr(gc, f)), float(getattr(gh, f))
        assert abs(a - b) <= 1e-10 * abs(b), (f, a, b)
    assert sum(cuda_cheb.K1T_LAUNCHES_BY_SHAPE.values()) > 0


def test_transient_fit_demo_on_card(cuda, capsys):
    """The ported transient_fit_demo at its defaults on the card (8x8, 2
    CN steps a rollout): exit 0, hardness 1.6 recovered within 0.05."""
    from spectral_tpu_torch.examples import transient_fit_demo

    assert transient_fit_demo.main(["-device", "cuda"]) == 0
    assert "recovered hardness = 1.6" in capsys.readouterr().out
    assert sum(cuda_cheb.K1T_LAUNCHES_BY_SHAPE.values()) > 0


# -- the solver families (SNES, FAS, the short-recurrence Krylov types,
# recycling): each on the card against the same solver on the host ---------

def _cpu_close(card, host, tol=1e-10):
    """Norm-wise relative distance of a card tensor (or dict) to the host's."""
    if isinstance(host, dict):
        num = sum(float(torch.sum((card[k].cpu() - host[k]) ** 2)) for k in host)
        den = sum(float(torch.sum(host[k] ** 2)) for k in host)
        return (num / den) ** 0.5 <= tol
    return float(torch.linalg.vector_norm(card.cpu() - host)
                 / torch.linalg.vector_norm(host)) <= tol


@pytest.mark.parametrize("snes_type", ["newtontr", "qn", "anderson", "ngmres", "ngmres npc",
                                       "fas"])
def test_snes_family_on_card_matches_host(cuda, snes_type):
    """Each -snes_type of the elliptic driver (the driver's dispatch,
    _snes_solve) at 12^3, gamma 1, fastdiag PC, float64, on the card and on
    the host: the same iteration count, reason and Krylov counts, the
    solution to 1e-10 relative, K1 launched on the card."""
    from spectral_tpu_torch.cli.drivers import _snes_solve
    from spectral_tpu_torch.solvers.krylov import KSPConfig
    from spectral_tpu_torch.solvers.newton import NewtonConfig
    from spectral_tpu_torch.utils.options import Options

    argv = ["-snes_type", "ngmres", "-npc_snes_type", "newtonls"] if snes_type == "ngmres npc" \
        else ["-snes_type", snes_type]
    res = {}
    for dev in ("cpu", cuda):
        def make_model(dims, dev=dev):
            return EllipticModel(Grid(dims, device=dev), gamma=1.0)

        m = make_model((12, 12, 12))
        _, b, d = m.setup_problem(exact=0)
        cuda_cheb.reset_launch_counts()
        res[str(dev)] = r = _snes_solve(
            Options(argv), m, make_model, b, d, None,
            ksp=KSPConfig(type="fgmres", rtol=1e-5, max_it=500),
            newton=NewtonConfig(rtol=1e-10, max_it=50), pc="fastdiag")
        k1 = cuda_cheb.LAUNCHES["chebdiff_last_kernel"]
        assert (k1 > 0) == (dev == cuda)
        print(json.dumps({"snes_type": snes_type, "device": str(dev), "iters": r.iters,
                          "reason": r.reason_str(), "krylov": r.ksp_iters, "k1_launches": k1}))
    host, card = res["cpu"], res[str(cuda)]
    assert (card.iters, card.reason, card.ksp_iters) == (host.iters, host.reason, host.ksp_iters)
    assert _cpu_close(card.x, host.x)


def _poisson_pair(dev, dims=(12, 12, 12)):
    m = PoissonModel(Grid(dims, device=dev))
    u, f = m.exact_solution()
    return m, m.rhs(u, f), m.build_pc("fastdiag")


@pytest.mark.parametrize("ksp_type,extra", [("bcgs", {}), ("richardson", {}),
                                            ("chebyshev", {}),
                                            ("chebyshev", dict(emin=0.5, emax=5.0))])
def test_krylov_types_on_card_match_host(cuda, ksp_type, extra):
    """The Poisson solve at 12^3 with each short-recurrence type and the
    fastdiag PC (K1 in the operator), on the card and on the host: the
    same count and reason, the solution to 1e-10 relative where it
    converges (Chebyshev with its own bounds stops at the divergence
    tolerance on this spectrum, at the same step on both).  Richardson
    with an unscaled step diverges on this spectrum, as in the JAX
    package, until its residual norm (a sum of squares) overflows past
    sqrt(DBL_MAX) ~ 1.3e154: the same reason, the same norms to 1e-8
    relative over the first 40 steps, and each run's last finite norm
    past 1e150.  Later on the norm is carried by modes that grow from
    round-off, so the two runs part and the step at which each overflows
    is not compared: a host run with the PC scaled by 1 + 2^-52 parts
    from the host's own by more than 1% after step 100."""
    from spectral_tpu_torch.solvers.krylov import KSPConfig
    from spectral_tpu_torch.solvers.types import ConvergedReason

    cfg = KSPConfig(type=ksp_type, rtol=1e-10, max_it=500, **extra)
    res = {}
    for dev in ("cpu", cuda):
        m, b, M = _poisson_pair(dev)
        cuda_cheb.reset_launch_counts()
        res[str(dev)] = cfg.solve(m.operator, b, M=M)
        assert (cuda_cheb.LAUNCHES["chebdiff_last_kernel"] > 0) == (dev == cuda)
    host, card = res["cpu"], res[str(cuda)]
    print(json.dumps({"ksp_type": ksp_type, **extra, "host": [host.iters, host.reason],
                      "card": [card.iters, card.reason]}))
    assert card.reason == host.reason
    if host.reason != ConvergedReason.DIVERGED_NANORINF:
        assert card.iters == host.iters
        if host.reason > 0:
            assert _cpu_close(card.x, host.x)
    else:
        m, b, M = _poisson_pair("cpu")
        nudged = cfg.solve(m.operator, b, M=lambda r: M(r) * (1.0 + 2.0**-52))
        hh, ch, nh = (np.asarray(r.history_list()) for r in (host, card, nudged))
        np.testing.assert_allclose(ch[:40], hh[:40], rtol=1e-8)
        np.testing.assert_allclose(nh[:40], hh[:40], rtol=1e-8)
        assert nudged.reason == host.reason
        assert np.max(np.abs(nh[100:300] / hh[100:300] - 1.0)) > 1e-2
        hh, ch = hh[np.isfinite(hh)], ch[np.isfinite(ch)]
        assert hh[-1] > 1e150 and ch[-1] > 1e150, (hh[-1], ch[-1])


def test_minres_on_card_matches_host(cuda):
    """MINRES on the symmetric indefinite saddle system with the SPD block
    PC at 12^3: the card's count and reason equal to the host's, the
    solution to 1e-10 relative, x* recovered."""
    from chip_smoke import minres_system
    from spectral_tpu_torch.solvers.krylov import minres

    res = {}
    for dev in ("cpu", cuda):
        K, M, xs = minres_system(dev, ((12, 12, 9), (12, 12, 3)))
        res[str(dev)] = (minres(K, K(xs), M=M, rtol=1e-10, max_it=1000), xs)
    (host, xs), (card, _) = res["cpu"], res[str(cuda)]
    assert host.reason > 0 and (card.iters, card.reason) == (host.iters, host.reason)
    assert _cpu_close(card.x, host.x)
    assert _cpu_close(host.x, xs, 1e-6)


def test_solve_recycled_stokes_on_card(cuda):
    """KSPConfig.solve_recycled on README:43's Stokes Jacobian at 12^3 on
    the card (a dict state, the null space projected, W built by one
    batched apply of the projected operator): the harvest is float64 of
    (8, 6912); the first solve takes the JAX package's 9 FGMRES
    iterations, the second, deflated by it, no more than the JAX package's
    12-13 (its count from the zero state and from starts perturbed by 1e-13
    and 1e-11, stokes_oracle.py recycle12)."""
    from spectral_tpu_torch.models.stokes import StokesConfig, StokesProblem
    from spectral_tpu_torch.solvers.krylov import KSPConfig

    p = StokesProblem(Grid((12, 12, 12), device=cuda), StokesConfig(
        exact=2, cont0=1, vel_ksp=KSPConfig(type="gmres", rtol=1e-5, max_it=4),
        svel_ksp=KSPConfig(type="preonly"), schur_ksp=KSPConfig(type="gmres", rtol=1e-5,
                                                                max_it=3)))
    residual = p.make_residual(p.params_at(p.config.cont))
    z = p.zero_state()
    rng = np.random.default_rng(5)
    x1 = {"v": p.mask_v(torch.as_tensor(rng.standard_normal(tuple(z["v"].shape)), device=cuda)),
          "p": p.project_p(torch.as_tensor(rng.standard_normal(tuple(z["p"].shape)),
                                           device=cuda))}
    F0, ls = residual(z)
    F1, _ = residual(x1)
    pcs, pca = p.make_pc()
    st = pcs(z, ls)
    ksp = KSPConfig(type="fgmres", rtol=1e-8, max_it=200, restart=30)
    A = lambda w: p.jacobian_action(z, ls, w)  # noqa: E731
    M = lambda r: pca(st, r)  # noqa: E731
    r1, U = ksp.solve_recycled(A, F0, M=M, null_project=p.null_project, U=None, nkeep=8)
    r2, _ = ksp.solve_recycled(A, F1, M=M, null_project=p.null_project, U=U, nkeep=8)
    print(json.dumps({"iters": [r1.iters, r2.iters]}))
    assert U.dtype == torch.float64 and tuple(U.shape) == (8, 6912) and U.device.type == "cuda"
    assert r1.reason > 0 and r2.reason > 0
    assert r1.iters == 9 and r2.iters <= 13, (r1.iters, r2.iters)


def test_steady_accelerated_on_card_matches_host(cuda):
    """Anderson acceleration over chunks of 2 coupled steps at 8x8 (the
    CPU test's run) on the card and on the host: the same steps, T to
    1e-10 relative, K1 launched on the card."""
    from spectral_tpu_torch.models.convection import ConvectionConfig, ConvectionModel
    from spectral_tpu_torch.solvers.krylov import KSPConfig

    out = {}
    for dev in ("cpu", cuda):
        cfg = ConvectionConfig(Ra=1e4, dt=5e-4, velocity_bc="freeslip", side_bc="insulated",
                               stokes_pc="dense",
                               stokes_ksp=KSPConfig(type="fgmres", rtol=1e-12, max_it=100,
                                                    restart=50))
        m = ConvectionModel.unit_box((8, 8), cfg, device=dev)
        cuda_cheb.reset_launch_counts()
        out[str(dev)] = m.steady_accelerated(m.conductive_state(amp=0.05), m=3, chunk=2,
                                             tol=1e-3, max_iters=6, warmup=10)
        assert (cuda_cheb.LAUNCHES["chebdiff_last_kernel"] > 0) == (dev == cuda)
    (Th, _, ih), (Tc, _, ic) = out["cpu"], out[str(cuda)]
    assert ic["steps"] == ih["steps"] == 22
    assert _cpu_close(Tc, Th)


@pytest.mark.parametrize("shape", [(5, 5, 5), (64, 64, 48), (12, 12, 9)])
def test_k1_solver_shapes(cuda, shape):
    """K1 at the shapes phase 14 gives it beyond the earlier paths' (FAS's
    coarsest level, the MINRES system's velocity block), float64, against
    its plain version."""
    u = _randn(shape, torch.float64, cuda, 3)
    assert _rel(cuda_cheb.chebdiff_last(u), cuda_cheb.chebdiff_last_ref(u)) <= BOUND[torch.float64]


def test_curved_poisson_on_card_matches_host(cuda):
    """Curved Poisson (bump:0.08, 14^2 and 10^3): the card's metric
    Laplacian (K1 on its last-axis derivatives) equals the host's to 1e-12,
    and the solve takes the host's iterations to the host's error; a
    mapped 3-D PoissonModel(method="kernel") launches K1 and never K2."""
    from spectral_tpu_torch.models.curvilinear import CurvilinearPoisson
    from spectral_tpu_torch.ops.curvilinear import named_map
    from spectral_tpu_torch.ops.mapping import AxisMap

    def u_fn(x):
        return np.prod(np.cos(0.5 * np.pi * x), axis=-1)

    for dims in ((14, 14), (10, 10, 10)):
        d = len(dims)
        out = {}
        for dev in ("cpu", cuda):
            cp = CurvilinearPoisson(Grid(dims, device=dev), named_map("bump:0.08"))
            u, b = cp.manufactured(u_fn, lambda x: -d * (0.5 * np.pi) ** 2 * u_fn(x))
            x = _randn(dims, torch.float64, dev, 3)
            cuda_cheb.reset_launch_counts()
            lap = cp.map.laplacian(x)
            if dev != "cpu":
                assert cuda_cheb.LAUNCHES["chebdiff_last_kernel"] > 0
            r = cp.solve(b)
            out[str(dev)] = (lap.cpu(), r.iters, float(torch.max(torch.abs(r.x - u))))
        (lh, ih, eh), (lc, ic, ec) = out["cpu"], out[str(cuda)]
        assert _rel(lc, lh) <= 1e-12
        assert abs(ic - ih) <= 1 and abs(ec - eh) <= 1e-10, (ih, ic, eh, ec)
    maps = (AxisMap.tanh_cluster(0.0, 2.0, 12, 1.4), AxisMap.kte(0.0, 1.0, 12, 0.9),
            AxisMap.affine(0.0, 1.0, 12))
    cuda_cheb.reset_launch_counts()
    PoissonModel(Grid((12, 12, 12), maps=maps, device=cuda), method="kernel").operator(
        _randn((12, 12, 12), torch.float64, cuda, 4))
    assert cuda_cheb.LAUNCHES["chebdiff_last_kernel"] > 0
    assert cuda_cheb.LAUNCHES["laplacian3d_plane_kernel"] == 0
    assert cuda_cheb.LAUNCHES["laplacian3d_x_kernel"] == 0


def test_stokes_family_on_card_matches_host(cuda):
    """ROADMAP item 7a on the card: a 3-member power-law family at 8x8,
    its Newton counts equal the host's, every member within 1e-10 of the
    host's family, K1 launched once a batch under vmap ((3, 8, 8))."""
    from spectral_tpu_torch.models.rheology import PowerLawParams
    from spectral_tpu_torch.models.stokes import StokesConfig, StokesProblem

    fam = [PowerLawParams(1.0, e, 1e-2, 1.0) for e in (1.0, 2.0, 3.0)]
    res = {}
    for dev in ("cpu", cuda):
        p = StokesProblem(Grid((8, 8), device=dev, dtype=torch.float64),
                          StokesConfig(exact=2, rheology=1))
        cuda_cheb.reset_launch_counts()
        res[str(dev)] = p.solve_family(fam)
    host, card = res["cpu"], res["cuda"]
    assert card.iters.tolist() == host.iters.tolist() and (card.reason > 0).all()
    for k in ("v", "p"):
        assert float(torch.max(torch.abs(card.x[k].cpu() - host.x[k]))) <= 1e-10
    assert cuda_cheb.K1_LAUNCHES_BY_SHAPE.get(((3, 8, 8), torch.float64), 0) > 0


def _pencil_rank(rank, store, queue):
    import torch.distributed as dist

    from spectral_tpu_torch.parallel import (chebdiff_pencil, chebdiff_pencil_pipelined,
                                             gather_tensor, halo_shift, make_mesh,
                                             shard_tensor)
    from spectral_tpu_torch.ops.stencil import shift

    dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank, world_size=2)
    dev = torch.device("cuda")
    mesh = make_mesh({"x": 2})
    u = _randn((16, 12, 8), torch.float64, dev, 3)
    ul = shard_tensor(u, mesh, {0: "x"})
    out = {"path": mesh.comm_path}
    for ax in range(3):
        got = gather_tensor(chebdiff_pencil(ul, ax, mesh), mesh, {0: "x"})
        out[f"pencil {ax}"] = _rel(got, chebyshev.chebdiff(u, ax))
    got = gather_tensor(chebdiff_pencil_pipelined(ul, 0, mesh, chunks=2), mesh, {0: "x"})
    out["pipelined"] = _rel(got, chebyshev.chebdiff(u, 0))
    for s in (-1, 1):
        got = gather_tensor(halo_shift(ul, 0, s, mesh), mesh, {0: "x"})
        out[f"halo {s}"] = float(torch.max(torch.abs(got - shift(u, 0, s))))
    if rank == 0:
        queue.put(out)
    dist.barrier()
    dist.destroy_process_group()


def test_pencil_two_gloo_ranks_on_card(cuda, tmp_path):
    """ROADMAP item 7b on the card: two gloo processes sharing it, the
    pencil along each axis, its pipelined form (asynchronous exchanges)
    and the halo (staged through pinned host memory: gloo takes no CUDA
    send/recv) against the one-process results."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_pencil_rank, args=(r, str(tmp_path / "store"), queue))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        out = queue.get(timeout=300)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    assert out["path"] == "gloo; CUDA tensors staged through pinned host memory: sendrecv"
    assert max(out[f"pencil {ax}"] for ax in range(3)) <= 1e-12
    assert out["pipelined"] <= 1e-12
    assert out["halo -1"] == out["halo 1"] == 0.0


def _sharded_rank(rank, store, queue):
    """One of two gloo processes on the card: README:43 at 12^3 and the
    zero-flux fastdiag apply on slabs of {"x": 2}."""
    import torch.distributed as dist

    from spectral_tpu_torch.models.stokes import StokesConfig, StokesProblem
    from spectral_tpu_torch.ops.fastdiag import FastDiagSolver
    from spectral_tpu_torch.parallel import make_mesh
    from spectral_tpu_torch.parallel.slab import Slab
    from spectral_tpu_torch.solvers.krylov import KSPConfig

    dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank, world_size=2)
    dev = torch.device("cuda")
    mesh = make_mesh({"x": 2})
    slab = Slab.of(mesh)
    cfg = StokesConfig(exact=2, cont0=1, schur_ksp=KSPConfig(type="gmres", rtol=1e-5, max_it=3),
                       vel_ksp=KSPConfig(type="gmres", rtol=1e-5, max_it=4),
                       svel_ksp=KSPConfig(type="preonly"),
                       outer_ksp=KSPConfig(type="fgmres", rtol=1e-10, max_it=500, restart=50))
    g = Grid((12, 12, 12), device=dev)
    p1 = StokesProblem(g, cfg)
    one = p1.solve()
    z = p1.zero_state()   # round-off's own move: a start moved by 1e-14
    pert = p1.solve({"v": p1.mask_v(1e-14 * _randn(z["v"].shape, torch.float64, dev, 6)),
                     "p": p1.mask_p(1e-14 * _randn(z["p"].shape, torch.float64, dev, 7))})
    cuda_cheb.reset_launch_counts()
    sh = StokesProblem(g, cfg, mesh=mesh).solve()
    out = {"counts": [sh.iters, list(sh.ksp_iters)], "one": [one.iters, list(one.ksp_iters)],
           "perturbed": [pert.iters, list(pert.ksp_iters)],
           "k1": cuda_cheb.LAUNCHES["chebdiff_last_kernel"],
           "k2": cuda_cheb.LAUNCHES["laplacian3d_plane_kernel"],
           "dv": _rel(slab.gather(sh.x["v"]), one.x["v"]), "move": _rel(pert.x["v"], one.x["v"])}
    r = _randn((12, 12, 12), torch.float64, dev, 5)
    for nm in (0, 1):
        fd = FastDiagSolver.build(g, shift=1.0, neumann_axes=(nm,))
        out[f"neumann {nm}"] = _rel(slab.gather(fd.apply(slab.local(r), slab=slab)),
                                    fd.apply(r))
    if rank == 0:
        queue.put(out)
    dist.barrier()
    dist.destroy_process_group()


def test_sharded_stokes_and_neumann_fastdiag_on_card(cuda, tmp_path):
    """ROADMAP item 7c on the card: two gloo processes sharing it run
    README:43 at 12^3 on slabs of {"x": 2} at the one-process card solve's
    Newton count, its FGMRES count within the range that a start moved by
    1e-14 spans (max(3, 10%) beyond it, the repo's rule: round-off moves
    it, ROADMAP queue 3), v within 4x that start's move (or 1e-9), K1
    launched and K2 not; and the zero-flux fastdiag apply along the
    sharded and an unsharded axis against the one-process apply."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_sharded_rank, args=(r, str(tmp_path / "store"), queue))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        out = queue.get(timeout=600)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    (n, (k,)), (n1, (k1,)), (_, (kp,)) = out["counts"], out["one"], out["perturbed"]
    lo, hi = min(k1, kp), max(k1, kp)
    slack = max(3, -(-hi // 10))
    assert n == n1 and lo - slack <= k <= hi + slack, out
    assert out["dv"] <= max(1e-9, 4 * out["move"]) and out["k1"] > 0 and out["k2"] == 0, out
    assert out["neumann 0"] <= 1e-12 and out["neumann 1"] <= 1e-12, out


def test_utilities_on_card(cuda, tmp_path):
    """Checkpoints load onto the card in their saved dtype, check_finite
    and fail-fast read CUDA tensors, PhaseTimer waits for the card,
    trace_summary sees the card's kernels, and the production switch sends
    a last-axis derivative to K1 or to the matmul."""
    from spectral_tpu_torch.utils import checkpoint as ckpt
    from spectral_tpu_torch.utils import debug
    from spectral_tpu_torch.utils.profiling import PhaseTimer, trace_summary

    x = {"v": _randn((6, 5, 2), torch.float64, cuda, 0), "p": _randn((6, 5), torch.float32, cuda, 1)}
    ckpt.save_state(str(tmp_path), 3, x)
    y = ckpt.load_state(str(tmp_path), 3, {"v": torch.zeros(1, device=cuda),
                                           "p": torch.zeros(1, dtype=torch.float64)})
    assert y["v"].is_cuda and y["v"].dtype == torch.float64 and torch.equal(y["v"], x["v"])
    assert y["p"].device.type == "cpu" and y["p"].dtype == torch.float32
    debug.check_finite(x)
    with pytest.raises(FloatingPointError, match=r"\['p'\]"):
        debug.check_finite({"v": x["v"], "p": x["p"] / 0.0})
    try:
        debug.enable_fail_fast()
        with pytest.raises(FloatingPointError, match="sqrt"):
            torch.sqrt(-x["v"].abs() - 1.0)
    finally:
        debug.enable_fail_fast(False)
    t = PhaseTimer(cuda)
    with t.phase("matmul"):
        a = _randn((2048, 2048), torch.float64, cuda, 2)
        for _ in range(4):
            a = a @ a / 2048.0
    assert t.counts["matmul"] == 1 and t.totals["matmul"] > 0
    s = trace_summary(lambda: a @ a)
    assert s["device_event_count"] >= 1 and 0 < s["device_busy_ms"] <= s["wall_ms"]
    assert any(k.startswith("/device:cuda") for k in s["planes"])
    u = _randn((4, 20, 20), torch.float64, cuda, 3)
    try:
        for mode, launches in (("kernel", 1), ("matmul", 0)):
            chebyshev.set_production_path(mode)
            cuda_cheb.reset_launch_counts()
            got = chebyshev.chebdiff(u, -1)
            assert cuda_cheb.LAUNCHES["chebdiff_last_kernel"] == launches
            assert _rel(got, cuda_cheb.chebdiff_last_ref(u)) <= BOUND[torch.float64]
    finally:
        chebyshev.set_production_path("kernel")
