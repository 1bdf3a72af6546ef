"""Plain versions of the port's kernels (spectral_tpu_torch.ops.cuda_cheb)
against the JAX package's Pallas kernels in interpret mode, run as
tests/test_pallas.py runs them (K3's TPU kernel, in benchmarks/exp_pallas.py,
has no interpret switch: its plain version is held to the formula that
script builds); and the wrappers' CPU-only routing and refusals."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectral_tpu.grid import Grid as JGrid
from spectral_tpu.ops.chebyshev import diffmat_np
from spectral_tpu.ops.pallas_cheb import chebdiff_last_pallas, laplacian3d_pallas
from spectral_tpu_torch.grid import Grid
from spectral_tpu_torch.ops import _build, cuda_cheb


@pytest.mark.parametrize("shape,block,scale", [
    ((3, 10, 16), 16, None),
    ((7, 12), 4, None),      # ragged: 7 rows in blocks of 4
    ((5, 12), 8, 0.25),      # scale folded into D^T
])
def test_chebdiff_last_ref_matches_pallas(shape, block, scale):
    u = np.random.default_rng(0).standard_normal(shape)
    ref = chebdiff_last_pallas(jnp.asarray(u), block_rows=block, interpret=True,
                               scale=scale)
    got = cuda_cheb.chebdiff_last_ref(torch.from_numpy(u), scale)
    # atol 1e-10, the tolerance tests/test_pallas.py holds the kernel to:
    # both multiply by the same float64 (s D)^T, in another summation order
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-10, rtol=0)


def test_laplacian3d_ref_matches_pallas():
    u = np.random.default_rng(2).standard_normal((12, 10, 8))
    ref = np.asarray(laplacian3d_pallas(jnp.asarray(u), interpret=True))
    got = cuda_cheb.laplacian3d_ref(torch.from_numpy(u)).numpy()
    # scale-normalised atol 1e-11 (test_pallas.py): D2 entries reach ~n^4/15
    scale = np.max(np.abs(ref))
    np.testing.assert_allclose(got / scale, ref / scale, atol=1e-11, rtol=0)


def test_laplacian3d_ref_boundary_mask_and_scales_match_pallas():
    jg = JGrid((8, 8, 8))
    g = Grid((8, 8, 8), device="cpu")
    u = np.random.default_rng(3).standard_normal(g.dims)
    scales = (0.25, 1.0, 4.0)
    ref = np.asarray(laplacian3d_pallas(jnp.asarray(u), bmask=jg.boundary_mask,
                                        interpret=True, scales=scales))
    got = cuda_cheb.laplacian3d_ref(torch.from_numpy(u), g.boundary_mask,
                                    scales).numpy()
    # boundary rows are u itself: bitwise
    np.testing.assert_array_equal(got[g.boundary_mask_np], u[g.boundary_mask_np])
    scale = np.max(np.abs(ref))
    np.testing.assert_allclose(got / scale, ref / scale, atol=1e-11, rtol=0)


def test_cpu_wrappers_take_the_plain_path_and_count_nothing():
    cuda_cheb.reset_launch_counts()
    rng = np.random.default_rng(4)
    u2 = torch.from_numpy(rng.standard_normal((6, 9)))
    u3 = torch.from_numpy(rng.standard_normal((8, 7, 6)))
    mask = Grid((8, 7, 6), device="cpu").boundary_mask
    np.testing.assert_array_equal(cuda_cheb.chebdiff_last(u2, 0.5).numpy(),
                                  cuda_cheb.chebdiff_last_ref(u2, 0.5).numpy())
    np.testing.assert_array_equal(cuda_cheb.laplacian3d(u3, mask).numpy(),
                                  cuda_cheb.laplacian3d_ref(u3, mask).numpy())
    np.testing.assert_array_equal(cuda_cheb.chebdiff_packed(u2, 1).numpy(),
                                  cuda_cheb.chebdiff_packed_ref(u2, 1).numpy())
    assert cuda_cheb.LAUNCHES == {"chebdiff_last_kernel": 0, "laplacian3d_plane_kernel": 0,
                                  "laplacian3d_x_kernel": 0, "chebdiff_packed_kernel": 0}
    assert cuda_cheb.K1_LAUNCHES_BY_SHAPE == {}
    assert cuda_cheb.K1T_LAUNCHES_BY_SHAPE == {}


def test_non_cpu_tensors_never_take_the_plain_path():
    """A tensor that is not on the CPU goes to the kernel or raises; here a
    meta tensor (neither CPU nor CUDA) must raise, not compute."""
    u = torch.empty((4, 8), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        cuda_cheb.chebdiff_last(u)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        cuda_cheb.laplacian3d(torch.empty((4, 4, 4), device="meta"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        cuda_cheb.chebdiff_packed(torch.empty((4, 128), device="meta"), 2)


def test_kernel_limits():
    # K2's shared-memory need at the production grid, and its limit
    assert cuda_cheb.laplacian3d_smem_bytes((64, 64, 64), 8) <= cuda_cheb.SMEM_LIMIT
    assert cuda_cheb.laplacian3d_smem_bytes((128, 128, 128), 8) > cuda_cheb.SMEM_LIMIT
    assert cuda_cheb.K1_MAX_N == 128


@pytest.mark.parametrize("dims,itemsize,values,tiled", [
    # tiled: D2z^T (nzp^2) + the plane (nyp rows of nzp + 4) + 4 rows of D2y (nyp + 4)
    ((8, 8, 8), 4, 64 + 8 * 12 + 4 * 12, True),
    ((64, 64, 64), 4, 4096 + 64 * 68 + 4 * 68, True),
    ((64, 64, 64), 8, 4096 + 64 * 68 + 4 * 68, True),
    ((20, 12, 10), 8, 144 + 12 * 16 + 4 * 16, True),       # ny, nz padded to 12
    # unpadded: D2z^T (nz^2) + the plane (ny nz) + 1 row of D2y (ny)
    ((4, 118, 118), 8, 2 * 118 * 118 + 118, False),
    ((128, 128, 128), 8, 2 * 128 * 128 + 128, False),    # refused
])
def test_laplacian3d_smem_rule(dims, itemsize, values, tiled):
    """K2's shared-memory need, the C side's k2_plane_values at 4 rows a
    block, or k2_plane_values_unpadded at one row where the tiled layout
    does not fit; 128^3 in float64 exceeds the limit and is refused."""
    need = cuda_cheb.laplacian3d_smem_bytes(dims, itemsize)
    assert need == itemsize * values
    assert cuda_cheb.laplacian3d_plane_tiled(dims, itemsize) == tiled
    assert (need <= cuda_cheb.SMEM_LIMIT) == (dims != (128, 128, 128))


def test_laplacian3d_takes_every_field_the_single_pass_took():
    """The single-pass K2 took a field when itemsize (ny nz + nz^2 + ny tj
    + nx) <= SMEM_LIMIT, tj = max(1, min(ny, 1024 // nz)).  That need grows
    with nx and the two-pass rule does not depend on nx, so nx = 1 covers
    every (ny, nz) it took: each is taken now."""
    for itemsize in (4, 8):
        cap = cuda_cheb.SMEM_LIMIT // itemsize

        def single_pass(ny, nz):
            return ny * nz + nz * nz + ny * max(1, min(ny, 1024 // nz)) + 1

        nz = 1
        while single_pass(1, nz) <= cap:
            ny = 1
            while single_pass(ny, nz) <= cap:
                need = cuda_cheb.laplacian3d_smem_bytes((1, ny, nz), itemsize)
                assert need <= cuda_cheb.SMEM_LIMIT, (itemsize, ny, nz, need)
                ny += 1
            nz += 1


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """A missing compiler is an error, never a silent fall back."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "_DEFAULT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_library_name_follows_the_sources(monkeypatch, tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// one")
    monkeypatch.setattr(_build, "SOURCES", (src,))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    first = _build.library_path()
    assert first.parent == tmp_path / "build"
    src.write_text("// two")
    assert _build.library_path() != first


@pytest.mark.parametrize("pack", [1, 2])
def test_chebdiff_packed_ref_matches_exp_pallas_formula(pack):
    """K3's plain version against the dense operator of exp_pallas.py:33,
    kron(I_pack, D^T / n^2) on the (M, n * pack) view, and against the
    unpacked product of exp_pallas.py:78 on the (M * pack, n) view."""
    n, M = 16, 9
    u = np.random.default_rng(5).standard_normal((M, n * pack))
    DT = diffmat_np(n).T / (n * n)
    got = cuda_cheb.chebdiff_packed_ref(torch.from_numpy(u), pack, 1.0 / (n * n)).numpy()
    # float64 products of the same entries, summed in other orders
    np.testing.assert_allclose(got, u @ np.kron(np.eye(pack), DT), atol=1e-13, rtol=0)
    np.testing.assert_allclose(got, (u.reshape(-1, n) @ DT).reshape(M, n * pack),
                               atol=1e-13, rtol=0)


def test_chebdiff_packed_refusals():
    """Checked alike on every device, so the CPU sees them too."""
    u = torch.zeros((8, 128), dtype=torch.float64)
    with pytest.raises(ValueError, match="2-D"):
        cuda_cheb.chebdiff_packed(u.reshape(2, 4, 128), 1)
    with pytest.raises(ValueError, match="multiple of pack"):
        cuda_cheb.chebdiff_packed(u[:, :30], 4)
    with pytest.raises(ValueError, match="n \\* pack <= 128"):
        cuda_cheb.chebdiff_packed(torch.zeros((8, 192)), 2)
    with pytest.raises(ValueError, match="block_rows"):
        cuda_cheb.chebdiff_packed(u, 2, block_rows=512)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_cheb.chebdiff_packed(u, 1, block_rows=128)    # 128 x 128 in float64
    assert cuda_cheb.chebdiff_packed(u, 2, block_rows=128).shape == u.shape
    assert cuda_cheb.K3_BLOCK_ROWS == (32, 64, 128)
    assert cuda_cheb.LAUNCHES["chebdiff_packed_kernel"] == 0


@pytest.mark.parametrize("itemsize,n,pack,block_rows,stages", [
    # the sweep shapes: n = 64 float32, 32-256 pencils a stage
    (4, 64, 1, 32, 24), (4, 64, 1, 64, 12), (4, 64, 1, 128, 6),
    (4, 64, 2, 32, 12), (4, 64, 2, 64, 6), (4, 64, 2, 128, 3),
    # the float64 limits: one stage fits, or none
    (8, 64, 2, 128, 1), (8, 128, 1, 64, 1), (8, 128, 1, 128, 0),
])
def test_chebdiff_packed_stage_rule(itemsize, n, pack, block_rows, stages):
    """K3's ring depth and shared memory against the C side's layout (k3_shape):
    two 8-byte mbarriers a stage, the padded D^T, then the stages of
    block_rows * pack rows of npad + 4."""
    assert cuda_cheb.chebdiff_packed_stages(n, pack, block_rows, itemsize,
                                            max_stages=1 << 20) == stages
    assert cuda_cheb.chebdiff_packed_stages(n, pack, block_rows, itemsize) == min(
        stages, cuda_cheb.K3_MAX_STAGES)
    npad = (n + 3) // 4 * 4
    for cap in {1, 2, max(stages, 1)}:
        used = max(1, min(cap, stages))
        smem = cuda_cheb.chebdiff_packed_smem_bytes(n, pack, block_rows, itemsize, cap)
        assert smem == 16 * used + itemsize * (npad * npad + used * block_rows * pack * (npad + 4))
        assert (smem <= cuda_cheb.SMEM_LIMIT) == (stages >= 1)


def test_chebdiff_packed_accepts_the_shapes_it_did():
    """A ring of one stage needs 16 bytes more than the single tile K3 had;
    no shape crosses the limit for it: the shapes taken and refused stay."""
    for itemsize in (4, 8):
        for n in range(2, cuda_cheb.K1_MAX_N + 1):
            npad = (n + 3) // 4 * 4
            for pack in range(1, cuda_cheb.K1_MAX_N // n + 1):
                for rows in cuda_cheb.K3_BLOCK_ROWS:
                    single_tile = itemsize * (npad * npad + rows * pack * (npad + 4))
                    took = cuda_cheb.chebdiff_packed_stages(n, pack, rows, itemsize) >= 1
                    assert took == (single_tile <= cuda_cheb.SMEM_LIMIT), (itemsize, n, pack, rows)


def test_chebdiff_packed_branch_rule():
    """Bulk copies take n % 4 == 0 (no k padding) from a 16-byte aligned u2d."""
    u32, u64 = torch.zeros((6, 128)), torch.zeros((6, 36), dtype=torch.float64)
    assert u32.data_ptr() % 16 == 0 and u64.data_ptr() % 16 == 0
    assert cuda_cheb.chebdiff_packed_bulk(u32, 2)                        # n = 64
    assert cuda_cheb.chebdiff_packed_bulk(u64, 3)                        # n = 12
    assert not cuda_cheb.chebdiff_packed_bulk(u32[:, :30].contiguous(), 3)  # n = 10
    assert not cuda_cheb.chebdiff_packed_bulk(u64[:, :30].contiguous(), 3)  # n = 10
    assert not cuda_cheb.chebdiff_packed_bulk(u32.view(-1)[1:-127].view(5, 128), 2)


# -- K1's reverse mode: the autograd pair (_K1 / _K1T) on its plain version --

def _k1_pair_inputs():
    rng = np.random.default_rng(11)
    return [torch.from_numpy(rng.standard_normal((6, 7, 8))) for _ in range(3)]


def _through_pair(x):
    """A nonlinear function of x whose derivatives all pass K1 and K1^T."""
    y = cuda_cheb.chebdiff_last(x)
    return y * y * cuda_cheb.chebdiff_last(torch.sin(x), 0.5)


def _through_matmul(x):
    y = cuda_cheb.chebdiff_last_ref(x)
    return y * y * cuda_cheb.chebdiff_last_ref(torch.sin(x), 0.5)


def test_k1_pair_matches_the_matmul_path():
    """On the CPU the pair runs its plain version, so every derivative of
    it equals autograd's through torch.matmul: torch.func.vjp,
    .backward() of a requires_grad tensor, jvp-of-vjp, vmap-of-vjp and
    torch.func.hessian at (6, 7, 8), each to 1e-14 of the largest entry."""
    u, ct, tan = _k1_pair_inputs()

    def close(a, b):
        assert float(torch.max(torch.abs(a - b))) <= 1e-14 * float(torch.max(torch.abs(b)))

    for f_pair, f_ref in ((_through_pair, _through_matmul),
                          (lambda x: cuda_cheb.chebdiff_last_t(x, 2.0),
                           lambda x: cuda_cheb.chebdiff_last_t_ref(x, 2.0))):
        got, want = (torch.func.vjp(f, u)[1](ct)[0] for f in (f_pair, f_ref))
        close(got, want)
        x = u.clone().requires_grad_()
        (f_pair(x) * ct).sum().backward()
        close(x.grad, want)

        def jvp_of_vjp(f):
            return torch.func.jvp(lambda z: torch.func.vjp(f, z)[1](ct)[0], (u,), (tan,))[1]

        close(jvp_of_vjp(f_pair), jvp_of_vjp(f_ref))
        vv = [torch.func.vmap(lambda z, f=f: torch.func.vjp(f, z)[1](z)[0])(u)
              for f in (f_pair, f_ref)]
        close(*vv)
    h = [torch.func.hessian(lambda z, f=f: f(z).sum())(u) for f in (_through_pair, _through_matmul)]
    close(*h)
    # the transpose: <K1 u, g> == <u, K1^T g>
    lhs = torch.sum(cuda_cheb.chebdiff_last(u, 0.5) * ct)
    rhs = torch.sum(u * cuda_cheb.chebdiff_last_t(ct, 0.5))
    assert abs(float(lhs - rhs)) <= 1e-12 * abs(float(lhs))


def test_k1_routes_a_graph_to_the_pair_and_k2_refuses_one():
    """A tensor that needs a graph, or one wrapped by torch.func, goes to
    the pair (so its gradient is never dropped); the rest to the raw
    launch.  K2 has no reverse mode and refuses both."""
    u = _k1_pair_inputs()[0]
    x = u.clone().requires_grad_()
    assert cuda_cheb.chebdiff_last(x).grad_fn is not None
    assert cuda_cheb._needs_graph(x) and not cuda_cheb._needs_graph(u)
    with torch.no_grad():
        assert not cuda_cheb._needs_graph(x)
        assert cuda_cheb.chebdiff_last(x).grad_fn is None
    u3 = torch.from_numpy(np.random.default_rng(5).standard_normal((6, 6, 6)))
    with pytest.raises(RuntimeError, match="reverse mode"):
        cuda_cheb.laplacian3d(u3.clone().requires_grad_())
    with pytest.raises(RuntimeError, match="reverse mode"):
        torch.func.vmap(cuda_cheb.laplacian3d)(u3[None])
    with torch.no_grad():
        cuda_cheb.laplacian3d(u3.clone().requires_grad_())
