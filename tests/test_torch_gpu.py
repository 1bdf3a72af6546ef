"""The port's CUDA kernels on the card: each against its plain version, the
launch counters, and the production switch.  Marked ``cuda``; every test
skips without CUDA (decided in the fixture, not at import).  On the card:

    python -m pytest tests/test_torch_gpu.py -m cuda -q -p no:randomly --noconftest
"""

import numpy as np
import pytest
import torch

from spectral_tpu_torch.grid import Grid
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
                                         ((1000, 64), None)])
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
    assert cuda_cheb.LAUNCHES["laplacian3d_kernel"] == 1


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
    assert cuda_cheb.LAUNCHES == {"chebdiff_last_kernel": 0,
                                         "laplacian3d_kernel": 0}


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
