"""Hand-written CUDA kernels for the Chebyshev transform hot path, with
their plain PyTorch versions and launch counters.

Counterpart of ``spectral_tpu/ops/pallas_cheb.py``.  The kernels live in
``spectral_tpu_torch/csrc/cheb_kernels.cu`` (CUDA C++ for sm_90a, built by
``ops._build`` at first use); the source note there gives, for each, the
TPU kernel it replaces, what bounds it on the H100 and what its design
does about that.

- K1 ``chebdiff_last``   replaces ``pallas_cheb.py::chebdiff_last_pallas``:
  y = u @ (s D)^T along the last axis of any-rank u.
- K2 ``laplacian3d``     replaces ``pallas_cheb.py::laplacian3d_pallas``:
  y = -(s_x D2_x u + s_y D2_y u + s_z D2_z u) on a 3-D field, with the
  boundary-identity select folded into the epilogue.

Each wrapper takes its plain version (``*_ref``, the same function in
``torch.matmul`` / ``tensordot``) only for a tensor on the CPU.  For a CUDA
tensor it launches the kernel or raises: there is no fallback.  Each
launch adds one to ``LAUNCHES[<kernel name>]``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from spectral_tpu_torch.ops.chebyshev import diffmat_np

# Largest last-axis extent K1 takes: D^T lives in shared memory
# (128 x 128 in float64 is 128 KB of the 227 KB a block may use).
K1_MAX_N = 128
# Shared memory a block may use on sm_90 (bytes); K2 checks its need against it.
SMEM_LIMIT = 232448

# Kernel launches since the last reset, by kernel name.
LAUNCHES = {"chebdiff_last_kernel": 0, "laplacian3d_kernel": 0}

_KERNEL_DTYPES = {torch.float32: "f32", torch.float64: "f64"}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Constant matrices: built in float64 on the host, scale folded in BEFORE
# the cast to the working dtype (as pallas_cheb.py does), cached per
# (shape, scale, dtype, device).  Read-only, shared by all callers.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _diffmat_t(n: int, scale: float | None, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    DTnp = diffmat_np(n).T
    if scale is not None:
        DTnp = DTnp * scale
    return torch.as_tensor(np.ascontiguousarray(DTnp), dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def _d2_t(dims: tuple[int, int, int], scales: tuple[float, float, float],
          dtype: torch.dtype, device: torch.device) -> tuple[torch.Tensor, ...]:
    out = []
    for n, s in zip(dims, scales):
        D = diffmat_np(n)
        out.append(torch.as_tensor(np.ascontiguousarray(s * (D @ D).T),
                                   dtype=dtype, device=device))
    return tuple(out)


def _scales3(scales) -> tuple[float, float, float]:
    if scales is None:
        return (1.0, 1.0, 1.0)
    return tuple(float(s) for s in scales)


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the oracle for the kernels on the card)
# ---------------------------------------------------------------------------

def chebdiff_last_ref(u: torch.Tensor, scale: float | None = None) -> torch.Tensor:
    """y = u @ (scale * D)^T along the last axis, in u's dtype."""
    return torch.matmul(u, _diffmat_t(u.shape[-1], scale, u.dtype, u.device))


def laplacian3d_ref(u: torch.Tensor, bmask: torch.Tensor | None = None,
                    scales=None) -> torch.Tensor:
    """y = -(s_x D2_x u + s_y D2_y u + s_z D2_z u); y = where(bmask, u, y)."""
    d2xt, d2yt, d2zt = _d2_t(tuple(u.shape), _scales3(scales), u.dtype, u.device)
    t = torch.matmul(u, d2zt)                                           # z
    t = t + torch.tensordot(u, d2yt, dims=([1], [0])).transpose(1, 2)  # y
    t = t + torch.tensordot(d2xt, u, dims=([0], [0]))                  # x
    y = -t
    if bmask is not None:
        y = torch.where(bmask, u, y)
    return y


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _check_cuda(name: str, *tensors: torch.Tensor) -> str:
    """Device, dtype and layout checks; returns the dtype suffix."""
    u = tensors[0]
    if u.device.type != "cuda":
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got {u.device}")
    if u.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{name}: the kernel takes float32 or float64, got {u.dtype}")
    for t in tensors:
        if t.device != u.device:
            raise ValueError(f"{name}: tensors on {t.device} and {u.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
    return _KERNEL_DTYPES[u.dtype]


def _launch(name: str, fn, device: torch.device, *args) -> None:
    from spectral_tpu_torch.ops._build import check, load_library

    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, fn)(*args, stream)
    check(lib, fn, code)
    LAUNCHES[name] += 1


def chebdiff_last(u: torch.Tensor, scale: float | None = None) -> torch.Tensor:
    """Derivative along the last axis through K1 (plain version on the CPU).

    ``scale`` is folded into the resident matrix, so a scaled derivative
    costs no extra pass over u."""
    if u.device.type == "cpu":
        return chebdiff_last_ref(u, scale)
    suffix = _check_cuda("chebdiff_last", u)
    if u.ndim < 1:
        raise ValueError("chebdiff_last: need at least one axis")
    n = u.shape[-1]
    if not 2 <= n <= K1_MAX_N:
        raise ValueError(f"chebdiff_last: the kernel takes 2 <= n <= {K1_MAX_N}, got {n}")
    DT = _diffmat_t(n, None if scale is None else float(scale), u.dtype, u.device)
    y = torch.empty_like(u)
    M = u.numel() // n
    if M == 0:
        return y
    _launch("chebdiff_last_kernel", f"chebdiff_last_{suffix}", u.device,
            u.data_ptr(), DT.data_ptr(), y.data_ptr(), M, n)
    return y


def laplacian3d_smem_bytes(dims: tuple[int, int, int], itemsize: int) -> int:
    """Shared memory K2 needs for a field of ``dims`` (mirrors the C side)."""
    nx, ny, nz = dims
    tj = max(1, min(ny, 1024 // nz))
    return itemsize * (ny * nz + nz * nz + ny * tj + nx)


def laplacian3d(u: torch.Tensor, bmask: torch.Tensor | None = None,
                scales=None) -> torch.Tensor:
    """The 3-D spectral Laplacian through K2 (plain version on the CPU).

    With ``bmask`` (bool, u's shape) boundary rows are the identity,
    y_b = u_b, applied in the kernel's epilogue."""
    if u.device.type == "cpu":
        return laplacian3d_ref(u, bmask, scales)
    tensors = (u,) if bmask is None else (u, bmask)
    suffix = _check_cuda("laplacian3d", *tensors)
    if u.ndim != 3:
        raise ValueError(f"laplacian3d: need a 3-D field, got shape {tuple(u.shape)}")
    if bmask is not None and (bmask.dtype != torch.bool or bmask.shape != u.shape):
        raise ValueError("laplacian3d: bmask must be a bool tensor of u's shape")
    dims = tuple(u.shape)
    need = laplacian3d_smem_bytes(dims, u.element_size())
    if need > SMEM_LIMIT:
        raise ValueError(f"laplacian3d: {dims} in {u.dtype} needs {need} bytes "
                         f"of shared memory, the kernel has {SMEM_LIMIT}")
    d2xt, d2yt, d2zt = _d2_t(dims, _scales3(scales), u.dtype, u.device)
    y = torch.empty_like(u)
    _launch("laplacian3d_kernel", f"laplacian3d_{suffix}", u.device,
            u.data_ptr(), d2xt.data_ptr(), d2yt.data_ptr(), d2zt.data_ptr(),
            None if bmask is None else bmask.data_ptr(), y.data_ptr(), *dims)
    return y
