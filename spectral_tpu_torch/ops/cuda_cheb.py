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
- K3 ``chebdiff_packed`` replaces ``benchmarks/exp_pallas.py::make_pallas``:
  y = u2d @ kron(I_pack, (s D)^T) on a lane-packed (M, n * pack) view,
  without multiplying the Kronecker product's zero blocks.

Each wrapper takes its plain version (``*_ref``, the same function in
``torch.matmul`` / ``tensordot``) only for a tensor on the CPU.  For a CUDA
tensor it launches the kernel or raises: there is no fallback.  Each
launch adds one to ``LAUNCHES[<kernel name>]`` (K2's call launches two
kernels, its plane pass and its x pass, and adds one to each), and each
K1 launch to ``K1_LAUNCHES_BY_SHAPE[(u.shape, u.dtype)]``.

K1 is linear, u -> u (s D)^T, so its reverse mode is the same kernel with
the row-major s D as its right factor: g -> g (s D), "K1^T", counted under
K1's name and, by shape, in ``K1T_LAUNCHES_BY_SHAPE``.  A tensor that needs
a graph (``requires_grad`` under grad mode) or is wrapped by ``torch.func``
(vmap, jvp, grad, vjp) goes through the autograd pair ``_K1`` / ``_K1T``:
each one's backward applies the other, its forward-mode rule applies
itself to the tangent, and its vmap rule launches it once on the whole
batch, so every derivative of any order stays on the kernel.  Only a
tensor that needs no graph reaches the raw launch.  K2 has no reverse
mode and refuses a tensor that needs one.  A launch goes on the caller's
current stream, so it can be captured in a CUDA graph; a captured call
counts once, when it is captured, and its replays do not.
"""

from __future__ import annotations

import ctypes
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
LAUNCHES = {"chebdiff_last_kernel": 0, "laplacian3d_plane_kernel": 0,
            "laplacian3d_x_kernel": 0, "chebdiff_packed_kernel": 0}
# K1 launches since the last reset, by (u.shape, u.dtype): the forward
# product u (s D)^T, and the transposed one g (s D) of the reverse mode.
K1_LAUNCHES_BY_SHAPE: dict[tuple[torch.Size, torch.dtype], int] = {}
K1T_LAUNCHES_BY_SHAPE: dict[tuple[torch.Size, torch.dtype], int] = {}
# Row-tile heights K3 is built for (template instances of the kernel).
K3_BLOCK_ROWS = (32, 64, 128)
# Most tile stages in K3's ring (fewer where fewer fit); chip_smoke.py
# phase 5 times the alternatives.
K3_MAX_STAGES = 24

_KERNEL_DTYPES = {torch.float32: "f32", torch.float64: "f64"}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    K1_LAUNCHES_BY_SHAPE.clear()
    K1T_LAUNCHES_BY_SHAPE.clear()


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
def _diffmat(n: int, scale: float | None, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    """s D row-major: K1^T's right factor (g (s D) is the transpose of
    u (s D)^T)."""
    Dnp = diffmat_np(n)
    if scale is not None:
        Dnp = Dnp * scale
    return torch.as_tensor(np.ascontiguousarray(Dnp), dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def _d2_ops(dims: tuple[int, int, int], scales: tuple[float, float, float],
            dtype: torch.dtype, device: torch.device) -> tuple[torch.Tensor, ...]:
    """D2x and D2y row-major (K2 stages blocks of their rows in 16-byte
    copies) and D2z^T, each s (D @ D) for its axis."""
    D2 = [s * (diffmat_np(n) @ diffmat_np(n)) for n, s in zip(dims, scales)]
    return tuple(torch.as_tensor(np.ascontiguousarray(m), dtype=dtype, device=device)
                 for m in (D2[0], D2[1], D2[2].T))


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


def chebdiff_last_t_ref(g: torch.Tensor, scale: float | None = None) -> torch.Tensor:
    """y = g @ (scale * D) along the last axis, in g's dtype: the transpose
    of chebdiff_last_ref, its reverse mode."""
    return torch.matmul(g, _diffmat(g.shape[-1], scale, g.dtype, g.device))


def laplacian3d_ref(u: torch.Tensor, bmask: torch.Tensor | None = None,
                    scales=None) -> torch.Tensor:
    """y = -(s_x D2_x u + s_y D2_y u + s_z D2_z u); y = where(bmask, u, y)."""
    d2x, d2y, d2zt = _d2_ops(tuple(u.shape), _scales3(scales), u.dtype, u.device)
    t = torch.matmul(u, d2zt)                                           # z
    t = t + torch.tensordot(u, d2y, dims=([1], [1])).transpose(1, 2)   # y
    t = t + torch.tensordot(d2x, u, dims=([1], [0]))                   # x
    y = -t
    if bmask is not None:
        y = torch.where(bmask, u, y)
    return y


def chebdiff_packed_ref(u2d: torch.Tensor, pack: int,
                        scale: float | None = None) -> torch.Tensor:
    """y = u2d @ kron(I_pack, (scale * D)^T): the literal dense function of
    the lane-packed TPU experiment, zero blocks included."""
    n = u2d.shape[-1] // pack
    eye = torch.eye(pack, dtype=u2d.dtype, device=u2d.device)
    return u2d @ torch.kron(eye, _diffmat_t(n, scale, u2d.dtype, u2d.device))


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _check_cuda(name: str, *tensors: torch.Tensor) -> str:
    """Device, dtype and layout checks; returns the dtype suffix."""
    u = tensors[0]
    dev = u.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got {dev}")
    suffix = _KERNEL_DTYPES.get(u.dtype)
    if suffix is None:
        raise TypeError(f"{name}: the kernel takes float32 or float64, got {u.dtype}")
    for t in tensors:
        if t is not u and t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
    return suffix


# C entry points by name, resolved once from the library (ops._build).
_ENTRY: dict[str, ctypes._CFuncPtr] = {}


def _entry(fn: str) -> ctypes._CFuncPtr:
    from spectral_tpu_torch.ops._build import load_library

    f = _ENTRY[fn] = getattr(load_library(), fn)
    return f


def _call(fn: str, device: torch.device, *args, stream: bool = True) -> None:
    """Call the C entry point ``fn`` with ``device`` current (switched to
    only where it is not) and, with ``stream``, its current raw stream
    last; raise on a CUDA error."""
    f = _ENTRY.get(fn) or _entry(fn)
    idx = device.index
    if stream:   # the raw handle, without building a torch.cuda.Stream
        args += (torch._C._cuda_getCurrentRawStream(idx),)
    if torch.cuda.current_device() == idx:
        code = f(*args)
    else:
        with torch.cuda.device(idx):
            code = f(*args)
    if code:
        from spectral_tpu_torch.ops._build import check, load_library

        check(load_library(), fn, code)


def _launch(name: str, fn: str, device: torch.device, *args) -> None:
    _call(fn, device, *args)
    LAUNCHES[name] += 1


def _needs_graph(u: torch.Tensor) -> bool:
    """Whether u needs autograd's graph or is wrapped by torch.func (a
    batched, dual or grad-tracking tensor has no data_ptr)."""
    return (torch.is_grad_enabled() and u.requires_grad) or \
        torch._C._functorch.is_functorch_wrapped_tensor(u)


def _k1(u: torch.Tensor, scale: float | None, transpose: bool) -> torch.Tensor:
    """One K1 launch on a tensor that needs no graph: y = u (s D)^T, or
    with ``transpose`` y = u (s D) (K1^T); the plain version on the CPU."""
    dev = u.device
    if dev.type == "cpu":
        return (chebdiff_last_t_ref if transpose else chebdiff_last_ref)(u, scale)
    suffix = _check_cuda("chebdiff_last", u)
    if u.ndim < 1:
        raise ValueError("chebdiff_last: need at least one axis")
    n = u.shape[-1]
    if not 2 <= n <= K1_MAX_N:
        raise ValueError(f"chebdiff_last: the kernel takes 2 <= n <= {K1_MAX_N}, got {n}")
    factor = _diffmat if transpose else _diffmat_t
    F = factor(n, None if scale is None else float(scale), u.dtype, dev)
    y = torch.empty_like(u)
    M = u.numel() // n
    if M == 0:
        return y
    _launch("chebdiff_last_kernel", "chebdiff_last_" + suffix, dev,
            u.data_ptr(), F.data_ptr(), y.data_ptr(), M, n)
    counts = K1T_LAUNCHES_BY_SHAPE if transpose else K1_LAUNCHES_BY_SHAPE
    key = (u.shape, u.dtype)
    counts[key] = counts.get(key, 0) + 1
    return y


def chebdiff_last(u: torch.Tensor, scale: float | None = None) -> torch.Tensor:
    """Derivative along the last axis through K1 (plain version on the CPU).

    ``scale`` is folded into the resident matrix, so a scaled derivative
    costs no extra pass over u.  A tensor that needs a graph or is wrapped
    by torch.func goes through the autograd pair (its reverse mode K1^T)."""
    if _needs_graph(u):
        return _K1.apply(u, scale)
    return _k1(u, scale, False)


def chebdiff_last_t(g: torch.Tensor, scale: float | None = None) -> torch.Tensor:
    """g (s D) along the last axis through K1^T (plain version on the CPU):
    the transpose of chebdiff_last, its vector-Jacobian product."""
    if _needs_graph(g):
        return _K1T.apply(g, scale)
    return _k1(g, scale, True)


class _K1(torch.autograd.Function):
    """u -> u (s D)^T through K1, for tensors that need a graph or are
    wrapped by torch.func.  backward: K1^T on the cotangent (through
    ``_K1T.apply``, so a backward is differentiable again); jvp: K1 on the
    tangent; vmap: one launch on the physical batch, batch axis first (K1
    takes any rank, so the batch joins its rows)."""

    @staticmethod
    def forward(u, scale):   # a batch moved first, or a cotangent, may be strided
        return _k1(u.contiguous(), scale, False)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.scale = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _K1T.apply(g, ctx.scale), None

    @staticmethod
    def jvp(ctx, u_dot, _):
        return _K1.apply(u_dot, ctx.scale)

    @staticmethod
    def vmap(info, in_dims, u, scale):
        if in_dims[0] is None:
            return _K1.apply(u, scale), None
        return _K1.apply(u.movedim(in_dims[0], 0), scale), 0


class _K1T(torch.autograd.Function):
    """g -> g (s D) through K1^T: ``_K1``'s transpose, with the roles of
    the pair swapped (its backward is K1)."""

    @staticmethod
    def forward(g, scale):
        return _k1(g.contiguous(), scale, True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.scale = inputs[1]

    @staticmethod
    def backward(ctx, u_bar):
        return _K1.apply(u_bar, ctx.scale), None

    @staticmethod
    def jvp(ctx, g_dot, _):
        return _K1T.apply(g_dot, ctx.scale)

    @staticmethod
    def vmap(info, in_dims, g, scale):
        if in_dims[0] is None:
            return _K1T.apply(g, scale), None
        return _K1T.apply(g.movedim(in_dims[0], 0), scale), 0


_GRID_KEYS = ("rows", "blocks", "threads", "smem")


def chebdiff_last_grid(u: torch.Tensor) -> dict:
    """K1's launch for the CUDA tensor u, as its C side chooses it (rows a
    tile, blocks, threads a block, shared memory bytes); launches nothing."""
    suffix = _check_cuda("chebdiff_last_grid", u)
    n = u.shape[-1]
    DT = _diffmat_t(n, None, u.dtype, u.device)
    out = (ctypes.c_longlong * 4)()
    _call("chebdiff_last_config_" + suffix, u.device, u.data_ptr(), DT.data_ptr(),
          u.numel() // n, n, ctypes.addressof(out), stream=False)
    return dict(zip(_GRID_KEYS, out))


def laplacian3d_grid(u: torch.Tensor) -> dict:
    """K2's launch for the 3-D CUDA tensor u: for each pass ("plane", "x"),
    rows a block, blocks, threads a block, shared memory bytes, and whether
    the plane pass is tiled; launches nothing."""
    suffix = _check_cuda("laplacian3d_grid", u)
    out = (ctypes.c_longlong * 9)()
    _call("laplacian3d_config_" + suffix, u.device, *u.shape, ctypes.addressof(out),
          stream=False)
    return {"plane": dict(zip(_GRID_KEYS, out[:4]), tiled=bool(out[8])),
            "x": dict(zip(_GRID_KEYS, out[4:8]))}


def laplacian3d_plane_tiled(dims: tuple[int, int, int], itemsize: int) -> bool:
    """Whether K2's plane pass takes its tiled layout (mirrors k2_shape in
    the C source): D2z^T, the plane u[i] in rows of nz + 4 and 4 rows of
    D2y, with ny and nz padded to multiples of 4, fit in SMEM_LIMIT."""
    _, ny, nz = dims
    nyp, nzp = (ny + 3) // 4 * 4, (nz + 3) // 4 * 4
    return itemsize * (nzp * nzp + nyp * (nzp + 4) + 4 * (nyp + 4)) <= SMEM_LIMIT


def laplacian3d_smem_bytes(dims: tuple[int, int, int], itemsize: int) -> int:
    """The least shared memory K2 takes for a field of ``dims`` (mirrors
    k2_plane_values in the C source): its plane pass, tiled at 4 rows a
    block where that fits, else unpadded at one row, nz^2 + ny nz + ny
    values.  Its x pass takes at most 51,200 bytes, so the plane pass
    decides which fields K2 takes."""
    _, ny, nz = dims
    nyp, nzp = (ny + 3) // 4 * 4, (nz + 3) // 4 * 4
    if laplacian3d_plane_tiled(dims, itemsize):
        return itemsize * (nzp * nzp + nyp * (nzp + 4) + 4 * (nyp + 4))
    return itemsize * (nz * nz + ny * nz + ny)


def laplacian3d(u: torch.Tensor, bmask: torch.Tensor | None = None,
                scales=None) -> torch.Tensor:
    """The 3-D spectral Laplacian through K2 (plain version on the CPU).

    With ``bmask`` (bool, u's shape) boundary rows are the identity,
    y_b = u_b, applied in the kernel's epilogue."""
    if _needs_graph(u):
        raise RuntimeError("laplacian3d: K2 has no reverse mode; a tensor that needs a "
                           "graph or is wrapped by torch.func takes the composed "
                           "operator (PoissonModel method 'matmul' or 'auto')")
    if u.device.type == "cpu":
        return laplacian3d_ref(u, bmask, scales)
    return _laplacian3d(u, bmask, scales)[1]


def _laplacian3d(u: torch.Tensor, bmask: torch.Tensor | None,
                 scales) -> tuple[torch.Tensor, torch.Tensor]:
    """K2 on a CUDA tensor: (t, y), t the plane pass's output
    s_y D2_y u + s_z D2_z u (chip_smoke.py holds each pass against its
    plain version)."""
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
    d2x, d2y, d2zt = _d2_ops(dims, _scales3(scales), u.dtype, u.device)
    t = torch.empty_like(u)   # the plane pass's output, the x pass's input
    y = torch.empty_like(u)
    _call(f"laplacian3d_{suffix}", u.device, u.data_ptr(), d2x.data_ptr(), d2y.data_ptr(),
          d2zt.data_ptr(), None if bmask is None else bmask.data_ptr(), t.data_ptr(),
          y.data_ptr(), *dims)
    LAUNCHES["laplacian3d_plane_kernel"] += 1
    LAUNCHES["laplacian3d_x_kernel"] += 1
    return t, y


def _packed_sizes(n: int, pack: int, block_rows: int, itemsize: int) -> tuple[int, int]:
    """K3's shared memory (mirrors k3_shape in the C source): the bytes of
    the padded D^T, and of one stage, block_rows * pack * (npad + 4) values
    and two 8-byte mbarriers."""
    npad = (n + 3) // 4 * 4
    return itemsize * npad * npad, itemsize * block_rows * pack * (npad + 4) + 16


def chebdiff_packed_stages(n: int, pack: int, block_rows: int, itemsize: int,
                           max_stages: int = K3_MAX_STAGES) -> int:
    """K3's ring depth (mirrors the C side): as many stages as fit in
    SMEM_LIMIT beside D^T, at most ``max_stages``; 0 when none fits."""
    fixed, stage = _packed_sizes(n, pack, block_rows, itemsize)
    return max(0, min(max_stages, (SMEM_LIMIT - fixed) // stage))


def chebdiff_packed_smem_bytes(n: int, pack: int, block_rows: int, itemsize: int,
                               max_stages: int = K3_MAX_STAGES) -> int:
    """Shared memory K3 takes (mirrors the C side): D^T and its stages; the
    need of one stage where none fits."""
    fixed, stage = _packed_sizes(n, pack, block_rows, itemsize)
    return fixed + max(1, chebdiff_packed_stages(n, pack, block_rows, itemsize,
                                                 max_stages)) * stage


def chebdiff_packed_bulk(u2d: torch.Tensor, pack: int) -> bool:
    """Whether K3 fills its stages by bulk copies (mirrors the C side):
    n % 4 == 0 and a 16-byte aligned u2d; otherwise its producer warp
    copies them with ordinary loads."""
    return (u2d.shape[1] // pack) % 4 == 0 and u2d.data_ptr() % 16 == 0


def _packed_shape(u2d: torch.Tensor, pack: int, block_rows: int) -> int:
    """K3's argument checks (the same on every device); returns n."""
    if u2d.ndim != 2:
        raise ValueError(f"chebdiff_packed: need a 2-D (M, n * pack) tensor, "
                         f"got shape {tuple(u2d.shape)}")
    w = u2d.shape[1]
    if pack < 1 or w % pack:
        raise ValueError(f"chebdiff_packed: row width {w} is not a multiple of pack={pack}")
    n = w // pack
    if n < 2 or w > K1_MAX_N:
        raise ValueError(f"chebdiff_packed: the kernel takes 2 <= n and "
                         f"n * pack <= {K1_MAX_N}, got n={n}, pack={pack}")
    if block_rows not in K3_BLOCK_ROWS:
        raise ValueError(f"chebdiff_packed: block_rows must be one of "
                         f"{K3_BLOCK_ROWS}, got {block_rows}")
    if chebdiff_packed_stages(n, pack, block_rows, u2d.element_size()) < 1:
        need = chebdiff_packed_smem_bytes(n, pack, block_rows, u2d.element_size())
        raise ValueError(f"chebdiff_packed: n={n}, pack={pack}, block_rows={block_rows} "
                         f"in {u2d.dtype} needs {need} bytes of shared memory, "
                         f"the kernel has {SMEM_LIMIT}")
    return n


def chebdiff_packed(u2d: torch.Tensor, pack: int, scale: float | None = None,
                    block_rows: int = 64) -> torch.Tensor:
    """The lane-packed derivative through K3 (plain version on the CPU):
    each row of the contiguous (M, n * pack) ``u2d`` holds ``pack``
    pencils of n, each multiplied by (scale * D)^T.  ``block_rows`` picks
    the row-tile height (one of K3_BLOCK_ROWS), the TPU sweep's blk.  The
    arguments are checked alike on every device."""
    return _chebdiff_packed(u2d, pack, scale, block_rows, K3_MAX_STAGES)


def _chebdiff_packed(u2d: torch.Tensor, pack: int, scale: float | None, block_rows: int,
                     max_stages: int) -> torch.Tensor:
    """``chebdiff_packed`` with the ring depth capped at ``max_stages``
    (chip_smoke.py times the caps)."""
    pack = int(pack)
    n = _packed_shape(u2d, pack, block_rows)
    if u2d.device.type == "cpu":
        return chebdiff_packed_ref(u2d, pack, scale)
    suffix = _check_cuda("chebdiff_packed", u2d)
    DT = _diffmat_t(n, None if scale is None else float(scale), u2d.dtype, u2d.device)
    y = torch.empty_like(u2d)
    if u2d.shape[0] == 0:
        return y
    _launch("chebdiff_packed_kernel", f"chebdiff_packed_{suffix}", u2d.device,
            u2d.data_ptr(), DT.data_ptr(), y.data_ptr(), u2d.shape[0], n, pack,
            block_rows, max_stages)
    return y
