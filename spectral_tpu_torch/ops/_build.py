"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled at first use with ``nvcc`` into a shared library
with a plain C interface and loaded with ``ctypes``.  The library lands in
``build/spectral_tpu_torch-kernels/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.  Nothing here
runs at import time; a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "cheb_kernels.cu",)
BUILD_DIR = _PKG.parent / "build" / "spectral_tpu_torch-kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

_P = ctypes.c_void_p
_SIGNATURES = {
    # (u, dt, y, M, n, stream)
    "chebdiff_last_f32": [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P],
    "chebdiff_last_f64": [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P],
    # (u, dt, y, M, n, pack, block_rows, max_stages, stream)
    "chebdiff_packed_f32": [_P, _P, _P, ctypes.c_longlong] + [ctypes.c_int] * 4 + [_P],
    "chebdiff_packed_f64": [_P, _P, _P, ctypes.c_longlong] + [ctypes.c_int] * 4 + [_P],
    # (u, d2x, d2y, d2zt, bmask, t, y, nx, ny, nz, stream); t: scratch of u's size
    "laplacian3d_f32": [_P] * 7 + [ctypes.c_int] * 3 + [_P],
    "laplacian3d_f64": [_P] * 7 + [ctypes.c_int] * 3 + [_P],
    # launch configurations, launching nothing: (u, dt, M, n, out[4]), (nx, ny, nz, out[9])
    "chebdiff_last_config_f32": [_P, _P, ctypes.c_longlong, ctypes.c_int, _P],
    "chebdiff_last_config_f64": [_P, _P, ctypes.c_longlong, ctypes.c_int, _P],
    "laplacian3d_config_f32": [ctypes.c_int] * 3 + [_P],
    "laplacian3d_config_f64": [ctypes.c_int] * 3 + [_P],
}


def _nvcc() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    candidates += [shutil.which("nvcc") or "", _DEFAULT_NVCC]
    for c in candidates:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcheb_kernels-{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the sources if no library for them exists yet.  Returns the
    library path and the seconds spent compiling (0.0 when it existed).
    The compiler's report (``-Xptxas -v``: registers, shared memory,
    spills) is kept beside the library as ``.log``."""
    path = library_path()
    if path.exists():
        return path, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return path, seconds


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, declare every signature."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.cheb_kernels_error_string.argtypes = [ctypes.c_int]
    lib.cheb_kernels_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = lib.cheb_kernels_error_string(code).decode()
        raise RuntimeError(f"{name} failed: CUDA error {code} ({msg})")
