"""ctypes bindings to the native C++ IO runtime (``csrc/io.cpp``).

Counterpart of ``spectral_tpu/utils/native.py``, on the port's own copy of
the source.  The library is compiled with ``g++`` at first use into
``build/spectral_tpu_torch-io/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of the source and flags; it is built under
a temporary name and moved into place, so processes building at once do
not collide.  Without a compiler ``available()`` is False, and every
function takes its Python path: the formatters give the native output
byte for byte, the blobs the same wire format.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "io.cpp"
BUILD_DIR = _PKG.parent / "build" / "spectral_tpu_torch-io"
CXX_FLAGS = ("-O2", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_tried = False

_D = ctypes.POINTER(ctypes.c_double)
_SIGNATURES = {
    "st_format_rows": [_D, ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64],
    "st_format_tensors": [_D, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64],
    "st_write_blob": [ctypes.c_char_p, _D, ctypes.c_int64],
    "st_read_blob": [ctypes.c_char_p, _D, ctypes.c_int64],
}


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"libspectral_io-{h.hexdigest()[:16]}.so"


def _build() -> Path:
    path = library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        try:
            subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                           check=True, capture_output=True)
            os.replace(tmp, path)   # atomic: a concurrent loader sees all or nothing
        finally:
            tmp.unlink(missing_ok=True)
    return path


def _load():
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            try:
                lib = ctypes.CDLL(str(_build()))
            except (OSError, subprocess.CalledProcessError):
                return None   # no compiler, or no build: the Python paths serve
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int64
            _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _f64(arr) -> np.ndarray:
    return np.ascontiguousarray(arr, dtype=np.float64)


def format_rows(arr) -> str:
    """Rows of '%20e ' values, one line per row."""
    lib = _load()
    if lib is None:
        return format_rows_py(arr)
    a = _f64(arr)
    rows, cols = a.shape
    cap = rows * (cols * 24 + 2) + 16
    buf = ctypes.create_string_buffer(cap)
    n = lib.st_format_rows(a.ctypes.data_as(_D), rows, cols, buf, cap)
    if n < 0:
        raise RuntimeError("native formatting failed")
    return buf.raw[:n].decode().rstrip("\n")


def format_tensors(arr) -> str:
    """(nodes, 3, 3) tensor blocks in the VTK TENSORS layout: three lines a
    node and a blank line after each."""
    lib = _load()
    if lib is None:
        return format_tensors_py(arr)
    a = _f64(arr)
    nodes = a.shape[0]
    cap = nodes * (3 * (3 * 24 + 2) + 2) + 16
    buf = ctypes.create_string_buffer(cap)
    n = lib.st_format_tensors(a.ctypes.data_as(_D), nodes, buf, cap)
    if n < 0:
        raise RuntimeError("native formatting failed")
    return buf.raw[:n].decode()


def format_rows_py(arr) -> str:
    """format_rows without the library, byte for byte."""
    return "\n".join(" ".join(f"{v:20e}" for v in row) + " " for row in _f64(arr))


def format_tensors_py(arr) -> str:
    """format_tensors without the library, byte for byte (the JAX
    package's fallback drops the last blank line; the native layout keeps
    it)."""
    return "".join(format_rows_py(block) + "\n\n" for block in _f64(arr))


# Blob wire format (csrc/io.cpp's st_write_blob/st_read_blob and the Python
# path below, the JAX package's): <u64 magic 'SPECTLTR'> <u64 count> <count f64 LE>.
_BLOB_MAGIC = 0x53504543544C5452


def write_blob(path: str, arr) -> None:
    lib = _load()
    a = _f64(arr).reshape(-1)
    if lib is None:
        with open(path, "wb") as f:
            f.write(struct.pack("<QQ", _BLOB_MAGIC, a.size))
            a.astype("<f8", copy=False).tofile(f)
        return
    rc = lib.st_write_blob(os.fsencode(path), a.ctypes.data_as(_D), a.size)
    if rc != 0:
        raise IOError(f"st_write_blob failed rc={rc}")


def read_blob(path: str, n: int) -> np.ndarray:
    lib = _load()
    if lib is None:
        with open(path, "rb") as f:
            magic, count = struct.unpack("<QQ", f.read(16))
            if magic != _BLOB_MAGIC:
                raise IOError(f"bad blob magic in {path}: {magic:#x}")
            if count != n:
                raise IOError(f"blob {path} holds {count} values, need {n}")
            return np.fromfile(f, dtype="<f8", count=n)
    out = np.empty(n, dtype=np.float64)
    rc = lib.st_read_blob(os.fsencode(path), out.ctypes.data_as(_D), n)
    if rc != 0:
        raise IOError(f"st_read_blob failed rc={rc}")
    return out
