// Native IO runtime for spectral-tpu-torch (a copy of the JAX package's
// csrc/io.cpp: the same entry points and the same blob wire format).
//
// The reference's output path is PetscViewerASCIIPrintf in a per-value loop
// (StokesVecView, stokes.C:1897-1916) — C-speed formatting.  The Python VTK
// writer would spend seconds formatting a 64^3 Stokes state; this module
// restores native formatting speed (exposed to Python via ctypes, see
// spectral_tpu_torch/utils/native.py, which builds it at first use).
//
// Build: g++ -O2 -shared -fPIC -o libspectral_io.so io.cpp

#include <cstdint>
#include <cstdio>
#include <cstring>

extern "C" {

// Format rows of doubles as "%20e %20e ...\n"; returns bytes written.
// `out` must hold at least rows * (cols * 22 + 2) bytes.
int64_t st_format_rows(const double* data, int64_t rows, int64_t cols,
                       char* out, int64_t out_cap) {
    char* p = out;
    char* end = out + out_cap;
    for (int64_t i = 0; i < rows; ++i) {
        for (int64_t j = 0; j < cols; ++j) {
            if (end - p < 32) return -1;
            p += snprintf(p, end - p, "%20e ", data[i * cols + j]);
        }
        if (end - p < 2) return -1;
        *p++ = '\n';
    }
    return p - out;
}

// Format a 3x3-tensor block sequence (VTK TENSORS layout: 3 lines per node
// + blank line, stokes.C:1878-1888); data is (nodes, 3, 3) row-major.
int64_t st_format_tensors(const double* data, int64_t nodes,
                          char* out, int64_t out_cap) {
    char* p = out;
    char* end = out + out_cap;
    for (int64_t i = 0; i < nodes; ++i) {
        for (int64_t r = 0; r < 3; ++r) {
            for (int64_t c = 0; c < 3; ++c) {
                if (end - p < 32) return -1;
                p += snprintf(p, end - p, "%20e ", data[(i * 3 + r) * 3 + c]);
            }
            if (end - p < 2) return -1;
            *p++ = '\n';
        }
        if (end - p < 2) return -1;
        *p++ = '\n';
    }
    return p - out;
}

// Binary checkpoint writer: header (magic, count, per-array ndim/shape)
// followed by raw little-endian f64 payloads.  Faster and simpler than
// np.savez for large continuation states; format documented in native.py.
int64_t st_write_blob(const char* path, const double* data, int64_t n) {
    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    const uint64_t magic = 0x53504543544C5452ull;  // "SPECTLTR"
    fwrite(&magic, sizeof(magic), 1, f);
    uint64_t count = (uint64_t)n;
    fwrite(&count, sizeof(count), 1, f);
    size_t written = fwrite(data, sizeof(double), (size_t)n, f);
    fclose(f);
    return (int64_t)written == n ? 0 : -2;
}

int64_t st_read_blob(const char* path, double* data, int64_t n) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    uint64_t magic = 0, count = 0;
    if (fread(&magic, sizeof(magic), 1, f) != 1 ||
        magic != 0x53504543544C5452ull) { fclose(f); return -3; }
    if (fread(&count, sizeof(count), 1, f) != 1 ||
        (int64_t)count != n) { fclose(f); return -4; }
    size_t got = fread(data, sizeof(double), (size_t)n, f);
    fclose(f);
    return (int64_t)got == n ? 0 : -2;
}

}  // extern "C"
