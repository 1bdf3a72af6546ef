// Hand-written Hopper (sm_90a) kernels for the Chebyshev transform hot path.
//
// Built by spectral_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.  Each
// entry point launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 on success).  Every kernel
// is templated on float and double and accumulates in the working type.
//
// K1 chebdiff_last_kernel  (replaces spectral_tpu/ops/pallas_cheb.py::chebdiff_last_pallas)
//   y[M, n] = u[M, n] @ DT[n, n], DT = (s D)^T folded on the host in float64
//   before the cast.  Bound: at n = 64 in float32 the product does 2n = 128
//   FLOP per 8 bytes of device memory moved (read u, write y), 16 FLOP/byte,
//   just under the H100's float32 (non-tensor-core) balance of about
//   20 FLOP/byte, so the roofline is memory traffic with the FMA pipe close
//   behind; in this design the shared-memory load pipe binds first.
//   Design: each block keeps DT in shared memory (loaded once) and streams
//   row tiles of u through a row-major shared tile (grid-stride loop over
//   tiles, grid sized by occupancy), so u and y cross device memory once.
//   When n % 4 == 0 the tiles are double-buffered: the next one streams in
//   by cp.async while the current one computes (other n take a synchronous,
//   zero-padded load).  Each thread owns a 4 x 4 register tile of y and
//   walks k four steps at a time: 8 16-byte shared loads (4 rows of u, 4
//   rows of DT) feed 64 FMAs.  The ragged row tail is masked, not padded.
//   Largest n: K1_MAX_N = 128 (DT is 128 KB in float64).
//
// K2 laplacian3d_kernel    (replaces spectral_tpu/ops/pallas_cheb.py::laplacian3d_pallas)
//   y = -(D2x u + D2y u + D2z u) on an (nx, ny, nz) field, D2 = s (D @ D)
//   precombined in float64; with bmask, y = where(bmask, u, y) in the
//   epilogue.  The TPU kernel keeps the whole field in VMEM; a 64^3 field
//   (1 MiB in float32, 2 MiB in float64) does not fit the 227 KB of shared
//   memory a block may use.  Bound: 6n FLOP per point against 8 (16) bytes
//   of device traffic, so the operator is cheap; what costs is re-reading
//   u along three lines per point.  Design: block (jt, i) owns the points
//   (i, j0..j0+tj, all k).  It holds the x-plane u[i, :, :], D2z^T and its
//   rows of D2y in shared memory, so the y and z contractions read shared
//   memory only; the x contraction reads pencils u[:, j, k] from global
//   memory, coalesced over k and L2-resident at these sizes (50 MB L2).
//   y is written once.  Limit: (ny*nz + nz*nz + ny*tj + nx) * sizeof(T)
//   <= 227 KB (64^3 in float64 takes 73 KB).
//
// K3 chebdiff_packed_kernel  (replaces benchmarks/exp_pallas.py::make_pallas)
//   y[M, n*pack] = u[M, n*pack] @ kron(I_pack, DT), DT = (s D)^T folded on
//   the host in float64 before the cast: the lane-packed derivative of the
//   TPU experiment, which packs `pack` pencils of n = 64 into one 128-lane
//   row so the MXU sees a full-width product.  The TPU multiplies the zero
//   blocks of the Kronecker product for free; a GPU thread pays for every
//   FMA, and at pack = 2 the dense form would do 17.2 GFLOP at the sweep
//   shape.  This kernel never touches the zero blocks: the (M, n*pack) rows
//   are M*pack contiguous pencils of n, and one resident DT (n x n) in
//   shared memory serves every pencil of every row.  Bound at the sweep
//   shape (u of 1,048,576 x 64 float32, either packing): 512 MiB moved (u
//   read once, y written once), 0.160 ms at 3.35 TB/s; 8.6 GFLOP, 0.128 ms
//   at 67 TFLOP/s float32 (outside the tensor cores): memory bound.
//   Design: the row-tile height (BM rows, BM * pack pencils) is a template
//   parameter (32, 64 or 128: the counterpart of the TPU's blk sweep).  A
//   block loads DT once, then walks row tiles (grid-stride loop, grid sized
//   by occupancy): a coalesced copy of the tile into padded shared rows,
//   then each thread computes 4 x 4 register tiles of y from 16-byte shared
//   loads (micro_tile, shared with K1).  The ragged last tile is masked (the TPU launch,
//   grid = M // blk, leaves it unwritten).  The TPU's dimension_semantics
//   and vmem_limit_bytes have no counterpart: blocks always run in
//   parallel on the card, and shared memory is sized per launch.
//   Limit: (npad^2 + BM * pack * (npad + 4)) * sizeof(T) <= 227 KB.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 4;  // K1 rows per thread
constexpr int kTN = 4;  // K1 columns per thread
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use on sm_90

struct K1Shape {
  int npad;  // n rounded up to a multiple of 4 (k extent in shared memory)
  int ncg;   // column groups of kTN (npad / kTN)
  int rg;    // row groups of kTM
  int bm;    // rows per tile (rg * kTM)
  int ldu;   // row stride of the u tile (npad + 4: 16-byte rows, 2 bank groups)
};

K1Shape k1_shape(int n) {
  K1Shape s;
  s.npad = (n + 3) / 4 * 4;
  s.ncg = s.npad / kTN;
  s.rg = kThreads / s.ncg;
  s.bm = s.rg * kTM;
  s.ldu = s.npad + 4;
  return s;
}

// Four consecutive values from / to 16-byte aligned memory.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void load4(const double* p, double v[4]) {
  const double2 q0 = *reinterpret_cast<const double2*>(p);
  const double2 q1 = *reinterpret_cast<const double2*>(p + 2);
  v[0] = q0.x; v[1] = q0.y; v[2] = q1.x; v[3] = q1.y;
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(double* p, const double v[4]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  *reinterpret_cast<double2*>(p + 2) = make_double2(v[2], v[3]);
}

// The register tile of K1 and K3: acc[i][j] = sum_k a[i * lda + k] * b[k * ldb + j]
// over k < npad (a multiple of 4), i < kTM, j < kTN.  Each step of four k
// takes 8 16-byte shared loads (4 rows of a, 4 rows of b) and does 64 FMAs.
template <typename T>
__device__ __forceinline__ void micro_tile(const T* a, int lda, const T* b, int ldb, int npad,
                                           T acc[kTM][kTN]) {
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = T(0);
  for (int k0 = 0; k0 < npad; k0 += 4) {
    T av[kTM][4];
#pragma unroll
    for (int i = 0; i < kTM; ++i) load4(a + i * lda + k0, av[i]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      T bv[kTN];
      load4(b + size_t(k0 + kk) * ldb, bv);
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fma(av[i][kk], bv[j], acc[i][j]);
    }
  }
}

// Asynchronous 16-byte global -> shared copies (sm_80+), tracked in groups.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_prior() {  // all groups but the newest
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Issue the copies of one row tile into ``buf``: 16-byte chunks, rows past
// the end are skipped (their accumulators are never stored).  Needs
// n % 4 == 0 and a 16-byte aligned u, so chunks never straddle rows.
template <typename T>
__device__ __forceinline__ void issue_tile(T* buf, const T* __restrict__ u, long long M,
                                           int n, const K1Shape& s, long long tile) {
  constexpr int CH = 16 / sizeof(T);
  const long long row0 = tile * s.bm;
  const long long left = M - row0;
  const int rows = left < s.bm ? int(left) : s.bm;
  const T* src = u + row0 * n;
  for (int c = threadIdx.x; c < rows * n / CH; c += kThreads) {
    const int e = c * CH, r = e / n, k = e - r * n;
    cp_async16(buf + r * s.ldu + k, src + e);
  }
  cp_async_commit();
}

// Synchronous tile load for any n: the k extent is zero-padded to npad.
template <typename T>
__device__ __forceinline__ void load_tile(T* buf, const T* __restrict__ u, long long M,
                                          int n, const K1Shape& s, long long tile) {
  const long long row0 = tile * s.bm;
  const long long left = M - row0;
  const int rows = left < s.bm ? int(left) : s.bm;
  const T* src = u + row0 * n;
  const int dr = kThreads / s.npad, dk = kThreads % s.npad;
  int r = threadIdx.x / s.npad, k = threadIdx.x % s.npad;
  while (r < s.bm) {
    buf[r * s.ldu + k] = (r < rows && k < n) ? src[size_t(r) * n + k] : T(0);
    r += dr;
    k += dk;
    if (k >= s.npad) { k -= s.npad; ++r; }
  }
}

// kAsync: double-buffered cp.async tile loads (the next tile streams in
// while this one computes); otherwise one synchronous buffer.
template <typename T, bool kAsync>
__global__ void __launch_bounds__(kThreads)
chebdiff_last_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                     T* __restrict__ y, long long M, int n, K1Shape s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* dts = reinterpret_cast<T*>(smem_raw);  // npad x npad, zero beyond n
  // one or two u tiles of bm x ldu: [r * ldu + k] = u[row0 + r, k]
  T* const ubase = dts + size_t(s.npad) * s.npad;
  const size_t ustride = size_t(s.bm) * s.ldu;
  const int tid = threadIdx.x;

  const long long tiles = (M + s.bm - 1) / s.bm;
  if (kAsync && blockIdx.x < tiles) issue_tile(ubase, u, M, n, s, blockIdx.x);
  for (int idx = tid; idx < s.npad * s.npad; idx += blockDim.x) {
    const int k = idx / s.npad, c = idx - k * s.npad;
    dts[idx] = (k < n && c < n) ? dt[size_t(k) * n + c] : T(0);
  }

  const int cg = tid % s.ncg;
  const int rgi = tid / s.ncg;
  const bool active = rgi < s.rg;
  const bool vec_store = (n % 4) == 0;  // y rows start 16-byte aligned
  int cur = 0;

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * s.bm;
    const long long left = M - row0;
    const int rows = left < s.bm ? int(left) : s.bm;
    if (kAsync) {
      const long long next = tile + gridDim.x;
      if (next < tiles) {
        issue_tile(ubase + (cur ^ 1) * ustride, u, M, n, s, next);
      } else {
        cp_async_commit();  // an empty group keeps the wait count uniform
      }
      cp_async_wait_prior();  // this tile's copies (this thread's) have landed
    } else {
      load_tile(ubase, u, M, n, s, tile);
    }
    __syncthreads();  // the tile and DT are visible to every thread
    if (active) {
      T acc[kTM][kTN];
      micro_tile(ubase + cur * ustride + rgi * kTM * s.ldu, s.ldu, dts + cg * kTN, s.npad,
                 s.npad, acc);
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int rr = rgi * kTM + i;
        if (rr < rows) {
          T* dst = y + (row0 + rr) * n + cg * kTN;
          if (vec_store) {
            store4(dst, acc[i]);  // n % 4 == 0, so cg * 4 + 3 < n
          } else {
#pragma unroll
            for (int j = 0; j < kTN; ++j)
              if (cg * kTN + j < n) dst[j] = acc[i][j];
          }
        }
      }
    }
    __syncthreads();  // every reader is done before this buffer is refilled
    if (kAsync) cur ^= 1;
  }
}

template <typename T, bool kAsync>
cudaError_t launch_k1(const T* u, const T* dt, T* y, long long M, int n,
                      const K1Shape& s, cudaStream_t stream) {
  const size_t smem = sizeof(T) * (size_t(s.npad) * s.npad +
                                   (kAsync ? 2 : 1) * size_t(s.bm) * s.ldu);
  if (smem > size_t(kMaxSmem)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(chebdiff_last_kernel<T, kAsync>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, chebdiff_last_kernel<T, kAsync>, kThreads, smem)) != cudaSuccess)
    return err;
  const long long tiles = (M + s.bm - 1) / s.bm;
  long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > tiles) blocks = tiles;
  chebdiff_last_kernel<T, kAsync><<<unsigned(blocks), kThreads, smem, stream>>>(u, dt, y, M, n, s);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_chebdiff_last(const T* u, const T* dt, T* y, long long M,
                                 int n, cudaStream_t stream) {
  if (n < 2 || n > 128 || M < 0) return cudaErrorInvalidValue;
  if (M == 0) return cudaSuccess;
  const K1Shape s = k1_shape(n);
  const bool async = n % 4 == 0 && reinterpret_cast<unsigned long long>(u) % 16 == 0;
  return async ? launch_k1<T, true>(u, dt, y, M, n, s, stream)
               : launch_k1<T, false>(u, dt, y, M, n, s, stream);
}

int k2_tile_rows(int ny, int nz) {
  int tj = 1024 / nz;
  if (tj < 1) tj = 1;
  if (tj > ny) tj = ny;
  return tj;
}

template <typename T>
size_t k2_smem(int nx, int ny, int nz, int tj) {
  return sizeof(T) * (size_t(ny) * nz + size_t(nz) * nz + size_t(ny) * tj + nx);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
laplacian3d_kernel(const T* __restrict__ u, const T* __restrict__ d2xt,
                   const T* __restrict__ d2yt, const T* __restrict__ d2zt,
                   const bool* __restrict__ bmask, T* __restrict__ y,
                   int nx, int ny, int nz, int tj) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* plane = reinterpret_cast<T*>(smem_raw);  // u[i, :, :]            (ny x nz)
  T* dzt = plane + size_t(ny) * nz;            // D2zT[a, k]            (nz x nz)
  T* dyt = dzt + size_t(nz) * nz;              // D2yT[a, j0 + jl]      (ny x tj)
  T* dxc = dyt + size_t(ny) * tj;              // D2xT[a, i]            (nx)
  const int i = blockIdx.y;
  const int j0 = blockIdx.x * tj;
  const int tjh = min(tj, ny - j0);
  const size_t pstride = size_t(ny) * nz;
  const T* ui = u + size_t(i) * pstride;

  for (int idx = threadIdx.x; idx < ny * nz; idx += blockDim.x) plane[idx] = ui[idx];
  for (int idx = threadIdx.x; idx < nz * nz; idx += blockDim.x) dzt[idx] = d2zt[idx];
  for (int idx = threadIdx.x; idx < ny * tj; idx += blockDim.x) {
    const int a = idx / tj, jl = idx - a * tj;
    dyt[idx] = jl < tjh ? d2yt[size_t(a) * ny + j0 + jl] : T(0);
  }
  for (int a = threadIdx.x; a < nx; a += blockDim.x) dxc[a] = d2xt[size_t(a) * nx + i];
  __syncthreads();

  for (int p = threadIdx.x; p < tjh * nz; p += blockDim.x) {
    const int jl = p / nz, k = p - jl * nz;
    const int j = j0 + jl;
    T acc = T(0);
    const T* row = plane + size_t(j) * nz;  // u[i, j, :]
    for (int a = 0; a < nz; ++a) acc = fma(dzt[size_t(a) * nz + k], row[a], acc);
    for (int a = 0; a < ny; ++a) acc = fma(dyt[size_t(a) * tj + jl], plane[size_t(a) * nz + k], acc);
    const T* pencil = u + size_t(j) * nz + k;  // u[:, j, k]
    for (int a = 0; a < nx; ++a) acc = fma(dxc[a], pencil[size_t(a) * pstride], acc);
    const size_t o = size_t(i) * pstride + size_t(j) * nz + k;
    y[o] = (bmask != nullptr && bmask[o]) ? ui[size_t(j) * nz + k] : -acc;
  }
}

template <typename T>
cudaError_t launch_laplacian3d(const T* u, const T* d2xt, const T* d2yt,
                               const T* d2zt, const bool* bmask, T* y,
                               int nx, int ny, int nz, cudaStream_t stream) {
  if (nx < 1 || ny < 1 || nz < 1) return cudaErrorInvalidValue;
  const int tj = k2_tile_rows(ny, nz);
  const size_t smem = k2_smem<T>(nx, ny, nz, tj);
  if (smem > size_t(kMaxSmem)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(laplacian3d_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((ny + tj - 1) / tj, nx);
  laplacian3d_kernel<T><<<grid, kThreads, smem, stream>>>(u, d2xt, d2yt, d2zt,
                                                          bmask, y, nx, ny, nz, tj);
  return cudaGetLastError();
}


template <int BM>
size_t k3_smem(int n, int pack, size_t itemsize) {
  const int npad = (n + 3) / 4 * 4;
  return itemsize * (size_t(npad) * npad + size_t(BM) * pack * (npad + 4));
}

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
chebdiff_packed_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                       T* __restrict__ y, long long M, int n, int pack) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int npad = (n + 3) / 4 * 4;
  const int ldu = npad + 4;
  const int w = n * pack;        // elements per row of u and y
  const int P = BM * pack;       // pencils per row tile
  T* dts = reinterpret_cast<T*>(smem_raw);   // npad x npad, zero beyond n
  T* tile = dts + size_t(npad) * npad;        // P x ldu: [p * ldu + k]
  const int tid = threadIdx.x;

  for (int idx = tid; idx < npad * npad; idx += blockDim.x) {
    const int k = idx / npad, c = idx - k * npad;
    dts[idx] = (k < n && c < n) ? dt[size_t(k) * n + c] : T(0);
  }
  // the k padding of every pencil is zero once and never overwritten
  for (int idx = tid; idx < P * (npad - n); idx += blockDim.x) {
    const int p = idx / (npad - n), k = n + idx - p * (npad - n);
    tile[p * ldu + k] = T(0);
  }

  const int ncg = npad / kTN;            // column groups
  const int items = (P / kTM) * ncg;     // 4 x 4 output tiles per row tile
  const long long tiles = (M + BM - 1) / BM;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long row0 = t * BM;
    const int rows = M - row0 < BM ? int(M - row0) : BM;
    const T* src = u + row0 * w;
    for (int e = tid; e < rows * w; e += blockDim.x) {
      const int p = e / n, k = e - p * n;
      tile[p * ldu + k] = src[e];
    }
    __syncthreads();  // the tile (and, the first time, DT) is visible
    const int pencils = rows * pack;
    for (int it = tid; it < items; it += blockDim.x) {
      const int cg = it % ncg, pg = it / ncg;
      if (pg * kTM >= pencils) continue;
      T acc[kTM][kTN];
      micro_tile(tile + pg * kTM * ldu, ldu, dts + cg * kTN, npad, npad, acc);
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int p = pg * kTM + i;
        if (p < pencils) {
          T* dst = y + (row0 * pack + p) * n + cg * kTN;
#pragma unroll
          for (int j = 0; j < kTN; ++j)
            if (cg * kTN + j < n) dst[j] = acc[i][j];
        }
      }
    }
    __syncthreads();  // every reader is done before the tile is refilled
  }
}

template <typename T, int BM>
cudaError_t launch_k3(const T* u, const T* dt, T* y, long long M, int n, int pack,
                      cudaStream_t stream) {
  const size_t smem = k3_smem<BM>(n, pack, sizeof(T));
  if (smem > size_t(kMaxSmem)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(chebdiff_packed_kernel<T, BM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, chebdiff_packed_kernel<T, BM>, kThreads, smem)) != cudaSuccess)
    return err;
  const long long tiles = (M + BM - 1) / BM;
  long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > tiles) blocks = tiles;
  chebdiff_packed_kernel<T, BM><<<unsigned(blocks), kThreads, smem, stream>>>(u, dt, y, M, n,
                                                                             pack);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_chebdiff_packed(const T* u, const T* dt, T* y, long long M, int n,
                                   int pack, int block_rows, cudaStream_t stream) {
  if (n < 2 || pack < 1 || n * pack > 128 || M < 0) return cudaErrorInvalidValue;
  if (M == 0) return cudaSuccess;
  switch (block_rows) {
    case 32: return launch_k3<T, 32>(u, dt, y, M, n, pack, stream);
    case 64: return launch_k3<T, 64>(u, dt, y, M, n, pack, stream);
    case 128: return launch_k3<T, 128>(u, dt, y, M, n, pack, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int chebdiff_last_f32(const void* u, const void* dt, void* y, long long M, int n,
                      void* stream) {
  return int(launch_chebdiff_last(static_cast<const float*>(u), static_cast<const float*>(dt),
                                  static_cast<float*>(y), M, n,
                                  static_cast<cudaStream_t>(stream)));
}

int chebdiff_last_f64(const void* u, const void* dt, void* y, long long M, int n,
                      void* stream) {
  return int(launch_chebdiff_last(static_cast<const double*>(u), static_cast<const double*>(dt),
                                  static_cast<double*>(y), M, n,
                                  static_cast<cudaStream_t>(stream)));
}

int laplacian3d_f32(const void* u, const void* d2xt, const void* d2yt, const void* d2zt,
                    const void* bmask, void* y, int nx, int ny, int nz, void* stream) {
  return int(launch_laplacian3d(static_cast<const float*>(u), static_cast<const float*>(d2xt),
                                static_cast<const float*>(d2yt), static_cast<const float*>(d2zt),
                                static_cast<const bool*>(bmask), static_cast<float*>(y),
                                nx, ny, nz, static_cast<cudaStream_t>(stream)));
}

int laplacian3d_f64(const void* u, const void* d2xt, const void* d2yt, const void* d2zt,
                    const void* bmask, void* y, int nx, int ny, int nz, void* stream) {
  return int(launch_laplacian3d(static_cast<const double*>(u), static_cast<const double*>(d2xt),
                                static_cast<const double*>(d2yt), static_cast<const double*>(d2zt),
                                static_cast<const bool*>(bmask), static_cast<double*>(y),
                                nx, ny, nz, static_cast<cudaStream_t>(stream)));
}

int chebdiff_packed_f32(const void* u, const void* dt, void* y, long long M, int n,
                        int pack, int block_rows, void* stream) {
  return int(launch_chebdiff_packed(static_cast<const float*>(u), static_cast<const float*>(dt),
                                    static_cast<float*>(y), M, n, pack, block_rows,
                                    static_cast<cudaStream_t>(stream)));
}

int chebdiff_packed_f64(const void* u, const void* dt, void* y, long long M, int n,
                        int pack, int block_rows, void* stream) {
  return int(launch_chebdiff_packed(static_cast<const double*>(u),
                                    static_cast<const double*>(dt), static_cast<double*>(y),
                                    M, n, pack, block_rows, static_cast<cudaStream_t>(stream)));
}

const char* cheb_kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
