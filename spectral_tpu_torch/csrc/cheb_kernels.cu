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
//   at 67 TFLOP/s float32 (outside the tensor cores): memory bound, with
//   the FMA pipe at 80% of the byte time, so the kernel must overlap its
//   loads with its FMAs and keep the FMA pipe fed from shared memory.
//   Design, for what binds on this card:
//   - Pencils, not rows.  A row tile of BM rows (a template parameter: 32,
//     64 or 128, the TPU's blk sweep) is BM * pack contiguous pencils, so
//     every packing runs the same code and the same FMAs.
//   - Latency: a ring of `stages` tile buffers filled by Hopper bulk copies
//     (cp.async.bulk, the 1-D TMA copy; no tensor map).  One producer warp
//     waits on a stage's "empty" mbarrier, arms its "full" mbarrier with
//     expect_tx for the bytes it copies (fewer on the ragged last tile) and
//     issues 4 copies, one per quarter of the tile.  Eight consumer warps
//     wait on "full", compute, and arrive on "empty".  The host sizes the
//     ring: as many stages as fit in 227 KB beside the resident DT, capped
//     at K3_MAX_STAGES (chip_smoke.py phase 5 times every cap).  At n = 64
//     float32 that is 6 stages of 128 pencils or 3 of 256; float64 with 256
//     pencils fits 1.
//   - Few copies: the TMA unit pays per copy.  An earlier version of this
//     kernel, with one 256-byte copy a pencil into rows of npad + 4, was
//     bound by its copies and took 1.6 times as long at the sweep shape
//     (PERF.md).  A quarter of a tile is contiguous in u and lands
//     contiguous in shared memory, followed by a 16-byte pad (k3_shape).
//   - The shared-load pipe: each consumer thread owns kTM pencils x 8
//     columns of y (8 x 8 in float32: 16 16-byte shared loads feed 256
//     FMAs; 4 x 8 in float64, the FMA pipe there runs at half rate).  A
//     warp's lanes take one pencil from each quarter x 8 consecutive 16-byte
//     column chunks.  The pads put the 4 pencils of a load in 4 bank groups
//     (one copy per tile into unpadded rows would put them in one), and the
//     8 chunks of DT are contiguous, so every shared load is one
//     conflict-free wavefront, at any n (pencil_tile).  K1 keeps micro_tile:
//     its tile is the same for every n and its results are kept bit for bit.
//   - Stores: 16-byte stores from registers, a warp writing 4 full 128-byte
//     row segments; the ragged tail is masked, never padded in memory.
//   - A persistent grid: one block per resident slot (SM count x occupancy,
//     read once per instance), each walking tiles blockIdx.x + k gridDim.x;
//     the consumer warps take the items of consecutive tiles in turn, so
//     all eight stay busy when a tile has fewer items than warps.
//   - Shapes a bulk copy cannot take (n % 4 != 0, whose pencils need zero k
//     padding in shared memory, or u not 16-byte aligned) run the same
//     kernel with kBulk false: the producer warp copies the tile with
//     ordinary loads and stores, and every lane arrives on "full".
//   FMA pipe only: no tensor cores, so float32 stays float32 (no TF32).
//   The ragged last tile is masked (the TPU launch, grid = M // blk, leaves
//   it unwritten).  The TPU's dimension_semantics and vmem_limit_bytes have
//   no counterpart: blocks always run in parallel on the card, and shared
//   memory is sized per launch.
//   Limit: one stage, (npad^2 + BM * pack * (npad + 4)) * sizeof(T) + 16
//   <= 227 KB.

#include <cuda_runtime.h>

#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>
#include <utility>

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

// The register tile of K1: acc[i][j] = sum_k a[i * lda + k] * b[k * ldb + j]
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

// Launch set-up shared by every launcher, done once per (device, kernel,
// dynamic shared memory bytes): raise the kernel's dynamic shared memory
// limit (never lowering it below a size an earlier launch needed) and
// return in *blocks how many blocks of `threads` the card holds at once
// (SM count x occupancy), the size of a persistent grid.  Later launches
// read the cache under a lock (ctypes calls release the interpreter lock).
cudaError_t resident_blocks(const void* kernel, int threads, size_t smem, long long* blocks) {
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, size_t> smem_set;
  static std::map<std::tuple<int, const void*, size_t>, long long> cache;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(dev, kernel, smem);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *blocks = hit->second;
    return cudaSuccess;
  }
  size_t& limit = smem_set[std::make_pair(dev, kernel)];
  if (smem > limit) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    limit = smem;
  }
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return err;
  *blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  cache.emplace(key, *blocks);
  return cudaSuccess;
}

template <typename T, bool kAsync>
cudaError_t launch_k1(const T* u, const T* dt, T* y, long long M, int n,
                      const K1Shape& s, cudaStream_t stream) {
  const size_t smem = sizeof(T) * (size_t(s.npad) * s.npad +
                                   (kAsync ? 2 : 1) * size_t(s.bm) * s.ldu);
  if (smem > size_t(kMaxSmem)) return cudaErrorInvalidValue;
  long long blocks = 0;
  const cudaError_t err = resident_blocks(
      reinterpret_cast<const void*>(chebdiff_last_kernel<T, kAsync>), kThreads, smem, &blocks);
  if (err != cudaSuccess) return err;
  const long long tiles = (M + s.bm - 1) / s.bm;
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
  long long resident = 0;  // K2's grid follows the field, not the card
  const cudaError_t err = resident_blocks(reinterpret_cast<const void*>(laplacian3d_kernel<T>),
                                          kThreads, smem, &resident);
  if (err != cudaSuccess) return err;
  const dim3 grid((ny + tj - 1) / tj, nx);
  laplacian3d_kernel<T><<<grid, kThreads, smem, stream>>>(u, d2xt, d2yt, d2zt,
                                                          bmask, y, nx, ny, nz, tj);
  return cudaGetLastError();
}


// ---- K3 -------------------------------------------------------------------

constexpr int kK3Consumers = 8;                      // consumer warps
constexpr int kK3Threads = 32 * (kK3Consumers + 1);  // and one producer warp
constexpr int kK3Cols = 64;  // columns of y one warp item covers: 8 lanes x 8

// K3's register tile: each thread owns kTM pencils x 8 columns of y, in
// 16-byte column chunks of kV values; a warp item is 4 lanes (one a
// quarter) x kTM pencils by 8 lanes x 8 columns.
template <typename T>
struct K3Tile {
  static constexpr int kV = 16 / int(sizeof(T));
  static constexpr int kTM = sizeof(T) == 4 ? 8 : 4;
};

// A stage holds one row tile as 4 quarters (the pencils a quarter: G =
// BM * pack / 4, a multiple of 8), each quarter a row of G pencils of npad
// values and a 16-byte pad: pencil r of quarter q sits at q * ldq + r * npad.
// The pad shifts each quarter by one bank group (4 in float64), so the 4
// pencils a warp reads at once, one from each quarter, never share a bank.
struct K3Shape {
  int npad;     // n rounded up to a multiple of 4: the k extent, DT's row stride
  int quarter;  // pencils a quarter, G
  int ldq;      // a quarter's stride, G * npad + 16 / sizeof(T)
  int stages;   // ring depth
  size_t stage_len;  // values a stage: BM * pack * (npad + 4), PR 2's tile
  size_t smem;  // bytes: two mbarriers a stage, DT, the stages
};

// The stage rule (mirrored by cuda_cheb.chebdiff_packed_stages): as many
// stages as fit beside DT, at most max_stages; 0 when not even one fits.
// A stage keeps the size of the single tile K3 had before its ring (the
// quarters use BM * pack * npad + 64 / sizeof(T) of it), so the shapes the
// kernel takes stay the same.
K3Shape k3_shape(int n, int pack, int bm, int max_stages, size_t itemsize) {
  K3Shape s;
  s.npad = (n + 3) / 4 * 4;
  s.quarter = bm * pack / 4;
  s.ldq = s.quarter * s.npad + int(16 / itemsize);
  s.stage_len = size_t(bm) * pack * (s.npad + 4);
  const size_t fixed = itemsize * size_t(s.npad) * s.npad;
  const size_t stage = itemsize * s.stage_len + 2 * sizeof(unsigned long long);
  const size_t fit = fixed < size_t(kMaxSmem) ? (size_t(kMaxSmem) - fixed) / stage : 0;
  s.stages = int(fit < size_t(max_stages) ? fit : size_t(max_stages));
  s.smem = fixed + size_t(s.stages) * stage;
  return s;
}

// 16 bytes: four floats (load4 / store4) or two doubles.
__device__ __forceinline__ void load16(const float* p, float v[4]) { load4(p, v); }
__device__ __forceinline__ void load16(const double* p, double v[2]) {
  const double2 q = *reinterpret_cast<const double2*>(p);
  v[0] = q.x; v[1] = q.y;
}
__device__ __forceinline__ void store16(float* p, const float v[4]) { store4(p, v); }
__device__ __forceinline__ void store16(double* p, const double v[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("{\n\t.reg .b64 state;\n\tmbarrier.arrive.shared::cta.b64 state, [%0];\n\t}\n"
               ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// Spin until the phase of parity `parity` has completed (on a new barrier,
// parity 1 counts as completed).
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}\n"
                 : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}
// The 1-D bulk (TMA) copy of `bytes` (a multiple of 16, both addresses
// 16-byte aligned) from global to shared memory, counted on `bar` as
// transaction bytes.
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src, unsigned bytes,
                                              unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// K3's register tile: acc[i][j] = sum_k a[i lda + k] * b[k ldb + col(j)]
// over k < npad (a multiple of 4), i < kTM, j < 8, col(j) = (j / kV) 8 kV
// + j % kV.  Each step of four k takes kTM loads of a (load4: one 16-byte
// load in float32, two in float64) and 4 x 8 / kV 16-byte loads of b: in
// float32 16 loads feed 256 FMAs.  Unless kFull, a chunk c with ok[c]
// false lies past DT's columns: it is not read and adds zero.
template <typename T, bool kFull>
__device__ __forceinline__ void pencil_tile(const T* a, int lda, const T* b, int ldb, int npad,
                                            const bool (&ok)[8 / K3Tile<T>::kV],
                                            T (&acc)[K3Tile<T>::kTM][8]) {
  constexpr int V = K3Tile<T>::kV, TM = K3Tile<T>::kTM;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = T(0);
  for (int k0 = 0; k0 < npad; k0 += 4) {
    T av[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i) load4(a + size_t(i) * lda + k0, av[i]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const T* bk = b + size_t(k0 + kk) * ldb;
      T bv[8];
#pragma unroll
      for (int c = 0; c < 8 / V; ++c) {
        if (kFull || ok[c]) {
          load16(bk + c * 8 * V, bv + c * V);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) bv[c * V + j] = T(0);
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fma(av[i][kk], bv[j], acc[i][j]);
    }
  }
}

// kBulk: the producer warp fills stages by bulk copies; otherwise it copies
// them with ordinary loads and stores (any n, any alignment of u).
template <typename T, int BM, bool kBulk>
__global__ void __launch_bounds__(kK3Threads, 1)
chebdiff_packed_kernel(const T* __restrict__ u, const T* __restrict__ dt, T* __restrict__ y,
                       long long M, int n, int pack, K3Shape s) {
  constexpr int V = K3Tile<T>::kV, TM = K3Tile<T>::kTM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem_raw);
  unsigned long long* empty = full + s.stages;
  T* dts = reinterpret_cast<T*>(empty + s.stages);  // npad x npad, zero beyond n
  T* ring = dts + size_t(s.npad) * s.npad;           // stages x stage_len
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int idx = tid; idx < s.npad * s.npad; idx += blockDim.x) {
    const int k = idx / s.npad, c = idx - k * s.npad;
    dts[idx] = (k < n && c < n) ? dt[size_t(k) * n + c] : T(0);
  }
  // the k padding of every pencil is zeroed once; no copy writes it
  const int kpad = s.npad - n, per_stage = 4 * s.quarter * kpad;
  for (int idx = tid; idx < s.stages * per_stage; idx += blockDim.x) {
    const int st = idx / per_stage, e = idx - st * per_stage, p = e / kpad;
    ring[st * s.stage_len + (p / s.quarter) * s.ldq + (p % s.quarter) * s.npad + n +
         e - p * kpad] = T(0);
  }
  if (tid == 0) {
    for (int st = 0; st < s.stages; ++st) {
      mbar_init(full + st, kBulk ? 1 : 32);
      mbar_init(empty + st, kK3Consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the last block-wide barrier: the roles part here

  const long long w = (long long)n * pack;  // elements a row of u and y
  const long long tiles = (M + BM - 1) / BM;
  int st = 0;
  unsigned phase = 0;
  if (warp == kK3Consumers) {  // the producer
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
      mbar_wait(empty + st, phase ^ 1);  // the first lap passes at once
      const long long row0 = t * BM;
      const int np = int(M - row0 < BM ? M - row0 : BM) * pack;
      const T* src = u + row0 * w;
      T* stage = ring + st * s.stage_len;
      if (kBulk) {  // npad == n: a quarter's pencils are contiguous in both memories
        if (lane == 0) mbar_arrive_expect_tx(full + st, unsigned(size_t(np) * n * sizeof(T)));
        __syncwarp();
        const int cnt = min(max(np - lane * s.quarter, 0), s.quarter);  // lane q: quarter q
        if (lane < 4 && cnt > 0)
          bulk_copy_g2s(stage + size_t(lane) * s.ldq, src + size_t(lane) * s.quarter * n,
                        unsigned(size_t(cnt) * n * sizeof(T)), full + st);
      } else {
        for (int e = lane; e < np * n; e += 32) {
          const int p = e / n;
          stage[(p / s.quarter) * s.ldq + (p % s.quarter) * s.npad + e - p * n] = src[e];
        }
        mbar_arrive(full + st);  // each lane, after its own stores
      }
      if (++st == s.stages) { st = 0; phase ^= 1; }
    }
    return;
  }

  const int ncb = (s.npad + kK3Cols - 1) / kK3Cols;  // column blocks
  const int items = s.quarter / TM * ncb;             // warp items a tile
  const int pl = lane & 3, cl = lane >> 2;            // lane: quarter, column chunk
  const bool vec_store =
      (n * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  int rot = 0;  // items of this block's earlier tiles, mod kK3Consumers
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    mbar_wait(full + st, phase);
    const long long row0 = t * BM;
    const int np = int(M - row0 < BM ? M - row0 : BM) * pack;
    const T* stage = ring + st * s.stage_len;
    T* yt = y + row0 * w;
    // item g of the block's stream goes to warp g % kK3Consumers
    for (int it = (warp - rot + kK3Consumers) % kK3Consumers; it < items; it += kK3Consumers) {
      const int pg = it / ncb, cb = it - pg * ncb;
      if (pg * TM >= np) continue;
      const int r0 = pg * TM;                  // this lane's pencils: r0 + i of quarter pl
      const int col0 = cb * kK3Cols + cl * V;  // this lane's chunks: col0 + 8 V c
      bool ok[8 / V];
#pragma unroll
      for (int c = 0; c < 8 / V; ++c) ok[c] = col0 + c * 8 * V < s.npad;
      const T* a = stage + size_t(pl) * s.ldq + size_t(r0) * s.npad;
      T acc[TM][8];
      if (ok[8 / V - 1])  // every chunk inside DT: always so at n = 64 and 128
        pencil_tile<T, true>(a, s.npad, dts + col0, s.npad, s.npad, ok, acc);
      else
        pencil_tile<T, false>(a, s.npad, dts + col0, s.npad, s.npad, ok, acc);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int p = pl * s.quarter + r0 + i;
        if (p >= np) continue;
        T* dst = yt + size_t(p) * n;
#pragma unroll
        for (int c = 0; c < 8 / V; ++c) {
          const int col = col0 + c * 8 * V;
          if (vec_store) {
            if (col < n) store16(dst + col, acc[i] + c * V);  // n % kV == 0: whole chunks
          } else {
#pragma unroll
            for (int j = 0; j < V; ++j)
              if (col + j < n) dst[col + j] = acc[i][c * V + j];
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);  // this warp is done reading the stage
    rot = (rot + items) % kK3Consumers;
    if (++st == s.stages) { st = 0; phase ^= 1; }
  }
}

template <typename T, int BM, bool kBulk>
cudaError_t launch_k3(const T* u, const T* dt, T* y, long long M, int n, int pack,
                      const K3Shape& s, cudaStream_t stream) {
  long long blocks = 0;
  const cudaError_t err = resident_blocks(
      reinterpret_cast<const void*>(chebdiff_packed_kernel<T, BM, kBulk>), kK3Threads, s.smem,
      &blocks);
  if (err != cudaSuccess) return err;
  const long long tiles = (M + BM - 1) / BM;
  if (blocks > tiles) blocks = tiles;
  chebdiff_packed_kernel<T, BM, kBulk><<<unsigned(blocks), kK3Threads, s.smem, stream>>>(
      u, dt, y, M, n, pack, s);
  return cudaGetLastError();
}

template <typename T, int BM>
cudaError_t launch_k3_rows(const T* u, const T* dt, T* y, long long M, int n, int pack,
                           int max_stages, cudaStream_t stream) {
  const K3Shape s = k3_shape(n, pack, BM, max_stages, sizeof(T));
  if (s.stages < 1) return cudaErrorInvalidValue;
  // a bulk copy takes whole quarters: n % 4 == 0 (so npad == n and the
  // quarters are 16-byte multiples) from a 16-byte aligned u
  const bool bulk = n % 4 == 0 && reinterpret_cast<uintptr_t>(u) % 16 == 0;
  return bulk ? launch_k3<T, BM, true>(u, dt, y, M, n, pack, s, stream)
              : launch_k3<T, BM, false>(u, dt, y, M, n, pack, s, stream);
}

template <typename T>
cudaError_t launch_chebdiff_packed(const T* u, const T* dt, T* y, long long M, int n,
                                   int pack, int block_rows, int max_stages,
                                   cudaStream_t stream) {
  if (n < 2 || pack < 1 || n * pack > 128 || M < 0 || max_stages < 1)
    return cudaErrorInvalidValue;
  if (M == 0) return cudaSuccess;
  switch (block_rows) {
    case 32: return launch_k3_rows<T, 32>(u, dt, y, M, n, pack, max_stages, stream);
    case 64: return launch_k3_rows<T, 64>(u, dt, y, M, n, pack, max_stages, stream);
    case 128: return launch_k3_rows<T, 128>(u, dt, y, M, n, pack, max_stages, stream);
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
                        int pack, int block_rows, int max_stages, void* stream) {
  return int(launch_chebdiff_packed(static_cast<const float*>(u), static_cast<const float*>(dt),
                                    static_cast<float*>(y), M, n, pack, block_rows, max_stages,
                                    static_cast<cudaStream_t>(stream)));
}

int chebdiff_packed_f64(const void* u, const void* dt, void* y, long long M, int n,
                        int pack, int block_rows, int max_stages, void* stream) {
  return int(launch_chebdiff_packed(static_cast<const double*>(u),
                                    static_cast<const double*>(dt), static_cast<double*>(y),
                                    M, n, pack, block_rows, max_stages,
                                    static_cast<cudaStream_t>(stream)));
}

const char* cheb_kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
