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
//   by cp.async while the current one computes, and DT and a block's first
//   tile land in one cp.async group, one round trip (other n take a
//   synchronous, zero-padded load).  Each thread owns a 4 x 4 register tile
//   of y and walks k four steps at a time: 8 16-byte shared loads (4 rows of
//   u, 4 rows of DT) feed 64 FMAs.  The ragged row tail is masked, not padded.
//   Small M (the solves' 64^3, 32^3, 12^5): where full tiles would leave
//   resident blocks empty, each block takes one tile, as high as gives the
//   busiest SM the fewest rows (least_busy_rows; 128 tiles of 32 rows at
//   64^3, of 8 at 32^3, 130 of 160 at 12^5), so the product spreads over
//   the SMs.  There a call is latency: one load round trip, then 1024 FMAs
//   (float64: at half rate) a thread with one warp a scheduler.  Large M
//   keeps the persistent grid of full tiles.
//   Largest n: K1_MAX_N = 128 (DT is 128 KB in float64).
//
// K2 laplacian3d_kernel    (replaces spectral_tpu/ops/pallas_cheb.py::laplacian3d_pallas)
//   y = -(D2x u + D2y u + D2z u) on an (nx, ny, nz) field, D2 = s (D @ D)
//   precombined in float64; with bmask, y = where(bmask, u, y) in the
//   epilogue.  The TPU kernel keeps the whole field in VMEM; a 64^3 field
//   (1 MiB in float32, 2 MiB in float64) does not fit the 227 KB of shared
//   memory a block may use.  Bound: 6n FLOP a point against 8 (16) bytes of
//   device traffic; at 64^3 the FMAs bind (0.0015 ms float32), and every
//   line of u has to meet its operator in shared memory.  Design: two
//   passes, each a set of small products in K1's 4 x 4 register tile
//   (micro_tile), launched by one C call on the caller's stream:
//   - the plane pass (y and z): block (i, p) stages the plane u[i] (rows
//     padded to nz + 4), D2z^T and its rows of D2y, and computes
//     t[i, j, :] = u[i, j, :] D2z^T + D2y[j, :] u[i] for its rows j, both
//     terms accumulated in one register tile (micro_tile's kAccumulate);
//     the z term's operands land first, the rest during it;
//   - the x pass: on the (nx, ny nz) views, block (q, p) stages D2x's rows
//     and u's columns c0 .. c0 + 32 in chunks of 64 x values, starts its
//     tile from t, accumulates D2x u and stores -(t + D2x u), or u where
//     bmask; 16-byte loads and stores where ny nz % 4 == 0, the ragged tail
//     masked.  It is launched by programmatic dependent launch: its blocks
//     start beside the plane pass's (whose kernel asks for the largest
//     shared-memory carveout, so they fit) and stage D2x and u before they
//     wait for t.
//   Every staging copy is a cp.async, 16 bytes where rows are 16-byte
//   multiples, else one element, zero-filling the padding.  Both passes
//   size their blocks by least_busy_rows (at 64^3: 128 blocks each).  FMA
//   pipes only, no tensor cores.  Limit: the plane pass with 4 rows a block,
//   (nzp^2 + nyp (nzp + 4) + 4 (nyp + 4)) * sizeof(T) <= 227 KB, nyp and nzp
//   ny and nz rounded up to multiples of 4 (64^3 in float64 takes 70 KB).
//   A plane that does not fit so is staged unpadded, one output point a
//   thread (plane_unpadded), with (nz^2 + ny nz + ny) * sizeof(T) <= 227 KB
//   at one row a block: every field the single-pass K2 took is taken
//   (cuda_cheb's tests check the rule), and 128^3 in float64 is refused.

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

#include <algorithm>
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

// rg row groups a tile; 0 takes the most the block's threads hold.
K1Shape k1_shape(int n, int rg = 0) {
  K1Shape s;
  s.npad = (n + 3) / 4 * 4;
  s.ncg = s.npad / kTN;
  s.rg = rg > 0 ? rg : kThreads / s.ncg;
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

// The register tile of K1 and K2: acc[i][j] = sum_k a[i * lda + k] * b[k * ldb + j]
// over k < npad (a multiple of 4), i < kTM, j < kTN; with kAccumulate the sum
// is added to acc as it stands, in the same order.  Each step of four k
// takes 8 16-byte shared loads (4 rows of a, 4 rows of b) and does 64 FMAs.
template <typename T, bool kAccumulate = false>
__device__ __forceinline__ void micro_tile(const T* a, int lda, const T* b, int ldb, int npad,
                                           T acc[kTM][kTN]) {
  if (!kAccumulate) {
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = T(0);
  }
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// The same copies, zero-filling the destination where !valid (no bytes read).
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(s), "l"(gmem), "r"(valid ? 16 : 0) : "memory");
}
// One element (4 or 8 bytes), for layouts 16-byte copies cannot take.
template <typename T>
__device__ __forceinline__ void cp_async_elem_zfill(T* smem, const T* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               ::"r"(s), "l"(gmem), "n"(int(sizeof(T))), "r"(valid ? int(sizeof(T)) : 0)
               : "memory");
}

// Programmatic dependent launch (sm_90): a kernel launched after this one
// with programmatic stream serialization may start once every block here
// has called launch_dependents (or exited); it calls grid_dependency_wait
// before it reads what this kernel writes.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Issue the copies of one row tile into ``buf`` (the caller commits):
// 16-byte chunks, rows past the end are skipped (their accumulators are
// never stored).  Needs n % 4 == 0 and a 16-byte aligned u, so chunks
// never straddle rows.
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

  const long long tiles = (M + s.bm - 1) / s.bm;  // the grid takes at most this many blocks
  if (kAsync) {  // n == npad: DT and the first tile in one group, one round trip
    constexpr int CH = 16 / sizeof(T);
    for (int c = tid; c < n * n / CH; c += kThreads) cp_async16(dts + c * CH, dt + c * CH);
    issue_tile(ubase, u, M, n, s, blockIdx.x);
    cp_async_commit();
  } else {
    for (int idx = tid; idx < s.npad * s.npad; idx += blockDim.x) {
      const int k = idx / s.npad, c = idx - k * s.npad;
      dts[idx] = (k < n && c < n) ? dt[size_t(k) * n + c] : T(0);
    }
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
        cp_async_commit();
        cp_async_wait_prior();  // this tile's copies (this thread's) have landed
      } else {
        cp_async_wait_all();  // the block's last tile: nothing to prefetch
      }
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

// The card's SM count, read once per device.
cudaError_t sm_count(int* sms) {
  static std::mutex mu;
  static std::map<int, int> cache;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> lock(mu);
  const auto hit = cache.find(dev);
  if (hit != cache.end()) {
    *sms = hit->second;
    return cudaSuccess;
  }
  if ((err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  cache.emplace(dev, *sms);
  return cudaSuccess;
}

// Launch set-up shared by every launcher, done once per (device, kernel,
// dynamic shared memory bytes): raise the kernel's dynamic shared memory
// limit (never lowering it below a size an earlier launch needed) and
// return in *blocks how many blocks of `threads` the card holds at once
// (SM count x occupancy), the size of a persistent grid.  Later launches
// read the cache under a lock (ctypes calls release the interpreter lock).
// With max_shared, the kernel also asks for the SM's largest shared-memory
// carveout, so blocks of another kernel that start beside its own (K2's x
// pass beside its plane pass) find room on every SM.
cudaError_t resident_blocks(const void* kernel, int threads, size_t smem, long long* blocks,
                            bool max_shared = false) {
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
  if (max_shared &&
      (err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                  int(cudaSharedmemCarveoutMaxShared))) != cudaSuccess)
    return err;
  int sms = 0, per_sm = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return err;
  *blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  cache.emplace(key, *blocks);
  return cudaSuccess;
}

// The rows a tile, a multiple of 4 from 4 to `most`, that give the busiest
// SM the fewest rows when `copies` x ceil(extent / rows) tiles are dealt
// round-robin over `sms` SMs; the larger on a tie (fewer blocks, fewer
// copies of what every block stages).  K1 at 64^3 takes 128 tiles of 32
// rows: tiles of 28 would cover all 132 SMs but put two on 15 of them.
int least_busy_rows(long long extent, long long copies, int most, int sms) {
  int best = most;
  long long best_rows = -1;
  for (int rows = most; rows >= 4; rows -= 4) {
    const long long tiles = copies * ((extent + rows - 1) / rows);
    const long long busiest = (tiles + sms - 1) / sms * rows;
    if (best_rows < 0 || busiest < best_rows) {
      best = rows;
      best_rows = busiest;
    }
  }
  return best;
}

template <typename T, bool kAsync>
size_t k1_smem(const K1Shape& s) {
  return sizeof(T) * (size_t(s.npad) * s.npad + (kAsync ? 2 : 1) * size_t(s.bm) * s.ldu);
}

// K1's launch configuration: a persistent grid of full tiles where M fills
// the resident slots (the configuration K1 has always had there);
// otherwise one tile a block, as high as least_busy_rows finds.
template <typename T, bool kAsync>
cudaError_t k1_config(long long M, int n, K1Shape* s, size_t* smem, long long* blocks) {
  const void* kernel = reinterpret_cast<const void*>(chebdiff_last_kernel<T, kAsync>);
  *s = k1_shape(n);
  *smem = k1_smem<T, kAsync>(*s);
  if (*smem > size_t(kMaxSmem)) return cudaErrorInvalidValue;
  cudaError_t err = resident_blocks(kernel, kThreads, *smem, blocks);
  if (err != cudaSuccess) return err;
  long long tiles = (M + s->bm - 1) / s->bm;
  if (tiles < *blocks) {
    int sms = 0;
    if ((err = sm_count(&sms)) != cudaSuccess) return err;
    *s = k1_shape(n, least_busy_rows(M, 1, s->bm, sms) / kTM);
    *smem = k1_smem<T, kAsync>(*s);
    if ((err = resident_blocks(kernel, kThreads, *smem, blocks)) != cudaSuccess) return err;
    tiles = (M + s->bm - 1) / s->bm;
  }
  if (*blocks > tiles) *blocks = tiles;
  return cudaSuccess;
}

template <typename T, bool kAsync>
cudaError_t launch_k1(const T* u, const T* dt, T* y, long long M, int n, cudaStream_t stream) {
  K1Shape s;
  size_t smem = 0;
  long long blocks = 0;
  const cudaError_t err = k1_config<T, kAsync>(M, n, &s, &smem, &blocks);
  if (err != cudaSuccess) return err;
  chebdiff_last_kernel<T, kAsync><<<unsigned(blocks), kThreads, smem, stream>>>(u, dt, y, M, n, s);
  return cudaGetLastError();
}

// Tiles go by cp.async when n % 4 == 0 and u and DT are 16-byte aligned.
template <typename T>
bool k1_async(const T* u, const T* dt, int n) {
  return n % 4 == 0 && reinterpret_cast<uintptr_t>(u) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(dt) % 16 == 0;
}

template <typename T>
cudaError_t launch_chebdiff_last(const T* u, const T* dt, T* y, long long M,
                                 int n, cudaStream_t stream) {
  if (n < 2 || n > 128 || M < 0) return cudaErrorInvalidValue;
  if (M == 0) return cudaSuccess;
  return k1_async(u, dt, n) ? launch_k1<T, true>(u, dt, y, M, n, stream)
                            : launch_k1<T, false>(u, dt, y, M, n, stream);
}

// What launch_chebdiff_last would launch, into out[4]: rows a tile, blocks,
// threads a block, dynamic shared memory bytes.
template <typename T>
cudaError_t chebdiff_last_config(const T* u, const T* dt, long long M, int n, long long* out) {
  if (n < 2 || n > 128 || M < 1) return cudaErrorInvalidValue;
  K1Shape s{};
  size_t smem = 0;
  long long blocks = 0;
  const cudaError_t err = k1_async(u, dt, n) ? k1_config<T, true>(M, n, &s, &smem, &blocks)
                                             : k1_config<T, false>(M, n, &s, &smem, &blocks);
  out[0] = s.bm;
  out[1] = blocks;
  out[2] = kThreads;
  out[3] = (long long)smem;
  return err;
}

// ---- K2 -------------------------------------------------------------------

constexpr int kK2AThreads = 256;  // plane pass: all stage, (ra / 4) x (nzpad / 4) compute
constexpr int kK2BThreads = 128;  // x pass: (rb / 4) x (kK2Cols / 4)
constexpr int kK2Cols = 32;       // columns of the (nx, ny * nz) view an x-pass block owns
constexpr int kK2Chunk = 64;      // x values an x-pass step stages
constexpr int kK2MaxRows = 64;    // rows i an x-pass block owns, at most

struct K2Shape {
  int nypad, nzpad;  // ny, nz rounded up to multiples of 4: the y and z contraction extents
  int ldp;           // plane row stride, nzpad + 4
  int ldy;           // D2y row stride, nypad + 4
  bool tiled;        // plane pass: register tiles on padded rows, or one point a thread
  int ra;            // plane pass: rows j a block (tiled: a multiple of 4)
  int rb;            // x pass: rows i a block (a multiple of 4)
  int kc;            // x pass: x values a step (a multiple of 4)
  size_t smem_a, smem_b;  // bytes a block of each pass
};

// The plane pass's shared memory in values: D2zT, the plane, ra rows of
// D2y; tiled, padded as K2Shape says, else unpadded.  Mirrored, at the
// least rows a block (4 tiled, 1 unpadded), by cuda_cheb.laplacian3d_smem_bytes.
size_t k2_plane_values(int nypad, int nzpad, int ra) {
  return size_t(nzpad) * nzpad + size_t(nypad) * (nzpad + 4) + size_t(ra) * (nypad + 4);
}
size_t k2_plane_values_unpadded(int ny, int nz, int ra) {
  return size_t(nz) * nz + size_t(ny) * nz + size_t(ra) * ny;
}

// Each pass's rows a block.  The plane pass is tiled where 4 rows of the
// padded layout fit, and splits each plane's ny rows by least_busy_rows (at
// most what its threads and shared memory hold); otherwise it stages the
// plane unpadded, min(ny, 1024 / nz) rows a block as the single-pass K2
// took, fewer where they do not fit, and the field is refused if one row
// does not.  So it takes every field the single pass took (a field of
// nz = 118 in float64 needs 238,208 bytes tiled).  The x pass splits the nx
// rows of each column tile by least_busy_rows.  At 64^3 on 132 SMs: 64 x 2
// tiled blocks of 32 rows j, and 128 column tiles x 64 rows i.
K2Shape k2_shape(int nx, int ny, int nz, size_t itemsize, int sms) {
  K2Shape s;
  s.nypad = (ny + 3) / 4 * 4;
  s.nzpad = (nz + 3) / 4 * 4;
  s.ldp = s.nzpad + 4;
  s.ldy = s.nypad + 4;
  s.tiled = itemsize * k2_plane_values(s.nypad, s.nzpad, 4) <= size_t(kMaxSmem);
  if (s.tiled) {
    int most = std::min(kK2AThreads / (s.nzpad / kTN) * kTM, s.nypad);  // the block's threads
    while (most > 4 && itemsize * k2_plane_values(s.nypad, s.nzpad, most) > size_t(kMaxSmem))
      most -= 4;
    s.ra = least_busy_rows(ny, nx, std::max(most, 4), sms);
    s.smem_a = itemsize * k2_plane_values(s.nypad, s.nzpad, s.ra);
  } else {
    s.ra = std::max(1, std::min(ny, 1024 / nz));
    while (s.ra > 1 && itemsize * k2_plane_values_unpadded(ny, nz, s.ra) > size_t(kMaxSmem))
      --s.ra;
    s.smem_a = itemsize * k2_plane_values_unpadded(ny, nz, s.ra);
  }
  const long long ctiles = ((long long)ny * nz + kK2Cols - 1) / kK2Cols;
  s.rb = least_busy_rows(nx, ctiles, std::min((nx + 3) / 4 * 4, kK2MaxRows), sms);
  s.kc = std::min((nx + 3) / 4 * 4, kK2Chunk);
  s.smem_b = itemsize * (size_t(s.rb) * (s.kc + 4) + size_t(s.kc) * kK2Cols);
  return s;
}

// Stage a rows x cols block of src (row stride lds) into dst (row stride
// ldd), zero-filled out to rpad x cpad, by cp.async; the caller commits and
// waits.  With vec (cols and cpad multiples of 16 bytes, src rows 16-byte
// aligned) in 16-byte copies, else one element a copy.
template <typename T, int kNT>
__device__ __forceinline__ void stage_async(T* dst, int ldd, const T* __restrict__ src,
                                            long long lds, int rows, int cols, int rpad,
                                            int cpad, bool vec) {
  const int V = vec ? 16 / int(sizeof(T)) : 1;
  const int cw = cpad / V;
  for (int e = threadIdx.x; e < rpad * cw; e += kNT) {
    const int r = e / cw, c = (e - r * cw) * V;
    const bool ok = r < rows && c < cols;
    const T* from = ok ? src + r * lds + c : src;
    if (vec)
      cp_async16_zfill(dst + r * ldd + c, from, ok);
    else
      cp_async_elem_zfill(dst + r * ldd + c, from, ok);
  }
}

// Pass A, the plane pass: block (i, p) computes rows j0 .. j0 + ra of the
// plane i of t = D2z u + D2y u.  Tiled: both terms in one 4 x 4 register
// tile per thread.  vec_z: 16-byte copies of the plane and D2zT (nz a
// multiple of 16 bytes, u and d2zt aligned); vec_y: of the rows of D2y.
template <typename T>
__device__ __forceinline__ void plane_tiled(T* dzt, const T* __restrict__ u,
                                            const T* __restrict__ d2y,
                                            const T* __restrict__ d2zt, T* __restrict__ t,
                                            int ny, int nz, const K2Shape& s, bool vec_z,
                                            bool vec_y) {
  // dzt: D2zT[a, k]                                                     nzpad x nzpad
  T* plane = dzt + size_t(s.nzpad) * s.nzpad;  // u[i, a, k]           nypad x ldp
  T* dy = plane + size_t(s.nypad) * s.ldp;     // D2y[j0 + jl, a]      ra x ldy
  const int i = blockIdx.x, j0 = blockIdx.y * s.ra;
  const size_t pstride = size_t(ny) * nz;
  const T* ui = u + i * pstride;
  // two groups: what the z term reads (D2zT, the block's own rows of the
  // plane), then the rest of the plane and D2y, which land during the z term
  const int j1 = min(j0 + s.ra, s.nypad);  // own rows j0 .. j1 (padded rows zeroed)
  stage_async<T, kK2AThreads>(dzt, s.nzpad, d2zt, nz, nz, nz, s.nzpad, s.nzpad, vec_z);
  stage_async<T, kK2AThreads>(plane + size_t(j0) * s.ldp, s.ldp, ui + size_t(j0) * nz, nz,
                              min(j1, ny) - j0, nz, j1 - j0, s.nzpad, vec_z);
  cp_async_commit();
  stage_async<T, kK2AThreads>(plane, s.ldp, ui, nz, j0, nz, j0, s.nzpad, vec_z);
  stage_async<T, kK2AThreads>(plane + size_t(j1) * s.ldp, s.ldp, ui + size_t(j1) * nz, nz,
                              max(ny - j1, 0), nz, s.nypad - j1, s.nzpad, vec_z);
  stage_async<T, kK2AThreads>(dy, s.ldy, d2y + size_t(j0) * ny, ny, min(s.ra, ny - j0), ny,
                              s.ra, s.nypad, vec_y);
  cp_async_commit();

  const int ncg = s.nzpad / kTN;
  const int cg = threadIdx.x % ncg, rgi = threadIdx.x / ncg;
  const int jl = rgi * kTM, j = j0 + jl;
  const bool active = rgi < s.ra / kTM && j < ny;
  T acc[kTM][kTN];
  cp_async_wait_prior();
  __syncthreads();  // the first group has landed, from every thread
  if (active)
    micro_tile<T>(plane + size_t(j) * s.ldp, s.ldp, dzt + cg * kTN, s.nzpad, s.nzpad, acc);
  cp_async_wait_all();
  __syncthreads();
  if (!active) return;
  micro_tile<T, true>(dy + size_t(jl) * s.ldy, s.ldy, plane + cg * kTN, s.ldp, s.nypad, acc);
  const int k = cg * kTN;
#pragma unroll
  for (int r = 0; r < kTM; ++r) {
    if (j + r >= ny) break;
    T* dst = t + i * pstride + size_t(j + r) * nz + k;
    if (nz % 4 == 0) {
      store4(dst, acc[r]);  // k + 3 < nz
    } else {
#pragma unroll
      for (int c = 0; c < kTN; ++c)
        if (k + c < nz) dst[c] = acc[r][c];
    }
  }
}

// Unpadded, for planes whose padded layout does not fit: D2zT, the plane and
// the block's rows of D2y staged as they lie in memory, one element a copy,
// and one output point a thread at a time.
template <typename T>
__device__ __forceinline__ void plane_unpadded(T* dzt, const T* __restrict__ u,
                                               const T* __restrict__ d2y,
                                               const T* __restrict__ d2zt, T* __restrict__ t,
                                               int ny, int nz, int ra) {
  T* plane = dzt + size_t(nz) * nz;          // u[i, a, k]         ny x nz
  T* dy = plane + size_t(ny) * nz;           // D2y[j0 + jl, a]    ra x ny
  const int i = blockIdx.x, j0 = blockIdx.y * ra, rows = min(ra, ny - j0);
  const size_t pstride = size_t(ny) * nz;
  stage_async<T, kK2AThreads>(dzt, nz, d2zt, nz, nz, nz, nz, nz, false);
  stage_async<T, kK2AThreads>(plane, nz, u + i * pstride, nz, ny, nz, ny, nz, false);
  stage_async<T, kK2AThreads>(dy, ny, d2y + size_t(j0) * ny, ny, rows, ny, rows, ny, false);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  for (int p = threadIdx.x; p < rows * nz; p += kK2AThreads) {
    const int jl = p / nz, k = p - jl * nz;
    const T* row = plane + size_t(j0 + jl) * nz;
    const T* dyr = dy + size_t(jl) * ny;
    T acc = T(0);
    for (int a = 0; a < nz; ++a) acc = fma(row[a], dzt[size_t(a) * nz + k], acc);
    for (int a = 0; a < ny; ++a) acc = fma(dyr[a], plane[size_t(a) * nz + k], acc);
    t[i * pstride + size_t(j0 + jl) * nz + k] = acc;
  }
}

template <typename T, bool kTiled>
__global__ void __launch_bounds__(kK2AThreads)
laplacian3d_plane_kernel(const T* __restrict__ u, const T* __restrict__ d2y,
                         const T* __restrict__ d2zt, T* __restrict__ t, int ny, int nz,
                         K2Shape s, bool vec_z, bool vec_y) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  launch_dependents();  // the x pass's blocks may start staging what is not t
  if constexpr (kTiled)
    plane_tiled(reinterpret_cast<T*>(smem_raw), u, d2y, d2zt, t, ny, nz, s, vec_z, vec_y);
  else
    plane_unpadded(reinterpret_cast<T*>(smem_raw), u, d2y, d2zt, t, ny, nz, s.ra);
}

// Pass B, the x pass with the epilogue, on the (nx, ncol = ny * nz) views:
// block (q, p) owns rows i0 .. i0 + rb and columns c0 .. c0 + kK2Cols.  Its
// threads start from t, add D2x u one chunk of kc x values at a time in the
// same register tile, and store y = -(t + D2x u), or u where bmask.  vec:
// ncol % 4 == 0 and u, t, y 16-byte aligned (16-byte copies, loads, stores);
// vec_x: 16-byte copies of D2x (nx a multiple of 16 bytes, d2x aligned).
template <typename T>
__global__ void __launch_bounds__(kK2BThreads)
laplacian3d_x_kernel(const T* __restrict__ u, const T* __restrict__ d2x,
                     const bool* __restrict__ bmask, const T* __restrict__ t,
                     T* __restrict__ y, int nx, long long ncol, K2Shape s, bool vec,
                     bool vec_x) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* dx = reinterpret_cast<T*>(smem_raw);      // D2x[i0 + r, a0 + a]  rb x (kc + 4)
  T* ut = dx + size_t(s.rb) * (s.kc + 4);      // u[a0 + a, c0 + c]    kc x kK2Cols
  const long long c0 = (long long)blockIdx.x * kK2Cols;
  const int i0 = blockIdx.y * s.rb;
  const int cg = threadIdx.x % (kK2Cols / kTN), rgi = threadIdx.x / (kK2Cols / kTN);
  const int il = rgi * kTM, i = i0 + il;
  const long long c = c0 + cg * kTN;
  const bool active = rgi < s.rb / kTM && i < nx;
  const int cols = int(ncol - c0 < kK2Cols ? ncol - c0 : kK2Cols);

  // bmask for the epilogue loads while the first chunk stages (bit 4 r + q:
  // row i + r, column c + q); t only after the plane pass has completed
  T acc[kTM][kTN];
  unsigned bits = 0;
  const bool vrow = vec && c < ncol;  // ncol % 4 == 0, so c + 3 < ncol
  if (active && bmask != nullptr) {
#pragma unroll
    for (int r = 0; r < kTM; ++r)
#pragma unroll
      for (int q = 0; q < kTN; ++q)
        if (i + r < nx && c + q < ncol && bmask[size_t(i + r) * ncol + c + q])
          bits |= 1u << (r * kTN + q);
  }
  for (int a0 = 0; a0 < nx; a0 += s.kc) {
    if (a0 > 0) __syncthreads();  // every thread is done with the last chunk
    const int ka = min(s.kc, nx - a0);
    stage_async<T, kK2BThreads>(dx, s.kc + 4, d2x + size_t(i0) * nx + a0, nx,
                                min(s.rb, nx - i0), ka, s.rb, s.kc, vec_x);
    stage_async<T, kK2BThreads>(ut, kK2Cols, u + size_t(a0) * ncol + c0, ncol, ka, cols,
                                s.kc, kK2Cols, vec);
    cp_async_commit();
    if (a0 == 0) {
      grid_dependency_wait();
      if (active) {
#pragma unroll
        for (int r = 0; r < kTM; ++r) {
          const size_t o = size_t(i + r) * ncol + c;
          if (vrow && i + r < nx) {
            load4(t + o, acc[r]);
          } else {
#pragma unroll
            for (int q = 0; q < kTN; ++q)
              acc[r][q] = i + r < nx && c + q < ncol ? t[o + q] : T(0);
          }
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();
    if (active)
      micro_tile<T, true>(dx + size_t(il) * (s.kc + 4), s.kc + 4, ut + cg * kTN, kK2Cols, s.kc,
                          acc);
  }
  if (!active || c >= ncol) return;
#pragma unroll
  for (int r = 0; r < kTM; ++r) {
    if (i + r >= nx) break;
    const size_t o = size_t(i + r) * ncol + c;
    T v[kTN];
#pragma unroll
    for (int q = 0; q < kTN; ++q) v[q] = (bits >> (r * kTN + q)) & 1u ? u[o + q] : -acc[r][q];
    if (vec) {  // ncol % 4 == 0, so c + 3 < ncol
      store4(y + o, v);
    } else {
#pragma unroll
      for (int q = 0; q < kTN; ++q)
        if (c + q < ncol) y[o + q] = v[q];
    }
  }
}

template <typename T>
bool aligned16(const T* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// What launch_laplacian3d would launch, into out[9]: for the plane pass and
// then the x pass, rows a block, blocks, threads a block, dynamic shared
// memory bytes; then 1 where the plane pass is tiled, else 0.
template <typename T>
cudaError_t laplacian3d_config(int nx, int ny, int nz, long long* out) {
  if (nx < 1 || ny < 1 || nz < 1) return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const K2Shape s = k2_shape(nx, ny, nz, sizeof(T), sms);
  const long long ncol = (long long)ny * nz;
  const long long v[9] = {s.ra, (long long)nx * ((ny + s.ra - 1) / s.ra), kK2AThreads,
                          (long long)s.smem_a, s.rb,
                          (ncol + kK2Cols - 1) / kK2Cols * ((nx + s.rb - 1) / s.rb),
                          kK2BThreads, (long long)s.smem_b, s.tiled ? 1 : 0};
  for (int k = 0; k < 9; ++k) out[k] = v[k];
  return cudaSuccess;
}

// Both passes on the caller's stream, the plane pass writing t, the x pass
// reading it.
template <typename T>
cudaError_t launch_laplacian3d(const T* u, const T* d2x, const T* d2y, const T* d2zt,
                               const bool* bmask, T* t, T* y, int nx, int ny, int nz,
                               cudaStream_t stream) {
  if (nx < 1 || ny < 1 || nz < 1) return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const K2Shape s = k2_shape(nx, ny, nz, sizeof(T), sms);
  if (s.smem_a > size_t(kMaxSmem) || s.smem_b > size_t(kMaxSmem)) return cudaErrorInvalidValue;
  // K2's grids follow the field; this sets the smem limits and carveouts once
  long long resident = 0;
  const void* plane = s.tiled ? reinterpret_cast<const void*>(laplacian3d_plane_kernel<T, true>)
                              : reinterpret_cast<const void*>(laplacian3d_plane_kernel<T, false>);
  if ((err = resident_blocks(plane, kK2AThreads, s.smem_a, &resident, true)) != cudaSuccess)
    return err;
  if ((err = resident_blocks(reinterpret_cast<const void*>(laplacian3d_x_kernel<T>),
                             kK2BThreads, s.smem_b, &resident, true)) != cudaSuccess)
    return err;
  constexpr int V = 16 / sizeof(T);
  const dim3 grid_a(nx, (ny + s.ra - 1) / s.ra);
  const bool vec_z = nz % V == 0 && aligned16(u) && aligned16(d2zt);
  const bool vec_y = ny % V == 0 && aligned16(d2y);
  if (s.tiled)
    laplacian3d_plane_kernel<T, true><<<grid_a, kK2AThreads, s.smem_a, stream>>>(
        u, d2y, d2zt, t, ny, nz, s, vec_z, vec_y);
  else
    laplacian3d_plane_kernel<T, false><<<grid_a, kK2AThreads, s.smem_a, stream>>>(
        u, d2y, d2zt, t, ny, nz, s, vec_z, vec_y);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // the x pass by programmatic dependent launch: its blocks start once every
  // plane-pass block has, and stage D2x and u before they wait for t
  const long long ncol = (long long)ny * nz;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned((ncol + kK2Cols - 1) / kK2Cols), (nx + s.rb - 1) / s.rb);
  cfg.blockDim = dim3(kK2BThreads);
  cfg.dynamicSmemBytes = s.smem_b;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const T* tc = t;
  return cudaLaunchKernelEx(&cfg, laplacian3d_x_kernel<T>, u, d2x, bmask, tc, y, nx, ncol, s,
                            ncol % 4 == 0 && aligned16(u) && aligned16(t) && aligned16(y),
                            nx % V == 0 && aligned16(d2x));
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

// d2x, d2y: s (D @ D) row-major; d2zt: its transpose.  t: scratch of u's
// size, 16-byte aligned, written by the plane pass and read by the x pass.
int laplacian3d_f32(const void* u, const void* d2x, const void* d2y, const void* d2zt,
                    const void* bmask, void* t, void* y, int nx, int ny, int nz, void* stream) {
  return int(launch_laplacian3d(static_cast<const float*>(u), static_cast<const float*>(d2x),
                                static_cast<const float*>(d2y), static_cast<const float*>(d2zt),
                                static_cast<const bool*>(bmask), static_cast<float*>(t),
                                static_cast<float*>(y), nx, ny, nz,
                                static_cast<cudaStream_t>(stream)));
}

int laplacian3d_f64(const void* u, const void* d2x, const void* d2y, const void* d2zt,
                    const void* bmask, void* t, void* y, int nx, int ny, int nz, void* stream) {
  return int(launch_laplacian3d(static_cast<const double*>(u), static_cast<const double*>(d2x),
                                static_cast<const double*>(d2y), static_cast<const double*>(d2zt),
                                static_cast<const bool*>(bmask), static_cast<double*>(t),
                                static_cast<double*>(y), nx, ny, nz,
                                static_cast<cudaStream_t>(stream)));
}

int chebdiff_last_config_f32(const void* u, const void* dt, long long M, int n,
                             long long* out) {
  return int(chebdiff_last_config(static_cast<const float*>(u), static_cast<const float*>(dt),
                                  M, n, out));
}

int chebdiff_last_config_f64(const void* u, const void* dt, long long M, int n,
                             long long* out) {
  return int(chebdiff_last_config(static_cast<const double*>(u), static_cast<const double*>(dt),
                                  M, n, out));
}

int laplacian3d_config_f32(int nx, int ny, int nz, long long* out) {
  return int(laplacian3d_config<float>(nx, ny, nz, out));
}

int laplacian3d_config_f64(int nx, int ny, int nz, long long* out) {
  return int(laplacian3d_config<double>(nx, ny, nz, out));
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
