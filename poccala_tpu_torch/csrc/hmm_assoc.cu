// The (logsumexp, +) semiring product for Hopper (sm_90a), CUDA C++: the
// combine of the time-parallel forward algorithm.
//
// Replaces the combine of poccala_tpu/ops/hmm.py:forward_log_assoc (:163),
// which jax.lax.associative_scan applies level by level, and its tail (the
// row of alpha_0 through every prefix product).  Not a Pallas kernel: the
// JAX package leaves both to XLA, which materialises the [P, N, N, N] sums
// of a level (~30 GB at T = 16,000, N = 98).  No library has this product:
// cuBLAS and cuDNN multiply over (+, x).
//
//   product:  C[p, i, j] = max(LSE_k(A[p, i, k] + B[p, k, j]), NEG_INF)
//   rows:     c[p, j]    = max(LSE_k(a[p, k] + B[p, k, j]), NEG_INF)
//
// LSE is JAX's: m = max_k x_k (0 where m is not finite), then
// log(sum_k exp(x_k - m)) + m, the sum in ascending k, expf and logf of
// the library (no fast math), the clamp at NEG_INF = -1e30 last.  A[p] is
// row-major [M, K] at a + p sa, B[p] [K, N] at b + p sb, C[p] [M, N] at
// c + p sc: a level's strided slices and the interleaved output are views,
// so the scan copies nothing between levels.
//
// Dead entries.  An operand entry x is dead when x <= NEG_INF (-inf too; a
// NaN is live).  The operators M_t[i, j] = log_A[i, j] + log_b[t, j] are a
// left-to-right band made dense, so a product of 2^l of them is a band of
// width ~4 2^l + 1 above the diagonal and, past ~32 frames, an upper
// triangle; every other entry is NEG_INF after the clamp.  A term with a
// dead operand is skipped: both kernels sum only the k that a live entry
// of each operand can reach, and the result is bit for bit that of the
// dense sum over every k (tests/cuda_emu/hmm_assoc_parent.cu) wherever
// every finite live entry is below 2^75 (~3.8e22, half an ulp of 1e30) and
// none is +inf.  Then a term d + v with d dead and v not NaN rounds to
// <= NEG_INF: it never exceeds a term of two live operands, so the max m is
// unchanged where the output has such a term, and it adds expf(<= NEG_INF
// - m) = 0.0f to the sum, which changes no bit; where no term has two live
// operands the dense sum's m is <= NEG_INF too, and both outputs clamp to
// NEG_INF (log(0) + m = -inf where nothing is summed).  A NaN entry makes
// every term it enters NaN, whatever the other operand, and with it the
// dense sum: the ranges also take in the k of every NaN (the row form
// reads the rows outside its range for them), so those outputs are NaN
// here too.  Log-probabilities are ~1e6.
//
// What bounds it.  The dense product of N x N matrices takes N^3 terms of
// an add and a max (pass 1) and an add, a subtraction, an exponential and a
// sum add (pass 2); an H100 issues 16 exponentials a cycle an SM, and the
// library's expf is ~8 instructions around its MUFU.EX2, so the dense
// product is bound by the issue of pass 2.  Skipping dead terms leaves
// ~1/28 of them at N = 98 (the live terms of the scan over a full band of
// width 5), and the product becomes bound by its bytes: two operands read
// and one result written, 3 N^2 floats a product.
//
// The design.  Each warp owns a 32 x 4 output tile of one p: lane (lr, lc)
// = (lane / 4, lane % 4) the rows lr, lr + 8, lr + 16, lr + 24 of column
// lc, so a B element read from shared memory serves 4 outputs and an A
// element is a broadcast to 4 lanes (the 8 rows a load reads lie in 8
// banks unless K is a multiple of 8).  The tile's k-range is the
// intersection of its A rows' live columns and its B columns' live rows
// (the first and last live k of its 32-row group and 4-column group, found
// by the CTA from the operands it holds: 2 N^2 compares a product),
// widened to every NaN of either (tile_range); both
// passes run over that range only, ascending, and a tile whose range is
// empty (the lower triangle, the band's outside) has no k loop and writes
// NEG_INF.  Narrow tiles fit the band: the down-sweep's products (prefix
// triangle x band) need ~4 + width k a tile.  Two routes, chosen by shape:
//  * shared memory (A, B and C fit a CTA's 227 KB: N <= 139 square): a
//    persistent CTA of 1024 threads an SM walks the products.  The copy
//    engine stages A[p] and B[p] (a bulk copy each); a warp a group finds
//    the live ranges by ballots; the 32 warps take tiles in row-major order
//    from a counter in shared memory and write C[p]'s image there, which
//    the copy engine stores (a 32 x 4 tile's own stores would be 32
//    segments of 16 bytes).  Where two products' operands fit (N <= 107
//    square) the CTA stages the next product while it computes this one.
//    Where P is small the tiles of one p are split over several CTAs (each
//    stages the whole operands), so the later levels fill more of the card;
//  * k-tiled: a CTA of 256 threads per 64 x 64 output block, 4 tiles a
//    warp, live ranges from device memory, and the k-tiles of the block's
//    range (32 deep) staged in shared memory once a pass.
// The row form is a CTA per p: the live range of a[p] first, then B[p]'s
// rows in that range (contiguous: the prefix products are row-major)
// staged in shared memory, read once where they fit (48 KB: all of them up
// to N = K ~ 110), and thread j walks column j, pass 2 only over the k
// where both a[p, k] and the column are live; the other rows are read
// once by the whole CTA, 16 bytes a load, for a NaN alone.  alpha_0 of a
// sentence HMM is live at its live states, so the tail stages those rows
// of each prefix.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr unsigned FULL = 0xffffffffu;
// the shared-memory route: threads a CTA
constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
// a warp's output tile: TILE_M rows by TILE_N columns, R rows a lane
constexpr int TILE_M = 32;
constexpr int TILE_N = 4;
constexpr int R = TILE_M * TILE_N / 32;
// the shared-memory route's limit: an H100's shared memory a CTA may opt in
constexpr int SMEM_LIMIT = 232448;
// the k-tiled route: threads a CTA, its output block, its k-tiles' depth
constexpr int TILED_THREADS = 256;
constexpr int TILED_WARPS = TILED_THREADS / 32;
constexpr int BLOCK_M = 64;
constexpr int BLOCK_N = 64;
constexpr int KT = 32;
constexpr int BLOCK_TILES = (BLOCK_M / TILE_M) * (BLOCK_N / TILE_N);
constexpr int WARP_TILES = BLOCK_TILES / TILED_WARPS;
// the row form: threads a CTA, and the shared memory of its staged rows
constexpr int ROW_THREADS = 128;
constexpr int ROW_WARPS = ROW_THREADS / 32;
constexpr int ROW_SMEM = 48 * 1024;
// the Python side's NEG_INF, converted as torch converts it
#define NEG_INF_F ((float)(-1e30))

// One float from global to shared memory without passing a register: the
// copy is in flight until a cp_async_wait says its group has landed.
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// Until at most PENDING of this thread's committed groups are in flight
// (the landed copies are seen by this thread).
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(PENDING) : "memory");
}
// An mbarrier in this CTA's shared memory, `count` arrivals a phase; its
// initialisation seen by the bulk copies after the next barrier.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               ::"r"((unsigned)__cvta_generic_to_shared(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
// Arrive on the barrier, its phase to wait for `bytes` more.
__device__ __forceinline__ void mbar_arm(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "{ .reg .b64 st;\n\t"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1; }"
      ::"r"((unsigned)__cvta_generic_to_shared(bar)), "r"(bytes)
      : "memory");
}
// Until the phase of parity `parity` has completed (its bytes then seen).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(bar);
  unsigned done;
  do {
    asm volatile(
        "{ .reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}
// `bytes` (a multiple of 16; both addresses 16-byte aligned) from device to
// shared memory by the copy engine, counted on `bar`.
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      ::"r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src), "r"(bytes),
        "r"((unsigned)__cvta_generic_to_shared(bar))
      : "memory");
}
// `bytes` (as bulk_load's) from shared to device memory by the copy engine,
// after this CTA's writes to the source were fenced for it (proxy_fence
// by each writer, then a barrier).
__device__ __forceinline__ void bulk_store(float* dst, const float* src,
                                           unsigned bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n\t"
      "cp.async.bulk.commit_group;"
      ::"l"(dst), "r"((unsigned)__cvta_generic_to_shared(src)), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// Until this thread's bulk stores have read their source (READ) or are
// done.
template <bool READ>
__device__ __forceinline__ void bulk_store_wait() {
  if (READ)
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}
// End of the asynchronous-copy helpers.

// src's offset in floats from a 16-byte boundary: a buffer that stages
// src starts that far past one, so that the two align alike.
__device__ __forceinline__ int misalign(const float* src) {
  return (int)(reinterpret_cast<uintptr_t>(src) >> 2 & 3);
}

// The floats of a 16-byte aligned region that holds the 16-byte granules
// of n floats at any misalignment.
__host__ __device__ __forceinline__ int padded_floats(long long n) {
  return (int)((n + 3 + 3) / 4 * 4);
}

// The bytes of the 16-byte granules that hold n floats at src.
__device__ __forceinline__ unsigned granule_bytes(const float* src, int n) {
  return 16u * ((misalign(src) + n + 3) / 4);
}

// n floats at src (device memory) into `region` (16-byte aligned, at least
// padded_floats(n) long), where they land at region + misalign(src): one
// bulk copy, on `bar`, of the 16-byte granules that hold them (a granule
// never crosses a page, so the few floats around them that come along are
// readable; they are never read).  From one thread, which has armed `bar`
// for granule_bytes(src, n).
__device__ __forceinline__ void stage_floats(float* region, const float* src,
                                             int n, uint64_t* bar) {
  bulk_load(region, src - misalign(src), granule_bytes(src, n), bar);
}

// n contiguous floats at x (device memory) split at 16-byte boundaries:
// the first `head` floats, `vecs` whole 16 bytes, the rest.
struct Span {
  int head, vecs;
  __device__ __forceinline__ Span(const float* x, int n) {
    head = min(n, (4 - misalign(x)) & 3);
    vecs = (n - head) / 4;
  }
};

__device__ __forceinline__ bool is_dead(float x) { return x <= NEG_INF_F; }
__device__ __forceinline__ bool is_nan(float x) { return x != x; }

// JAX's max of an LSE: 0 where it is not finite
__device__ __forceinline__ float finite_or_zero(float m) {
  return m > -INFINITY && m < INFINITY ? m : 0.f;
}

// log(s) + m, clamped at NEG_INF as torch.clamp(min=) does (NaN passes)
__device__ __forceinline__ float lse_out(float s, float m) {
  const float v = logf(s) + m;
  return v < NEG_INF_F ? NEG_INF_F : v;
}

// The first and last live entry (lo, hi) and the first and last NaN (nlo,
// nhi) of x[0], x[step], ..., x[(K - 1) step] (K and -1 where none is).
__device__ __forceinline__ void live_range(const float* x, long long step,
                                           int K, int& lo, int& hi, int& nlo,
                                           int& nhi) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float v = x[k * step];
    if (!is_dead(v)) {
      lo = min(lo, k);
      hi = k;
    }
    if (is_nan(v)) {
      nlo = min(nlo, k);
      nhi = k;
    }
  }
}

// The k-range [lo, hi] of a tile from the ranges of its row group (g_rows:
// first and last live k, first and last NaN k) and its column group
// (g_cols): where both operands are live, and every NaN of either;
// empty where lo > hi.
__device__ __forceinline__ void tile_range(const int (&g_rows)[4],
                                           const int (&g_cols)[4], int& lo,
                                           int& hi) {
  lo = max(g_rows[0], g_cols[0]);
  hi = min(g_rows[1], g_cols[1]);
  lo = min(lo, min(g_rows[2], g_cols[2]));
  hi = max(hi, max(g_rows[3], g_cols[3]));
}

// The live ranges of 32 rows (a warp's, lane = row) reduced over the warp,
// and of 4 columns (groups of 4 lanes) reduced over each group: written to
// out[0..1] by the group's first lane.
__device__ __forceinline__ void reduce_rows(int lo, int hi, int* out) {
  lo = (int)__reduce_min_sync(FULL, (unsigned)lo);
  hi = (int)__reduce_max_sync(FULL, (unsigned)(hi + 1)) - 1;
  if ((threadIdx.x & 31) == 0) {
    out[0] = lo;
    out[1] = hi;
  }
}
__device__ __forceinline__ void reduce_cols(int lo, int hi, int* out) {
  for (int o = 1; o < TILE_N; o <<= 1) {
    lo = min(lo, __shfl_xor_sync(FULL, lo, o));
    hi = max(hi, __shfl_xor_sync(FULL, hi, o));
  }
  if ((threadIdx.x & (TILE_N - 1)) == 0) {
    out[0] = lo;
    out[1] = hi;
  }
}

// The first and last k in `bits` (bit l: k = k0 + l) into lo and hi.
__device__ __forceinline__ void ballot_range(unsigned bits, int k0, int& lo,
                                             int& hi) {
  if (bits) {
    lo = min(lo, k0 + __ffs(bits) - 1);
    hi = k0 + 31 - __clz(bits);
  }
}

// The first and last live k, and the first and last NaN k, of each 32-row
// group of A (row-major [M, K]) and of each 4-column group of B ([K, N]) in
// the CTA's shared memory, into `groups` (4 ints a group, the row groups
// first; K and -1 where none is).  A warp a group, lane l at k = 32 w + l:
// A's group read down column k, B's 4 columns along row k, a ballot over
// the 32 k.  2 N^2 loads a product, each lane's independent of one another.
__device__ __forceinline__ void scan_groups(const float* As, const float* Bs,
                                            int M, int K, int N, int tiles_m,
                                            int tiles_n, int* groups) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int g = warp; g < tiles_m + tiles_n; g += WARPS) {
    int lo = K, hi = -1, nlo = K, nhi = -1;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int k = k0 + lane;
      bool live = false, nan = false;
      if (k < K) {
        if (g < tiles_m) {
          const float* x = As + g * TILE_M * K + k;
          const int rows = min(TILE_M, M - g * TILE_M);
#pragma unroll 8
          for (int r = 0; r < rows; ++r) {
            const float v = x[r * K];
            live |= !is_dead(v);
            nan |= is_nan(v);
          }
        } else {
          const int j0 = (g - tiles_m) * TILE_N;
          const float* x = Bs + k * N + j0;
          for (int q = 0; q < min(TILE_N, N - j0); ++q) {
            live |= !is_dead(x[q]);
            nan |= is_nan(x[q]);
          }
        }
      }
      ballot_range(__ballot_sync(FULL, live), k0, lo, hi);
      ballot_range(__ballot_sync(FULL, nan), k0, nlo, nhi);
    }
    if (lane == 0) {
      groups[4 * g] = lo;
      groups[4 * g + 1] = hi;
      groups[4 * g + 2] = nlo;
      groups[4 * g + 3] = nhi;
    }
  }
}

// One pass over k in [ka, kb] of a lane's R outputs: rows[r][k] is
// A[i_r, k], col[k * ldb] is B[k, j].  SUM = false: the max into m; SUM =
// true: the sum of exponentials into s (m final).
template <bool SUM>
__device__ __forceinline__ void tile_pass(const float* const (&rows)[R],
                                          const float* col, int ldb, int ka,
                                          int kb, float (&m)[R],
                                          float (&s)[R]) {
#pragma unroll 4
  for (int k = ka; k <= kb; ++k) {
    const float bk = col[k * ldb];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float x = rows[r][k] + bk;
      if (SUM)
        s[r] += expf(x - m[r]);
      else
        m[r] = x > m[r] ? x : m[r];
    }
  }
}

// The lane's outputs (rows i + 8 r of column j) into C[p]; NEG_INF where
// the tile's k-range is empty.
__device__ __forceinline__ void store_tile(float* cp, int i, int j, int M,
                                           int N, bool dead,
                                           const float (&m)[R],
                                           const float (&s)[R]) {
  if (j >= N) return;
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (i + 8 * r < M)
      cp[(long long)(i + 8 * r) * N + j] =
          dead ? NEG_INF_F : lse_out(s[r], m[r]);
}

// The shared-memory route: a persistent CTA walks the items (p, split) of
// P * splits from blockIdx.x in steps of gridDim.x; with two buffers it
// stages the next item while it computes this one.  A product's operands
// come in by the copy engine (a bulk copy each), and its live tiles write
// their outputs into C[p]'s image in shared memory (NEG_INF first), which
// goes out by one bulk copy where the
// CTA holds all of C[p]: a 32 x 4 tile's own stores would be 32 segments
// of 16 bytes.  Dynamic shared memory: nbuf buffers of A[p] [M, K] and
// B[p] [K, N], then C's image [M, N] (each region padded to hold its 16-
// byte granules, placed as misaligned as its source or destination), the
// buffers' mbarriers, the
// ranges of each 32-row group and of each 4-column group (scan_groups),
// the tile counter.
__global__ void __launch_bounds__(THREADS, 1)
lse_product_kernel(const float* a, long long sa, const float* b,
                   long long sb, float* c, long long sc, long long P, int M,
                   int K, int N, int splits, int nbuf) {
  extern __shared__ __align__(16) float smem[];
  const int tiles_m = (M + TILE_M - 1) / TILE_M;
  const int tiles_n = (N + TILE_N - 1) / TILE_N;
  const int ntiles = tiles_m * tiles_n;
  const int a_floats = padded_floats(M * K);
  const int buf_floats = a_floats + padded_floats(K * N);
  float* out_region = smem + nbuf * buf_floats;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(out_region + padded_floats(M * N));
  int* groups = reinterpret_cast<int*>(bars + 2);
  int* counter = groups + 4 * (tiles_m + tiles_n);
  const int tid = threadIdx.x, lane = tid & 31;
  const int lr = lane >> 2, lc = lane & 3;
  const long long items = P * splits;

  // A[p] and B[p] of item `it` into buffer `buf` on its barrier (thread 0)
  auto stage = [&](long long it, int buf) {
    const long long p = it / splits;
    const float* ap = a + p * sa;
    const float* bp = b + p * sb;
    float* base = smem + buf * buf_floats;
    mbar_arm(bars + buf, granule_bytes(ap, M * K) + granule_bytes(bp, K * N));
    stage_floats(base, ap, M * K, bars + buf);
    stage_floats(base + a_floats, bp, K * N, bars + buf);
  };

  if (tid == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 1, 1);
  }
  int cur = 0;
  unsigned phases = 0;   // bit b: the parity of buffer b's next phase
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const long long p = item / splits;
    const int split = (int)(item - p * splits);
    float* cp = c + p * sc;
    float* out = out_region + misalign(cp);
    if (tid == 0) bulk_store_wait<true>();   // C's image read out
    __syncthreads();   // and the previous item's readers are done
    if (tid == 0) {
      *counter = 0;
      if (nbuf == 1 || item == blockIdx.x) stage(item, cur);
      if (nbuf == 2 && item + gridDim.x < items)
        stage(item + gridDim.x, cur ^ 1);
    }
    mbar_wait(bars + cur, phases >> cur & 1);
    phases ^= 1u << cur;
    __syncthreads();
    const float* As = smem + cur * buf_floats + misalign(a + p * sa);
    const float* Bs = smem + cur * buf_floats + a_floats + misalign(b + p * sb);
    scan_groups(As, Bs, M, K, N, tiles_m, tiles_n, groups);
    const int out_floats = padded_floats(M * N);
    for (int e = tid; e < out_floats / 4; e += THREADS)
      reinterpret_cast<float4*>(out_region)[e] =
          make_float4(NEG_INF_F, NEG_INF_F, NEG_INF_F, NEG_INF_F);
    __syncthreads();

    for (;;) {
      int q = 0;
      if (lane == 0) q = atomicAdd(counter, 1);
      const int t = split + __shfl_sync(FULL, q, 0) * splits;
      if (t >= ntiles) break;
      const int ti = t / tiles_n, tj = t - ti * tiles_n;
      const int* gr = groups + 4 * ti;
      const int* gc = groups + 4 * (tiles_m + tj);
      const int g_rows[4] = {gr[0], gr[1], gr[2], gr[3]};
      const int g_cols[4] = {gc[0], gc[1], gc[2], gc[3]};
      int lo, hi;
      tile_range(g_rows, g_cols, lo, hi);
      if (lo > hi) continue;   // NEG_INF already
      const int i = ti * TILE_M + lr, j = tj * TILE_N + lc;
      const float* rows[R];
      float m[R], s[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        rows[r] = As + min(i + 8 * r, M - 1) * K;
        m[r] = -INFINITY;
        s[r] = 0.f;
      }
      const float* col = Bs + min(j, N - 1);
      tile_pass<false>(rows, col, N, lo, hi, m, s);
#pragma unroll
      for (int r = 0; r < R; ++r) m[r] = finite_or_zero(m[r]);
      tile_pass<true>(rows, col, N, lo, hi, m, s);
      store_tile(out, i, j, M, N, false, m, s);
    }
    if (splits == 1) {   // all of C[p]: its middle by one bulk copy
      proxy_fence();
      __syncthreads();
      const Span sp(cp, M * N);
      if (tid == 0 && sp.vecs)
        bulk_store(cp + sp.head, out + sp.head, 16u * sp.vecs);
      for (int e = tid; e < sp.head; e += THREADS) cp[e] = out[e];
      for (int e = sp.head + 4 * sp.vecs + tid; e < M * N; e += THREADS)
        cp[e] = out[e];
    } else {   // this CTA's tiles alone
      __syncthreads();
      for (int e = tid; e < M * N; e += THREADS) {
        const int i = e / N, j = e - i * N;
        if ((i / TILE_M * tiles_n + j / TILE_N) % splits == split)
          cp[e] = out[e];
      }
    }
    if (nbuf == 2) cur ^= 1;
  }
  if (tid == 0) bulk_store_wait<false>();
}

// The k-tiled route: CTA (p, block) of P * blocks_m * blocks_n, the block
// BLOCK_M x BLOCK_N outputs; warp w owns the block's tiles w, w +
// TILED_WARPS, ...
__global__ void __launch_bounds__(TILED_THREADS)
lse_product_tiled_kernel(const float* a, long long sa, const float* b,
                         long long sb, float* c, long long sc, int M, int K,
                         int N, int blocks_m, int blocks_n) {
  __shared__ float As[BLOCK_M][KT + 1];
  __shared__ float Bs[KT][BLOCK_N];
  __shared__ int groups[4 * (BLOCK_M / TILE_M + BLOCK_N / TILE_N)];
  constexpr int GROUP_M = BLOCK_M / TILE_M;
  constexpr int GROUP_N = BLOCK_N / TILE_N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long per_p = (long long)blocks_m * blocks_n;
  const long long p = blockIdx.x / per_p;
  const int blk = (int)(blockIdx.x - p * per_p);
  const int i0 = (blk / blocks_n) * BLOCK_M, j0 = (blk % blocks_n) * BLOCK_N;
  const float* ap = a + p * sa;
  const float* bp = b + p * sb;

  for (int e = tid; e < BLOCK_M + BLOCK_N; e += TILED_THREADS) {
    int lo = K, hi = -1, nlo = K, nhi = -1;
    if (e < BLOCK_M) {
      if (i0 + e < M)
        live_range(ap + (long long)(i0 + e) * K, 1, K, lo, hi, nlo, nhi);
      int* g = groups + 4 * (e / TILE_M);
      reduce_rows(lo, hi, g);
      reduce_rows(nlo, nhi, g + 2);
    } else {
      const int j = j0 + e - BLOCK_M;
      if (j < N) live_range(bp + j, N, K, lo, hi, nlo, nhi);
      int* g = groups + 4 * (GROUP_M + (e - BLOCK_M) / TILE_N);
      reduce_cols(lo, hi, g);
      reduce_cols(nlo, nhi, g + 2);
    }
  }
  __syncthreads();

  // the warp's tiles, and the k-range of the whole block
  int lo[WARP_TILES], hi[WARP_TILES];
  int k_first = K, k_last = -1;
  for (int u = 0; u < BLOCK_TILES; ++u) {
    const int* gr = groups + 4 * (u / GROUP_N);
    const int* gc = groups + 4 * (GROUP_M + u % GROUP_N);
    const int g_rows[4] = {gr[0], gr[1], gr[2], gr[3]};
    const int g_cols[4] = {gc[0], gc[1], gc[2], gc[3]};
    int l, h;
    tile_range(g_rows, g_cols, l, h);
    if (l <= h) {
      k_first = min(k_first, l);
      k_last = max(k_last, h);
    }
    if (u % TILED_WARPS == warp) {
      lo[u / TILED_WARPS] = l;
      hi[u / TILED_WARPS] = h;
    }
  }
  const int lr = lane >> 2, lc = lane & 3;
  float m[WARP_TILES][R], s[WARP_TILES][R];
  for (int u = 0; u < WARP_TILES; ++u)
    for (int r = 0; r < R; ++r) {
      m[u][r] = -INFINITY;
      s[u][r] = 0.f;
    }

  // the k-tile at k0 into shared memory (0 outside the matrices: never
  // summed, and rows or columns outside are not written)
  auto stage = [&](int k0) {
    __syncthreads();   // the previous tile's readers are done
    for (int e = tid; e < BLOCK_M * KT; e += TILED_THREADS) {
      const int r = e / KT, q = e - r * KT;
      As[r][q] = i0 + r < M && k0 + q < K
                     ? ap[(long long)(i0 + r) * K + k0 + q] : 0.f;
    }
    for (int e = tid; e < KT * BLOCK_N; e += TILED_THREADS) {
      const int r = e / BLOCK_N, q = e - r * BLOCK_N;
      Bs[r][q] = k0 + r < K && j0 + q < N
                     ? bp[(long long)(k0 + r) * N + j0 + q] : 0.f;
    }
    __syncthreads();
  };
  for (int sum = 0; sum < 2; ++sum) {   // pass 1, the max; pass 2, the sum
    for (int k0 = k_first; k0 <= k_last; k0 += KT) {
      stage(k0);
      for (int u = 0; u < WARP_TILES; ++u) {
        const int t = warp + TILED_WARPS * u;
        const float* rows[R];
        for (int r = 0; r < R; ++r)
          rows[r] = As[(t / GROUP_N) * TILE_M + lr + 8 * r];
        const float* col = &Bs[0][(t % GROUP_N) * TILE_N + lc];
        const int ka = max(lo[u], k0) - k0, kb = min(hi[u], k0 + KT - 1) - k0;
        if (sum)
          tile_pass<true>(rows, col, BLOCK_N, ka, kb, m[u], s[u]);
        else
          tile_pass<false>(rows, col, BLOCK_N, ka, kb, m[u], s[u]);
      }
    }
    if (!sum)
      for (int u = 0; u < WARP_TILES; ++u)
        for (int r = 0; r < R; ++r) m[u][r] = finite_or_zero(m[u][r]);
  }
  float* cp = c + p * sc;
  for (int u = 0; u < WARP_TILES; ++u) {
    const int t = warp + TILED_WARPS * u;
    store_tile(cp, i0 + (t / GROUP_N) * TILE_M + lr,
               j0 + (t % GROUP_N) * TILE_N + lc, M, N, lo[u] > hi[u], m[u],
               s[u]);
  }
}

// Whether this thread's share of n contiguous floats at x (device memory)
// holds a NaN: ROW_THREADS threads, 16 bytes a load past the head.
__device__ __forceinline__ bool share_has_nan(const float* x, int n) {
  const Span sp(x, n);
  bool nan = false;
  for (int e = threadIdx.x; e < sp.head; e += ROW_THREADS)
    nan |= is_nan(x[e]);
  const float4* v = reinterpret_cast<const float4*>(x + sp.head);
#pragma unroll 4
  for (int e = threadIdx.x; e < sp.vecs; e += ROW_THREADS) {
    const float4 q = v[e];
    nan |= is_nan(q.x) | is_nan(q.y) | is_nan(q.z) | is_nan(q.w);
  }
  for (int e = sp.head + 4 * sp.vecs + threadIdx.x; e < n; e += ROW_THREADS)
    nan |= is_nan(x[e]);
  return nan;
}

// The row form: CTA p of P.  The rows of B[p] in a[p]'s live range are
// staged seg_rows at a time, width columns at a time (every entry read
// once where the range fits one segment, as at N = K <= 120), and thread j
// walks column j0 + j; dynamic shared memory: a[p]'s segment, then B's
// [seg_rows, width] (6 floats longer: where the segment is whole rows it
// comes by one bulk copy of its granules, placed as misaligned as its
// source).
__global__ void __launch_bounds__(ROW_THREADS)
lse_rows_kernel(const float* a, long long sa, const float* b, long long sb,
                float* c, long long sc, int K, int N, int width,
                int seg_rows) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int range[3];   // a[p]'s live range; NaN outside it found
  __shared__ uint64_t bar;
  float* as = smem;
  float* bs_region = smem + (seg_rows + 3) / 4 * 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long p = blockIdx.x;
  const float* ap = a + p * sa;
  const float* bp = b + p * sb;
  if (tid == 0) {
    mbar_init(&bar, 1);
    range[2] = 0;
  }
  if (warp == 0) {   // a[p]'s live range
    int lo = K, hi = -1;
    for (int k = lane; k < K; k += 32)
      if (!is_dead(ap[k])) {
        lo = min(lo, k);
        hi = k;
      }
    reduce_rows(lo, hi, range);
  }
  __syncthreads();
  const int lo = range[0], hi = range[1];
  const bool once = hi - lo < seg_rows;
  // a NaN of B[p] in a row outside the range (where a[p] is dead) makes a
  // term of the dense sum NaN: those rows read once for it (its column
  // found below where one is); a NaN of a[p] is live, in the range
  const int below = min(lo, K), above = max(hi + 1, below);
  if (share_has_nan(bp, below * N) ||
      share_has_nan(bp + (long long)above * N, (K - above) * N))
    atomicAdd(&range[2], 1);
  __syncthreads();
  const bool nan_outside = range[2] != 0;
  float* bs = bs_region;
  unsigned phase = 0;
  for (int j0 = 0; j0 < N; j0 += width) {
    const int w = min(width, N - j0), j = j0 + tid;
    // pass 1: the max over the range, the first and last k where both
    // operands are live, and whether a term is NaN
    float m = -INFINITY;
    int t_lo = K, t_hi = -1;
    bool nan = false;
    for (int k0 = lo; k0 <= hi; k0 += seg_rows) {
      const int kn = min(seg_rows, hi + 1 - k0);
      const float* src = bp + (long long)k0 * N;
      __syncthreads();   // the previous segment's readers are done
      if (w == N) {      // whole rows: one contiguous block
        bs = bs_region + misalign(src);
        if (tid == 0) {
          mbar_arm(&bar, granule_bytes(src, kn * N));
          stage_floats(bs_region, src, kn * N, &bar);
        }
      } else {
        if (tid == 0) mbar_arm(&bar, 0);
        for (int r = warp; r < kn; r += ROW_WARPS)
          for (int q = lane; q < w; q += 32)
            cp_async_f32(bs + r * w + q, src + (long long)r * N + j0 + q);
      }
      for (int e = tid; e < kn; e += ROW_THREADS)
        cp_async_f32(as + e, ap + k0 + e);
      cp_async_commit();
      cp_async_wait<0>();
      mbar_wait(&bar, phase);
      phase ^= 1;
      __syncthreads();
      if (tid < w) {
#pragma unroll 4
        for (int q = 0; q < kn; ++q) {
          const float ak = as[q], bk = bs[q * w + tid];
          const float x = ak + bk;
          m = x > m ? x : m;
          nan |= is_nan(x);
          if (!is_dead(ak) && !is_dead(bk)) {
            t_lo = min(t_lo, k0 + q);
            t_hi = k0 + q;
          }
        }
      }
    }
    if (tid < w) {
      for (int k = 0; nan_outside && k < K; ++k)   // column j's own
        if (k < below || k >= above) nan |= is_nan(bp[(long long)k * N + j]);
      m = finite_or_zero(m);
      float s = 0.f;
      if (nan) {
        s = NAN;
      } else if (once) {
#pragma unroll 4
        for (int k = t_lo; k <= t_hi; ++k)
          s += expf(as[k - lo] + bs[(k - lo) * w + tid] - m);
      } else {
        for (int k = t_lo; k <= t_hi; ++k)
          s += expf(ap[k] + bp[(long long)k * N + j] - m);
      }
      c[p * sc + j] = lse_out(s, m);
    }
  }
}

bool bad_shape(long long P, int M, int K, int N) {
  return P < 0 || M < 1 || K < 1 || N < 1;
}

}  // namespace

// Plain C interface for ctypes.  Each returns cudaGetLastError() after its
// launch (0 = cudaSuccess; nothing is launched for P = 0), or
// cudaErrorInvalidValue for a shape it does not take; the launch is
// asynchronous on `stream`.  Strides are in elements.

// C[p] = A[p] (x) B[p] for p < P: A [M, K], B [K, N], C [M, N].
extern "C" int hmm_lse_product(const void* a, long long sa, const void* b,
                               long long sb, void* c, long long sc,
                               long long P, int M, int K, int N,
                               void* stream) {
  if (bad_shape(P, M, K, N)) return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaSuccess;
  if (a == nullptr || b == nullptr || c == nullptr)
    return (int)cudaErrorInvalidValue;
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  float* cf = static_cast<float*>(c);
  const long long tiles_m = (M + TILE_M - 1) / TILE_M;
  const long long tiles_n = (N + TILE_N - 1) / TILE_N;
  // (in floats, so that no int overflows at any shape)
  const long long item_floats = ((long long)M * K + 6) / 4 * 4 +
                                ((long long)K * N + 6) / 4 * 4;
  const long long extra =
      4 * (((long long)M * N + 6) / 4 * 4) + 16 + 16 * (tiles_m + tiles_n) + 4;
  if (4 * item_floats + extra <= SMEM_LIMIT) {
    // two buffers where they fit; a CTA an SM's share, and each p's tiles
    // split over enough CTAs to fill the card once
    const long long item_bytes = 4 * item_floats;
    const int nbuf = 2 * item_bytes + extra <= SMEM_LIMIT ? 2 : 1;
    const long long smem = nbuf * item_bytes + extra;
    int dev = 0, sms = 0, sm_smem = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&sm_smem,
                           cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    const long long slots =
        sms * std::max(1LL, std::min((long long)(2048 / THREADS),
                                     sm_smem / (smem + 1024)));
    const long long splits =
        P >= slots ? 1
                   : std::max(1LL, std::min((slots + P - 1) / P,
                                            tiles_m * tiles_n / WARPS));
    const long long grid = std::min(P * splits, slots);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          lse_product_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    lse_product_kernel<<<(unsigned)grid, THREADS, (size_t)smem,
                         (cudaStream_t)stream>>>(af, sa, bf, sb, cf, sc, P, M,
                                                 K, N, (int)splits, nbuf);
  } else {
    const int blocks_m = (M + BLOCK_M - 1) / BLOCK_M;
    const int blocks_n = (N + BLOCK_N - 1) / BLOCK_N;
    const long long grid = P * blocks_m * blocks_n;
    if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    lse_product_tiled_kernel<<<(unsigned)grid, TILED_THREADS, 0,
                               (cudaStream_t)stream>>>(
        af, sa, bf, sb, cf, sc, M, K, N, blocks_m, blocks_n);
  }
  return (int)cudaGetLastError();
}

// c[p] = a[p] (x) B[p] for p < P: a [K] (sa = 0: one row for every p),
// B [K, N], c [N].
extern "C" int hmm_lse_rows(const void* a, long long sa, const void* b,
                            long long sb, void* c, long long sc, long long P,
                            int K, int N, void* stream) {
  if (bad_shape(P, 1, K, N)) return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaSuccess;
  if (a == nullptr || b == nullptr || c == nullptr)
    return (int)cudaErrorInvalidValue;
  if (P > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int width = std::min(N, ROW_THREADS);
  const int seg_rows =
      std::max(1, std::min(K, (ROW_SMEM / 4 - 10) / (width + 1)));
  lse_rows_kernel<<<(unsigned)P, ROW_THREADS,
                    (size_t)(4 * ((seg_rows + 3) / 4 * 4 + seg_rows * width + 6)),
                    (cudaStream_t)stream>>>(
      static_cast<const float*>(a), sa, static_cast<const float*>(b), sb,
      static_cast<float*>(c), sc, K, N, width, seg_rows);
  return (int)cudaGetLastError();
}

extern "C" const char* hmm_assoc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
