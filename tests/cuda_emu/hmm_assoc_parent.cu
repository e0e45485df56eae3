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
// What bounds it: the exponentials.  A product of N x N matrices takes N^3
// adds and compares (pass 1) and N^3 adds, subtractions, exponentials and
// sum adds (pass 2); an H100 issues 16 exponentials a cycle an SM against
// 128 float32 adds, and the library's expf is ~6 instructions around its
// MUFU.EX2, so the time is the issue of pass 2, far above the bytes (3 N^2
// floats a product).
//
// The design (a first one: right, simple): a CTA of 256 threads per 32 x 32
// output tile of one p (a 1-D grid: p major, then the tile), the k-tiles of
// both operands staged in shared memory (A's rows padded against bank
// conflicts), each warp 4 rows (w, w + 8, w + 16, w + 24) and each lane one
// column, so a staged B element serves 4 outputs and an A element is a
// broadcast.  Two passes over k: the max, then the sum of exponentials;
// each stages the operands anew (they stay in L1/L2).  The row form is a
// warp per (p, 32 columns): lane j walks k, a[p, k] a broadcast load.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = TILE / WARPS;   // output rows a thread owns
// the Python side's NEG_INF, converted as torch converts it
#define NEG_INF_F ((float)(-1e30))

// JAX's max of an LSE: 0 where it is not finite
__device__ __forceinline__ float finite_or_zero(float m) {
  return m > -INFINITY && m < INFINITY ? m : 0.f;
}

// log(s) + m, clamped at NEG_INF as torch.clamp(min=) does (NaN passes)
__device__ __forceinline__ float lse_out(float s, float m) {
  const float v = logf(s) + m;
  return v < NEG_INF_F ? NEG_INF_F : v;
}

__global__ void __launch_bounds__(THREADS)
lse_product_kernel(const float* a, long long sa, const float* b,
                   long long sb, float* c, long long sc, int M, int K, int N,
                   int tiles_m, int tiles_n) {
  __shared__ float As[TILE][TILE + 1];
  __shared__ float Bs[TILE][TILE];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long per_p = (long long)tiles_m * tiles_n;
  const long long p = blockIdx.x / per_p;
  const int t = (int)(blockIdx.x - p * per_p);
  const int i0 = (t / tiles_n) * TILE, j0 = (t % tiles_n) * TILE;
  const float* ap = a + p * sa;
  const float* bp = b + p * sb;

  // the k-tile at k0 (kn columns of A, rows of B) into shared memory;
  // outside the matrices 0 (never summed: the loops stop at kn, and rows
  // or columns outside are not written)
  auto stage = [&](int k0, int kn) {
    __syncthreads();   // the previous tile's readers are done
    for (int e = tid; e < TILE * TILE; e += THREADS) {
      const int r = e / TILE, q = e - r * TILE;
      As[r][q] = i0 + r < M && q < kn
                     ? ap[(long long)(i0 + r) * K + k0 + q] : 0.f;
      Bs[r][q] = r < kn && j0 + q < N
                     ? bp[(long long)(k0 + r) * N + j0 + q] : 0.f;
    }
    __syncthreads();
  };

  float m[ROWS], s[ROWS];
  for (int r = 0; r < ROWS; ++r) {
    m[r] = -INFINITY;
    s[r] = 0.f;
  }
  for (int k0 = 0; k0 < K; k0 += TILE) {   // pass 1: the max over k
    const int kn = min(TILE, K - k0);
    stage(k0, kn);
    for (int k = 0; k < kn; ++k) {
      const float bk = Bs[k][lane];
      for (int r = 0; r < ROWS; ++r) {
        const float x = As[warp + WARPS * r][k] + bk;
        m[r] = x > m[r] ? x : m[r];
      }
    }
  }
  for (int r = 0; r < ROWS; ++r) m[r] = finite_or_zero(m[r]);
  for (int k0 = 0; k0 < K; k0 += TILE) {   // pass 2: the sum, k ascending
    const int kn = min(TILE, K - k0);
    stage(k0, kn);
    for (int k = 0; k < kn; ++k) {
      const float bk = Bs[k][lane];
      for (int r = 0; r < ROWS; ++r) {
        const float x = As[warp + WARPS * r][k] + bk;
        s[r] += expf(x - m[r]);
      }
    }
  }
  const int j = j0 + lane;
  if (j >= N) return;
  float* cp = c + p * sc;
  for (int r = 0; r < ROWS; ++r) {
    const int i = i0 + warp + WARPS * r;
    if (i < M) cp[(long long)i * N + j] = lse_out(s[r], m[r]);
  }
}

__global__ void __launch_bounds__(THREADS)
lse_rows_kernel(const float* a, long long sa, const float* b, long long sb,
                float* c, long long sc, long long P, int K, int N,
                int tiles_n) {
  const int lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const long long p = g / tiles_n;
  if (p >= P) return;
  const int j = (int)(g - p * tiles_n) * 32 + lane;
  if (j >= N) return;
  const float* ap = a + p * sa;
  const float* bp = b + p * sb + j;
  float m = -INFINITY, s = 0.f;
  for (int k = 0; k < K; ++k) {
    const float x = ap[k] + bp[(long long)k * N];
    m = x > m ? x : m;
  }
  m = finite_or_zero(m);
  for (int k = 0; k < K; ++k) s += expf(ap[k] + bp[(long long)k * N] - m);
  c[p * sc + j] = lse_out(s, m);
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
  const int tiles_m = (M + TILE - 1) / TILE, tiles_n = (N + TILE - 1) / TILE;
  const long long grid = P * tiles_m * tiles_n;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  lse_product_kernel<<<(unsigned)grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(a), sa, static_cast<const float*>(b), sb,
      static_cast<float*>(c), sc, M, K, N, tiles_m, tiles_n);
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
  const int tiles_n = (N + 31) / 32;
  const long long grid = (P * tiles_n + WARPS - 1) / WARPS;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  lse_rows_kernel<<<(unsigned)grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(a), sa, static_cast<const float*>(b), sb,
      static_cast<float*>(c), sc, P, K, N, tiles_n);
  return (int)cudaGetLastError();
}

extern "C" const char* hmm_assoc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
