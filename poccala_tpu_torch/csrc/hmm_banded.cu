// Banded HMM dynamic programming over time for Hopper (sm_90a), CUDA C++:
// forward, backward and Viterbi (with its backtrace) over a batch of
// embedded sentence HMMs.
//
// Replaces the lax.scan recursions of poccala_tpu/ops/hmm.py:
// forward_log_banded (:237), backward_log_banded (:263) and
// viterbi_log_banded (:288), each vmapped over utterances.  These are NOT
// Pallas kernels: the JAX package compiles the three scans into one XLA
// program.  Run eagerly in PyTorch, each frame of each scan is ~20 small
// launches, so the DP moves onto the card as one launch per scan.
//
// Notation (all float32, row-major, contiguous):
//   band[B, N, W]    band[b, j, k] = log A(j -> j+k) of utterance b
//   log_pi[B, N], log_b[B, T, N], mask[B, T] (uint8; mask[b, 0] unread)
//
//   forward:  a'[j] = max(b_t[j] + LSE_k(a[j-k] + band[j-k, k]), NEG_INF)
//   backward: s = b_{t+1} + beta_{t+1};
//             beta_t[j] = max(LSE_k(band[j, k] + s[j+k]), NEG_INF)
//   Viterbi:  d'[j] = max(b_t[j] + max_k(d[j-k] + band[j-k, k]), NEG_INF),
//             offset backpointer = the smallest k reaching the max
//
// Out-of-band terms are exactly NEG_INF (-1e30, a finite sentinel), padded
// frames are identity steps (offset 0 for Viterbi), and beta resets to 0
// while frame t+1 is padding — the JAX semantics, term for term and in the
// same order of additions, so the plain PyTorch version
// (poccala_tpu_torch/ops/hmm.py) agrees to float32 rounding of expf/logf.
//
// What bounds it: nothing but latency.  At the training slice (B = 256
// utterances, T = 319 frames, N = 50 sentence states, W = 5) log_b is
// 16 MB and the work ~4 MFLOP per scan; the serial T loop is the cost.
// The design:
//
// * One block per utterance, one thread per sentence state (N <= 1024,
//   rounded up to a warp multiple).  The carry lives in shared memory,
//   double-buffered, so one __syncthreads per frame suffices.
// * A thread's W incoming (forward, Viterbi) or outgoing (backward) band
//   entries are loaded into registers once: they do not change over time.
// * Next frame's log_b and mask are loaded one step ahead, hiding the
//   global-load latency behind the current step.
// * Viterbi writes uint8 offsets to a [B, T-1, N] scratch and thread 0
//   walks the backtrace after the loop, inside the same launch.
// * expf/logf, no fast math: the logsumexp must match the plain version.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int MAX_W = 16;
constexpr int MAX_N = 1024;

__device__ __forceinline__ float lse_of(const float* x, int w) {
  float mx = x[0];
#pragma unroll
  for (int k = 1; k < MAX_W; ++k)
    if (k < w) mx = fmaxf(mx, x[k]);
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < MAX_W; ++k)
    if (k < w) s += expf(x[k] - mx);
  return logf(s) + mx;
}

// Thread 0's logsumexp over a shared-memory row (max, then sum, as
// jax.nn.logsumexp).
__device__ float row_lse(const float* row, int n) {
  float mx = row[0];
  for (int i = 1; i < n; ++i) mx = fmaxf(mx, row[i]);
  float s = 0.0f;
  for (int i = 0; i < n; ++i) s += expf(row[i] - mx);
  return logf(s) + mx;
}

__global__ void forward_kernel(const float* __restrict__ band,
                               const float* __restrict__ log_pi,
                               const float* __restrict__ log_b,
                               const uint8_t* __restrict__ mask,
                               float* __restrict__ alpha,
                               float* __restrict__ loglik, int T, int N,
                               int W) {
  extern __shared__ float sm[];  // [2][N]
  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const bool live = j < N;
  const float* lb = log_b + (size_t)b * T * N;
  const uint8_t* mk = mask + (size_t)b * T;
  float* out = alpha + (size_t)b * T * N;

  float bin[MAX_W];  // bin[k] = band[b, j-k, k]
#pragma unroll
  for (int k = 0; k < MAX_W; ++k)
    bin[k] = (live && k < W && j - k >= 0)
                 ? band[((size_t)b * N + (j - k)) * W + k] : 0.0f;

  float a = 0.0f;
  if (live) {
    a = log_pi[(size_t)b * N + j] + lb[j];
    sm[j] = a;
    out[j] = a;
  }
  float b_next = (live && T > 1) ? lb[N + j] : 0.0f;
  uint8_t m_next = T > 1 ? mk[1] : 0;
  __syncthreads();

  int cur = 0;
  for (int t = 1; t < T; ++t) {
    const float b_t = b_next;
    const uint8_t m_t = m_next;
    if (t + 1 < T) {
      if (live) b_next = lb[(size_t)(t + 1) * N + j];
      m_next = mk[t + 1];
    }
    if (m_t && live) {
      const float* prev = sm + cur * N;
      float x[MAX_W];
#pragma unroll
      for (int k = 0; k < MAX_W; ++k)
        x[k] = (k < W && j - k >= 0) ? prev[j - k] + bin[k] : NEG_INF;
      a = fmaxf(lse_of(x, W) + b_t, NEG_INF);
    }
    if (live) {
      sm[(cur ^ 1) * N + j] = a;
      out[(size_t)t * N + j] = a;
    }
    cur ^= 1;
    __syncthreads();
  }
  if (j == 0) loglik[b] = row_lse(sm + cur * N, N);
}

__global__ void backward_kernel(const float* __restrict__ band,
                                const float* __restrict__ log_b,
                                const uint8_t* __restrict__ mask,
                                float* __restrict__ beta, int T, int N,
                                int W) {
  extern __shared__ float sm[];  // [2][N] of s = b_{t+1} + beta_{t+1}
  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const bool live = j < N;
  const float* lb = log_b + (size_t)b * T * N;
  const uint8_t* mk = mask + (size_t)b * T;
  float* out = beta + (size_t)b * T * N;

  float bout[MAX_W];  // bout[k] = band[b, j, k]
#pragma unroll
  for (int k = 0; k < MAX_W; ++k)
    bout[k] = (live && k < W) ? band[((size_t)b * N + j) * W + k] : 0.0f;

  if (live) {
    out[(size_t)(T - 1) * N + j] = 0.0f;
    sm[j] = lb[(size_t)(T - 1) * N + j] + 0.0f;
  }
  float b_here = (live && T > 1) ? lb[(size_t)(T - 2) * N + j] : 0.0f;
  uint8_t m_here = T > 1 ? mk[T - 1] : 0;
  __syncthreads();

  int cur = 0;
  for (int t = T - 2; t >= 0; --t) {
    const float b_t = b_here;
    const uint8_t m_next = m_here;  // validity of frame t+1
    if (t >= 1) {
      if (live) b_here = lb[(size_t)(t - 1) * N + j];
      m_here = mk[t];
    }
    float bt = 0.0f;
    if (m_next && live) {
      const float* s = sm + cur * N;
      float x[MAX_W];
#pragma unroll
      for (int k = 0; k < MAX_W; ++k)
        x[k] = (k < W) ? bout[k] + ((j + k < N) ? s[j + k] : NEG_INF)
                       : NEG_INF;
      bt = fmaxf(lse_of(x, W), NEG_INF);
    }
    if (live) {
      out[(size_t)t * N + j] = bt;
      sm[(cur ^ 1) * N + j] = b_t + bt;
    }
    cur ^= 1;
    __syncthreads();
  }
}

__global__ void viterbi_kernel(const float* __restrict__ band,
                               const float* __restrict__ log_pi,
                               const float* __restrict__ log_b,
                               const uint8_t* __restrict__ mask,
                               uint8_t* __restrict__ offs,
                               float* __restrict__ score,
                               int32_t* __restrict__ path,
                               float* __restrict__ delta_last, int T, int N,
                               int W, int end_states) {
  extern __shared__ float sm[];  // [2][N]
  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const bool live = j < N;
  const float* lb = log_b + (size_t)b * T * N;
  const uint8_t* mk = mask + (size_t)b * T;
  uint8_t* off = offs + (size_t)b * (T - 1) * N;

  float bin[MAX_W];  // bin[k] = band[b, j-k, k]
#pragma unroll
  for (int k = 0; k < MAX_W; ++k)
    bin[k] = (live && k < W && j - k >= 0)
                 ? band[((size_t)b * N + (j - k)) * W + k] : 0.0f;

  float d = 0.0f;
  if (live) {
    d = log_pi[(size_t)b * N + j] + lb[j];
    sm[j] = d;
  }
  float b_next = (live && T > 1) ? lb[N + j] : 0.0f;
  uint8_t m_next = T > 1 ? mk[1] : 0;
  __syncthreads();

  int cur = 0;
  for (int t = 1; t < T; ++t) {
    const float b_t = b_next;
    const uint8_t m_t = m_next;
    if (t + 1 < T) {
      if (live) b_next = lb[(size_t)(t + 1) * N + j];
      m_next = mk[t + 1];
    }
    uint8_t bk = 0;
    if (m_t && live) {
      const float* prev = sm + cur * N;
      float best = prev[j] + bin[0];
#pragma unroll
      for (int k = 1; k < MAX_W; ++k) {
        if (k < W) {
          const float cand = (j - k >= 0) ? prev[j - k] + bin[k] : NEG_INF;
          if (cand > best) {  // strict: the smallest offset wins a tie
            best = cand;
            bk = (uint8_t)k;
          }
        }
      }
      d = fmaxf(best + b_t, NEG_INF);
    }
    if (live) {
      sm[(cur ^ 1) * N + j] = d;
      off[(size_t)(t - 1) * N + j] = bk;
    }
    cur ^= 1;
    __syncthreads();  // also publishes this block's offsets in global memory
  }
  if (live) delta_last[(size_t)b * N + j] = d;
  if (j == 0) {
    const float* last = sm + cur * N;
    const int lo = end_states > 0 ? N - end_states : 0;
    int state = lo;
    for (int s = lo + 1; s < N; ++s)
      if (last[s] > last[state]) state = s;  // first maximum
    score[b] = last[state];
    int32_t* p = path + (size_t)b * T;
    p[T - 1] = state;
    for (int t = T - 2; t >= 0; --t) {
      // JAX's dynamic indexing: a negative state (a degenerate utterance
      // whose deltas all sit at the sentinel backtraces below 0) counts
      // from the end once, then clamps
      int idx = state < 0 ? state + N : state;
      idx = idx < 0 ? 0 : (idx > N - 1 ? N - 1 : idx);
      state -= off[(size_t)t * N + idx];
      p[t] = state;
    }
  }
}

int threads_for(int N) { return ((N + 31) / 32) * 32; }

bool bad_shape(int B, int T, int N, int W) {
  return B < 1 || T < 1 || N < 1 || N > MAX_N || W < 1 || W > MAX_W;
}

}  // namespace

// Plain C interface for ctypes.  Each returns cudaGetLastError() after the
// launch (0 = cudaSuccess), or cudaErrorInvalidValue for a shape it does
// not take; the launch is asynchronous on `stream`.
extern "C" int hmm_forward_banded(const void* band, const void* log_pi,
                                  const void* log_b, const void* mask,
                                  void* alpha, void* loglik, int B, int T,
                                  int N, int W, void* stream) {
  if (bad_shape(B, T, N, W)) return (int)cudaErrorInvalidValue;
  forward_kernel<<<B, threads_for(N), 2 * N * sizeof(float),
                   (cudaStream_t)stream>>>(
      static_cast<const float*>(band), static_cast<const float*>(log_pi),
      static_cast<const float*>(log_b), static_cast<const uint8_t*>(mask),
      static_cast<float*>(alpha), static_cast<float*>(loglik), T, N, W);
  return (int)cudaGetLastError();
}

extern "C" int hmm_backward_banded(const void* band, const void* log_b,
                                   const void* mask, void* beta, int B, int T,
                                   int N, int W, void* stream) {
  if (bad_shape(B, T, N, W)) return (int)cudaErrorInvalidValue;
  backward_kernel<<<B, threads_for(N), 2 * N * sizeof(float),
                    (cudaStream_t)stream>>>(
      static_cast<const float*>(band), static_cast<const float*>(log_b),
      static_cast<const uint8_t*>(mask), static_cast<float*>(beta), T, N, W);
  return (int)cudaGetLastError();
}

extern "C" int hmm_viterbi_banded(const void* band, const void* log_pi,
                                  const void* log_b, const void* mask,
                                  void* offs, void* score, void* path,
                                  void* delta_last, int B, int T, int N,
                                  int W, int end_states, void* stream) {
  if (bad_shape(B, T, N, W) || end_states < 0 || end_states > N)
    return (int)cudaErrorInvalidValue;
  viterbi_kernel<<<B, threads_for(N), 2 * N * sizeof(float),
                   (cudaStream_t)stream>>>(
      static_cast<const float*>(band), static_cast<const float*>(log_pi),
      static_cast<const float*>(log_b), static_cast<const uint8_t*>(mask),
      static_cast<uint8_t*>(offs), static_cast<float*>(score),
      static_cast<int32_t*>(path), static_cast<float*>(delta_last), T, N, W,
      end_states);
  return (int)cudaGetLastError();
}

extern "C" int hmm_banded_max_w() { return MAX_W; }
extern "C" int hmm_banded_max_n() { return MAX_N; }

extern "C" const char* hmm_banded_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
