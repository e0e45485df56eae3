// Fused diagonal-GMM state scoring for Hopper (sm_90a), CUDA C++.
//
// Replaces poccala_tpu/ops/pallas/gmm_score_tpu.py:gmm_log_scores_pallas
// (kernel body _kernel, lines 68-97).  It computes
//
//   out[t, s] = logsumexp_m( xa[t, :] . weight[m, :, s] + bias[m, s] )
//
// where the wrapper (poccala_tpu_torch/ops/cuda/gmm_score_cuda.py) packs
// xa = [x^2, x] (T x 2D), weight[m] = [-0.5/var ; mean/var] (2D x S) and
// bias[m] = -0.5 sum(mean^2/var) + normalizer const + log w (M x S).  The
// [T, S, M] component lattice never reaches device memory: an online
// max/sum logsumexp folds the mixtures in registers.
//
// What bounds it: at the decode slice (T = 256 utterances x 319 frames =
// 81,664, S = 606, M = 8, 2D = 78) the work is 2*T*2D*S*M ~ 62 GFLOP of
// fp32 FMA against ~225 MB of traffic (mostly the 198 MB [T, S] output),
// so it is compute-bound on the CUDA cores.  The design:
//
// * One block owns a T_TILE x S_TILE output tile.  Its xa tile is staged
//   in shared memory once (transposed, so a thread reads its TM rows of
//   one k with one 16-byte load); the sequential Pallas grid axis over
//   mixtures becomes the loop over m inside the block, each iteration
//   staging mixture m's [2D, S_TILE] weights.
// * Each thread keeps a TM x TN register micro-tile of dot products plus
//   the running max and sum of its outputs.  The dots are plain fp32 FMA:
//   never TF32, because at the covariance floor 1/var reaches 1e6 and the
//   x^2 p - 2 x mu p cancellation then costs thousands of nats.
// * Ragged T and S are masked in the loads and the store, so the wrapper
//   makes no padded copies.
// * bf16 is a template variant: bf16 operands in memory, widened to fp32
//   in shared memory; a bf16 x bf16 product is exact in fp32, so products
//   and sums are fp32 as in JAX's preferred_element_type=float32 dot.
// * expf/logf, not fast math, so the logsumexp matches the plain version.
//
// Speed beyond this (3xTF32 or bf16 wgmma, TMA staging) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int T_TILE = 64;
constexpr int S_TILE = 64;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (T_TILE / TM) * (S_TILE / TN);  // 256
constexpr int XS_LD = T_TILE + 4;  // padded row of the transposed xa tile

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename Op>
__global__ void __launch_bounds__(THREADS)
gmm_score_kernel(const Op* __restrict__ xa, const Op* __restrict__ weight,
                 const float* __restrict__ bias, float* __restrict__ out,
                 int T, int S, int M, int K) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;               // [K][XS_LD]: xs[k][t] = xa[t0 + t, k]
  float* ws = smem + K * XS_LD;   // [K][S_TILE]: ws[k][s] = weight[m, k, s0 + s]

  const int t0 = blockIdx.x * T_TILE;
  const int s0 = blockIdx.y * S_TILE;
  const int tid = threadIdx.x;
  const int tx = tid % (S_TILE / TN);
  const int ty = tid / (S_TILE / TN);

  for (int i = tid; i < T_TILE * K; i += THREADS) {
    const int t = i / K;
    const int k = i - t * K;
    xs[k * XS_LD + t] =
        (t0 + t < T) ? widen(xa[(size_t)(t0 + t) * K + k]) : 0.0f;
  }

  float mx[TM][TN];
  float ss[TM][TN];

  for (int m = 0; m < M; ++m) {
    __syncthreads();  // xs staged; previous mixture's ws fully read
    const Op* wm = weight + (size_t)m * K * S;
    for (int i = tid; i < K * S_TILE; i += THREADS) {
      const int k = i / S_TILE;
      const int s = i - k * S_TILE;
      ws[i] = (s0 + s < S) ? widen(wm[(size_t)k * S + s0 + s]) : 0.0f;
    }
    __syncthreads();

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

    for (int k = 0; k < K; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[k * XS_LD + ty * TM]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[k * S_TILE + tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }

#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int s = s0 + tx * TN + j;
      const float bj = (s < S) ? bias[(size_t)m * S + s] : 0.0f;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float v = acc[i][j] + bj;
        if (m == 0) {
          mx[i][j] = v;
          ss[i][j] = 1.0f;
        } else {
          const float nm = fmaxf(mx[i][j], v);
          ss[i][j] = ss[i][j] * expf(mx[i][j] - nm) + expf(v - nm);
          mx[i][j] = nm;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int t = t0 + ty * TM + i;
    if (t >= T) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int s = s0 + tx * TN + j;
      if (s < S) out[(size_t)t * S + s] = mx[i][j] + logf(ss[i][j]);
    }
  }
}

template <typename Op>
int launch(const void* xa, const void* weight, const void* bias, void* out,
           int T, int S, int M, int K, void* stream) {
  const size_t smem = (size_t)K * (XS_LD + S_TILE) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gmm_score_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((T + T_TILE - 1) / T_TILE, (S + S_TILE - 1) / S_TILE);
  gmm_score_kernel<Op><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const Op*>(xa), static_cast<const Op*>(weight),
      static_cast<const float*>(bias), static_cast<float*>(out), T, S, M, K);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.  Each returns cudaGetLastError() after the
// launch (0 = cudaSuccess); the launch is asynchronous on `stream`.
extern "C" int gmm_score_f32(const void* xa, const void* weight,
                             const void* bias, void* out, int T, int S,
                             int M, int K, void* stream) {
  return launch<float>(xa, weight, bias, out, T, S, M, K, stream);
}

extern "C" int gmm_score_bf16(const void* xa, const void* weight,
                              const void* bias, void* out, int T, int S,
                              int M, int K, void* stream) {
  return launch<__nv_bfloat16>(xa, weight, bias, out, T, S, M, K, stream);
}

extern "C" int gmm_score_max_k() {
  // largest 2D whose tiles fit the 227 KB a block may opt into
  return (int)((227 * 1024) / ((XS_LD + S_TILE) * sizeof(float)));
}

extern "C" const char* gmm_score_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
