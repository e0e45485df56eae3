// Fused diagonal-GMM state scoring for Hopper (sm_90a), CUDA C++.
//
// Replaces poccala_tpu/ops/pallas/gmm_score_tpu.py:gmm_log_scores_pallas
// (kernel body _kernel, lines 68-97).  Both kernels compute
//
//   out[t, s] = logsumexp_m( [x^2, x][t, :] . W[m, :, s] + bias[m, s] )
//
// with W[m] = [-0.5/var ; mean/var] and bias[m] = -0.5 sum(mean^2/var) +
// normalizer const + log w, packed by the wrapper
// (poccala_tpu_torch/ops/cuda/gmm_score_cuda.py).  The [T, S, M] component
// lattice never reaches device memory: the sequential Pallas grid axis over
// mixtures is a loop inside the block, folded by an online logsumexp that
// costs one exponential per element:
//
//   e = exp(-|v - mx|);  v > mx ? (ss = ss*e + 1, mx = v) : (ss += e)
//
// (__expf and, for the final log, __logf: their absolute errors are below
// 1e-6, far inside the 1e-4 tolerance of the scores).
//
// What bounds it, at the decode slice (T = 256 x 319 = 81,664 frames,
// S = 606, M = 8, D = 39): 2*T*2D*S*M = 61.8 GFLOP against ~200 MB of
// traffic (the [T, S] output).  In fp32 that is 0.92 ms of FMA at the
// card's 67 TFLOP/s: compute-bound on the CUDA cores.  In bf16 the product
// takes 0.06 ms of tensor-core time and as long again to stream the output;
// the 396 M exponentials and selects of the fold, ~9 instructions an element
// on the CUDA cores, are what the kernel cannot go below (~0.12 ms).
//
// f32 kernel (exact fp32 FMA, never TF32: at the covariance floor 1/var
// reaches 1e6 and the x^2 p - 2 x mu p cancellation would cost thousands of
// nats):
// * a 128 x 64 output tile per block of 128 threads, two blocks an SM; each
//   thread owns an 8 x 8 micro-tile as 2 x 2 groups of 4 x 4, so one k step
//   is four 16-byte shared loads (the x loads broadcast within a warp, the
//   weight loads contiguous across it) for 64 FMAs.  Accumulators, running
//   max and running sum take 192 registers of the 255;
// * x^2 is formed while the x tile is staged, so no [T, 2D] operand exists
//   in device memory;
// * mixture m + 1's weights and bias arrive by cp.async in a second shared
//   buffer while mixture m is multiplied.  The packer pads S to a multiple
//   of the tile and appends the bias as row 2D of each mixture's weights,
//   so staging has no mask;
// * K = 2D = 78 is a template constant (26 k steps unrolled: 93% of the
//   loop's instructions are FFMA); any other D takes the same kernel with a
//   run-time K;
// * the finished tile goes through shared memory and leaves as whole rows:
//   16-byte stores when S is a multiple of 4, 8-byte ones when it is even
//   (S = 606), 4-byte ones otherwise, each warp writing contiguous runs;
// * a 32 x 64 tile with a 4 x 4 micro-tile takes over when T is too short
//   for the large tiles to fill the card (a stream chunk has T = 25).
//
// bf16 kernel (operands centred on the frame mean and rounded to bf16,
// exact products, fp32 sums, as JAX's bf16 dot with
// preferred_element_type=float32): the product runs on the tensor cores
// with wgmma.  A block of two warpgroups owns 128 x 64 outputs; each
// warpgroup issues m64n64k16 steps with A (the centred [x^2, x] tile,
// rounded while it is staged) and B (the mixture's weights) read from
// shared memory in the no-swizzle core-matrix layout, which the packer
// writes so that cp.async copies it through unchanged; K = 2*ceil8(D), each
// half padded with zeros.  The same one-exponential fold runs on the
// accumulator fragments; two blocks an SM overlap one block's fold with the
// other's wgmma.  Weights and bias come three mixtures ahead through a ring
// of four shared buffers (a mixture lasts ~1 us here, less than the L2's
// latency), with one block barrier a mixture; the x tile comes by cp.async as
// it lies in memory and is centred, squared and rounded from shared memory.
// The frame-dependent half of the operands, (mean - c)/var and the bias, is
// built by a small kernel of its own launched just ahead.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int SMEM_MAX = 232448;  // bytes a block may opt into on sm_90
constexpr int STAGE = 8;          // global loads in flight while x is staged
constexpr int K_UNROLL = 26;      // k steps unrolled in the f32 loop

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One mixture folded into the running (max, sum) with one exponential.
__device__ __forceinline__ void lse_fold(float v, float& mx, float& ss) {
  const float e = __expf(-fabsf(v - mx));
  if (v > mx) {
    ss = fmaf(ss, e, 1.0f);
    mx = v;
  } else {
    ss += e;
  }
}

// A finished TT x TS tile, staged in shared memory with row stride LD,
// written as whole rows with the widest store S allows.
template <int TT, int TS, int LD, int THREADS>
__device__ __forceinline__ void store_tile(const float* os, float* out, int t0,
                                           int s0, int T, int S, int tid) {
  if ((S & 3) == 0) {
    for (int i = tid; i < TT * TS / 4; i += THREADS) {
      const int r = i / (TS / 4), c = (i % (TS / 4)) * 4;
      if (t0 + r < T && s0 + c < S)
        *reinterpret_cast<float4*>(&out[(size_t)(t0 + r) * S + s0 + c]) =
            *reinterpret_cast<const float4*>(&os[r * LD + c]);
    }
  } else if ((S & 1) == 0) {
    for (int i = tid; i < TT * TS / 2; i += THREADS) {
      const int r = i / (TS / 2), c = (i % (TS / 2)) * 2;
      if (t0 + r < T && s0 + c < S)
        *reinterpret_cast<float2*>(&out[(size_t)(t0 + r) * S + s0 + c]) =
            *reinterpret_cast<const float2*>(&os[r * LD + c]);
    }
  } else {
    for (int i = tid; i < TT * TS; i += THREADS) {
      const int r = i / TS, c = i % TS;
      if (t0 + r < T && s0 + c < S)
        out[(size_t)(t0 + r) * S + s0 + c] = os[r * LD + c];
    }
  }
}

// ---------------------------------------------------------------------
// f32: exact FMA on the CUDA cores
// ---------------------------------------------------------------------

// wpack: [M][K + 1][S_pad] f32, row K the bias; S_pad a multiple of TS.
// KC: K as a compile-time constant, or 0 for the run-time K = 2 * d_rt.
template <int TT, int TS, int RG, int CG, int KC>
__global__ void __launch_bounds__((TT / (4 * RG)) * (TS / (4 * CG)))
gmm_score_f32_kernel(const float* __restrict__ x,
                     const float* __restrict__ wpack, float* __restrict__ out,
                     int T, int S, int S_pad, int M, int d_rt) {
  constexpr int NTX = TS / (4 * CG);
  constexpr int NTY = TT / (4 * RG);
  constexpr int THREADS = NTX * NTY;
  constexpr int XLD = TT + 4;
  constexpr int MT = 4 * RG;
  constexpr int NT = 4 * CG;
  const int D = KC ? KC / 2 : d_rt;
  const int K = KC ? KC : 2 * d_rt;

  extern __shared__ __align__(16) float smem[];
  float* xs = smem;            // [K][XLD]: rows 0..D-1 x^2, rows D..2D-1 x
  float* ws = smem + K * XLD;  // [2][K + 1][TS]
  const int wtile = (K + 1) * TS;

  const int t0 = blockIdx.x * TT;
  const int s0 = blockIdx.y * TS;
  const int tid = threadIdx.x;
  const int tx = tid % NTX;
  const int ty = tid / NTX;

  auto prefetch = [&](int m) {
    const float* src = wpack + (size_t)m * (K + 1) * S_pad + s0;
    float* dst = ws + (m & 1) * wtile;
    for (int i = tid; i < (K + 1) * (TS / 4); i += THREADS) {
      const int r = i / (TS / 4), c = (i % (TS / 4)) * 4;
      cp_async16(dst + r * TS + c, src + (size_t)r * S_pad + c);
    }
    cp_async_commit();
  };
  prefetch(0);

  {
    // the tile's rows are one contiguous run of x; STAGE loads are in
    // flight before the first is stored
    const int valid = min(TT, T - t0) * D;
    const float* xt = x + (size_t)t0 * D;
    for (int i0 = tid; i0 < TT * D; i0 += STAGE * THREADS) {
      float v[STAGE];
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int i = i0 + u * THREADS;
        v[u] = (i < valid) ? xt[i] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int i = i0 + u * THREADS;
        if (i < TT * D) {
          const int t = i / D, d = i - t * D;
          xs[d * XLD + t] = v[u] * v[u];
          xs[(D + d) * XLD + t] = v[u];
        }
      }
    }
  }

  float mx[MT][NT];
  float ss[MT][NT];

  for (int m = 0; m < M; ++m) {
    if (m + 1 < M) {
      prefetch(m + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // mixture m's weights (and, at m = 0, xs) are staged
    const float* wb = ws + (m & 1) * wtile;

    float acc[MT][NT];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[i][j] = 0.0f;

#pragma unroll(K_UNROLL)
    for (int k = 0; k < K; ++k) {
      float a[MT], b[NT];
#pragma unroll
      for (int g = 0; g < RG; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(
            &xs[k * XLD + g * (TT / RG) + ty * 4]);
        a[4 * g] = v.x, a[4 * g + 1] = v.y, a[4 * g + 2] = v.z,
                a[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int g = 0; g < CG; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(
            &wb[k * TS + g * (TS / CG) + tx * 4]);
        b[4 * g] = v.x, b[4 * g + 1] = v.y, b[4 * g + 2] = v.z,
                b[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }

    float bias[NT];
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(
          &wb[K * TS + g * (TS / CG) + tx * 4]);
      bias[4 * g] = v.x, bias[4 * g + 1] = v.y, bias[4 * g + 2] = v.z,
                  bias[4 * g + 3] = v.w;
    }
    if (m == 0) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          mx[i][j] = acc[i][j] + bias[j];
          ss[i][j] = 1.0f;
        }
    } else {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          lse_fold(acc[i][j] + bias[j], mx[i][j], ss[i][j]);
    }
    __syncthreads();  // everyone is done with this buffer (and, last, xs)
  }

  float* os = smem;  // [TT][TS], over the operand tiles
#pragma unroll
  for (int gi = 0; gi < RG; ++gi)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int gj = 0; gj < CG; ++gj) {
        float4 v;
        v.x = mx[4 * gi + i][4 * gj] + __logf(ss[4 * gi + i][4 * gj]);
        v.y = mx[4 * gi + i][4 * gj + 1] + __logf(ss[4 * gi + i][4 * gj + 1]);
        v.z = mx[4 * gi + i][4 * gj + 2] + __logf(ss[4 * gi + i][4 * gj + 2]);
        v.w = mx[4 * gi + i][4 * gj + 3] + __logf(ss[4 * gi + i][4 * gj + 3]);
        *reinterpret_cast<float4*>(&os[(gi * (TT / RG) + ty * 4 + i) * TS +
                                       gj * (TS / CG) + tx * 4]) = v;
      }
  __syncthreads();
  store_tile<TT, TS, TS, THREADS>(os, out, t0, s0, T, S, tid);
}

size_t f32_smem_bytes(int tt, int ts, int k) {
  size_t floats = (size_t)k * (tt + 4) + 2 * (size_t)(k + 1) * ts;
  if (floats < (size_t)tt * ts) floats = (size_t)tt * ts;
  return floats * sizeof(float);
}

template <int TT, int TS, int RG, int CG, int KC>
int launch_f32(const float* x, const float* wpack, float* out, int T, int S,
               int S_pad, int M, int D, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes(TT, TS, 2 * D);
  auto kernel = gmm_score_f32_kernel<TT, TS, RG, CG, KC>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T + TT - 1) / TT, (S + TS - 1) / TS);
  constexpr int THREADS = (TT / (4 * RG)) * (TS / (4 * CG));
  kernel<<<grid, THREADS, smem, stream>>>(x, wpack, out, T, S, S_pad, M, D);
  return (int)cudaGetLastError();
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 132;
  return n;
}

// ---------------------------------------------------------------------
// bf16: wgmma on the tensor cores
// ---------------------------------------------------------------------

constexpr int BT = 128;      // rows a block: two warpgroups of 64
constexpr int BS = 64;       // senones a block: the wgmma's N
constexpr int NB = 4;        // ring of weight buffers: three mixtures ahead
constexpr int BOLD = BS + 8; // row stride of the staged output tile

// Shared-memory matrix descriptor, no swizzle, K-major: a core matrix is 8
// rows of 16 bytes, stored contiguously; lbo = bytes between the two core
// matrices along K, sbo = bytes between 8-row groups.
__device__ __forceinline__ uint64_t smem_desc(const void* p, unsigned lbo,
                                              unsigned sbo) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// x: [T, D] f32; center: [D] f32; w_x2 and w_x: [M][Dp/8][S_pad][8] bf16, the
// -0.5p rows (k = d) and the (mu - c)p rows (k = Dp + d) of K = 2 * Dp;
// bias: [M][S_pad].  DPC: Dp as a compile-time constant, or 0 for dp_rt.
template <int DPC>
__global__ void __launch_bounds__(2 * BT, 256 / BT)
gmm_score_bf16_kernel(const float* __restrict__ x,
                      const float* __restrict__ center,
                      const __nv_bfloat16* __restrict__ w_x2,
                      const __nv_bfloat16* __restrict__ w_x,
                      const float* __restrict__ bias, float* __restrict__ out,
                      int T, int S, int S_pad, int M, int D, int dp_rt) {
  constexpr int THREADS = 2 * BT;
  const int Dp = DPC ? DPC : dp_rt;
  const int K = 2 * Dp;
  const int kc8 = K / 8;  // 16-byte chunks along K

  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kc8][BT][8]
  __nv_bfloat16* bs = a_s + (size_t)K * BT;              // [NB][kc8][BS][8]
  float* bias_s = reinterpret_cast<float*>(bs + NB * (size_t)K * BS);  // [NB][BS]
  float* cs = bias_s + NB * BS;  // [Dp]: the centre, zero beyond D
  float* os = cs + Dp;           // [BT][BOLD]; first the raw x tile [BT][D]

  const int t0 = blockIdx.x * BT;
  const int s0 = blockIdx.y * BS;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int warp = (tid % 128) / 32;

  auto prefetch = [&](int m) {
    const size_t off = ((size_t)m * (kc8 / 2) * S_pad + s0) * 8;
    __nv_bfloat16* dst = bs + (size_t)(m % NB) * K * BS;
    for (int i = tid; i < kc8 * BS; i += THREADS) {
      const int c = i / BS, n = i % BS;
      const __nv_bfloat16* src =
          c < kc8 / 2 ? w_x2 + off + ((size_t)c * S_pad + n) * 8
                      : w_x + off + ((size_t)(c - kc8 / 2) * S_pad + n) * 8;
      cp_async16(dst + ((size_t)c * BS + n) * 8, src);
    }
    if (tid < BS / 4)
      cp_async16(bias_s + (m % NB) * BS + tid * 4,
                 bias + (size_t)m * S_pad + s0 + tid * 4);
    cp_async_commit();
  };

  // the tile's rows are one contiguous, 16-byte aligned run of x: it comes
  // by cp.async as it lies, with the first mixtures' weights behind it
  const int rows = min(BT, T - t0);
  {
    const int valid = rows * D;
    const float* xt = x + (size_t)t0 * D;
    for (int i = tid; i < valid / 4; i += THREADS)
      cp_async16(os + 4 * i, xt + 4 * i);
    if (tid < valid % 4) os[valid / 4 * 4 + tid] = xt[valid / 4 * 4 + tid];
    cp_async_commit();
    if (tid < Dp) cs[tid] = tid < D ? center[tid] : 0.0f;
  }
  for (int j = 0; j < NB - 1; ++j) {
    if (j < M) prefetch(j);
    else cp_async_commit();
  }
  cp_async_wait<NB - 1>();  // x has landed
  __syncthreads();

  {
    // centred, squared and rounded into the core-matrix layout, two
    // neighbouring dims a step so that each store is one bf16 pair
    const int hp = Dp / 2;
#pragma unroll 2
    for (int i = tid; i < BT * hp; i += THREADS) {
      const int t = i / hp, d = 2 * (i - t * hp);
      const float* xr = os + t * D;
      const float v0 = (t < rows && d < D) ? xr[d] - cs[d] : 0.0f;
      const float v1 = (t < rows && d + 1 < D) ? xr[d + 1] - cs[d + 1] : 0.0f;
      const size_t at = ((size_t)(d / 8) * BT + t) * 8 + d % 8;
      *reinterpret_cast<__nv_bfloat162*>(&a_s[at]) =
          __floats2bfloat162_rn(v0 * v0, v1 * v1);
      *reinterpret_cast<__nv_bfloat162*>(&a_s[at + (size_t)(Dp / 8) * BT * 8]) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
  float acc[32], mx[32], ss[32];

  for (int m = 0; m < M; ++m) {
    // one group a step, empty at the tail, so that all but the newest
    // NB - 2 groups done means mixture m has landed
    cp_async_wait<NB - 2>();
    // shared-memory writes of this thread become visible to the tensor
    // cores' (async proxy) reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    // everyone has left mixture m - 1: its buffer takes mixture m + NB - 1
    if (m + NB - 1 < M) prefetch(m + NB - 1);
    else cp_async_commit();

    const __nv_bfloat16* bb = bs + (size_t)(m % NB) * K * BS;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    for (int ks = 0; ks < K / 16; ++ks) {
      const uint64_t da =
          smem_desc(a_s + ((size_t)(2 * ks) * BT + wg * 64) * 8, BT * 16, 128);
      const uint64_t db =
          smem_desc(bb + (size_t)(2 * ks) * BS * 8, BS * 16, 128);
      wgmma_m64n64k16(acc, da, db, ks > 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(acc[i])::"memory");

    // fragment: reg 4g + 2h + c is row 16*warp + lane/4 + 8h, col
    // 8g + 2*(lane % 4) + c
    const float* bm = bias_s + (m % NB) * BS;
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      const float2 b2 =
          *reinterpret_cast<const float2*>(&bm[8 * g + 2 * (lane % 4)]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 4 * g + 2 * h;
        const float v0 = acc[r] + b2.x, v1 = acc[r + 1] + b2.y;
        if (m == 0) {
          mx[r] = v0, ss[r] = 1.0f, mx[r + 1] = v1, ss[r + 1] = 1.0f;
        } else {
          lse_fold(v0, mx[r], ss[r]);
          lse_fold(v1, mx[r + 1], ss[r + 1]);
        }
      }
    }
  }

#pragma unroll
  for (int g = 0; g < 8; ++g)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 4 * g + 2 * h;
      const int row = wg * 64 + warp * 16 + lane / 4 + 8 * h;
      float2 v;
      v.x = mx[r] + __logf(ss[r]);
      v.y = mx[r + 1] + __logf(ss[r + 1]);
      *reinterpret_cast<float2*>(&os[row * BOLD + 8 * g + 2 * (lane % 4)]) = v;
    }
  __syncthreads();  // os was the raw x tile: read before the loop's barriers
  store_tile<BT, BS, BOLD, THREADS>(os, out, t0, s0, T, S, tid);
}

// The frame-dependent half of the bf16 operands, one thread per (m, s):
// w_x[m][d / 8][s][d % 8] = bf16((mean - c) * prec) and
// bias[m][s] = -0.5 sum((mean - c)^2 * prec) + cst[s][m]; padded senones
// and dims are zero.  means, prec: [S][M][D]; cst: [S][M].
__global__ void gmm_bf16_prepare_kernel(const float* __restrict__ means,
                                        const float* __restrict__ prec,
                                        const float* __restrict__ cst,
                                        const float* __restrict__ center,
                                        __nv_bfloat16* __restrict__ w_x,
                                        float* __restrict__ bias, int S,
                                        int S_pad, int M, int D, int Dp) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= S_pad * M) return;
  const int m = idx / S_pad, s = idx - m * S_pad;
  const float* mu = means + ((size_t)s * M + m) * D;
  const float* pr = prec + ((size_t)s * M + m) * D;
  float acc = 0.0f;
  for (int c = 0; c < Dp / 8; ++c) {
    __align__(16) __nv_bfloat16 chunk[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int d = c * 8 + e;
      float a2 = 0.0f;
      if (s < S && d < D) {
        const float mc = mu[d] - center[d];
        a2 = mc * pr[d];
        acc += mc * mc * pr[d];
      }
      chunk[e] = __float2bfloat16(a2);
    }
    *reinterpret_cast<uint4*>(
        &w_x[(((size_t)m * (Dp / 8) + c) * S_pad + s) * 8]) =
        *reinterpret_cast<const uint4*>(chunk);
  }
  bias[(size_t)m * S_pad + s] =
      s < S ? -0.5f * acc + cst[(size_t)s * M + m] : 0.0f;
}

size_t bf16_smem_bytes(int dp) {
  const size_t k = 2 * (size_t)dp;
  const size_t os = (size_t)BT * (dp > BOLD ? dp : BOLD);  // raw x, then out
  return k * BT * 2 + NB * k * BS * 2 + (NB * BS + dp) * sizeof(float) +
         os * sizeof(float);
}

}  // namespace

// Plain C interface for ctypes.  Each launch is asynchronous on `stream` and
// returns cudaGetLastError() (0 = cudaSuccess).

// x [T, D] f32, wpack [M][2D + 1][S_pad] f32 (S_pad a multiple of 64),
// out [T, S] f32.
constexpr int FT = 128;  // rows of the f32 kernel's large tile

extern "C" int gmm_score_f32(const void* x, const void* wpack, void* out,
                             int T, int S, int S_pad, int M, int D,
                             void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(wpack);
  float* of = static_cast<float*>(out);
  cudaStream_t st = (cudaStream_t)stream;
  // the large tile once its grid gives every SM its two blocks
  const long big_blocks = (long)((T + FT - 1) / FT) * ((S + 63) / 64);
  const bool big = big_blocks >= 2L * sm_count() &&
                   f32_smem_bytes(FT, 64, 2 * D) <= (size_t)SMEM_MAX;
  if (D == 39) {
    if (big)
      return launch_f32<FT, 64, 2, 2, 78>(xf, wf, of, T, S, S_pad, M, D, st);
    return launch_f32<32, 64, 1, 1, 78>(xf, wf, of, T, S, S_pad, M, D, st);
  }
  if (big)
    return launch_f32<FT, 64, 2, 2, 0>(xf, wf, of, T, S, S_pad, M, D, st);
  return launch_f32<32, 64, 1, 1, 0>(xf, wf, of, T, S, S_pad, M, D, st);
}

template <int DPC>
int launch_bf16(const float* x, const float* center,
                const __nv_bfloat16* w_x2, const __nv_bfloat16* w_x,
                const float* bias, float* out, int T, int S, int S_pad, int M,
                int D, int dp, cudaStream_t stream) {
  const size_t smem = bf16_smem_bytes(dp);
  const cudaError_t e = cudaFuncSetAttribute(
      gmm_score_bf16_kernel<DPC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T + BT - 1) / BT, (S + BS - 1) / BS);
  gmm_score_bf16_kernel<DPC><<<grid, 2 * BT, smem, stream>>>(
      x, center, w_x2, w_x, bias, out, T, S, S_pad, M, D, dp);
  return (int)cudaGetLastError();
}

// x [T, D] f32, center [D] f32 (the frames' mean), means and prec
// [S][M][D] f32, cst [S][M] f32 (normalizer const + log w), w_x2
// [M][Dp/8][S_pad][8] bf16 (Dp = D rounded up to 8; the packed -0.5 prec),
// out [T, S] f32; scratch for this call: w_x like w_x2, bias [M][S_pad] f32.
// Two launches: the frame-dependent operands, then the scores.
extern "C" int gmm_score_bf16(const void* x, const void* center,
                              const void* means, const void* prec,
                              const void* cst, const void* w_x2, void* w_x,
                              void* bias, void* out, int T, int S, int S_pad,
                              int M, int D, void* stream) {
  const int dp = (D + 7) / 8 * 8;
  cudaStream_t st = (cudaStream_t)stream;
  const float* cf = static_cast<const float*>(center);
  __nv_bfloat16* wx = static_cast<__nv_bfloat16*>(w_x);
  float* bf = static_cast<float*>(bias);
  gmm_bf16_prepare_kernel<<<(S_pad * M + 127) / 128, 128, 0, st>>>(
      static_cast<const float*>(means), static_cast<const float*>(prec),
      static_cast<const float*>(cst), cf, wx, bf, S, S_pad, M, D, dp);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const float* xf = static_cast<const float*>(x);
  const __nv_bfloat16* w2 = static_cast<const __nv_bfloat16*>(w_x2);
  float* of = static_cast<float*>(out);
  if (dp == 40)
    return launch_bf16<40>(xf, cf, w2, wx, bf, of, T, S, S_pad, M, D, dp, st);
  return launch_bf16<0>(xf, cf, w2, wx, bf, of, T, S, S_pad, M, D, dp, st);
}

// Largest feature dimension whose tiles fit the shared memory a block may
// opt into (the f32 kernel's small tile; the bf16 kernel).
extern "C" int gmm_score_max_d(int bf16) {
  int d = 0;
  if (bf16) {
    while (bf16_smem_bytes((d + 1 + 7) / 8 * 8) <= (size_t)SMEM_MAX) ++d;
  } else {
    while (f32_smem_bytes(32, 64, 2 * (d + 1)) <= (size_t)SMEM_MAX) ++d;
  }
  return d;
}

extern "C" const char* gmm_score_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
