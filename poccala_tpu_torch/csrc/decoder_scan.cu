// The device decoder's exact frame scan for Hopper (sm_90a), CUDA C++:
// every frame of one decode call (or one stream chunk) for every utterance
// of the batch, in one launch.
//
// Replaces `step` of DeviceBeamDecoder._build_step
// (poccala_tpu/decoder/device.py:423-472) under the lax.scan of `_build_run`
// (:713) and `_chunk_fn` (:886).  Not a Pallas kernel: the JAX package
// traces the scan into one XLA program.  Run eagerly in PyTorch the frame
// is ~79 small launches (DeviceBeamDecoder._frame_step, the plain version),
// ~25,000 a decode call; here it is one.
//
// Tables (row-major, contiguous; ScanTables below):
//   bands[N, Ns, W]   log transition from state s to s + k of node n
//   senone[N, Ns]     senone of each token state, -1 where not emitting
//   parent[N]         tree parent, -1 for first-level nodes and the root
//   root_child[N]     1 where a word re-enters (first-level nodes)
//   node_slot[Q], word_slot[Q], slot_valid[Q]: the static (node, word)
//                     emission slots
// Carry per utterance: deltas[N, Ns] (float32) and ctx[N, Ns] (int32, the
// packed context (h + 1)(V + 1) + l of traceback pointer h and last word l).
//
// Per frame, exactly the plain loop's arithmetic (max, select, and one add
// per term in the same order; no reduction in floating point), so the
// carry, the traceback rows and hence the n-best equal the plain loop's
// bit for bit:
//   1. d'[n, s] = max_k(d[n, s-k] + bands[n, s-k, k]) (strict >, k from 0:
//      the smaller offset wins a tie), ctx riding the same selects; then
//      d'[n, s] = max(d' + log_b, NEG_INF) with log_b from the frame's
//      scores row (NEG_INF where not emitting, 0 in state 0);
//   2. the exit of each node over rr = Ns-1-k, k = 1..W-1 (strict >);
//   3. the frame's best word emission over the Q slots: the top R (R = 1
//      with no LM, else min(Q, 16)) acoustic exits in lax.top_k's order
//      (descending, the lower slot first on ties), each plus its LM term
//      (the constant -word_penalty, a flat [(V+1)V] table, or a sparse
//      bigram by a lower-bound binary search in sorted keys with a
//      per-row backoff), then the first maximum;
//   4. the entry state of every node: its parent's exit against the
//      restart from the frame's best emission (strict > picks the
//      restart), ctx = (t+1)(V+1) + word for a restart;
//   5. the traceback row (prev, word) of the frame, -1 where no word.
// Frames at or past n_valid[b] are frozen: rows -1, carry untouched.
//
// What bounds it.  At the decode cell (B = 256 utterances, 319 frames, the
// built-in lexicon's N = 125 nodes of Ns = 8 states, S = 606 senones) the
// scan must read the scores once: 198 MB, 0.059 ms at 3.35 TB/s, and does
// ~40 operations per token state and frame (1e8 in all) — nothing.  What
// costs is that frame t needs frame t-1: each utterance is a chain of 319
// dependent frames, and each frame needs its whole block (the emission is
// a reduction over all word-end slots, the entry reads other nodes'
// exits), so the time is (one frame's latency: three barriers, a block
// reduction, loads of the tables) x T.  At the 21,589-node synthetic
// lexicon the carry (N Ns 8 B = 1.38 MB an utterance) cannot stay on chip:
// it goes to device memory and back every frame, 256 x 319 x 2.76 MB =
// 225 GB, ~67 ms at the memory rate.
//
// Design (simple and right first):
// * One block per utterance, persistent over all of the call's frames.  A
//   thread owns nodes n = tid, tid + T, ... in every phase.  The advance is
//   node-local (a state reads only lower states of its own node), so it
//   runs in place in registers, the states taken from Ns-1 down to 0; the
//   carry needs no second buffer.  The only data that crosses nodes are
//   the exits (ex, ex_ctx [N]), read by the emission and the entry phase
//   after a barrier.
// * Carry and exits live in shared memory where they fit in the 227 KB a
//   block may opt into (the built-in lexicon: 9 KB; the CD lexicon of 875
//   nodes: 63 KB), else in device memory (the same kernel, CARRY_SMEM =
//   false): two instantiations of one source.
// * The frame's scores row is copied into shared memory one frame ahead
//   by cp.async, double-buffered.
// * Ns and W are runtime values up to NS_MAX and W_MAX: every loop over
//   them is unrolled to the maximum with the bound as a predicate, so the
//   node's states stay in registers (an index into a register array must
//   be a compile-time constant).
// * The emission is R passes of a block argmax under the total order
//   (value descending, slot ascending), each pass taking the best slot
//   after the previous pass's winner: lax.top_k's order exactly, with no
//   sort.  A warp then adds the R LM terms and takes the first maximum.
// * B = 256 blocks of 128 threads fill the card's 132 SMs at once in the
//   shared-memory case; the global-memory case is bound by the carry's
//   round trip.  Not tuned here.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NS_MAX = 16;     // token states per node
constexpr int W_MAX = 8;       // band width
constexpr int R_MAX = 16;      // candidates of the LM's two-phase emission
constexpr int MAX_THREADS = 256;
constexpr int MAX_WARPS = MAX_THREADS / 32;
// the opt-in shared memory of one block, less room for the static arrays
constexpr size_t SMEM_LIMIT = 232448 - 1024;

// The Python side's constants, converted as torch converts them: the
// double, rounded to float32.
#define NEG_INF_F ((float)(-1e30))
#define NEG_INF_HALF_F ((float)(-1e30 / 2.0))

}  // namespace

// Field order and types mirror ops/cuda/decoder_scan_cuda.py:_ScanTables.
struct ScanTables {
  const float* bands;          // [N, Ns, W]
  const int32_t* senone;       // [N, Ns], -1 where not emitting
  const int32_t* parent;       // [N], -1 where none
  const uint8_t* root_child;   // [N]
  const int32_t* node_slot;    // [Q]
  const int32_t* word_slot;    // [Q]
  const uint8_t* slot_valid;   // [Q]
  const float* lm_flat;        // [(V+1) V] (lm_mode 1)
  const float* lm_uni;         // [V]       (lm_mode 2)
  const float* lm_rboff;       // [V+1]
  const float* lm_cbase;       // [V]
  const int32_t* lm_keys;      // [n_keys] sorted ascending
  const float* lm_vals;        // [n_keys]
  int32_t n_nodes, n_states, band_w, n_slots, n_vocab, r_top, lm_mode,
      lm_n_keys;
  float penalty;               // the constant LM term (lm_mode 0)
};

namespace {

__device__ __forceinline__ void cp_async_f32(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// Wait until at most one of this thread's committed groups is in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// The total order of the emission's top-R: a before b when its value is
// larger, or equal with the smaller slot.
__device__ __forceinline__ bool before(float va, int qa, float vb, int qb) {
  return va > vb || (va == vb && qa < qb);
}

// The word-boundary score of (lm context l, word w): device.py's _lm.
__device__ __forceinline__ float lm_term(const ScanTables& tb, int l_r,
                                         int w_r) {
  const int v = tb.n_vocab;
  if (tb.lm_mode == 2) {
    const int w_c = min(max(w_r, 0), v - 1);
    if (l_r >= v) return tb.lm_uni[w_c];
    const int l_c = max(l_r, 0);
    const int kq = l_c * v + w_c;
    int lo = 0, hi = tb.lm_n_keys;     // torch.searchsorted, side="left"
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (tb.lm_keys[mid] < kq) lo = mid + 1; else hi = mid;
    }
    if (lo < tb.lm_n_keys && tb.lm_keys[lo] == kq) return tb.lm_vals[lo];
    return tb.lm_rboff[l_c] + tb.lm_cbase[w_c];
  }
  if (tb.lm_mode == 1)
    return tb.lm_flat[(long long)max(l_r, 0) * v + min(max(w_r, 0), v - 1)];
  return tb.penalty;
}

// Block-wide first-in-order (value, slot) pair; every thread gets it.
// red_v / red_q hold one pair per warp.
__device__ __forceinline__ void block_best(float& v, int& q, float* red_v,
                                           int* red_q) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oq = __shfl_down_sync(0xffffffffu, q, off);
    if (before(ov, oq, v, q)) { v = ov; q = oq; }
  }
  if (lane == 0) { red_v[warp] = v; red_q[warp] = q; }
  __syncthreads();
  v = red_v[0];
  q = red_q[0];
  for (int i = 1; i < warps; ++i)
    if (before(red_v[i], red_q[i], v, q)) { v = red_v[i]; q = red_q[i]; }
  __syncthreads();   // red_* free for the next pass
}

template <bool CARRY_SMEM>
__global__ void __launch_bounds__(MAX_THREADS)
decoder_scan_kernel(const ScanTables tb, const float* __restrict__ scores,
                    const int32_t* __restrict__ n_valid,
                    const float* __restrict__ d_in,
                    const int32_t* __restrict__ c_in, float* d_out,
                    int32_t* c_out, float* ex_global, int32_t* exc_global,
                    int32_t* __restrict__ tb_prev,
                    int32_t* __restrict__ tb_word, int Tc, int S, int t0) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red_v[MAX_WARPS];
  __shared__ int red_q[MAX_WARPS];
  __shared__ float top_v[R_MAX];
  __shared__ int top_q[R_MAX];
  __shared__ float e_score_s;
  __shared__ int prev_s, word_s;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int N = tb.n_nodes, Ns = tb.n_states, W = tb.band_w;
  const int Q = tb.n_slots, V = tb.n_vocab, R = tb.r_top;
  const int vp1 = V + 1;
  const size_t carry_n = (size_t)N * Ns;

  // shared memory: scores rows [2][S] | (CARRY_SMEM) ex [N] | ex_ctx [N] |
  // deltas [N Ns] | ctx [N Ns]
  float* srow = reinterpret_cast<float*>(smem_raw);
  float* ex;
  int32_t* exc;
  float* dc;
  int32_t* cc;
  if (CARRY_SMEM) {
    ex = srow + 2 * S;
    exc = reinterpret_cast<int32_t*>(ex + N);
    dc = reinterpret_cast<float*>(exc + N);
    cc = reinterpret_cast<int32_t*>(dc + carry_n);
  } else {
    ex = ex_global + (size_t)b * N;
    exc = exc_global + (size_t)b * N;
    dc = d_out + (size_t)b * carry_n;
    cc = c_out + (size_t)b * carry_n;
  }
  const float* din = d_in + (size_t)b * carry_n;
  const int32_t* cin = c_in + (size_t)b * carry_n;
  if (CARRY_SMEM || dc != din) {
    for (size_t i = tid; i < carry_n; i += nthr) {
      dc[i] = din[i];
      cc[i] = cin[i];
    }
  }

  const int nv = min(Tc, max(n_valid[b], 0));
  const float* sc_b = scores + (size_t)b * Tc * S;
  if (nv > 0)
    for (int j = tid; j < S; j += nthr) cp_async_f32(srow + j, sc_b + j);
  cp_async_commit();

  for (int i = 0; i < nv; ++i) {
    float* row = srow + (i & 1) * S;
    if (i + 1 < nv) {
      float* next = srow + ((i + 1) & 1) * S;
      const float* src = sc_b + (size_t)(i + 1) * S;
      for (int j = tid; j < S; j += nthr) cp_async_f32(next + j, src + j);
    }
    cp_async_commit();   // an empty group past the end keeps the count
    cp_async_wait_one(); // frame i's row has landed (this thread's part)
    __syncthreads();     // ... and every thread's; last frame's entry done

    // 1-2. advance, emission scores, exits: node-local, in registers
    for (int n = tid; n < N; n += nthr) {
      float d[NS_MAX];
      int c[NS_MAX];
      const size_t base = (size_t)n * Ns;
#pragma unroll
      for (int s = 0; s < NS_MAX; ++s)
        if (s < Ns) { d[s] = dc[base + s]; c[s] = cc[base + s]; }
      const float* bn = tb.bands + base * W;
      const int32_t* sn = tb.senone + base;
#pragma unroll
      for (int s = NS_MAX - 1; s >= 0; --s) {
        if (s >= Ns) continue;
        float best = NEG_INF_F;
        int bctx = V;
#pragma unroll
        for (int k = 0; k < W_MAX && k <= s; ++k) {
          if (k >= W) break;
          const float cand = d[s - k] + __ldg(bn + (s - k) * W + k);
          if (cand > best) { best = cand; bctx = c[s - k]; }
        }
        float lb = 0.0f;
        if (s > 0) {
          const int sen = __ldg(sn + s);
          lb = sen >= 0 ? row[sen] : NEG_INF_F;
        }
        const float x = best + lb;
        d[s] = x < NEG_INF_F ? NEG_INF_F : x;   // torch.clamp(min=NEG_INF)
        c[s] = bctx;
      }
      float e = NEG_INF_F;
      int ectx = V;
#pragma unroll
      for (int k = 1; k < W_MAX; ++k) {
        if (k >= W) break;
        const int rr = Ns - 1 - k;
#pragma unroll
        for (int s = 0; s < NS_MAX; ++s) {
          if (s == rr) {
            const float cand = d[s] + __ldg(bn + s * W + k);
            if (cand > e) { e = cand; ectx = c[s]; }
          }
        }
      }
#pragma unroll
      for (int s = 1; s < NS_MAX; ++s)
        if (s < Ns) { dc[base + s] = d[s]; cc[base + s] = c[s]; }
      ex[n] = e;
      exc[n] = ectx;
    }
    __syncthreads();

    // 3. the frame's best word emission: R ordered block argmaxes
    float pv = 0.0f;
    int pq = -1;
    for (int r = 0; r < R; ++r) {
      float bv = -INFINITY;   // below every slot's value (>= NEG_INF)
      int bq = 0x7fffffff;
      for (int q = tid; q < Q; q += nthr) {
        const float xq = ex[__ldg(tb.node_slot + q)];
        const float a =
            (__ldg(tb.slot_valid + q) && xq > NEG_INF_HALF_F) ? xq : NEG_INF_F;
        const bool after = r == 0 || before(pv, pq, a, q);
        if (after && before(a, q, bv, bq)) { bv = a; bq = q; }
      }
      block_best(bv, bq, red_v, red_q);
      if (tid == 0) { top_v[r] = bv; top_q[r] = bq; }
      pv = bv;
      pq = bq;
    }
    __syncthreads();
    if (warp == 0) {
      float tot = -INFINITY;  // lanes past R never win
      int slot = 0, cr = 0;
      if (lane < R) {
        slot = top_q[lane];
        const float r_sc = top_v[lane];
        cr = exc[__ldg(tb.node_slot + slot)];
        const float lm = lm_term(tb, cr % vp1, __ldg(tb.word_slot + slot));
        tot = r_sc > NEG_INF_HALF_F ? r_sc + lm : NEG_INF_F;
      }
      int idx = lane;   // first maximum over the R candidates
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ot = __shfl_down_sync(0xffffffffu, tot, off);
        const int oi = __shfl_down_sync(0xffffffffu, idx, off);
        const int os = __shfl_down_sync(0xffffffffu, slot, off);
        const int oc = __shfl_down_sync(0xffffffffu, cr, off);
        if (before(ot, oi, tot, idx)) { tot = ot; idx = oi; slot = os; cr = oc; }
      }
      if (lane == 0) {
        const bool valid = tot > NEG_INF_HALF_F;
        e_score_s = tot;
        prev_s = valid ? cr / vp1 - 1 : -1;
        word_s = valid ? __ldg(tb.word_slot + slot) : -1;
        tb_prev[(size_t)b * Tc + i] = prev_s;
        tb_word[(size_t)b * Tc + i] = word_s;
      }
    }
    __syncthreads();

    // 4. entry states: parent flow against the restart
    const float e_score = e_score_s;
    const int word = word_s;
    const int re_ctx = (t0 + i + 1) * vp1 + (word >= 0 ? word : V);
    for (int n = tid; n < N; n += nthr) {
      const int p = __ldg(tb.parent + n);
      const float flow = p >= 0 ? ex[p] : NEG_INF_F;
      const int flow_ctx = exc[max(p, 0)];
      const float restart = __ldg(tb.root_child + n) ? e_score : NEG_INF_F;
      const bool use_restart = restart > flow;
      dc[(size_t)n * Ns] = use_restart ? restart : flow;
      cc[(size_t)n * Ns] = use_restart ? re_ctx : flow_ctx;
    }
  }
  cp_async_wait_all();
  for (int i = nv + tid; i < Tc; i += nthr) {
    tb_prev[(size_t)b * Tc + i] = -1;
    tb_word[(size_t)b * Tc + i] = -1;
  }
  if (CARRY_SMEM) {
    __syncthreads();
    float* dout = d_out + (size_t)b * carry_n;
    int32_t* cout = c_out + (size_t)b * carry_n;
    for (size_t i = tid; i < carry_n; i += nthr) {
      dout[i] = dc[i];
      cout[i] = cc[i];
    }
  }
}

int threads_for(int N) {
  const int t = (N + 31) / 32 * 32;
  return t < 64 ? 64 : (t > MAX_THREADS ? MAX_THREADS : t);
}

size_t smem_bytes(bool carry_smem, int N, int Ns, int S) {
  size_t bytes = 2 * (size_t)S * sizeof(float);
  if (carry_smem)
    bytes += 2 * (size_t)N * 4 + 2 * (size_t)N * Ns * 4;
  return bytes;
}

bool carry_fits(int N, int Ns, int S) {
  return smem_bytes(true, N, Ns, S) <= SMEM_LIMIT;
}

// Opt into the dynamic shared memory past 48 KB, then launch one block of
// `threads` per utterance.
template <bool CARRY_SMEM>
int launch(int B, int threads, size_t smem, cudaStream_t stream,
           const ScanTables& tb, const float* scores, const int32_t* n_valid,
           const float* d_in, const int32_t* c_in, float* d_out,
           int32_t* c_out, float* ex, int32_t* exc, int32_t* tb_prev,
           int32_t* tb_word, int Tc, int S, int t0) {
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        decoder_scan_kernel<CARRY_SMEM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  decoder_scan_kernel<CARRY_SMEM><<<B, threads, smem, stream>>>(
      tb, scores, n_valid, d_in, c_in, d_out, c_out, ex, exc, tb_prev,
      tb_word, Tc, S, t0);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.  decoder_scan_exact returns
// cudaGetLastError() after the launch (0 = cudaSuccess), or
// cudaErrorInvalidValue for a shape it does not take; the launch is
// asynchronous on `stream`.  The carry goes from (d_in, c_in) to
// (d_out, c_out) ([B, N, Ns]); tb_prev and tb_word ([B, Tc]) are written
// whole.  ex_scratch / exc_scratch ([B, N]) are read only where the carry
// does not fit in shared memory (decoder_scan_carry_in_smem returns 0).
extern "C" int decoder_scan_exact(const ScanTables* tables,
                                  const void* scores, const void* n_valid,
                                  const void* d_in, const void* c_in,
                                  void* d_out, void* c_out, void* ex_scratch,
                                  void* exc_scratch, void* tb_prev,
                                  void* tb_word, int B, int Tc, int S, int t0,
                                  void* stream_) {
  const ScanTables tb = *tables;
  if (B < 1 || Tc < 1 || S < 1 || tb.n_nodes < 1 || tb.n_states < 1 ||
      tb.n_states > NS_MAX || tb.band_w < 1 || tb.band_w > W_MAX ||
      tb.n_slots < 1 || tb.r_top < 1 || tb.r_top > R_MAX ||
      tb.r_top > tb.n_slots || tb.lm_mode < 0 || tb.lm_mode > 2 ||
      (tb.lm_mode > 0 && tb.n_vocab < 1) || t0 < 0)
    return (int)cudaErrorInvalidValue;
  const int N = tb.n_nodes, Ns = tb.n_states;
  const bool in_smem = carry_fits(N, Ns, S);
  const size_t smem = smem_bytes(in_smem, N, Ns, S);
  if (smem > SMEM_LIMIT || (!in_smem && (ex_scratch == nullptr ||
                                          exc_scratch == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_;
  const int threads = in_smem ? threads_for(N) : MAX_THREADS;
  const auto* sc = static_cast<const float*>(scores);
  const auto* nvalid = static_cast<const int32_t*>(n_valid);
  const auto* din = static_cast<const float*>(d_in);
  const auto* cin = static_cast<const int32_t*>(c_in);
  auto* dout = static_cast<float*>(d_out);
  auto* cout = static_cast<int32_t*>(c_out);
  auto* exs = static_cast<float*>(ex_scratch);
  auto* excs = static_cast<int32_t*>(exc_scratch);
  auto* tbp = static_cast<int32_t*>(tb_prev);
  auto* tbw = static_cast<int32_t*>(tb_word);
  return in_smem
             ? launch<true>(B, threads, smem, stream, tb, sc, nvalid, din,
                            cin, dout, cout, exs, excs, tbp, tbw, Tc, S, t0)
             : launch<false>(B, threads, smem, stream, tb, sc, nvalid, din,
                             cin, dout, cout, exs, excs, tbp, tbw, Tc, S, t0);
}

// 1 where the carry of an N-node, Ns-state lexicon at S senones stays in
// shared memory, 0 where it goes to device memory (and the exits to the
// scratch the caller passes).
extern "C" int decoder_scan_carry_in_smem(int N, int Ns, int S) {
  return carry_fits(N, Ns, S);
}
extern "C" int decoder_scan_max_states() { return NS_MAX; }
extern "C" int decoder_scan_max_w() { return W_MAX; }
extern "C" int decoder_scan_max_r() { return R_MAX; }

extern "C" const char* decoder_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
