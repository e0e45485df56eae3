// The device decoder's exact frame scan for Hopper (sm_90a), CUDA C++:
// every frame of one decode call (or one stream chunk) for every utterance
// of the batch, in one launch.  Below it, in the same source, the n-best
// (decoder_finalize_kernel) and the block-pruned search's frame scan
// (decoder_pruned_kernel).
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
//   nodes: 63 KB), else in device memory (CARRY_SMEM = false).
// * The frame's scores row is copied into shared memory one frame ahead
//   by cp.async, double-buffered, where the two rows fit (2 S 4 bytes
//   within SMEM_LIMIT: S up to ~28,900 senones); a larger bank reads each
//   frame's row straight from device memory (ROWS_SMEM = false).  The
//   rows come first: the carry goes to shared memory only in what they
//   leave.
// * Ns and W are runtime values.  Up to NS_MAX and W_MAX (REGS) every
//   loop over them is unrolled to the maximum with the bound as a
//   predicate, so the node's states stay in registers (an index into a
//   register array must be a compile-time constant).  Past either (Ns =
//   2 + 2 (state_num - 2) > 16 from state_num 10 on; W = the widest live
//   transition, up to state_num) the advance runs in place on the carry
//   where it lives, shared or device memory, with runtime loops: the same
//   compares in the same order (states Ns-1 down, offsets k up, strict >).
// * The three choices make eight instantiations of one source, chosen at
//   launch (scan_plan, states_in_regs).
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
constexpr int PRUNED_PHASES = 6;  // the pruned scan's traced phases
constexpr int MAX_THREADS = 256;
constexpr int MAX_WARPS = MAX_THREADS / 32;
// the opt-in shared memory of one block, less room for the static arrays
constexpr size_t SMEM_LIMIT = 232448 - 1024;

// The Python side's constants, converted as torch converts them: the
// double, rounded to float32.
#define NEG_INF_F ((float)(-1e30))
#define NEG_INF_HALF_F ((float)(-1e30 / 2.0))
constexpr unsigned FULL = 0xffffffffu;

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

// The block-pruned search's tables beside ScanTables; field order and types
// mirror ops/cuda/decoder_scan_cuda.py:_PrunedTables.
struct PrunedTables {
  const int32_t* slot_ptr;     // [n_blocks + 1]: block j's slots are
                               // [slot_ptr[j], slot_ptr[j + 1])
  const int32_t* node_group;   // [N]: the row of group_senone of each node
  const int32_t* group_senone; // [n_groups, Ns]: the distinct senone rows
                               // (-1 where not emitting)
  int32_t block_size, n_active, n_blocks, n_groups;
};

// The pruned scan's operands ([B, ...] each, contiguous); field order
// mirrors ops/cuda/decoder_scan_cuda.py:_PrunedIO.  The carry goes from
// the *_in to the *_out tensors; d_work / c_work ([B, K blk Ns]), ex / exc
// ([B, K blk]), meta ([B, 2 n_blocks + 6 K] int32) and la ([B, n_groups])
// are scratch, read only where the plan keeps that part out of shared
// memory.
struct PrunedIO {
  const float* scores;         // [B, Tc, S]
  const int32_t* n_valid;      // [B]
  const int64_t* kb_in;        // [B, K] active blocks, best first
  const float* d_in;           // [B, K, blk, Ns]
  const int32_t* c_in;         // [B, K, blk, Ns]
  const float* e_in;           // [B, N] entry row
  const int32_t* ec_in;        // [B, N] its contexts
  int64_t* kb_out;
  float* d_out;
  int32_t* c_out;
  float* e_out;
  int32_t* ec_out;
  float* d_work;
  int32_t* c_work;
  float* ex;
  int32_t* exc;
  int32_t* meta;
  float* la;                   // [B, n_groups]
  int32_t* tb_prev;            // [B, Tc]
  int32_t* tb_word;            // [B, Tc]
  long long* clocks;           // [PRUNED_PHASES] or null: block 0's cycles
                               // a phase (the entry refresh and the next
                               // row's wait; the lookahead; the top K and
                               // remap; the advance; the emission's passes;
                               // its totals), added to
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

// Warp-wide first-in-order (value, slot) pair; every lane gets it (a
// butterfly: the order is total, so any pairing gives the same winner).
__device__ __forceinline__ void warp_best(float& v, int& q) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL, v, off);
    const int oq = __shfl_xor_sync(FULL, q, off);
    if (before(ov, oq, v, q)) { v = ov; q = oq; }
  }
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

// The exit of one node from its states d / c (Ns of them) and its bands
// bn [Ns, W]: device.py's _exit_of, k = 1..W-1 ascending, strict >, from
// NEG_INF and context V.  Returns the exit score; *ectx its packed context.
__device__ __forceinline__ float states_exit(const ScanTables& tb,
                                             const float* d, const int32_t* c,
                                             const float* bn, int* ectx) {
  const int Ns = tb.n_states, W = tb.band_w;
  float e = NEG_INF_F;
  int ec = tb.n_vocab;
  for (int k = 1; k < W; ++k) {
    const int rr = Ns - 1 - k;
    if (rr < 0) break;
    const float cand = d[rr] + __ldg(bn + rr * W + k);
    if (cand > e) { e = cand; ec = c[rr]; }
  }
  *ectx = ec;
  return e;
}

// The exit of node n from the full carry d / c ([N, Ns]).
__device__ __forceinline__ float node_exit(const ScanTables& tb,
                                           const float* d, const int32_t* c,
                                           int n, int* ectx) {
  const size_t base = (size_t)n * tb.n_states;
  return states_exit(tb, d + base, c + base, tb.bands + base * tb.band_w,
                     ectx);
}

// The banded advance of one node in place, where its states d / c live
// (shared or device memory), against its bands bn [Ns, W] and senones
// sn [Ns] on the frame's scores row: device.py's
// _advance and the clamp, states Ns-1 down (a state reads only lower states
// of its node, so no second buffer), offsets k up, strict >; log_b is the
// row's score where the state emits, NEG_INF where not, 0 in state 0.
__device__ __forceinline__ void advance_in_place(const ScanTables& tb,
                                                 float* d, int32_t* c,
                                                 const float* bn,
                                                 const int32_t* sn,
                                                 const float* row) {
  const int Ns = tb.n_states, W = tb.band_w, V = tb.n_vocab;
  for (int s = Ns - 1; s >= 0; --s) {
    float best = NEG_INF_F;
    int bctx = V;
    for (int k = 0; k < W && k <= s; ++k) {
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
}

template <bool CARRY_SMEM, bool ROWS_SMEM, bool REGS>
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

  // shared memory: (ROWS_SMEM) scores rows [2][S] | (CARRY_SMEM) ex [N] |
  // ex_ctx [N] | deltas [N Ns] | ctx [N Ns]
  float* srow = reinterpret_cast<float*>(smem_raw);
  float* ex;
  int32_t* exc;
  float* dc;
  int32_t* cc;
  if (CARRY_SMEM) {
    ex = srow + (ROWS_SMEM ? 2 * S : 0);
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
  if (ROWS_SMEM) {
    if (nv > 0)
      for (int j = tid; j < S; j += nthr) cp_async_f32(srow + j, sc_b + j);
    cp_async_commit();
  }

  for (int i = 0; i < nv; ++i) {
    const float* row;
    if (ROWS_SMEM) {
      row = srow + (i & 1) * S;
      if (i + 1 < nv) {
        float* next = srow + ((i + 1) & 1) * S;
        const float* src = sc_b + (size_t)(i + 1) * S;
        for (int j = tid; j < S; j += nthr) cp_async_f32(next + j, src + j);
      }
      cp_async_commit();   // an empty group past the end keeps the count
      cp_async_wait_one(); // frame i's row has landed (this thread's part)
    } else {
      row = sc_b + (size_t)i * S;
    }
    __syncthreads();     // ... and every thread's; last frame's entry done

    // 1-2. advance, emission scores, exits: node-local
    for (int n = tid; n < N; n += nthr) {
      const size_t base = (size_t)n * Ns;
      const float* bn = tb.bands + base * W;
      const int32_t* sn = tb.senone + base;
      float e = NEG_INF_F;
      int ectx = V;
      if constexpr (REGS) {   // the node's states in registers
        float d[NS_MAX];
        int c[NS_MAX];
#pragma unroll
        for (int s = 0; s < NS_MAX; ++s)
          if (s < Ns) { d[s] = dc[base + s]; c[s] = cc[base + s]; }
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
      } else {   // in place where the carry lives (state 0's advanced
                 // value too: the entry phase overwrites it)
        advance_in_place(tb, dc + base, cc + base, bn, sn, row);
        e = states_exit(tb, dc + base, cc + base, bn, &ectx);
      }
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
  if (ROWS_SMEM) cp_async_wait_all();
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

// ----------------------------------------------------------------------
// The n-best of a decode call or a stream result.
//
// Replaces `finalize` of DeviceBeamDecoder._build_finalize
// (poccala_tpu/decoder/device.py:638-692), whose pointer chase is a
// lax.scan of max_words - 1 steps (:670-676).  Its plain version,
// DeviceBeamDecoder._finalize_plain, is ~10 eager ops a chase step: ~630
// launches a call, for work of a few microseconds.  Here one block per
// utterance does all of it in one launch:
//   1. the exit of each slot's node from the final carry (node_exit) and
//      the slot's acoustic score ac[q] (NEG_INF where the slot is not valid
//      or the exit is at or below NEG_INF / 2);
//   2. the top R = min(Q, max(32, 2 C)) slots in _top_k's order (value
//      descending, the lower slot first among equals): R block argmaxes,
//      each taking the best slot after the previous winner, as the frame
//      scan's emission does;
//   3. each of the R candidates' LM term on (its exit context % (V + 1),
//      its word) and its total (one float add, NEG_INF where the acoustic
//      score is at or below NEG_INF / 2);
//   4. the top C of the R totals in the same order, by one warp;
//   5. one thread per candidate chases max_words - 1 traceback pointers
//      through (tb_prev, tb_word), writes the newest-first words into its
//      seqs row (all -1 for an invalid candidate), counts them and reverses
//      the row's first `lens` entries in place: _finalize_plain's `rev`,
//      `lens` and gather.
// Compares, one float add per candidate and integer work only, so seqs and
// scores equal the plain version's bit for bit.
//
// What bounds it: the bytes, ~1 us at the decode cell (the rows [B, T]
// int32 twice, the slots' carry, seqs), and the latency of its dependent
// steps: R + C selection passes and the chase's max_words - 1 dependent
// loads.  The utterance's rows are staged in shared memory when their T 8
// bytes fit beside the selection's arrays (ROWS_SMEM), so a chase step is
// a shared-memory load; else it reads device memory.  ac[Q] sits in shared
// memory where it fits beside those, else in a [B, Q] device scratch.
template <bool ROWS_SMEM>
__global__ void __launch_bounds__(MAX_THREADS)
decoder_finalize_kernel(const ScanTables tb, const float* __restrict__ deltas,
                        const int32_t* __restrict__ ctx,
                        const int32_t* __restrict__ tb_prev,
                        const int32_t* __restrict__ tb_word, float* ac_global,
                        int32_t* __restrict__ seqs,
                        float* __restrict__ scores, int T, int C, int R,
                        int L, int ac_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red_v[MAX_WARPS];
  __shared__ int red_q[MAX_WARPS];

  const int b = blockIdx.x;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int Q = tb.n_slots, vp1 = tb.n_vocab + 1;
  const size_t carry_n = (size_t)tb.n_nodes * tb.n_states;
  const float* d_b = deltas + (size_t)b * carry_n;
  const int32_t* c_b = ctx + (size_t)b * carry_n;

  // shared memory: top_v [R] | top_q [R] | tot [R] | cr [R] | pick [C] |
  // (ROWS_SMEM) prev [T] | word [T] | (ac_in_smem) ac [Q]
  float* top_v = reinterpret_cast<float*>(smem_raw);
  int* top_q = reinterpret_cast<int*>(top_v + R);
  float* tot = reinterpret_cast<float*>(top_q + R);
  int* cr = reinterpret_cast<int*>(tot + R);
  int* pick = cr + R;
  int32_t* rows = pick + C;
  const int32_t* prev = tb_prev + (size_t)b * T;
  const int32_t* word = tb_word + (size_t)b * T;
  if (ROWS_SMEM) {
    for (int i = tid; i < T; i += nthr) {
      rows[i] = prev[i];
      rows[T + i] = word[i];
    }
    prev = rows;
    word = rows + T;
  }
  float* ac = ac_in_smem
                  ? reinterpret_cast<float*>(rows + (ROWS_SMEM ? 2 * T : 0))
                  : ac_global + (size_t)b * Q;

  // 1. the slots' acoustic scores
  for (int q = tid; q < Q; q += nthr) {
    int unused;
    const float x =
        node_exit(tb, d_b, c_b, __ldg(tb.node_slot + q), &unused);
    ac[q] = (__ldg(tb.slot_valid + q) && x > NEG_INF_HALF_F) ? x : NEG_INF_F;
  }
  __syncthreads();

  // 2. the top R slots: R ordered block argmaxes
  float pv = 0.0f;
  int pq = -1;
  for (int r = 0; r < R; ++r) {
    float bv = -INFINITY;   // below every slot's value (>= NEG_INF)
    int bq = 0x7fffffff;
    for (int q = tid; q < Q; q += nthr) {
      const float a = ac[q];
      const bool after = r == 0 || before(pv, pq, a, q);
      if (after && before(a, q, bv, bq)) { bv = a; bq = q; }
    }
    block_best(bv, bq, red_v, red_q);
    if (tid == 0) { top_v[r] = bv; top_q[r] = bq; }
    pv = bv;
    pq = bq;
  }
  __syncthreads();

  // 3. their LM terms and totals
  for (int r = tid; r < R; r += nthr) {
    const int slot = top_q[r];
    int c;
    node_exit(tb, d_b, c_b, __ldg(tb.node_slot + slot), &c);
    const float lm = lm_term(tb, c % vp1, __ldg(tb.word_slot + slot));
    const float r_sc = top_v[r];
    tot[r] = r_sc > NEG_INF_HALF_F ? r_sc + lm : NEG_INF_F;
    cr[r] = c;
  }
  __syncthreads();

  // 4. the top C totals, by the first warp
  if (tid < 32) {
    float pt = 0.0f;
    int pi = -1;
    for (int c = 0; c < C; ++c) {
      float bv = -INFINITY;
      int bi = 0x7fffffff;
      for (int r = tid; r < R; r += 32) {
        const float x = tot[r];
        const bool after = c == 0 || before(pt, pi, x, r);
        if (after && before(x, r, bv, bi)) { bv = x; bi = r; }
      }
      warp_best(bv, bi);
      if (tid == 0) {
        pick[c] = bi;
        scores[(size_t)b * C + c] = bv;
      }
      pt = bv;
      pi = bi;
    }
  }
  __syncthreads();

  // 5. the chase, one thread per candidate, then the reversal
  for (int c = tid; c < C; c += nthr) {
    const int r = pick[c];
    const bool valid = tot[r] > NEG_INF_HALF_F;
    int32_t* out = seqs + ((size_t)b * C + c) * L;
    int ptr = cr[r] / vp1 - 1;
    const int last = __ldg(tb.word_slot + top_q[r]);
    int w = valid ? last : -1;
    out[0] = w;
    int lens = w >= 0;
    for (int j = 1; j < L; ++j) {
      int nx = -1;
      w = -1;
      if (ptr >= 0) {
        const int p = min(ptr, T - 1);
        w = word[p];
        nx = prev[p];
      }
      ptr = nx;
      w = valid ? w : -1;
      out[j] = w;
      lens += w >= 0;
    }
    for (int j = 0, k = lens - 1; j < k; ++j, --k) {
      const int32_t x = out[j];
      out[j] = out[k];
      out[k] = x;
    }
    for (int j = lens; j < L; ++j) out[j] = -1;
  }
}

// ----------------------------------------------------------------------
// The block-pruned frame scan.
//
// Replaces `step_pruned` of make_pruned (poccala_tpu/decoder/device.py:
// 500-603) under the same lax.scans as the exact step (:713, :886).  Its
// plain version, DeviceBeamDecoder._step_pruned in a loop over frames, is
// ~100 eager launches a frame and builds a [B, N, Ns] lookahead temporary
// every frame (178 MB at 256 utterances of the 21,589-node lexicon); here
// one launch runs every frame of a decode call or a stream chunk for every
// utterance.  The nodes are in DFS order, padded to n_blocks blocks of
// blk; K blocks are active.  The carry per utterance: kb [K] (int64, the
// active blocks, best first), the compact deltas / ctx [K, blk, Ns] and the
// global entry row and its contexts [N].  Per frame, exactly the plain
// loop's arithmetic (compares, max, one add per term in its order), so the
// carry, kb and the traceback rows equal the plain loop's bit for bit:
//   1. lookahead: la[n] = max over the node's states of the frame's score
//      (NEG_INF where a state does not emit), blk_best[j] = max over block
//      j of entry + la; an active block also takes max over its nodes of
//      (max_s d + la) (the plain loop's scatter_reduce "amax").  la is
//      computed once per distinct senone row (group: 125 rows at the
//      synthetic lexicon, against 21,760 nodes), read through node_group:
//      the same max over the same values in the same order;
//   2. the K best blocks in _top_k's order (value descending, the lower
//      block first on ties): K passes of a warp argmax, each taking the
//      best block after the previous winner;
//   3. remap: a surviving block keeps its interior, a fresh one starts at
//      (NEG_INF, V); state 0 of every active node takes the entry row;
//   4. the banded advance and clamp of the K blk active nodes in place
//      (advance_in_place), then their exits (states_exit);
//   5. the word emission over the active blocks' slots and the entry
//      refresh of all N nodes, as the exact scan's phases 3-4;
//   6. the traceback row (prev, word).
// Frames at or past n_valid[b] are frozen: rows -1, carry untouched.
//
// Where the plain loop's results hinge on detail, and what this does:
// * Ties among dead blocks.  Most blocks hold no token: their entry is
//   NEG_INF and NEG_INF + la rounds to -1e30 (-2e30 for an all-padding
//   block), so dozens of blocks tie and _top_k takes the lowest indices.
//   blk_best is computed densely by the plain loop's formula for every
//   node of every block (no shortcut past dead nodes), so each tie is the
//   same tie, and the selection breaks it by the block index.
// * The clipped parent.  _enter reads flow_ctx = ex_ctx[:, parent] with
//   parent clipped to 0, so a parentless node takes node 0's exit context
//   when it does not restart: the entry phase looks node max(p, 0) up
//   through the block map like any parent (V where its block is inactive,
//   as in the flat row the plain loop scatters).
// * Only active nodes have finite exits.  The exits are kept compact
//   (ex [K blk], by logical position) with map[n_blocks] = the position of
//   each active block (-1 elsewhere) for the parent lookup, no [N] row.
//   The slots come from np.nonzero(word_tab >= 0) in node order, so each
//   block's slots are one range (slot_ptr) and the emission scans only the
//   K ranges, in slot order.  With an LM and fewer than R finite
//   candidates the plain loop fills its top R with NEG_INF slots from all
//   Q; their total is NEG_INF, so they never win the first maximum nor
//   reach a row: here a pass that finds no slot gives a NEG_INF total.
// * Memory.  The entry row (8 N bytes: 174 KB at 21,760 nodes) and the
//   compact carry (8 K blk Ns: 131 KB at 8 x 256, 65.5 KB at 4 x 256) do
//   not both fit in the 227 KB a block may take.  pruned_plan places, in
//   order, the scores rows (double-buffered by cp.async), the small block
//   arrays (meta), the groups' lookahead, the exits, the carry, the entry
//   row, each in shared memory if it fits in what is left, else in device
//   memory (the entry row in the output tensors, the rest in scratch the
//   wrapper passes).  The carry comes before the entry row: the advance
//   reads and writes it in place, state after state, while the entry row
//   is read and written once a frame, and at 4 x 256 the carry leaves room
//   for two blocks an SM, so the 256 utterances run in one wave (on an
//   H100: 29.3 ms a call, against 47.8 ms with the entry row first).
//   ROWS_SMEM (the cp.async prefetch) makes two instantiations; every other
//   part is placed at run time, through a base pointer.
// * No shape limit the plain loop lacks: any Ns and W (the advance runs in
//   place with runtime loops), block size, K <= n_blocks, Q and S.  A
//   device-memory carry is permuted by a physical-slot table (phys), so a
//   surviving block never moves; the output is written in kb's order.
//
// What bounds it.  At the pruned cell (B = 256, 319 frames, N = 21,760,
// Ns = 8, K = 8 of 85 blocks of 256, S = 606) the scan must read the
// scores of the 300 senones the lexicon names once (~100 MB) and do, a
// frame, the lookahead (the 125 senone groups' maxima, entry + la and its
// block max over N nodes, the K blocks' max_s d + la), the advance of the
// K blk active nodes and the entry refresh's compare: 1.8e10 operations a
// call, ~0.26 ms at one float32 operation each.  As for the exact scan,
// what costs is the chain of T dependent frames per utterance, each a
// sequence of block-wide phases, one block per utterance.  On an H100 (phase_clocks) a frame takes
// ~170 k cycles of a block at 8 x 256: the lookahead and the advance a third
// each, the entry refresh a fifth, the top K and the emission the rest;
// each a chain of L2 loads of the static tables (21,760 nodes' worth every
// frame) that 8 warps do not hide, not a bandwidth.  Three things moved it:
// the lookahead through the 125 senone groups instead of every node's Ns
// senones (89 -> 73 ms a call at 8 x 256), the entry refresh's table loads
// BATCH at a time (-> 66 ms) and the carry before the entry row (-> 55 ms;
// 4 x 256: 29 ms).  States in registers, state-major carries and
// transposed tables did not.  Not tuned further.
constexpr int BATCH = 8;   // the entry refresh's table loads in flight

struct PrunedPlan {
  bool rows_smem, meta_smem, la_smem, ex_smem, entry_smem, carry_smem;
  unsigned meta_off, la_off, ex_off, entry_off, carry_off, smem;
};

template <bool ROWS_SMEM>
__global__ void __launch_bounds__(MAX_THREADS)
decoder_pruned_kernel(const ScanTables tb, const PrunedTables pt,
                      const PrunedPlan plan, const PrunedIO io, int Tc,
                      int S, int t0) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red_v[MAX_WARPS];
  __shared__ int red_q[MAX_WARPS];
  __shared__ float top_v[R_MAX];
  __shared__ int top_q[R_MAX];
  __shared__ float e_score_s;
  __shared__ int word_s;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, warps = nthr >> 5;
  const int N = tb.n_nodes, Ns = tb.n_states;
  const int V = tb.n_vocab, R = tb.r_top, vp1 = V + 1;
  const int blk = pt.block_size, K = pt.n_active, NB = pt.n_blocks;
  const int act_n = K * blk;                       // active nodes
  const size_t blk_n = (size_t)blk * Ns;           // one block's carry
  const size_t carry_n = (size_t)K * blk_n;

  // meta: blk_best [NB] | map [NB] (block -> position, -1) | kb_s [K]
  // (position -> block) | knew [K] | phys [K] (position -> carry slot) |
  // nphys [K] | used [K] | fresh [K]
  int32_t* meta = plan.meta_smem
      ? reinterpret_cast<int32_t*>(smem_raw + plan.meta_off)
      : io.meta + (size_t)b * (2 * NB + 6 * K);
  float* blk_best = reinterpret_cast<float*>(meta);
  int32_t* map = meta + NB;
  int32_t* kb_s = map + NB;
  int32_t* knew = kb_s + K;
  int32_t* phys = knew + K;
  int32_t* nphys = phys + K;
  int32_t* used = nphys + K;
  int32_t* fresh = used + K;
  float* srow = reinterpret_cast<float*>(smem_raw);
  float* la_g = plan.la_smem
      ? reinterpret_cast<float*>(smem_raw + plan.la_off)
      : io.la + (size_t)b * pt.n_groups;
  float* ex;
  int32_t* exc;
  if (plan.ex_smem) {
    ex = reinterpret_cast<float*>(smem_raw + plan.ex_off);
    exc = reinterpret_cast<int32_t*>(ex + act_n);
  } else {
    ex = io.ex + (size_t)b * act_n;
    exc = io.exc + (size_t)b * act_n;
  }
  float* ent;
  int32_t* entc;
  if (plan.entry_smem) {
    ent = reinterpret_cast<float*>(smem_raw + plan.entry_off);
    entc = reinterpret_cast<int32_t*>(ent + N);
  } else {
    ent = io.e_out + (size_t)b * N;
    entc = io.ec_out + (size_t)b * N;
  }
  float* dw;
  int32_t* cw;
  if (plan.carry_smem) {
    dw = reinterpret_cast<float*>(smem_raw + plan.carry_off);
    cw = reinterpret_cast<int32_t*>(dw + carry_n);
  } else {
    dw = io.d_work + (size_t)b * carry_n;
    cw = io.c_work + (size_t)b * carry_n;
  }

  // the carry in, each block in the carry slot of its position
  {
    const float* e_b = io.e_in + (size_t)b * N;
    const int32_t* ec_b = io.ec_in + (size_t)b * N;
    for (int n = tid; n < N; n += nthr) {
      ent[n] = e_b[n];
      entc[n] = ec_b[n];
    }
    const float* d_b = io.d_in + (size_t)b * carry_n;
    const int32_t* c_b = io.c_in + (size_t)b * carry_n;
    for (size_t i = tid; i < carry_n; i += nthr) {
      dw[i] = d_b[i];
      cw[i] = c_b[i];
    }
    for (int j = tid; j < NB; j += nthr) map[j] = -1;
  }
  __syncthreads();
  for (int k = tid; k < K; k += nthr) {
    const int j = (int)io.kb_in[(size_t)b * K + k];
    kb_s[k] = j;
    phys[k] = k;
    map[j] = k;
  }

  const int nv = min(Tc, max(io.n_valid[b], 0));
  const float* sc_b = io.scores + (size_t)b * Tc * S;
  if (ROWS_SMEM) {
    if (nv > 0)
      for (int j = tid; j < S; j += nthr) cp_async_f32(srow + j, sc_b + j);
    cp_async_commit();
  }
  // the phases' cycles in block 0, summed over its frames, where io.clocks
  // is given (PRUNED_PHASES of them; each phase ends at a barrier)
  const bool trace = io.clocks != nullptr && b == 0 && tid == 0;
  long long tick = trace ? clock64() : 0;
  auto mark = [&](int phase) {
    if (trace) {
      const long long now = clock64();
      io.clocks[phase] += now - tick;
      tick = now;
    }
  };

  for (int i = 0; i < nv; ++i) {
    const float* row;
    if (ROWS_SMEM) {
      row = srow + (i & 1) * S;
      if (i + 1 < nv) {
        float* next = srow + ((i + 1) & 1) * S;
        const float* src = sc_b + (size_t)(i + 1) * S;
        for (int j = tid; j < S; j += nthr) cp_async_f32(next + j, src + j);
      }
      cp_async_commit();   // an empty group past the end keeps the count
      cp_async_wait_one(); // frame i's row has landed (this thread's part)
    } else {
      row = sc_b + (size_t)i * S;
    }
    __syncthreads();     // ... and every thread's; last frame's entry done
    mark(0);

    // 1. lookahead: each senone row's best score (amax over the states in
    // order), then a warp a block, densely over its nodes
    for (int g = tid; g < pt.n_groups; g += nthr) {
      const int32_t* sn = pt.group_senone + (size_t)g * Ns;
      float la = NEG_INF_F;
      for (int s = 0; s < Ns; ++s) {
        const int sen = __ldg(sn + s);
        const float x = sen >= 0 ? row[sen] : NEG_INF_F;
        if (s == 0 || x > la) la = x;
      }
      la_g[g] = la;
    }
    __syncthreads();
    for (int j = warp; j < NB; j += warps) {
      const int k = map[j];
      const float* dk = k >= 0 ? dw + (size_t)phys[k] * blk_n : nullptr;
      float best = -INFINITY, inner = -INFINITY;
      for (int n = lane; n < blk; n += 32) {
        const int node = j * blk + n;
        const float la = la_g[__ldg(pt.node_group + node)];
        const float pot = ent[node] + la;
        if (pot > best) best = pot;
        if (dk != nullptr) {
          const float* dn = dk + (size_t)n * Ns;
          float m = dn[0];
          for (int s = 1; s < Ns; ++s) m = dn[s] > m ? dn[s] : m;
          const float x = m + la;
          if (x > inner) inner = x;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(FULL, best, off);
        const float oi = __shfl_xor_sync(FULL, inner, off);
        best = ob > best ? ob : best;
        inner = oi > inner ? oi : inner;
      }
      if (lane == 0) blk_best[j] = (k >= 0 && inner > best) ? inner : best;
    }
    __syncthreads();
    mark(1);

    // 2-3. the top K blocks (warp 0), then the remap (its lane 0)
    if (warp == 0) {
      float pv = 0.0f;
      int pq = -1;
      for (int r = 0; r < K; ++r) {
        float bv = -INFINITY;
        int bq = 0x7fffffff;
        for (int j = lane; j < NB; j += 32) {
          const float x = blk_best[j];
          const bool after = r == 0 || before(pv, pq, x, j);
          if (after && before(x, j, bv, bq)) { bv = x; bq = j; }
        }
        warp_best(bv, bq);
        if (lane == 0) knew[r] = bq;
        pv = bv;
        pq = bq;
      }
      if (lane == 0) {
        for (int k = 0; k < K; ++k) used[k] = 0;
        for (int k = 0; k < K; ++k) {   // a survivor keeps its carry slot
          const int op = map[knew[k]];
          nphys[k] = op >= 0 ? phys[op] : -1;
          if (op >= 0) used[phys[op]] = 1;
        }
        for (int k = 0; k < K; ++k) map[kb_s[k]] = -1;
        for (int k = 0, f = 0; k < K; ++k) {   // a fresh block a free slot
          fresh[k] = nphys[k] < 0;
          if (fresh[k]) {
            while (used[f]) ++f;
            nphys[k] = f;
            used[f] = 1;
          }
          kb_s[k] = knew[k];
          phys[k] = nphys[k];
          map[knew[k]] = k;
        }
      }
    }
    __syncthreads();
    mark(2);

    // 4. the active nodes: remap, advance in place, exits
    for (int idx = tid; idx < act_n; idx += nthr) {
      const int k = idx / blk, n = idx - k * blk;
      const int node = kb_s[k] * blk + n;
      float* d = dw + (size_t)phys[k] * blk_n + (size_t)n * Ns;
      int32_t* c = cw + (size_t)phys[k] * blk_n + (size_t)n * Ns;
      if (fresh[k])
        for (int s = 1; s < Ns; ++s) {
          d[s] = NEG_INF_F;
          c[s] = V;
        }
      d[0] = ent[node];
      c[0] = entc[node];
      const size_t base = (size_t)node * Ns;
      const float* bn = tb.bands + base * tb.band_w;
      advance_in_place(tb, d, c, bn, tb.senone + base, row);
      int ectx;
      ex[idx] = states_exit(tb, d, c, bn, &ectx);
      exc[idx] = ectx;
    }
    __syncthreads();
    mark(3);

    // 5. the frame's best word emission: R ordered block argmaxes over the
    // active blocks' slots
    float pv = 0.0f;
    int pq = -1;
    for (int r = 0; r < R; ++r) {
      float bv = -INFINITY;   // below every slot's value (>= NEG_INF)
      int bq = 0x7fffffff;    // stays where no slot is left
      for (int k = 0; k < K; ++k) {
        const int j = kb_s[k];
        const int q1 = __ldg(pt.slot_ptr + j + 1);
        for (int q = __ldg(pt.slot_ptr + j) + tid; q < q1; q += nthr) {
          const float xq = ex[(k - j) * blk + __ldg(tb.node_slot + q)];
          const float a = (__ldg(tb.slot_valid + q) && xq > NEG_INF_HALF_F)
                              ? xq : NEG_INF_F;
          const bool after = r == 0 || before(pv, pq, a, q);
          if (after && before(a, q, bv, bq)) { bv = a; bq = q; }
        }
      }
      block_best(bv, bq, red_v, red_q);
      if (tid == 0) { top_v[r] = bv; top_q[r] = bq; }
      pv = bv;
      pq = bq;
    }
    __syncthreads();
    mark(4);
    if (warp == 0) {
      float tot = -INFINITY;  // lanes past R never win
      int slot = 0, cr = 0;
      if (lane < R) {
        tot = NEG_INF_F;      // the plain loop's NEG_INF picks
        const int q = top_q[lane];
        if (q != 0x7fffffff) {
          slot = q;
          const int node = __ldg(tb.node_slot + q), j = node / blk;
          cr = exc[map[j] * blk + node - j * blk];
          const float lm = lm_term(tb, cr % vp1, __ldg(tb.word_slot + q));
          const float r_sc = top_v[lane];
          tot = r_sc > NEG_INF_HALF_F ? r_sc + lm : NEG_INF_F;
        }
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
        word_s = valid ? __ldg(tb.word_slot + slot) : -1;
        io.tb_prev[(size_t)b * Tc + i] = valid ? cr / vp1 - 1 : -1;
        io.tb_word[(size_t)b * Tc + i] = word_s;
      }
    }
    __syncthreads();
    mark(5);

    // 6. the entry row: parent flow (through the block map) against the
    // restart
    const float e_score = e_score_s;
    const int word = word_s;
    const int re_ctx = (t0 + i + 1) * vp1 + (word >= 0 ? word : V);
    for (int n0 = tid; n0 < N; n0 += nthr * BATCH) {
      int par[BATCH];   // the batch's table loads in flight together
      bool root[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int n = n0 + nthr * u;
        par[u] = n < N ? __ldg(tb.parent + n) : -1;
        root[u] = n < N && __ldg(tb.root_child + n);
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int n = n0 + nthr * u;
        if (n >= N) break;
        const int p = par[u];
        const int pc = max(p, 0), pj = pc / blk, k = map[pj];
        float x = NEG_INF_F;
        int xc = V;
        if (k >= 0) {
          x = ex[(k - pj) * blk + pc];
          xc = exc[(k - pj) * blk + pc];
        }
        const float flow = p >= 0 ? x : NEG_INF_F;
        const float restart = root[u] ? e_score : NEG_INF_F;
        const bool use_restart = restart > flow;
        ent[n] = use_restart ? restart : flow;
        entc[n] = use_restart ? re_ctx : xc;
      }
    }
  }
  if (ROWS_SMEM) cp_async_wait_all();
  for (int i = nv + tid; i < Tc; i += nthr) {
    io.tb_prev[(size_t)b * Tc + i] = -1;
    io.tb_word[(size_t)b * Tc + i] = -1;
  }
  __syncthreads();
  // the carry out in kb's order
  for (int k = tid; k < K; k += nthr) io.kb_out[(size_t)b * K + k] = kb_s[k];
  float* d_o = io.d_out + (size_t)b * carry_n;
  int32_t* c_o = io.c_out + (size_t)b * carry_n;
  for (size_t i = tid; i < carry_n; i += nthr) {
    const size_t k = i / blk_n, at = (size_t)phys[k] * blk_n + (i - k * blk_n);
    d_o[i] = dw[at];
    c_o[i] = cw[at];
  }
  if (plan.entry_smem) {
    float* e_o = io.e_out + (size_t)b * N;
    int32_t* ec_o = io.ec_out + (size_t)b * N;
    for (int n = tid; n < N; n += nthr) {
      e_o[n] = ent[n];
      ec_o[n] = entc[n];
    }
  }
}

int threads_for(int n) {
  const int t = (n + 31) / 32 * 32;
  return t < 64 ? 64 : (t > MAX_THREADS ? MAX_THREADS : t);
}

// Where the frame scan keeps its scores rows and its carry: the rows in
// shared memory when the two fit SMEM_LIMIT, the carry (exits, deltas,
// ctx) in what they leave.
struct ScanPlan {
  bool rows_smem, carry_smem;
  size_t smem;
};

ScanPlan scan_plan(int N, int Ns, int S) {
  const size_t rows = 2 * (size_t)S * sizeof(float);
  const size_t carry = 2 * (size_t)N * 4 + 2 * (size_t)N * Ns * 4;
  ScanPlan p;
  p.rows_smem = rows <= SMEM_LIMIT;
  const size_t room = SMEM_LIMIT - (p.rows_smem ? rows : 0);
  p.carry_smem = carry <= room;
  p.smem = (p.rows_smem ? rows : 0) + (p.carry_smem ? carry : 0);
  return p;
}

// A node's states in registers (unrolled to NS_MAX, W_MAX), else in place
// in the carry.
bool states_in_regs(int Ns, int W) { return Ns <= NS_MAX && W <= W_MAX; }

// Opt into the dynamic shared memory past 48 KB, then launch one block of
// `threads` per utterance.
template <bool CARRY_SMEM, bool ROWS_SMEM, bool REGS>
int launch(int B, int threads, size_t smem, cudaStream_t stream,
           const ScanTables& tb, const float* scores, const int32_t* n_valid,
           const float* d_in, const int32_t* c_in, float* d_out,
           int32_t* c_out, float* ex, int32_t* exc, int32_t* tb_prev,
           int32_t* tb_word, int Tc, int S, int t0) {
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        decoder_scan_kernel<CARRY_SMEM, ROWS_SMEM, REGS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  decoder_scan_kernel<CARRY_SMEM, ROWS_SMEM, REGS><<<B, threads, smem, stream>>>(
      tb, scores, n_valid, d_in, c_in, d_out, c_out, ex, exc, tb_prev,
      tb_word, Tc, S, t0);
  return (int)cudaGetLastError();
}

using LaunchFn = int (*)(int, int, size_t, cudaStream_t, const ScanTables&,
                         const float*, const int32_t*, const float*,
                         const int32_t*, float*, int32_t*, float*, int32_t*,
                         int32_t*, int32_t*, int, int, int);
// indexed by carry_smem * 4 + rows_smem * 2 + states_in_regs
constexpr LaunchFn LAUNCH[8] = {
    launch<false, false, false>, launch<false, false, true>,
    launch<false, true, false>,  launch<false, true, true>,
    launch<true, false, false>,  launch<true, false, true>,
    launch<true, true, false>,   launch<true, true, true>};

// What the n-best kernel keeps in shared memory: the selection's arrays,
// then the traceback rows where they fit, then ac where it fits.
struct FinalizePlan {
  bool rows_smem, ac_smem;
  size_t smem;
};

FinalizePlan finalize_plan(int Q, int T, int C, int R) {
  const size_t base = 16 * (size_t)R + 4 * (size_t)C;
  const size_t rows = 8 * (size_t)T, ac = 4 * (size_t)Q;
  FinalizePlan p;
  p.rows_smem = base + rows <= SMEM_LIMIT;
  const size_t used = base + (p.rows_smem ? rows : 0);
  p.ac_smem = used + ac <= SMEM_LIMIT;
  p.smem = used + (p.ac_smem ? ac : 0);
  return p;
}

template <bool ROWS_SMEM>
int launch_finalize(int B, int threads, size_t smem, cudaStream_t stream,
                    const ScanTables& tb, const float* deltas,
                    const int32_t* ctx, const int32_t* tb_prev,
                    const int32_t* tb_word, float* ac, int32_t* seqs,
                    float* scores, int T, int C, int R, int L,
                    int ac_in_smem) {
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        decoder_finalize_kernel<ROWS_SMEM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  decoder_finalize_kernel<ROWS_SMEM><<<B, threads, smem, stream>>>(
      tb, deltas, ctx, tb_prev, tb_word, ac, seqs, scores, T, C, R, L,
      ac_in_smem);
  return (int)cudaGetLastError();
}

// What the pruned scan keeps in shared memory: in order, the two scores
// rows, meta, the groups' lookahead, the exits, the carry and the entry
// row, each where it fits in what the earlier parts leave of SMEM_LIMIT.
PrunedPlan pruned_plan(int N, int Ns, int S, int K, int blk, int G) {
  const int NB = blk > 0 ? N / blk : 0;
  const size_t act = (size_t)K * blk;
  PrunedPlan p{};
  size_t used = 0;
  auto take = [&](size_t bytes, unsigned* off) {
    if (used + bytes > SMEM_LIMIT) return false;
    if (off != nullptr) *off = (unsigned)used;
    used += bytes;
    return true;
  };
  p.rows_smem = take(2 * (size_t)S * 4, nullptr);
  p.meta_smem = take(4 * (2 * (size_t)NB + 6 * (size_t)K), &p.meta_off);
  p.la_smem = take(4 * (size_t)G, &p.la_off);
  p.ex_smem = take(8 * act, &p.ex_off);
  p.carry_smem = take(8 * act * Ns, &p.carry_off);
  p.entry_smem = take(8 * (size_t)N, &p.entry_off);
  p.smem = (unsigned)used;
  return p;
}

template <bool ROWS_SMEM>
int launch_pruned(int B, int threads, cudaStream_t stream,
                  const ScanTables& tb, const PrunedTables& pt,
                  const PrunedPlan& plan, const PrunedIO& io, int Tc, int S,
                  int t0) {
  if (plan.smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        decoder_pruned_kernel<ROWS_SMEM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  decoder_pruned_kernel<ROWS_SMEM><<<B, threads, plan.smem, stream>>>(
      tb, pt, plan, io, Tc, S, t0);
  return (int)cudaGetLastError();
}

bool bad_tables(const ScanTables& tb) {
  return tb.n_nodes < 1 || tb.n_states < 1 || tb.band_w < 1 ||
         tb.n_slots < 1 || tb.lm_mode < 0 || tb.lm_mode > 2 ||
         (tb.lm_mode > 0 && tb.n_vocab < 1);
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
  if (B < 1 || Tc < 1 || S < 1 || bad_tables(tb) || tb.r_top < 1 ||
      tb.r_top > R_MAX || tb.r_top > tb.n_slots || t0 < 0)
    return (int)cudaErrorInvalidValue;
  const int N = tb.n_nodes, Ns = tb.n_states;
  const ScanPlan plan = scan_plan(N, Ns, S);
  if (!plan.carry_smem && (ex_scratch == nullptr || exc_scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const int threads = plan.carry_smem ? threads_for(N) : MAX_THREADS;
  const int which = plan.carry_smem * 4 + plan.rows_smem * 2 +
                    states_in_regs(Ns, tb.band_w);
  return LAUNCH[which](
      B, threads, plan.smem, (cudaStream_t)stream_, tb,
      static_cast<const float*>(scores), static_cast<const int32_t*>(n_valid),
      static_cast<const float*>(d_in), static_cast<const int32_t*>(c_in),
      static_cast<float*>(d_out), static_cast<int32_t*>(c_out),
      static_cast<float*>(ex_scratch), static_cast<int32_t*>(exc_scratch),
      static_cast<int32_t*>(tb_prev), static_cast<int32_t*>(tb_word), Tc, S,
      t0);
}

// 1 where the carry of an N-node, Ns-state lexicon at S senones stays in
// shared memory, 0 where it goes to device memory (and the exits to the
// scratch the caller passes).
extern "C" int decoder_scan_carry_in_smem(int N, int Ns, int S) {
  return scan_plan(N, Ns, S).carry_smem;
}
// 1 where the frame's scores row is staged in shared memory, 0 where the
// kernel reads it from device memory.
extern "C" int decoder_scan_rows_in_smem(int N, int Ns, int S) {
  return scan_plan(N, Ns, S).rows_smem;
}
// 1 where a node's states live in registers, 0 where the advance runs in
// place in the carry.
extern "C" int decoder_scan_states_in_regs(int Ns, int W) {
  return states_in_regs(Ns, W);
}
extern "C" int decoder_scan_max_r() { return R_MAX; }

// The n-best of B utterances from their final carry (deltas, ctx
// [B, N, Ns]) and traceback rows (tb_prev, tb_word [B, T]): seqs [B, C, L]
// int32 and scores [B, C] float32, written whole.  C = min(n_cand, Q)
// candidates out of R = min(Q, max(32, 2 C)) acoustic ones, L = max_words.
// ac_scratch ([B, Q] float32) is read only where
// decoder_finalize_ac_in_smem returns 0.  Returns as decoder_scan_exact.
extern "C" int decoder_finalize(const ScanTables* tables, const void* deltas,
                                const void* ctx, const void* tb_prev,
                                const void* tb_word, void* ac_scratch,
                                void* seqs, void* scores, int B, int T,
                                int C, int R, int L, void* stream_) {
  const ScanTables tb = *tables;
  if (B < 1 || T < 0 || bad_tables(tb) || C < 1 || C > R ||
      R > tb.n_slots || L < 1)
    return (int)cudaErrorInvalidValue;
  const FinalizePlan plan = finalize_plan(tb.n_slots, T, C, R);
  if (plan.smem > SMEM_LIMIT || (!plan.ac_smem && ac_scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const auto fn =
      plan.rows_smem ? &launch_finalize<true> : &launch_finalize<false>;
  return fn(B, threads_for(tb.n_slots), plan.smem, (cudaStream_t)stream_, tb,
            static_cast<const float*>(deltas),
            static_cast<const int32_t*>(ctx),
            static_cast<const int32_t*>(tb_prev),
            static_cast<const int32_t*>(tb_word),
            static_cast<float*>(ac_scratch), static_cast<int32_t*>(seqs),
            static_cast<float*>(scores), T, C, R, L, plan.ac_smem);
}

// 1 where the n-best kernel stages the traceback rows in shared memory, 0
// where its chase reads device memory.
extern "C" int decoder_finalize_rows_in_smem(int Q, int T, int C, int R) {
  return finalize_plan(Q, T, C, R).rows_smem;
}
// 1 where the slots' acoustic scores stay in shared memory, 0 where they
// go to the [B, Q] scratch the caller passes.
extern "C" int decoder_finalize_ac_in_smem(int Q, int T, int C, int R) {
  return finalize_plan(Q, T, C, R).ac_smem;
}
// The block-pruned scan of B utterances over Tc frames of scores [B, Tc,
// S] (the first at absolute frame t0): the carry (kb, deltas, ctx, entry
// row and contexts) from io's *_in to its *_out tensors, the rows written
// whole.  The scratch io names is read only where decoder_pruned_smem
// leaves that part out of shared memory.  Returns as decoder_scan_exact.
extern "C" int decoder_scan_pruned(const ScanTables* tables,
                                   const PrunedTables* pruned,
                                   const PrunedIO* io_, int B, int Tc, int S,
                                   int t0, void* stream_) {
  const ScanTables tb = *tables;
  const PrunedTables pt = *pruned;
  const PrunedIO io = *io_;
  if (B < 1 || Tc < 1 || S < 1 || bad_tables(tb) || tb.r_top < 1 ||
      tb.r_top > R_MAX || tb.r_top > tb.n_slots || t0 < 0 ||
      pt.slot_ptr == nullptr || pt.node_group == nullptr ||
      pt.group_senone == nullptr || pt.n_groups < 1 ||
      pt.block_size < 1 || pt.n_active < 1 || pt.n_active > pt.n_blocks ||
      (long long)pt.n_blocks * pt.block_size != tb.n_nodes)
    return (int)cudaErrorInvalidValue;
  const PrunedPlan plan = pruned_plan(tb.n_nodes, tb.n_states, S,
                                      pt.n_active, pt.block_size,
                                      pt.n_groups);
  if ((!plan.meta_smem && io.meta == nullptr) ||
      (!plan.la_smem && io.la == nullptr) ||
      (!plan.ex_smem && (io.ex == nullptr || io.exc == nullptr)) ||
      (!plan.carry_smem && (io.d_work == nullptr || io.c_work == nullptr)))
    return (int)cudaErrorInvalidValue;
  const auto fn =
      plan.rows_smem ? &launch_pruned<true> : &launch_pruned<false>;
  return fn(B, threads_for(pt.n_active * pt.block_size),
            (cudaStream_t)stream_, tb, pt, plan, io, Tc, S, t0);
}

extern "C" int decoder_pruned_phases() { return PRUNED_PHASES; }

// Where the pruned scan keeps each part, as bits (1 = shared memory): 1
// the scores rows, 2 meta (the block arrays), 4 the groups' lookahead, 8
// the exits, 16 the entry row, 32 the carry.
extern "C" int decoder_pruned_smem(int N, int Ns, int S, int K, int blk,
                                   int G) {
  const PrunedPlan p = pruned_plan(N, Ns, S, K, blk, G);
  return p.rows_smem | p.meta_smem << 1 | p.la_smem << 2 | p.ex_smem << 3 |
         p.entry_smem << 4 | p.carry_smem << 5;
}

extern "C" const char* decoder_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
