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
//   node_info[N, 4]   each node's group, its packed parent word (bit 0 the
//                     root-child flag, bit 1 "has a parent", bits 2.. the
//                     parent, 0 where none), its first valid word slot and
//                     its valid slot count
//   group_senone[G, Ns], group_bands[G, Ns, W]: the distinct (senone row,
//                     band row) pairs of the nodes (a few hundred against
//                     thousands of nodes), -1 where a state does not emit
//   node_slot[Q], word_slot[Q], slot_valid[Q]: the static (node, word)
//                     emission slots, in node order
//   bands[N, Ns, W]   per node, for the n-best
// Carry per utterance: deltas[N, Ns] (float32) and ctx[N, Ns] (int32, the
// packed context (h + 1)(V + 1) + l of traceback pointer h and last word l).
//
// Per frame, exactly the plain loop's arithmetic (max, select, and one add
// per term in the same order; no reduction in floating point), so the
// carry, the traceback rows and hence the n-best equal the plain loop's
// bit for bit:
//   1. the entry state of every node from the previous frame: its parent's
//      exit against the restart from that frame's best emission (strict >
//      picks the restart), ctx = (t+1)(V+1) + word for a restart;
//   2. d'[n, s] = max_k(d[n, s-k] + bands[n, s-k, k]) (strict >, k from 0:
//      the smaller offset wins a tie), ctx riding the same selects; then
//      d'[n, s] = max(d' + log_b, NEG_INF) with log_b from the frame's
//      scores row (NEG_INF where not emitting, 0 in state 0);
//   3. the exit of each node over rr = Ns-1-k, k = 1..W-1 (strict >);
//   4. the frame's best word emission over the Q slots: the top R (R = 1
//      with no LM, else min(Q, 16)) acoustic exits in lax.top_k's order
//      (descending, the lower slot first on ties), each plus its LM term
//      (the constant -word_penalty, a flat [(V+1)V] table, or a sparse
//      bigram by a lower-bound binary search in sorted keys with a
//      per-row backoff), then the first maximum;
//   5. the traceback row (prev, word) of the frame, -1 where no word.
// The entry after the last valid frame is written once at the end, so the
// carry out is the plain loop's.  Frames at or past n_valid[b] are frozen:
// rows -1, carry untouched.
//
// What bounds it.  At the decode cell (B = 256 utterances, 319 frames, the
// built-in lexicon's N = 125 nodes of Ns = 8 states, S = 606 senones) the
// scan must read the scores of the senones the lexicon names once and does
// ~40 operations per token state and frame (1e8 in all): 0.03 ms.  What
// costs is that frame t needs frame t-1: each utterance is a chain of 319
// dependent frames, and each frame needs all of its nodes (the emission is
// a reduction over all word-end slots, the entry reads other nodes'
// exits), so the time is one frame's latency (its barriers, the loads of
// its tables) x T.  At the 21,589-node synthetic lexicon the carry (N Ns 8
// B = 1.38 MB an utterance) does not fit one block's 227 KB of shared
// memory.
//
// Design:
// * Routes (scan_plan, chosen at launch).  On chip: the carry, the exits
//   and the nodes' info live in shared memory.  Where they fit one CTA's,
//   one CTA per utterance; where they fit a thread-block cluster's, the
//   smallest cluster that holds them (2-8 CTAs portable, up to 16
//   non-portable) splits each utterance's nodes into contiguous ranges,
//   one a CTA, and what crosses CTAs goes through distributed shared
//   memory: a parent's exit in another CTA, read by the entry step, and
//   each CTA's emission list, merged by every warp.  Past what a cluster
//   of 16 holds (the device-memory route) an utterance still runs on a
//   cluster, of the size that runs the batch in the fewest waves times
//   nodes a CTA while the scratch of the utterances in flight stays in L2
//   (so the batch size enters this route's plan): each CTA keeps its
//   nodes' info and both frames' exits in shared memory (past what 16
//   CTAs hold, in a device scratch, read across CTAs past L1 after the
//   cluster barrier) and the carry of as many of its nodes as fit beside
//   them; the rest of its carry lives state-major in a device scratch
//   (a warp's load of a state reads 32 adjacent nodes), converted from and
//   to the [B, N, Ns] carry at the start and end of the launch.
// * A thread owns the same nodes every frame.  The entry refresh is folded
//   into the next frame's advance: the exits (ex, exc) are double-buffered
//   by frame parity, and the owner of node n takes its entry from the
//   previous frame's exit of parent[n] and the previous frame's emission,
//   just before it advances n.  The advance is node-local (a state reads
//   only lower states of its node), so it runs in place, the states taken
//   from Ns-1 down to 0.
// * The emission in one barrier.  Each warp takes its own top R over its
//   nodes' slots under the total order (value descending, slot
//   ascending): each lane keeps its own best few, and R warp argmaxes over
//   the lanes' heads take them in order: no block barrier.  After one
//   barrier every warp merges the warps' sorted lists (by rank where they
//   are few and R > 1: an entry's place is its place in its list plus a
//   binary search in each other list; else by the same selection over
//   their entries) and picks the first maximum of the LM
//   totals itself, so every thread holds the frame's emission for the next
//   frame's entries.  In a cluster, warp 0 of each CTA first merges its
//   CTA's lists, and after the cluster barrier every warp merges the CTAs'
//   lists by that selection over their entries (a binary search in
//   another CTA's memory is a chain of remote loads).  A frame is one __syncthreads on one CTA; one
//   __syncthreads and one cluster barrier in a cluster.
// * The static tables by group: each node's band and senone rows are read
//   through its group, from copies staged in shared memory once a call
//   where they fit (else from device memory).
// * The frame's scores row is copied into shared memory two frames ahead by
//   cp.async, in three buffers, where they fit; a larger bank reads each
//   frame's row straight from device memory (ROWS_SMEM = false).
// * Ns and W are runtime values.  Up to NS_MAX and W_MAX (NSR) every
//   loop over them is unrolled to the maximum with the bound as a
//   predicate, so the node's states stay in registers (an index into a
//   register array must be a compile-time constant).  Past either (Ns =
//   2 + 2 (state_num - 2) > 16 from state_num 10 on; W = the widest live
//   transition, up to state_num) the advance runs in place on the carry
//   where it lives, shared or device memory, with runtime loops: the same
//   compares in the same order (states Ns-1 down, offsets k up, strict >).
//   Where the carry lives in device memory, registers are scarcer (512
//   threads a CTA): a node's states live there only up to 8 states and 2
//   offsets, all loaded before it is advanced; else the advance runs in
//   place on NODES_PER_THREAD nodes of a thread at once, at W <= 2 WINDOW
//   states at a time (a window's old states of all of them loaded before
//   its compares), past that a state at a time.
// * On chip or not, rows in shared memory or not, and states in registers
//   (unrolled to 8 states and 2 offsets, or on chip 16 and 8) or in place
//   make ten instantiations of one source; the cluster size and the
//   placement of the group tables, the info and exits and the carry are
//   read at run time.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>
#include <vector>

namespace {

constexpr int NS_MAX = 16;     // token states per node
constexpr int W_MAX = 8;       // band width
constexpr int WINDOW = 4;      // states a step of the in-place advance off
                               // chip loads (at band width <= 2)
constexpr int R_MAX = 16;      // candidates of the LM's two-phase emission
constexpr int PRUNED_PHASES = 6;  // the pruned scan's traced phases
constexpr int EXACT_PHASES = 5;   // the exact scan's traced phases
constexpr int MAX_THREADS = 256;  // the n-best
constexpr int LANE_TOP = 4;       // a lane's own list in a warp's top R
constexpr int SLOT_BATCH = 8;     // slots a thread reads at once there
constexpr int SCAN_THREADS = 512;  // the exact scan on chip, the pruned scan
constexpr int SCAN_WARPS = SCAN_THREADS / 32;
constexpr int NODES_PER_THREAD = 4;   // the most an on-chip thread owns
constexpr int MAX_CLUSTER = 16;       // CTAs of an utterance on chip
constexpr int PORTABLE_CLUSTER = 8;
constexpr int MERGE = R_MAX * R_MAX / 32;  // a lane's entries in a merge
constexpr int RANK_LISTS = 4;  // the most lists merged by rank
// the opt-in shared memory of one block, less room for the static arrays
constexpr size_t SMEM_LIMIT = 232448 - 1024;

// The Python side's constants, converted as torch converts them: the
// double, rounded to float32.
#define NEG_INF_F ((float)(-1e30))
#define NEG_INF_HALF_F ((float)(-1e30 / 2.0))
constexpr unsigned FULL = 0xffffffffu;
constexpr int NO_SLOT = 0x7fffffff;

}  // namespace

// Field order and types mirror ops/cuda/decoder_scan_cuda.py:_ScanTables.
struct ScanTables {
  const float* bands;          // [N, Ns, W] (the n-best's node exits)
  const int32_t* node_slot;    // [Q]
  const int32_t* word_slot;    // [Q]
  const uint8_t* slot_valid;   // [Q]
  const float* lm_flat;        // [(V+1) V] (lm_mode 1)
  const float* lm_uni;         // [V]       (lm_mode 2)
  const float* lm_rboff;       // [V+1]
  const float* lm_cbase;       // [V]
  const int32_t* lm_keys;      // [n_keys] sorted ascending
  const float* lm_vals;        // [n_keys]
  const int32_t* node_info;    // [N, 4]: group, parent word, first valid
                               // slot, valid slot count
  const int32_t* group_senone; // [G, Ns], -1 where not emitting
  const float* group_bands;    // [G, Ns, W]
  int32_t n_nodes, n_states, band_w, n_slots, n_vocab, r_top, lm_mode,
      lm_n_keys, n_groups;
  float penalty;               // the constant LM term (lm_mode 0)
};

// The block-pruned search's tables beside ScanTables; field order and types
// mirror ops/cuda/decoder_scan_cuda.py:_PrunedTables.  Per lexicon block j
// the distinct groups of its root children (rc_group[rc_ptr[j] ..
// rc_ptr[j + 1]]) and of its other nodes (dead_group), and its nodes that
// have a parent, by the parent's block a: segments src_ptr[j] ..
// src_ptr[j + 1], segment g of block a = src_block[g] holding the edges
// seg_ptr[g] .. seg_ptr[g + 1], each the parent's index in a (flow_par)
// and the child's group (flow_grp).
struct PrunedTables {
  const int32_t* rc_ptr;       // [n_blocks + 1]
  const int32_t* rc_group;
  const int32_t* dead_ptr;     // [n_blocks + 1]
  const int32_t* dead_group;
  const int32_t* src_ptr;      // [n_blocks + 1]
  const int32_t* src_block;    // [segments]
  const int32_t* seg_ptr;      // [segments + 1]
  const int32_t* flow_par;     // [edges]
  const int32_t* flow_grp;     // [edges]
  int32_t block_size, n_active, n_blocks;
};

// The pruned scan's operands ([B, ...] each, contiguous); field order
// mirrors ops/cuda/decoder_scan_cuda.py:_PrunedIO.  The carry goes from
// the *_in to the *_out tensors; d_work / c_work ([B, K blk Ns]), ex / exc
// ([B, 2 K blk]), meta ([B, 3 n_blocks + 7 K] int32) and la ([B, G]) are
// scratch, read only where the plan keeps that part out of shared memory.
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
  float* la;                   // [B, G]
  int32_t* tb_prev;            // [B, Tc]
  int32_t* tb_word;            // [B, Tc]
  long long* clocks;           // [PRUNED_PHASES] or null: block 0's cycles
                               // a phase (the row's wait and the entry row
                               // out; the lookahead; the top K and remap;
                               // the entries and the advance; the
                               // emission's lists and merge; its totals),
                               // added to
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
// This CTA's rank in its cluster.
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
// A barrier over every thread of the cluster; shared-memory writes before
// it are seen by the other CTAs' reads after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
// p (in this CTA's shared memory) at the same offset in CTA `rank`'s, as a
// generic address (distributed shared memory).
template <class T>
__device__ __forceinline__ T* cluster_map(T* p, unsigned rank) {
  unsigned long long out;
  asm volatile("mapa.u64 %0, %1, %2;"
               : "=l"(out)
               : "l"(reinterpret_cast<unsigned long long>(p)), "r"(rank));
  return reinterpret_cast<T*>(out);
}

// The total order of the emission's top-R: a before b when its value is
// larger, or equal with the smaller slot.
__device__ __forceinline__ bool before(float va, int qa, float vb, int qb) {
  return va > vb || (va == vb && qa < qb);
}

// The count of entries of the ordered list (lv, lq) [n] before (v, q): a
// binary search.
__device__ __forceinline__ int count_before(const float* lv, const int* lq,
                                            int n, float v, int q) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (before(lv[mid], lq[mid], v, q)) lo = mid + 1; else hi = mid;
  }
  return lo;
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

// float <-> int preserving the order (-0 below +0), for a max over ints
__device__ __forceinline__ int ordered(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float unordered(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// Warp-wide first-in-order (value, slot) pair (value descending, slot
// ascending, slots in [0, NO_SLOT]); every lane gets it: two warp
// reductions, the largest value (as an unsigned key: a value's zero counts
// as +0, as the order's compares count -0), then the smallest slot of it.
__device__ __forceinline__ void warp_best(float& v, int& q) {
  const unsigned key = (unsigned)ordered(v + 0.0f) ^ 0x80000000u;
  const unsigned top = __reduce_max_sync(FULL, key);
  q = (int)__reduce_min_sync(FULL, key == top ? (unsigned)q : 0xffffffffu);
  v = unordered((int)(top ^ 0x80000000u));
}

// The warp-wide max of v (a zero as +0); every lane gets it.
__device__ __forceinline__ float warp_max(float v) {
  return unordered(__reduce_max_sync(FULL, ordered(v + 0.0f)));
}

// The warp's top R (value, slot) pairs in the total order, written to
// out_v / out_q [R] ((-inf, NO_SLOT) past the candidates).  Each lane
// keeps its own best LANE_TOP candidates of what is left, sorted, and the
// warp takes R argmaxes over the lanes' heads; the winner's lane drops its
// head and, once its list is empty, rescans its candidates for the next
// LANE_TOP after the last one it gave.  A lane scans its candidates about
// once, however large R; for R = 1 it keeps only its best (no list to
// sort).  each(take) calls take(value, slot) for every candidate of this
// lane.
template <class Each>
__device__ __forceinline__ void warp_top(int R, Each each, float* out_v,
                                         int* out_q) {
  const int lane = threadIdx.x & 31;
  if (R == 1) {
    float bv = -INFINITY;   // below every slot's value (>= NEG_INF)
    int bq = NO_SLOT;
    each([&](float a, int s) {
      if (before(a, s, bv, bq)) {
        bv = a;
        bq = s;
      }
    });
    warp_best(bv, bq);   // (-inf, NO_SLOT) where no lane has one
    if (lane == 0) {
      out_v[0] = bv;
      out_q[0] = bq;
    }
    return;
  }
  float v[LANE_TOP];
  int q[LANE_TOP];
  bool more = false;     // candidates past the list remain
  float pv = 0.0f;       // the last pair this lane gave
  int pq = -1;
  auto fill = [&](bool after_last) {
#pragma unroll
    for (int i = 0; i < LANE_TOP; ++i) {
      v[i] = -INFINITY;   // below every slot's value (>= NEG_INF)
      q[i] = NO_SLOT;
    }
    int n = 0;
    each([&](float a, int s) {
      if (after_last && !before(pv, pq, a, s)) return;
      ++n;
      if (!before(a, s, v[LANE_TOP - 1], q[LANE_TOP - 1])) return;
      v[LANE_TOP - 1] = a;
      q[LANE_TOP - 1] = s;
#pragma unroll
      for (int i = LANE_TOP - 1; i > 0; --i)
        if (before(v[i], q[i], v[i - 1], q[i - 1])) {
          const float tv = v[i];
          const int tq = q[i];
          v[i] = v[i - 1];
          q[i] = q[i - 1];
          v[i - 1] = tv;
          q[i - 1] = tq;
        }
    });
    more = n > LANE_TOP;
  };
  fill(false);
  int r = 0;
  for (; r < R; ++r) {
    float bv = v[0];
    int bq = q[0];
    warp_best(bv, bq);
    if (bq == NO_SLOT) break;   // every lane is out: the same in every lane
    if (lane == 0) {
      out_v[r] = bv;
      out_q[r] = bq;
    }
    if (q[0] == bq) {   // this lane's head: drop it
      pv = bv;
      pq = bq;
#pragma unroll
      for (int i = 0; i + 1 < LANE_TOP; ++i) {
        v[i] = v[i + 1];
        q[i] = q[i + 1];
      }
      v[LANE_TOP - 1] = -INFINITY;
      q[LANE_TOP - 1] = NO_SLOT;
      if (q[0] == NO_SLOT && more) fill(true);
    }
  }
  for (int k = r + lane; k < R; k += 32) {
    out_v[k] = -INFINITY;
    out_q[k] = NO_SLOT;
  }
}

// Lane r's pair of the warp's scratch list out_v / out_q [R] ((-inf,
// NO_SLOT) past R), after the warp wrote it; the scratch is free again on
// return.
__device__ __forceinline__ void lane_pair(int R, const float* out_v,
                                          const int* out_q, float& my_v,
                                          int& my_q) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  my_v = lane < R ? out_v[lane] : -INFINITY;
  my_q = lane < R ? out_q[lane] : NO_SLOT;
  __syncwarp();
}

// The top R of L ordered lists of R pairs (list l at lv(l), lq(l); L R <=
// 32 MERGE), by warp_top over the lanes' entries through the warp's
// scratch out_v / out_q [R]; lane r gets the r-th pair.
template <class ListV, class ListQ>
__device__ __forceinline__ void warp_merge(int L, int R, ListV lv, ListQ lq,
                                           float* out_v, int* out_q,
                                           float& my_v, int& my_q) {
  const int lane = threadIdx.x & 31;
  if (R == 1) {   // one pass over one entry a list
    my_v = lane < L ? lv(lane)[0] : -INFINITY;
    my_q = lane < L ? lq(lane)[0] : NO_SLOT;
    warp_best(my_v, my_q);
    if (lane > 0) {
      my_v = -INFINITY;
      my_q = NO_SLOT;
    }
    return;
  }
  float ev[MERGE];
  int eq[MERGE];
#pragma unroll
  for (int k = 0; k < MERGE; ++k) {
    const int e = lane + 32 * k, l = e / R;
    ev[k] = -INFINITY;
    eq[k] = NO_SLOT;
    if (l < L) {
      ev[k] = lv(l)[e - l * R];
      eq[k] = lq(l)[e - l * R];
    }
  }
  warp_top(R, [&](auto&& take) {
#pragma unroll
    for (int k = 0; k < MERGE; ++k)
      if (eq[k] != NO_SLOT) take(ev[k], eq[k]);
  }, out_v, out_q);
  lane_pair(R, out_v, out_q, my_v, my_q);
}

// The entries first, first + step, ... of L ordered lists of R pairs
// (list l at lv(l), lq(l)) placed by rank into out_v / out_q: an entry's
// rank is its position in its list plus, in each other list, the count of
// entries before it (a binary search; a slot is in one list at most, so
// the ranks are distinct); the entries of rank < R go in place.
template <class ListV, class ListQ>
__device__ __forceinline__ void place_by_rank(int L, int R, ListV lv,
                                              ListQ lq, int first, int step,
                                              float* out_v, int* out_q) {
  for (int e = first; e < L * R; e += step) {
    const int l = e / R, pos = e - l * R;
    const float v = lv(l)[pos];
    const int q = lq(l)[pos];
    if (q == NO_SLOT) continue;   // past the list's pairs
    int rank = pos;
    for (int o = 0; o < L && rank < R; ++o)
      if (o != l) rank += count_before(lv(o), lq(o), R, v, q);
    if (rank < R) {
      out_v[rank] = v;
      out_q[rank] = q;
    }
  }
}

// The top R of L ordered lists in this CTA's shared memory: by rank where
// R > 1 and the lists are few (RANK_LISTS: a few binary searches an
// entry), through the warp's scratch out_v / out_q [R], else by
// warp_merge; lane r gets the r-th pair.
template <class ListV, class ListQ>
__device__ __forceinline__ void merge_lists(int L, int R, ListV lv, ListQ lq,
                                            float* out_v, int* out_q,
                                            float& my_v, int& my_q) {
  if (R > 1 && L <= RANK_LISTS) {
    const int lane = threadIdx.x & 31;
    if (lane < R) {
      out_v[lane] = -INFINITY;
      out_q[lane] = NO_SLOT;
    }
    __syncwarp();
    place_by_rank(L, R, lv, lq, lane, 32, out_v, out_q);
    lane_pair(R, out_v, out_q, my_v, my_q);
  } else {
    warp_merge(L, R, lv, lq, out_v, out_q, my_v, my_q);
  }
}

// The frame's word emission from the top R pairs (lane r holds the r-th):
// each plus its LM term on (its exit context % (V + 1), its word), then the
// first maximum; ctx_of(node) is the node's exit context.  Every lane gets
// the total, the word (-1 where none) and the traceback pointer.
template <class CtxOf>
__device__ __forceinline__ void pick(const ScanTables& tb, float v, int q,
                                     CtxOf ctx_of, float& e_score, int& word,
                                     int& prev) {
  const int lane = threadIdx.x & 31, vp1 = tb.n_vocab + 1;
  float tot = -INFINITY;  // lanes past R never win
  int w = -1, cr = 0;
  if (lane < tb.r_top) {
    tot = NEG_INF_F;      // the plain loop's NEG_INF picks
    if (q != NO_SLOT) {
      w = tb.word_slot[q];
      cr = ctx_of(tb.node_slot[q]);
      const float lm = lm_term(tb, cr % vp1, w);
      tot = v > NEG_INF_HALF_F ? v + lm : NEG_INF_F;
    }
  }
  int idx = 0;   // first maximum over the R candidates
  if (tb.r_top > 1) {
    idx = lane;
    warp_best(tot, idx);
  }
  tot = __shfl_sync(FULL, tot, idx);
  w = __shfl_sync(FULL, w, idx);
  cr = __shfl_sync(FULL, cr, idx);
  const bool valid = tot > NEG_INF_HALF_F;
  e_score = tot;
  word = valid ? w : -1;
  prev = valid ? cr / vp1 - 1 : -1;
}

// A node's states d / c are d[s * ds], c[s * ds]: ds = 1 where the carry
// is node-major, the node count of the carry's rows where it is
// state-major (in shared memory: a warp's lanes then read consecutive
// words, free of bank conflicts).

// The exit of one node from its states d / c (Ns of them) and its bands
// bn [Ns, W]: device.py's _exit_of, k = 1..W-1 ascending, strict >, from
// NEG_INF and context V.  Returns the exit score; *ectx its packed context.
__device__ __forceinline__ float states_exit(const ScanTables& tb,
                                             const float* d, const int32_t* c,
                                             int ds, const float* bn,
                                             int* ectx) {
  const int Ns = tb.n_states, W = tb.band_w;
  float e = NEG_INF_F;
  int ec = tb.n_vocab;
  for (int k = 1; k < W; ++k) {
    const int rr = Ns - 1 - k;
    if (rr < 0) break;
    const float cand = d[rr * ds] + bn[rr * W + k];
    if (cand > e) { e = cand; ec = c[rr * ds]; }
  }
  *ectx = ec;
  return e;
}

// The exit of node n from the full carry d / c ([N, Ns]).
__device__ __forceinline__ float node_exit(const ScanTables& tb,
                                           const float* d, const int32_t* c,
                                           int n, int* ectx) {
  const size_t base = (size_t)n * tb.n_states;
  return states_exit(tb, d + base, c + base, 1, tb.bands + base * tb.band_w,
                     ectx);
}

// The banded advance of one node in place, where its states d / c live
// (shared or device memory), against its bands bn [Ns, W] and senones
// sn [Ns] on the frame's scores row: device.py's
// _advance and the clamp, states Ns-1 down (a state reads only lower states
// of its node, so no second buffer), offsets k up, strict >; log_b is the
// row's score where the state emits, NEG_INF where not, 0 in state 0.
__device__ __forceinline__ void advance_in_place(const ScanTables& tb,
                                                 float* d, int32_t* c, int ds,
                                                 const float* bn,
                                                 const int32_t* sn,
                                                 const float* row) {
  const int Ns = tb.n_states, W = tb.band_w, V = tb.n_vocab;
  for (int s = Ns - 1; s >= 0; --s) {
    float best = NEG_INF_F;
    int bctx = V;
    for (int k = 0; k < W && k <= s; ++k) {
      const float cand = d[(s - k) * ds] + bn[(s - k) * W + k];
      if (cand > best) { best = cand; bctx = c[(s - k) * ds]; }
    }
    float lb = 0.0f;
    if (s > 0) {
      const int sen = sn[s];
      lb = sen >= 0 ? row[sen] : NEG_INF_F;
    }
    const float x = best + lb;
    d[s * ds] = x < NEG_INF_F ? NEG_INF_F : x;   // torch.clamp(min=NEG_INF)
    c[s * ds] = bctx;
  }
}

// The same advance with the node's states in registers (unrolled to
// NSR <= NS_MAX states and WR <= W_MAX offsets), state 0 entering as
// (d0, c0); the states past 0 are written back (the next entry replaces
// state 0), and the exit returned (*ectx its context).
template <int NSR, int WR>
__device__ __forceinline__ float advance_regs(const ScanTables& tb, float* dn,
                                             int32_t* cn, int ds, float d0,
                                             int c0, const float* bn,
                                             const int32_t* sn,
                                             const float* row, int* ectx) {
  const int Ns = tb.n_states, W = tb.band_w, V = tb.n_vocab;
  float d[NSR];
  int c[NSR];
  d[0] = d0;
  c[0] = c0;
#pragma unroll
  for (int s = 1; s < NSR; ++s)
    if (s < Ns) { d[s] = dn[s * ds]; c[s] = cn[s * ds]; }
#pragma unroll
  for (int s = NSR - 1; s >= 0; --s) {
    if (s >= Ns) continue;
    float best = NEG_INF_F;
    int bctx = V;
#pragma unroll
    for (int k = 0; k < WR && k <= s; ++k) {
      if (k >= W) break;
      const float cand = d[s - k] + bn[(s - k) * W + k];
      if (cand > best) { best = cand; bctx = c[s - k]; }
    }
    float lb = 0.0f;
    if (s > 0) {
      const int sen = sn[s];
      lb = sen >= 0 ? row[sen] : NEG_INF_F;
    }
    const float x = best + lb;
    d[s] = x < NEG_INF_F ? NEG_INF_F : x;   // torch.clamp(min=NEG_INF)
    c[s] = bctx;
  }
  float e = NEG_INF_F;
  int ec = V;
#pragma unroll
  for (int k = 1; k < WR; ++k) {
    if (k >= W) break;
    const int rr = Ns - 1 - k;
#pragma unroll
    for (int s = 0; s < NSR; ++s) {
      if (s == rr) {
        const float cand = d[s] + bn[s * W + k];
        if (cand > e) { e = cand; ec = c[s]; }
      }
    }
  }
#pragma unroll
  for (int s = 1; s < NSR; ++s)
    if (s < Ns) { dn[s * ds] = d[s]; cn[s * ds] = c[s]; }
  *ectx = ec;
  return e;
}

// advance_in_place and states_exit of U nodes at once at band width W <=
// 2, for a carry in device memory: the states are taken WINDOW at a time
// from the top, each window's old states and the one below it loaded for
// all U nodes before any compare (a state reads only itself and the state
// below, not yet advanced), so a frame waits on about Ns / WINDOW rounds
// of loads.  The same compares in the same order (k = 0, then 1); the
// exit is taken from the exit state as the advance writes it.  ex / exc
// [U] get the exits.
template <int U>
__device__ __forceinline__ void advance_window(
    const ScanTables& tb, float* const* d, int32_t* const* c, const int* ds,
    const float* const* bn, const int32_t* const* sn, const bool* act,
    const float* row, float* ex, int* exc) {
  const int Ns = tb.n_states, W = tb.band_w, V = tb.n_vocab;
#pragma unroll
  for (int j = 0; j < U; ++j) {
    ex[j] = NEG_INF_F;
    exc[j] = V;
  }
  for (int hi = Ns - 1; hi >= 0; hi -= WINDOW) {
    const int lo = hi - WINDOW;   // x[.][i] is the old state lo + i
    float x[U][WINDOW + 1];
    int xc[U][WINDOW + 1];
#pragma unroll
    for (int j = 0; j < U; ++j)
#pragma unroll
      for (int i = 0; i <= WINDOW; ++i) {
        const bool live = act[j] && lo + i >= 0;
        x[j][i] = live ? d[j][(lo + i) * ds[j]] : 0.0f;
        xc[j][i] = live ? c[j][(lo + i) * ds[j]] : 0;
      }
#pragma unroll
    for (int i = WINDOW; i >= 1; --i) {
      const int s = lo + i;
      if (s < 0) continue;
      const int k_exit = Ns - 1 - s;
#pragma unroll
      for (int j = 0; j < U; ++j) {
        if (!act[j]) continue;
        float best = NEG_INF_F;
        int bctx = V;
        float cand = x[j][i] + bn[j][s * W];            // k = 0
        if (cand > best) {
          best = cand;
          bctx = xc[j][i];
        }
        if (W > 1 && s >= 1) {                         // k = 1
          cand = x[j][i - 1] + bn[j][(s - 1) * W + 1];
          if (cand > best) {
            best = cand;
            bctx = xc[j][i - 1];
          }
        }
        float lb = 0.0f;
        if (s > 0) {
          const int sen = sn[j][s];
          lb = sen >= 0 ? row[sen] : NEG_INF_F;
        }
        float y = best + lb;
        y = y < NEG_INF_F ? NEG_INF_F : y;   // torch.clamp(min=NEG_INF)
        d[j][s * ds[j]] = y;
        c[j][s * ds[j]] = bctx;
        if (k_exit >= 1 && k_exit < W) {
          cand = y + bn[j][s * W + k_exit];
          if (cand > ex[j]) {
            ex[j] = cand;
            exc[j] = bctx;
          }
        }
      }
    }
  }
}

// The entry of a node (state 0 for the next frame) from the parent's exit
// (x, xc) and the previous frame's emission: device.py's _enter, strict >
// picks the restart; a parentless node takes the exit context of node 0 as
// the plain loop's clipped gather does.
__device__ __forceinline__ void entry_of(int pword, float x, int xc,
                                         float e_score, int re_ctx, float* d0,
                                         int* c0) {
  const float flow = (pword & 2) ? x : NEG_INF_F;
  const float restart = (pword & 1) ? e_score : NEG_INF_F;
  const bool use_restart = restart > flow;
  *d0 = use_restart ? restart : flow;
  *c0 = use_restart ? re_ctx : xc;
}

// Where the exact scan keeps what.  `onchip`: the carry, the exits and the
// nodes' info in shared memory, over `cs` CTAs of `chunk` nodes each.  Not
// on chip (the device-memory route): also `cs` CTAs of `chunk` nodes, each
// with its nodes' info and exits in shared memory where they fit
// (`ex_smem`; else in the scratch), and the carry of its first `in_nodes`
// nodes in shared memory, of the rest in the scratch (state-major both);
// `scratch_words` float32 and int32 words an utterance in the scratch.
// The three scores rows and the group tables each in shared memory where
// they fit.  Byte offsets into the dynamic shared memory: the emission's
// lists first, at 0.
struct ScanPlan {
  int onchip, cs, chunk, threads, rows_smem, groups_smem, in_nodes, ex_smem;
  unsigned rows_off, groups_off, info_off, ex_off, carry_off, smem;
  long long scratch_words;
};

template <bool ONCHIP, bool ROWS_SMEM, int NSR, int WR>
__global__ void __launch_bounds__(SCAN_THREADS)
decoder_scan_kernel(const ScanTables tb, const ScanPlan plan,
                    const float* __restrict__ scores,
                    const int32_t* __restrict__ n_valid,
                    const float* __restrict__ d_in,
                    const int32_t* __restrict__ c_in, float* d_out,
                    int32_t* c_out, float* scratch_f, int32_t* scratch_i,
                    int32_t* __restrict__ tb_prev,
                    int32_t* __restrict__ tb_word, int Tc, int S, int t0,
                    long long* clocks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cs = plan.cs;
  const int rank = cs > 1 ? (int)cluster_rank() : 0;
  const int b = blockIdx.x / cs;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, warps = nthr >> 5;
  const int N = tb.n_nodes, Ns = tb.n_states, W = tb.band_w;
  const int V = tb.n_vocab, R = tb.r_top, vp1 = V + 1;
  const int chunk = plan.chunk;
  const int lo = rank * chunk;                  // this CTA's first node
  const int n_own = max(0, min(N - lo, chunk));
  // nodes of this CTA whose carry is in shared memory (the first ones),
  // and the stride of the rest's in the scratch
  const int in_nodes = ONCHIP ? chunk : plan.in_nodes;
  const int out_nodes = chunk - in_nodes;
  const bool ex_smem = ONCHIP || plan.ex_smem;

  // shared memory: the warps' lists [2][SCAN_WARPS][R], the CTA's [2][R]
  // and the warps' merge scratch [SCAN_WARPS][R] (values, then slots each)
  // | scores rows [3][S] | group tables | (ex_smem) node info [chunk] |
  // exits [2][chunk] and contexts | carry [Ns][in_nodes] by state
  float* wl_v = reinterpret_cast<float*>(smem_raw);
  int* wl_q = reinterpret_cast<int*>(wl_v + 2 * SCAN_WARPS * R);
  float* cl_v = reinterpret_cast<float*>(wl_q + 2 * SCAN_WARPS * R);
  int* cl_q = reinterpret_cast<int*>(cl_v + 2 * R);
  float* mo_v = reinterpret_cast<float*>(cl_q + 2 * R) + warp * R;
  int* mo_q = reinterpret_cast<int*>(mo_v - warp * R + SCAN_WARPS * R) +
              warp * R;
  float* srow = reinterpret_cast<float*>(smem_raw + plan.rows_off);
  const int32_t* gsen = tb.group_senone;
  const float* gband = tb.group_bands;
  if (plan.groups_smem) {
    const size_t n_sen = (size_t)tb.n_groups * Ns;
    int32_t* s_sen = reinterpret_cast<int32_t*>(smem_raw + plan.groups_off);
    float* s_band = reinterpret_cast<float*>(s_sen + n_sen);
    for (size_t j = tid; j < n_sen; j += nthr) s_sen[j] = gsen[j];
    for (size_t j = tid; j < n_sen * W; j += nthr) s_band[j] = gband[j];
    gsen = s_sen;
    gband = s_band;
  }
  const int4* info;
  float* ex;
  int32_t* exc;
  // the carry by state: node l < in_nodes at dc[l + s * in_nodes], the
  // others (not on chip) at dg[l - in_nodes + s * out_nodes]
  float* dc = reinterpret_cast<float*>(smem_raw + plan.carry_off);
  int32_t* cc = reinterpret_cast<int32_t*>(dc + (size_t)in_nodes * Ns);
  float* dg = nullptr;
  int32_t* cg = nullptr;
  const float* din = d_in + ((size_t)b * N + lo) * Ns;
  const int32_t* cin = c_in + ((size_t)b * N + lo) * Ns;
  const size_t carry_n = (size_t)n_own * Ns;
  if (!ONCHIP) {   // this utterance's scratch: carries, then exits
    float* xf = scratch_f + (size_t)b * plan.scratch_words;
    int32_t* xi = scratch_i + (size_t)b * plan.scratch_words;
    dg = xf + (size_t)rank * Ns * out_nodes;
    cg = xi + (size_t)rank * Ns * out_nodes;
    ex = xf + (size_t)cs * Ns * out_nodes + (size_t)rank * 2 * chunk;
    exc = xi + (size_t)cs * Ns * out_nodes + (size_t)rank * 2 * chunk;
  }
  if (ex_smem) {
    // each node's parent word re-packed as (CTA << 24 | index in it << 2)
    int4* s_info = reinterpret_cast<int4*>(smem_raw + plan.info_off);
    const int4* g_info = reinterpret_cast<const int4*>(tb.node_info) + lo;
    for (int l = tid; l < n_own; l += nthr) {
      int4 v = g_info[l];
      const int p = v.y >> 2, cta = p / chunk;
      v.y = (v.y & 3) | (p - cta * chunk) << 2 | cta << 24;
      s_info[l] = v;
    }
    info = s_info;
    ex = reinterpret_cast<float*>(smem_raw + plan.ex_off);
    exc = reinterpret_cast<int32_t*>(ex + 2 * chunk);
  } else {
    info = reinterpret_cast<const int4*>(tb.node_info) + lo;
  }
  // node l's states: *d, *c and the stride between them
  auto states_of = [&](int l, float** d, int32_t** c) {
    if (ONCHIP || l < in_nodes) {
      *d = dc + l;
      *c = cc + l;
      return in_nodes;
    }
    *d = dg + (l - in_nodes);
    *c = cg + (l - in_nodes);
    return out_nodes;
  };
  for (size_t j = tid; j < carry_n; j += nthr) {
    const int l = (int)(j / Ns), s = (int)(j - (size_t)l * Ns);
    float* d;
    int32_t* c;
    const int ds = states_of(l, &d, &c);
    d[s * ds] = din[j];
    c[s * ds] = cin[j];
  }

  const int nv = min(Tc, max(n_valid[b], 0));
  const float* sc_b = scores + (size_t)b * Tc * S;
  if (ROWS_SMEM) {   // rows 0 and 1 in flight, then wait for row 0
    for (int r = 0; r < 2; ++r) {
      if (r < nv)
        for (int j = tid; j < S; j += nthr)
          cp_async_f32(srow + r * S + j, sc_b + (size_t)r * S + j);
      cp_async_commit();
    }
    cp_async_wait_one();
  }
  __syncthreads();
  // the phases' cycles in block 0, summed over its frames, where clocks is
  // given (EXACT_PHASES of them: the row wait and the barrier, the entries,
  // advance and exits, the emission's lists and merges, the pick, the
  // entry after the last frame)
  const bool trace = clocks != nullptr && b == 0 && rank == 0 && tid == 0;
  long long tick = trace ? clock64() : 0, spent[EXACT_PHASES] = {};
  auto mark = [&](int phase) {   // summed in registers, added at the end
    if (trace) {
      const long long now = clock64();
      spent[phase] += now - tick;
      tick = now;
    }
  };
  // where node `at` (an index into the CTA's exits [2][chunk]) of CTA `cta`
  // has its exit: in its shared memory (distributed shared memory for
  // another CTA's) or its part of the scratch, read past L1 (another CTA
  // wrote it)
  auto exit_at = [&](int cta, int at, int* xc) {
    if (ex_smem) {
      const float* e = ex;
      const int32_t* c = exc;
      if (cta != rank) {
        e = cluster_map(e, cta);
        c = cluster_map(c, cta);
      }
      *xc = c[at];
      return e[at];
    }
    const long long o = (long long)(cta - rank) * 2 * chunk + at;
    *xc = __ldcg(exc + o);
    return __ldcg(ex + o);
  };
  // a node's previous-frame exit (buffer `buf`) by its parent word
  // (re-packed where the info is in shared memory)
  auto parent_exit = [&](int pword, int buf, int* xc) {
    int cta, idx;
    if (ex_smem) {
      cta = pword >> 24;
      idx = pword >> 2 & 0x3fffff;
    } else {
      const int p = pword >> 2;
      cta = p / chunk;
      idx = p - cta * chunk;
    }
    return exit_at(cta, buf * chunk + idx, xc);
  };
  auto ctx_of = [&](int buf, int node) {
    const int cta = node / chunk;
    int xc;
    exit_at(cta, buf * chunk + node - cta * chunk, &xc);
    return xc;
  };

  float e_prev = NEG_INF_F;   // the previous frame's emission
  int re_prev = 0;            // and its restart context
  for (int i = 0; i < nv; ++i) {
    const int cur = i & 1, prv = cur ^ 1;
    const float* row;
    if (ROWS_SMEM) {
      row = srow + (i % 3) * S;
      if (i + 2 < nv) {
        float* next = srow + ((i + 2) % 3) * S;
        const float* src = sc_b + (size_t)(i + 2) * S;
        for (int j = tid; j < S; j += nthr) cp_async_f32(next + j, src + j);
      }
      cp_async_commit();   // an empty group past the end keeps the count
    } else {
      row = sc_b + (size_t)i * S;
    }

    // 1-3. each owned node: its entry, the advance, its exit
    float* ex_c = ex + cur * chunk;
    int32_t* exc_c = exc + cur * chunk;
    if constexpr (ONCHIP) {
      for (int l = tid; l < n_own; l += nthr) {
        const int4 nf = info[l];
        float* dn = dc + l;
        int32_t* cn = cc + l;
        float d0;
        int c0;
        if (i > 0) {
          int xc;
          const float x = parent_exit(nf.y, prv, &xc);
          entry_of(nf.y, x, xc, e_prev, re_prev, &d0, &c0);
        } else {
          d0 = dn[0];
          c0 = cn[0];
        }
        const float* bn = gband + (size_t)nf.x * Ns * W;
        const int32_t* sn = gsen + (size_t)nf.x * Ns;
        float e;
        int ectx;
        if constexpr (NSR > 0) {
          e = advance_regs<NSR, WR>(tb, dn, cn, chunk, d0, c0, bn, sn, row,
                                    &ectx);
        } else {
          dn[0] = d0;
          cn[0] = c0;
          advance_in_place(tb, dn, cn, chunk, bn, sn, row);
          e = states_exit(tb, dn, cn, chunk, bn, &ectx);
        }
        ex_c[l] = e;
        exc_c[l] = ectx;
      }
    } else {
      // where the states live in registers, one node at a time (all of its
      // states loaded at once; more nodes would spill); else
      // NODES_PER_THREAD nodes in place: their entries at once, then at
      // band width <= 2 each window's loads at once, past it one node after
      // another
      constexpr int U = NSR > 0 ? 1 : NODES_PER_THREAD;
      for (int l0 = tid; l0 < n_own; l0 += nthr * U) {
        float* dn[U];
        int32_t* cn[U];
        int dsn[U], pw[U], ectx[U];
        const float* bn[U];
        const int32_t* sn[U];
        bool act[U];
        float d0[U], e[U];
        int c0[U];
#pragma unroll
        for (int j = 0; j < U; ++j) {
          const int l = l0 + j * nthr;
          act[j] = l < n_own;
          const int la = act[j] ? l : l0;
          dsn[j] = states_of(la, &dn[j], &cn[j]);
          const int4 nf = info[la];
          pw[j] = nf.y;
          bn[j] = gband + (size_t)nf.x * Ns * W;
          sn[j] = gsen + (size_t)nf.x * Ns;
        }
#pragma unroll
        for (int j = 0; j < U; ++j) {
          if (i > 0) {
            int xc;
            const float x = parent_exit(pw[j], prv, &xc);
            entry_of(pw[j], x, xc, e_prev, re_prev, &d0[j], &c0[j]);
          } else {
            d0[j] = dn[j][0];
            c0[j] = cn[j][0];
          }
        }
        if constexpr (NSR > 0) {   // U = 1: act[0] holds
          e[0] = advance_regs<NSR, WR>(tb, dn[0], cn[0], dsn[0], d0[0], c0[0],
                                       bn[0], sn[0], row, &ectx[0]);
        } else {
#pragma unroll
          for (int j = 0; j < U; ++j)
            if (act[j]) {
              dn[j][0] = d0[j];
              cn[j][0] = c0[j];
            }
          if (W <= 2) {
            advance_window<U>(tb, dn, cn, dsn, bn, sn, act, row, e, ectx);
          } else {
#pragma unroll
            for (int j = 0; j < U; ++j)
              if (act[j]) {
                advance_in_place(tb, dn[j], cn[j], dsn[j], bn[j], sn[j], row);
                e[j] = states_exit(tb, dn[j], cn[j], dsn[j], bn[j], &ectx[j]);
              }
          }
        }
#pragma unroll
        for (int j = 0; j < U; ++j)
          if (act[j]) {
            ex_c[l0 + j * nthr] = e[j];
            exc_c[l0 + j * nthr] = ectx[j];
          }
      }
    }
    mark(1);

    // 4. this warp's top R over its nodes' slots, then every warp merges
    // the lists (in a cluster: each CTA's, then the CTAs')
    float* wv = wl_v + cur * SCAN_WARPS * R;
    int* wq = wl_q + cur * SCAN_WARPS * R;
    if constexpr (ONCHIP) {   // at most NODES_PER_THREAD nodes a thread:
      float ce[NODES_PER_THREAD];   // their exits and valid slots held
      int c0[NODES_PER_THREAD], c1[NODES_PER_THREAD];
#pragma unroll
      for (int j = 0; j < NODES_PER_THREAD; ++j) {
        const int l = tid + j * nthr;
        c0[j] = c1[j] = 0;
        ce[j] = NEG_INF_F;
        if (l < n_own) {
          ce[j] = ex_c[l];
          if (ce[j] > NEG_INF_HALF_F) {   // else its slots score NEG_INF
            c0[j] = info[l].z;
            c1[j] = c0[j] + info[l].w;
          }
        }
      }
      warp_top(R, [&](auto&& take) {
#pragma unroll
        for (int j = 0; j < NODES_PER_THREAD; ++j)
          for (int s = c0[j]; s < c1[j]; ++s) take(ce[j], s);
      }, wv + warp * R, wq + warp * R);
    } else {
      warp_top(R, [&](auto&& take) {
        for (int l = tid; l < n_own; l += nthr) {
          const float e = ex_c[l];
          if (!(e > NEG_INF_HALF_F)) continue;   // its slots score NEG_INF
          const int4 nf = info[l];   // its valid slots
          for (int s = nf.z; s < nf.z + nf.w; ++s) take(e, s);
        }
      }, wv + warp * R, wq + warp * R);
    }
    mark(2);
    if (ROWS_SMEM) cp_async_wait_one();   // row i + 1 (this thread's part)
    __syncthreads();
    mark(0);
    auto warp_lists_v = [&](int w) { return wv + w * R; };
    auto warp_lists_q = [&](int w) { return wq + w * R; };
    float v;
    int q;
    if (cs == 1) {
      merge_lists(warps, R, warp_lists_v, warp_lists_q, mo_v, mo_q, v, q);
    } else {
      float* cv = cl_v + cur * R;
      int* cq = cl_q + cur * R;
      if (warp == 0) {
        merge_lists(warps, R, warp_lists_v, warp_lists_q, mo_v, mo_q, v, q);
        if (lane < R) {
          cv[lane] = v;
          cq[lane] = q;
        }
      }
      cluster_sync();
      warp_merge(cs, R, [&](int c) { return cluster_map(cv, c); },
                 [&](int c) { return cluster_map(cq, c); }, mo_v, mo_q, v,
                 q);
    }
    mark(2);

    // 5. the pick and the traceback row
    int word, prev;
    pick(tb, v, q, [&](int node) { return ctx_of(cur, node); }, e_prev, word,
         prev);
    re_prev = (t0 + i + 1) * vp1 + (word >= 0 ? word : V);
    if (rank == 0 && tid == 0) {
      tb_prev[(size_t)b * Tc + i] = prev;
      tb_word[(size_t)b * Tc + i] = word;
    }
    mark(3);
  }
  // the entry after the last frame
  if (nv > 0) {
    const int last = (nv - 1) & 1;
    for (int l = tid; l < n_own; l += nthr) {
      const int pword = info[l].y;
      int xc;
      const float x = parent_exit(pword, last, &xc);
      float* d;
      int32_t* c;
      states_of(l, &d, &c);
      entry_of(pword, x, xc, e_prev, re_prev, d, c);
    }
  }
  mark(4);
  if (trace)
    for (int k = 0; k < EXACT_PHASES; ++k) clocks[k] += spent[k];
  if (ROWS_SMEM) cp_async_wait_all();
  if (rank == 0)
    for (int i = nv + tid; i < Tc; i += nthr) {
      tb_prev[(size_t)b * Tc + i] = -1;
      tb_word[(size_t)b * Tc + i] = -1;
    }
  __syncthreads();
  float* dout = d_out + ((size_t)b * N + lo) * Ns;
  int32_t* cout = c_out + ((size_t)b * N + lo) * Ns;
  for (size_t j = tid; j < carry_n; j += nthr) {
    const int l = (int)(j / Ns), s = (int)(j - (size_t)l * Ns);
    float* d;
    int32_t* c;
    const int ds = states_of(l, &d, &c);
    dout[j] = d[s * ds];
    cout[j] = c[s * ds];
  }
  if (cs > 1) cluster_sync();   // no CTA leaves while another reads it
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
//   1. the exit of each slot's node from the final carry (node_exit's
//      compares, the nodes and exit states of SLOT_BATCH slots a thread
//      loaded together) and the slot's acoustic score ac[q] (NEG_INF where
//      the slot is not valid or the exit is at or below NEG_INF / 2);
//   2. the top R = min(Q, max(32, 2 C)) slots in _top_k's order (value
//      descending, the lower slot first among equals): each warp's top R
//      over its threads' slots (warp_top: a lane's own few best, R warp
//      argmaxes over the lanes' heads), then each entry of the warps' lists
//      placed by its rank (place_by_rank: its place in its list plus a
//      binary search in each other list; the slots are distinct, so are the
//      ranks), the scan's selection and merge;
//   3. each of the R candidates' LM term on (its exit context % (V + 1),
//      its word) and its total (one float add, NEG_INF where the acoustic
//      score is at or below NEG_INF / 2);
//   4. the top C of the R totals in the same order, each total placed by
//      its rank among the R;
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
// steps: R warp argmaxes, three barriers and the chase's max_words - 1
// dependent loads.  The utterance's rows are staged in shared memory when
// their T 8 bytes fit beside the selection's arrays (ROWS_SMEM), so a
// chase step is a shared-memory load; else it reads device memory.  ac[Q]
// sits in shared memory where it fits beside those, else in a [B, Q]
// device scratch.
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

  const int b = blockIdx.x;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, warps = nthr >> 5;
  const int Q = tb.n_slots, vp1 = tb.n_vocab + 1;
  const size_t carry_n = (size_t)tb.n_nodes * tb.n_states;
  const float* d_b = deltas + (size_t)b * carry_n;
  const int32_t* c_b = ctx + (size_t)b * carry_n;

  // shared memory: top_v [R] | top_q [R] | tot [R] | cr [R] | pick [C] |
  // the warps' lists [warps][R] (values, then slots) | (ROWS_SMEM) prev [T]
  // | word [T] | (ac_in_smem) ac [Q]
  float* top_v = reinterpret_cast<float*>(smem_raw);
  int* top_q = reinterpret_cast<int*>(top_v + R);
  float* tot = reinterpret_cast<float*>(top_q + R);
  int* cr = reinterpret_cast<int*>(tot + R);
  int* pick = cr + R;
  float* wl_v = reinterpret_cast<float*>(pick + C);
  int* wl_q = reinterpret_cast<int*>(wl_v + warps * R);
  int32_t* rows = wl_q + warps * R;
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

  // 1. the slots' acoustic scores, SLOT_BATCH slots a thread at a time:
  // their nodes, then their exit states and bands, loaded together
  const int Ns = tb.n_states, W = tb.band_w;
  for (int q0 = tid; q0 < Q; q0 += nthr * SLOT_BATCH) {
    size_t at[SLOT_BATCH];   // each slot's node's first state
    float x[SLOT_BATCH];
#pragma unroll
    for (int j = 0; j < SLOT_BATCH; ++j) {
      const int q = q0 + j * nthr;
      at[j] = q < Q ? (size_t)__ldg(tb.node_slot + q) * Ns : 0;
      x[j] = NEG_INF_F;
    }
    for (int k = 1; k < W; ++k) {   // node_exit's compares, in its order
      const int rr = Ns - 1 - k;
      if (rr < 0) break;
      float cand[SLOT_BATCH];
#pragma unroll
      for (int j = 0; j < SLOT_BATCH; ++j)
        cand[j] = d_b[at[j] + rr] + __ldg(tb.bands + (at[j] + rr) * W + k);
#pragma unroll
      for (int j = 0; j < SLOT_BATCH; ++j)
        if (cand[j] > x[j]) x[j] = cand[j];
    }
#pragma unroll
    for (int j = 0; j < SLOT_BATCH; ++j) {
      const int q = q0 + j * nthr;
      if (q < Q)
        ac[q] = (__ldg(tb.slot_valid + q) && x[j] > NEG_INF_HALF_F)
                    ? x[j] : NEG_INF_F;
    }
  }
  __syncthreads();

  // 2. the top R slots: each warp's, then the warps' lists by rank
  float* my_v = wl_v + warp * R;
  int* my_q = wl_q + warp * R;
  warp_top(R, [&](auto&& take) {
    for (int q = tid; q < Q; q += nthr) take(ac[q], q);
  }, my_v, my_q);
  __syncthreads();
  place_by_rank(warps, R, [&](int w) { return wl_v + w * R; },
                [&](int w) { return wl_q + w * R; }, tid, nthr, top_v, top_q);
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

  // 4. the top C totals: each total's rank among the R
  for (int r = tid; r < R; r += nthr) {
    const float x = tot[r];
    int rank = 0;
    for (int o = 0; o < R; ++o) rank += before(tot[o], o, x, r);
    if (rank < C) {
      pick[rank] = r;
      scores[(size_t)b * C + rank] = x;
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
//      computed once per group (a few hundred against 21,760 nodes), the
//      same max over the same values in the same order;
//   2. the K best blocks in _top_k's order (value descending, the lower
//      block first on ties): each block's rank in that order, the count of
//      blocks before it (a warp a block), and the blocks of rank < K in
//      place;
//   3. remap: a surviving block keeps its interior, a fresh one starts at
//      (NEG_INF, V); state 0 of every active node takes its entry;
//   4. the banded advance and clamp of the K blk active nodes in place
//      (advance_in_place), then their exits (states_exit);
//   5. the word emission over the active blocks' slots, as the exact
//      scan's;
//   6. the traceback row (prev, word).
// Frames at or past n_valid[b] are frozen: rows -1, carry untouched.
//
// What changed between frames is all a frame reads.  After a frame the
// entry row is (NEG_INF, V) but for root children (the restart), the
// children of active nodes (the parent's exit) and parentless nodes (node
// 0's exit context where its block is active), so:
// * No entry row is kept.  An active node's entry is computed when its
//   advance needs it, from the previous frame's exits (double-buffered by
//   frame parity, with the block map that indexes them) and emission; the
//   [N] row is read once at the start (the first frame's entries) and
//   written once at the end.
// * The lookahead's dense max over N nodes becomes, per block (a warp a
//   block, the one writer of its value), the max of three terms: the
//   restart plus the best la of its root children's groups, NEG_INF plus
//   the best la of its other nodes' groups (static per-block lists of
//   distinct groups: rounding is monotone, fl(a + x) never decreases as x
//   grows, so these equal the dense maxima bit for bit, and dead blocks
//   tie at NEG_INF + la as in the plain loop), and its nodes whose parent
//   was active in the previous frame (parent's exit + la: the static
//   edges into the block grouped by the parent's block, a segment read
//   where that block was active).  The first frame of a launch takes the
//   dense max over the entry row in.
// * A frame's work is O(G Ns + n_blocks (groups a block) + K blk) instead
//   of O(N).
//
// Where the plain loop's results hinge on detail, and what this does:
// * Ties among dead blocks: see above; the selection breaks ties by the
//   block index.
// * The clipped parent.  _enter reads flow_ctx = ex_ctx[:, parent] with
//   parent clipped to 0, so a parentless node takes node 0's exit context
//   when it does not restart: the entry looks node max(p, 0) up through
//   the block map like any parent (V where its block is inactive).
// * Only active nodes have finite exits, kept compact (ex [K blk] by
//   position).  With an LM and fewer than R finite candidates the plain
//   loop fills its top R with NEG_INF slots from all Q; their total is
//   NEG_INF, so they never win the first maximum nor reach a row: a list
//   entry with no slot gives a NEG_INF total.
// * Memory.  pruned_plan places, in order, the emission's lists, the
//   scores rows (double-buffered by cp.async), the small block arrays
//   (meta), the groups' lookahead, the group tables, the exits and the
//   carry, each in shared memory if it fits in what is left, else in
//   device memory (scratch the wrapper passes; the group tables read in
//   place).  ROWS_SMEM makes two instantiations; every other part is
//   placed at run time, through a base pointer.
// * No shape limit the plain loop lacks: any Ns and W (the advance runs in
//   place with runtime loops), block size, K <= n_blocks, Q and S.  A
//   device-memory carry is permuted by a physical-slot table (phys), so a
//   surviving block never moves; the output is written in kb's order.

struct PrunedPlan {
  bool rows_smem, meta_smem, la_smem, groups_smem, ex_smem, carry_smem;
  unsigned rows_off, meta_off, la_off, groups_off, ex_off, carry_off, smem;
};

template <bool ROWS_SMEM>
__global__ void __launch_bounds__(SCAN_THREADS)
decoder_pruned_kernel(const ScanTables tb, const PrunedTables pt,
                      const PrunedPlan plan, const PrunedIO io, int Tc,
                      int S, int t0) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, warps = nthr >> 5;
  const int N = tb.n_nodes, Ns = tb.n_states, W = tb.band_w;
  const int V = tb.n_vocab, R = tb.r_top, vp1 = V + 1, G = tb.n_groups;
  const int blk = pt.block_size, K = pt.n_active, NB = pt.n_blocks;
  const int act_n = K * blk;                       // active nodes
  const size_t blk_n = (size_t)blk * Ns;           // one block's carry,
                                                   // [Ns][blk] by state
  const size_t carry_n = (size_t)K * blk_n;
  const int4* info = reinterpret_cast<const int4*>(tb.node_info);

  // the warps' lists [2][SCAN_WARPS][R] (values, then slots) at 0; meta:
  // blk_best [NB] | map [2][NB] (block -> position
  // by frame parity, -1) | kb_s [2][K] (position -> block) | knew [K] |
  // phys [K] (position -> carry slot) | nphys [K] | used [K] | fresh [K]
  float* wl_v = reinterpret_cast<float*>(smem_raw);
  int* wl_q = reinterpret_cast<int*>(wl_v + 2 * SCAN_WARPS * R);
  float* mo_v = reinterpret_cast<float*>(wl_q + 2 * SCAN_WARPS * R + 4 * R) +
                warp * R;   // the exact scan's layout: the CTA's lists unused
  int* mo_q = reinterpret_cast<int*>(mo_v - warp * R + SCAN_WARPS * R) +
              warp * R;
  int32_t* meta = plan.meta_smem
      ? reinterpret_cast<int32_t*>(smem_raw + plan.meta_off)
      : io.meta + (size_t)b * (3 * NB + 7 * K);
  float* blk_best = reinterpret_cast<float*>(meta);
  int32_t* map = meta + NB;
  int32_t* kb_s = map + 2 * NB;
  int32_t* knew = kb_s + 2 * K;
  int32_t* phys = knew + K;
  int32_t* nphys = phys + K;
  int32_t* used = nphys + K;
  int32_t* fresh = used + K;
  float* srow = reinterpret_cast<float*>(smem_raw + plan.rows_off);
  float* la_g = plan.la_smem
      ? reinterpret_cast<float*>(smem_raw + plan.la_off)
      : io.la + (size_t)b * G;
  const int32_t* gsen = tb.group_senone;
  const float* gband = tb.group_bands;
  if (plan.groups_smem) {
    const size_t n_sen = (size_t)G * Ns;
    int32_t* s_sen = reinterpret_cast<int32_t*>(smem_raw + plan.groups_off);
    float* s_band = reinterpret_cast<float*>(s_sen + n_sen);
    for (size_t j = tid; j < n_sen; j += nthr) s_sen[j] = gsen[j];
    for (size_t j = tid; j < n_sen * W; j += nthr) s_band[j] = gband[j];
    gsen = s_sen;
    gband = s_band;
  }
  float* ex;
  int32_t* exc;
  if (plan.ex_smem) {
    ex = reinterpret_cast<float*>(smem_raw + plan.ex_off);
    exc = reinterpret_cast<int32_t*>(ex + 2 * act_n);
  } else {
    ex = io.ex + (size_t)b * 2 * act_n;
    exc = io.exc + (size_t)b * 2 * act_n;
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

  // the carry in, each block in the carry slot of its position; the
  // blocks in frame parity 1 (the frame before the first)
  const float* e_b = io.e_in + (size_t)b * N;
  const int32_t* ec_b = io.ec_in + (size_t)b * N;
  {
    const float* d_b = io.d_in + (size_t)b * carry_n;
    const int32_t* c_b = io.c_in + (size_t)b * carry_n;
    for (size_t i = tid; i < carry_n; i += nthr) {   // [K][blk][Ns] in
      const size_t kn = i / Ns, k = kn / blk;
      const size_t at = (k * Ns + i - kn * Ns) * blk + kn - k * blk;
      dw[at] = d_b[i];
      cw[at] = c_b[i];
    }
    for (int j = tid; j < NB; j += nthr) map[j] = map[NB + j] = -1;
  }
  __syncthreads();
  for (int k = tid; k < K; k += nthr) {
    const int j = (int)io.kb_in[(size_t)b * K + k];
    kb_s[k] = kb_s[K + k] = j;
    phys[k] = k;
    map[NB + j] = k;
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
  long long tick = trace ? clock64() : 0, spent[PRUNED_PHASES] = {};
  auto mark = [&](int phase) {   // summed in registers, added at the end
    if (trace) {
      const long long now = clock64();
      spent[phase] += now - tick;
      tick = now;
    }
  };
  float e_prev = NEG_INF_F;   // the previous frame's emission
  int re_prev = 0;            // and its restart context
  // node's entry for frame i: the entry row in for the first frame, else
  // from frame i - 1's exits (through its block map) and emission
  auto entry = [&](int i, int node, float* d0, int32_t* c0) {
    if (i == 0) {
      *d0 = e_b[node];
      *c0 = ec_b[node];
      return;
    }
    const int buf = (i - 1) & 1, pword = info[node].y;
    const int p = pword >> 2, pj = p / blk, k = map[buf * NB + pj];
    float x = NEG_INF_F;
    int xc = V;
    if (k >= 0) {
      const int at = buf * act_n + k * blk + p - pj * blk;
      x = ex[at];
      xc = exc[at];
    }
    entry_of(pword, x, xc, e_prev, re_prev, d0, c0);
  };

  for (int i = 0; i < nv; ++i) {
    const int cur = i & 1, prv = cur ^ 1;
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
    __syncthreads();     // ... and every thread's; last frame's pick done
    mark(0);

    // 1. lookahead: each group's best score (amax over the states in
    // order), then each block's
    for (int g = tid; g < G; g += nthr) {
      const int32_t* sn = gsen + (size_t)g * Ns;
      float la = NEG_INF_F;
      for (int s = 0; s < Ns; ++s) {
        const int sen = sn[s];
        const float x = sen >= 0 ? row[sen] : NEG_INF_F;
        if (s == 0 || x > la) la = x;
      }
      la_g[g] = la;
    }
    __syncthreads();
    // a warp a block: the max of its terms, written once
    const int* map_p = map + prv * NB;
    const float er = e_prev > NEG_INF_F ? e_prev : NEG_INF_F;
    for (int j = warp; j < NB; j += warps) {
      float best = -INFINITY, mrc = -INFINITY, mdead = -INFINITY;
      if (i == 0) {   // densely over the entry row in
        for (int n = lane; n < blk; n += 32) {
          const int node = j * blk + n;
          const float pot = e_b[node] + la_g[info[node].x];
          if (pot > best) best = pot;
        }
      } else {
        // the restart over root children, NEG_INF over the other nodes
        for (int a = pt.rc_ptr[j] + lane; a < pt.rc_ptr[j + 1]; a += 32) {
          const float x = la_g[pt.rc_group[a]];
          mrc = x > mrc ? x : mrc;
        }
        for (int a = pt.dead_ptr[j] + lane; a < pt.dead_ptr[j + 1]; a += 32) {
          const float x = la_g[pt.dead_group[a]];
          mdead = x > mdead ? x : mdead;
        }
        // its nodes whose parent's block was active: the parent's exit
        for (int g = pt.src_ptr[j]; g < pt.src_ptr[j + 1]; ++g) {
          const int k = map_p[pt.src_block[g]];
          if (k < 0) continue;
          const float* exk = ex + prv * act_n + k * blk;
          for (int a = pt.seg_ptr[g] + lane; a < pt.seg_ptr[g + 1]; a += 32) {
            const float x = exk[pt.flow_par[a]] + la_g[pt.flow_grp[a]];
            if (x > best) best = x;
          }
        }
      }
      // an active block's own nodes: max_s d + la
      const int k = map_p[j];
      if (k >= 0) {
        const float* dk = dw + (size_t)phys[k] * blk_n;
        for (int n = lane; n < blk; n += 32) {
          const float* dn = dk + n;
          float m = dn[0];
          for (int s = 1; s < Ns; ++s) m = dn[s * blk] > m ? dn[s * blk] : m;
          const float x = m + la_g[info[j * blk + n].x];
          if (x > best) best = x;
        }
      }
      best = warp_max(best);
      if (i > 0) {
        mrc = warp_max(mrc);
        mdead = warp_max(mdead);
        if (pt.rc_ptr[j + 1] > pt.rc_ptr[j]) {
          const float x = er + mrc;
          best = x > best ? x : best;
        }
        if (pt.dead_ptr[j + 1] > pt.dead_ptr[j]) {
          const float x = NEG_INF_F + mdead;
          best = x > best ? x : best;
        }
      }
      if (lane == 0) blk_best[j] = best;
    }
    __syncthreads();
    mark(1);

    // 2. the top K blocks: each block's rank in the total order (value
    // descending, block ascending), a warp a block counting the blocks
    // before it; the blocks of rank < K go in place
    int* kb_c = kb_s + cur * K;
    int* map_c = map + cur * NB;
    for (int j = warp; j < NB; j += warps) {
      const float x = blk_best[j];
      int n_before = 0;
      for (int o = lane; o < NB; o += 32)
        n_before += before(blk_best[o], o, x, j);
      const int rank = __reduce_add_sync(FULL, n_before);
      if (lane == 0 && rank < K) knew[rank] = j;
    }
    __syncthreads();
    // 3. the remap (thread 0)
    if (tid == 0) {
      const int* map_p = map + prv * NB;
      for (int k = 0; k < K; ++k) used[k] = 0;
      for (int k = 0; k < K; ++k) {   // a survivor keeps its carry slot
        const int op = map_p[knew[k]];
        nphys[k] = op >= 0 ? phys[op] : -1;
        if (op >= 0) used[phys[op]] = 1;
      }
      for (int k = 0; k < K; ++k) map_c[kb_c[k]] = -1;   // frame i - 2's
      for (int k = 0, f = 0; k < K; ++k) {   // a fresh block a free slot
        fresh[k] = nphys[k] < 0;
        if (fresh[k]) {
          while (used[f]) ++f;
          nphys[k] = f;
          used[f] = 1;
        }
        kb_c[k] = knew[k];
        phys[k] = nphys[k];
        map_c[knew[k]] = k;
      }
    }
    __syncthreads();
    mark(2);

    // 4. the active nodes: entry, advance in place, exits; then this warp's
    // top R over their slots
    float* ex_c = ex + cur * act_n;
    int32_t* exc_c = exc + cur * act_n;
    for (int idx = tid; idx < act_n; idx += nthr) {
      const int k = idx / blk, n = idx - k * blk;
      const int node = kb_c[k] * blk + n;
      float* d = dw + (size_t)phys[k] * blk_n + n;
      int32_t* c = cw + (size_t)phys[k] * blk_n + n;
      if (fresh[k])
        for (int s = 1; s < Ns; ++s) {
          d[s * blk] = NEG_INF_F;
          c[s * blk] = V;
        }
      entry(i, node, d, c);
      const int grp = info[node].x;
      const float* bn = gband + (size_t)grp * Ns * W;
      advance_in_place(tb, d, c, blk, bn, gsen + (size_t)grp * Ns, row);
      int ectx;
      ex_c[idx] = states_exit(tb, d, c, blk, bn, &ectx);
      exc_c[idx] = ectx;
    }
    float* wv = wl_v + cur * SCAN_WARPS * R;
    int* wq = wl_q + cur * SCAN_WARPS * R;
    warp_top(R, [&](auto&& take) {
      for (int idx = tid; idx < act_n; idx += nthr) {
        const float e = ex_c[idx];
        if (!(e > NEG_INF_HALF_F)) continue;   // its slots score NEG_INF
        const int k = idx / blk;
        const int4 nf = info[kb_c[k] * blk + idx - k * blk];
        for (int s = nf.z; s < nf.z + nf.w; ++s) take(e, s);
      }
    }, wv + warp * R, wq + warp * R);
    mark(3);
    __syncthreads();

    // 5-6. every warp merges the lists and picks; the traceback row
    float v;
    int q;
    merge_lists(warps, R, [&](int w) { return wv + w * R; },
                [&](int w) { return wq + w * R; }, mo_v, mo_q, v, q);
    mark(4);
    int word, prev;
    pick(tb, v, q, [&](int node) {
      const int j = node / blk;
      return exc_c[map_c[j] * blk + node - j * blk];
    }, e_prev, word, prev);
    re_prev = (t0 + i + 1) * vp1 + (word >= 0 ? word : V);
    if (tid == 0) {
      io.tb_prev[(size_t)b * Tc + i] = prev;
      io.tb_word[(size_t)b * Tc + i] = word;
    }
    mark(5);
  }
  if (ROWS_SMEM) cp_async_wait_all();
  for (int i = nv + tid; i < Tc; i += nthr) {
    io.tb_prev[(size_t)b * Tc + i] = -1;
    io.tb_word[(size_t)b * Tc + i] = -1;
  }
  __syncthreads();
  // the carry out in kb's order, and the entry row after the last frame
  const int* kb_l = kb_s + ((nv - 1) & 1) * K;
  for (int k = tid; k < K; k += nthr) io.kb_out[(size_t)b * K + k] = kb_l[k];
  float* d_o = io.d_out + (size_t)b * carry_n;
  int32_t* c_o = io.c_out + (size_t)b * carry_n;
  for (size_t i = tid; i < carry_n; i += nthr) {   // [K][blk][Ns] out
    const size_t kn = i / Ns, k = kn / blk;
    const size_t at = ((size_t)phys[k] * Ns + i - kn * Ns) * blk + kn - k * blk;
    d_o[i] = dw[at];
    c_o[i] = cw[at];
  }
  float* e_o = io.e_out + (size_t)b * N;
  int32_t* ec_o = io.ec_out + (size_t)b * N;
  for (int n = tid; n < N; n += nthr) entry(nv, n, e_o + n, ec_o + n);
  mark(0);
  if (trace)
    for (int k = 0; k < PRUNED_PHASES; ++k) io.clocks[k] += spent[k];
}

int threads_for(int n, int most = MAX_THREADS) {
  const int t = (n + 31) / 32 * 32;
  return t < 64 ? 64 : (t > most ? most : t);
}

size_t align16(size_t bytes) { return (bytes + 15) / 16 * 16; }

// The emission's lists: the warps' [2][SCAN_WARPS][R], the CTA's [2][R]
// and the warps' merge scratch [SCAN_WARPS][R], a value and a slot each.
size_t lists_bytes(int R) {
  return align16((3 * (size_t)SCAN_WARPS + 2) * R * 8);
}

// The exact scan's on-chip plan (ScanPlan above).  The rows go to shared
// memory where the three fit beside the lists.  Then the node ranges'
// info, exits and carry on chip beside them and the group tables (else
// without the group tables): on one CTA where they fit, else on the
// cluster size (up to MAX_CLUSTER) of which the card runs the most at
// once (`active(plan)`: utterances in flight), the largest among equals
// (the least work a CTA).  onchip = 0 where no size holds them.
template <class Active>
ScanPlan onchip_plan(int N, int Ns, int W, int S, int G, int R,
                     Active active) {
  const size_t lists = lists_bytes(R);
  const size_t rows = align16(3 * (size_t)S * 4);
  const size_t groups = align16((size_t)G * Ns * (W + 1) * 4);
  ScanPlan p{}, best{};
  int best_n = 0;
  p.rows_smem = lists + rows <= SMEM_LIMIT;
  const size_t base = lists + (p.rows_smem ? rows : 0);
  p.rows_off = (unsigned)lists;
  for (int with_groups = 1; with_groups >= 0 && best_n == 0; --with_groups)
    for (int cs = 1; cs <= MAX_CLUSTER; ++cs) {
      const int chunk = (N + cs - 1) / cs;
      if (chunk > SCAN_THREADS * NODES_PER_THREAD) continue;
      size_t at = base;
      p.groups_smem = with_groups;
      p.groups_off = (unsigned)at;
      at += with_groups ? groups : 0;
      p.info_off = (unsigned)at;
      at += align16((size_t)chunk * 16);
      p.ex_off = (unsigned)at;
      at += align16((size_t)chunk * 16);
      p.carry_off = (unsigned)at;
      at += align16((size_t)chunk * Ns * 8);
      if (at > SMEM_LIMIT) continue;
      p.onchip = 1;
      p.cs = cs;
      p.chunk = p.in_nodes = chunk;
      p.ex_smem = 1;
      p.threads = threads_for(chunk, SCAN_THREADS);
      p.smem = (unsigned)at;
      if (cs == 1) return p;
      const int n = active(p);
      if (n > 0 && n >= best_n) {
        best = p;
        best_n = n;
      }
    }
  return best;
}

// The device-memory route's layout on cs CTAs of ceil(N / cs) nodes each:
// after the lists and the rows (where they fit), the group tables, the
// nodes' info and exits, then the carry of as many nodes as fit; the group
// tables make way where the info and exits fit only without them, and the
// info and exits go to the scratch where they do not fit at all.
ScanPlan device_plan(int N, int Ns, int W, int S, int G, int R, int cs) {
  const size_t lists = lists_bytes(R);
  const size_t rows = align16(3 * (size_t)S * 4);
  const size_t groups = align16((size_t)G * Ns * (W + 1) * 4);
  ScanPlan p{};
  p.cs = cs;
  p.chunk = (N + cs - 1) / cs;
  p.threads = threads_for(p.chunk, SCAN_THREADS);
  p.rows_smem = lists + rows <= SMEM_LIMIT;
  p.rows_off = (unsigned)lists;
  size_t at = lists + (p.rows_smem ? rows : 0);
  const size_t info = align16((size_t)p.chunk * 16);
  const size_t exits = 2 * info;   // the info, then the two frames' exits
  p.groups_smem = at + groups <= SMEM_LIMIT &&
                  (at + groups + exits <= SMEM_LIMIT ||
                   at + exits > SMEM_LIMIT);
  p.groups_off = (unsigned)at;
  at += p.groups_smem ? groups : 0;
  p.ex_smem = at + exits <= SMEM_LIMIT;
  p.info_off = (unsigned)at;
  p.ex_off = (unsigned)(at + info);
  at += p.ex_smem ? exits : 0;
  p.carry_off = (unsigned)at;
  p.in_nodes = p.ex_smem ? (int)std::min<size_t>(
                               p.chunk, (SMEM_LIMIT - at) / (8 * (size_t)Ns))
                         : 0;
  p.smem = (unsigned)(at + (size_t)p.in_nodes * Ns * 8);
  p.scratch_words =
      (long long)cs * ((long long)Ns * (p.chunk - p.in_nodes) +
                       (p.ex_smem ? 0 : 2LL * p.chunk));
  return p;
}

// A node's states in registers, unrolled to (8 states, 2 offsets: the
// left-to-right topology) or, on chip, (NS_MAX, W_MAX): kinds 1-2; else in
// place in the carry (0: off chip by windows at band width <= 2, else a node at a time).
int regs_kind(int Ns, int W, bool onchip) {
  if (Ns <= 8 && W <= 2) return 1;
  return onchip && W <= W_MAX && Ns <= NS_MAX ? 2 : 0;
}

// Opt a kernel into its dynamic shared memory past 48 KB and, past 8 CTAs,
// into a non-portable cluster size.
template <class K>
cudaError_t prepare(K kernel, size_t smem, int cs) {
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return rc;
  }
  if (cs > PORTABLE_CLUSTER)
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return cudaSuccess;
}

// B utterances of plan.cs CTAs each, in clusters of plan.cs where it is
// more than 1.
cudaLaunchConfig_t launch_config(int B, const ScanPlan& plan,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * plan.cs, 1, 1);
  cfg.blockDim = dim3(plan.threads, 1, 1);
  cfg.dynamicSmemBytes = plan.smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = plan.cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = plan.cs > 1 ? 1 : 0;
  return cfg;
}

// How many clusters of the plan's shape the card runs at once (CTAs where
// plan.cs is 1), into *n.
template <bool ONCHIP, bool ROWS_SMEM, int NSR, int WR>
cudaError_t active_clusters(const ScanPlan& plan, int* n) {
  const auto kernel = decoder_scan_kernel<ONCHIP, ROWS_SMEM, NSR, WR>;
  *n = 0;
  cudaError_t rc = prepare(kernel, plan.smem, plan.cs);
  if (rc != cudaSuccess) return rc;
  if (plan.cs == 1) {
    int dev = 0, sms = 0, per_sm = 0;
    rc = cudaGetDevice(&dev);
    if (rc == cudaSuccess)
      rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, plan.threads, plan.smem);
    *n = per_sm * sms;
    return rc;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(1, plan, nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(n, kernel, &cfg);
}

template <bool ONCHIP, bool ROWS_SMEM, int NSR, int WR>
int launch(int B, const ScanPlan& plan, cudaStream_t stream,
           const ScanTables& tb, const float* scores, const int32_t* n_valid,
           const float* d_in, const int32_t* c_in, float* d_out,
           int32_t* c_out, float* scratch_f, int32_t* scratch_i,
           int32_t* tb_prev, int32_t* tb_word, int Tc, int S, int t0,
           long long* clocks) {
  const auto kernel = decoder_scan_kernel<ONCHIP, ROWS_SMEM, NSR, WR>;
  cudaError_t rc = prepare(kernel, plan.smem, plan.cs);
  if (rc != cudaSuccess) return (int)rc;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(B, plan, stream, &attr);
  rc = cudaLaunchKernelEx(&cfg, kernel, tb, plan, scores, n_valid, d_in,
                          c_in, d_out, c_out, scratch_f, scratch_i, tb_prev,
                          tb_word, Tc, S, t0, clocks);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}

using LaunchFn = int (*)(int, const ScanPlan&, cudaStream_t,
                         const ScanTables&, const float*, const int32_t*,
                         const float*, const int32_t*, float*, int32_t*,
                         float*, int32_t*, int32_t*, int32_t*, int, int, int,
                         long long*);
using ClustersFn = cudaError_t (*)(const ScanPlan&, int*);
// off chip indexed by rows_smem * 2 + regs_kind, on chip by 4 + rows_smem
// * 3 + regs_kind
#define SCAN_INSTANCES(f)                                                   \
  {f<false, false, 0, 0>, f<false, false, 8, 2>, f<false, true, 0, 0>,     \
   f<false, true, 8, 2>, f<true, false, 0, 0>, f<true, false, 8, 2>,       \
   f<true, false, NS_MAX, W_MAX>, f<true, true, 0, 0>, f<true, true, 8, 2>, \
   f<true, true, NS_MAX, W_MAX>}
constexpr LaunchFn LAUNCH[10] = SCAN_INSTANCES(launch);
constexpr ClustersFn CLUSTERS[10] = SCAN_INSTANCES(active_clusters);

int instance(const ScanPlan& p, const ScanTables& tb) {
  const int kind = regs_kind(tb.n_states, tb.band_w, p.onchip);
  return p.onchip ? 4 + p.rows_smem * 3 + kind : p.rows_smem * 2 + kind;
}

// A shape's plans, kept per device and shape (choosing a layout asks the
// card for the occupancy of each size that fits): the on-chip plan and the
// clusters of its shape the card runs at once (1 where the CTAs are not
// clustered), or, where the carry stays off chip, the device-memory
// route's layout at each cluster size and the clusters (CTAs at size 1) of
// it the card runs at once.
struct Planned {
  int key[7];
  ScanPlan plan;
  int active;
  ScanPlan by_size[MAX_CLUSTER];
  int active_by_size[MAX_CLUSTER];
  long long l2_bytes;
};
std::mutex plans_mutex;
std::vector<Planned> plans;
constexpr size_t PLANS_KEPT = 64;

// The plans for these tables at S senones on the current device.  Returns
// the first error of the occupancy queries, or cudaSuccess.
cudaError_t plan_for(const ScanTables& tb, int S, Planned* out) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  const int key[7] = {dev, tb.n_nodes, tb.n_states, tb.band_w,
                      S,   tb.n_groups, tb.r_top};
  std::lock_guard<std::mutex> lock(plans_mutex);
  for (const Planned& p : plans)
    if (std::equal(key, key + 7, p.key)) {
      *out = p;
      return cudaSuccess;
    }
  Planned p{};
  std::copy(key, key + 7, p.key);
  p.plan = onchip_plan(
      tb.n_nodes, tb.n_states, tb.band_w, S, tb.n_groups, tb.r_top,
      [&](const ScanPlan& q) {
        int n = 0;
        if (rc == cudaSuccess) rc = CLUSTERS[instance(q, tb)](q, &n);
        return rc == cudaSuccess ? n : 0;
      });
  if (rc != cudaSuccess) return rc;
  p.active = 1;
  if (p.plan.onchip && p.plan.cs > 1) {
    rc = CLUSTERS[instance(p.plan, tb)](p.plan, &p.active);
    if (rc != cudaSuccess) return rc;
  }
  if (!p.plan.onchip) {
    int l2 = 0;
    rc = cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev);
    if (rc != cudaSuccess) return rc;
    p.l2_bytes = l2;
  }
  if (!p.plan.onchip)
    for (int cs = 1; cs <= MAX_CLUSTER; ++cs) {
      ScanPlan& q = p.by_size[cs - 1];
      q = device_plan(tb.n_nodes, tb.n_states, tb.band_w, S, tb.n_groups,
                      tb.r_top, cs);
      if (q.smem > SMEM_LIMIT) continue;   // lists and group tables alone
      rc = CLUSTERS[instance(q, tb)](q, &p.active_by_size[cs - 1]);
      if (rc != cudaSuccess) return rc;
    }
  if (plans.size() >= PLANS_KEPT) plans.erase(plans.begin());
  plans.push_back(p);
  *out = p;
  return cudaSuccess;
}

// The plan for B utterances and the clusters (CTAs) of it the card runs at
// once.  Off chip, a wave of utterances takes about as long as the nodes a
// CTA owns while the scratch of the utterances in flight stays in L2 (an
// H100 80GB HBM3 at 700 W, `state_num = 10` over 21,589 nodes, B = 8:
// 11.2 ms on clusters of 9, the card running 9 at once; 12.3 on 8; 13.8 on
// 16, 7 at once, two waves; 83.0 on one CTA an utterance; B = 128: 122.2
// on clusters of 8, 131.2 on 16, 156.0 on one CTA with ~400 MB of scratch
// in flight): the size with the fewest waves times nodes a CTA, among the
// sizes whose utterances in flight keep their scratch within the L2 (all
// sizes where none does); the largest size among equals.
// cudaErrorInvalidValue where the card runs no size.
cudaError_t choose(const Planned& p, int B, ScanPlan* plan, int* active) {
  if (p.plan.onchip) {
    *plan = p.plan;
    *active = p.active;
    return cudaSuccess;
  }
  long long best = -1;
  for (int fit_l2 = 1; fit_l2 >= 0 && best < 0; --fit_l2)
    for (int cs = 1; cs <= MAX_CLUSTER; ++cs) {
      const int a = p.active_by_size[cs - 1];
      if (a < 1) continue;
      const ScanPlan& q = p.by_size[cs - 1];
      const long long in_flight = std::min(B, a) * q.scratch_words * 8;
      if (fit_l2 && in_flight > p.l2_bytes) continue;
      const long long cost = (B + a - 1) / a * (long long)q.chunk;
      if (best < 0 || cost <= best) {
        best = cost;
        *plan = q;
        *active = a;
      }
    }
  return best < 0 ? cudaErrorInvalidValue : cudaSuccess;
}

// What the n-best kernel keeps in shared memory: the selection's arrays
// and the warps' lists, then the traceback rows where they fit, then ac
// where it fits.
struct FinalizePlan {
  bool rows_smem, ac_smem;
  size_t smem;
};

FinalizePlan finalize_plan(int Q, int T, int C, int R) {
  const size_t warps = threads_for(Q) / 32;
  const size_t base = 16 * (size_t)R + 4 * (size_t)C + 8 * warps * R;
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

// What the pruned scan keeps in shared memory: the emission's lists, then
// in order the two scores rows, meta, the groups' lookahead, the group
// tables, the exits and the carry, each where it fits in what the earlier
// parts leave of SMEM_LIMIT.
PrunedPlan pruned_plan(int N, int Ns, int W, int S, int K, int blk, int G,
                       int R) {
  const int NB = blk > 0 ? N / blk : 0;
  const size_t act = (size_t)K * blk;
  PrunedPlan p{};
  size_t used = lists_bytes(R);
  auto take = [&](size_t bytes, unsigned* off) {
    bytes = align16(bytes);
    if (used + bytes > SMEM_LIMIT) return false;
    *off = (unsigned)used;
    used += bytes;
    return true;
  };
  p.rows_smem = take(2 * (size_t)S * 4, &p.rows_off);
  p.meta_smem = take(4 * (3 * (size_t)NB + 7 * (size_t)K), &p.meta_off);
  p.la_smem = take(4 * (size_t)G, &p.la_off);
  p.groups_smem = take(4 * (size_t)G * Ns * (W + 1), &p.groups_off);
  p.ex_smem = take(16 * act, &p.ex_off);
  p.carry_smem = take(8 * act * Ns, &p.carry_off);
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
  return tb.n_nodes < 1 || tb.n_nodes >= (1 << 22) || tb.n_states < 1 ||
         tb.band_w < 1 || tb.n_slots < 1 || tb.lm_mode < 0 ||
         tb.lm_mode > 2 || (tb.lm_mode > 0 && tb.n_vocab < 1) ||
         tb.node_info == nullptr || tb.group_senone == nullptr ||
         tb.group_bands == nullptr || tb.n_groups < 1;
}

}  // namespace

// Plain C interface for ctypes.  decoder_scan_exact returns
// cudaGetLastError() after the launch (0 = cudaSuccess), or
// cudaErrorInvalidValue for a shape it does not take; the launch is
// asynchronous on `stream`.  The carry goes from (d_in, c_in) to
// (d_out, c_out) ([B, N, Ns]); tb_prev and tb_word ([B, Tc]) are written
// whole.  scratch_f / scratch_i (float32 and int32, [B, scratch words]:
// decoder_scan_plan's last entry) are read only where the carry stays off
// chip (its first entry 0) and the scratch words are more than 0.  clocks:
// null, or EXACT_PHASES int64 counters the first utterance's cycles are
// added to.
extern "C" int decoder_scan_exact(const ScanTables* tables,
                                  const void* scores, const void* n_valid,
                                  const void* d_in, const void* c_in,
                                  void* d_out, void* c_out, void* scratch_f,
                                  void* scratch_i, void* tb_prev,
                                  void* tb_word, int B, int Tc, int S, int t0,
                                  void* clocks, void* stream_) {
  const ScanTables tb = *tables;
  if (B < 1 || Tc < 1 || S < 1 || bad_tables(tb) || tb.r_top < 1 ||
      tb.r_top > R_MAX || tb.r_top > tb.n_slots || t0 < 0)
    return (int)cudaErrorInvalidValue;
  Planned planned;
  cudaError_t rc = plan_for(tb, S, &planned);
  if (rc != cudaSuccess) return (int)rc;
  ScanPlan plan;
  int active = 0;
  rc = choose(planned, B, &plan, &active);
  if (rc != cudaSuccess) return (int)rc;
  if (!plan.onchip && plan.scratch_words > 0 &&
      (scratch_f == nullptr || scratch_i == nullptr))
    return (int)cudaErrorInvalidValue;
  return LAUNCH[instance(plan, tb)](
      B, plan, (cudaStream_t)stream_, tb, static_cast<const float*>(scores),
      static_cast<const int32_t*>(n_valid), static_cast<const float*>(d_in),
      static_cast<const int32_t*>(c_in), static_cast<float*>(d_out),
      static_cast<int32_t*>(c_out), static_cast<float*>(scratch_f),
      static_cast<int32_t*>(scratch_i), static_cast<int32_t*>(tb_prev),
      static_cast<int32_t*>(tb_word), Tc, S, t0,
      static_cast<long long*>(clocks));
}

// The exact scan's plan for these tables at S senones and B utterances,
// into out[11]: on chip (1) or not (0), CTAs an utterance, nodes a CTA,
// threads a CTA, the rows in shared memory, the group tables in shared
// memory, dynamic shared memory bytes a CTA, the clusters of that shape
// the card runs at once (1 where the CTAs of an on-chip plan are not
// clustered; CTAs where an off-chip plan's are not), the nodes a CTA keeps
// the carry of in shared memory, the info and exits in shared memory, and
// the scratch words an utterance.  Returns 0, the error of an occupancy
// query, or cudaErrorInvalidValue for tables the scan does not take.
extern "C" int decoder_scan_plan(const ScanTables* tables, int S, int B,
                                 long long* out) {
  const ScanTables tb = *tables;
  if (S < 1 || B < 1 || bad_tables(tb) || tb.r_top < 1 || tb.r_top > R_MAX)
    return (int)cudaErrorInvalidValue;
  Planned planned;
  cudaError_t rc = plan_for(tb, S, &planned);
  if (rc != cudaSuccess) return (int)rc;
  ScanPlan p;
  int active = 0;
  rc = choose(planned, B, &p, &active);
  if (rc != cudaSuccess) return (int)rc;
  const long long fields[11] = {p.onchip,    p.cs,        p.chunk,
                                p.threads,   p.rows_smem, p.groups_smem,
                                p.smem,      active,      p.in_nodes,
                                p.ex_smem,   p.scratch_words};
  for (int i = 0; i < 11; ++i) out[i] = fields[i];
  return 0;
}
// 1 where a node's states live in registers on chip (off chip only up to
// 8 states at W <= 2), 0 where the advance runs in place in the carry.
extern "C" int decoder_scan_states_in_regs(int Ns, int W) {
  return regs_kind(Ns, W, true) > 0;
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
      pt.rc_ptr == nullptr || pt.rc_group == nullptr ||
      pt.dead_ptr == nullptr || pt.dead_group == nullptr ||
      pt.src_ptr == nullptr || pt.src_block == nullptr ||
      pt.seg_ptr == nullptr || pt.flow_par == nullptr ||
      pt.flow_grp == nullptr ||
      pt.block_size < 1 || pt.n_active < 1 || pt.n_active > pt.n_blocks ||
      (long long)pt.n_blocks * pt.block_size != tb.n_nodes)
    return (int)cudaErrorInvalidValue;
  const PrunedPlan plan = pruned_plan(
      tb.n_nodes, tb.n_states, tb.band_w, S, pt.n_active, pt.block_size,
      tb.n_groups, tb.r_top);
  if ((!plan.meta_smem && io.meta == nullptr) ||
      (!plan.la_smem && io.la == nullptr) ||
      (!plan.ex_smem && (io.ex == nullptr || io.exc == nullptr)) ||
      (!plan.carry_smem && (io.d_work == nullptr || io.c_work == nullptr)))
    return (int)cudaErrorInvalidValue;
  const auto fn =
      plan.rows_smem ? &launch_pruned<true> : &launch_pruned<false>;
  return fn(B, threads_for(pt.n_active * pt.block_size, SCAN_THREADS),
            (cudaStream_t)stream_, tb, pt, plan, io, Tc, S, t0);
}

extern "C" int decoder_pruned_phases() { return PRUNED_PHASES; }
extern "C" int decoder_exact_phases() { return EXACT_PHASES; }

// Where the pruned scan keeps each part, as bits (1 = shared memory): 1
// the scores rows, 2 meta (the block arrays), 4 the groups' lookahead, 8
// the exits, 16 the carry, 32 the group tables.
extern "C" int decoder_pruned_smem(int N, int Ns, int W, int S, int K,
                                   int blk, int G, int R) {
  const PrunedPlan p = pruned_plan(N, Ns, W, S, K, blk, G, R);
  return p.rows_smem | p.meta_smem << 1 | p.la_smem << 2 | p.ex_smem << 3 |
         p.carry_smem << 4 | p.groups_smem << 5;
}

extern "C" const char* decoder_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
