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
// What bounds it: the length of one frame's dependent chain, times T.  At
// the training slice (B = 256 utterances, T = 319 frames, N = 50 sentence
// states, W = 5) a scan moves 33 MB (0.01 ms at the card's memory rate)
// and does ~4 MFLOP; but frame t needs frame t-1, so each utterance is 318
// dependent steps of: fetch W neighbours, W adds, a W-way max, W expf, a
// W-way sum, logf, two adds, a clamp.  With the library's expf and logf
// that chain is ~45 dependent operations, ~0.2 us on an H100, and 256
// utterances are 256 independent chains on a card with 528 warp
// schedulers: the time is (time of one step) x T whatever B is, up to a
// few hundred.  A design can only shorten the step, and keep everything
// that is not the chain (loads, stores, the mask, address arithmetic) off
// it.
//
// N <= 128 and W in 3..7 (the warp kernels; Viterbi's notes stand at its
// kernel):
//
// * A warp per utterance, the carry in registers.  Lane l owns the states
//   at places p = l + 32 r, r = 0..K-1, K = ceil(N / 32) <= 4, so log_b
//   loads and alpha / beta stores are coalesced with no alignment demand
//   on N.  Forward counts places from state 0 up (p = j), backward from
//   state N-1 down (p = N-1-j): either way the W-1 neighbours a step needs
//   sit at the places below, and come by __shfl_sync from lane (l - k) &
//   31, out of register r or, where the lane index wraps, r-1.  Below
//   place 0 the neighbour is exactly NEG_INF, and the dead lanes of a
//   partial last register hold NEG_INF and feed only each other.  No
//   barrier in the frame loop; the (W-1) K shuffles of a step are
//   independent of each other.
// * W and K are template constants: the band loops are exact and a lane
//   keeps W band entries per owned state in registers, loaded once.
// * A step is computed in every lane at every frame and the result then
//   selected (padded frame: identity step; beta: 0), so the loop body is
//   one basic block and a lane's K chains can interleave.  A kernel takes
//   as long as its longest utterance either way.
// * log_b reaches a step through a ring of RING frames per warp in shared
//   memory, filled by cp.async RING-1 steps ahead, each lane copying and
//   reading only its own entries (no barrier, no registers held by loads
//   in flight).  The frame mask is read 32 steps at a time, one byte a
//   lane, and a step's bit comes out of a ballot.  alpha / beta stores are
//   fire and forget.
// * Four warps a block: with B = 256 that is 64 blocks, a warp per
//   scheduler on 64 SMs.
// * loglik is a warp reduction (max by shuffle, then the sum of expf by
//   shuffle): the sum's order differs from a serial loop over N, within
//   float32 rounding of the result.
// * What the card showed: at K <= 2 a step costs what its chain costs
//   (K = 1 and K = 2 take the same time).  At K = 3, 4 a warp runs K
//   rows' arithmetic itself, and how well ptxas interleaves the rows
//   decides the time; the order of the rows in the source moves it
//   (backward walks its registers from K-1 down for that reason).
//
// * Viterbi's step has no expf and no logf: W adds and a first-maximum
//   compare-select chain.  Its backpointers stay on the SM, 4 bits a state
//   in shared memory, and the backtrace reads them there; an utterance
//   whose T-1 frames of them do not fit goes to the block route.
//
// N > 128 or another W (up to MAX_N and MAX_W), and Viterbi's utterances
// too long for its warp kernel: the block route (forward_block_kernel /
// backward_block_kernel / viterbi_block_kernel, see "Block route" and
// "Viterbi's block route" below) is the warp kernels' design spread over
// the warps of a CTA, and past one CTA over a thread-block cluster:
//
// * The carry stays in registers, K = 1, 2 or 4 places a lane, the W band
//   entries of each place loaded once; up to 16 warps a CTA (2,048 places)
//   and 16 CTAs a cluster (32,768 >= MAX_N).  Neighbours inside a warp come
//   by shuffle; only each warp's top W-1 places cross shared memory (to the
//   next CTA of the cluster through distributed shared memory).
// * No barrier in the frame loop: each warp hands its top W-1 places to
//   the warp above through a ring of edge slots (st.async counted on an
//   mbarrier, in the next CTA for a CTA's last warp), so the warps run as
//   a wavefront.
// * log_b through the warp kernels' cp.async ring, RING-1 frames ahead.
// * loglik (and Viterbi's end state) is a reduction over the cluster.
// * Viterbi's backpointers, 4 bits a place, go to a device scratch a word
//   of 8 steps at a time; after the loop one warp walks the backtrace by
//   windows of 32 steps staged in shared memory.
// * The launch chooses the cluster size from (B, N, W) and the card's
//   occupancy (block_plan), for each recursion's own instantiations.
//
// Every kernel does a step's arithmetic in the same order (terms k =
// 0..W-1 ascending, the maximum first, then the sum of expf(x - max),
// logf(sum) + max, + b_t, the clamp at NEG_INF), so alpha and beta of a
// warp kernel and of a block kernel are equal bit for bit, and so are
// Viterbi's score, path and final delta (adds, maxima and the smallest
// offset on a tie).
// expf/logf, no fast math: the logsumexp must match the plain version.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>
#include <vector>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int MAX_W = 16;

// ----------------------------------------------------------------------
// Warp kernels: forward and backward at N <= 128, W in 3..7
// ----------------------------------------------------------------------

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;        // warps (utterances) per block
constexpr int WARP_MAX_N = 128;
constexpr int WARP_MIN_W = 3;
constexpr int WARP_MAX_W = 7;
constexpr int RING = 8;         // frames of log_b per warp in shared memory

// One float from global to shared memory without passing a register: the
// copy is in flight until cp_async_wait says its group has landed.
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// Wait until at most PENDING of this thread's committed groups are in flight.
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(PENDING) : "memory");
}

// c ? x : y as one selp that the compiler cannot turn back into a branch
// around the computation of x.
__device__ __forceinline__ float select_f32(bool c, float x, float y) {
  float out;
  asm("{ .reg .pred p; setp.ne.u32 p, %3, 0; selp.f32 %0, %1, %2, p; }"
      : "=f"(out) : "f"(x), "f"(y), "r"((unsigned)c));
  return out;
}

// The block route's cluster of CTAs (one CTA where the launch's cluster
// size is 1): a barrier over all of its threads; shared-memory writes
// before it (this CTA's and stores into another's) are seen after it.
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
// The block route's hand-off between neighbouring warps.  Nothing on it
// releases at cluster scope (that waits for this thread's stores of alpha
// or beta to reach L2): data and signals travel by st.async, which counts
// its bytes on the receiving CTA's mbarrier, and a barrier's phase is armed
// by its own CTA (arrive.expect_tx, CTA scope).
//
// An mbarrier in this CTA's shared memory, for `count` arrivals a phase.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               ::"r"((unsigned)__cvta_generic_to_shared(bar)), "r"(count)
               : "memory");
}
// The barriers' initialisation, seen by the cluster after the next
// cluster_sync.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
// Arrive on this CTA's barrier, its phase to wait for `bytes` more.
__device__ __forceinline__ void mbar_arm(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "{ .reg .b64 st;\n\t"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1; }"
      ::"r"((unsigned)__cvta_generic_to_shared(bar)), "r"(bytes)
      : "memory");
}
// Wait until the phase of parity `parity` of this CTA's barrier `bar` has
// completed (its writes by st.async then seen).
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
// v into `dst` of CTA `rank` of the cluster (dst and bar given by their
// offsets in this CTA's shared memory), 4 bytes counted on that CTA's
// barrier `bar`.
__device__ __forceinline__ void st_async(float* dst, float v, uint64_t* bar,
                                         unsigned rank) {
  unsigned d, m;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(d)
               : "r"((unsigned)__cvta_generic_to_shared(dst)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(m)
               : "r"((unsigned)__cvta_generic_to_shared(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];" ::"r"(d), "f"(v), "r"(m) : "memory");
}

// A step's logsumexp at the band width the warp kernels' template fixes.
template <int W>
__device__ __forceinline__ float lse_w(const float (&x)[W]) {
  float mx = x[0];
#pragma unroll
  for (int k = 1; k < W; ++k) mx = fmaxf(mx, x[k]);
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < W; ++k) s += expf(x[k] - mx);
  return logf(s) + mx;
}

// A warp's view of one utterance's log_b and mask over the scan's steps
// i = 0..T-2 (forward: frame 1 + i; backward: frame T-2-i, with the mask of
// the frame after it).  log_b rows go through a ring of RING frames in
// shared memory, RING-1 steps ahead of their use, each lane copying and
// reading only its own places' entries (so no barrier).  The mask comes 32
// steps at a time, one byte a lane, with the next 32 bytes already in a
// register; a step's bit is read out of a ballot.  Nothing here branches:
// a step of the scan is one basic block, so the copies, the address
// arithmetic and the mask overlap the latency of the step's arithmetic.
static_assert((RING & (RING - 1)) == 0, "RING is a power of two");

template <int K, bool FORWARD>
struct FrameFeed {
  const float* src;    // log_b of the frame the next copy fetches, place 32 r
                       // of this lane at src[+-32 r]
  const uint8_t* mk;   // mask[b]
  float* ring;         // this warp's [RING][K][32], + lane
  int T, N, lane;
  uint8_t byte, next;  // mask of steps 32 q + lane and 32 (q + 1) + lane
  int live = -1;       // places of this warp that hold a state (-1: N)

  __device__ __forceinline__ uint8_t mask_byte(int i) const {
    // the mask that step i reads: frame 1+i (forward), T-1-i (backward)
    return i < T - 1 ? mk[FORWARD ? 1 + i : T - 1 - i] : 0;
  }
  __device__ __forceinline__ void copy_ahead(int n) {  // step n -> slot n % RING
    float* dst = ring + (n & (RING - 1)) * (K * 32);
#pragma unroll
    for (int r = 0; r < K; ++r)
      if (n < T - 1 && lane + 32 * r < (live < 0 ? N : live))
        cp_async_f32(dst + 32 * r, src + (FORWARD ? 32 * r : -32 * r));
    cp_async_commit();  // an empty group past the end keeps the count
    src += FORWARD ? N : -N;
  }
  __device__ __forceinline__ void start() {
#pragma unroll 1
    for (int n = 0; n < RING - 1; ++n) copy_ahead(n);
    byte = mask_byte(lane);
    next = mask_byte(32 + lane);
  }
  // Step i: whether its frame is real (the same for every lane), and
  // log_b of the step's frame for this lane's places.
  __device__ __forceinline__ bool step(int i, float (&b_t)[K]) {
    const unsigned bits = __ballot_sync(FULL, byte != 0);
    if ((i & 31) == 31) {
      byte = next;
      next = mask_byte(i + 33 + lane);
    }
    cp_async_wait<RING - 2>();  // step i's group has landed
    const float* slot = ring + (i & (RING - 1)) * (K * 32);
#pragma unroll
    for (int r = 0; r < K; ++r) b_t[r] = slot[32 * r];
    copy_ahead(i + RING - 1);  // into the slot step i-1 read
    return (bits >> (i & 31)) & 1u;
  }
};

// sh[r][k] = c[r] of lane (lane - k) & 31, k = 1..W-1: every neighbour a
// step needs, in (W-1) K independent shuffles.
template <int K, int W>
__device__ __forceinline__ void fetch_below(const float (&c)[K], int lane,
                                            float (&sh)[K][W]) {
#pragma unroll
  for (int k = 1; k < W; ++k)
#pragma unroll
    for (int r = 0; r < K; ++r)
      sh[r][k] = __shfl_sync(FULL, c[r], (lane - k) & 31);
}

// The carry k places below register r's place: in the same register where
// the lane index does not wrap, else in register r-1; below place 0 it is
// exactly NEG_INF.
template <int K, int W>
__device__ __forceinline__ float below(const float (&sh)[K][W], int r, int k,
                                       int lane) {
  if (r == 0) return lane >= k ? sh[0][k] : NEG_INF;
  return lane >= k ? sh[r][k] : sh[r > 0 ? r - 1 : 0][k];
}

// Static shared memory of a warp kernel: its blocks' log_b rings.
constexpr size_t ring_bytes(int K) {
  return sizeof(float) * WARPS * RING * K * 32;
}

template <int K, int W>
__global__ void __launch_bounds__(32 * WARPS)
forward_warp_kernel(const float* __restrict__ band,
                    const float* __restrict__ log_pi,
                    const float* __restrict__ log_b,
                    const uint8_t* __restrict__ mask,
                    float* __restrict__ alpha, float* __restrict__ loglik,
                    int B, int T, int N) {
  __shared__ float rings[WARPS][RING][K][32];
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp leaves: no block barrier follows
  const float* lb = log_b + (size_t)b * T * N + lane;
  float* out = alpha + (size_t)b * T * N + lane;
  FrameFeed<K, true> feed{lb + N, mask + (size_t)b * T,
                          &rings[threadIdx.x >> 5][0][0][lane], T, N, lane,
                          0, 0};
  feed.start();

  bool live[K];
  float bin[K][W];  // bin[r][k] = band[b, j-k, k], j = lane + 32 r
  float a[K];       // NEG_INF in dead lanes
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int j = lane + 32 * r;
    live[r] = j < N;
#pragma unroll
    for (int k = 0; k < W; ++k)
      bin[r][k] = (live[r] && j - k >= 0)
                      ? band[((size_t)b * N + (j - k)) * W + k] : 0.0f;
    a[r] = NEG_INF;
    if (live[r]) {
      a[r] = log_pi[(size_t)b * N + j] + lb[32 * r];
      out[32 * r] = a[r];
    }
  }

#pragma unroll 1
  for (int i = 0; i < T - 1; ++i) {  // frame t = 1 + i
    float b_t[K];
    const bool m_t = feed.step(i, b_t);  // the same for every lane
    out += N;
    float sh[K][W];
    fetch_below<K, W>(a, lane, sh);
#pragma unroll
    for (int r = 0; r < K; ++r) {
      float x[W];
      x[0] = a[r] + bin[r][0];
#pragma unroll
      for (int k = 1; k < W; ++k)
        // below state 0 bin is 0, and the term exactly NEG_INF
        x[k] = below<K, W>(sh, r, k, lane) + bin[r][k];
      const float v = fmaxf(lse_w<W>(x) + b_t[r], NEG_INF);
      a[r] = select_f32(m_t && live[r], v, a[r]);
    }
#pragma unroll
    for (int r = 0; r < K; ++r)
      if (live[r]) out[32 * r] = a[r];
  }

  // loglik = logsumexp over the N live states, by the warp: the maximum,
  // then the sum of expf(a - max), both by butterfly shuffles.  The sum's
  // order differs from a serial loop over N (float32 rounding of loglik).
  float mx = NEG_INF;  // every live a[r] is >= NEG_INF by the clamp
#pragma unroll
  for (int r = 0; r < K; ++r) mx = fmaxf(mx, a[r]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
  float s = 0.0f;
#pragma unroll
  for (int r = 0; r < K; ++r)
    if (live[r]) s += expf(a[r] - mx);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  if (lane == 0) loglik[b] = logf(s) + mx;
}

template <int K, int W>
__global__ void __launch_bounds__(32 * WARPS)
backward_warp_kernel(const float* __restrict__ band,
                     const float* __restrict__ log_b,
                     const uint8_t* __restrict__ mask,
                     float* __restrict__ beta, int B, int T, int N) {
  __shared__ float rings[WARPS][RING][K][32];
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;
  // Places count down from the utterance's end: register r of lane l owns
  // state j = N-1-(l + 32 r), so state j+k sits k places below, as state
  // j-k does in the forward kernel.
  const float* lb = log_b + (size_t)b * T * N + (N - 1 - lane);
  float* out = beta + ((size_t)b * T + (T - 1)) * N + (N - 1 - lane);
  FrameFeed<K, false> feed{lb + (ptrdiff_t)(T - 2) * N, mask + (size_t)b * T,
                           &rings[threadIdx.x >> 5][0][0][lane], T, N, lane,
                           0, 0};
  feed.start();

  bool live[K];
  float bout[K][W];  // bout[r][k] = band[b, j, k], j = N-1-(lane + 32 r)
  float s[K];        // s = b_{t+1} + beta_{t+1}; NEG_INF in dead lanes
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int j = N - 1 - (lane + 32 * r);
    live[r] = j >= 0;
#pragma unroll
    for (int k = 0; k < W; ++k)
      bout[r][k] = live[r] ? band[((size_t)b * N + j) * W + k] : 0.0f;
    s[r] = NEG_INF;
    if (live[r]) {
      out[-32 * r] = 0.0f;
      s[r] = lb[(ptrdiff_t)(T - 1) * N - 32 * r] + 0.0f;
    }
  }

#pragma unroll 1
  for (int i = 0; i < T - 1; ++i) {  // frame t = T-2-i
    float b_t[K];
    const bool m_next = feed.step(i, b_t);  // validity of frame t+1
    out -= N;
    float sh[K][W];
    fetch_below<K, W>(s, lane, sh);
#pragma unroll
    for (int r = K - 1; r >= 0; --r) {
      float x[W];
      x[0] = bout[r][0] + s[r];
#pragma unroll
      for (int k = 1; k < W; ++k)
        // past state N-1 the band entry is added to NEG_INF, as the block
        // kernel and the plain version do
        x[k] = bout[r][k] + below<K, W>(sh, r, k, lane);
      // beta resets to 0 while frame t+1 is padding
      const float bt = select_f32(m_next, fmaxf(lse_w<W>(x), NEG_INF), 0.0f);
      if (live[r]) out[-32 * r] = bt;
      s[r] = live[r] ? b_t[r] + bt : NEG_INF;
    }
  }
}

// ----------------------------------------------------------------------
// Block route: forward and backward where the warp kernels do not take
// (N, W), up to MAX_N states and MAX_W (Viterbi's: see below)
// ----------------------------------------------------------------------
//
// The warp kernels' design over many warps.  An utterance's places (forward:
// p = j; backward: p = N-1-j) are cut into ranges of 32 K, one a warp:
// global warp g owns places 32 K g + lane + 32 r, r = 0..K-1, its carry in
// K registers a lane and its places' W band entries loaded once.  A CTA
// holds up to BLOCK_WARPS warps; past 32 K BLOCK_WARPS places an utterance
// runs on a thread-block cluster of up to MAX_CLUSTER CTAs.  K is 1, 2 or
// 4 (the least that holds the CTA's share), so registers hold every N up to
// 4 x 32 x 16 x 16 = 32,768 > MAX_N.
//
// A step needs the W-1 places below each place: inside the warp by shuffle,
// as in the warp kernels; below the warp's lowest place, from the top W-1
// places of the warp below, handed over warp to warp with no barrier over
// the CTA: the warp below stores them, each frame, by st.async into one of
// SLOTS edge slots of the warp above (in the next CTA's shared memory for a
// CTA's last warp), counted on the slot's `full` mbarrier there; the warp
// above waits on it, reads the slot, arms it for its next use and hands the
// slot back by an st.async counted on the warp below's `empty` mbarrier,
// which the warp below waits on before it fills the slot again.  So the
// warps run as a wavefront: warp g's frame t needs warp g-1's frame t-1 and
// may run up to SLOTS frames behind it.  A warp advances its registers from
// the top one down (a register's row needs its own and the next lower
// register's old values, so each is overwritten in turn); the edge slot
// is read at the top of the frame, so that the K rows' chains are one block
// of arithmetic that the compiler interleaves.  log_b comes through the warp
// kernels' FrameFeed (a ring of RING frames a warp, cp.async, no barrier).
// Dead places (past N) hold NEG_INF and feed only dead places above them.
// loglik is reduced over the cluster: each warp's maximum by shuffles, the
// CTA's and the cluster's in rank order, then the sum of expf(a - max) the
// same way.
//
// What bounds it (an H100): a frame is one dependent step of each warp and
// ~230 instructions a warp at K = 1, W = 5 to dispatch, ~85 of them the
// logsumexp, the rest the feed, the hand-off and their addresses; with 9
// to 18 warps an SM dispatching them sets the frame (0.5-0.7 us).  A cluster
// spreads an utterance's warps over SMs at the cost of hand-offs through
// distributed shared memory; block_plan weighs the two.  A cluster barrier
// a frame (split into arrive and wait), or mbarrier arrivals that release
// at cluster scope, cost 1-1.4 us a frame at every shape: a release waits
// for the thread's stores of alpha or beta to reach L2.  st.async does
// not, and the arming arrivals release at CTA scope only.

constexpr int BLOCK_WARPS = 16;     // warps a CTA at most
constexpr int MAX_CLUSTER = 16;     // CTAs an utterance at most
constexpr int PORTABLE_CLUSTER = 8;
constexpr int SLOTS = 4;            // edge slots a warp
constexpr int EDGE = MAX_W;         // an edge slot's floats (W-1 used)
static_assert(MAX_W - 1 <= 32, "an edge is the top W-1 lanes of a warp");

// A block-route CTA's dynamic shared memory: the warps' `full` and `empty`
// mbarriers [2][warps][SLOTS], then in floats their log_b rings
// [warps][RING][K][32], their edge slots [warps][SLOTS][EDGE], the words
// their slots' hand-backs land in [warps][SLOTS], and the loglik partials
// [warps + 3] (a value a warp; the CTA's maximum, the CTA's sum, the
// utterance's maximum).
__host__ __device__ inline size_t block_smem_bytes(int warps, int k) {
  return 2 * (size_t)warps * SLOTS * sizeof(uint64_t) +
         sizeof(float) * ((size_t)warps * RING * k * 32 +
                          (size_t)warps * SLOTS * (EDGE + 1) + warps + 3);
}

// A thread's place in the block route.
struct BlockCta {
  int cs, rank, b, warps, wid, lane, base;  // base: its warp's first place
  int wn, last;         // band width; the last frame whose edge is handed
  bool below, above;    // whether a warp lies below / above its places
  uint64_t* full;       // its slots' [SLOTS]: filled by the warp below
  uint64_t* empty;      // [SLOTS]: its edges read by the warp above
  float* ring;          // [RING][K][32]
  float* slot;          // [SLOTS][EDGE]: the warp below's top places
  float* sink;          // [SLOTS]: where the warp above's hand-backs land
  float* part;          // the CTA's [warps + 3]
  // the warp above's slots and full barriers, and the warp below's empty
  // barriers: this CTA's, or (a CTA's last / first warp) at the same
  // offsets in the next / previous CTA's
  int up_rank, up_wid, down_rank, down_wid;
};

template <int K>
__device__ __forceinline__ BlockCta block_cta(unsigned char* smem, int cs,
                                              int T, int wn) {
  BlockCta c;
  c.cs = cs;
  c.wn = wn;
  c.last = T - 2;
  c.rank = blockIdx.x % cs;   // a cluster is cs consecutive CTAs
  c.b = blockIdx.x / cs;
  c.warps = blockDim.x >> 5;
  c.wid = threadIdx.x >> 5;
  c.lane = threadIdx.x & 31;
  const int g = c.rank * c.warps + c.wid;
  c.base = g * 32 * K;
  // a band of width 1 has no neighbours: no hand-off
  c.below = wn > 1 && g > 0;
  c.above = wn > 1 && g + 1 < cs * c.warps;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  c.full = bars + c.wid * SLOTS;
  c.empty = bars + (c.warps + c.wid) * SLOTS;
  float* f = reinterpret_cast<float*>(bars + 2 * c.warps * SLOTS);
  c.ring = f + (size_t)c.wid * RING * K * 32;
  c.slot = f + (size_t)c.warps * RING * K * 32 + c.wid * SLOTS * EDGE;
  c.sink = f + (size_t)c.warps * (RING * K * 32 + SLOTS * EDGE) +
           c.wid * SLOTS;
  c.part = f + (size_t)c.warps * (RING * K * 32 + SLOTS * (EDGE + 1));
  c.up_rank = c.wid + 1 < c.warps ? c.rank : c.rank + 1;
  c.up_wid = c.wid + 1 < c.warps ? c.wid + 1 : 0;
  c.down_rank = c.wid > 0 ? c.rank : c.rank - 1;
  c.down_wid = c.wid > 0 ? c.wid - 1 : c.warps - 1;
  return c;
}

// Every warp's barriers, the first use of each armed (its slots by this
// warp, for the W-1 edge values; its hand-backs by this warp, for the ones
// the warp above will send), then every CTA of the cluster running with
// them, before any st.async reaches another CTA.
__device__ __forceinline__ void block_start(const BlockCta& c) {
  if (c.lane < SLOTS) {
    mbar_init(c.full + c.lane, 1);
    mbar_init(c.empty + c.lane, 1);
    if (c.below) mbar_arm(c.full + c.lane, 4 * (c.wn - 1));
    if (c.above && c.lane + SLOTS <= c.last) mbar_arm(c.empty + c.lane, 4);
  }
  mbar_init_fence();
  cluster_sync();
}

// Hand frame e's top W-1 places of this warp (lane 31 - m holds place
// 32 K (g + 1) - 1 - m in its last register v, m = 0..W-2) to the warp
// above: wait until it has read the slot's last edge (and arm the slot's
// next hand-back, where the warp above will send one), then st.async the
// values into its slot, counted on its full barrier.
__device__ __forceinline__ void hand_up(const BlockCta& c, float v, int e) {
  if (!c.above) return;
  const int s = e % SLOTS;
  if (e >= SLOTS) {
    mbar_wait(c.empty + s, ((e / SLOTS) - 1) & 1);
    __syncwarp();
    if (c.lane == 0 && e + SLOTS <= c.last) mbar_arm(c.empty + s, 4);
  }
  const int d = c.up_wid - c.wid;   // the warp above's offset in its CTA
  const int m = 31 - c.lane;
  if (m < c.wn - 1)
    st_async(c.slot + (d * SLOTS + s) * EDGE + m, v, c.full + d * SLOTS + s,
             (unsigned)c.up_rank);
}

// lo[k] = the carry k places below this lane's lowest place, for lanes
// below k: frame e's top places of the warp below (NEG_INF below place 0).
// Wait for them, read them, arm the slot for its next use, and hand it back
// to the warp below (lane 0's st.async carries a value it read, so it
// leaves after the reads) where the warp below will fill it again.
template <int WA>
__device__ __forceinline__ void take_below(const BlockCta& c, int e,
                                           float (&lo)[WA]) {
  if (!c.below) {
#pragma unroll
    for (int k = 1; k < WA; ++k) lo[k] = NEG_INF;
    return;
  }
  const int s = e % SLOTS;
  mbar_wait(c.full + s, (e / SLOTS) & 1);
  const float* edge = c.slot + s * EDGE - c.lane - 1;
#pragma unroll
  for (int k = 1; k < WA; ++k)
    if (k < c.wn) lo[k] = c.lane < k ? edge[k] : 0.0f;
  __syncwarp();
  if (c.lane == 0) {
    mbar_arm(c.full + s, 4 * (c.wn - 1));
    if (e + SLOTS <= c.last) {
      const int d = c.down_wid - c.wid;
      st_async(c.sink + d * SLOTS + s, lo[1], c.empty + d * SLOTS + s,
               (unsigned)c.down_rank);
    }
  }
}

// sh[k] = v of lane (lane - k) & 31, k = 1..W-1.
template <int WA>
__device__ __forceinline__ void shuffle_below(float v, int lane, int wn,
                                              float (&sh)[WA]) {
#pragma unroll
  for (int k = 1; k < WA; ++k)
    if (k < wn) sh[k] = __shfl_sync(FULL, v, (lane - k) & 31);
}

// lse_w at a band width of wn <= WA (WA = MAX_W: the runtime width).
template <int WA>
__device__ __forceinline__ float lse_n(const float (&x)[WA], int wn) {
  float mx = x[0];
#pragma unroll
  for (int k = 1; k < WA; ++k)
    if (k < wn) mx = fmaxf(mx, x[k]);
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < WA; ++k)
    if (k < wn) s += expf(x[k] - mx);
  return logf(s) + mx;
}

template <int K, int W>  // W = 0: the band width w_rt at run time
__global__ void __launch_bounds__(32 * BLOCK_WARPS)
forward_block_kernel(const float* __restrict__ band,
                     const float* __restrict__ log_pi,
                     const float* __restrict__ log_b,
                     const uint8_t* __restrict__ mask,
                     float* __restrict__ alpha, float* __restrict__ loglik,
                     int T, int N, int w_rt, int cs) {
  constexpr int WA = W ? W : MAX_W;
  const int wn = W ? W : w_rt;
  extern __shared__ __align__(16) unsigned char dp_smem[];
  const BlockCta c = block_cta<K>(dp_smem, cs, T, wn);
  const int lane = c.lane;
  const float* lb = log_b + (size_t)c.b * T * N + c.base + lane;
  float* out = alpha + (size_t)c.b * T * N + c.base + lane;
  FrameFeed<K, true> feed{lb + N, mask + (size_t)c.b * T, c.ring + lane, T,
                          N, lane, 0, 0, N > c.base ? N - c.base : 0};
  feed.start();

  bool live[K];
  float bin[K][WA];  // bin[r][k] = band[b, j-k, k], j = base + lane + 32 r
  float a[K];        // NEG_INF at dead places
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int j = c.base + lane + 32 * r;
    live[r] = j < N;
#pragma unroll
    for (int k = 0; k < WA; ++k)
      bin[r][k] = (k < wn && live[r] && j - k >= 0)
                      ? band[((size_t)c.b * N + (j - k)) * wn + k] : 0.0f;
    a[r] = NEG_INF;
    if (live[r]) {
      a[r] = log_pi[(size_t)c.b * N + j] + lb[32 * r];
      out[32 * r] = a[r];
    }
  }
  block_start(c);
  if (T > 1) hand_up(c, a[K - 1], 0);

#pragma unroll 1
  for (int t = 1; t < T; ++t) {
    float b_t[K];
    const bool m_t = feed.step(t - 1, b_t);  // the same for every lane
    out += N;
    // the edge first, so that the K rows below are one block of arithmetic
    float edge[WA], hi[WA], lo[WA];  // the carry k places below rows r, r-1
    take_below<WA>(c, t - 1, edge);
    shuffle_below<WA>(a[K - 1], lane, wn, hi);
#pragma unroll
    for (int r = K - 1; r >= 0; --r) {
      if (r > 0) {
        shuffle_below<WA>(a[r > 0 ? r - 1 : 0], lane, wn, lo);
      } else {
#pragma unroll
        for (int k = 1; k < WA; ++k) lo[k] = edge[k];
      }
      float x[WA];
      x[0] = a[r] + bin[r][0];
#pragma unroll
      for (int k = 1; k < WA; ++k)
        // below state 0 bin is 0, and the term exactly NEG_INF
        if (k < wn) x[k] = (lane >= k ? hi[k] : lo[k]) + bin[r][k];
      const float v = fmaxf(lse_n<WA>(x, wn) + b_t[r], NEG_INF);
      a[r] = select_f32(m_t && live[r], v, a[r]);
#pragma unroll
      for (int k = 1; k < WA; ++k) hi[k] = lo[k];
    }
    if (t + 1 < T) hand_up(c, a[K - 1], t);
#pragma unroll
    for (int r = 0; r < K; ++r)
      if (live[r]) out[32 * r] = a[r];
  }

  // loglik = logsumexp over the N states: each warp's maximum by shuffles,
  // the CTA's and then the cluster's in rank order; the sum of expf(a - max)
  // the same way; rank 0 writes it.  Every live a is >= NEG_INF.
  float mx = NEG_INF;
#pragma unroll
  for (int r = 0; r < K; ++r) mx = fmaxf(mx, a[r]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
  if (lane == 0) c.part[c.wid] = mx;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = c.part[0];
    for (int w = 1; w < c.warps; ++w) m = fmaxf(m, c.part[w]);
    c.part[c.warps] = m;
  }
  cluster_sync();
  if (threadIdx.x == 0) {
    float m = NEG_INF;
    for (int q = 0; q < cs; ++q)
      m = fmaxf(m, *cluster_map(c.part + c.warps, (unsigned)q));
    c.part[c.warps + 2] = m;
  }
  __syncthreads();
  const float top = c.part[c.warps + 2];
  float s = 0.0f;
#pragma unroll
  for (int r = 0; r < K; ++r)
    if (live[r]) s += expf(a[r] - top);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  if (lane == 0) c.part[c.wid] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.0f;
    for (int w = 0; w < c.warps; ++w) sum += c.part[w];
    c.part[c.warps + 1] = sum;
  }
  cluster_sync();
  if (c.rank == 0 && threadIdx.x == 0) {
    float sum = 0.0f;
    for (int q = 0; q < cs; ++q)
      sum += *cluster_map(c.part + c.warps + 1, (unsigned)q);
    loglik[c.b] = logf(sum) + top;
  }
  cluster_sync();  // no CTA leaves while rank 0 reads its sum
}

template <int K, int W>  // W = 0: the band width w_rt at run time
__global__ void __launch_bounds__(32 * BLOCK_WARPS)
backward_block_kernel(const float* __restrict__ band,
                      const float* __restrict__ log_b,
                      const uint8_t* __restrict__ mask,
                      float* __restrict__ beta, int T, int N, int w_rt,
                      int cs) {
  constexpr int WA = W ? W : MAX_W;
  const int wn = W ? W : w_rt;
  extern __shared__ __align__(16) unsigned char dp_smem[];
  const BlockCta c = block_cta<K>(dp_smem, cs, T, wn);
  const int lane = c.lane;
  // Places count down from the utterance's end: register r of this lane
  // owns state j = N-1-(base + lane + 32 r), so state j+k sits k places
  // below, as state j-k does in forward.
  const ptrdiff_t j0 = (ptrdiff_t)N - 1 - (c.base + lane);
  const float* lb = log_b + (size_t)c.b * T * N + j0;
  float* out = beta + ((size_t)c.b * T + (T - 1)) * N + j0;
  FrameFeed<K, false> feed{lb + (ptrdiff_t)(T - 2) * N, mask + (size_t)c.b * T,
                           c.ring + lane, T, N, lane, 0, 0,
                           N > c.base ? N - c.base : 0};
  feed.start();

  bool live[K];
  float bout[K][WA];  // bout[r][k] = band[b, j, k]
  float s[K];         // s = b_{t+1} + beta_{t+1}; NEG_INF at dead places
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const ptrdiff_t j = j0 - 32 * r;
    live[r] = j >= 0;
#pragma unroll
    for (int k = 0; k < WA; ++k)
      bout[r][k] = (k < wn && live[r])
                       ? band[((size_t)c.b * N + j) * wn + k] : 0.0f;
    s[r] = NEG_INF;
    if (live[r]) {
      out[-32 * r] = 0.0f;
      s[r] = lb[(ptrdiff_t)(T - 1) * N - 32 * r] + 0.0f;
    }
  }
  block_start(c);
  if (T > 1) hand_up(c, s[K - 1], 0);

#pragma unroll 1
  for (int i = 1; i < T; ++i) {  // frame t = T-1-i
    float b_t[K];
    const bool m_next = feed.step(i - 1, b_t);  // validity of frame t+1
    out -= N;
    float edge[WA], hi[WA], lo[WA];
    take_below<WA>(c, i - 1, edge);
    shuffle_below<WA>(s[K - 1], lane, wn, hi);
#pragma unroll
    for (int r = K - 1; r >= 0; --r) {
      if (r > 0) {
        shuffle_below<WA>(s[r > 0 ? r - 1 : 0], lane, wn, lo);
      } else {
#pragma unroll
        for (int k = 1; k < WA; ++k) lo[k] = edge[k];
      }
      float x[WA];
      x[0] = bout[r][0] + s[r];
#pragma unroll
      for (int k = 1; k < WA; ++k)
        // past state N-1 the band entry is added to NEG_INF, as the warp
        // kernel and the plain version do
        if (k < wn) x[k] = bout[r][k] + (lane >= k ? hi[k] : lo[k]);
      // beta resets to 0 while frame t+1 is padding
      const float bt = select_f32(m_next, fmaxf(lse_n<WA>(x, wn), NEG_INF),
                                  0.0f);
      if (live[r]) out[-32 * r] = bt;
      s[r] = live[r] ? b_t[r] + bt : NEG_INF;
#pragma unroll
      for (int k = 1; k < WA; ++k) hi[k] = lo[k];
    }
    if (i + 1 < T) hand_up(c, s[K - 1], i);
  }
  cluster_sync();  // no CTA leaves while another may arrive on its barriers
}

// ----------------------------------------------------------------------
// Viterbi's block route
// ----------------------------------------------------------------------
//
// forward_block_kernel's layout, feed and hand-off with Viterbi's step: W
// adds and a first-maximum compare-select chain (strict >, so the smallest
// offset wins a tie), then the clamp; a padded frame keeps delta and
// writes offset 0.  The arithmetic is adds and maxima, so score, path and
// final delta equal the warp kernel's bit for bit whatever the layout.
//
// The backpointers (an offset < W <= 16: 4 bits) go to a device scratch of
// ceil((T-1) / 8) x N words an utterance, word q of state j holding j's
// offsets of steps 8q .. 8q+7: a lane packs each of its places' offsets
// into a register and stores the K words every 8th step, coalesced, fire
// and forget.  (On chip they would not fit: a CTA of 16 warps at K = 4
// makes 1 KB of them a frame, 318 KB at T = 319, beside its ~66 KB ring.)
//
// After the loop the end state, the first maximum over the end states, is
// reduced over the cluster as loglik is: each warp's by shuffles (the
// larger value, on equal values the lower state), then the CTA's and the
// cluster's in rank order.  One cluster barrier makes every CTA's scratch
// words visible, and one warp walks the backtrace by windows of WALK = 32
// steps, every lane the same state, storing path 32 frames at a time.  An
// offset is < W, so the states of a window's steps lie within 32 (W-1)
// places below the state it starts from, and those of the next window
// within 64 (W-1): as the warp starts a window it copies the next
// window's 4 words of each of those places into a second buffer of shared
// memory by cp.async, and walks the window from the first buffer: 32
// unrolled steps of one shared-memory load each, with no branch, whose
// chain hides the copies' latency.  A degenerate utterance whose deltas
// all sit at the sentinel backtraces below state 0, and JAX's indexing (a
// negative state counts from the end once, then clamps) jumps to the top
// of the range, out of the buffer: that window is walked again by checked
// steps that stage what they need.

constexpr int OFFS_STEPS = 8;   // steps of offsets in a scratch word
constexpr int WALK = 32;        // steps of a backtrace window
static_assert(WALK == 32, "a window's frames are a warp's path stores");
constexpr int NO_STATE = 0x7fffffff;

// Words of one utterance's backpointers in the scratch.
__host__ __device__ inline size_t viterbi_block_words(int T, int N) {
  return (size_t)((T - 1 + OFFS_STEPS - 1) / OFFS_STEPS) * N;
}

// Places a staged backtrace window holds at band width w: those its own
// steps and the next window's can reach.
__host__ __device__ inline int walk_span(int w) {
  return 2 * WALK * (w - 1) + 1;
}

// Viterbi's CTA's dynamic shared memory: the block route's, then each
// warp's end state and the CTA's [warps + 1], then two staged windows'
// words [2][WALK / OFFS_STEPS][walk_span(w)].
__host__ __device__ inline size_t viterbi_smem_bytes(int warps, int k,
                                                     int w) {
  return block_smem_bytes(warps, k) + sizeof(int) * (warps + 1) +
         sizeof(uint32_t) * 2 * (WALK / OFFS_STEPS) * walk_span(w);
}

// Copy by cp.async the words of window `window`'s steps (its WALK /
// OFFS_STEPS groups of the utterance's `groups`) of the places [lo, hi],
// lo = max(hi - span + 1, 0), into buf [WALK / OFFS_STEPS][span], a lane
// every 32nd place; returns lo.  One commit group.
__device__ __forceinline__ int walk_stage(uint32_t* buf,
                                          const uint32_t* words, int window,
                                          int hi, int span, int groups,
                                          int N, int lane) {
  const int lo = hi - span + 1 > 0 ? hi - span + 1 : 0;
#pragma unroll
  for (int g = 0; g < WALK / OFFS_STEPS; ++g) {
    const int q = window * (WALK / OFFS_STEPS) + g;
    if (q < groups)
      for (int i = lane; i <= hi - lo; i += 32)
        cp_async_f32(reinterpret_cast<float*>(buf + g * span + i),
                     reinterpret_cast<const float*>(words + (size_t)q * N +
                                                    lo + i));
  }
  cp_async_commit();
  return lo;
}

// The first maximum over the warp's lanes: the larger value, on equal
// values the lower state; a lane holding NO_STATE holds none.  Every lane
// ends with the same (top, state).
__device__ __forceinline__ void warp_first_max(float& top, int& state) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float v = __shfl_xor_sync(FULL, top, o);
    const int j = __shfl_xor_sync(FULL, state, o);
    if (j != NO_STATE &&
        (state == NO_STATE || v > top || (v == top && j < state))) {
      top = v;
      state = j;
    }
  }
}

template <int K, int W>  // W = 0: the band width w_rt at run time
__global__ void __launch_bounds__(32 * BLOCK_WARPS)
viterbi_block_kernel(const float* __restrict__ band,
                     const float* __restrict__ log_pi,
                     const float* __restrict__ log_b,
                     const uint8_t* __restrict__ mask,
                     uint32_t* __restrict__ offs, float* __restrict__ score,
                     int32_t* __restrict__ path,
                     float* __restrict__ delta_last, int T, int N, int w_rt,
                     int end_states, int cs) {
  constexpr int WA = W ? W : MAX_W;
  const int wn = W ? W : w_rt;
  extern __shared__ __align__(16) unsigned char dp_smem[];
  const BlockCta c = block_cta<K>(dp_smem, cs, T, wn);
  const int lane = c.lane;
  const float* lb = log_b + (size_t)c.b * T * N + c.base + lane;
  uint32_t* const words = offs + (size_t)c.b * viterbi_block_words(T, N);
  uint32_t* out = words + c.base + lane;
  FrameFeed<K, true> feed{lb + N, mask + (size_t)c.b * T, c.ring + lane, T,
                          N, lane, 0, 0, N > c.base ? N - c.base : 0};
  feed.start();

  bool live[K];
  float bin[K][WA];  // bin[r][k] = band[b, j-k, k], j = base + lane + 32 r
  float d[K];        // NEG_INF at dead places
  uint32_t packed[K];  // this word's offsets so far, 4 bits a step
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int j = c.base + lane + 32 * r;
    live[r] = j < N;
#pragma unroll
    for (int k = 0; k < WA; ++k)
      bin[r][k] = (k < wn && live[r] && j - k >= 0)
                      ? band[((size_t)c.b * N + (j - k)) * wn + k] : 0.0f;
    d[r] = live[r] ? log_pi[(size_t)c.b * N + j] + lb[32 * r] : NEG_INF;
    packed[r] = 0u;
  }
  block_start(c);
  if (T > 1) hand_up(c, d[K - 1], 0);

#pragma unroll 1
  for (int t = 1; t < T; ++t) {
    float b_t[K];
    const bool m_t = feed.step(t - 1, b_t);  // the same for every lane
    const int at = 4 * ((t - 1) & (OFFS_STEPS - 1));  // its bits in a word
    float edge[WA], hi[WA], lo[WA];  // the carry k places below rows r, r-1
    take_below<WA>(c, t - 1, edge);
    shuffle_below<WA>(d[K - 1], lane, wn, hi);
#pragma unroll
    for (int r = K - 1; r >= 0; --r) {
      if (r > 0) {
        shuffle_below<WA>(d[r > 0 ? r - 1 : 0], lane, wn, lo);
      } else {
#pragma unroll
        for (int k = 1; k < WA; ++k) lo[k] = edge[k];
      }
      float best = d[r] + bin[r][0];
      unsigned bk = 0;
#pragma unroll
      for (int k = 1; k < WA; ++k)
        if (k < wn) {
          // below state 0 bin is 0, and the candidate exactly NEG_INF
          const float cand = (lane >= k ? hi[k] : lo[k]) + bin[r][k];
          const bool wins = cand > best;  // strict: the smallest offset wins
          best = wins ? cand : best;
          bk = wins ? (unsigned)k : bk;
        }
      const bool take = m_t && live[r];
      d[r] = select_f32(take, fmaxf(best + b_t[r], NEG_INF), d[r]);
      packed[r] |= (take ? bk : 0u) << at;  // a padded frame: offset 0
#pragma unroll
      for (int k = 1; k < WA; ++k) hi[k] = lo[k];
    }
    if (t + 1 < T) hand_up(c, d[K - 1], t);
    if (at == 4 * (OFFS_STEPS - 1) || t + 1 == T) {  // the word is complete
#pragma unroll
      for (int r = 0; r < K; ++r) {
        if (live[r]) out[32 * r] = packed[r];
        packed[r] = 0u;
      }
      out += N;
    }
  }

#pragma unroll
  for (int r = 0; r < K; ++r)
    if (live[r]) delta_last[(size_t)c.b * N + c.base + lane + 32 * r] = d[r];

  // The end state: a lane's own first maximum over [lo_end, N) (its places
  // ascend with r), the warp's, the CTA's in warp order, the cluster's.
  const int lo_end = end_states > 0 ? N - end_states : 0;
  float top = 0.0f;
  int state = NO_STATE;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int j = c.base + lane + 32 * r;
    if (j >= lo_end && j < N && (state == NO_STATE || d[r] > top)) {
      top = d[r];
      state = j;
    }
  }
  warp_first_max(top, state);
  int* const arg = reinterpret_cast<int*>(dp_smem +
                                          block_smem_bytes(c.warps, K));
  if (lane == 0) {
    c.part[c.wid] = top;
    arg[c.wid] = state;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float v = c.part[0];
    int s = arg[0];
    for (int w = 1; w < c.warps; ++w)
      if (arg[w] != NO_STATE && (s == NO_STATE || c.part[w] > v)) {
        v = c.part[w];
        s = arg[w];
      }
    c.part[c.warps] = v;
    arg[c.warps] = s;
  }
  cluster_sync();  // every CTA's end state and scratch words are seen
  const bool walker = c.rank == 0 && c.wid == 0;
  if (walker) {
    top = 0.0f;
    state = NO_STATE;
    if (lane < cs) {
      top = *cluster_map(c.part + c.warps, (unsigned)lane);
      state = *cluster_map(arg + c.warps, (unsigned)lane);
    }
    warp_first_max(top, state);
  }
  cluster_sync();  // no CTA leaves while rank 0 reads its end state
  if (!walker) return;
  if (lane == 0) score[c.b] = top;

  // The backtrace by windows of frames WALK m .. WALK m + WALK-1, from the
  // top, the same state in every lane.  `cur` holds window m's words of
  // the places [cf, cl].  Each window's steps run unrolled and without a
  // branch, in places counted from cf: a load from the staged words (its
  // place clamped into the buffer), the offset out of it, a subtraction.
  // A state outside [cf, cl] on the way (a wrap below state 0, or the top
  // window's first state) is flagged, and the window is walked again by
  // checked steps that stage what they need.
  uint32_t* cur = reinterpret_cast<uint32_t*>(arg + c.warps + 1);
  const int span = walk_span(wn);
  uint32_t* nxt = cur + (WALK / OFFS_STEPS) * span;
  const int groups = (T - 1 + OFFS_STEPS - 1) / OFFS_STEPS;
  int32_t* const p = path + (size_t)c.b * T;
  int cf = 0, cl = -1;
  int mine = state;  // the state of the frame WALK m + lane
#pragma unroll 1
  for (int m = (T - 1) / WALK; m >= 0; --m) {
    const int t0 = m * WALK;
    const int top = min(T - 2 - t0, WALK - 1);  // the window's last step
    const int s = state;                        // frame t0 + top + 1's
    // JAX's indexing of a negative state: from the end once, then clamped
    // (a state never passes N-1: it only decreases)
    const int idx = s >= 0 ? s : max(s + N, 0);
    if (top >= 0 && (idx < cf || idx > cl)) {   // not staged
      cf = walk_stage(cur, words, m, idx, span, groups, N, lane);
      cl = idx;
      cp_async_wait<0>();
      __syncwarp();
    }
    // the next window's words: its states lie within 2 WALK (W-1) places
    // below this window's first one
    int nf = 0, nl = -1;
    if (m > 0) {
      nf = walk_stage(nxt, words, m - 1, idx, span, groups, N, lane);
      nl = idx;
    }
    const unsigned range = (unsigned)(cl - cf);
    int loc = s - cf;  // the state, counted from cf
    bool out = false;  // a state outside [cf, cl] on the way
#pragma unroll
    for (int i = WALK - 1; i >= 0; --i) {  // step t0 + i
      const uint32_t* row = cur + (i / OFFS_STEPS) * span;
      const unsigned at = (unsigned)loc;
      out |= i <= top && at > range;
      const uint32_t word = row[min(at, (unsigned)(span - 1))];
      const int off = (int)((word >> (4 * (i % OFFS_STEPS))) & 15u);
      if (i <= top) loc -= off;
      if (i == lane) mine = loc + cf;
    }
    state = loc + cf;
    if (out) {  // again, step by step
      state = s;
#pragma unroll 1
      for (int t = t0 + top; t >= t0; --t) {
        const int j = state >= 0 ? state : max(state + N, 0);
        if (j < cf || j > cl) {
          __syncwarp();  // every lane is done with `cur`
          cf = walk_stage(cur, words, m, j, span, groups, N, lane);
          cl = j;
          cp_async_wait<0>();
          __syncwarp();
        }
        state -= (int)((cur[(t - t0) / OFFS_STEPS * span + j - cf] >>
                        (4 * (t % OFFS_STEPS))) & 15u);
        if (t - t0 == lane) mine = state;
      }
    }
    if (t0 + lane < T) p[t0 + lane] = mine;
    cp_async_wait<0>();
    __syncwarp();  // the next window's words landed; `cur` is free
    uint32_t* const done = cur;
    cur = nxt;
    nxt = done;
    cf = nf;
    cl = nl;
  }
}

// Viterbi's backpointers of one lane at one frame, 4 bits a place (an
// offset is < W <= 7), packed into one word: a byte while a lane owns at
// most two places, else 16 bits.
template <int K> struct OffsWord { using type = uint16_t; };
template <> struct OffsWord<1> { using type = uint8_t; };
template <> struct OffsWord<2> { using type = uint8_t; };

// Bytes of one utterance's backpointers in shared memory.
__host__ __device__ inline size_t viterbi_offs_bytes(int T, int N) {
  const size_t word = (N + 31) / 32 <= 2 ? 1 : 2;
  return ((size_t)(T - 1) * 32 * word + 15) / 16 * 16;
}

// Viterbi with its backtrace, a warp per utterance: delta in K registers a
// lane as alpha is in forward_warp_kernel, log_b and the mask through the
// same FrameFeed.  A step is W adds and a first-maximum compare-select
// chain (no expf, no logf), computed at every frame and then selected.  The
// backpointers never leave the SM: a lane packs its K offsets of a frame
// into one OffsWord in shared memory ((T-1) x 32 words an utterance), and
// after a __syncwarp every lane walks the same backtrace out of shared
// memory (the loads broadcast), keeps the state of the frames t = lane mod
// 32, and the warp stores path 32 frames at a time.  Every value equals the
// block kernel's bit for bit: the arithmetic is adds and maxima.
template <int K, int W>
__global__ void __launch_bounds__(32 * WARPS)
viterbi_warp_kernel(const float* __restrict__ band,
                    const float* __restrict__ log_pi,
                    const float* __restrict__ log_b,
                    const uint8_t* __restrict__ mask,
                    float* __restrict__ score, int32_t* __restrict__ path,
                    float* __restrict__ delta_last, int B, int T, int N,
                    int end_states) {
  using Off = typename OffsWord<K>::type;
  __shared__ float rings[WARPS][RING][K][32];
  extern __shared__ __align__(16) unsigned char viterbi_offs[];
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp leaves: no block barrier follows
  Off* offs = reinterpret_cast<Off*>(
      viterbi_offs + (threadIdx.x >> 5) * viterbi_offs_bytes(T, N));
  const float* lb = log_b + (size_t)b * T * N + lane;
  FrameFeed<K, true> feed{lb + N, mask + (size_t)b * T,
                          &rings[threadIdx.x >> 5][0][0][lane], T, N, lane,
                          0, 0};
  feed.start();

  bool live[K];
  float bin[K][W];  // bin[r][k] = band[b, j-k, k], j = lane + 32 r
  float d[K];       // NEG_INF in dead lanes
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int j = lane + 32 * r;
    live[r] = j < N;
#pragma unroll
    for (int k = 0; k < W; ++k)
      bin[r][k] = (live[r] && j - k >= 0)
                      ? band[((size_t)b * N + (j - k)) * W + k] : 0.0f;
    d[r] = live[r] ? log_pi[(size_t)b * N + j] + lb[32 * r] : NEG_INF;
  }

  // Two steps an iteration: the second step's copies, mask and address
  // arithmetic fill the stalls of the first step's chain (a step took a
  // quarter less time on the card than with one step an iteration).
#pragma unroll 2
  for (int i = 0; i < T - 1; ++i) {  // frame t = 1 + i
    float b_t[K];
    const bool m_t = feed.step(i, b_t);  // the same for every lane
    float sh[K][W];
    fetch_below<K, W>(d, lane, sh);
    unsigned packed = 0;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      float best = d[r] + bin[r][0];
      unsigned bk = 0;
#pragma unroll
      for (int k = 1; k < W; ++k) {
        // below state 0 bin is 0, and the candidate exactly NEG_INF
        const float cand = below<K, W>(sh, r, k, lane) + bin[r][k];
        const bool better = cand > best;  // strict: the smallest offset wins
        best = better ? cand : best;
        bk = better ? (unsigned)k : bk;
      }
      const bool take = m_t && live[r];
      d[r] = select_f32(take, fmaxf(best + b_t[r], NEG_INF), d[r]);
      packed |= (take ? bk : 0u) << (4 * r);  // a padded frame: offset 0
    }
    offs[i * 32 + lane] = (Off)packed;
  }
  __syncwarp();  // every lane's backpointers are visible to the warp

#pragma unroll
  for (int r = 0; r < K; ++r)
    if (live[r]) delta_last[(size_t)b * N + lane + 32 * r] = d[r];

  // The first maximum over the states [lo, N): a lane's own first (its
  // places ascend with r), then across lanes the larger value, and on equal
  // values the lower state.
  const int lo = end_states > 0 ? N - end_states : 0;
  constexpr int NONE = 0x7fffffff;
  float top = 0.0f;
  int state = NONE;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int j = lane + 32 * r;
    if (j >= lo && j < N && (state == NONE || d[r] > top)) {
      top = d[r];
      state = j;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float v = __shfl_xor_sync(FULL, top, o);
    const int j = __shfl_xor_sync(FULL, state, o);
    if (j != NONE && (state == NONE || v > top || (v == top && j < state))) {
      top = v;
      state = j;
    }
  }
  if (lane == 0) score[b] = top;

  // The backtrace, the same in every lane.  JAX's dynamic indexing: a
  // negative state (a degenerate utterance whose deltas all sit at the
  // sentinel backtraces below 0) counts from the end once, then clamps.
  int32_t* p = path + (size_t)b * T;
  int mine = state;  // the state of the frame t = lane mod 32 of this round
#pragma unroll 1
  for (int t = T - 1; t >= 0; --t) {
    if (t < T - 1) {
      int idx = state < 0 ? state + N : state;
      idx = idx < 0 ? 0 : (idx > N - 1 ? N - 1 : idx);
      const unsigned word = offs[t * 32 + (idx & 31)];
      state -= (int)((word >> (4 * (idx >> 5))) & 15u);
    }
    if ((t & 31) == lane) mine = state;
    if ((t & 31) == 0 && t + lane < T) p[t + lane] = mine;
  }
}

// One instantiation per (K, W) the warp kernels take.  SMEM_ bytes of
// dynamic shared memory ride along (0 for forward and backward); where they
// and the rings together pass the 48 KB a kernel gets unasked, the
// instantiation opts in first.
#define HMM_WARP_CASE(KERNEL, K_, W_, ...)                                  \
  case (K_) * 8 + (W_):                                                     \
    if (dyn_smem > 0 && dyn_smem + ring_bytes(K_) > 48 * 1024) {            \
      const cudaError_t rc = cudaFuncSetAttribute(                          \
          KERNEL<K_, W_>, cudaFuncAttributeMaxDynamicSharedMemorySize,      \
          (int)dyn_smem);                                                   \
      if (rc != cudaSuccess) return (int)rc;                                \
    }                                                                       \
    KERNEL<K_, W_><<<blocks, 32 * WARPS, dyn_smem, stream>>>(__VA_ARGS__);  \
    break;
#define HMM_WARP_K(KERNEL, K_, ...)                                         \
  HMM_WARP_CASE(KERNEL, K_, 3, __VA_ARGS__)                                 \
  HMM_WARP_CASE(KERNEL, K_, 4, __VA_ARGS__)                                 \
  HMM_WARP_CASE(KERNEL, K_, 5, __VA_ARGS__)                                 \
  HMM_WARP_CASE(KERNEL, K_, 6, __VA_ARGS__)                                 \
  HMM_WARP_CASE(KERNEL, K_, 7, __VA_ARGS__)
#define HMM_WARP_LAUNCH(KERNEL, B_, N_, W_, SMEM_, ...)                     \
  do {                                                                      \
    const int blocks = ((B_) + WARPS - 1) / WARPS;                          \
    const size_t dyn_smem = (SMEM_);                                        \
    switch ((((N_) + 31) / 32) * 8 + (W_)) {                                \
      HMM_WARP_K(KERNEL, 1, __VA_ARGS__)                                    \
      HMM_WARP_K(KERNEL, 2, __VA_ARGS__)                                    \
      HMM_WARP_K(KERNEL, 3, __VA_ARGS__)                                    \
      HMM_WARP_K(KERNEL, 4, __VA_ARGS__)                                    \
    }                                                                       \
  } while (0)

bool takes_warp(int N, int W) {
  return N <= WARP_MAX_N && W >= WARP_MIN_W && W <= WARP_MAX_W;
}

// Shared memory a block may hold in all (the card's 227 KB), and what the
// warp Viterbi kernel asks of it: the log_b rings and four utterances'
// backpointers.  An utterance too long for that goes to the block route.
constexpr size_t SMEM_PER_BLOCK = 227 * 1024;

size_t viterbi_warp_smem(int T, int N) {
  return WARPS * viterbi_offs_bytes(T, N);
}

bool viterbi_takes_warp(int T, int N, int W) {
  return takes_warp(N, W) &&
         viterbi_warp_smem(T, N) + ring_bytes((N + 31) / 32) <= SMEM_PER_BLOCK;
}

// The most sentence states the kernels take, the limit the GPU tests hold
// all three recursions to: 227 KB over two floats a state, the
// double-buffered shared-memory carry of the kernels the block route
// replaced, kept so that no shape they took is lost.  The block route's
// registers hold up to 32,768.
constexpr int MAX_N = 29056;

bool bad_shape(int B, int T, int N, int W) {
  return B < 1 || T < 1 || N < 1 || N > MAX_N || W < 1 || W > MAX_W;
}

// ----------------------------------------------------------------------
// The block route's launch plan
// ----------------------------------------------------------------------

using ForwardBlockFn = void (*)(const float*, const float*, const float*,
                                const uint8_t*, float*, float*, int, int,
                                int, int);
using BackwardBlockFn = void (*)(const float*, const float*, const uint8_t*,
                                 float*, int, int, int, int);
using ViterbiBlockFn = void (*)(const float*, const float*, const float*,
                                const uint8_t*, uint32_t*, float*, int32_t*,
                                float*, int, int, int, int, int);

// The block route's recursions, as the plan and its C entry name them.
enum BlockDir { BACKWARD = 0, FORWARD = 1, VITERBI = 2 };

// Places a lane by index, and the instantiations: [K index][W - 2 for W in
// 3..7, else 0 (the runtime band width)].
constexpr int BLOCK_K[3] = {1, 2, 4};
#define BLOCK_ROW(KERNEL, K_)                                             \
  {KERNEL<K_, 0>, KERNEL<K_, 3>, KERNEL<K_, 4>, KERNEL<K_, 5>,            \
   KERNEL<K_, 6>, KERNEL<K_, 7>}
const ForwardBlockFn FORWARD_BLOCK[3][6] = {
    BLOCK_ROW(forward_block_kernel, 1), BLOCK_ROW(forward_block_kernel, 2),
    BLOCK_ROW(forward_block_kernel, 4)};
const BackwardBlockFn BACKWARD_BLOCK[3][6] = {
    BLOCK_ROW(backward_block_kernel, 1), BLOCK_ROW(backward_block_kernel, 2),
    BLOCK_ROW(backward_block_kernel, 4)};
const ViterbiBlockFn VITERBI_BLOCK[3][6] = {
    BLOCK_ROW(viterbi_block_kernel, 1), BLOCK_ROW(viterbi_block_kernel, 2),
    BLOCK_ROW(viterbi_block_kernel, 4)};
#undef BLOCK_ROW

int block_w_index(int W) {
  return W >= WARP_MIN_W && W <= WARP_MAX_W ? W - 2 : 0;
}

// A launch shape of the block route: cs CTAs an utterance (0: none holds
// N), `warps` warps a CTA of K = BLOCK_K[kidx] places a lane, `smem` bytes
// of dynamic shared memory; `active`, the clusters of it (CTAs where cs is
// 1) the card runs at once, and `spread`, how many of those it can hold one
// CTA an SM (a cluster's CTAs share a GPC, so large clusters fit fewer).
struct BlockShape {
  int cs, kidx, warps;
  size_t smem;
  int active, spread;
};

// The shape on cs CTAs: the least K whose BLOCK_WARPS warps hold the CTA's
// ceil(N / cs) places; Viterbi's CTAs also hold its end states and a
// backtrace window at band width W.
BlockShape block_shape(int dir, int N, int W, int cs) {
  BlockShape p{};
  const int chunk = (N + cs - 1) / cs;
  for (int i = 0; i < 3; ++i) {
    const int per_warp = 32 * BLOCK_K[i];
    if (chunk <= per_warp * BLOCK_WARPS) {
      p.cs = cs;
      p.kidx = i;
      p.warps = (chunk + per_warp - 1) / per_warp;
      p.smem = dir == VITERBI ? viterbi_smem_bytes(p.warps, BLOCK_K[i], W)
                              : block_smem_bytes(p.warps, BLOCK_K[i]);
      return p;
    }
  }
  return p;
}

cudaLaunchConfig_t block_config(int B, const BlockShape& p,
                                cudaStream_t stream,
                                cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * p.cs, 1, 1);
  cfg.blockDim = dim3(32 * p.warps, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;   // a cluster of one CTA too: the kernel's barriers
  return cfg;
}

// Opt the kernel into the shape's dynamic shared memory and cluster size.
// The attributes belong to the function, which every shape of its
// instantiation shares, and the last shape planned may have changed them:
// set them again before each launch.
template <class Fn>
cudaError_t block_opt_in(Fn kernel, const BlockShape& p) {
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (rc == cudaSuccess && p.cs > PORTABLE_CLUSTER)
    rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return rc;
}

// How many of the shape run at once, and how many one CTA an SM: the
// clusters that fit when each CTA asks for more than half an SM's shared
// memory (`sm_smem`).
template <class Fn>
cudaError_t block_active(Fn kernel, BlockShape* p, int sms, int sm_smem) {
  cudaError_t rc = block_opt_in(kernel, *p);
  if (rc != cudaSuccess) return rc;
  if (p->cs == 1) {
    int per_sm = 0;
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                       32 * p->warps,
                                                       p->smem);
    p->active = per_sm * sms;
    p->spread = sms;
    return rc;
  }
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = block_config(1, *p, nullptr, &attr);
  rc = cudaOccupancyMaxActiveClusters(&p->active, kernel, &cfg);
  BlockShape one = *p;
  one.smem = std::max(p->smem, (size_t)sm_smem / 2 + 1);
  if (rc == cudaSuccess) rc = block_opt_in(kernel, one);
  cfg.dynamicSmemBytes = one.smem;
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveClusters(&p->spread, kernel, &cfg);
  return rc;
}

// Every cluster size's shape for one (device, recursion, N, W), kept.
struct BlockShapes {
  int key[4];
  int sms, sm_smem;
  BlockShape by_size[MAX_CLUSTER];
};
std::mutex block_mutex;
std::vector<BlockShapes> block_shapes;
constexpr size_t BLOCK_SHAPES_KEPT = 64;

template <class Fn>
cudaError_t block_shapes_for(const Fn (&table)[3][6], int dir, int N,
                             int W, BlockShapes* out) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  const int key[4] = {dev, dir, N, W};
  std::lock_guard<std::mutex> lock(block_mutex);
  for (const BlockShapes& s : block_shapes)
    if (std::equal(key, key + 4, s.key)) {
      *out = s;
      return cudaSuccess;
    }
  BlockShapes s{};
  std::copy(key, key + 4, s.key);
  rc = cudaDeviceGetAttribute(&s.sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(
        &s.sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (rc != cudaSuccess) return rc;
  // no more CTAs than warps' worth of places
  const int most = std::min(MAX_CLUSTER, (N + 31) / 32);
  for (int cs = 1; cs <= most; ++cs) {
    BlockShape& p = s.by_size[cs - 1];
    p = block_shape(dir, N, W, cs);
    if (p.cs == 0) continue;
    rc = block_active(table[p.kidx][block_w_index(W)], &p, s.sms,
                      s.sm_smem);
    if (rc != cudaSuccess) return rc;
  }
  if (block_shapes.size() >= BLOCK_SHAPES_KEPT)
    block_shapes.erase(block_shapes.begin());
  block_shapes.push_back(s);
  *out = s;
  return cudaSuccess;
}

// The modelled frame of the block route, in places: a CTA's places times
// the square of the CTAs stacked on the busiest SM (one while the clusters
// in flight fit one CTA an SM, else at least two), but no less than one
// dependent step (LAT_PLACES: at B = 1 and N = 1,100, CTAs of 123 places
// or fewer all took the same time).  Stacked CTAs ran slower than their
// places alone say; the square ranks the cluster sizes as a sweep of them
// on an H100 did (PERF.md, the block route's cluster sweep).
constexpr long long LAT_PLACES = 128;

// The cluster size for B utterances of N states: the least waves x frame,
// the smaller size among equals.
BlockShape block_choose(const BlockShapes& s, int B, int N) {
  BlockShape best{};
  long long best_cost = 0;
  for (const BlockShape& p : s.by_size) {
    if (p.cs == 0 || p.active <= 0) continue;
    const long long waves = (B + p.active - 1) / p.active;
    const int in_flight = std::min(B, p.active);
    const long long resident = (long long)in_flight * p.cs;
    const long long stack =
        in_flight <= p.spread
            ? 1
            : std::max(2LL, (resident + s.sms - 1) / s.sms);
    const long long chunk = (N + p.cs - 1) / p.cs;
    const long long cost =
        waves * std::max(stack * stack * chunk, LAT_PLACES);
    if (best.cs == 0 || cost < best_cost) {
      best = p;
      best_cost = cost;
    }
  }
  return best;
}

template <class Fn>
cudaError_t block_plan(const Fn (&table)[3][6], int dir, int B, int N,
                       int W, BlockShape* out) {
  BlockShapes s;
  const cudaError_t rc = block_shapes_for(table, dir, N, W, &s);
  if (rc != cudaSuccess) return rc;
  *out = block_choose(s, B, N);
  return out->cs ? cudaSuccess : cudaErrorInvalidValue;
}

// One launch of the block route on the plan's clusters; the kernel's last
// argument is the cluster size.
template <class Fn, class... Args>
int block_launch(const Fn (&table)[3][6], int dir, int B, int N, int W,
                 cudaStream_t stream, Args... args) {
  BlockShape p{};
  cudaError_t rc = block_plan(table, dir, B, N, W, &p);
  const Fn kernel = table[p.kidx][block_w_index(W)];
  if (rc == cudaSuccess) rc = block_opt_in(kernel, p);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = block_config(B, p, stream, &attr);
  if (rc == cudaSuccess) rc = cudaLaunchKernelEx(&cfg, kernel, args..., p.cs);
  // read the thread's last error either way: a refused call leaves none
  // behind for the next launch to report
  const cudaError_t last = cudaGetLastError();
  return (int)(rc != cudaSuccess ? rc : last);
}

}  // namespace

// Plain C interface for ctypes.  Each returns cudaGetLastError() after the
// launch (0 = cudaSuccess), or cudaErrorInvalidValue for a shape it does
// not take; the launch is asynchronous on `stream`.  Each recursion
// chooses its kernel by shape: the warp kernel where it takes (N, W) (and,
// for Viterbi, T), the block route elsewhere; `block_only` != 0 sends
// every shape to the block route (for holding one against the other).
// One launch either way.
namespace {

int forward_banded(const void* band_, const void* log_pi_, const void* log_b_,
                   const void* mask_, void* alpha_, void* loglik_, int B,
                   int T, int N, int W, void* stream_, bool block_only) {
  if (bad_shape(B, T, N, W)) return (int)cudaErrorInvalidValue;
  const float* band = static_cast<const float*>(band_);
  const float* log_pi = static_cast<const float*>(log_pi_);
  const float* log_b = static_cast<const float*>(log_b_);
  const uint8_t* mask = static_cast<const uint8_t*>(mask_);
  float* alpha = static_cast<float*>(alpha_);
  float* loglik = static_cast<float*>(loglik_);
  cudaStream_t stream = (cudaStream_t)stream_;
  if (takes_warp(N, W) && !block_only)
    HMM_WARP_LAUNCH(forward_warp_kernel, B, N, W, 0, band, log_pi, log_b, mask,
                    alpha, loglik, B, T, N);
  else
    return block_launch(FORWARD_BLOCK, FORWARD, B, N, W, stream, band, log_pi,
                        log_b, mask, alpha, loglik, T, N, W);
  return (int)cudaGetLastError();
}

int backward_banded(const void* band_, const void* log_b_, const void* mask_,
                    void* beta_, int B, int T, int N, int W, void* stream_,
                    bool block_only) {
  if (bad_shape(B, T, N, W)) return (int)cudaErrorInvalidValue;
  const float* band = static_cast<const float*>(band_);
  const float* log_b = static_cast<const float*>(log_b_);
  const uint8_t* mask = static_cast<const uint8_t*>(mask_);
  float* beta = static_cast<float*>(beta_);
  cudaStream_t stream = (cudaStream_t)stream_;
  if (takes_warp(N, W) && !block_only)
    HMM_WARP_LAUNCH(backward_warp_kernel, B, N, W, 0, band, log_b, mask, beta, B,
                    T, N);
  else
    return block_launch(BACKWARD_BLOCK, BACKWARD, B, N, W, stream, band, log_b,
                        mask, beta, T, N, W);
  return (int)cudaGetLastError();
}

// `offs` is the block route's backpointer scratch in device memory,
// viterbi_block_words(T, N) words an utterance (hmm_viterbi_scratch_bytes);
// the warp kernel keeps its backpointers in shared memory and reads none.
int viterbi_banded(const void* band_, const void* log_pi_, const void* log_b_,
                   const void* mask_, void* offs_, void* score_, void* path_,
                   void* delta_last_, int B, int T, int N, int W,
                   int end_states, void* stream_, bool block_only) {
  if (bad_shape(B, T, N, W) || end_states < 0 || end_states > N)
    return (int)cudaErrorInvalidValue;
  const float* band = static_cast<const float*>(band_);
  const float* log_pi = static_cast<const float*>(log_pi_);
  const float* log_b = static_cast<const float*>(log_b_);
  const uint8_t* mask = static_cast<const uint8_t*>(mask_);
  float* score = static_cast<float*>(score_);
  int32_t* path = static_cast<int32_t*>(path_);
  float* delta_last = static_cast<float*>(delta_last_);
  cudaStream_t stream = (cudaStream_t)stream_;
  if (viterbi_takes_warp(T, N, W) && !block_only) {
    HMM_WARP_LAUNCH(viterbi_warp_kernel, B, N, W, viterbi_warp_smem(T, N),
                    band, log_pi, log_b, mask, score, path, delta_last, B, T,
                    N, end_states);
    return (int)cudaGetLastError();
  }
  if (offs_ == nullptr && T > 1) return (int)cudaErrorInvalidValue;
  return block_launch(VITERBI_BLOCK, VITERBI, B, N, W, stream, band, log_pi,
                      log_b, mask, static_cast<uint32_t*>(offs_), score, path,
                      delta_last, T, N, W, end_states);
}

}  // namespace

extern "C" int hmm_forward_banded(const void* band, const void* log_pi,
                                  const void* log_b, const void* mask,
                                  void* alpha, void* loglik, int B, int T,
                                  int N, int W, void* stream) {
  return forward_banded(band, log_pi, log_b, mask, alpha, loglik, B, T, N, W,
                        stream, false);
}

extern "C" int hmm_forward_banded_block(const void* band, const void* log_pi,
                                        const void* log_b, const void* mask,
                                        void* alpha, void* loglik, int B,
                                        int T, int N, int W, void* stream) {
  return forward_banded(band, log_pi, log_b, mask, alpha, loglik, B, T, N, W,
                        stream, true);
}

extern "C" int hmm_backward_banded(const void* band, const void* log_b,
                                   const void* mask, void* beta, int B, int T,
                                   int N, int W, void* stream) {
  return backward_banded(band, log_b, mask, beta, B, T, N, W, stream, false);
}

extern "C" int hmm_backward_banded_block(const void* band, const void* log_b,
                                         const void* mask, void* beta, int B,
                                         int T, int N, int W, void* stream) {
  return backward_banded(band, log_b, mask, beta, B, T, N, W, stream, true);
}

extern "C" int hmm_viterbi_banded(const void* band, const void* log_pi,
                                  const void* log_b, const void* mask,
                                  void* offs, void* score, void* path,
                                  void* delta_last, int B, int T, int N,
                                  int W, int end_states, void* stream) {
  return viterbi_banded(band, log_pi, log_b, mask, offs, score, path,
                        delta_last, B, T, N, W, end_states, stream, false);
}

extern "C" int hmm_viterbi_banded_block(const void* band, const void* log_pi,
                                        const void* log_b, const void* mask,
                                        void* offs, void* score, void* path,
                                        void* delta_last, int B, int T,
                                        int N, int W, int end_states,
                                        void* stream) {
  return viterbi_banded(band, log_pi, log_b, mask, offs, score, path,
                        delta_last, B, T, N, W, end_states, stream, true);
}

// The block route's launch for B utterances of N states at band width W
// (dir: 1 forward's kernels, 0 backward's, 2 Viterbi's): out = {CTAs an
// utterance, places a lane, warps a CTA, dynamic shared memory bytes, the
// clusters (CTAs where it is 1 CTA) the card runs at once, how many of
// those it holds one CTA an SM}.
extern "C" int hmm_banded_block_plan(int B, int N, int W, int dir,
                                     int* out) {
  if (bad_shape(B, 1, N, W) || dir < BACKWARD || dir > VITERBI)
    return (int)cudaErrorInvalidValue;
  BlockShape p;
  const cudaError_t rc =
      dir == VITERBI  ? block_plan(VITERBI_BLOCK, VITERBI, B, N, W, &p)
      : dir == FORWARD ? block_plan(FORWARD_BLOCK, FORWARD, B, N, W, &p)
                       : block_plan(BACKWARD_BLOCK, BACKWARD, B, N, W, &p);
  if (rc != cudaSuccess) return (int)rc;
  out[0] = p.cs;
  out[1] = BLOCK_K[p.kidx];
  out[2] = p.warps;
  out[3] = (int)p.smem;
  out[4] = p.active;
  out[5] = p.spread;
  return 0;
}

extern "C" int hmm_banded_max_w() { return MAX_W; }
extern "C" int hmm_banded_max_n() { return MAX_N; }
// 1 where forward and backward go to the warp kernels, 0 for the block ones.
extern "C" int hmm_banded_takes_warp(int N, int W) { return takes_warp(N, W); }
// The same for Viterbi, whose warp kernel also has to hold T-1 frames of
// backpointers in shared memory.
extern "C" int hmm_viterbi_takes_warp(int T, int N, int W) {
  return viterbi_takes_warp(T, N, W);
}
// Bytes of the `offs` scratch hmm_viterbi_banded (block_only != 0:
// hmm_viterbi_banded_block) needs for the shape: 0 on the warp kernel, -1
// for a shape no kernel takes.
extern "C" long long hmm_viterbi_scratch_bytes(int B, int T, int N, int W,
                                               int block_only) {
  if (bad_shape(B, T, N, W)) return -1;
  if (viterbi_takes_warp(T, N, W) && !block_only) return 0;
  return (long long)B * (long long)(viterbi_block_words(T, N) *
                                    sizeof(uint32_t));
}

extern "C" const char* hmm_banded_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
