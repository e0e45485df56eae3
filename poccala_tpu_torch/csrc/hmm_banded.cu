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
//   whose T-1 frames of them do not fit goes to the block kernel.
//
// N > 128 (up to MAX_N), another W (up to MAX_W), or a Viterbi utterance
// too long for shared memory (the block kernels):
//
// * One block per utterance, one thread per sentence state (rounded up to
//   a warp multiple).  The carry lives in shared memory, double-buffered,
//   so one __syncthreads per frame suffices.
// * A thread's W incoming (forward, Viterbi) or outgoing (backward) band
//   entries are loaded into registers once: they do not change over time.
// * Next frame's log_b and mask are loaded one step ahead.
// * Viterbi writes uint8 offsets to a [B, T-1, N] scratch and thread 0
//   walks the backtrace after the loop, inside the same launch.
//
// Both families do a step's arithmetic in the same order (terms k = 0..W-1
// ascending, the maximum first, then the sum of expf(x - max), logf(sum) +
// max, + b_t, the clamp at NEG_INF), so alpha and beta of a warp kernel
// and of a block kernel are equal bit for bit, and so are Viterbi's score,
// path and final delta (adds, maxima and the smallest offset on a tie).
// expf/logf, no fast math: the logsumexp must match the plain version.

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

__global__ void forward_block_kernel(const float* __restrict__ band,
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

__global__ void backward_block_kernel(const float* __restrict__ band,
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

// The block kernels' lse_of with an exact band width.
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

  __device__ __forceinline__ uint8_t mask_byte(int i) const {
    // the mask that step i reads: frame 1+i (forward), T-1-i (backward)
    return i < T - 1 ? mk[FORWARD ? 1 + i : T - 1 - i] : 0;
  }
  __device__ __forceinline__ void copy_ahead(int n) {  // step n -> slot n % RING
    float* dst = ring + (n & (RING - 1)) * (K * 32);
#pragma unroll
    for (int r = 0; r < K; ++r)
      if (n < T - 1 && lane + 32 * r < N)
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
// backpointers.  An utterance too long for that goes to the block kernel.
constexpr size_t SMEM_PER_BLOCK = 227 * 1024;

size_t viterbi_warp_smem(int T, int N) {
  return WARPS * viterbi_offs_bytes(T, N);
}

bool viterbi_takes_warp(int T, int N, int W) {
  return takes_warp(N, W) &&
         viterbi_warp_smem(T, N) + ring_bytes((N + 31) / 32) <= SMEM_PER_BLOCK;
}

__global__ void viterbi_block_kernel(const float* __restrict__ band,
                                     const float* __restrict__ log_pi,
                                     const float* __restrict__ log_b,
                                     const uint8_t* __restrict__ mask,
                                     uint8_t* __restrict__ offs,
                                     float* __restrict__ score,
                                     int32_t* __restrict__ path,
                                     float* __restrict__ delta_last, int T,
                                     int N, int W, int end_states) {
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
// not take; the launch is asynchronous on `stream`.  Each recursion
// chooses its kernel by shape: the warp kernel where it takes (N, W) (and,
// for Viterbi, T), the block kernel elsewhere; `block_only` != 0 sends
// every shape to the block kernel (for holding one against the other).
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
    forward_block_kernel<<<B, threads_for(N), 2 * N * sizeof(float),
                           stream>>>(band, log_pi, log_b, mask, alpha,
                                     loglik, T, N, W);
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
    backward_block_kernel<<<B, threads_for(N), 2 * N * sizeof(float),
                            stream>>>(band, log_b, mask, beta, T, N, W);
  return (int)cudaGetLastError();
}

// `offs` is the block kernel's [B, T-1, N] uint8 scratch in device memory;
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
  } else {
    if (offs_ == nullptr && T > 1) return (int)cudaErrorInvalidValue;
    viterbi_block_kernel<<<B, threads_for(N), 2 * N * sizeof(float),
                           stream>>>(band, log_pi, log_b, mask,
                                     static_cast<uint8_t*>(offs_), score,
                                     path, delta_last, T, N, W, end_states);
  }
  return (int)cudaGetLastError();
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

extern "C" int hmm_banded_max_w() { return MAX_W; }
extern "C" int hmm_banded_max_n() { return MAX_N; }
// 1 where forward and backward go to the warp kernels, 0 for the block ones.
extern "C" int hmm_banded_takes_warp(int N, int W) { return takes_warp(N, W); }
// The same for Viterbi, whose warp kernel also has to hold T-1 frames of
// backpointers in shared memory.
extern "C" int hmm_viterbi_takes_warp(int T, int N, int W) {
  return viterbi_takes_warp(T, N, W);
}

extern "C" const char* hmm_banded_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
