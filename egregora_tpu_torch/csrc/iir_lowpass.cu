// iir_lowpass: the first-order recurrence z[n] = a x[n] + p z[n-1], z[-1] = 0,
// along each row of a contiguous float32 [C, N], for Hopper (sm_90a).  With
// a = 1 - k and p = k it is the K-weighting low-pass under every loudness
// reading.
//
// Replaces the Pallas TPU kernel egregora_tpu/ops/pallas_iir.py::
// iir_lowpass_pallas (_iir_block_kernel), which scans one channel per
// pallas_call with the IIR carry in SMEM across a sequential grid of
// 32768-sample blocks.  A Hopper grid runs its blocks in parallel and in
// no order, so here the carry passes from tile to tile through published
// prefixes instead: one launch a call, a chained scan with decoupled
// look-back (Merrill and Garland, "Single-pass Parallel Prefix Scan with
// Decoupled Look-back", NVIDIA 2016).
//
// 1. Tiles in order.  A block takes its tile, over (channel, tile) in
//    channel-major order, from an atomic counter in the call's workspace,
//    not from blockIdx: every predecessor of a tile has then started, so
//    the chain cannot deadlock however the card schedules blocks.  (Where
//    every row is one tile nothing passes between blocks: blockIdx then,
//    and no workspace.)
// 2. The local scan.  The block loads its 8192 samples with coalesced
//    16-byte streaming loads into shared memory (XOR-swizzled 16-byte
//    slots, so that the copy and each thread's run of 32 are
//    conflict-free), each thread scans its run in registers from a zero
//    state, and the runs' end states combine in a block scan (warp shuffles, then one warp over the
//    eight warp totals): a left state before a right span of L samples
//    gives  left * p^L + right.  The tile's end state from a zero state,
//    its aggregate, is published at once as one 64-bit word: the f32 value
//    and a status (aggregate or inclusive).
// 3. The look-back.  One warp reads the status words of the 32 nearest
//    predecessors in the row, one a lane, until none is unpublished; it
//    sums the aggregates up to the nearest inclusive prefix, each scaled by
//    (p^8192)^j, and walks further back while the window held none.  A
//    spin past 2^22 polls (seconds, where a sound wait takes microseconds)
//    traps, so a broken chain fails its launch instead of hanging the card.
//    The tile publishes its own inclusive prefix, adds  carry * p^(i+1)  to
//    its samples while they are in registers, and stores them once.
//
// Every power of the pole comes from a table the wrapper computes in
// float64 and passes as float32: p^j for j = 0..8192, then (p^8192)^j for
// j = 0..32.  A power taken by repeated float32 multiplication would drift
// over thousands of samples when p is within 1e-4 of 1.
//
// Bound on the H100: 8 bytes a sample (one float32 read, one written) at
// 3.35 TB/s; 2 FLOPs a sample are nothing.  The call reads and writes the
// signal once (plus an 8-byte status word a tile, zeroed by one memset).
// Tiles of 8192 samples (runs of 32) and streaming cache hints measured
// faster at the meter's 2 x 14.4M samples than 2048 or 4096 and plain
// loads (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RUN = 32;                  // samples a thread scans
constexpr int TILE = THREADS * RUN;      // 8192 samples a block
constexpr int WINDOW = 32;               // predecessors a look-back step reads
constexpr unsigned long long AGGREGATE = 1ull << 32;
constexpr unsigned long long INCLUSIVE = 2ull << 32;
constexpr unsigned POLL_LIMIT = 1u << 22;

__device__ __forceinline__ unsigned long long load_word(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_word(unsigned long long* p, unsigned long long status,
                                           float v) {
  const unsigned long long w = status | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;\n" :: "l"(p), "l"(w) : "memory");
}

// the shared-memory slot of the tile's 16-byte slot q
__device__ __forceinline__ int slot(int q) { return q ^ ((q >> 3) & 7); }

// status: the call's workspace, zeroed: [0] the tile counter, then one
// word a (channel, tile); null where every row is one tile.  pw: p^j
// (j = 0..TILE), then (p^TILE)^j (j = 0..WINDOW).  vec: rows start
// 16-byte aligned (n % 4 == 0 and x, z aligned).
__global__ void __launch_bounds__(THREADS)
iir_lookback(const float* __restrict__ x, float* __restrict__ z,
             unsigned long long* __restrict__ status, long long n, int ntiles, float a,
             const float* __restrict__ pw, int vec) {
  __shared__ float4 buf[TILE / 4];
  __shared__ float wtot[WARPS];
  __shared__ int s_tile;
  __shared__ float s_carry;
  const float* pt = pw + TILE + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid == 0)
    s_tile = status ? int(atomicAdd(reinterpret_cast<unsigned*>(status), 1u)) : blockIdx.x;
  __syncthreads();
  const int tile = s_tile;
  const int row = tile / ntiles, t = tile - row * ntiles;
  unsigned long long* words = status + 1;
  const long long t0 = (long long)t * TILE;
  const long long left = n - t0;         // samples of the tile in the signal
  const size_t at = size_t(row) * size_t(n) + size_t(t0);
  const bool full = vec && left >= TILE;

  if (full) {
    const float4* src = reinterpret_cast<const float4*>(x + at);
#pragma unroll
    for (int q = tid; q < TILE / 4; q += THREADS) buf[slot(q)] = __ldcs(src + q);
  } else {
    for (int q = tid; q < TILE / 4; q += THREADS) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = 4 * q + e < left ? x[at + 4 * q + e] : 0.f;
      buf[slot(q)] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  __syncthreads();

  // the thread's run from a zero state
  const float p = pw[1];
  float v[RUN];
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < RUN / 4; ++u) {
    const float4 q = buf[slot(tid * (RUN / 4) + u)];
    s = fmaf(p, s, a * q.x); v[4 * u] = s;
    s = fmaf(p, s, a * q.y); v[4 * u + 1] = s;
    s = fmaf(p, s, a * q.z); v[4 * u + 2] = s;
    s = fmaf(p, s, a * q.w); v[4 * u + 3] = s;
  }

  // inclusive scan of the runs' end states within the warp, then over the warps
  float e = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, e, o);
    if (lane >= o) e = fmaf(pw[RUN * o], up, e);
  }
  if (lane == 31) wtot[warp] = e;
  __syncthreads();
  if (warp == 0) {
    float wv = lane < WARPS ? wtot[lane] : 0.f;
#pragma unroll
    for (int o = 1; o < WARPS; o <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, wv, o);
      if (lane >= o) wv = fmaf(pw[RUN * 32 * o], up, wv);
    }
    // wv of lane WARPS - 1: the tile's aggregate
    const float agg = __shfl_sync(0xffffffffu, wv, WARPS - 1);
    if (lane < WARPS) wtot[lane] = wv;

    // the state entering the tile: the end state of tile t - 1
    float carry = 0.f;
    if (t == 0) {
      if (lane == 0 && status) store_word(words + tile, INCLUSIVE, agg);
    } else {
      if (lane == 0) store_word(words + tile, AGGREGATE, agg);
      float scale = 1.f;                  // (p^TILE)^(predecessors passed)
      for (int j0 = 0;; j0 += WINDOW) {
        const int j = j0 + lane;          // this lane reads tile t - 1 - j of the row
        unsigned long long w = INCLUSIVE;  // before the row's start: state 0
        for (unsigned polls = 0;; ++polls) {
          if (j < t) w = load_word(words + tile - 1 - j);
          if (__all_sync(0xffffffffu, (w >> 32) != 0)) break;
          if (polls == POLL_LIMIT) __trap();
        }
        const unsigned incl = __ballot_sync(0xffffffffu, (w >> 32) == 2);
        const int first = incl ? __ffs(incl) - 1 : WINDOW;   // the nearest inclusive prefix
        float term = lane <= first ? __uint_as_float(unsigned(w)) * pt[lane] : 0.f;
#pragma unroll
        for (int o = 16; o; o >>= 1) term += __shfl_xor_sync(0xffffffffu, term, o);
        carry = fmaf(scale, term, carry);
        if (incl) break;
        scale *= pt[WINDOW];
      }
      if (lane == 0) store_word(words + tile, INCLUSIVE, fmaf(pt[1], carry, agg));
    }
    if (lane == 0) s_carry = carry;
  }
  __syncthreads();

  // the state just before this thread's first sample, then the run
  float before = __shfl_up_sync(0xffffffffu, e, 1);
  if (lane == 0) before = 0.f;
  if (warp > 0) before = fmaf(pw[RUN * lane], wtot[warp - 1], before);
  before = fmaf(pw[RUN * tid], s_carry, before);
#pragma unroll
  for (int u = 0; u < RUN / 4; ++u)
    buf[slot(tid * (RUN / 4) + u)] = make_float4(
        fmaf(pw[4 * u + 1], before, v[4 * u]), fmaf(pw[4 * u + 2], before, v[4 * u + 1]),
        fmaf(pw[4 * u + 3], before, v[4 * u + 2]), fmaf(pw[4 * u + 4], before, v[4 * u + 3]));
  __syncthreads();

  if (full) {
    float4* dst = reinterpret_cast<float4*>(z + at);
#pragma unroll
    for (int q = tid; q < TILE / 4; q += THREADS) __stcs(dst + q, buf[slot(q)]);
  } else {
    for (int q = tid; q < TILE / 4; q += THREADS) {
      const float4 r = buf[slot(q)];
      const float vals[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int e2 = 0; e2 < 4; ++e2)
        if (4 * q + e2 < left) z[at + 4 * q + e2] = vals[e2];
    }
  }
}

long long tiles_of(long long n) { return (n + TILE - 1) / TILE; }

}  // namespace

// Bytes of workspace for [c, n]: the tile counter and one status word a
// (channel, tile), 8 bytes each; none where every row is one tile.
extern "C" long long iir_lowpass_workspace_bytes(int c, long long n) {
  return tiles_of(n) > 1 ? 8LL * (1 + c * tiles_of(n)) : 0;
}

// The block the library launches: samples a tile, threads, predecessors a
// look-back step reads.
extern "C" void iir_lowpass_layout(int* out) {
  out[0] = TILE;
  out[1] = THREADS;
  out[2] = WINDOW;
}

// x, z: contiguous float32 [c, n] on the current device (z may not alias
// x); work: iir_lowpass_workspace_bytes(c, n) bytes, 8-byte aligned, zeroed
// here (unused where that is 0); tables: float32 [8193 + 33], p^j for j =
// 0..8192, then (p^8192)^j for j = 0..32.  One memset (none where every
// row is one tile) and one launch on `stream`, without synchronising;
// returns the first failing call's cudaError_t (0 on success).
extern "C" int iir_lowpass_f32(const void* x, void* z, void* work, const void* tables,
                               int c, long long n, float a, void* stream) {
  if (c <= 0 || n <= 0) return int(cudaErrorInvalidValue);
  const long long ntiles = tiles_of(n);
  if (c * ntiles > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long work_bytes = iir_lowpass_workspace_bytes(c, n);
  if (work_bytes) {
    const cudaError_t err = cudaMemsetAsync(work, 0, size_t(work_bytes), s);
    if (err != cudaSuccess) return int(err);
  }
  const int vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(z) % 16 == 0;
  iir_lookback<<<unsigned(c * ntiles), THREADS, 0, s>>>(
      static_cast<const float*>(x), static_cast<float*>(z),
      work_bytes ? static_cast<unsigned long long*>(work) : nullptr, n, int(ntiles), a,
      static_cast<const float*>(tables), vec);
  return int(cudaGetLastError());
}
