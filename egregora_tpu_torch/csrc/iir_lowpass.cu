// iir_lowpass: the first-order recurrence z[n] = a x[n] + p z[n-1], z[-1] = 0,
// along each row of a contiguous float32 [C, N], for Hopper (sm_90a).  With
// a = 1 - k and p = k it is the K-weighting low-pass under every loudness
// reading.
//
// Replaces the Pallas TPU kernel egregora_tpu/ops/pallas_iir.py::
// iir_lowpass_pallas (_iir_block_kernel), which scans one channel per
// pallas_call with the IIR carry in SMEM across a sequential grid of
// 32768-sample blocks, each cut into 128 lane segments whose carries
// combine through one 128x128 MXU matmul.  A Hopper grid runs its blocks
// in parallel and in no order, so nothing can carry from one block to the
// next.  Here a call is two or three launches of a plain block scan:
//
//   1. iir_scan_tiles, grid (tiles, C): a block takes a tile of 4096
//      samples (256 threads x 16 consecutive samples, staged through
//      shared memory for coalesced loads and stores).  Each thread scans
//      its 16 samples in registers from a zero state; the threads' end
//      states combine in a block-level inclusive scan (warp shuffles,
//      then one warp over the eight warp totals): combining a left state
//      with a right span of L samples is  left * p^L + right.  Each thread
//      then adds  carry * p^(i+1)  to its samples and the tile is stored.
//      The tile's end state (from a zero state at the tile's start) goes
//      to `ends`.
//   2. The tiles' end states are the same recurrence with pole p^4096 and
//      a = 1 (the state entering tile b is the scan of the ends up to
//      b-1): iir_scan_tiles again on [C, tiles], recursively while there
//      is more than one tile (one level for N <= 16.7M samples).
//   3. iir_add_carry, grid (tiles - 1, C): z[n] += p^(i+1) * state
//      entering the tile, for every tile after the first.
//
// Every power of the pole comes from a table the wrapper computes in
// float64 and passes as float32 (pw[j] = p^j, j = 0..4096, one table per
// level): a power taken by repeated float32 multiplication would drift
// over thousands of samples when p is within 1e-4 of 1.
//
// Bound on the H100: 8 bytes a sample (one float32 read, one written) at
// 3.35 TB/s; 2 FLOPs a sample are nothing.  Passes 1 and 3 each read and
// write the signal once, so the call moves about twice the bound's bytes.
// A single pass with decoupled look-back and vector loads is the work of
// a later change.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RUN = 16;                  // samples a thread scans
constexpr int TILE = THREADS * RUN;      // 4096 samples a block
constexpr int MAX_LEVELS = 4;

__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

__global__ void __launch_bounds__(THREADS)
iir_scan_tiles(const float* __restrict__ x, float* __restrict__ z,
               float* __restrict__ ends, long long n, int ntiles, float a,
               const float* __restrict__ pw) {
  __shared__ float buf[TILE + TILE / 32];   // one pad word in 32: conflict-free runs
  __shared__ float wtot[WARPS];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long t0 = (long long)blockIdx.x * TILE;
  const size_t row = size_t(blockIdx.y) * size_t(n);
  x += row;
  z += row;

  for (int i = tid; i < TILE; i += THREADS) {
    const long long g = t0 + i;
    buf[padded(i)] = g < n ? x[g] : 0.f;
  }
  __syncthreads();

  const float p = pw[1];
  float v[RUN];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < RUN; ++i) {
    s = fmaf(p, s, a * buf[padded(tid * RUN + i)]);
    v[i] = s;
  }

  // inclusive scan of the threads' end states within the warp
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
    if (lane < WARPS) wtot[lane] = wv;
  }
  __syncthreads();

  // the state just before this thread's first sample
  float carry = __shfl_up_sync(0xffffffffu, e, 1);
  if (lane == 0) carry = 0.f;
  if (warp > 0) carry = fmaf(pw[RUN * lane], wtot[warp - 1], carry);
#pragma unroll
  for (int i = 0; i < RUN; ++i) {
    v[i] = fmaf(pw[i + 1], carry, v[i]);
    buf[padded(tid * RUN + i)] = v[i];
  }
  if (ends != nullptr && tid == THREADS - 1) ends[size_t(blockIdx.y) * ntiles + blockIdx.x] = v[RUN - 1];
  __syncthreads();

  for (int i = tid; i < TILE; i += THREADS) {
    const long long g = t0 + i;
    if (g < n) z[g] = buf[padded(i)];
  }
}

// z[n] += p^(i+1) * state entering tile b, for tiles b >= 1 (blockIdx.x = b - 1);
// states[b - 1] is the state at the end of tile b - 1.
__global__ void __launch_bounds__(THREADS)
iir_add_carry(float* __restrict__ z, const float* __restrict__ states, long long n,
              int ntiles, const float* __restrict__ pw) {
  const int b = blockIdx.x + 1;
  const float c = states[size_t(blockIdx.y) * ntiles + b - 1];
  float* zr = z + size_t(blockIdx.y) * size_t(n) + (long long)b * TILE;
  const long long left = n - (long long)b * TILE;
  for (int i = threadIdx.x; i < TILE; i += THREADS) {
    if (i < left) zr[i] = fmaf(pw[i + 1], c, zr[i]);
  }
}

int tiles_of(long long n) { return int((n + TILE - 1) / TILE); }

}  // namespace

// Levels of the scan for N samples: 1 + the levels the tiles' states need.
extern "C" int iir_lowpass_levels(long long n) {
  int levels = 1;
  for (long long len = n; tiles_of(len) > 1; len = tiles_of(len)) ++levels;
  return levels;
}

// Floats of workspace for [c, n]: each level above the first keeps its
// input (the ends) and its output (the states), c * tiles each.
extern "C" long long iir_lowpass_workspace_floats(int c, long long n) {
  long long total = 0;
  for (long long len = n; tiles_of(len) > 1; len = tiles_of(len)) {
    total += 2LL * c * tiles_of(len);
  }
  return total;
}

// x, z: contiguous float32 [c, n] on the current device (z may not alias
// x); work: iir_lowpass_workspace_floats(c, n) floats; tables: float32
// [iir_lowpass_levels(n)][4097], table l holding (p^(4096^l))^j.  Runs on
// `stream` without synchronising; returns the first failing launch's
// cudaError_t (0 on success).
extern "C" int iir_lowpass_f32(const void* x, void* z, void* work, const void* tables,
                               int c, long long n, float a, void* stream) {
  if (c <= 0 || c > 65535 || n <= 0) return int(cudaErrorInvalidValue);
  if (iir_lowpass_levels(n) > MAX_LEVELS) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  struct Level {
    float* out;
    float* states;
    long long len;
    int nt;
    const float* pw;
  } lv[MAX_LEVELS];
  const float* in = static_cast<const float*>(x);
  float* out = static_cast<float*>(z);
  float* w = static_cast<float*>(work);
  const float* pw = static_cast<const float*>(tables);
  long long len = n;
  float coef = a;
  int depth = 0;
  for (;;) {
    const int nt = tiles_of(len);
    float* ends = nullptr;
    if (nt > 1) {
      ends = w;
      w += size_t(c) * nt;
    }
    iir_scan_tiles<<<dim3(nt, c), THREADS, 0, s>>>(in, out, ends, len, nt, coef, pw);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
    lv[depth] = {out, w, len, nt, pw};
    if (nt == 1) break;
    in = ends;           // the next level scans the tiles' end states ...
    out = w;             // ... into the states entering each tile
    w += size_t(c) * nt;
    len = nt;
    coef = 1.f;
    pw += TILE + 1;
    ++depth;
  }
  for (int d = depth - 1; d >= 0; --d) {
    iir_add_carry<<<dim3(lv[d].nt - 1, c), THREADS, 0, s>>>(lv[d].out, lv[d].states,
                                                             lv[d].len, lv[d].nt, lv[d].pw);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  return 0;
}
