// attn_rows: exact softmax attention [B*H, N, D] -> [B*H, N, D] for Hopper
// (sm_90a): bf16 in and out (attn_rows_bf16) or float32 in and out
// (attn_rows_f32), D in {32, 64, 128, 256, 512} (the wrapper pads other
// head sizes up to 512 with zero columns).
//
// Replaces the Pallas TPU kernel egregora_tpu/ops/attn_pallas.py::flash_rows
// (_kernel), which holds a q-block's whole [block_q, N] f32 score row in
// VMEM.  A Hopper SM has at most 227 KB of shared memory, so this kernel
// streams the key axis with an online softmax instead.
//
// bf16 entry: attn_core.cuh's warpgroup-MMA core (wgmma products, TMA
// K/V ring, O in registers; its note gives the design and the bound) with
// flash_rows's rounding: scores in f32 scaled after the bf16 QK^T
// product, the running max from -inf, the weights rounded to bf16 for the
// PV product and the normaliser l summed over those rounded weights, the
// f32 accumulator divided by l and rounded to bf16 once.  64 q rows a
// block; keys a K/V tile by D: 128 up to D = 128, 64 at 256, 32 at 512
// (two warpgroups split D).  ops/attn_rows.py's BF16_TILES mirrors them.
//
// f32 entry: the same online softmax in plain f32 FMA on the SIMT cores
// (no TF32: the float32 configs exist for their precision), 32-key tiles;
// lane j of a warp forms the scores of key j for the warp's 16 rows, and
// lanes 2r, 2r+1 update half of output row r each.  Rows past N load
// zeros and are never stored; keys past N are masked to -inf.  Bound:
// 4*B*H*N^2*D FLOPs at 67 TFLOP/s (f32 FMA).
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "attn_core.cuh"

namespace {

constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

// flash_rows's rounding: running max from -inf, l over the rounded weights
struct RowsNumerics {
  static __device__ __forceinline__ float m_init() { return -CUDART_INF_F; }
  static constexpr bool SUM_ROUNDED = true;
};

template <int D, int BK>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int n, float scale,
           cudaStream_t stream) {
  return attn_core::launch<D, BK, RowsNumerics>(q, k, v, o, bh, n, scale, stream);
}

// ---- float32 entry ----------------------------------------------------

constexpr int FBN = 32;            // keys per K/V tile of the f32 entry

template <int D>
struct LayoutF32 {
  static constexpr int BM = D > 256 ? 16 : 64;   // q rows a block, 16 a warp
  static constexpr int WARPS = BM / 16;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int LDQ = D + 4;    // f32 row pitch of the Q, V and O tiles
  static constexpr int LDK = D + 1;    // K pitch: lane j reads row j, no bank conflicts
  static constexpr int LDS = FBN + 1;  // a warp's scores
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + align128(size_t(BM) * LDQ * 4);
  static constexpr size_t v_off = k_off + align128(size_t(FBN) * LDK * 4);
  static constexpr size_t s_off = v_off + align128(size_t(FBN) * LDQ * 4);
  static constexpr size_t o_off = s_off + align128(size_t(WARPS) * 16 * LDS * 4);
  static constexpr size_t bytes = o_off + align128(size_t(BM) * LDQ * 4);
};

template <int D>
__global__ void __launch_bounds__(LayoutF32<D>::THREADS)
attn_rows_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int n,
                     float scale) {
  using L = LayoutF32<D>;
  constexpr int BM = L::BM, THREADS = L::THREADS;
  static_assert(D % 32 == 0, "head dim must be a multiple of 32");
  static_assert(L::bytes <= 232448, "tile set exceeds 227 KB of shared memory");
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + L::q_off);
  float* ks = reinterpret_cast<float*>(smem + L::k_off);
  float* vs = reinterpret_cast<float*>(smem + L::v_off);
  float* os = reinterpret_cast<float*>(smem + L::o_off);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  float* sw = reinterpret_cast<float*>(smem + L::s_off) + warp * 16 * L::LDS;
  const float* qw = qs + warp * 16 * L::LDQ;

  const int q0 = blockIdx.x * BM;
  const size_t base = size_t(blockIdx.y) * size_t(n) * D;
  q += base;
  k += base;
  v += base;
  o += base;

  constexpr int CPR = D / 4;   // float4 chunks per row
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = tid; i < BM * CPR; i += THREADS) {
    const int r = i / CPR, c = (i % CPR) * 4;
    float4 val = zero;
    if (q0 + r < n) val = *reinterpret_cast<const float4*>(q + size_t(q0 + r) * D + c);
    *reinterpret_cast<float4*>(qs + r * L::LDQ + c) = val;
    *reinterpret_cast<float4*>(os + r * L::LDQ + c) = zero;
  }

  const int r = lane >> 1;
  const int half = lane & 1;
  float m_run = -CUDART_INF_F;
  float l_run = 0.f;
  float* orow = os + (warp * 16 + r) * L::LDQ + half * (D / 2);

  for (int kv0 = 0; kv0 < n; kv0 += FBN) {
    __syncthreads();   // the previous tile's readers are done with ks / vs
    for (int i = tid; i < FBN * CPR; i += THREADS) {
      const int rr = i / CPR, c = (i % CPR) * 4;
      float4 kval = zero, vval = zero;
      if (kv0 + rr < n) {
        kval = *reinterpret_cast<const float4*>(k + size_t(kv0 + rr) * D + c);
        vval = *reinterpret_cast<const float4*>(v + size_t(kv0 + rr) * D + c);
      }
      float* kd = ks + rr * L::LDK + c;
      kd[0] = kval.x; kd[1] = kval.y; kd[2] = kval.z; kd[3] = kval.w;
      *reinterpret_cast<float4*>(vs + rr * L::LDQ + c) = vval;
    }
    __syncthreads();

    // scores of key kv0 + lane for the warp's 16 rows
    float acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.f;
    const float* krow = ks + lane * L::LDK;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kd = krow[d];
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] = fmaf(qw[i * L::LDQ + d], kd, acc[i]);
    }
    const bool valid = kv0 + lane < n;
#pragma unroll
    for (int i = 0; i < 16; ++i) sw[i * L::LDS + lane] = valid ? acc[i] * scale : -CUDART_INF_F;
    __syncwarp();

    float* srow = sw + r * L::LDS + half * (FBN / 2);
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int c = 0; c < FBN / 2; ++c) mx = fmaxf(mx, srow[c]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);      // finite: every tile has a valid key
    const float alpha = expf(m_run - m_new);   // 0 on the first tile
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < FBN / 2; ++c) {
      const float p = expf(srow[c] - m_new);
      srow[c] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_run = l_run * alpha + sum;
    m_run = m_new;
    __syncwarp();

    float p[FBN];
#pragma unroll
    for (int j = 0; j < FBN; ++j) p[j] = sw[r * L::LDS + j];
    const float* vcol = vs + half * (D / 2);
    for (int c = 0; c < D / 2; ++c) {
      float a = orow[c] * alpha;
#pragma unroll
      for (int j = 0; j < FBN; ++j) a = fmaf(p[j], vcol[j * L::LDQ + c], a);
      orow[c] = a;
    }
    __syncwarp();
  }

  const int row = q0 + warp * 16 + r;
  if (row < n) {
    const float inv = 1.f / l_run;
    float* dst = o + size_t(row) * D + half * (D / 2);
    for (int c = 0; c < D / 2; ++c) dst[c] = orow[c] * inv;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int bh, int n,
               float scale, cudaStream_t stream) {
  using L = LayoutF32<D>;
  const int smem = int(L::bytes);
  cudaError_t err = cudaFuncSetAttribute(
      attn_rows_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((n + L::BM - 1) / L::BM, bh);
  attn_rows_f32_kernel<D><<<grid, L::THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), n, scale);
  return int(cudaGetLastError());
}

}  // namespace

// the bf16 tile by head size: (D, keys a K/V tile); ops/attn_rows.py's
// BF16_TILES mirrors it (the card tests hold it to attn_rows_bf16_layout)
#define BF16_TILES(X) X(32, 128) X(64, 128) X(128, 128) X(256, 64) X(512, 32)

// q, k, v, o: contiguous bf16 [bh, n, d] on the current device.  Returns
// the launch's cudaError_t (0 on success); the kernel runs on `stream`
// without synchronising.
extern "C" int attn_rows_bf16(const void* q, const void* k, const void* v, void* o,
                              int bh, int n, int d, float scale, void* stream) {
  if (bh <= 0 || bh > 65535 || n <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(D_, BK_) \
  if (d == D_) return launch<D_, BK_>(q, k, v, o, bh, n, scale, s);
  BF16_TILES(LAUNCH)
  return int(cudaErrorInvalidValue);
}

// the bf16 block at tile (d, bk): out = {q rows, threads, dynamic shared
// memory bytes}; returns 0, or -1 where that tile is not built
extern "C" int attn_rows_bf16_layout(int d, int bk, int* out) {
#define LAYOUT(D_, BK_) \
  if (d == D_ && bk == BK_) return attn_core::layout<D_, BK_>(out), 0;
  BF16_TILES(LAYOUT)
  return -1;
}

// q, k, v, o: contiguous float32 [bh, n, d] on the current device; as
// attn_rows_bf16.
extern "C" int attn_rows_f32(const void* q, const void* k, const void* v, void* o,
                             int bh, int n, int d, float scale, void* stream) {
  if (bh <= 0 || bh > 65535 || n <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch_f32<32>(q, k, v, o, bh, n, scale, s);
    case 64: return launch_f32<64>(q, k, v, o, bh, n, scale, s);
    case 128: return launch_f32<128>(q, k, v, o, bh, n, scale, s);
    case 256: return launch_f32<256>(q, k, v, o, bh, n, scale, s);
    case 512: return launch_f32<512>(q, k, v, o, bh, n, scale, s);
    default: return int(cudaErrorInvalidValue);
  }
}
