// attn_online: exact softmax attention [B*H, N, D] -> [B*H, N, D] with a
// k-blocked online softmax, for Hopper (sm_90a): bf16 in and out
// (attn_online_bf16) or float32 in and out (attn_online_f32), D in
// {32, 64, 128, 256, 512} (the wrapper pads other head sizes with zero
// columns), any N (the last key tile is masked), and the block sizes
// (BQ q rows, BK keys a tile) listed at the bottom of this file.
//
// Replaces the Pallas TPU kernel egregora_tpu/ops/attn_flash.py::
// flash_online (_kernel), which runs a (batch, q block, k block) grid with
// the k axis sequential and keeps the running max m (from -1e30), the
// normaliser l and the f32 accumulator in VMEM scratch.  A Hopper block
// cannot carry state from one grid step to the next, so each block owns a
// q tile and loops over the key tiles itself, holding that state.  The
// numerics are _kernel's: scores in f32 scaled after the product, the
// running max from -1e30, l summed over the f32 weights e, e rounded to
// v's dtype for P.V, f32 accumulator divided by l at the end.
//
// bf16 entry: attn_core.cuh's warpgroup-MMA core (wgmma products, TMA
// K/V ring, O in registers at every D; its note gives the design and the
// bound) with those numerics: 64 q rows a block (BQ = 64; at D = 512 two
// warpgroups split D over them), 64 or 128 keys a tile (32 at D = 512).
//
// f32 entry: the same loop on the SIMT cores in plain f32 FMA (no TF32:
// the float32 configs exist for their precision); S, the weights and O
// in shared memory.  Bound: 4*BH*N^2*D FLOPs at 67 TFLOP/s (f32 FMA).
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "attn_core.cuh"

namespace {

constexpr float M_INIT = -1e30f;   // flash_online's initial running max

constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

// flash_online's rounding: running max from -1e30, l over the f32 weights
struct OnlineNumerics {
  static __device__ __forceinline__ float m_init() { return M_INIT; }
  static constexpr bool SUM_ROUNDED = false;
};

template <int D, int BQ, int BK>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int n, float scale,
           cudaStream_t stream) {
  static_assert(BQ == attn_core::Config<D, BK>::BQ, "q rows a block");
  return attn_core::launch<D, BK, OnlineNumerics>(q, k, v, o, bh, n, scale, stream);
}

// ---- float32 entry -------------------------------------------------------

constexpr int FTHREADS = 128;

template <int D, int BQ, int BK>
struct OnlineF32 {
  static constexpr int LDQ = D + 1;   // Q and K pitch: a lane per key row, no conflicts
  static constexpr int LDS = BK + 1;
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + align128(size_t(BQ) * LDQ * 4);
  static constexpr size_t v_off = k_off + align128(size_t(BK) * LDQ * 4);
  static constexpr size_t s_off = v_off + align128(size_t(BK) * D * 4);
  static constexpr size_t o_off = s_off + align128(size_t(BQ) * LDS * 4);
  static constexpr size_t st_off = o_off + align128(size_t(BQ) * D * 4);
  static constexpr size_t bytes = st_off + align128(size_t(3) * BQ * 4);
};

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(FTHREADS)
attn_online_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o, int n,
                       float scale) {
  using L = OnlineF32<D, BQ, BK>;
  constexpr int RG = FTHREADS / BK;   // row groups of the score product
  constexpr int RPT = BQ / RG;        // score rows a thread
  constexpr int WARPS = FTHREADS / 32;
  static_assert(BK >= 32 && BK % 32 == 0 && BQ % RG == 0 && D % 4 == 0, "tile sizes");
  static_assert(L::bytes <= 232448, "tile set exceeds 227 KB of shared memory");
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + L::q_off);
  float* ks = reinterpret_cast<float*>(smem + L::k_off);
  float* vs = reinterpret_cast<float*>(smem + L::v_off);
  float* ss = reinterpret_cast<float*>(smem + L::s_off);
  float* os = reinterpret_cast<float*>(smem + L::o_off);
  float* m_s = reinterpret_cast<float*>(smem + L::st_off);
  float* l_s = m_s + BQ;
  float* c_s = l_s + BQ;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * BQ;
  const size_t base = size_t(blockIdx.y) * size_t(n) * D;
  q += base;
  k += base;
  v += base;
  o += base;

  constexpr int CPR = D / 4;   // float4 chunks per row
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = tid; i < BQ * CPR; i += FTHREADS) {
    const int r = i / CPR, c = (i % CPR) * 4;
    float4 val = zero;
    if (q0 + r < n) val = *reinterpret_cast<const float4*>(q + size_t(q0 + r) * D + c);
    float* dst = qs + r * L::LDQ + c;
    dst[0] = val.x; dst[1] = val.y; dst[2] = val.z; dst[3] = val.w;
    *reinterpret_cast<float4*>(os + r * D + c) = zero;
  }
  for (int r = tid; r < BQ; r += FTHREADS) {
    m_s[r] = M_INIT;
    l_s[r] = 0.f;
  }

  const int col = tid % BK;   // the key of this thread's scores
  const int rg = tid / BK;

  for (int kv0 = 0; kv0 < n; kv0 += BK) {
    __syncthreads();   // the previous tile's readers are done with ks / vs / ss
    for (int i = tid; i < BK * CPR; i += FTHREADS) {
      const int rr = i / CPR, c = (i % CPR) * 4;
      float4 kval = zero, vval = zero;
      if (kv0 + rr < n) {
        kval = *reinterpret_cast<const float4*>(k + size_t(kv0 + rr) * D + c);
        vval = *reinterpret_cast<const float4*>(v + size_t(kv0 + rr) * D + c);
      }
      float* kd = ks + rr * L::LDQ + c;
      kd[0] = kval.x; kd[1] = kval.y; kd[2] = kval.z; kd[3] = kval.w;
      *reinterpret_cast<float4*>(vs + rr * D + c) = vval;
    }
    __syncthreads();

    // S: thread (rg, col) forms the scores of key col for rows rg + RG*i
    float acc[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
    const float* krow = ks + col * L::LDQ;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kd = krow[d];
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i] = fmaf(qs[(rg + RG * i) * L::LDQ + d], kd, acc[i]);
    }
    const bool valid = kv0 + col < n;
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      ss[(rg + RG * i) * L::LDS + col] = valid ? acc[i] * scale : -CUDART_INF_F;
    __syncthreads();

    // online softmax, one warp a row
    for (int r = warp; r < BQ; r += WARPS) {
      float* srow = ss + r * L::LDS;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int c = lane; c < BK; c += 32) mx = fmaxf(mx, srow[c]);
#pragma unroll
      for (int off = 16; off; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float corr = expf(m_prev - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = lane; c < BK; c += 32) {
        const float e = expf(srow[c] - m_new);
        srow[c] = e;
        sum += e;
      }
#pragma unroll
      for (int off = 16; off; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // O = O * corr + P V
    for (int i = tid; i < BQ * D; i += FTHREADS) {
      const int r = i / D, c = i % D;
      const float* prow = ss + r * L::LDS;
      float a = os[i] * c_s[r];
#pragma unroll 8
      for (int j = 0; j < BK; ++j) a = fmaf(prow[j], vs[j * D + c], a);
      os[i] = a;
    }
  }
  __syncthreads();

  for (int i = tid; i < BQ * D; i += FTHREADS) {
    const int r = i / D, c = i % D;
    if (q0 + r < n) o[size_t(q0 + r) * D + c] = os[i] / l_s[r];
  }
}

template <int D, int BQ, int BK>
int launch_f32(const void* q, const void* k, const void* v, void* o, int bh, int n,
               float scale, cudaStream_t stream) {
  const int smem = int(OnlineF32<D, BQ, BK>::bytes);
  cudaError_t err = cudaFuncSetAttribute(
      attn_online_f32_kernel<D, BQ, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((n + BQ - 1) / BQ, bh);
  attn_online_f32_kernel<D, BQ, BK><<<grid, FTHREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), n, scale);
  return int(cudaGetLastError());
}

}  // namespace

#define TILE(FN, D_, BQ_, BK_) \
  if (d == D_ && bq == BQ_ && bk == BK_) return FN<D_, BQ_, BK_>(q, k, v, o, bh, n, scale, s);
#define BF16_TILES(X)                                                  \
  X(launch, 32, 64, 64) X(launch, 32, 64, 128) X(launch, 64, 64, 64)   \
  X(launch, 64, 64, 128) X(launch, 128, 64, 64) X(launch, 128, 64, 128) \
  X(launch, 256, 64, 64) X(launch, 512, 64, 32)

// q, k, v, o: contiguous bf16 [bh, n, d] on the current device; (d, bq, bk)
// one of the tiles below (ops/attn_flash.py's BF16_TILES).  Returns the
// launch's cudaError_t (0 on success); the kernel runs on `stream` without
// synchronising.
extern "C" int attn_online_bf16(const void* q, const void* k, const void* v, void* o,
                                int bh, int n, int d, int bq, int bk, float scale,
                                void* stream) {
  if (bh <= 0 || bh > 65535 || n <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BF16_TILES(TILE)
  return int(cudaErrorInvalidValue);
}

#define LAYOUT(FN, D_, BQ_, BK_)                                          \
  static_assert(BQ_ == attn_core::Config<D_, BK_>::BQ, "q rows a block"); \
  if (d == D_ && bk == BK_) return attn_core::layout<D_, BK_>(out), 0;

// the bf16 block at tile (d, bk): out = {q rows, threads, dynamic shared
// memory bytes}; returns 0, or -1 where that tile is not built
extern "C" int attn_online_bf16_layout(int d, int bk, int* out) {
  BF16_TILES(LAYOUT)
  return -1;
}

// q, k, v, o: contiguous float32 [bh, n, d] on the current device; (d, bq,
// bk) one of the tiles below (ops/attn_flash.py's F32_TILES); as
// attn_online_bf16.
extern "C" int attn_online_f32(const void* q, const void* k, const void* v, void* o,
                               int bh, int n, int d, int bq, int bk, float scale,
                               void* stream) {
  if (bh <= 0 || bh > 65535 || n <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  TILE(launch_f32, 32, 32, 32) TILE(launch_f32, 32, 32, 64)
  TILE(launch_f32, 32, 64, 32) TILE(launch_f32, 32, 64, 64)
  TILE(launch_f32, 64, 32, 32) TILE(launch_f32, 64, 32, 64)
  TILE(launch_f32, 64, 64, 32) TILE(launch_f32, 64, 64, 64)
  TILE(launch_f32, 128, 32, 32) TILE(launch_f32, 128, 32, 64)
  TILE(launch_f32, 128, 64, 32) TILE(launch_f32, 128, 64, 64)
  TILE(launch_f32, 256, 32, 32) TILE(launch_f32, 256, 64, 32)
  TILE(launch_f32, 512, 16, 32)
  return int(cudaErrorInvalidValue);
}
