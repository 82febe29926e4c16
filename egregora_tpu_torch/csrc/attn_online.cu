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
// bf16 entry: one warp per 16 q rows; products on the tensor cores with
// mma.sync m16n8k16 (bf16 -> f32).  S = Q K^T lands in the accumulator
// registers, whose layout is that of the A operand of the next product,
// so P goes from S to P.V without a trip through shared memory.  Up to
// D = 128 the Q fragments and the O accumulator stay in registers for the
// whole key loop; at D = 256 and 512 they do not fit, and Q is read from
// shared memory and each lane keeps its own O fragments in a shared
// memory slab.  K/V tiles go through shared memory, loaded with 16-byte
// vectors and zero-filled past N.
//
// f32 entry: the same loop on the SIMT cores in plain f32 FMA (no TF32:
// the float32 configs exist for their precision); S, the weights and O
// in shared memory.
//
// Bound on the H100: 4*BH*N^2*D operations at 989 TFLOP/s (bf16 tensor
// cores; 67 TFLOP/s for f32 FMA) against q, k, v read once and o written
// once (8*BH*N*D bytes in bf16) at 3.35 TB/s: the operations bound every
// shape of the FlashSR path.  Double-buffered K/V loads (cp.async or TMA)
// and wgmma are the work of a later change.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float M_INIT = -1e30f;   // flash_online's initial running max
constexpr int VEC = 8;             // bf16 values per 16-byte load

constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two floats -> one register of two bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// c (16x8 f32) += a (16x16 bf16, row major) * b (16x8 bf16, column major).
// Fragments, with g = lane / 4 and t = lane % 4:
//   a: {(g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..)}
//   b: {(k 2t..2t+1, n g), (k 2t+8.., n g)}
//   c: {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---- bf16 entry ----------------------------------------------------------

template <int D, int BQ, int BK>
struct Online {
  static constexpr int WARPS = BQ / 16;
  static constexpr int THREADS = WARPS * 32;
  static constexpr bool O_REGS = D <= 128;   // Q and O fragments in registers
  static constexpr int LD = D + 8;           // bf16 pitch of the Q, K, V tiles
  static constexpr int LDO = D + 8;          // f32 pitch of the O slab
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + align128(size_t(BQ) * LD * 2);
  static constexpr size_t v_off = k_off + align128(size_t(BK) * LD * 2);
  static constexpr size_t o_off = v_off + align128(size_t(BK) * LD * 2);
  static constexpr size_t bytes = o_off + (O_REGS ? 0 : align128(size_t(BQ) * LDO * 4));
};

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(Online<D, BQ, BK>::THREADS)
attn_online_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ o, int n, float scale) {
  using L = Online<D, BQ, BK>;
  constexpr int THREADS = L::THREADS, LD = L::LD;
  constexpr int NJ = BK / 8;     // 8-key column tiles of S
  constexpr int NK = D / 16;     // 16-wide steps of Q K^T
  constexpr int NO = D / 8;      // 8-wide column tiles of O
  constexpr int NP = BK / 16;    // 16-key steps of P V
  static_assert(D % 16 == 0 && BQ % 16 == 0 && BK % 16 == 0, "tile sizes");
  static_assert(L::bytes <= 232448, "tile set exceeds 227 KB of shared memory");
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L::q_off);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + L::k_off);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + L::v_off);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const size_t base = size_t(blockIdx.y) * size_t(n) * D;
  q += base;
  k += base;
  v += base;
  o += base;

  constexpr int CPR = D / VEC;   // 16-byte chunks per row
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < BQ * CPR; i += THREADS) {
    const int r = i / CPR, c = (i % CPR) * VEC;
    uint4 val = zero;
    if (q0 + r < n) val = *reinterpret_cast<const uint4*>(q + size_t(q0 + r) * D + c);
    *reinterpret_cast<uint4*>(qs + r * LD + c) = val;
  }
  __syncthreads();

  const __nv_bfloat16* qw = qs + warp * 16 * LD;
  // register path: Q's A fragments and O's accumulators for the whole loop
  uint32_t qf[L::O_REGS ? NK : 1][4];
  float oacc[L::O_REGS ? NO : 1][4];
  // slab path: this lane's O fragments, row g and g + 8 of the warp's 16
  float* ow = reinterpret_cast<float*>(smem + L::o_off) + warp * 16 * L::LDO;
  if constexpr (L::O_REGS) {
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      qf[kk][0] = ld32(qw + g * LD + kk * 16 + 2 * t);
      qf[kk][1] = ld32(qw + (g + 8) * LD + kk * 16 + 2 * t);
      qf[kk][2] = ld32(qw + g * LD + kk * 16 + 8 + 2 * t);
      qf[kk][3] = ld32(qw + (g + 8) * LD + kk * 16 + 8 + 2 * t);
    }
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[j][e] = 0.f;
  } else {
    for (int j = 0; j < NO; ++j) {
      *reinterpret_cast<float2*>(ow + g * L::LDO + j * 8 + 2 * t) = make_float2(0.f, 0.f);
      *reinterpret_cast<float2*>(ow + (g + 8) * L::LDO + j * 8 + 2 * t) = make_float2(0.f, 0.f);
    }
  }

  float m0 = M_INIT, m1 = M_INIT;   // running max of rows g and g + 8
  float l0 = 0.f, l1 = 0.f;         // running normaliser

  for (int kv0 = 0; kv0 < n; kv0 += BK) {
    __syncthreads();   // the previous tile's readers are done with ks / vs
    for (int i = tid; i < BK * CPR; i += THREADS) {
      const int rr = i / CPR, c = (i % CPR) * VEC;
      uint4 kval = zero, vval = zero;
      if (kv0 + rr < n) {
        kval = *reinterpret_cast<const uint4*>(k + size_t(kv0 + rr) * D + c);
        vval = *reinterpret_cast<const uint4*>(v + size_t(kv0 + rr) * D + c);
      }
      *reinterpret_cast<uint4*>(ks + rr * LD + c) = kval;
      *reinterpret_cast<uint4*>(vs + rr * LD + c) = vval;
    }
    __syncthreads();

    // S = Q_w K^T: [16, BK] f32 in registers
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t a[4];
      if constexpr (L::O_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        a[0] = ld32(qw + g * LD + kk * 16 + 2 * t);
        a[1] = ld32(qw + (g + 8) * LD + kk * 16 + 2 * t);
        a[2] = ld32(qw + g * LD + kk * 16 + 8 + 2 * t);
        a[3] = ld32(qw + (g + 8) * LD + kk * 16 + 8 + 2 * t);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const __nv_bfloat16* krow = ks + (j * 8 + g) * LD + kk * 16 + 2 * t;
        const uint32_t b[2] = {ld32(krow), ld32(krow + 8)};
        mma16816(s[j], a, b);
      }
    }

    // online softmax over this tile: scale after the product, mask keys
    // past N, running max and normaliser as flash_online's _kernel
    const int valid = n - kv0;
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        s[j][e] = col < valid ? s[j][e] * scale : -CUDART_INF_F;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));   // finite: every tile has a key
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float corr0 = __expf(m0 - mn0);           // 0 on the first tile
    const float corr1 = __expf(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      s[j][0] = __expf(s[j][0] - mn0);
      s[j][1] = __expf(s[j][1] - mn0);
      s[j][2] = __expf(s[j][2] - mn1);
      s[j][3] = __expf(s[j][3] - mn1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    l0 = l0 * corr0 + quad_sum(sum0);
    l1 = l1 * corr1 + quad_sum(sum1);
    m0 = mn0;
    m1 = mn1;

    // P = e rounded to bf16, straight from the S registers into the A
    // operand of P V (the accumulator layout of n-tiles 2p and 2p + 1 is
    // the A layout of k-step p)
    uint32_t pf[NP][4];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      pf[p][0] = pack_bf16(s[2 * p][0], s[2 * p][1]);
      pf[p][1] = pack_bf16(s[2 * p][2], s[2 * p][3]);
      pf[p][2] = pack_bf16(s[2 * p + 1][0], s[2 * p + 1][1]);
      pf[p][3] = pack_bf16(s[2 * p + 1][2], s[2 * p + 1][3]);
    }

    // O = O * corr + P V
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      float c[4];
      float* o0 = ow + g * L::LDO + j * 8 + 2 * t;
      float* o1 = ow + (g + 8) * L::LDO + j * 8 + 2 * t;
      if constexpr (L::O_REGS) {
        c[0] = oacc[j][0] * corr0;
        c[1] = oacc[j][1] * corr0;
        c[2] = oacc[j][2] * corr1;
        c[3] = oacc[j][3] * corr1;
      } else {
        const float2 a0 = *reinterpret_cast<const float2*>(o0);
        const float2 a1 = *reinterpret_cast<const float2*>(o1);
        c[0] = a0.x * corr0;
        c[1] = a0.y * corr0;
        c[2] = a1.x * corr1;
        c[3] = a1.y * corr1;
      }
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const __nv_bfloat16* vcol = vs + (p * 16 + 2 * t) * LD + j * 8 + g;
        const uint32_t b[2] = {pack2(vcol[0], vcol[LD]), pack2(vcol[8 * LD], vcol[9 * LD])};
        mma16816(c, pf[p], b);
      }
      if constexpr (L::O_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[j][e] = c[e];
      } else {
        *reinterpret_cast<float2*>(o0) = make_float2(c[0], c[1]);
        *reinterpret_cast<float2*>(o1) = make_float2(c[2], c[3]);
      }
    }
  }

  // O / l, rounded to bf16 once
  const int row0 = q0 + warp * 16 + g;
  const int row1 = row0 + 8;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    float c[4];
    if constexpr (L::O_REGS) {
#pragma unroll
      for (int e = 0; e < 4; ++e) c[e] = oacc[j][e];
    } else {
      const float2 a0 = *reinterpret_cast<const float2*>(ow + g * L::LDO + j * 8 + 2 * t);
      const float2 a1 = *reinterpret_cast<const float2*>(ow + (g + 8) * L::LDO + j * 8 + 2 * t);
      c[0] = a0.x;
      c[1] = a0.y;
      c[2] = a1.x;
      c[3] = a1.y;
    }
    if (row0 < n)
      *reinterpret_cast<__nv_bfloat162*>(o + size_t(row0) * D + j * 8 + 2 * t) =
          __floats2bfloat162_rn(c[0] / l0, c[1] / l0);
    if (row1 < n)
      *reinterpret_cast<__nv_bfloat162*>(o + size_t(row1) * D + j * 8 + 2 * t) =
          __floats2bfloat162_rn(c[2] / l1, c[3] / l1);
  }
}

template <int D, int BQ, int BK>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int n,
           float scale, cudaStream_t stream) {
  using L = Online<D, BQ, BK>;
  const int smem = int(L::bytes);
  cudaError_t err = cudaFuncSetAttribute(
      attn_online_kernel<D, BQ, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((n + BQ - 1) / BQ, bh);
  attn_online_kernel<D, BQ, BK><<<grid, L::THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), n, scale);
  return int(cudaGetLastError());
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

// q, k, v, o: contiguous bf16 [bh, n, d] on the current device; (d, bq, bk)
// one of the tiles below (ops/attn_flash.py's BF16_TILES).  Returns the
// launch's cudaError_t (0 on success); the kernel runs on `stream` without
// synchronising.
extern "C" int attn_online_bf16(const void* q, const void* k, const void* v, void* o,
                                int bh, int n, int d, int bq, int bk, float scale,
                                void* stream) {
  if (bh <= 0 || bh > 65535 || n <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  TILE(launch, 32, 64, 32) TILE(launch, 32, 64, 64) TILE(launch, 32, 64, 128)
  TILE(launch, 32, 128, 32) TILE(launch, 32, 128, 64) TILE(launch, 32, 128, 128)
  TILE(launch, 64, 64, 32) TILE(launch, 64, 64, 64) TILE(launch, 64, 64, 128)
  TILE(launch, 64, 128, 32) TILE(launch, 64, 128, 64) TILE(launch, 64, 128, 128)
  TILE(launch, 128, 64, 32) TILE(launch, 128, 64, 64)
  TILE(launch, 128, 128, 32) TILE(launch, 128, 128, 64)
  TILE(launch, 256, 64, 32) TILE(launch, 256, 64, 64)
  TILE(launch, 512, 32, 32)
  return int(cudaErrorInvalidValue);
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
