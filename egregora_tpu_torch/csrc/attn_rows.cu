// attn_rows: exact softmax attention [B*H, N, D] -> [B*H, N, D] for Hopper
// (sm_90a): bf16 in and out (attn_rows_bf16) or float32 in and out
// (attn_rows_f32), D in {32, 64, 128, 256, 512} (the wrapper pads other
// head sizes up to 512 with zero columns).
//
// Replaces the Pallas TPU kernel egregora_tpu/ops/attn_pallas.py::flash_rows
// (_kernel), which holds a q-block's whole [block_q, N] f32 score row in
// VMEM.  A Hopper SM has at most 227 KB of shared memory, so this kernel
// streams the key axis instead: one block per (b*h, 64-row q tile), four
// warps of 16 rows each, K/V tiles in shared memory, and an online softmax
// with f32 running max and sum.  At D = 512 the 64-row tile set (Q, K, V in
// bf16 and the f32 accumulator: 320 KB) does not fit, so that head size
// runs 32 q rows (two warps) a block against 32-key tiles (169 KB); the
// f32 entry runs 16 q rows (one warp) a block there.
//
// bf16 entry: scores are scaled in f32 after the bf16 QK^T product (as
// flash_rows does), the unnormalised weights are rounded to bf16 for the
// PV product, and the accumulator is f32; the output is divided by the
// running sum and rounded to bf16 once.  Both products run on the tensor
// cores (WMMA 16x16x16 bf16 -> f32); the per-warp S, P and O tiles go
// through shared memory between them.
//
// f32 entry: the same online softmax in plain f32 FMA on the SIMT cores
// (no TF32: the float32 configs exist for their precision), 32-key tiles;
// lane j of a warp forms the scores of key j for the warp's 16 rows, and
// lanes 2r, 2r+1 update half of output row r each.
//
// Rows past N (ragged tail) load zeros and are never stored; keys past N
// are masked to -inf.
//
// Bound on the H100: 4*B*H*N^2*D FLOPs at 989 TFLOP/s (bf16 tensor
// cores; 67 TFLOP/s for f32 FMA) against 8*B*H*N*D bytes (16 in f32: q,
// k, v read once, o written once) at 3.35 TB/s.  At every shape of the
// FlashSR path (N >= 512, D >= 32) the operations bound it.  Keeping O in
// registers (mma.sync fragments) and pipelining the K/V loads (cp.async
// or TMA) is the work of a later change.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int VEC = 8;             // bf16 values per 16-byte load

constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

// BM q rows a block (one warp per 16), BN keys a K/V tile: 64 and 64 up
// to D = 256, 32 and 32 at D = 512
template <int D>
struct Tile {
  static constexpr int BM = D > 256 ? 32 : 64;
  static constexpr int BN = D > 256 ? 32 : 64;
  static constexpr int WARPS = BM / 16;
  static constexpr int THREADS = WARPS * 32;
};

template <int D>
struct Layout : Tile<D> {
  static constexpr int BM = Tile<D>::BM, BN = Tile<D>::BN, WARPS = Tile<D>::WARPS;
  static constexpr int LDQ = D + 8;    // bf16 row pitch of the Q, K, V tiles
  static constexpr int LDS = BN + 4;   // f32 row pitch of a warp's scores
  static constexpr int LDP = BN + 8;   // bf16 row pitch of a warp's weights
  static constexpr int LDO = D + 4;    // f32 row pitch of a warp's accumulator
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + align128(size_t(BM) * LDQ * 2);
  static constexpr size_t v_off = k_off + align128(size_t(BN) * LDQ * 2);
  static constexpr size_t s_off = v_off + align128(size_t(BN) * LDQ * 2);
  static constexpr size_t p_off = s_off + align128(size_t(WARPS) * 16 * LDS * 4);
  static constexpr size_t o_off = p_off + align128(size_t(WARPS) * 16 * LDP * 2);
  static constexpr size_t bytes = o_off + align128(size_t(WARPS) * 16 * LDO * 4);
};

template <int D>
__global__ void __launch_bounds__(Tile<D>::THREADS)
attn_rows_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, int n, float scale) {
  using L = Layout<D>;
  constexpr int BM = L::BM, BN = L::BN, THREADS = L::THREADS;
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  static_assert(L::bytes <= 232448, "tile set exceeds 227 KB of shared memory");
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L::q_off);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + L::k_off);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + L::v_off);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  float* sw = reinterpret_cast<float*>(smem + L::s_off) + warp * 16 * L::LDS;
  __nv_bfloat16* pw = reinterpret_cast<__nv_bfloat16*>(smem + L::p_off) + warp * 16 * L::LDP;
  float* ow = reinterpret_cast<float*>(smem + L::o_off) + warp * 16 * L::LDO;

  const int q0 = blockIdx.x * BM;
  const size_t base = size_t(blockIdx.y) * size_t(n) * D;
  q += base;
  k += base;
  v += base;
  o += base;

  constexpr int CPR = D / VEC;   // 16-byte chunks per row
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < BM * CPR; i += THREADS) {
    const int r = i / CPR, c = (i % CPR) * VEC;
    uint4 val = zero;
    if (q0 + r < n) val = *reinterpret_cast<const uint4*>(q + size_t(q0 + r) * D + c);
    *reinterpret_cast<uint4*>(qs + r * L::LDQ + c) = val;
  }
  for (int i = lane; i < 16 * D; i += 32) ow[(i / D) * L::LDO + (i % D)] = 0.f;

  // softmax state: lanes 2r and 2r+1 share row r of the warp's 16,
  // each taking half of the columns
  const int r = lane >> 1;
  const int half = lane & 1;
  float m_run = -CUDART_INF_F;
  float l_run = 0.f;

  for (int kv0 = 0; kv0 < n; kv0 += BN) {
    __syncthreads();   // the previous tile's readers are done with ks / vs
    for (int i = tid; i < BN * CPR; i += THREADS) {
      const int rr = i / CPR, c = (i % CPR) * VEC;
      uint4 kval = zero, vval = zero;
      if (kv0 + rr < n) {
        kval = *reinterpret_cast<const uint4*>(k + size_t(kv0 + rr) * D + c);
        vval = *reinterpret_cast<const uint4*>(v + size_t(kv0 + rr) * D + c);
      }
      *reinterpret_cast<uint4*>(ks + rr * L::LDQ + c) = kval;
      *reinterpret_cast<uint4*>(vs + rr * L::LDQ + c) = vval;
    }
    __syncthreads();

    // S = Q_w K^T for this warp's 16 rows: [16, BN] f32
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(a, qs + warp * 16 * L::LDQ + kk * 16, L::LDQ);
        wmma::load_matrix_sync(b, ks + j * 16 * L::LDQ + kk * 16, L::LDQ);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(sw + j * 16, acc, L::LDS, wmma::mem_row_major);
    }
    __syncwarp();

    const int valid = min(BN, n - kv0);
    float* srow = sw + r * L::LDS + half * (BN / 2);
    float mx = -CUDART_INF_F;
#pragma unroll 8
    for (int c = 0; c < BN / 2; ++c) {
      const float s = (half * (BN / 2) + c < valid) ? srow[c] * scale : -CUDART_INF_F;
      srow[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);      // finite: every tile has a valid key
    const float alpha = __expf(m_run - m_new);  // 0 on the first tile
    float sum = 0.f;
    __nv_bfloat16* prow = pw + r * L::LDP + half * (BN / 2);
#pragma unroll 8
    for (int c = 0; c < BN / 2; ++c) {
      const __nv_bfloat16 p = __float2bfloat16(__expf(srow[c] - m_new));
      prow[c] = p;
      sum += __bfloat162float(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_run = l_run * alpha + sum;
    m_run = m_new;
    float* orow = ow + r * L::LDO + half * (D / 2);
#pragma unroll 8
    for (int c = 0; c < D / 2; ++c) orow[c] *= alpha;
    __syncwarp();

    // O_w += P_w V: [16, BN] x [BN, D]
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, ow + j * 16, L::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(a, pw + kk * 16, L::LDP);
        wmma::load_matrix_sync(b, vs + kk * 16 * L::LDQ + j * 16, L::LDQ);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(ow + j * 16, acc, L::LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  const int row = q0 + warp * 16 + r;
  if (row < n) {
    const float inv = 1.f / l_run;
    const float* orow = ow + r * L::LDO + half * (D / 2);
    __nv_bfloat16* dst = o + size_t(row) * D + half * (D / 2);
#pragma unroll 4
    for (int c = 0; c < D / 2; c += 2) {
      *reinterpret_cast<__nv_bfloat162*>(dst + c) =
          __floats2bfloat162_rn(orow[c] * inv, orow[c + 1] * inv);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int n,
           float scale, cudaStream_t stream) {
  using L = Layout<D>;
  const int smem = int(L::bytes);
  cudaError_t err = cudaFuncSetAttribute(
      attn_rows_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((n + L::BM - 1) / L::BM, bh);
  attn_rows_kernel<D><<<grid, L::THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), n, scale);
  return int(cudaGetLastError());
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

// q, k, v, o: contiguous bf16 [bh, n, d] on the current device.  Returns
// the launch's cudaError_t (0 on success); the kernel runs on `stream`
// without synchronising.
extern "C" int attn_rows_bf16(const void* q, const void* k, const void* v, void* o,
                              int bh, int n, int d, float scale, void* stream) {
  if (bh <= 0 || bh > 65535 || n <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch<32>(q, k, v, o, bh, n, scale, s);
    case 64: return launch<64>(q, k, v, o, bh, n, scale, s);
    case 128: return launch<128>(q, k, v, o, bh, n, scale, s);
    case 256: return launch<256>(q, k, v, o, bh, n, scale, s);
    case 512: return launch<512>(q, k, v, o, bh, n, scale, s);
    default: return int(cudaErrorInvalidValue);
  }
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
