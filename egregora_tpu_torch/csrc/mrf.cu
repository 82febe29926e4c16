// mrf: the fused HiFi-GAN multi-receptive-field (MRF) block for Hopper
// (sm_90a): bf16 in and out on the tensor cores, or float32 in and out in
// SIMT FMA (the *_f32 entries, at the end of this file).
//
// Replaces two Pallas TPU kernels of egregora_tpu:
//   ops/mrf_pallas.py::mrf_fused_cm (_mrf_kernel): [B, C, T], every branch
//     and their mean in one launch; each conv rounds its f32 sum to bf16
//     and then adds the bf16 bias (_conv_circ)  -> mrf_fused_cm_bf16
//   ops/mrf_rows.py::mrf_branch_rows (_branch_kernel): [B, T, C], one
//     branch a launch; each conv adds the f32 bias to its f32 sum and
//     rounds once (_conv_rows)                    -> mrf_branch_rows_bf16
//
// One branch (ResBlock1D) of kernel size k is, for each dilation d:
//   h = h + conv_k,1(leaky(conv_k,d(leaky(h)))),  leaky(x) = max(x, 0.1 x),
// with flax's 'SAME' zero padding at every conv.  A block owns one
// (batch item, time tile of TT samples): it loads the tile with a halo of
// H = sum_d ((k-1)/2)(d+1) samples a side (60 for k = 11, d = 1, 3, 5)
// into shared memory as rows [time][channel] and runs the whole chain
// there; the input is read once and the output written once.  Every conv
// output is re-zeroed outside the signal [0, T), which is what makes the
// tile equal to per-layer zero padding; rows past T and before 0 load
// zeros, so any T runs without padding copies.  Each conv computes only
// the rows the rest of the chain still needs (the window shrinks by the
// conv's reach), rounded up to 16-row tiles; rows outside it hold stale
// finite values that never reach a needed row.
//
// Each conv is k shifted [16 rows x C] x [C x C] products per 16-row
// tile: mma.sync m16n8k16 bf16 -> f32 on the tensor cores, A fragments
// read from the shared tile (row pitch C + 8: conflict-free 32-bit
// loads), B fragments from the packed weights in device memory
// ([k][C_out][C_in] per conv, through L1), accumulators in registers for
// 64 output channels at a time; the epilogue rounds, adds the bias,
// masks, applies leaky or the residual add in registers and writes bf16
// back to shared memory.
//
// Bound on the H100: 12 k C^2 T B FLOPs per branch (252 C^2 T B for the
// three branches k = 3, 7, 11) at 989 TFLOP/s against 4 B C T bytes (one
// bf16 read and write) at 3.35 TB/s: 63 C FLOP/byte for a whole block,
// so the operations bound it at every C >= 16 of the vocoder.  The time
// tile is chosen by C so that two blocks fit an SM (about 110 KB each:
// cur and scratch tiles of TT + 2H + 16 rows, plus the branch sum of TT
// rows when the launch runs several branches); a C too wide for a
// 64-sample tile in that budget takes one block of up to 220 KB.  Staging
// the weights in shared memory, a pipelined load of the next tile and
// wgmma are the work of a later change.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_BRANCHES = 4;
constexpr int MAX_DILS = 4;
constexpr int NF = 8;                 // n8 fragments per accumulator pass (64 channels)
constexpr int SMALL_BUDGET = 110 * 1024;
constexpr int LARGE_BUDGET = 220 * 1024;
constexpr int MAX_TT = 2048;

struct Spec {
  int nb;                        // branches
  int nd;                        // dilation iterations per branch
  int k[MAX_BRANCHES];
  int d[MAX_DILS];
  long long w_off[MAX_BRANCHES]; // element offset of a branch's weights
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ldg32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ float leaky(float v) { return v > 0.f ? v : v * 0.1f; }

__device__ __forceinline__ uint32_t pack2(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 unpack2(uint32_t u) {
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}

__device__ __forceinline__ uint32_t leaky2(uint32_t u) {
  const float2 f = __bfloat1622float2(unpack2(u));
  return pack2(__floats2bfloat162_rn(leaky(f.x), leaky(f.y)));
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One conv of the chain over rows [lo, lo + 16 * ceil(count / 16)) of the
// tile: dst[r] = epilogue(sum_j W_j src[r + j*d - s]), s = (k-1)/2 * d.
// LEAKY_IN applies leaky to the input as it is read (the dilated conv
// reads the residual stream h); RESID adds the result into dst in place
// (the unit conv), otherwise dst gets leaky of the result (the input of
// the unit conv).  CIRC selects _conv_circ's rounding, else _conv_rows's.
template <bool CIRC, bool LEAKY_IN, bool RESID>
__device__ void conv_tile(const __nv_bfloat16* __restrict__ src, __nv_bfloat16* dst,
                          const __nv_bfloat16* __restrict__ w,
                          const float* __restrict__ bias, int c, int lds, int k,
                          int d, int lo, int count, int g0, int t) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;        // fragment row (and n column of B)
  const int tq = lane & 3;        // fragment column pair
  const int s = ((k - 1) / 2) * d;
  const int ntiles = (count + 15) / 16;
  const int nkk = c / 16;
  for (int tile = warp; tile < ntiles; tile += WARPS) {
    const int r0 = lo + tile * 16;
    for (int n0 = 0; n0 < c; n0 += NF * 8) {
      const int nf = min(NF, (c - n0) / 8);
      float acc[NF][4];
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        float b0 = 0.f, b1 = 0.f;
        if (!CIRC && f < nf) {        // _conv_rows: the f32 sum starts at the bias
          b0 = bias[n0 + f * 8 + tq * 2];
          b1 = bias[n0 + f * 8 + tq * 2 + 1];
        }
        acc[f][0] = b0; acc[f][1] = b1; acc[f][2] = b0; acc[f][3] = b1;
      }
      for (int j = 0; j < k; ++j) {
        const __nv_bfloat16* arow = src + (r0 + j * d - s + g) * lds + tq * 2;
        const __nv_bfloat16* wj = w + size_t(j) * c * c + size_t(n0 + g) * c + tq * 2;
        for (int kk = 0; kk < nkk; ++kk) {
          uint32_t a[4];
          const __nv_bfloat16* p = arow + kk * 16;
          a[0] = ld32(p);
          a[1] = ld32(p + 8 * lds);
          a[2] = ld32(p + 8);
          a[3] = ld32(p + 8 * lds + 8);
          if (LEAKY_IN) {
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = leaky2(a[i]);
          }
#pragma unroll
          for (int f = 0; f < NF; ++f) {
            if (f < nf) {
              const __nv_bfloat16* q = wj + size_t(f) * 8 * c + kk * 16;
              mma16816(acc[f], a, ldg32(q), ldg32(q + 8));
            }
          }
        }
      }
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        if (f >= nf) continue;
        const int col = n0 + f * 8 + tq * 2;
        float bb0 = 0.f, bb1 = 0.f;
        if (CIRC) {
          bb0 = __bfloat162float(__float2bfloat16(bias[col]));
          bb1 = __bfloat162float(__float2bfloat16(bias[col + 1]));
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = r0 + g + half * 8;
          float v0 = acc[f][half * 2], v1 = acc[f][half * 2 + 1];
          if (CIRC) {     // round the conv, then add the bf16 bias (rounded)
            v0 = __bfloat162float(__float2bfloat16(v0)) + bb0;
            v1 = __bfloat162float(__float2bfloat16(v1)) + bb1;
          }
          const int gi = g0 + row;
          const bool inside = gi >= 0 && gi < t;
          __nv_bfloat162 out = __floats2bfloat162_rn(v0, v1);
          __nv_bfloat16* dp = dst + row * lds + col;
          if (RESID) {
            const float2 y = __bfloat1622float2(out);
            const float2 h = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(dp));
            out = __floats2bfloat162_rn(h.x + y.x, h.y + y.y);
          } else {
            const float2 y = __bfloat1622float2(out);
            out = __floats2bfloat162_rn(leaky(y.x), leaky(y.y));
          }
          if (!inside) out = __floats2bfloat162_rn(0.f, 0.f);
          *reinterpret_cast<__nv_bfloat162*>(dp) = out;
        }
      }
    }
  }
}

// CM: x, y are [B, C, T] and the convs round as _conv_circ; otherwise
// [B, T, C] and _conv_rows.  Grid (ceil(T / TT), B).
template <bool CM>
__global__ void __launch_bounds__(THREADS)
mrf_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ y,
           const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias,
           int c, int t, int tt, int halo, Spec sp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lds = c + 8;
  const int l = tt + 2 * halo;
  const int rows = l + 16;
  __nv_bfloat16* cur = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* tmp = cur + rows * lds;
  __nv_bfloat16* sum = tmp + rows * lds;       // used when sp.nb > 1
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * tt;
  const int g0 = t0 - halo;                    // signal index of tile row 0
  const size_t base = size_t(blockIdx.y) * c * t;
  x += base;
  y += base;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  for (int i = tid; i < rows * lds; i += THREADS) tmp[i] = zero;

  for (int bi = 0; bi < sp.nb; ++bi) {
    if (CM) {
      for (int i = tid; i < c * rows; i += THREADS) {
        const int ch = i / rows, r = i % rows, gi = g0 + r;
        cur[r * lds + ch] = (r < l && gi >= 0 && gi < t) ? x[size_t(ch) * t + gi] : zero;
      }
    } else {
      const int half_c = c / 2;
      for (int i = tid; i < rows * half_c; i += THREADS) {
        const int r = i / half_c, cp = (i % half_c) * 2, gi = g0 + r;
        uint32_t v = 0u;
        if (r < l && gi >= 0 && gi < t) v = ld32(x + size_t(gi) * c + cp);
        *reinterpret_cast<uint32_t*>(cur + r * lds + cp) = v;
      }
    }
    __syncthreads();

    const int k = sp.k[bi];
    const int hw = (k - 1) / 2;
    int reach = 0;                              // receptive reach still ahead
    for (int m = 0; m < sp.nd; ++m) reach += hw * (sp.d[m] + 1);
    const __nv_bfloat16* wb = w + sp.w_off[bi];
    const float* bb = bias + size_t(bi) * sp.nd * 2 * c;
    const size_t conv_w = size_t(k) * c * c;
    for (int m = 0; m < sp.nd; ++m) {
      const int d = sp.d[m];
      reach -= hw * d;
      conv_tile<CM, true, false>(cur, tmp, wb + (2 * m) * conv_w, bb + (2 * m) * c, c,
                                 lds, k, d, halo - reach, tt + 2 * reach, g0, t);
      __syncthreads();
      reach -= hw;
      conv_tile<CM, false, true>(tmp, cur, wb + (2 * m + 1) * conv_w, bb + (2 * m + 1) * c,
                                 c, lds, k, 1, halo - reach, tt + 2 * reach, g0, t);
      __syncthreads();
    }
    if (sp.nb > 1) {                            // branch sum, rounded as the JAX sum
      const int half_c = c / 2;
      for (int i = tid; i < tt * half_c; i += THREADS) {
        const int r = i / half_c, cp = (i % half_c) * 2;
        __nv_bfloat162* a = reinterpret_cast<__nv_bfloat162*>(sum + r * lds + cp);
        const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
            cur + (halo + r) * lds + cp);
        if (bi == 0) {
          *a = v;
        } else {
          const float2 p = __bfloat1622float2(*a), q = __bfloat1622float2(v);
          *a = __floats2bfloat162_rn(p.x + q.x, p.y + q.y);
        }
      }
      __syncthreads();
    }
  }

  // the branch mean (or the one branch), rows [0, TT) of the tile
  const float nbf = float(sp.nb);
  const __nv_bfloat16* src = sp.nb > 1 ? sum : cur + halo * lds;
  if (CM) {
    for (int i = tid; i < c * tt; i += THREADS) {
      const int ch = i / tt, r = i % tt;
      if (t0 + r >= t) continue;
      float v = __bfloat162float(src[r * lds + ch]);
      if (sp.nb > 1) v = v / nbf;
      y[size_t(ch) * t + t0 + r] = __float2bfloat16(v);
    }
  } else {
    const int half_c = c / 2;
    for (int i = tid; i < tt * half_c; i += THREADS) {
      const int r = i / half_c, cp = (i % half_c) * 2;
      if (t0 + r >= t) continue;
      float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src + r * lds + cp));
      if (sp.nb > 1) {
        v.x = v.x / nbf;
        v.y = v.y / nbf;
      }
      *reinterpret_cast<__nv_bfloat162*>(y + size_t(t0 + r) * c + cp) =
          __floats2bfloat162_rn(v.x, v.y);
    }
  }
}

// Time tile for C channels and the halo: the largest multiple of 16 (at
// most MAX_TT, and no longer than T needs) whose tiles fit the budget.
int pick_tile(int c, int t, int halo, int nb, int budget) {
  const int row_bytes = (c + 8) * 2;
  const int fixed = 2 * (2 * halo + 16);
  const int per = nb > 1 ? 3 : 2;
  int tt = (budget / row_bytes - fixed) / per / 16 * 16;
  tt = tt < MAX_TT ? tt : MAX_TT;
  const int need = (t + 15) / 16 * 16;
  return tt < need ? tt : need;
}

template <bool CM>
int launch(const void* x, void* y, const void* w, const float* bias, int b, int c,
           int t, const Spec& sp, cudaStream_t stream) {
  if (b <= 0 || b > 65535 || t <= 0 || c <= 0 || c % 16) return int(cudaErrorInvalidValue);
  int halo = 0;
  for (int bi = 0; bi < sp.nb; ++bi) {
    int h = 0;
    for (int m = 0; m < sp.nd; ++m) h += ((sp.k[bi] - 1) / 2) * (sp.d[m] + 1);
    halo = h > halo ? h : halo;
  }
  int tt = pick_tile(c, t, halo, sp.nb, SMALL_BUDGET);
  if (tt < 64 && tt < (t + 15) / 16 * 16) tt = pick_tile(c, t, halo, sp.nb, LARGE_BUDGET);
  if (tt < 16) return int(cudaErrorInvalidValue);
  const int rows = tt + 2 * halo + 16;
  const size_t smem = size_t(c + 8) * 2 * (2 * rows + (sp.nb > 1 ? tt : 0));
  cudaError_t err = cudaFuncSetAttribute(
      mrf_kernel<CM>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((t + tt - 1) / tt, b);
  mrf_kernel<CM><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
      static_cast<const __nv_bfloat16*>(w), bias, c, t, tt, halo, sp);
  return int(cudaGetLastError());
}

bool make_spec(Spec& sp, int nb, const int* ks, int nd, const int* ds, int c) {
  if (nb <= 0 || nb > MAX_BRANCHES || nd <= 0 || nd > MAX_DILS) return false;
  sp.nb = nb;
  sp.nd = nd;
  long long off = 0;
  for (int bi = 0; bi < nb; ++bi) {
    if (ks[bi] <= 0 || ks[bi] % 2 == 0) return false;
    sp.k[bi] = ks[bi];
    sp.w_off[bi] = off;
    off += 2LL * nd * ks[bi] * c * c;
  }
  for (int m = 0; m < nd; ++m) {
    if (ds[m] <= 0) return false;
    sp.d[m] = ds[m];
  }
  return true;
}

// ---- float32 entries --------------------------------------------------
//
// The same tile schedule in float32, for C of any size: each conv is
// plain FMA on the SIMT cores (no TF32), thread (row group, output
// channel) summing k * C products for RB rows at a time; the weights come
// transposed, [k][C_in][C_out] per conv, so a warp's output channels read
// consecutive words.  Both roundings agree in f32 (the plain version adds
// the bias after the sum in both cases); CIRC adds it after the sum, the
// rows entry starts the sum at it.  The tiles live in shared memory when
// they fit LARGE_BUDGET with at least 16 samples; a C too wide for that
// (about 200 and up at k = 11) keeps them in a device workspace the
// wrapper allocates (mrf_f32_workspace_floats), block by block, still
// read and written by one block between barriers.

constexpr int RB = 4;                 // rows a thread sums at a time
constexpr int WS_TT = 1024;           // time tile of the workspace layout

template <bool CIRC, bool LEAKY_IN, bool RESID>
__device__ void conv_tile_f32(const float* src, float* dst, const float* __restrict__ w,
                              const float* __restrict__ bias, int c, int k, int d,
                              int lo, int count, int g0, int t) {
  const int s = ((k - 1) / 2) * d;
  const int groups = (count + RB - 1) / RB;
  for (int item = threadIdx.x; item < groups * c; item += THREADS) {
    const int co = item % c;
    const int r0 = lo + (item / c) * RB;
    const float b = bias[co];
    float acc[RB];
#pragma unroll
    for (int i = 0; i < RB; ++i) acc[i] = CIRC ? 0.f : b;
    for (int j = 0; j < k; ++j) {
      const float* srow = src + (r0 + j * d - s) * c;
      const float* wj = w + size_t(j) * c * c + co;
      for (int ci = 0; ci < c; ++ci) {
        const float wv = wj[size_t(ci) * c];
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          float a = srow[i * c + ci];
          if (LEAKY_IN) a = leaky(a);
          acc[i] = fmaf(wv, a, acc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const int row = r0 + i;
      const int gi = g0 + row;
      float v = CIRC ? acc[i] + b : acc[i];
      float* dp = dst + row * c + co;
      v = RESID ? *dp + v : leaky(v);
      *dp = (gi >= 0 && gi < t) ? v : 0.f;
    }
  }
}

// CM: x, y are [B, C, T] and the convs add the bias after the sum; else
// [B, T, C].  Grid (ceil(T / TT), B).  ws: null (tiles in shared memory)
// or a workspace of per_block floats for each block.
template <bool CM>
__global__ void __launch_bounds__(THREADS)
mrf_f32_kernel(const float* __restrict__ x, float* __restrict__ y,
               const float* __restrict__ w, const float* __restrict__ bias, int c, int t,
               int tt, int halo, Spec sp, float* ws, size_t per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int l = tt + 2 * halo;
  const int rows = l + 16;
  float* cur = ws ? ws + per_block * (size_t(blockIdx.y) * gridDim.x + blockIdx.x)
                  : reinterpret_cast<float*>(smem);
  float* tmp = cur + rows * c;
  float* sum = tmp + rows * c;               // used when sp.nb > 1
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * tt;
  const int g0 = t0 - halo;
  const size_t base = size_t(blockIdx.y) * c * t;
  x += base;
  y += base;

  for (int i = tid; i < rows * c; i += THREADS) tmp[i] = 0.f;

  for (int bi = 0; bi < sp.nb; ++bi) {
    for (int i = tid; i < c * rows; i += THREADS) {
      int ch, r;
      if (CM) {
        ch = i / rows;
        r = i % rows;
      } else {
        r = i / c;
        ch = i % c;
      }
      const int gi = g0 + r;
      float v = 0.f;
      if (r < l && gi >= 0 && gi < t) v = CM ? x[size_t(ch) * t + gi] : x[size_t(gi) * c + ch];
      cur[r * c + ch] = v;
    }
    __syncthreads();

    const int k = sp.k[bi];
    const int hw = (k - 1) / 2;
    int reach = 0;
    for (int m = 0; m < sp.nd; ++m) reach += hw * (sp.d[m] + 1);
    const float* wb = w + sp.w_off[bi];
    const float* bb = bias + size_t(bi) * sp.nd * 2 * c;
    const size_t conv_w = size_t(k) * c * c;
    for (int m = 0; m < sp.nd; ++m) {
      const int d = sp.d[m];
      reach -= hw * d;
      conv_tile_f32<CM, true, false>(cur, tmp, wb + (2 * m) * conv_w, bb + (2 * m) * c, c,
                                     k, d, halo - reach, tt + 2 * reach, g0, t);
      __syncthreads();
      reach -= hw;
      conv_tile_f32<CM, false, true>(tmp, cur, wb + (2 * m + 1) * conv_w,
                                     bb + (2 * m + 1) * c, c, k, 1, halo - reach,
                                     tt + 2 * reach, g0, t);
      __syncthreads();
    }
    if (sp.nb > 1) {
      for (int i = tid; i < tt * c; i += THREADS) {
        const float v = cur[halo * c + i];
        sum[i] = bi == 0 ? v : sum[i] + v;
      }
      __syncthreads();
    }
  }

  const float nbf = float(sp.nb);
  const float* src = sp.nb > 1 ? sum : cur + halo * c;
  for (int i = tid; i < c * tt; i += THREADS) {
    int ch, r;
    if (CM) {
      ch = i / tt;
      r = i % tt;
    } else {
      r = i / c;
      ch = i % c;
    }
    if (t0 + r >= t) continue;
    float v = src[r * c + ch];
    if (sp.nb > 1) v = v / nbf;
    if (CM) {
      y[size_t(ch) * t + t0 + r] = v;
    } else {
      y[size_t(t0 + r) * c + ch] = v;
    }
  }
}

int spec_halo(const Spec& sp) {
  int halo = 0;
  for (int bi = 0; bi < sp.nb; ++bi) {
    int h = 0;
    for (int m = 0; m < sp.nd; ++m) h += ((sp.k[bi] - 1) / 2) * (sp.d[m] + 1);
    halo = h > halo ? h : halo;
  }
  return halo;
}

// (time tile, floats of a block's workspace or 0 for shared memory)
void plan_f32(int c, int t, int halo, int nb, int& tt, size_t& per_block) {
  const int row_bytes = c * 4;
  const int fixed = 2 * (2 * halo + 16);
  const int per = nb > 1 ? 3 : 2;
  const int need = (t + 15) / 16 * 16;
  tt = (SMALL_BUDGET / row_bytes - fixed) / per / 16 * 16;
  if (tt < 64) tt = (LARGE_BUDGET / row_bytes - fixed) / per / 16 * 16;
  tt = tt < MAX_TT ? tt : MAX_TT;
  tt = tt < need ? tt : need;
  per_block = 0;
  if (tt < 16) {
    tt = WS_TT < need ? WS_TT : need;
    per_block = size_t(2 * (tt + 2 * halo + 16) + (nb > 1 ? tt : 0)) * c;
  }
}

template <bool CM>
int launch_f32(const float* x, float* y, const float* w, const float* bias, int b, int c,
               int t, const Spec& sp, float* ws, cudaStream_t stream) {
  if (b <= 0 || b > 65535 || t <= 0 || c <= 0) return int(cudaErrorInvalidValue);
  const int halo = spec_halo(sp);
  int tt;
  size_t per_block;
  plan_f32(c, t, halo, sp.nb, tt, per_block);
  if (per_block && !ws) return int(cudaErrorInvalidValue);
  const size_t smem = per_block ? 0
      : size_t(c) * 4 * (2 * (tt + 2 * halo + 16) + (sp.nb > 1 ? tt : 0));
  cudaError_t err = cudaFuncSetAttribute(
      mrf_f32_kernel<CM>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((t + tt - 1) / tt, b);
  mrf_f32_kernel<CM><<<grid, THREADS, smem, stream>>>(
      x, y, w, bias, c, t, tt, halo, sp, per_block ? ws : nullptr, per_block);
  return int(cudaGetLastError());
}

}  // namespace

// x, y: contiguous bf16 [b, c, t]; w: bf16, per branch, dilation and conv
// (dilated, unit) the kernel as [k][c_out][c_in]; bias: float32
// [nb][nd][2][c]; ks[nb] odd kernel sizes, ds[nd] dilations (host
// arrays).  Runs on `stream` without synchronising; returns the launch's
// cudaError_t (0 on success).
extern "C" int mrf_fused_cm_bf16(const void* x, void* y, const void* w, const void* bias,
                                 int b, int c, int t, int nb, const int* ks, int nd,
                                 const int* ds, void* stream) {
  Spec sp;
  if (!make_spec(sp, nb, ks, nd, ds, c)) return int(cudaErrorInvalidValue);
  return launch<true>(x, y, w, static_cast<const float*>(bias), b, c, t, sp,
                      static_cast<cudaStream_t>(stream));
}

// One branch of kernel size k: x, y contiguous bf16 [b, t, c]; w: bf16
// [nd][2][k][c_out][c_in]; bias: float32 [nd][2][c].
extern "C" int mrf_branch_rows_bf16(const void* x, void* y, const void* w, const void* bias,
                                    int b, int t, int c, int k, int nd, const int* ds,
                                    void* stream) {
  Spec sp;
  if (!make_spec(sp, 1, &k, nd, ds, c)) return int(cudaErrorInvalidValue);
  return launch<false>(x, y, w, static_cast<const float*>(bias), b, c, t, sp,
                       static_cast<cudaStream_t>(stream));
}

// Floats of device workspace the f32 entries need for these operands (0:
// their tiles fit shared memory); nb = 1 and ks = &k for the rows entry.
extern "C" long long mrf_f32_workspace_floats(int b, int c, int t, int nb, const int* ks,
                                              int nd, const int* ds) {
  Spec sp;
  if (b <= 0 || t <= 0 || c <= 0 || !make_spec(sp, nb, ks, nd, ds, c)) return -1;
  int tt;
  size_t per_block;
  plan_f32(c, t, spec_halo(sp), nb, tt, per_block);
  return (long long)(per_block * size_t(b) * size_t((t + tt - 1) / tt));
}

// As mrf_fused_cm_bf16, in float32: w holds each conv transposed,
// [k][c_in][c_out]; ws: mrf_f32_workspace_floats floats (or null if 0).
extern "C" int mrf_fused_cm_f32(const void* x, void* y, const void* w, const void* bias,
                                int b, int c, int t, int nb, const int* ks, int nd,
                                const int* ds, void* ws, void* stream) {
  Spec sp;
  if (!make_spec(sp, nb, ks, nd, ds, c)) return int(cudaErrorInvalidValue);
  return launch_f32<true>(static_cast<const float*>(x), static_cast<float*>(y),
                          static_cast<const float*>(w), static_cast<const float*>(bias),
                          b, c, t, sp, static_cast<float*>(ws),
                          static_cast<cudaStream_t>(stream));
}

// As mrf_branch_rows_bf16, in float32: w [nd][2][k][c_in][c_out].
extern "C" int mrf_branch_rows_f32(const void* x, void* y, const void* w, const void* bias,
                                   int b, int t, int c, int k, int nd, const int* ds,
                                   void* ws, void* stream) {
  Spec sp;
  if (!make_spec(sp, 1, &k, nd, ds, c)) return int(cudaErrorInvalidValue);
  return launch_f32<false>(static_cast<const float*>(x), static_cast<float*>(y),
                           static_cast<const float*>(w), static_cast<const float*>(bias),
                           b, c, t, sp, static_cast<float*>(ws),
                           static_cast<cudaStream_t>(stream));
}
