// mrf: the fused HiFi-GAN multi-receptive-field (MRF) block for Hopper
// (sm_90a): bf16 in and out on the tensor cores (mrf_core.cuh), or float32
// in and out in SIMT FMA (the *_f32 entries, below).
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
// (batch item, time tile) with the chain's halo and re-zeroes every conv
// output outside the signal [0, T), which makes the tile equal to
// per-layer zero padding; the input is read once a branch and the output
// written once.  The bf16 entries run mrf_core.cuh's warpgroup-MMA chain
// (its note gives the design and the bound) with one rounding policy
// each; the wrapper pads C to the width the core runs (16, 32 or a
// multiple of 64: mrf_core::kernel_width) with zero channels.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mrf_core.cuh"

namespace {

using mrf_core::MAX_BRANCHES;
using mrf_core::MAX_DILS;
using mrf_core::Spec;
using mrf_core::leaky;

constexpr int THREADS = 256;          // the float32 entries' blocks
constexpr int SMALL_BUDGET = 110 * 1024;
constexpr int LARGE_BUDGET = 220 * 1024;
constexpr int MAX_TT = 2048;

// _conv_circ: the f32 sum rounded to bf16, then the bf16 bias added
struct CircRounding {
  static constexpr bool ROUND_THEN_BIAS = true;
};

// _conv_rows: the f32 sum starts at the f32 bias and is rounded once
struct RowsRounding {
  static constexpr bool ROUND_THEN_BIAS = false;
};

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

int spec_halo(const Spec& sp) {
  int halo = 0;
  for (int bi = 0; bi < sp.nb; ++bi) {
    int h = 0;
    for (int m = 0; m < sp.nd; ++m) h += ((sp.k[bi] - 1) / 2) * (sp.d[m] + 1);
    halo = h > halo ? h : halo;
  }
  return halo;
}

// the bf16 entries: C must be mrf_core::kernel_width(C)
template <class Rounding, bool CM>
int launch_bf16(const void* x, void* y, const void* w, const float* bias, int b, int c, int t,
                const Spec& sp, cudaStream_t stream) {
  mrf_core::Plan p;
  if (b <= 0 || b > 65535 || !mrf_core::make_plan(p, c, t, spec_halo(sp), sp.nb, CM))
    return int(cudaErrorInvalidValue);
  long long w_rows = 0;                      // the packed weights as [rows][C]
  for (int bi = 0; bi < sp.nb; ++bi) w_rows += 2LL * sp.nd * sp.k[bi] * c;
  switch (p.nc) {
    case 16: return mrf_core::launch<16, Rounding, CM>(x, y, w, bias, b, t, sp, p, w_rows, stream);
    case 32: return mrf_core::launch<32, Rounding, CM>(x, y, w, bias, b, t, sp, p, w_rows, stream);
    case 64: return mrf_core::launch<64, Rounding, CM>(x, y, w, bias, b, t, sp, p, w_rows, stream);
    case 128: return mrf_core::launch<128, Rounding, CM>(x, y, w, bias, b, t, sp, p, w_rows, stream);
    default: return int(cudaErrorInvalidValue);
  }
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

// x, y: contiguous bf16 [b, c, t], c = mrf_core::kernel_width(c); w: bf16,
// per branch, dilation and conv (dilated, unit) the kernel as
// [k][c_out][c_in]; bias: float32 [nb][nd][2][c]; ks[nb] odd kernel sizes,
// ds[nd] dilations (host arrays).  Runs on `stream` without
// synchronising; returns the launch's cudaError_t (0 on success).
extern "C" int mrf_fused_cm_bf16(const void* x, void* y, const void* w, const void* bias,
                                 int b, int c, int t, int nb, const int* ks, int nd,
                                 const int* ds, void* stream) {
  Spec sp;
  if (!make_spec(sp, nb, ks, nd, ds, c)) return int(cudaErrorInvalidValue);
  return launch_bf16<CircRounding, true>(x, y, w, static_cast<const float*>(bias), b, c, t,
                                         sp, static_cast<cudaStream_t>(stream));
}

// One branch of kernel size k: x, y contiguous bf16 [b, t, c]; w: bf16
// [nd][2][k][c_out][c_in]; bias: float32 [nd][2][c].
extern "C" int mrf_branch_rows_bf16(const void* x, void* y, const void* w, const void* bias,
                                    int b, int t, int c, int k, int nd, const int* ds,
                                    void* stream) {
  Spec sp;
  if (!make_spec(sp, 1, &k, nd, ds, c)) return int(cudaErrorInvalidValue);
  return launch_bf16<RowsRounding, false>(x, y, w, static_cast<const float*>(bias), b, c, t,
                                          sp, static_cast<cudaStream_t>(stream));
}

// The bf16 block for C channels (padded to kernel_width), T samples, halo
// H, nb branches, channel-major (cm) or not: out = {channels run, time
// tile, threads, dynamic shared memory bytes, weight ring slots, output
// channels a pass, taps a weight slice, leaky tile kept}; 0, or -1 where
// no tile fits.  ops/mrf_fused.py's bf16_plan mirrors it.
extern "C" int mrf_bf16_layout(int c, int t, int halo, int nb, int cm, int* out) {
  mrf_core::Plan p;
  if (c <= 0 || !mrf_core::make_plan(p, mrf_core::kernel_width(c), t, halo, nb, cm != 0))
    return -1;
  const int v[8] = {p.c, p.tt, mrf_core::THREADS, p.bytes, p.stages, p.nc, p.q, p.lk};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
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
