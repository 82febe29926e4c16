// conv_edge: the 'SAME' 3x3 convolution to one output channel,
// [B, F, M, C] x [3, 3, C] -> [B, F, M] float32, plus a bias, for Hopper
// (sm_90a): bf16 input (conv_edge_bf16) or float32 input (conv_edge_f32),
// any B, F, M and C.
//
// Replaces the Pallas TPU kernel egregora_tpu/ops/conv_edge.py::
// conv3x3_out1 (_kernel): the VAE decoder's last conv (nn.Conv(1, (3, 3))).
// That kernel takes frames of f_tile + 2 rows that its wrapper cuts from a
// zero-padded copy of the input and refuses F % f_tile != 0; its body sums
// each tap over C on the MXU, then the nine taps.  Here x is read in
// place, once, and nothing else is written.
//
// Bound on the H100: bytes, B*F*M*(C*elt + 4) (x read once, the output
// written once) at 3.35 TB/s.  On the CUDA cores the 9*C multiply-adds of
// a pixel cost more instructions a clock than an SM issues at that rate in
// bf16 (each value unpacked once a tap, two weight reads a step), so the
// channel sums go to the tensor cores.
//
// Two routes, by shape (conv_edge_bf16_layout names the one a C takes;
// entries conv_edge_bf16_tc, conv_edge_bf16_cc and conv_edge_f32):
//
// * Tensor cores (bf16, C % 8 == 0 and C <= 4096, x 16-byte aligned: what
//   a TMA tensor map can address).  The nine taps are the N dimension of
//   one product: D[p, t] = sum_c x[p, c] w[t, c], t = 0..8 of N = 16, per
//   pixel, by wgmma m64n16k16 with A straight from the TMA slab (128-byte
//   swizzle, no tap shift) and B the block's [16, C] weights in shared
//   memory; then out[f, m] = bias + sum_t D[(f + di - 1, m + dj - 1), t]
//   in f32 on the CUDA cores, as the JAX kernel sums each tap over C first
//   and then the taps.  Every x value is read from shared memory once.
//   A block of one consumer warpgroup and one producer warp walks down an F
//   segment (the wrapper's rows, f_tile at most) of a 64-column strip: the
//   producer keeps a 4-stage mbarrier ring of slabs full by TMA, a slab
//   being one image row of the strip and its two halo columns (66 pixels)
//   for one 64-channel box, from a 4-D tensor map over (C, M, F, B).  A
//   box reaching past an edge of the image (row or column -1, F, M) or past
//   C is zero-filled by the hardware: that is the 'SAME' padding and the
//   channel padding, with no bounds checks, and the batch edge stays exact.
//   The consumers run two M tiles a slab (pixels 0-63 and 8-71 of the
//   slab; rows 66-71 are zeros), four k16 steps a box, write the row's
//   nine live columns of D to shared memory and fold them into running
//   sums: each row of D completes one output row.  So every
//   pixel comes from device memory once, plus 2/64 of halo columns and
//   two halo rows a segment (mostly L2 hits).
// * CUDA cores (float32, whose products the tensor cores would round to
//   TF32; bf16 at any other C or alignment): a block of 256 threads walks
//   a 32-column strip 8 rows at a time, staging the (8 + 2) x (32 + 2)
//   halo of up to 64 (bf16) or 32 (float32) channels in shared memory with
//   bounds checks as the padding, each thread forming one output pixel's
//   9*C dot product in f32.
//
// The weights arrive as float32 and are rounded to x's dtype as they are
// staged (round to nearest even, as the JAX kernel's cast), so every
// product is exact and only the order of the f32 sums differs from the
// JAX kernel's.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

// ---- the tensor-core route --------------------------------------------------

namespace tc {

constexpr int STRIP = 64;                     // output columns a block
constexpr int BOX_COLS = STRIP + 2;           // pixels a slab: the strip and its halo
constexpr int SLAB_ROWS = 72;                 // pixel rows of a slab in shared memory
constexpr int CB = 64;                        // channels a box: 128 bytes, the swizzle
constexpr int SLAB_BYTES = SLAB_ROWS * 128;
constexpr int BOX_BYTES = BOX_COLS * 128;     // what one TMA box writes
constexpr int STAGES = 4;
constexpr int CONSUMERS = 128;                // one warpgroup
constexpr int THREADS = CONSUMERS + 32;       // and a producer warp
constexpr int TAPS = 9;
constexpr int DP = 68;                        // floats a tap's row of D (conflict-free)
constexpr int MAX_C = 4096;
constexpr int W_BYTES = 16 * 128;             // one box's [16 taps][64 channels] bf16

__host__ __device__ constexpr int boxes(int c) { return (c + CB - 1) / CB; }
__host__ __device__ constexpr int w_off() { return STAGES * SLAB_BYTES; }
__host__ __device__ constexpr int d_off(int c) { return w_off() + boxes(c) * W_BYTES; }
__host__ __device__ constexpr int bar_off(int c) { return d_off(c) + 2 * TAPS * DP * 4; }
// dynamic shared memory: the layout plus 1 KB to align the swizzled slabs
__host__ __device__ constexpr int bytes(int c) { return 1024 + bar_off(c) + 2 * STAGES * 8; }

// d (64 x 16 f32 fragment) (+)= A [64 x 16] x B [16 x 16]^T, both K-major
// in shared memory with the 128-byte swizzle
__device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Grid (strips, F segments, B); tx: x as (C, M, F, B), boxes of 64
// channels x 66 pixels; w: float32 [9, C]; rows: output rows a segment.
__global__ void __launch_bounds__(THREADS)
conv_edge_tc(const __grid_constant__ CUtensorMap tx, const float* __restrict__ w,
             const float* __restrict__ bias, float* __restrict__ out, int f, int m, int c,
             int rows) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;           // swizzle atoms: 1 KB aligned
  unsigned char* smem = smem_raw + (base - raw);
  const int nbox = boxes(c);
  const uint32_t bar_full = base + bar_off(c), bar_empty = bar_full + 8 * STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * STRIP, f0 = blockIdx.y * rows, b = blockIdx.z;
  const int f1 = min(f, f0 + rows);
  const int nrows = f1 - f0 + 2;                           // input rows f0 - 1 .. f1

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < CONSUMERS) {
    // the weights as [box][tap n][64 channels] bf16, 16-byte chunks XOR
    // the row as TMA's 128-byte swizzle lays them; taps 9-15 and channels
    // past C are zeros
    for (int i = tid; i < nbox * 16 * 8; i += CONSUMERS) {
      const int cb = i >> 7, n = (i >> 3) & 15, ch = i & 7;
      uint4 v;
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ci = cb * CB + ch * 8 + j;
        e[j] = __float2bfloat16(n < TAPS && ci < c ? w[n * c + ci] : 0.f);
      }
      const int off = w_off() + cb * W_BYTES + n * 128 + ((ch ^ (n & 7)) << 4);
      *reinterpret_cast<uint4*>(smem + off) = v;
    }
    // slab rows past the box, which the second M tile reads and TMA never writes
    constexpr int TAIL = (SLAB_ROWS - BOX_COLS) * 8;
    for (int i = tid; i < STAGES * TAIL; i += CONSUMERS) {
      const int off = (i / TAIL) * SLAB_BYTES + BOX_COLS * 128 + (i % TAIL) * 16;
      *reinterpret_cast<uint4*>(smem + off) = make_uint4(0u, 0u, 0u, 0u);
    }
    // those writes are read by wgmma, through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    // producer: every (row, channel box) of the segment into the ring
    if (lane == 0) {
      int it = 0;
      for (int r = 0; r < nrows; ++r)
        for (int cb = 0; cb < nbox; ++cb, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(bar_empty + 8 * s, ((it / STAGES) - 1) & 1);
          mbar_expect_tx(bar_full + 8 * s, BOX_BYTES);
          tma_load_4d(base + s * SLAB_BYTES, &tx, cb * CB, m0 - 1, f0 - 1 + r, b,
                      bar_full + 8 * s);
        }
    }
    return;
  }

  // consumers: warp wq holds rows 16 wq .. 16 wq + 15 of each M tile
  // (rows g and g + 8, columns 8j + 2 tq and 8j + 2 tq + 1 of fragment j)
  const int wq = warp, g = lane >> 2, tq = lane & 3;
  float* dsm = reinterpret_cast<float*>(smem + d_off(c));
  float acc0[8] = {}, acc1[8] = {};                         // pixels 0-63 and 8-71
  float part_prev = 0.f, part_cur = 0.f;                    // output rows r - 1 and r
  const float bv = bias[0];
  const int col = tid;                                      // tid < 64: output column m0 + tid
  out += (size_t(b) * f) * m + m0 + col;

  int it = 0;
  for (int r = 0; r < nrows; ++r) {
    for (int cb = 0; cb < nbox; ++cb, ++it) {
      const int s = it % STAGES;
      mbar_wait(bar_full + 8 * s, (it / STAGES) & 1);
      const uint32_t a = base + s * SLAB_BYTES, wb = base + w_off() + cb * W_BYTES;
      // four k16 steps: channels past C are zeros in both operands
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = smem_desc(wb + kk * 32, 16, 1024, 1);
        const int acc = cb > 0 || kk > 0;
        mma(acc0, smem_desc(a + kk * 32, 16, 1024, 1), db, acc);
        mma(acc1, smem_desc(a + 1024 + kk * 32, 16, 1024, 1), db, acc);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<8>(acc0);
      fence_regs<8>(acc1);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);        // this warp is done with the slab
    }

    // the row's nine live columns of D, as [tap][pixel], double-buffered
    float* dr = dsm + (r & 1) * TAPS * DP;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tap = 8 * j + 2 * tq + (e & 1), px = 16 * wq + g + 8 * (e >> 1);
        if (tap < TAPS) {
          dr[tap * DP + px] = acc0[4 * j + e];
          if (px + 8 >= 64 && px + 8 < BOX_COLS) dr[tap * DP + px + 8] = acc1[4 * j + e];
        }
      }
    named_bar_sync(1, CONSUMERS);
    if (col < STRIP) {
      // pixel col + dj of the slab is column m0 + col + dj - 1
      float rs[3];
#pragma unroll
      for (int di = 0; di < 3; ++di)
        rs[di] = dr[(3 * di) * DP + col] + dr[(3 * di + 1) * DP + col + 1] +
                 dr[(3 * di + 2) * DP + col + 2];
      // input row f0 - 1 + r is the row below output row f0 - 2 + r, the
      // centre row of f0 - 1 + r and the row above f0 + r
      const float done = part_prev + rs[2];
      const int fo = f0 - 2 + r;
      if (r >= 2 && m0 + col < m) out[size_t(fo) * m] = done + bv;
      part_prev = part_cur + rs[1];
      part_cur = rs[0];
    }
  }
}

int launch(const void* x, const void* w, const void* bias, void* out, int b, int f, int m,
           int c, int rows, cudaStream_t stream) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return int(cudaErrorNotSupported);
  CUtensorMap tx;
  const cuuint64_t dims[4] = {cuuint64_t(c), cuuint64_t(m), cuuint64_t(f), cuuint64_t(b)};
  const cuuint64_t strides[3] = {cuuint64_t(c) * 2, cuuint64_t(m) * c * 2,
                                 cuuint64_t(f) * m * c * 2};
  const cuuint32_t box[4] = {CB, BOX_COLS, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return int(cudaErrorInvalidValue);
  static int configured = -1;   // the device whose shared-memory limit is raised
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev != configured) {
    e = cudaFuncSetAttribute(conv_edge_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes(MAX_C));
    if (e == cudaSuccess) configured = dev;
  }
  if (e != cudaSuccess) return int(e);
  const dim3 grid((m + STRIP - 1) / STRIP, (f + rows - 1) / rows, b);
  conv_edge_tc<<<grid, THREADS, bytes(c), stream>>>(
      tx, static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<float*>(out), f, m, c, rows);
  return int(cudaGetLastError());
}

}  // namespace tc

// ---- the CUDA-core route ----------------------------------------------------

namespace staged {

constexpr int TF = 8;              // output rows a step
constexpr int TM = 32;             // output columns a block
constexpr int THREADS = TF * TM;   // one output pixel a thread
constexpr int HALO_PIX = (TF + 2) * (TM + 2);

template <typename T> struct Elt;
template <> struct Elt<__nv_bfloat16> {
  static constexpr int VEC = 8;    // values per 16 bytes
  static constexpr int CC = 64;    // channels a chunk
  __device__ static float weight(float w) { return __bfloat162float(__float2bfloat16(w)); }
  __device__ static void dot(const uint4& raw, const float* w, float& acc) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float4 w0 = *reinterpret_cast<const float4*>(w);
    const float4 w1 = *reinterpret_cast<const float4*>(w + 4);
    float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
    acc = fmaf(a.x, w0.x, acc); acc = fmaf(a.y, w0.y, acc);
    acc = fmaf(b.x, w0.z, acc); acc = fmaf(b.y, w0.w, acc);
    acc = fmaf(c.x, w1.x, acc); acc = fmaf(c.y, w1.y, acc);
    acc = fmaf(d.x, w1.z, acc); acc = fmaf(d.y, w1.w, acc);
  }
};
template <> struct Elt<float> {
  static constexpr int VEC = 4;
  static constexpr int CC = 32;
  __device__ static float weight(float w) { return w; }
  __device__ static void dot(const uint4& raw, const float* w, float& acc) {
    const float4 x = *reinterpret_cast<const float4*>(&raw);
    const float4 w0 = *reinterpret_cast<const float4*>(w);
    acc = fmaf(x.x, w0.x, acc); acc = fmaf(x.y, w0.y, acc);
    acc = fmaf(x.z, w0.z, acc); acc = fmaf(x.w, w0.w, acc);
  }
};

template <typename T>
struct EdgeLayout {
  static constexpr int VEC = Elt<T>::VEC, CC = Elt<T>::CC;
  static constexpr int PP = CC + VEC;   // pixel pitch: 16 bytes of pad, no bank conflicts
  static constexpr size_t tile_bytes = size_t(HALO_PIX) * PP * sizeof(T);
  static constexpr size_t bytes = tile_bytes + size_t(9) * CC * 4;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_edge_kernel(const T* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ out, int f,
                 int m, int c, int f_tile, int vec_ok) {
  using L = EdgeLayout<T>;
  constexpr int VEC = L::VEC, CC = L::CC, PP = L::PP;
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  float* ws = reinterpret_cast<float*>(smem + L::tile_bytes);

  const int tid = threadIdx.x;
  const int ty = tid / TM, tx = tid % TM;
  const int m0 = blockIdx.x * TM;
  const int f_end = min(f, (blockIdx.y + 1) * f_tile);
  x += size_t(blockIdx.z) * f * m * c;
  out += size_t(blockIdx.z) * f * m;

  for (int f0 = blockIdx.y * f_tile; f0 < f_end; f0 += TF) {
    float acc0 = 0.f, acc1 = 0.f;   // two partial sums for the FMA pipeline
    for (int c0 = 0; c0 < c; c0 += CC) {
      const int cc = min(CC, c - c0);
      const int nv = (cc + VEC - 1) / VEC;   // vectors a pixel, the tail zero-filled
      __syncthreads();   // the previous chunk's readers are done with the tile
      for (int i = tid; i < HALO_PIX * nv; i += THREADS) {
        const int p = i / nv, vi = i % nv;
        const int fi = f0 - 1 + p / (TM + 2), mi = m0 - 1 + p % (TM + 2);
        const int cv = vi * VEC;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (fi >= 0 && fi < f && mi >= 0 && mi < m) {
          const T* src = x + (size_t(fi) * m + mi) * c + c0 + cv;
          if (vec_ok && cv + VEC <= cc) {
            val = *reinterpret_cast<const uint4*>(src);
          } else {
            T* vt = reinterpret_cast<T*>(&val);
            for (int e = 0; e < VEC && cv + e < cc; ++e) vt[e] = src[e];
          }
        }
        *reinterpret_cast<uint4*>(tile + p * PP + cv) = val;
      }
      for (int i = tid; i < 9 * nv * VEC; i += THREADS) {
        const int tap = i / (nv * VEC), ch = i % (nv * VEC);
        ws[tap * CC + ch] = ch < cc ? Elt<T>::weight(w[tap * c + c0 + ch]) : 0.f;
      }
      __syncthreads();

#pragma unroll
      for (int di = 0; di < 3; ++di) {
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) {
          const T* px = tile + ((ty + di) * (TM + 2) + tx + dj) * PP;
          const float* wt = ws + (di * 3 + dj) * CC;
          for (int vi = 0; vi < nv; vi += 2) {
            Elt<T>::dot(*reinterpret_cast<const uint4*>(px + vi * VEC), wt + vi * VEC, acc0);
            if (vi + 1 < nv)
              Elt<T>::dot(*reinterpret_cast<const uint4*>(px + (vi + 1) * VEC),
                          wt + (vi + 1) * VEC, acc1);
          }
        }
      }
    }
    const int fo = f0 + ty, mo = m0 + tx;
    if (fo < f_end && mo < m) out[size_t(fo) * m + mo] = (acc0 + acc1) + bias[0];
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* bias, void* out, int b, int f,
           int m, int c, int f_tile, cudaStream_t stream) {
  if (f_tile % TF) return int(cudaErrorInvalidValue);
  const int smem = int(EdgeLayout<T>::bytes);
  static int configured = -1;   // the device whose shared-memory limit is raised
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev != configured) {
    err = cudaFuncSetAttribute(conv_edge_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err == cudaSuccess) configured = dev;
  }
  if (err != cudaSuccess) return int(err);
  const int vec_ok = (c % Elt<T>::VEC == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const dim3 grid((m + TM - 1) / TM, (f + f_tile - 1) / f_tile, b);
  conv_edge_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), f, m, c, f_tile, vec_ok);
  return int(cudaGetLastError());
}

}  // namespace staged

// the route of a bf16 x of C channels: the tensor cores where a TMA tensor
// map can address it (rows of 16-byte multiples, 16-byte aligned) and the
// weights fit shared memory
bool tensor_cores(int c, int aligned) { return aligned && c % 8 == 0 && c <= tc::MAX_C; }

bool shape_ok(int b, int f, int m, int c, int rows) {
  return b > 0 && b <= 65535 && f > 0 && m > 0 && c > 0 && rows > 0 &&
         (f + rows - 1) / rows <= 65535;
}

}  // namespace

// The block a bf16 x of C channels launches (16-byte aligned or not):
// out[0] route (1: tensor cores, 0: CUDA cores), out[1] output columns a
// block, out[2] rows a step of its F segment (a segment's rows must be a
// multiple of it), out[3] threads, out[4] dynamic shared memory bytes,
// out[5] TMA ring stages (0: none).  Returns 0, or cudaErrorInvalidValue
// for C <= 0.
extern "C" int conv_edge_bf16_layout(int c, int aligned, int* out) {
  if (c <= 0) return int(cudaErrorInvalidValue);
  if (tensor_cores(c, aligned)) {
    const int v[6] = {1, tc::STRIP, 1, tc::THREADS, tc::bytes(c), tc::STAGES};
    for (int i = 0; i < 6; ++i) out[i] = v[i];
  } else {
    const int v[6] = {0, staged::TM, staged::TF, staged::THREADS,
                      int(staged::EdgeLayout<__nv_bfloat16>::bytes), 0};
    for (int i = 0; i < 6; ++i) out[i] = v[i];
  }
  return 0;
}

// x: contiguous [b, f, m, c] bf16 (16-byte aligned, C % 8 == 0, C <=
// 4096: conv_edge_bf16_layout's route 1); w: contiguous float32 [3, 3, c]
// (rounded to bf16 here); bias: one float32; out: contiguous float32 [b, f, m];
// rows: output rows a block (an F segment).  The tensor-core route.
// Returns the launch's cudaError_t (0 on success; cudaErrorInvalidValue
// for a shape of the other route); the kernel runs on `stream` without
// synchronising.
extern "C" int conv_edge_bf16_tc(const void* x, const void* w, const void* bias, void* out,
                                 int b, int f, int m, int c, int rows, void* stream) {
  if (!shape_ok(b, f, m, c, rows) || !tensor_cores(c, reinterpret_cast<uintptr_t>(x) % 16 == 0))
    return int(cudaErrorInvalidValue);
  return tc::launch(x, w, bias, out, b, f, m, c, rows, static_cast<cudaStream_t>(stream));
}

// as conv_edge_bf16_tc, on the CUDA-core route at any C and alignment;
// rows a multiple of 8
extern "C" int conv_edge_bf16_cc(const void* x, const void* w, const void* bias, void* out,
                                 int b, int f, int m, int c, int rows, void* stream) {
  if (!shape_ok(b, f, m, c, rows)) return int(cudaErrorInvalidValue);
  return staged::launch<__nv_bfloat16>(x, w, bias, out, b, f, m, c, rows,
                                       static_cast<cudaStream_t>(stream));
}

// as conv_edge_bf16_cc, with x float32 (the CUDA-core route at every C)
extern "C" int conv_edge_f32(const void* x, const void* w, const void* bias, void* out,
                             int b, int f, int m, int c, int rows, void* stream) {
  if (!shape_ok(b, f, m, c, rows)) return int(cudaErrorInvalidValue);
  return staged::launch<float>(x, w, bias, out, b, f, m, c, rows,
                               static_cast<cudaStream_t>(stream));
}
