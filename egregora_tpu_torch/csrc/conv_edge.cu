// conv_edge: the 'SAME' 3x3 convolution to one output channel,
// [B, F, M, C] x [3, 3, C] -> [B, F, M] float32, plus a bias, for Hopper
// (sm_90a): bf16 input (conv_edge_bf16) or float32 input (conv_edge_f32),
// any B, F, M and C.
//
// Replaces the Pallas TPU kernel egregora_tpu/ops/conv_edge.py::
// conv3x3_out1 (_kernel): the VAE decoder's last conv (nn.Conv(1, (3, 3))).
// That kernel takes frames of f_tile + 2 rows that its wrapper cuts from a
// zero-padded copy of the input (two extra passes over the activation in
// device memory) and refuses F % f_tile != 0.  Here each block reads its
// halo straight from x, with bounds checks standing in for the zero pad,
// so x is read once (plus the halo) and nothing else is written.
//
// A block of 256 threads walks f_tile rows (a multiple of 8) of a 32-column
// strip, 8 rows at a time: it stages the (8 + 2) x (32 + 2) pixel halo of
// up to CC channels in shared memory with 16-byte loads (element loads
// where C is not a multiple of the vector or x is not 16-byte aligned),
// then each thread forms one output pixel's 9*C dot product in f32 from
// 16-byte reads of the tile; C beyond CC goes in further chunks.  The
// weights arrive as float32 holding values of x's dtype (the wrapper
// rounds them, as the JAX kernel casts them), so every product is exact
// and only the order of the f32 sum differs from the JAX kernel's.
//
// Bound on the H100: bytes, B*F*M*(C*elt + 4) (x read once, the output
// written once) at 3.35 TB/s; the 18*B*F*M*C operations at 67 TFLOP/s
// (f32 FMA) take a fifth of that at C = 64 in bf16.  The halo costs
// (10*34)/(8*32) = 1.33 reads of each pixel through L2.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TF = 8;              // output rows a step
constexpr int TM = 32;             // output columns a block
constexpr int THREADS = TF * TM;   // one output pixel a thread
constexpr int HALO_PIX = (TF + 2) * (TM + 2);

template <typename T> struct Elt;
template <> struct Elt<__nv_bfloat16> {
  static constexpr int VEC = 8;    // values per 16 bytes
  static constexpr int CC = 64;    // channels a chunk
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
        ws[tap * CC + ch] = ch < cc ? w[tap * c + c0 + ch] : 0.f;
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
  if (b <= 0 || b > 65535 || f <= 0 || m <= 0 || c <= 0 || f_tile <= 0 || f_tile % TF)
    return int(cudaErrorInvalidValue);
  const int fb = (f + f_tile - 1) / f_tile;
  if (fb > 65535) return int(cudaErrorInvalidValue);
  const int smem = int(EdgeLayout<T>::bytes);
  cudaError_t err = cudaFuncSetAttribute(
      conv_edge_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  const int vec_ok = (c % Elt<T>::VEC == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const dim3 grid((m + TM - 1) / TM, fb, b);
  conv_edge_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), f, m, c, f_tile, vec_ok);
  return int(cudaGetLastError());
}

}  // namespace

// x: contiguous [b, f, m, c] bf16; w: contiguous float32 [3, 3, c] (values
// of bf16); bias: one float32; out: contiguous float32 [b, f, m]; f_tile:
// rows a block, a multiple of 8.  Returns the launch's cudaError_t (0 on success); the
// kernel runs on `stream` without synchronising.
extern "C" int conv_edge_bf16(const void* x, const void* w, const void* bias, void* out,
                              int b, int f, int m, int c, int f_tile, void* stream) {
  return launch<__nv_bfloat16>(x, w, bias, out, b, f, m, c, f_tile,
                               static_cast<cudaStream_t>(stream));
}

// as conv_edge_bf16, with x float32
extern "C" int conv_edge_f32(const void* x, const void* w, const void* bias, void* out,
                             int b, int f, int m, int c, int f_tile, void* stream) {
  return launch<float>(x, w, bias, out, b, f, m, c, f_tile,
                       static_cast<cudaStream_t>(stream));
}
