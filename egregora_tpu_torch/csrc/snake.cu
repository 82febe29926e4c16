// snake: the DAC's Snake activation  y = x + sin(a x)^2 / (a + 1e-9)  over a
// [B, C, T] laid out NCW (contiguous) or NWC (channels-last: the memory of
// [B, T, C]), a = alpha[c] (clamped from below at `floor` where floor > 0),
// for Hopper (sm_90a), in one pass; the output in the input's layout.
//
// Replaces no TPU kernel: the JAX package's Snake is plain jnp
// (egregora_tpu/models/dac/model.py::snake), which XLA fuses into its
// neighbours.  The port's plain version (ops/snake.py::snake_plain) runs
// as six PyTorch passes over float32 copies (a cast up, a * x, sin, the
// square, the divide, the add), then the next conv casts the result back
// to bf16: about 56 bytes of traffic an element.  This kernel reads the
// input once, computes in float32 in registers and writes the output once,
// in the dtype the next conv reads.
//
// Bound on the H100: 4 bytes an element (bf16 in, bf16 out) at 3.35 TB/s,
// 0.84e12 elements a second.  The work is ~40 instructions an element (the
// accurate sinf's range reduction and polynomial, the IEEE divide), so the
// kernel sits near the card's balance point; the design keeps memory busy
// and the instruction count flat:
//
// 1. Rows.  One (b, c) row per blockIdx.y (a grid-stride loop over rows
//    where B*C passes 65535), tiles of THREADS * UNROLL 16-byte vectors
//    along T in blockIdx.x.  alpha[c], the clamp and the divisor a + 1e-9
//    are taken once a row into registers: no integer division an element.
// 2. Vectors.  16-byte loads (8 bf16 or 4 float32), UNROLL of them issued
//    by a thread before any is used, so that 64 bytes a thread are in
//    flight; the outputs leave as 16-byte (or 8-byte) stores.  A row whose
//    start is not on a vector boundary (T % V != 0) takes a scalar head up
//    to the boundary and a scalar tail after its last whole vector (block
//    0 of the row does both: at most 2 V - 2 elements).
// 3. Offsets are 64-bit: the decoder's last stage on a long song is past
//    2^31 elements.
// 4. NWC (snake_nwc_kernel): rows of C channels, one a (b, t).  A block is
//    threadIdx.x over 16-byte channel groups (W channels each) by
//    threadIdx.y over rows, so that the block's loads are one contiguous
//    run; a thread takes its W clamped alphas once into registers and then
//    NWC_UNROLL rows, blockDim.y apart, whose loads it starts before any is
//    used.  Registers bound it: each of a thread's W channels has its own
//    alpha, so the divisor is formed at each element (one add) instead of
//    kept, and two rows a thread beat four: 71% of the bytes bound against
//    66%, and 59% with four rows keeping the divisors, where the NCW kernel
//    reads 74% (H100, the 58 Snake shapes of one 60 s stereo call).  Where
//    C is not a multiple of W, or x or y is off the 16-byte boundary, the
//    groups are of one channel (scalar loads).
//
// Numerics: the same float32 operations in the same order as the plain
// version, each rounded as PyTorch's CUDA kernels round it -- the accurate
// sinf (no __sinf, no --use_fast_math), a true IEEE division, and
// __fmul_rn / __fdiv_rn / __fadd_rn so that nothing is contracted into an
// FMA -- then one round-to-nearest-even to bf16 at the store, as
// Tensor.to(torch.bfloat16) rounds.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;                // 16-byte vectors in flight a thread
constexpr int NWC_UNROLL = 2;            // rows a thread, NWC
constexpr int NWC_BYTES = 16;            // input bytes a thread loads from a row, NWC
constexpr long long MAX_GRID_Y = 65535;

// 16 bytes of input as float32: V elements
template <typename T>
struct In;

template <>
struct In<__nv_bfloat16> {
  static constexpr int V = 8;
  static __device__ __forceinline__ void unpack(const uint4& w, float* f) {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ float one(__nv_bfloat16 v) { return __bfloat162float(v); }
};

template <>
struct In<float> {
  static constexpr int V = 4;
  static __device__ __forceinline__ void unpack(const uint4& w, float* f) {
    f[0] = __uint_as_float(w.x);
    f[1] = __uint_as_float(w.y);
    f[2] = __uint_as_float(w.z);
    f[3] = __uint_as_float(w.w);
  }
  static __device__ __forceinline__ float one(float v) { return v; }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// V outputs from float32, at an address aligned to V * sizeof(T)
template <int V>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float* r) {
  if constexpr (V == 8) {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(r[0], r[1]), pack_bf16(r[2], r[3]),
                                              pack_bf16(r[4], r[5]), pack_bf16(r[6], r[7]));
  } else {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(r[0], r[1]), pack_bf16(r[2], r[3]));
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float* r) {
#pragma unroll
  for (int q = 0; q < V / 4; ++q)
    *reinterpret_cast<float4*>(p + 4 * q) =
        make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
}

__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }

// x + sin(a x)^2 / d, d = a + 1e-9, rounded as the plain version rounds
__device__ __forceinline__ float snake1(float x, float a, float d) {
  const float s = sinf(__fmul_rn(a, x));
  return __fadd_rn(x, __fdiv_rn(__fmul_rn(s, s), d));
}

// vec: x and y start 16-byte aligned, so that a row's vectors start where
// its element offset is a multiple of V
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(THREADS)
snake_kernel(const Tin* __restrict__ x, const float* __restrict__ alpha, Tout* __restrict__ y,
             long long rows, int channels, long long t, float floor, int vec) {
  constexpr int V = In<Tin>::V;
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    float a = alpha[row % channels];
    if (floor > 0.f && a < floor) a = floor;
    const float d = __fadd_rn(a, 1e-9f);
    const long long base = row * t;
    const Tin* xr = x + base;
    Tout* yr = y + base;
    if (vec) {
      const long long head = min((V - base % V) % V, t);
      const long long nv = (t - head) / V;           // whole vectors of the row
      const long long tail = head + nv * V;
      if (blockIdx.x == 0) {
        for (long long i = threadIdx.x; i < head; i += THREADS)
          store_one(yr + i, snake1(In<Tin>::one(xr[i]), a, d));
        for (long long i = tail + threadIdx.x; i < t; i += THREADS)
          store_one(yr + i, snake1(In<Tin>::one(xr[i]), a, d));
      }
      const uint4* xv = reinterpret_cast<const uint4*>(xr + head);
      Tout* yv = yr + head;
      const long long v0 = (long long)blockIdx.x * (THREADS * UNROLL) + threadIdx.x;
      uint4 w[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long v = v0 + (long long)u * THREADS;
        if (v < nv) w[u] = xv[v];
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long v = v0 + (long long)u * THREADS;
        if (v < nv) {
          float f[V];
          In<Tin>::unpack(w[u], f);
#pragma unroll
          for (int e = 0; e < V; ++e) f[e] = snake1(f[e], a, d);
          store<V>(yv + v * V, f);
        }
      }
    } else {
      const long long e0 = (long long)blockIdx.x * (THREADS * UNROLL * V) + threadIdx.x;
#pragma unroll 4
      for (int k = 0; k < UNROLL * V; ++k) {
        const long long i = e0 + (long long)k * THREADS;
        if (i < t) store_one(yr + i, snake1(In<Tin>::one(xr[i]), a, d));
      }
    }
  }
}

// NWC: N 32-bit words at an address aligned to 4 N bytes
template <int N>
__device__ __forceinline__ void load_words(const void* p, uint32_t* w) {
  if constexpr (N == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else if constexpr (N == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x, w[1] = v.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

template <int N>
__device__ __forceinline__ void store_words(void* p, const uint32_t* w) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      reinterpret_cast<uint4*>(p)[q] = make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    *reinterpret_cast<uint32_t*>(p) = w[0];
  }
}

// W elements of T as 32-bit words, and back
template <typename T, int W>
struct Pack {
  static constexpr int N = W * int(sizeof(T)) / 4;
  static __device__ __forceinline__ void unpack(const uint32_t* w, float* f) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if constexpr (sizeof(T) == 2) {
        f[2 * i] = __uint_as_float(w[i] << 16);
        f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      } else {
        f[i] = __uint_as_float(w[i]);
      }
    }
  }
  static __device__ __forceinline__ void pack(const float* f, uint32_t* w) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if constexpr (sizeof(T) == 2) w[i] = pack_bf16(f[2 * i], f[2 * i + 1]);
      else w[i] = __float_as_uint(f[i]);
    }
  }
};

// NWC: x and y hold `rows` rows of `channels`; W channels a group (W of
// NWC_BYTES of input, or 1 where those loads would not be aligned)
template <typename Tin, typename Tout, int W>
__global__ void __launch_bounds__(THREADS)
snake_nwc_kernel(const Tin* __restrict__ x, const float* __restrict__ alpha,
                 Tout* __restrict__ y, long long rows, int channels, float floor) {
  const int groups = channels / W;
  const long long r0 = (long long)blockIdx.x * blockDim.y * NWC_UNROLL + threadIdx.y;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    float a[W];
#pragma unroll
    for (int e = 0; e < W; ++e) {
      a[e] = alpha[g * W + e];
      if (floor > 0.f && a[e] < floor) a[e] = floor;
    }
    if constexpr (W == 1) {
      Tin w[NWC_UNROLL];
#pragma unroll
      for (int u = 0; u < NWC_UNROLL; ++u) {
        const long long r = r0 + (long long)u * blockDim.y;
        if (r < rows) w[u] = x[r * channels + g];
      }
#pragma unroll
      for (int u = 0; u < NWC_UNROLL; ++u) {
        const long long r = r0 + (long long)u * blockDim.y;
        if (r < rows)
          store_one(y + r * channels + g, snake1(In<Tin>::one(w[u]), a[0], __fadd_rn(a[0], 1e-9f)));
      }
    } else {
      using In_ = Pack<Tin, W>;
      using Out = Pack<Tout, W>;
      uint32_t w[NWC_UNROLL][In_::N];
#pragma unroll
      for (int u = 0; u < NWC_UNROLL; ++u) {
        const long long r = r0 + (long long)u * blockDim.y;
        if (r < rows) load_words<In_::N>(x + r * channels + g * W, w[u]);
      }
#pragma unroll
      for (int u = 0; u < NWC_UNROLL; ++u) {
        const long long r = r0 + (long long)u * blockDim.y;
        if (r < rows) {
          float f[W];
          uint32_t o[Out::N];
          In_::unpack(w[u], f);
#pragma unroll
          for (int e = 0; e < W; ++e) f[e] = snake1(f[e], a[e], __fadd_rn(a[e], 1e-9f));
          Out::pack(f, o);
          store_words<Out::N>(y + r * channels + g * W, o);
        }
      }
    }
  }
}

template <typename Tin, typename Tout>
int launch(const void* x, const void* alpha, void* y, long long rows, int channels, long long t,
           float floor, int nwc, cudaStream_t s) {
  const int aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (nwc) {
    constexpr int V = NWC_BYTES / int(sizeof(Tin));
    const int w = aligned && channels % V == 0 ? V : 1;
    const int groups = channels / w;
    const int bx = groups < THREADS ? groups : THREADS;
    const int by = THREADS / bx;
    const long long n = rows / channels * t;        // rows of the [B T, C] view
    const long long gx = (n + (long long)by * NWC_UNROLL - 1) / ((long long)by * NWC_UNROLL);
    if (gx > 0x7fffffffLL) return int(cudaErrorInvalidValue);
    const dim3 block(bx, by);
    if (w == V)
      snake_nwc_kernel<Tin, Tout, V><<<unsigned(gx), block, 0, s>>>(
          static_cast<const Tin*>(x), static_cast<const float*>(alpha), static_cast<Tout*>(y), n,
          channels, floor);
    else
      snake_nwc_kernel<Tin, Tout, 1><<<unsigned(gx), block, 0, s>>>(
          static_cast<const Tin*>(x), static_cast<const float*>(alpha), static_cast<Tout*>(y), n,
          channels, floor);
    return int(cudaGetLastError());
  }
  constexpr long long TILE = (long long)THREADS * UNROLL * In<Tin>::V;
  const long long gx = (t + TILE - 1) / TILE;
  if (gx > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  const dim3 grid(unsigned(gx), unsigned(rows < MAX_GRID_Y ? rows : MAX_GRID_Y));
  snake_kernel<Tin, Tout><<<grid, THREADS, 0, s>>>(
      static_cast<const Tin*>(x), static_cast<const float*>(alpha), static_cast<Tout*>(y), rows,
      channels, t, floor, aligned);
  return int(cudaGetLastError());
}

}  // namespace

// x: [rows / channels, channels, t] on the current device, NCW (nwc = 0:
// contiguous) or NWC (nwc = 1: the memory of [rows / channels, t,
// channels]), bf16 (x_bf16 = 1) or float32; alpha: float32 [channels]; y: a
// new tensor of x's shape and layout, bf16 (y_bf16 = 1) or float32, not
// aliasing x.  One launch on `stream`, without synchronising; returns its
// cudaError_t (0 on success).
extern "C" int snake_forward(const void* x, int x_bf16, const void* alpha, void* y, int y_bf16,
                             long long rows, int channels, long long t, float floor, int nwc,
                             void* stream) {
  if (rows <= 0 || channels <= 0 || t <= 0 || rows % channels) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && y_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, alpha, y, rows, channels, t, floor, nwc, s);
  if (x_bf16)
    return launch<__nv_bfloat16, float>(x, alpha, y, rows, channels, t, floor, nwc, s);
  if (y_bf16)
    return launch<float, __nv_bfloat16>(x, alpha, y, rows, channels, t, floor, nwc, s);
  return launch<float, float>(x, alpha, y, rows, channels, t, floor, nwc, s);
}
