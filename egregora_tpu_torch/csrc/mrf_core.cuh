// mrf_core.cuh: the bf16 HiFi-GAN MRF conv chain for Hopper (sm_90a),
// shared by both entries of mrf.cu: mrf_fused_cm_bf16 (port of
// egregora_tpu/ops/mrf_pallas.py::mrf_fused_cm, [B, C, T], every branch and
// their mean in one launch) and mrf_branch_rows_bf16 (port of
// egregora_tpu/ops/mrf_rows.py::mrf_branch_rows, [B, T, C], one branch a
// launch).  They differ only in the layout of x and y and in the rounding a
// policy sets: _conv_circ rounds each conv's f32 sum to bf16 and then adds
// the bf16 bias, _conv_rows starts the f32 sum at the bias and rounds once.
//
// What it computes, for each branch of kernel size k and each dilation d:
//   h += conv_k,1(leaky(conv_k,d(leaky(h)))),  leaky(v) = max(v, 0.1 v),
// with 'SAME' zero padding at every conv, every conv output re-zeroed
// outside the signal [0, T), and the branches summed and divided in bf16.
//
// Bound on the H100: 12 k C^2 T B FLOPs a branch (252 C^2 T B for k = 3, 7,
// 11) at 989 TFLOP/s against one bf16 read and write of [B, C, T]: 63 C
// FLOP a byte, so every C >= 16 is bound by the operations.  The design:
//
// - A block owns one (batch item, time tile of TT samples) and holds the
//   tile with a halo of H = max_b sum_d ((k-1)/2)(d+1) a side (the left one
//   rounded up to HL, a multiple of 8) in shared memory: `cur` (the
//   residual stream h), `lk` (leaky(h), where the plan keeps it) and `tmp`
//   (leaky of the dilated conv's output), time-major rows of C bf16 in
//   panels of 64 channels ([panel][rows][128 B]; one panel of 32 or 64 B
//   rows at C = 16, 32), the 16-byte chunks of each row XOR-swizzled by
//   the row as TMA's 128/64/32-byte swizzle does, so that any 8
//   consecutive rows of one chunk sit in 8 distinct bank groups.  Each
//   conv computes only the rows the rest of the chain still needs (the
//   window shrinks by the conv's reach), rounded up to 64-row M tiles;
//   rows beyond the tile clamp their reads and skip their writes, and hold
//   values that never reach a needed row.
// - A conv is, for each tap j, the rows shifted by j d - (k-1)/2 d times
//   W_j [C_out x C_in].  Two consumer warpgroups run it on wgmma
//   (m64nNk16, N = C up to 128, chunks of 128 or 64 output channels
//   above), one product a k16 slice of a tap and an M tile: A from
//   registers, loaded with ldmatrix.x4 at per-lane row addresses (any
//   shift is free), in two register sets so that one loads while the
//   other's product runs; B, the weights, K-major from shared memory.  The
//   dilated conv reads `lk`; where the plan has no room for it, it reads
//   `cur` and passes each fragment through leaky in registers.
// - The weights stream by TMA: one producer warp loads slices [q taps x N
//   output channels x 64 (or C) input channels] of the packed [k][C_out]
//   [C_in] weights, swizzled, into a ring of 2 to 8 slots with full /
//   empty mbarriers.  Each slice serves every M tile of the block (up to
//   MT a warpgroup, whose accumulators stay in registers) before its slot
//   is released, two products into the next slice: the weights cross L2
//   once per block and conv, not once per 16 rows, and the products run on
//   across slices.
// - The epilogue works on the f32 accumulators in registers: the policy's
//   rounding and bias, the mask outside [0, T), then leaky (dilated conv,
//   into tmp) or the residual add (unit conv, into cur in place, and its
//   leaky into lk).
// - The [B, T, C] entry loads and stores rows with 16-byte vector accesses;
//   the [B, C, T] entry stages the tile channel-major in `tmp` with 16-byte
//   loads and transposes it with ldmatrix.trans, and writes back the same
//   way through `tmp`.  x is re-read from L2 for each branch.  The branch
//   sum lives in a fourth tile of TT rows.
// - The time tile is sized by C and H: the largest multiple of 16 (at most
//   2 MT 64 - 128, so that the first conv's rows fit one pass of the
//   accumulators, and no longer than T needs) whose tiles fit 227 KB;
//   `lk` is kept where the tile it leaves is no shorter than 256 samples
//   or than the tile without it; the ring grows into what is left.  One
//   block of 288 threads an SM.  ptxas gives this kernel 168 registers a
//   thread at 288 threads as at 384, and setmaxnreg in a producer
//   warpgroup does not raise that; 256 threads (255 registers) with a
//   consumer lane issuing the copies measured slower at every shape.
//   ops/mrf_fused.py's bf16_plan mirrors make_plan, and mrf_bf16_layout
//   reports it.
#pragma once

#include <cuda_bf16.h>

#include "sm90.cuh"

namespace mrf_core {

using namespace sm90;

constexpr int MAX_BRANCHES = 4;
constexpr int MAX_DILS = 4;
constexpr int CONSUMERS = 256;                 // two warpgroups
constexpr int THREADS = CONSUMERS + 32;        // and the producer warp
constexpr int MAX_STAGES = 8;                  // slots of the weight ring
constexpr int SMEM_LIMIT = 232448;             // 227 KB a block

struct Spec {
  int nb;                          // branches
  int nd;                          // dilation iterations per branch
  int k[MAX_BRANCHES];
  int d[MAX_DILS];
  long long w_off[MAX_BRANCHES];   // element offset of a branch's weights
};

// a block's schedule and shared-memory layout (byte offsets from a 1 KB
// aligned base)
struct Plan {
  int c;            // channels the kernel runs (the wrapper pads to it)
  int nc;           // output channels of one accumulator pass (wgmma N)
  int pb;           // bytes of a panel row (64 channels, or C below 64)
  int q;            // taps a weight slice holds
  int stages;       // slots of the weight ring
  int mt;           // M tiles a warpgroup holds in registers
  int tt, hl, halo, rows, sp;   // time tile, left halo, halo, tile rows, staging pitch
  int lk;           // 1: leaky(h) kept in its own tile, updated with h
  int lk_off, tmp_off, sum_off, ring_off, bar_off, bytes, slice_bytes;
};

// ---- host side: the plan ----------------------------------------------------

inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// channels the kernel runs for C: 16, 32, or a multiple of 64
inline int kernel_width(int c) { return c <= 16 ? 16 : c <= 32 ? 32 : round_up(c, 64); }

inline bool fit(Plan& p, int tt, int nb, bool cm) {
  p.tt = tt;
  p.rows = round_up(p.hl + tt + p.halo, 16);
  p.sp = (p.rows / 8) % 2 ? p.rows : p.rows + 8;   // odd multiple of 16 bytes
  const int cur = p.rows * p.c * 2;
  const int tmp = cm && p.c * p.sp * 2 > cur ? p.c * p.sp * 2 : cur;
  const int sum = nb > 1 ? tt * p.c * 2 : 0;
  p.lk_off = round_up(cur, 1024);
  p.tmp_off = p.lk_off + (p.lk ? round_up(cur, 1024) : 0);
  p.sum_off = p.tmp_off + round_up(tmp, 1024);
  p.ring_off = p.sum_off + round_up(sum, 1024);
  p.bar_off = p.ring_off + p.stages * p.slice_bytes;
  p.bytes = p.bar_off + 16 * p.stages + 1024;      // + 1 KB to align the base
  return p.bytes <= SMEM_LIMIT;
}

// the longest tile that fits, with or without the leaky tile, at the
// ring's least depth (a 32 KB ring, two slots where that leaves none)
inline int longest_tile(Plan& p, int t, int nb, bool cm, int lk) {
  const int cap = 2 * p.mt * 64 - 128;
  const int need = round_up(t, 16);
  p.lk = lk;
  const int ring = 32768 / p.slice_bytes;
  for (p.stages = ring; p.stages >= 2; p.stages = p.stages > 2 ? 2 : 0)
    for (int tt = cap < need ? cap : need; tt >= 16; tt -= 16)
      if (fit(p, tt, nb, cm)) return tt;
  return 0;
}

// the plan for C = kernel_width(C) channels, T samples, halo H and nb
// branches, channel-major (cm) or not; false where no tile fits.  The
// leaky tile is kept where the tile it leaves is no shorter than 256
// samples or than the tile without it; the ring then grows into what is
// left, up to MAX_STAGES.
inline bool make_plan(Plan& p, int c, int t, int halo, int nb, bool cm) {
  if (c != kernel_width(c) || t <= 0 || halo < 0 || nb <= 0) return false;
  p.c = c;
  p.nc = c <= 128 ? c : (c % 128 == 0 ? 128 : 64);
  p.pb = (c < 64 ? c : 64) * 2;
  p.q = p.nc < c ? 1 : p.nc == 16 ? 16 : p.nc == 32 ? 8 : p.nc == 64 ? 2 : 1;
  p.slice_bytes = p.q * p.nc * p.pb;
  p.mt = p.nc == 16 ? 8 : p.nc == 32 ? 6 : p.nc == 64 ? 4 : 2;
  p.halo = halo;
  p.hl = round_up(halo, 8);
  const int plain = longest_tile(p, t, nb, cm, 0);
  const int with_lk = longest_tile(p, t, nb, cm, 1);
  const int lk = with_lk && with_lk >= (plain < 256 ? plain : 256);
  const int tt = lk ? with_lk : plain;
  if (!tt) return false;
  longest_tile(p, t, nb, cm, lk);                  // sets lk and the ring's least depth
  fit(p, tt, nb, cm);
  while (p.stages < MAX_STAGES) {
    ++p.stages;
    if (!fit(p, tt, nb, cm)) {
      --p.stages;
      break;
    }
  }
  return fit(p, tt, nb, cm);
}

// ---- device side ------------------------------------------------------------

template <int NC>
struct Geo {
  static constexpr int PB = NC == 16 ? 32 : NC == 32 ? 64 : 128;   // bytes of a panel row
  static constexpr int CPR = PB / 16;                              // 16-B chunks of it
  static constexpr int KK = PB / 32;                               // k16 steps a panel
  static constexpr int MT = NC == 16 ? 8 : NC == 32 ? 6 : NC == 64 ? 4 : 2;
  static constexpr uint32_t LAYOUT = PB == 128 ? 1 : PB == 64 ? 2 : 3;   // wgmma swizzle
};

// byte offset of 16-byte chunk `ch` (over all C) of row `row` in a
// [panel][rows][PB] tile: the chunk index XOR (row's byte offset >> 7),
// TMA's swizzle of the same span
template <int PB>
__device__ __forceinline__ uint32_t act_off(int row, int ch, int rows) {
  constexpr int CPR = PB / 16;
  const int panel = ch / CPR, c = ch % CPR;
  return uint32_t((panel * rows + row) * PB) + (uint32_t(c ^ ((row * PB >> 7) & (CPR - 1))) << 4);
}

__device__ __forceinline__ float leaky(float v) { return v > 0.f ? v : v * 0.1f; }

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

__device__ __forceinline__ uint32_t leaky2(uint32_t u) {
  const float2 f = unpack2(u);
  return pack2(leaky(f.x), leaky(f.y));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ uint4 add8(uint4 a, uint4 b) {   // bf16(a + b), 8 lanes
  uint32_t* pa = reinterpret_cast<uint32_t*>(&a);
  const uint32_t* pb = reinterpret_cast<const uint32_t*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = unpack2(pa[i]), y = unpack2(pb[i]);
    pa[i] = pack2(x.x + y.x, x.y + y.y);
  }
  return a;
}

__device__ __forceinline__ uint32_t div2(uint32_t u, float n) {
  const float2 f = unpack2(u);
  return pack2(f.x / n, f.y / n);
}

// d[N/2] (64 x N f32, the accumulator fragment) += A x B, k = 16: A in
// registers (the m16n8k16 A fragment of each warp's 16 rows), B [N x 16]
// K-major in shared memory
template <int N>
struct WgmmaRS;

template <>
struct WgmmaRS<16> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaRS<32> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaRS<64> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaRS<128> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

// ---- the kernel -------------------------------------------------------------

// Rounding: static constexpr bool ROUND_THEN_BIAS (_conv_circ) or not
// (_conv_rows).  CM: x, y are [B, C, T], else [B, T, C].  Grid (ceil(T /
// TT), B); tw: the weights as [rows][C] bf16, boxes [q NC][PB / 2].
template <int NC, class Rounding, bool CM>
__global__ void __launch_bounds__(THREADS, 1)
mrf_kernel(const __grid_constant__ CUtensorMap tw, const __nv_bfloat16* __restrict__ x,
           __nv_bfloat16* __restrict__ y, const float* __restrict__ bias, int t, int vec,
           Spec sp, Plan p) {
  using G = Geo<NC>;
  constexpr int PB = G::PB, MT = G::MT, KK = G::KK;
  constexpr bool CIRC = Rounding::ROUND_THEN_BIAS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;           // swizzle atoms: 1 KB aligned
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_full = base + p.bar_off, bar_empty = bar_full + 8 * p.stages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = p.c, rows = p.rows, tt = p.tt;
  const int cpr = c / 8;                                   // 16-B chunks of a row
  const int t0 = blockIdx.x * tt, g0 = t0 - p.hl;          // signal index of tile row 0
  const size_t item = size_t(blockIdx.y) * size_t(c) * size_t(t);
  x += item;
  y += item;

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    // producer: every weight slice, in the order the consumers take them
    if (lane == 0) {
      int it = 0;
      for (int bi = 0; bi < sp.nb; ++bi) {
        const int k = sp.k[bi], hw = (k - 1) / 2;
        int reach = 0;
        for (int m = 0; m < sp.nd; ++m) reach += hw * (sp.d[m] + 1);
        const int wbase = int(sp.w_off[bi] / c);
        for (int m = 0; m < sp.nd; ++m) {
          for (int u = 0; u < 2; ++u) {
            reach -= hw * (u ? 1 : sp.d[m]);
            const int tiles = (tt + 2 * reach + 63) / 64;
            const int passes = (tiles + 2 * MT - 1) / (2 * MT);
            const int wrow = wbase + (2 * m + u) * k * c;
            for (int pass = 0; pass < passes; ++pass)
              for (int n0 = 0; n0 < c; n0 += NC)
                for (int j0 = 0; j0 < k; j0 += p.q)
                  for (int kp = 0; kp < c; kp += PB / 2) {
                    const int s = it % p.stages;
                    if (it >= p.stages) mbar_wait(bar_empty + 8 * s, ((it / p.stages) - 1) & 1);
                    const uint32_t full = bar_full + 8 * s;
                    mbar_expect_tx(full, p.slice_bytes);
                    tma_load_2d(base + p.ring_off + s * p.slice_bytes, &tw, kp,
                                wrow + j0 * c + n0, full);
                    ++it;
                  }
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg, warp wq of it (rows 16 wq .. 16 wq + 15 of
  // each M tile), g = lane / 4 and tq = lane % 4 of the fragments
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, tq = lane & 3;
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;    // ldmatrix: the lane's row
  const int lch = lane >> 4;                               // and 16-B chunk
  const uint32_t cur = 0, lkb = p.lk_off, tmp = p.tmp_off, sum = p.sum_off;
  auto sm32 = [&](uint32_t off) { return reinterpret_cast<uint32_t*>(smem + off); };
  auto sm128 = [&](uint32_t off) { return reinterpret_cast<uint4*>(smem + off); };
  auto sync = [] { named_bar_sync(1, CONSUMERS); };
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  // a slot is released (one arrival a warp) once no product reading it
  // can still run
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
  };

  int it = 0;                                              // weight slices taken
  for (int bi = 0; bi < sp.nb; ++bi) {
    // the input tile, rows [0, rows) from signal index g0, zero outside [0, T)
    if (CM) {
      const int per = rows / 8;                            // 8-sample chunks of a channel
      for (int i = tid; i < c * per; i += CONSUMERS) {
        const int ch = i / per, u8 = i - ch * per, gi = g0 + 8 * u8;
        const __nv_bfloat16* src = x + size_t(ch) * t + gi;
        uint4 v = zero4;
        if (vec) {
          if (gi >= 0 && gi + 8 <= t) v = __ldg(reinterpret_cast<const uint4*>(src));
        } else {
          __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (gi + j >= 0 && gi + j < t) e[j] = src[j];
        }
        *sm128(tmp + (ch * p.sp + 8 * u8) * 2) = v;
      }
      sync();
      // staged [C][sp] -> cur: 16 channels x 16 rows a warp and step
      const int cb16 = c / 16, units = cb16 * (rows / 16), mi = lane >> 3;
      for (int u = warp; u < units; u += CONSUMERS / 32) {
        const int cb = (u % cb16) * 16, r0 = (u / cb16) * 16;
        uint32_t v[4];
        ldsm_x4_trans(v, base + tmp +
                             ((cb + 8 * (mi & 1) + (lane & 7)) * p.sp + r0 + 8 * (mi >> 1)) * 2);
#pragma unroll
        for (int i = 0; i < 4; ++i) {      // channels cb + 8(i&1) + 2tq, +1 at row r0 + 8(i>>1) + g
          const int row = r0 + 8 * (i >> 1) + g, ch = cb + 8 * (i & 1) + 2 * tq;
          const uint32_t off = act_off<PB>(row, ch >> 3, rows) + (ch & 7) * 2;
          *sm32(cur + off) = v[i];
          if (p.lk) *sm32(lkb + off) = leaky2(v[i]);
        }
      }
    } else {
      for (int i = tid; i < rows * cpr; i += CONSUMERS) {
        const int r = i / cpr, ch = i - r * cpr, gi = g0 + r;
        uint4 v = zero4;
        if (gi >= 0 && gi < t) {
          const __nv_bfloat16* src = x + size_t(gi) * c + ch * 8;
          if (vec) {
            v = __ldg(reinterpret_cast<const uint4*>(src));
          } else {
            __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
            for (int j = 0; j < 8; ++j) e[j] = src[j];
          }
        }
        const uint32_t off = act_off<PB>(r, ch, rows);
        *sm128(cur + off) = v;
        if (p.lk) {
          uint32_t* e = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
          for (int j = 0; j < 4; ++j) e[j] = leaky2(e[j]);
          *sm128(lkb + off) = v;
        }
      }
    }
    sync();

    const int k = sp.k[bi], hw = (k - 1) / 2;
    int reach = 0;                                         // receptive reach still ahead
    for (int m = 0; m < sp.nd; ++m) reach += hw * (sp.d[m] + 1);
    for (int m = 0; m < sp.nd; ++m) {
      for (int u = 0; u < 2; ++u) {                        // u = 0: dilated conv, 1: unit conv
        const int d = u ? 1 : sp.d[m], shift = hw * d;
        reach -= shift;
        const int lo = p.hl - reach;                       // first row the chain still needs
        const int tiles = (tt + 2 * reach + 63) / 64;
        const int passes = (tiles + 2 * MT - 1) / (2 * MT);
        const uint32_t src = base + (u ? tmp : p.lk ? lkb : cur), dst = u ? cur : tmp;
        const float* cb = bias + size_t((bi * sp.nd + m) * 2 + u) * c;
        for (int pass = 0; pass < passes; ++pass) {
          for (int n0 = 0; n0 < c; n0 += NC) {
            float acc[MT][NC / 2];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int j = 0; j < NC / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e)     // _conv_rows: the f32 sum starts at the bias
                  acc[mt][4 * j + e] = CIRC ? 0.f : __ldg(cb + n0 + 8 * j + 2 * tq + (e & 1));
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) fence_regs<NC / 2>(acc[mt]);   // before any product
            // one product: a k16 slice of one tap for one M tile, its A
            // fragment into register set `a` (through leaky for the dilated
            // conv when no leaky tile is kept), then its wgmma, one commit
            // group.  A set is reloaded two products later, once its group
            // has retired (wait_group 1); a slot's release waits the same
            // way, two products into the next slice, so that the products
            // run on across the slice boundary.
            uint32_t a0[4], a1[4];
            uint32_t panel = src;                          // the A panel of the slice
            int groups = 0, pending = -1, since = 0;
            auto product = [&](uint32_t (&a)[4], float* accm, int row, int chunk, uint32_t bs) {
              wgmma_wait<1>();
              if (pending >= 0 && ++since == 2) {
                release(pending);
                pending = -1;
              }
              const int swz = (row * PB >> 7) & (G::CPR - 1);
              ldsm_x4(a, panel + row * PB + (((chunk + lch) ^ swz) << 4));
              if (!u && !p.lk) {
#pragma unroll
                for (int i = 0; i < 4; ++i) a[i] = leaky2(a[i]);
              }
              fence_regs<4>(a);
              wgmma_fence();
              WgmmaRS<NC>::mma(accm, a, smem_desc(bs, 16, 8 * PB, G::LAYOUT));
              wgmma_commit();
              ++groups;
            };
            for (int j0 = 0; j0 < k; j0 += p.q) {
              const int nt = k - j0 < p.q ? k - j0 : p.q;
              for (int kp = 0; kp < c; kp += PB / 2) {
                const int s = it % p.stages;
                mbar_wait(bar_full + 8 * s, (it / p.stages) & 1);
                const uint32_t slot = base + p.ring_off + s * p.slice_bytes;
                const int ch0 = kp / 8;                    // the slice's first 16-B chunk
                panel = src + (ch0 / G::CPR) * rows * PB;
                const int c0 = ch0 % G::CPR;                // and its place in the A panel
                const int groups0 = groups;
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                  const int ti = pass * 2 * MT + 2 * mt + wg;
                  if (ti >= tiles) continue;
                  const int rbase = lo + 64 * ti + 16 * wq + lrow - shift;
                  for (int jj = 0; jj < nt; ++jj) {
                    int row = rbase + (j0 + jj) * d;
                    row = row < rows ? row : rows - 1;
                    const uint32_t bs = slot + jj * NC * PB;
#pragma unroll
                    for (int kk = 0; kk < KK; ++kk) {
                      if ((KK % 2 == 0 ? kk : groups) & 1)
                        product(a1, acc[mt], row, c0 + 2 * kk, bs + kk * 32);
                      else
                        product(a0, acc[mt], row, c0 + 2 * kk, bs + kk * 32);
                    }
                  }
                }
                if (pending >= 0 || groups - groups0 < 2) {   // too few to retire it
                  wgmma_wait_all();
                  if (pending >= 0) release(pending);
                  release(s);
                  pending = -1;
                } else {
                  pending = s;
                  since = 0;
                }
                ++it;
              }
            }
            wgmma_wait_all();
            if (pending >= 0) release(pending);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) fence_regs<NC / 2>(acc[mt]);
            // epilogue: rounding, bias, mask, then leaky into tmp or the
            // residual add into cur
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              const int ti = pass * 2 * MT + 2 * mt + wg;
              if (ti >= tiles) continue;
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const int row = lo + 64 * ti + 16 * wq + g + 8 * half;
                if (row >= rows) continue;
                const int gi = g0 + row;
                const bool inside = gi >= 0 && gi < t;
#pragma unroll
                for (int j = 0; j < NC / 8; ++j) {
                  const int col = n0 + 8 * j + 2 * tq;
                  float v0 = acc[mt][4 * j + 2 * half], v1 = acc[mt][4 * j + 2 * half + 1];
                  if (CIRC) {        // round the conv, then add the bf16 bias
                    v0 = round_bf16(v0) + round_bf16(__ldg(cb + col));
                    v1 = round_bf16(v1) + round_bf16(__ldg(cb + col + 1));
                  }
                  const float2 yv = unpack2(pack2(v0, v1));
                  const uint32_t off = act_off<PB>(row, col >> 3, rows) + (col & 7) * 2;
                  uint32_t* dp = sm32(dst + off);
                  uint32_t out;
                  if (u) {
                    const float2 h = unpack2(*dp);
                    out = pack2(h.x + yv.x, h.y + yv.y);
                  } else {
                    out = pack2(leaky(yv.x), leaky(yv.y));
                  }
                  *dp = inside ? out : 0u;
                  if (u && p.lk) *sm32(lkb + off) = inside ? leaky2(out) : 0u;
                }
              }
            }
          }
        }
        sync();
      }
    }

    if (sp.nb > 1) {                                       // branch sum, rounded as the JAX sum
      for (int i = tid; i < tt * cpr; i += CONSUMERS) {
        const int r = i / cpr, ch = i - r * cpr;
        const uint4 v = *sm128(cur + act_off<PB>(p.hl + r, ch, rows));
        uint4* a = sm128(sum + act_off<PB>(r, ch, tt));
        *a = bi == 0 ? v : add8(*a, v);
      }
      sync();
    }
  }

  // the branch mean (or the one branch): rows [0, TT) of sum, or [HL, HL +
  // TT) of cur
  const bool mean = sp.nb > 1;
  const float nbf = float(sp.nb);
  const uint32_t src = mean ? sum : cur;
  const int src_rows = mean ? tt : rows, src_r0 = mean ? 0 : p.hl;
  if (CM) {
    // -> staged [C][sp] in tmp (16 rows x 16 channels a warp and step),
    // then 8-sample chunks of each channel to y
    const int cb16 = c / 16, units = cb16 * (tt / 16), mi = lane >> 3;
    for (int u = warp; u < units; u += CONSUMERS / 32) {
      const int cb = (u % cb16) * 16, r0 = (u / cb16) * 16;
      uint32_t v[4];
      ldsm_x4_trans(v, base + src + act_off<PB>(src_r0 + r0 + 8 * (mi & 1) + (lane & 7),
                                                (cb >> 3) + (mi >> 1), src_rows));
#pragma unroll
      for (int i = 0; i < 4; ++i) {        // rows r0 + 8(i&1) + 2tq, +1 of channel cb + 8(i>>1) + g
        const int ch = cb + 8 * (i >> 1) + g, r = r0 + 8 * (i & 1) + 2 * tq;
        *sm32(tmp + (ch * p.sp + r) * 2) = mean ? div2(v[i], nbf) : v[i];
      }
    }
    sync();
    const int per = tt / 8;
    for (int i = tid; i < c * per; i += CONSUMERS) {
      const int ch = i / per, u8 = i - ch * per, gi = t0 + 8 * u8;
      if (gi >= t) continue;
      const uint4 v = *sm128(tmp + (ch * p.sp + 8 * u8) * 2);
      __nv_bfloat16* dst = y + size_t(ch) * t + gi;
      if (vec && gi + 8 <= t) {
        *reinterpret_cast<uint4*>(dst) = v;
      } else {
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
        for (int j = 0; j < 8 && gi + j < t; ++j) dst[j] = e[j];
      }
    }
  } else {
    for (int i = tid; i < tt * cpr; i += CONSUMERS) {
      const int r = i / cpr, ch = i - r * cpr, gi = t0 + r;
      if (gi >= t) continue;
      uint4 v = *sm128(src + act_off<PB>(src_r0 + r, ch, src_rows));
      if (mean) {
        uint32_t* pv = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
        for (int j = 0; j < 4; ++j) pv[j] = div2(pv[j], nbf);
      }
      __nv_bfloat16* dst = y + size_t(gi) * c + ch * 8;
      if (vec) {
        *reinterpret_cast<uint4*>(dst) = v;
      } else {
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
        for (int j = 0; j < 8; ++j) dst[j] = e[j];
      }
    }
  }
}

// ---- host side: the launch --------------------------------------------------

// x, y: contiguous bf16, [b, C, t] (CM) or [b, t, C]; w: the packed weights
// of sp (w_rows rows of C); bias: float32 [nb][nd][2][C]; p: make_plan's.
// Returns a cudaError_t.
template <int NC, class Rounding, bool CM>
int launch(const void* x, void* y, const void* w, const float* bias, int b, int t,
           const Spec& sp, const Plan& p, long long w_rows, cudaStream_t stream) {
  constexpr int PB = Geo<NC>::PB;
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return int(cudaErrorNotSupported);
  if (reinterpret_cast<uintptr_t>(w) % 16) return int(cudaErrorInvalidValue);
  CUtensorMap tw;
  const cuuint64_t dims[2] = {cuuint64_t(p.c), cuuint64_t(w_rows)};
  const cuuint64_t strides[1] = {cuuint64_t(p.c) * 2};
  const cuuint32_t box[2] = {cuuint32_t(PB / 2), cuuint32_t(p.q * NC)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(&tw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        PB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                  : PB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return int(cudaErrorInvalidValue);
  auto kernel = mrf_kernel<NC, Rounding, CM>;
  static int configured = -1;   // the device whose shared-memory limit is raised
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev != configured) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e == cudaSuccess) configured = dev;
  }
  if (e != cudaSuccess) return int(e);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16 == 0;
  const int vec = aligned && (!CM || t % 8 == 0);
  const dim3 grid((t + p.tt - 1) / p.tt, b);
  kernel<<<grid, THREADS, p.bytes, stream>>>(tw, static_cast<const __nv_bfloat16*>(x),
                                             static_cast<__nv_bfloat16*>(y), bias, t, vec, sp, p);
  return int(cudaGetLastError());
}

}  // namespace mrf_core
