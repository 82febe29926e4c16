// attn_core.cuh: the bf16 attention core for Hopper (sm_90a) shared by
// attn_rows.cu (port of egregora_tpu/ops/attn_pallas.py::flash_rows) and
// attn_online.cu (port of egregora_tpu/ops/attn_flash.py::flash_online).
// Both compute exact softmax attention [BH, N, D] -> [BH, N, D] in bf16
// with an f32 online softmax over key tiles; they differ only in the
// rounding a Numerics policy sets: the initial running max (-inf or
// -1e30) and whether the normaliser l sums the f32 weights or the
// weights rounded to bf16 (what the P.V product sees).
//
// Bound on the H100: 4*BH*N^2*D operations at 989 TFLOP/s (bf16 tensor
// cores) against q, k, v read once and o written once (8*BH*N*D bytes) at
// 3.35 TB/s; every shape of the FlashSR path (N >= 512) is bound by the
// operations, so the design keeps the tensor cores fed:
//
// - A block owns 64 q rows: a producer and one consumer warpgroup (two
//   at D = 512).  The producer's lane 0 issues TMA copies (tensor maps
//   over [BH, N, D], boxes of one 64- or 32-column panel, 128- or 64-byte
//   swizzled) of the block's Q once and of each K/V tile into a ring of
//   STAGES = 2 slots, each with
//   a "full" mbarrier (the copy's bytes) and an "empty" one (one arrival
//   per consumer warp), so the next tile loads while the current one is
//   multiplied.  TMA's zero fill past N stands in for bounds checks;
//   scores of keys >= N are masked to -inf and rows >= N never stored.
//   The producer is one warp beside one consumer warpgroup, a whole
//   warpgroup beside two, so that setmaxnreg can move its registers to
//   the consumers (240 each, where the compiler gives 384 threads 168).
// - The consumer warpgroup holds 64 rows.  S = Q K^T runs on wgmma with
//   both operands in shared memory (K-major B), into f32 registers; the
//   online softmax runs on those registers (quad shuffles for the row
//   max and sum); P is packed to bf16 in registers, whose accumulator
//   layout is the register-A layout of the next wgmma, and O += P V reads
//   V from shared memory in its loaded row-major layout with bf16's
//   transpose-B flag (MN-major B): no transposed copy.  O stays in f32
//   registers for the whole key loop at every D.
// - D <= 256: one consumer warpgroup a block (at D = 256 its O is 64x256
//   f32, 128 registers a thread).  128-row blocks of two warpgroups
//   sharing the ring measured slower at every FlashSR shape: 384-thread
//   blocks cap the compiler at 168 registers a thread.
// - D = 512 (SPLIT): O's 512 columns do not fit one warpgroup, so two
//   warpgroups share 64 rows and own 256 columns each.  Each contracts
//   its half of D for S; the halves are summed through shared memory
//   (a double-buffered 32 KB exchange, one named barrier a tile instead
//   of two for a single buffer), and since a+b == b+a both warpgroups
//   hold bit-identical S, max and P.  Shared memory: Q 64 KB + 2 stages
//   of K and V at 32 keys (128 KB) + the exchange (32 KB) = 224 KB.  Even
//   with 240 registers (setmaxnreg) ptxas spills ~70 bytes a thread
//   across the exchange's barrier and serialises some wgmma (C7512).
//
// Each wgmma batch is followed by wgmma.wait_group 0: no overlap of the
// softmax with the next product inside a warpgroup; the loads, and other
// blocks on the SM where they fit (D <= 128), overlap instead.  Per-row
// state is f32; every product accumulates in f32.
#pragma once

#include <cuda_bf16.h>
#include <math_constants.h>

#include "sm90.cuh"

namespace attn_core {

// ---- block geometry ---------------------------------------------------------

template <int D_, int BK_>
struct Config {
  static constexpr int D = D_, BK = BK_;
  static constexpr int BQ = 64;                    // q rows a block: wgmma's M
  static constexpr bool SPLIT = D > 256;           // two warpgroups on the rows, D/2 each
  static constexpr int NWG = SPLIT ? 2 : 1;        // consumer warpgroups
  static constexpr int DW = D / NWG;               // QK depth and O columns of a warpgroup
  // + the producer: one warp, or beside two consumer warpgroups a whole
  // warpgroup, whose registers setmaxnreg moves to them
  static constexpr int THREADS = NWG * 128 + (SPLIT ? 128 : 32);
  static constexpr int SW = D >= 64 ? 128 : 64;    // swizzle span: bytes of a panel row
  static constexpr int PW = SW / 2;                // bf16 columns of a panel
  static constexpr int PANELS = D / PW;
  static constexpr int STAGES = 2;
  static constexpr int NS = BK / 2;                // S registers a thread (64 x BK / 128)
  static constexpr int NO = DW / 2;                // O registers a thread
  static constexpr uint32_t Q_BYTES = 64u * D * 2;
  static constexpr uint32_t KV_BYTES = uint32_t(BK) * D * 2;   // K or V, one stage
  static constexpr uint32_t X_BYTES = SPLIT ? 2u * 2u * 64u * BK * 4u : 0u;
  static constexpr uint32_t q_off = 0;             // [panel][64][SW]
  static constexpr uint32_t k_off = q_off + Q_BYTES;               // [stage][panel][BK][SW]
  static constexpr uint32_t v_off = k_off + STAGES * KV_BYTES;
  static constexpr uint32_t x_off = v_off + STAGES * KV_BYTES;     // [buf][wg][NS/4][128] float4
  static constexpr uint32_t bar_off = x_off + X_BYTES;             // q, full[ST], empty[ST]
  static constexpr uint32_t bytes = bar_off + 8 * (1 + 2 * STAGES) + 1024;  // + 1 KB to align
  static_assert(D % 32 == 0 && D <= 512, "head dim");
  static_assert(BK % 16 == 0 && BK >= 32 && BK <= 128, "key tile");
  static_assert(DW <= 256, "O of a warpgroup fits its registers");
  static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0, "swizzle atoms stay aligned");
  static_assert(bytes <= 232448, "tile set exceeds 227 KB of shared memory");
};

using namespace sm90;

// d[N/2] (64 x N f32, the accumulator fragment) = / += A x B, k = 16:
//   ss: A [64 x 16] and B [N x 16] K-major in shared memory;
//   rs: A in registers (the m16n8k16 A fragment of each warp's 16 rows),
//       B [16 x N] MN-major (N contiguous) in shared memory.
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
}

// ---- the kernel -------------------------------------------------------------

// Numerics: static float m_init() (initial running max) and
// static constexpr bool SUM_ROUNDED (l sums the bf16-rounded weights).
template <int D, int BK, class Numerics>
__global__ void __launch_bounds__(Config<D, BK>::THREADS, 1)
attn_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int n,
            float scale) {
  using C = Config<D, BK>;
  constexpr int SW = C::SW, PW = C::PW, BKS = BK * SW;   // BKS: bytes of a K/V panel
  constexpr uint32_t LAYOUT = SW == 128 ? 1 : 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;           // swizzle atoms: 1 KB aligned
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t q_s = base + C::q_off, k_s = base + C::k_off, v_s = base + C::v_off;
  const uint32_t bar_q = base + C::bar_off;
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_q + 8 * (1 + C::STAGES);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, q0 = blockIdx.x * 64;
  const int ntiles = (n + BK - 1) / BK;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, C::NWG * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= C::NWG * 4) {
    // producer: Q once, then K and V tile by tile into the ring
    if constexpr (C::SPLIT) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == C::NWG * 4 && lane == 0) {
      mbar_expect_tx(bar_q, C::Q_BYTES);
      for (int p = 0; p < C::PANELS; ++p)
        tma_load(q_s + p * 64 * SW, &tq, p * PW, q0, bh, bar_q);
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % C::STAGES;
        if (it >= C::STAGES) mbar_wait(bar_empty + 8 * s, ((it / C::STAGES) - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, 2 * C::KV_BYTES);
        for (int p = 0; p < C::PANELS; ++p) {
          tma_load(k_s + s * C::KV_BYTES + p * BKS, &tk, p * PW, it * BK, bh, full);
          tma_load(v_s + s * C::KV_BYTES + p * BKS, &tv, p * PW, it * BK, bh, full);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg (its DW columns of D), warp wq of it (rows
  // 16 wq .. 16 wq + 15), g = lane / 4 and t = lane % 4 of the fragments
  if constexpr (C::SPLIT) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3;
  const int col0 = wg * C::DW;                           // first column of the warpgroup
  const int panel0 = col0 / PW;                          // first panel of its columns
  const uint32_t q_wg = q_s + panel0 * 64 * SW;

  float oacc[C::NO];
#pragma unroll
  for (int i = 0; i < C::NO; ++i) oacc[i] = 0.f;
  float m0 = Numerics::m_init(), m1 = Numerics::m_init();   // rows g and g + 8
  float l0 = 0.f, l1 = 0.f;

  mbar_wait(bar_q, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % C::STAGES;
    mbar_wait(bar_full + 8 * s, (it / C::STAGES) & 1);
    const uint32_t kb = k_s + s * C::KV_BYTES + panel0 * BKS;
    const uint32_t vb = v_s + s * C::KV_BYTES + panel0 * BKS;

    // S = Q K^T over this warpgroup's DW columns of D
    float sacc[C::NS];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::DW / 16; ++kk) {
      const uint32_t p = (kk * 16) / PW, off = ((kk * 16) % PW) * 2;
      Wgmma<BK>::ss(sacc, smem_desc(q_wg + p * 64 * SW + off, 16, 8 * SW, LAYOUT),
                    smem_desc(kb + p * BKS + off, 16, 8 * SW, LAYOUT), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<C::NS>(sacc);

    if constexpr (C::SPLIT) {
      // add the other warpgroup's half: the same fragment slots, so
      // thread i of each warpgroup holds the same elements
      float4* xs = reinterpret_cast<float4*>(smem + C::x_off);
      const int buf = it & 1, wt = tid & 127;
      float4* mine = xs + (buf * 2 + wg) * (C::NS / 4) * 128 + wt;
      const float4* other = xs + (buf * 2 + (wg ^ 1)) * (C::NS / 4) * 128 + wt;
#pragma unroll
      for (int e = 0; e < C::NS / 4; ++e)
        mine[e * 128] = make_float4(sacc[4 * e], sacc[4 * e + 1], sacc[4 * e + 2], sacc[4 * e + 3]);
      named_bar_sync(1, 256);
#pragma unroll
      for (int e = 0; e < C::NS / 4; ++e) {
        const float4 x = other[e * 128];
        sacc[4 * e] += x.x;
        sacc[4 * e + 1] += x.y;
        sacc[4 * e + 2] += x.z;
        sacc[4 * e + 3] += x.w;
      }
    }

    // online softmax: scale after the product, mask keys past N, running
    // max (rows g, g + 8 of the warp's 16: four lanes a row) and normaliser
    const int valid = n - it * BK;
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        sacc[4 * j + e] = col < valid ? sacc[4 * j + e] * scale : -CUDART_INF_F;
      }
      mx0 = fmaxf(mx0, fmaxf(sacc[4 * j], sacc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));   // finite: every tile has a key
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float alpha0 = __expf(m0 - mn0);        // 0 on the first tile
    const float alpha1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    // P = exp(S - m) rounded to bf16, straight into the register-A
    // fragments of P V: n-tiles 2kk and 2kk + 1 of S are k-step kk's A
    uint32_t pf[BK / 16][4];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* sj = sacc + 4 * (2 * kk + h);
        const float e0 = __expf(sj[0] - mn0), e1 = __expf(sj[1] - mn0);
        const float e2 = __expf(sj[2] - mn1), e3 = __expf(sj[3] - mn1);
        const uint32_t r0 = pack_bf16(e0, e1), r1 = pack_bf16(e2, e3);
        pf[kk][2 * h] = r0;
        pf[kk][2 * h + 1] = r1;
        if constexpr (Numerics::SUM_ROUNDED) {
          const float2 f0 = unpack_bf16(r0), f1 = unpack_bf16(r1);
          sum0 += f0.x + f0.y;
          sum1 += f1.x + f1.y;
        } else {
          sum0 += e0 + e1;
          sum1 += e2 + e3;
        }
      }
    }
    l0 = l0 * alpha0 + quad_sum(sum0);
    l1 = l1 * alpha1 + quad_sum(sum1);

    // O = O * alpha + P V over this warpgroup's DW columns
#pragma unroll
    for (int j = 0; j < C::NO / 4; ++j) {
      oacc[4 * j] *= alpha0;
      oacc[4 * j + 1] *= alpha0;
      oacc[4 * j + 2] *= alpha1;
      oacc[4 * j + 3] *= alpha1;
    }
    fence_regs<C::NO>(oacc);
    fence_regs<BK / 4>(&pf[0][0]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      Wgmma<C::DW>::rs(oacc, pf[kk], smem_desc(vb + kk * 16 * SW, BKS, 8 * SW, LAYOUT));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<C::NO>(oacc);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);   // this warp is done with the slot
  }

  // O / l, rounded to bf16 once
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int row0 = q0 + 16 * wq + g, row1 = row0 + 8;
  __nv_bfloat16* ob = o + size_t(bh) * size_t(n) * D + col0 + 2 * t;
#pragma unroll
  for (int j = 0; j < C::NO / 4; ++j) {
    if (row0 < n)
      *reinterpret_cast<__nv_bfloat162*>(ob + size_t(row0) * D + 8 * j) =
          __floats2bfloat162_rn(oacc[4 * j] * inv0, oacc[4 * j + 1] * inv0);
    if (row1 < n)
      *reinterpret_cast<__nv_bfloat162*>(ob + size_t(row1) * D + 8 * j) =
          __floats2bfloat162_rn(oacc[4 * j + 2] * inv1, oacc[4 * j + 3] * inv1);
  }
}

// ---- host side --------------------------------------------------------------

// a tensor map over contiguous bf16 [bh, n, d] whose box is one panel of
// `rows` rows; zero fill past n
inline int make_map(CUtensorMap* map, const void* ptr, int bh, int n, int d, int rows, int sw) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return int(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {cuuint64_t(d), cuuint64_t(n), cuuint64_t(bh)};
  const cuuint64_t strides[2] = {cuuint64_t(d) * 2, cuuint64_t(n) * cuuint64_t(d) * 2};
  const cuuint32_t box[3] = {cuuint32_t(sw / 2), cuuint32_t(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : int(cudaErrorInvalidValue);
}

// the block layout at tile (D, BK), for the libraries' *_bf16_layout
// queries: q rows, threads, dynamic shared memory (the layout plus 1 KB
// of alignment slack)
template <int D, int BK>
void layout(int* out) {
  out[0] = Config<D, BK>::BQ;
  out[1] = Config<D, BK>::THREADS;
  out[2] = int(Config<D, BK>::bytes);
}

// q, k, v, o: contiguous bf16 [bh, n, D]; returns a cudaError_t
template <int D, int BK, class Numerics>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int n, float scale,
           cudaStream_t stream) {
  using C = Config<D, BK>;
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, bh, n, D, C::BQ, C::SW);
  if (!err) err = make_map(&tk, k, bh, n, D, BK, C::SW);
  if (!err) err = make_map(&tv, v, bh, n, D, BK, C::SW);
  if (err) return err;
  auto kernel = attn_kernel<D, BK, Numerics>;
  static int configured = -1;   // the device whose shared-memory limit is raised
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev != configured) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::bytes));
    if (e == cudaSuccess) configured = dev;
  }
  if (e != cudaSuccess) return int(e);
  const dim3 grid((n + C::BQ - 1) / C::BQ, bh);
  kernel<<<grid, C::THREADS, C::bytes, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o),
                                                 n, scale);
  return int(cudaGetLastError());
}

}  // namespace attn_core
