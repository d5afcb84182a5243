// Hopper (sm_90a) primitives shared by the port's flash-attention kernels:
// mbarriers, TMA tile loads, wgmma shared-memory descriptors and products,
// warpgroup register reallocation, and the host helpers that encode the
// TMA tensor maps.
//
// Conventions.  Every operand tile in shared memory is written by TMA
// with the 128-byte swizzle: a (rows, 64) box of 2-byte elements (bf16 or
// f16) whose 128-byte rows are XOR-swizzled in groups of 8 (1024 bytes),
// at a 1024-byte aligned address.  A head dimension above 64 is two such
// boxes side by side (box 0 = columns 0..63, box 1 = 64..127); a head
// dimension below 64 is one box whose columns past D TMA fills with
// zeros.  The same tile is
// read by wgmma either K-major (its rows are the product's M or N index,
// its columns the reduction index: Q and K in Q K^T) or MN-major (its rows
// are the reduction index, its columns N: V in P V, the "tnspB" operand).
//
// The host helpers look cuTensorMapEncodeTiled up at run time with
// cudaGetDriverEntryPoint, so a library that includes this header needs
// no -lcuda.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

// ---------------------------------------------------------------------------
// Device side
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte aligned address at or after p (swizzled TMA tiles
// and wgmma descriptors assume that alignment).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// ---- mbarrier ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Makes the initialised barriers visible to every thread and to TMA.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and expect `bytes` more from TMA in the current phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `phase` has completed.  A barrier starts
// in phase 0, so waiting on parity 1 passes at once (the phase before
// it counts as completed): a producer waits on its "empty" barriers with
// the parity flipped, and its first pass over the ring does not block.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@!P1 bra LAB_WAIT;\n"
      "}\n"
      :: "r"(smem_u32(bar)), "r"(phase) : "memory");
}

// Named barrier `id` (1 to 15; 0 is __syncthreads) over `threads`
// threads, e.g. the 128 of one warpgroup.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// ---- TMA -----------------------------------------------------------------

// One box of a rank-4 tensor map into shared memory; completion adds the
// box's bytes to `bar`'s transaction count.  Coordinates are innermost
// first: (column, row, head, batch).  Elements outside the tensor come
// back as zeros and still count toward the bytes.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---- warpgroup register reallocation ---------------------------------------
// Executed by all four warps of a warpgroup.  ptxas honours it only when
// each role's code is one branch that never rejoins the other (else it
// warns "setmaxnreg ignored", C7508).

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// ---- wgmma -----------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle.  `lbo` and `sbo` in
// bytes.  K-major tiles: sbo = 1024 (the next 8 rows), lbo unused; a
// 16-wide k step inside a 64-column box advances the address by 32 bytes.
// MN-major tiles: sbo = 1024 (the next 8 rows of the reduction index),
// lbo = the distance to the next 64-column box; a 16-deep k step
// advances the address by 16 rows (2048 bytes).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pins registers that an in-flight wgmma reads or writes: without it the
// compiler may read an accumulator before wgmma_wait, or reuse an A
// fragment's registers while the product still reads them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
  }
}

#define RT_D8(i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define RT_REGS32                                                     \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
  "%28, %29, %30, %31"
#define RT_REGS64                                                     \
  RT_REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, " \
  "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "  \
  "%56, %57, %58, %59, %60, %61, %62, %63"

// d (64 x N f32, the accumulator layout: thread t of the warpgroup holds
// rows 16*(t/32) + (t%32)/4 + {0, 8} and columns 8*j + 2*(t%4) + {0, 1},
// register 4*j + 2*(row half) + column) = A (64 x 16, shared memory,
// K-major) * B (16 x N, shared memory; K-major, or MN-major when TB = 1),
// plus d when scale_d != 0.  N = 64 or 128 by the size of d.  T is the
// operands' type, bf16 or f16 (the same shapes and layouts; only the
// instruction's type names differ).
#define RT_SS32(TY)                                                   \
  asm volatile(                                                       \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                     \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"      \
      RT_REGS32 "}, %32, %33, p, 1, 1, 0, %35;\n}\n"                    \
      : RT_D8(0), RT_D8(8), RT_D8(16), RT_D8(24)                       \
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB))
#define RT_SS64(TY)                                                   \
  asm volatile(                                                       \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                     \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"     \
      RT_REGS64 "}, %64, %65, p, 1, 1, 0, %67;\n}\n"                    \
      : RT_D8(0), RT_D8(8), RT_D8(16), RT_D8(24), RT_D8(32), RT_D8(40), \
        RT_D8(48), RT_D8(56)                                           \
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB))
#define RT_RS32(TY)                                                   \
  asm volatile(                                                       \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                     \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"      \
      RT_REGS32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"      \
      : RT_D8(0), RT_D8(8), RT_D8(16), RT_D8(24)                       \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),            \
        "r"(scale_d), "n"(TB))
#define RT_RS64(TY)                                                   \
  asm volatile(                                                       \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                     \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"     \
      RT_REGS64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"      \
      : RT_D8(0), RT_D8(8), RT_D8(16), RT_D8(24), RT_D8(32), RT_D8(40), \
        RT_D8(48), RT_D8(56)                                           \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),            \
        "r"(scale_d), "n"(TB))

template <typename T>
__host__ __device__ constexpr bool is_f16() {
  return std::is_same<T, __half>::value;
}

template <int TB, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int scale_d) {
  if constexpr (is_f16<T>()) {
    RT_SS32("f16");
  } else {
    RT_SS32("bf16");
  }
}

template <int TB, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int scale_d) {
  if constexpr (is_f16<T>()) {
    RT_SS64("f16");
  } else {
    RT_SS64("bf16");
  }
}

// The same with A from registers: a[0..3] hold the 64 x 16 tile in the
// accumulator's layout for 16 columns (a[0]: row r, columns 2c, 2c+1;
// a[1]: row r + 8; a[2]: row r, columns 2c + 8, 2c + 9; a[3]: row r + 8),
// so the accumulator registers 8k..8k+7 of a product, packed in pairs,
// are the A fragment of its columns 16k..16k+15.
template <int TB, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  if constexpr (is_f16<T>()) {
    RT_RS32("f16");
  } else {
    RT_RS32("bf16");
  }
}

template <int TB, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  if constexpr (is_f16<T>()) {
    RT_RS64("f16");
  } else {
    RT_RS64("bf16");
  }
}

#undef RT_SS32
#undef RT_SS64
#undef RT_RS32
#undef RT_RS64
#undef RT_D8
#undef RT_REGS32
#undef RT_REGS64

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %2, %1;\n" : "=r"(r) : "f"(lo), "f"(hi));
  return r;
}

__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.f16x2.f32 %0, %2, %1;\n" : "=r"(r) : "f"(lo), "f"(hi));
  return r;
}

// Two f32 values rounded to T (bf16 or f16) and packed, lo in the low half.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (is_f16<T>()) {
    return pack_f16(lo, hi);
  } else {
    return pack_bf16(lo, hi);
  }
}

// Eight T values (16 bytes) widened to f32 pairs: element 2i, 2i + 1.
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t bits) {
  if constexpr (is_f16<T>()) {
    return __half22float2(*reinterpret_cast<const __half2*>(&bits));
  } else {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bits));
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once per process.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      p = nullptr;
    }
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A rank-4 tensor map over a 2-byte (B, H, S, D) operand (bf16 unless
// `dtype` says f16) with D contiguous, from its pointer and element
// strides (batch, head, row; multiples of 8, as TMA's 16-byte rule asks):
// boxes of (64 columns, box_rows rows, 1, 1) with the 128-byte swizzle.
// Returns 0 or a CUDA error code.
inline int encode_bhsd(CUtensorMap* map, const void* ptr, int B, int H,
                       int S, int D, const int64_t* strides, int box_rows,
                       CUtensorMapDataType dtype =
                           CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t gstrides[3] = {static_cast<cuuint64_t>(strides[2]) * 2,
                                  static_cast<cuuint64_t>(strides[1]) * 2,
                                  static_cast<cuuint64_t>(strides[0]) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = fn(map, dtype, 4,
                  const_cast<void*>(ptr), dims, gstrides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-map element type of T (bf16 or f16).
template <typename T>
constexpr CUtensorMapDataType tensor_map_dtype() {
  return is_f16<T>() ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

}  // namespace hopper
