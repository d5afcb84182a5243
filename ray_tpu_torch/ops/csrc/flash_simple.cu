// Flash attention, the simple family: forward (B1s), dq with the delta
// pre-pass (B2s) and dk/dv (B3s) on the CUDA cores, for what the wgmma
// kernels (flash_fwd.cu, flash_bwd.cu) do not take.
//
// Replaces, for those inputs, ray_tpu/ops/flash_attention.py:_fwd_kernel
// (:96, reached through _fwd's pallas_call at :183), _dq_kernel (:216,
// call at :337) and _dkdv_kernel (:264, call at :368).  The reference's
// flash_attention returns a result at every head dimension.  The wgmma
// kernels take bf16 and f16 at D in {16, 32, ..., 128}; this family takes
// f32, bf16 and f16 (the element type T) at every D >= 1.  f32 here is a
// true f32 computation: every product and sum is an f32 FMA on the CUDA
// cores, never a tensor-core instruction (no mma, wgmma or tf32), so the
// f32 gates that need exact tokens (dense == paged == spec, first tokens
// == the forward's argmax) hold on the card.
//
// Contract (the same as the wgmma kernels'): q (B, Hq, Sq, D) pre-scaled
// by D**-0.5, k/v (B, Hkv, Sk, D) in T; GQA reads kv head h / (Hq / Hkv)
// in the forward (the backward takes k/v at q's heads, as the reference's
// _bwd_impl does).  Forward: o (B, Hq, Sq, D) in T = softmax(q k^T +
// mask) v with p rounded to T before the PV product, lse (B, Hq, Sq) f32;
// a row with every key masked gives o = 0 and lse = -1e30.  Backward:
// delta = rowsum(do * o) in f32 (written by the dq launch for the dk/dv
// launch), p = exp(s - lse) with masked scores at -1e30, ds = p (dp -
// delta); dq = ds k with ds rounded to T, dv = p^T do with p rounded to T,
// dk = ds^T q with ds rounded to T; dq, dk, dv f32 and contiguous.  q, k,
// v, o and do are read through their batch, head and row strides (D
// contiguous; any alignment).  Causal masks key j for row i when j > i.
//
// Bound.  At the main path's shape (B=4, H=8, S=2048, D=128, causal;
// 2,098,176 visible pairs per (b, h)) the forward does 4 D pairs =
// 3.44e10 FLOP and dk/dv 8 D pairs = 6.87e10: 0.513 and 1.026 ms at the
// card's 67 TFLOP/s f32 (CUDA-core) peak, against ~0.03 ms for their
// bytes.  Both are bound by operations: an SM issues at most 4
// warp-wide FMAs a clock, and every other instruction (a shared load, an
// address, an exp) takes one of those slots.
//
// What held the first version of B1s and B3s to 26-28% and 14% of that
// bound (an H100 80GB HBM3 at 700 W), and what this design does about
// each:
// - One scalar shared load fed 1.6-3.2 FMAs (8 x 8 thread grid, 4x8 or
//   2x8 register tiles, rows padded by one float).  Here every product
//   is a register micro-tile fed by 128-bit shared loads whose four
//   floats run along the product's reduction index; tiles are stored
//   with rows padded by 4 floats (36 or 132), so the 16 lanes of a half
//   warp reading 16 rows at one column hit 8 distinct bank quads and the
//   other half warp reads the same rows or one other.  B1s: S and PV are
//   8 x 8 a thread (16 loads per 256 FMAs).  B3s: dV and dK are 8 x 8
//   (32 loads per 512 FMAs); S^T and dP^T are 8 keys x 4 rows (12 loads
//   per 128 FMAs), because the two 8 x 8 gradients stay in registers
//   beside them (128 of a thread's 255; p goes to shared memory so that
//   S^T and dP^T are never live together).
// - Four warps per SM (one block of 128 threads, 116 KB of shared
//   memory).  Here a block is 256 threads (8 warps, two per scheduler,
//   249-255 registers each and no spill: the [build] report).  Shared
//   memory at D = 128 in f32: B1s holds P (128 rows x 132), each row's
//   running max and sum, and a ring of 3 stages of 36,864 B (a 128 x 36
//   chunk of Q and one of K, or 32 x 132 of V): 179,200 B.  B3s holds
//   P^T and dS^T (128 keys x 68 each) and 3 stages of 33,792 B (128 x 36
//   of K or V with 64 x 36 of Q or dO, or 32 x 132 of dO and of Q):
//   171,008 B.  Both fit the 232,448 B a block may use.
// - Copies ran between two barriers with a divide and a modulo per
//   element.  Here each block walks one stream of chunks, and thread i
//   copies 4-element groups i + 256 j of the chunk two ahead (three
//   stages) with 16-byte cp.async while all eight warps compute on the
//   current one: one barrier a chunk both publishes it and frees the
//   stage the next copy overwrites, and a cursor advanced without
//   divisions names the next chunk.  A 16-bit T lands in a raw stage
//   (8-byte cp.async) and the thread that copied a group widens it to
//   f32 once, before that barrier (a 16-bit forward fits two stages).
//   Operands whose addresses or strides are not multiples of 4 elements
//   are copied by plain loads instead (correct, not overlapped).  Inside
//   a chunk, B1s loads the next step's operands into a second register
//   buffer while a step's FMAs run; B3s has no registers for that.
// - B3s held 32 keys per block at D = 128, reading Q and dO Sk / 32
//   times per (b, h).  Here it holds 128 keys: Sk / 128 times.
// Causal blocks skip the key tiles above their last row (B1s) and the q
// tiles below their first key (B3s), and only tiles that cross the
// diagonal or the sequence's end apply the mask; B1s launches the
// longest q tiles first.  exp(x) is computed as exp2(x log2 e).
//
// Every head dimension.  A B1s or B3s block writes 128 columns of o, dk
// and dv (its slice of D; columns past D are zeros it does not store)
// and reduces S = Q K^T (and dP = dO V^T) over all of D in chunks of
// 32, so D > 128 runs ceil(D / 128) slices in the grid, each computing
// S again, and only the first slice writes lse.  B2s keeps its first
// design (128 threads, whole tiles of 64 to 512 columns, scalar shared
// loads; its redesign is later work): D is padded with zeros to 64, 128,
// 256 or 512 and, above 512, split into slices of 512 whose blocks
// reduce S and dP over every 512-column chunk; only the first slice
// writes delta.
//
// Interface: plain C, loaded with ctypes.  `dtype` is 0 for f32, 1 for
// bf16, 2 for f16.  Kernels launch on the caller's stream and allocate
// nothing; each launcher returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::cp_async;
using hopper::cp_async_commit;
using hopper::cp_async_wait;

constexpr float kMasked = -1e30f;  // the reference's mask value
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x log2 e)
constexpr int kSmemMax = 232448;   // dynamic shared memory a block may use

// Element strides of a (B, H, S, D) operand; D is contiguous.
struct Strides {
  int64_t b, h, s;
};

// Loads, stores and rounding of one element type, in f32.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
};

template <>
struct Elem<__half> {
  static __device__ __forceinline__ float load(const __half* p) {
    return __half2float(*p);
  }
  static __device__ __forceinline__ void store(__half* p, float x) {
    *p = __float2half(x);
  }
  static __device__ __forceinline__ float round(float x) {
    return __half2float(__float2half(x));
  }
};

// ---------------------------------------------------------------------------
// B1s and B3s: 256 threads, register micro-tiles, a cp.async ring
// ---------------------------------------------------------------------------

// Thread t is (ty, tx) = (t / 16, t % 16): a half warp shares ty.
constexpr int kThreads = 256;
constexpr int kCols = 128;   // columns of o / dk / dv a block writes
constexpr int kChunk = 32;   // D columns of an S chunk; keys or rows of a
                             // second-product chunk
constexpr int kLd = kChunk + 4;  // row stride of a (rows, kChunk) chunk
constexpr int kLdc = kCols + 4;  // row stride of a (rows, kCols) chunk

__device__ __forceinline__ void ld4(float (&x)[4], const float* p) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x;
  x[1] = t.y;
  x[2] = t.z;
  x[3] = t.w;
}

// Sum and max over the 16 lanes of a half warp.
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int m = 1; m < 16; m *= 2) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int m = 1; m < 16; m *= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, m));
  return x;
}

// Rows [r0, r0 + R) x columns [c0, c0 + W) of one (b, h) slice of a
// (B, H, S, D) operand (`base`, row stride `rs`) into an f32 tile of row
// stride LD; rows at or past `rows` and columns at or past D are zeros.
// Thread t takes the 4-element groups t + 256 j.  With `vec` (every
// group aligned: vec_ok) a group is one cp.async: into the f32 tile for
// f32, into `raw` (the same layout in T) for a 16-bit T, which
// widen_tile turns into f32 once it has landed.  Otherwise the thread
// loads and stores the elements itself.
template <typename T, int R, int W, int LD>
__device__ __forceinline__ void copy_tile(float* tile, T* raw, const T* base,
                                          int64_t rs, int r0, int rows,
                                          int c0, int D, bool vec) {
  constexpr int kG = W / 4;  // groups per row
  static_assert((R * kG) % kThreads == 0, "whole groups per thread");
#pragma unroll
  for (int j = 0; j < R * kG / kThreads; ++j) {
    const int u = threadIdx.x + j * kThreads;
    const int r = u / kG;
    const int c = (u % kG) * 4;
    const bool in = r0 + r < rows && c0 + c < D;
    const T* src = base + (in ? static_cast<int64_t>(r0 + r) * rs + c0 + c
                              : 0);
    if (vec) {
      if constexpr (sizeof(T) == 4) {
        cp_async<16>(tile + r * LD + c, src, in ? 16 : 0);
      } else {
        cp_async<8>(raw + r * LD + c, src, in ? 8 : 0);
      }
    } else {
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[e] = in && c0 + c + e < D ? Elem<T>::load(src + e) : 0.f;
      }
      *reinterpret_cast<float4*>(tile + r * LD + c) =
          make_float4(x[0], x[1], x[2], x[3]);
    }
  }
}

// The groups this thread copied into `raw` by copy_tile<T, R, W, LD>,
// widened to f32 in `tile` (16-bit T only).
template <typename T, int R, int W, int LD>
__device__ __forceinline__ void widen_tile(float* tile, const T* raw) {
  constexpr int kG = W / 4;
#pragma unroll
  for (int j = 0; j < R * kG / kThreads; ++j) {
    const int u = threadIdx.x + j * kThreads;
    const int at = (u / kG) * LD + (u % kG) * 4;
    const uint2 bits = *reinterpret_cast<const uint2*>(raw + at);
    const float2 lo = hopper::unpack2<T>(bits.x);
    const float2 hi = hopper::unpack2<T>(bits.y);
    *reinterpret_cast<float4*>(tile + at) = make_float4(lo.x, lo.y, hi.x,
                                                        hi.y);
  }
}

// One step (4 columns, from column c) of chunk_product: acc += cur x S,
// while the rows of H at column c + 4 are loaded into nxt (if `more`),
// one with each of the first NH loads of S.
template <int NH, int NS, bool kHq, typename Acc>
__device__ __forceinline__ void product_step(Acc& acc, float (&cur)[NH][4],
                                             float (&nxt)[NH][4],
                                             const float* H, int hrow,
                                             const float* S, int srow,
                                             int c, bool more) {
  static_assert(NH <= NS, "H's next rows load beside S's");
#pragma unroll
  for (int q = 0; q < NS; ++q) {
    float sv[4];
    ld4(sv, S + (srow + 16 * q) * kLd + c);
    if (more && q < NH) ld4(nxt[q], H + (hrow + 16 * q) * kLd + c + 4);
    // e outer: the NH FMAs between two on one accumulator hide the
    // FMA's latency.
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        if constexpr (kHq) {
          acc[h][q] = fmaf(cur[h][e], sv[e], acc[h][q]);
        } else {
          acc[q][h] = fmaf(cur[h][e], sv[e], acc[q][h]);
        }
      }
  }
}

// acc += the products over one chunk's kChunk columns of the rows of H
// (NH rows, hrow + 16 h) and of S (NS rows, srow + 16 q), both of row
// stride kLd: acc[h][q] when kHq, else acc[q][h].  A step takes 4
// columns: H's NH float4 stay in registers while the next step's are
// loaded into the other of two buffers, spread over this step's NS
// loads of S, so that the loads overlap the step's NH x NS x 4 FMAs
// instead of preceding them.
// Without kPipe, each step loads H's float4 before its FMAs (one buffer,
// and one step a loop iteration: B3s spills with two).
template <int NH, int NS, bool kHq, bool kPipe, typename Acc>
__device__ __forceinline__ void chunk_product(Acc& acc, const float* H,
                                              int hrow, const float* S,
                                              int srow) {
  if constexpr (!kPipe) {
#pragma unroll 1
    for (int c = 0; c < kChunk; c += 4) {
      float hv[NH][4];
#pragma unroll
      for (int h = 0; h < NH; ++h) ld4(hv[h], H + (hrow + 16 * h) * kLd + c);
      product_step<NH, NS, kHq>(acc, hv, hv, H, hrow, S, srow, c, false);
    }
    return;
  }
  float ha[NH][4], hb[NH][4];
#pragma unroll
  for (int h = 0; h < NH; ++h) ld4(ha[h], H + (hrow + 16 * h) * kLd);
#pragma unroll 1
  for (int c = 0; c < kChunk; c += 8) {
    product_step<NH, NS, kHq>(acc, ha, hb, H, hrow, S, srow, c, true);
    product_step<NH, NS, kHq>(acc, hb, ha, H, hrow, S, srow, c + 4,
                              c + 8 < kChunk);
  }
}

// One step (4 indices, from r) of chunk_product_pv: acc += cur x V, while
// P's rows at index r + 4 are loaded into nxt (if `more`), two with each
// of the step's 4 rows of V.
template <int LDP>
__device__ __forceinline__ void pv_step(float (&acc)[8][8],
                                        float (&cur)[8][4],
                                        float (&nxt)[8][4], const float* P,
                                        int prow, const float* V, int tx,
                                        int r, bool more) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float v0[4], v1[4];
    ld4(v0, V + (r + e) * kLdc + 4 * tx);
    ld4(v1, V + (r + e) * kLdc + 64 + 4 * tx);
    if (more) {
      ld4(nxt[2 * e], P + (prow + 32 * e) * LDP + r + 4);
      ld4(nxt[2 * e + 1], P + (prow + 32 * e + 16) * LDP + r + 4);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[i][c] = fmaf(cur[i][e], v0[c], acc[i][c]);
        acc[i][4 + c] = fmaf(cur[i][e], v1[c], acc[i][4 + c]);
      }
  }
}

// acc[i][c] += sum over one chunk's kChunk indices r of P[prow + 16 i][r]
// * V[r][col c], the columns 4 tx + {0..3} and 64 + 4 tx + {0..3} of V
// (row stride kLdc); P has row stride LDP.  A step takes 4 indices: P's
// 8 float4 stay in registers while the next step's are loaded into the
// other buffer, as in chunk_product.
template <int LDP, bool kPipe>
__device__ __forceinline__ void chunk_product_pv(float (&acc)[8][8],
                                                 const float* P, int prow,
                                                 const float* V, int tx) {
  if constexpr (!kPipe) {
#pragma unroll 2
    for (int r = 0; r < kChunk; r += 4) {
      float pv[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) ld4(pv[i], P + (prow + 16 * i) * LDP + r);
      pv_step<LDP>(acc, pv, pv, P, prow, V, tx, r, false);
    }
    return;
  }
  float pa[8][4], pb[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) ld4(pa[i], P + (prow + 16 * i) * LDP);
#pragma unroll 1
  for (int r = 0; r < kChunk; r += 8) {
    pv_step<LDP>(acc, pa, pb, P, prow, V, tx, r, true);
    pv_step<LDP>(acc, pb, pa, P, prow, V, tx, r + 4, r + 8 < kChunk);
  }
}

// Shared memory of B1s and B3s: kFixed floats (P, or P^T and dS^T), then
// a ring of stages of kSlot floats, then, for a 16-bit T, each stage's
// raw copy (kSlot elements of T).  Three stages where they fit in the
// 232,448 bytes a block may use, else two.
template <typename T, int kFixed, int kSlot>
struct Ring {
  static constexpr int kRaw = sizeof(T) < 4 ? static_cast<int>(sizeof(T))
                                            : 0;
  static constexpr int bytes(int stages) {
    return kFixed * 4 + stages * kSlot * (4 + kRaw);
  }
  static constexpr int kStages = bytes(3) <= kSmemMax ? 3 : 2;
  static constexpr int kBytes = bytes(kStages);
  static_assert(kBytes <= kSmemMax, "shared memory");
};

// ---------------------------------------------------------------------------
// B1s: forward
// ---------------------------------------------------------------------------

// Whether B1s and B3s load the next step's operands during a step's
// FMAs (chunk_product): B3s's two gradients leave it no registers (with
// it, or without it and two steps unrolled, ptxas spills).
constexpr bool kFwdPipe = true;
constexpr bool kBwdPipe = false;

constexpr int kFwdRows = 128;            // q rows per block
constexpr int kFwdKeys = 128;            // keys per K/V tile
constexpr int kLdp = kFwdKeys + 4;       // row stride of P (rows, keys)
// P, then the running max m and sum l of each row.
constexpr int kFwdFixed = kFwdRows * kLdp + 2 * kFwdRows;
constexpr int kFwdSlot = (kFwdRows + kFwdKeys) * kLd;  // Q and K chunks
static_assert(kChunk * kLdc <= kFwdSlot, "a V chunk fits a stage");

// One block per (slice of 128 output columns, head, batch, 128-row q
// tile).  Its stream of chunks, for each K/V tile: the D / 32 chunks of
// Q and K (S = Q K^T, accumulated in registers), then the 4 chunks of 32
// keys of V's slice (O += P V).  Thread (ty, tx) owns rows ty + 16 i and
// keys tx + 16 j of S (i, j < 8), and rows ty + 16 i by columns 4 tx +
// {0..3} and 64 + 4 tx + {0..3} of O.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_simple_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o,
                        float* __restrict__ lse, int Hq, int Hkv, int Sq,
                        int Sk, int D, int causal, int vec, Strides qs,
                        Strides ks, Strides vs, Strides os) {
  using R = Ring<T, kFwdFixed, kFwdSlot>;
  extern __shared__ float4 smem4[];
  float* Ps = reinterpret_cast<float*>(smem4);
  float* Ms = Ps + kFwdRows * kLdp;
  float* Ls = Ms + kFwdRows;
  float* ring = Ps + kFwdFixed;
  T* raw = reinterpret_cast<T*>(ring + R::kStages * kFwdSlot);

  const int n_slices = (D + kCols - 1) / kCols;
  const int h = blockIdx.x / n_slices;
  const int c0 = (blockIdx.x % n_slices) * kCols;
  const int b = blockIdx.y;
  // Longest causal rows first: the last q tile has the most K/V tiles.
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kFwdRows;
  const int hk = h / (Hq / Hkv);
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  const int nd = (D + kChunk - 1) / kChunk;  // S chunks per K/V tile
  const int per = nd + kFwdKeys / kChunk;    // chunks per K/V tile
  const int kv_end = causal ? min(Sk, q0 + kFwdRows) : Sk;

  // The copy cursor: the stage (cs), K/V tile (ck, a key offset) and
  // place in the tile's chunks (cr) of the next chunk to copy, advanced
  // without divisions.
  int cs = 0, ck = 0, cr = 0;
  auto issue = [&]() {
    if (ck < kv_end) {
      float* tile = ring + cs * kFwdSlot;
      T* rt = raw + cs * kFwdSlot;
      if (cr < nd) {
        copy_tile<T, kFwdRows, kChunk, kLd>(tile, rt, qb, qs.s, q0, Sq,
                                            cr * kChunk, D, vec);
        copy_tile<T, kFwdKeys, kChunk, kLd>(
            tile + kFwdRows * kLd, rt + kFwdRows * kLd, kb, ks.s, ck, Sk,
            cr * kChunk, D, vec);
      } else {
        copy_tile<T, kChunk, kCols, kLdc>(tile, rt, vb, vs.s,
                                          ck + (cr - nd) * kChunk, Sk, c0,
                                          D, vec);
      }
    }
    cp_async_commit();  // empty past the end: the wait count stays fixed
    cs = cs + 1 == R::kStages ? 0 : cs + 1;
    if (++cr == per) {
      cr = 0;
      ck += kFwdKeys;
    }
  };

  // Waits for the next chunk (an S chunk of Q and K, or a V chunk),
  // widens it if 16-bit, then publishes it to every thread with one
  // barrier, after which every thread is also done with the chunk
  // before, whose stage the next copy takes.
  auto begin = [&](bool s_chunk) -> const float* {
    cp_async_wait<R::kStages - 2>();
    // The copies run stages - 1 chunks ahead: this chunk's stage follows
    // the next copy's.
    const int bs = cs + 1 == R::kStages ? 0 : cs + 1;
    float* tile = ring + bs * kFwdSlot;
    if constexpr (sizeof(T) < 4) {
      if (vec) {
        const T* rt = raw + bs * kFwdSlot;
        if (s_chunk) {
          widen_tile<T, kFwdRows, kChunk, kLd>(tile, rt);
          widen_tile<T, kFwdKeys, kChunk, kLd>(tile + kFwdRows * kLd,
                                               rt + kFwdRows * kLd);
        } else {
          widen_tile<T, kChunk, kCols, kLdc>(tile, rt);
        }
      }
    }
    __syncthreads();
    issue();
    return tile;
  };

  // m and l live in shared memory (one copy per row, written by the
  // row's lane tx = 0), which leaves the registers to the products.
  if (threadIdx.x < kFwdRows) {
    Ms[threadIdx.x] = -INFINITY;
    Ls[threadIdx.x] = 0.f;
  }
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

#pragma unroll
  for (int n = 0; n < R::kStages - 1; ++n) issue();
  for (int k0 = 0; k0 < kv_end; k0 += kFwdKeys) {
    // S = Q K^T, 32 columns of D a chunk.
    float s[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    for (int dc = 0; dc < nd; ++dc) {
      const float* Qc = begin(true);
      const float* Kc = Qc + kFwdRows * kLd;
      chunk_product<8, 8, true, kFwdPipe>(s, Qc, ty, Kc, tx);
    }

    // Online softmax per row over the half warp's 16 lanes; p, rounded to
    // T, into P for the PV chunks (which read it after their barrier).
    // Only a tile that crosses the diagonal or Sk masks.
    const bool edge =
        k0 + kFwdKeys > Sk || (causal && k0 + kFwdKeys - 1 > q0);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + tx + 16 * j;
        if (edge && (col >= Sk || (causal && col > row))) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_old = Ms[ty + 16 * i];
      const float l_old = Ls[ty + 16 * i];
      const float m_new = fmaxf(m_old, half_max(mx));
      // Every key so far masked: keep p = 0 (exp(-inf - 0)).
      const float mb = m_new == -INFINITY ? 0.f : m_new;
      const float alpha =
          m_old == -INFINITY ? 0.f : exp2f((m_old - mb) * kLog2e);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = exp2f((s[i][j] - mb) * kLog2e);
        rs += p;
        Ps[(ty + 16 * i) * kLdp + tx + 16 * j] = Elem<T>::round(p);
      }
      const float l_new = l_old * alpha + half_sum(rs);
      __syncwarp();  // every lane of the row has read m and l
      if (tx == 0) {
        Ms[ty + 16 * i] = m_new;
        Ls[ty + 16 * i] = l_new;
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= alpha;
    }

    // O += P V, 32 keys a chunk.
    for (int vc = 0; vc < kFwdKeys / kChunk; ++vc) {
      const float* Vc = begin(false);
      const float* Pc = Ps + vc * kChunk;
      chunk_product_pv<kLdp, kFwdPipe>(acc, Pc, ty, Vc, tx);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float m = Ms[ty + 16 * i];
    const float l = Ls[ty + 16 * i];
    const bool live = l > 0.f;
    const float inv = live ? 1.f / l : 0.f;
    T* orow = o + b * os.b + h * os.h + row * os.s;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = c0 + (c < 4 ? 4 * tx + c : 60 + 4 * tx + c);
      if (col < D) Elem<T>::store(orow + col, acc[i][c] * inv);
    }
    if (tx == 0 && c0 == 0) {
      lse[static_cast<int64_t>(b * Hq + h) * Sq + row] =
          live ? m + logf(l) : kMasked;
    }
  }
}

// ---------------------------------------------------------------------------
// B2s: dq, with the delta pre-pass (the first design, 128 threads)
// ---------------------------------------------------------------------------

constexpr int kDqThreads = 128;  // 16 row groups x 8 lanes

// Sum and max over the eight lanes of a row group (lanes 8g .. 8g + 7).
__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}

// Rows [r0, r0 + ROWS) of one (b, h) slice of a (B, H, S, D) operand into
// a (ROWS, DP + 1) f32 tile; rows past S and columns past D are zeros.
template <typename T, int ROWS, int DP>
__device__ __forceinline__ void load_tile(float* tile, const T* base,
                                          int64_t row_stride, int r0, int S,
                                          int D) {
  for (int i = threadIdx.x; i < ROWS * DP; i += kDqThreads) {
    const int r = i / DP;
    const int c = i % DP;
    float x = 0.f;
    if (r0 + r < S && c < D) {
      x = Elem<T>::load(base + static_cast<int64_t>(r0 + r) * row_stride + c);
    }
    tile[r * (DP + 1) + c] = x;
  }
}

template <int DP>
struct DqCfg {
  static constexpr int BM = DP <= 128 ? 64 : (DP == 256 ? 32 : 16);  // rows
  static constexpr int BN = DP <= 256 ? 64 : 32;  // keys per K/V tile
  static constexpr int TM = BM / 16;
  static constexpr int TN = BN / 8;
  static constexpr int TC = DP / 8;
  static constexpr int LD = DP + 1;
  static constexpr int LP = BN + 1;
  static constexpr int kQ = 0;
  static constexpr int kDo = kQ + BM * LD;
  static constexpr int kK = kDo + BM * LD;
  static constexpr int kV = kK + BN * LD;
  static constexpr int kS = kV + BN * LD;
  static constexpr int kBytes = (kS + BM * LP) * 4;
};

// One block per (slice of DP columns of dq, head, batch, q tile).  D <=
// DP has one slice, and Q and dO stay in shared memory; past DP, S and dP
// sum over every DP-column chunk of Q, dO, K and V, and K's slice is
// loaded again for dQ.
template <typename T, int DP>
__global__ void __launch_bounds__(kDqThreads)
flash_simple_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const T* __restrict__ o, const float* __restrict__ lse,
                       float* __restrict__ delta, float* __restrict__ dq,
                       int H, int Sq, int Sk, int D, int causal, Strides qs,
                       Strides ks, Strides vs, Strides dos, Strides os) {
  using C = DqCfg<DP>;
  extern __shared__ float smem[];
  float* Qs = smem + C::kQ;
  float* Dos = smem + C::kDo;
  float* Ks = smem + C::kK;
  float* Vs = smem + C::kV;
  float* DSs = smem + C::kS;

  const int n_chunks = (D + DP - 1) / DP;  // > 1 only for D > 512
  const int h = blockIdx.x / n_chunks;
  const int slice = blockIdx.x % n_chunks;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * C::BM;
  const int ty = threadIdx.x / 8;
  const int tx = threadIdx.x % 8;
  const int64_t row_off = static_cast<int64_t>(b * H + h) * Sq;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* db = dout + b * dos.b + h * dos.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  if (n_chunks == 1) {
    load_tile<T, C::BM, DP>(Qs, qb, qs.s, q0, Sq, D);
    load_tile<T, C::BM, DP>(Dos, db, dos.s, q0, Sq, D);
  }

  // delta = rowsum(dO * O) in f32 for this thread's rows (the group's
  // eight lanes split the columns), and lse.
  float dl[C::TM], ls[C::TM];
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int row = q0 + ty * C::TM + i;
    float sum = 0.f;
    if (row < Sq) {
      const T* orow = o + b * os.b + h * os.h + row * os.s;
      const T* drow = db + row * dos.s;
      for (int c = tx; c < D; c += 8) {
        sum = fmaf(Elem<T>::load(drow + c), Elem<T>::load(orow + c), sum);
      }
    }
    sum = group_sum(sum);
    dl[i] = sum;
    ls[i] = row < Sq ? lse[row_off + row] : 0.f;
    if (tx == 0 && row < Sq && slice == 0) delta[row_off + row] = sum;
  }

  float acc[C::TM][C::TC];
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int c = 0; c < C::TC; ++c) acc[i][c] = 0.f;

  const int kv_end = causal ? min(Sk, q0 + C::BM) : Sk;
  for (int k0 = 0; k0 < kv_end; k0 += C::BN) {
    // S = Q K^T and dP = dO V^T, over every chunk of D.
    float s[C::TM][C::TN], dp[C::TM][C::TN];
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int j = 0; j < C::TN; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int off = ch * DP;
      __syncthreads();  // the last tile's readers are done
      if (n_chunks > 1) {
        load_tile<T, C::BM, DP>(Qs, qb + off, qs.s, q0, Sq, D - off);
        load_tile<T, C::BM, DP>(Dos, db + off, dos.s, q0, Sq, D - off);
      }
      load_tile<T, C::BN, DP>(Ks, kb + off, ks.s, k0, Sk, D - off);
      load_tile<T, C::BN, DP>(Vs, vb + off, vs.s, k0, Sk, D - off);
      __syncthreads();
#pragma unroll 2
      for (int d = 0; d < DP; ++d) {
        float qv[C::TM], dov[C::TM], kv[C::TN], vv[C::TN];
#pragma unroll
        for (int i = 0; i < C::TM; ++i) {
          qv[i] = Qs[(ty * C::TM + i) * C::LD + d];
          dov[i] = Dos[(ty * C::TM + i) * C::LD + d];
        }
#pragma unroll
        for (int j = 0; j < C::TN; ++j) {
          kv[j] = Ks[(tx + 8 * j) * C::LD + d];
          vv[j] = Vs[(tx + 8 * j) * C::LD + d];
        }
#pragma unroll
        for (int i = 0; i < C::TM; ++i)
#pragma unroll
          for (int j = 0; j < C::TN; ++j) {
            s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
            dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
          }
      }
    }

    // p = exp(s - lse), ds = p (dp - delta), rounded to T (k's dtype).
#pragma unroll
    for (int i = 0; i < C::TM; ++i) {
      const int row = q0 + ty * C::TM + i;
#pragma unroll
      for (int j = 0; j < C::TN; ++j) {
        const int col = k0 + tx + 8 * j;
        const float x =
            (col >= Sk || (causal && col > row)) ? kMasked : s[i][j];
        const float p = expf(x - ls[i]);
        DSs[(ty * C::TM + i) * C::LP + tx + 8 * j] =
            Elem<T>::round(p * (dp[i][j] - dl[i]));
      }
    }
    __syncthreads();
    if (slice != n_chunks - 1) {  // Ks holds the last chunk: load ours
      load_tile<T, C::BN, DP>(Ks, kb + slice * DP, ks.s, k0, Sk,
                              D - slice * DP);
      __syncthreads();
    }

    // dQ += dS K.
#pragma unroll 4
    for (int kk = 0; kk < C::BN; ++kk) {
      float dsv[C::TM];
#pragma unroll
      for (int i = 0; i < C::TM; ++i)
        dsv[i] = DSs[(ty * C::TM + i) * C::LP + kk];
#pragma unroll
      for (int c = 0; c < C::TC; ++c) {
        const float kv = Ks[kk * C::LD + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < C::TM; ++i) acc[i][c] = fmaf(dsv[i], kv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int row = q0 + ty * C::TM + i;
    if (row >= Sq) continue;
    float* dqrow = dq + (row_off + row) * D;
#pragma unroll
    for (int c = 0; c < C::TC; ++c) {
      const int col = slice * DP + tx + 8 * c;
      if (col < D) dqrow[col] = acc[i][c];
    }
  }
}

// ---------------------------------------------------------------------------
// B3s: dk, dv
// ---------------------------------------------------------------------------

constexpr int kBwdKeys = 128;           // keys per block
constexpr int kBwdRows = 64;            // q rows per Q/dO tile
constexpr int kLdq = kBwdRows + 4;      // row stride of P^T, dS^T (keys, rows)
constexpr int kBwdFixed = 2 * kBwdKeys * kLdq;
constexpr int kBwdSlot = (kBwdKeys + kBwdRows) * kLd > 2 * kChunk * kLdc
                             ? (kBwdKeys + kBwdRows) * kLd
                             : 2 * kChunk * kLdc;

// One block per (slice of 128 columns of dk/dv, head, batch, 128-key
// tile).  Its stream of chunks, for each 64-row q tile: the D / 32
// chunks of K and Q (S^T = K Q^T), the D / 32 chunks of V and dO (dP^T =
// V dO^T), then 2 chunks of 32 rows of dO's and Q's slices (dV += P^T dO,
// dK += dS^T Q).  Thread (ty, tx) owns keys ty + 16 i (i < 8) by rows
// tx + 16 j (j < 4) of S^T and dP^T, and keys ty + 16 i by columns 4 tx +
// {0..3} and 64 + 4 tx + {0..3} of dK and dV.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_simple_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int H, int Sq, int Sk, int D, int causal, int vec,
                         Strides qs, Strides ks, Strides vs, Strides dos) {
  using R = Ring<T, kBwdFixed, kBwdSlot>;
  extern __shared__ float4 smem4[];
  float* Pt = reinterpret_cast<float*>(smem4);
  float* DSt = Pt + kBwdKeys * kLdq;
  float* ring = Pt + kBwdFixed;
  T* raw = reinterpret_cast<T*>(ring + R::kStages * kBwdSlot);

  const int n_slices = (D + kCols - 1) / kCols;
  const int h = blockIdx.x / n_slices;
  const int c0 = (blockIdx.x % n_slices) * kCols;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kBwdKeys;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int64_t row_off = static_cast<int64_t>(b * H + h) * Sq;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const T* db = dout + b * dos.b + h * dos.h;
  const int nd = (D + kChunk - 1) / kChunk;
  const int per = 2 * nd + kBwdRows / kChunk;  // chunks per q tile
  // Causal: rows below this key tile's first key see none of its keys.
  const int first = causal ? k0 / kBwdRows : 0;

  // The copy cursor, as in B1s: stage cs, q tile row cq, place cr in the
  // tile's chunks.
  int cs = 0, cq = first * kBwdRows, cr = 0;
  auto issue = [&]() {
    if (cq < Sq) {
      float* tile = ring + cs * kBwdSlot;
      T* rt = raw + cs * kBwdSlot;
      if (cr < 2 * nd) {
        const bool sc = cr < nd;  // S^T: K and Q; dP^T: V and dO
        const int off = (sc ? cr : cr - nd) * kChunk;
        copy_tile<T, kBwdKeys, kChunk, kLd>(tile, rt, sc ? kb : vb,
                                            sc ? ks.s : vs.s, k0, Sk, off,
                                            D, vec);
        copy_tile<T, kBwdRows, kChunk, kLd>(
            tile + kBwdKeys * kLd, rt + kBwdKeys * kLd, sc ? qb : db,
            sc ? qs.s : dos.s, cq, Sq, off, D, vec);
      } else {
        const int r0 = cq + (cr - 2 * nd) * kChunk;
        copy_tile<T, kChunk, kCols, kLdc>(tile, rt, db, dos.s, r0, Sq, c0,
                                          D, vec);
        copy_tile<T, kChunk, kCols, kLdc>(tile + kChunk * kLdc,
                                          rt + kChunk * kLdc, qb, qs.s, r0,
                                          Sq, c0, D, vec);
      }
    }
    cp_async_commit();
    cs = cs + 1 == R::kStages ? 0 : cs + 1;
    if (++cr == per) {
      cr = 0;
      cq += kBwdRows;
    }
  };

  auto begin = [&](bool d_chunk) -> const float* {
    cp_async_wait<R::kStages - 2>();
    const int bs = cs + 1 == R::kStages ? 0 : cs + 1;
    float* tile = ring + bs * kBwdSlot;
    if constexpr (sizeof(T) < 4) {
      if (vec) {
        const T* rt = raw + bs * kBwdSlot;
        if (d_chunk) {  // a chunk of D columns: S^T or dP^T
          widen_tile<T, kBwdKeys, kChunk, kLd>(tile, rt);
          widen_tile<T, kBwdRows, kChunk, kLd>(tile + kBwdKeys * kLd,
                                               rt + kBwdKeys * kLd);
        } else {
          widen_tile<T, kChunk, kCols, kLdc>(tile, rt);
          widen_tile<T, kChunk, kCols, kLdc>(tile + kChunk * kLdc,
                                             rt + kChunk * kLdc);
        }
      }
    }
    __syncthreads();
    issue();
    return tile;
  };

  float acc_k[8][8], acc_v[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

#pragma unroll
  for (int n = 0; n < R::kStages - 1; ++n) issue();
  for (int q0 = first * kBwdRows; q0 < Sq; q0 += kBwdRows) {
    // S^T = K Q^T, 32 columns of D a chunk; lse read during the last one.
    float s[8][4], ls[4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int dc = 0; dc < nd; ++dc) {
      const float* Kc = begin(true);
      if (dc == nd - 1) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = q0 + tx + 16 * j;  // rows past Sq are masked
          ls[j] = row < Sq ? lse[row_off + row] : 0.f;
        }
      }
      chunk_product<4, 8, false, kBwdPipe>(s, Kc + kBwdKeys * kLd, tx, Kc, ty);
    }
    // p^T = exp(s^T - lse): rounded to T (do's dtype) into P^T for dV,
    // and as it is into dS^T until dP^T is done (each thread rewrites
    // only its own elements), so that s need not stay in registers.  Only
    // a q tile that crosses the diagonal or Sq masks.
    const bool edge =
        q0 + kBwdRows > Sq || (causal && k0 + kBwdKeys - 1 > q0);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int key = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = q0 + tx + 16 * j;
        const float x = edge && (row >= Sq || (causal && key > row))
                            ? kMasked : s[i][j];
        const float p = exp2f((x - ls[j]) * kLog2e);
        const int at = (ty + 16 * i) * kLdq + tx + 16 * j;
        Pt[at] = Elem<T>::round(p);
        DSt[at] = p;
      }
    }

    // dP^T = V dO^T; delta read during the last chunk.
    float dp[8][4], dl[4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dp[i][j] = 0.f;
    for (int dc = 0; dc < nd; ++dc) {
      const float* Vc = begin(true);
      if (dc == nd - 1) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = q0 + tx + 16 * j;
          dl[j] = row < Sq ? delta[row_off + row] : 0.f;
        }
      }
      chunk_product<4, 8, false, kBwdPipe>(dp, Vc + kBwdKeys * kLd, tx, Vc, ty);
    }
    // ds = p (dp - delta), rounded to T (q's dtype) for dK, into dS^T
    // (P^T and dS^T are read after the next barrier).
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int at = (ty + 16 * i) * kLdq + tx + 16 * j;
        DSt[at] = Elem<T>::round(DSt[at] * (dp[i][j] - dl[j]));
      }

    // dV += P^T dO and dK += dS^T Q, 32 rows a chunk.
    for (int rc = 0; rc < kBwdRows / kChunk; ++rc) {
      const float* dOc = begin(false);
      const float* Qc = dOc + kChunk * kLdc;
      const int pc = rc * kChunk;
      chunk_product_pv<kLdq, kBwdPipe>(acc_v, Pt + pc, ty, dOc, tx);
      chunk_product_pv<kLdq, kBwdPipe>(acc_k, DSt + pc, ty, Qc, tx);
    }
  }
  cp_async_wait<0>();

  const int64_t key_off = static_cast<int64_t>(b * H + h) * Sk;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= Sk) continue;
    float* dkrow = dk + (key_off + key) * D;
    float* dvrow = dv + (key_off + key) * D;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = c0 + (c < 4 ? 4 * tx + c : 60 + 4 * tx + c);
      if (col < D) {
        dkrow[col] = acc_k[i][c];
        dvrow[col] = acc_v[i][c];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

Strides strides_at(const int64_t* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

// Whether every 4-element group that copy_tile reads from the first n
// operands starts on a 4-element boundary (so that it can be one
// cp.async): D, their strides and their addresses in elements multiples
// of 4.
int vec_ok(int elem, int D, const void* const* ptrs, int n,
           const int64_t* st) {
  if (D % 4) return 0;
  for (int i = 0; i < n; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % (4 * elem)) return 0;
    for (int j = 0; j < 3; ++j) {
      if (st[3 * i + j] % 4) return 0;
    }
  }
  return 1;
}

template <typename Kernel>
int prepare(Kernel kernel, int smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int Hq, int Hkv, int Sq, int Sk, int D,
               int causal, const int64_t* st, cudaStream_t stream) {
  using R = Ring<T, kFwdFixed, kFwdSlot>;
  const int rc = prepare(flash_simple_fwd_kernel<T>, R::kBytes);
  if (rc) return rc;
  const void* ptrs[3] = {q, k, v};
  const int vec = vec_ok(sizeof(T), D, ptrs, 3, st);
  dim3 grid(Hq * ((D + kCols - 1) / kCols), B,
            (Sq + kFwdRows - 1) / kFwdRows);
  flash_simple_fwd_kernel<T><<<grid, kThreads, R::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      Hq, Hkv, Sq, Sk, D, causal, vec, strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3));
  return static_cast<int>(cudaGetLastError());
}

// B2s's tile width: D zero-padded to 64, 128, 256 or 512, above 512
// slices of 512.
int dq_width(int D) {
  return D <= 64 ? 64 : D <= 128 ? 128 : D <= 256 ? 256 : 512;
}

template <typename T, int DP>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* o, const void* lse, void* delta, void* dq, int B,
              int H, int Sq, int Sk, int D, int causal, const int64_t* st,
              cudaStream_t stream) {
  using C = DqCfg<DP>;
  const int rc = prepare(flash_simple_dq_kernel<T, DP>, C::kBytes);
  if (rc) return rc;
  dim3 grid(H * ((D + DP - 1) / DP), B, (Sq + C::BM - 1) / C::BM);
  flash_simple_dq_kernel<T, DP><<<grid, kDqThreads, C::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const T*>(o), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<float*>(dq), H, Sq, Sk, D,
      causal, strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 3), strides_at(st, 4));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dkdv(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dk, void* dv, int B, int H, int Sq, int Sk, int D,
                int causal, const int64_t* st, cudaStream_t stream) {
  using R = Ring<T, kBwdFixed, kBwdSlot>;
  const int rc = prepare(flash_simple_dkdv_kernel<T>, R::kBytes);
  if (rc) return rc;
  const void* ptrs[4] = {q, k, v, dout};
  const int vec = vec_ok(sizeof(T), D, ptrs, 4, st);
  dim3 grid(H * ((D + kCols - 1) / kCols), B,
            (Sk + kBwdKeys - 1) / kBwdKeys);
  flash_simple_dkdv_kernel<T><<<grid, kThreads, R::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), H, Sq, Sk, D, causal,
      vec, strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 3));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
struct Fwd {
  template <typename... A>
  static int run(A... a) { return launch_fwd<T>(a...); }
};

template <typename T>
struct Dkdv {
  template <typename... A>
  static int run(A... a) { return launch_dkdv<T>(a...); }
};

// Calls F<T>::run(args...) for the runtime dtype code.
template <template <typename> class F, typename... Args>
int by_dtype(int dtype, Args... args) {
  switch (dtype) {
    case 0: return F<float>::run(args...);
    case 1: return F<__nv_bfloat16>::run(args...);
    case 2: return F<__half>::run(args...);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// B2s: launch_dq<T, DP> for the runtime dtype code and dq_width(D).
template <typename... Args>
int dispatch_dq(int dtype, int D, Args... args) {
  switch (dtype * 1000 + dq_width(D)) {
    case 64: return launch_dq<float, 64>(args...);
    case 128: return launch_dq<float, 128>(args...);
    case 256: return launch_dq<float, 256>(args...);
    case 512: return launch_dq<float, 512>(args...);
    case 1064: return launch_dq<__nv_bfloat16, 64>(args...);
    case 1128: return launch_dq<__nv_bfloat16, 128>(args...);
    case 1256: return launch_dq<__nv_bfloat16, 256>(args...);
    case 1512: return launch_dq<__nv_bfloat16, 512>(args...);
    case 2064: return launch_dq<__half, 64>(args...);
    case 2128: return launch_dq<__half, 128>(args...);
    case 2256: return launch_dq<__half, 256>(args...);
    case 2512: return launch_dq<__half, 512>(args...);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool grid_ok(int B, int tiles) { return B <= 65535 && tiles <= 65535; }

}  // namespace

// Forward: writes o and lse.  strides: 12, (batch, head, row) of q, k, v,
// o.
extern "C" int flash_fwd_simple(int dtype, const void* q, const void* k,
                                const void* v, void* o, void* lse, int B,
                                int Hq, int Hkv, int Sq, int Sk, int D,
                                int causal, const int64_t* strides,
                                void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || Sq <= 0 || Sk < 0 ||
      D < 1 || !grid_ok(B, (Sq + kFwdRows - 1) / kFwdRows))
    return static_cast<int>(cudaErrorInvalidValue);
  return by_dtype<Fwd>(dtype, q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, D,
                       causal, strides, static_cast<cudaStream_t>(stream));
}

// dq and the delta pre-pass: writes delta (B, H, Sq) f32 and dq.
// strides: 15, (batch, head, row) of q, k, v, do, o.
extern "C" int flash_bwd_dq_simple(int dtype, const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* o, const void* lse,
                                   void* delta, void* dq, int B, int H,
                                   int Sq, int Sk, int D, int causal,
                                   const int64_t* strides, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || D < 1 ||
      !grid_ok(B, (Sq + 15) / 16))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_dq(dtype, D, q, k, v, dout, o, lse, delta, dq, B, H, Sq,
                     Sk, D, causal, strides,
                     static_cast<cudaStream_t>(stream));
}

// dk and dv, reading the delta that the dq launch wrote.  Same strides.
extern "C" int flash_bwd_dkdv_simple(int dtype, const void* q,
                                     const void* k, const void* v,
                                     const void* dout, const void* o,
                                     const void* lse, void* delta, void* dk,
                                     void* dv, int B, int H, int Sq, int Sk,
                                     int D, int causal,
                                     const int64_t* strides, void* stream) {
  (void)o;  // delta already holds rowsum(do * o)
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || D < 1 ||
      !grid_ok(B, (Sk + kBwdKeys - 1) / kBwdKeys))
    return static_cast<int>(cudaErrorInvalidValue);
  return by_dtype<Dkdv>(dtype, q, k, v, dout,
                        static_cast<const void*>(lse),
                        static_cast<const void*>(delta), dk, dv, B, H, Sq,
                        Sk, D, causal, strides,
                        static_cast<cudaStream_t>(stream));
}
