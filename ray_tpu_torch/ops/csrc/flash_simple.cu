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
// 3.44e10 FLOP, dq 6 D pairs and the delta pass = 5.16e10 and dk/dv 8 D
// pairs = 6.87e10: 0.513, 0.770 and 1.026 ms at the card's 67 TFLOP/s
// f32 (CUDA-core) peak, against ~0.03 ms for their bytes.  All three are
// bound by operations: an SM issues at most 4 warp-wide FMAs a clock,
// and every other instruction (a shared load, an address, an exp) takes
// one of those slots.
//
// What held the first versions to 26-28% (B1s), 20% (B2s) and 14% (B3s)
// of that bound (an H100 80GB HBM3 at 700 W), and what this design does
// about each:
// - One scalar shared load fed 1.6-3.2 FMAs (8 x 8 thread grid, 4x8 or
//   2x8 register tiles, rows padded by one float).  Here every product
//   is a register micro-tile fed by 128-bit shared loads whose four
//   floats run along the product's reduction index; tiles are stored
//   with rows padded by 4 floats (36 or 132), so the 16 lanes of a half
//   warp reading 16 rows at one column hit 8 distinct bank quads and the
//   other half warp reads the same rows or one other.  B1s: S
//   and PV are 8 x 8 a thread (16 loads per 256 FMAs), and so are B2s's
//   S, dP and dQ.  B3s: dV and dK are 8 x 8 (32 loads per 512 FMAs); S^T
//   and dP^T are 8 keys x 4 rows (12 loads per 128 FMAs), because the
//   two 8 x 8 gradients stay in registers beside them (128 of a thread's
//   255; p goes to shared memory so that S^T and dP^T are never live
//   together, as it does in B2s).
// - Four warps per SM (one block of 128 threads, 116 to 149 KB of shared
//   memory).  Here a block is 256 threads (8 warps, two per scheduler,
//   249-255 registers each and no spill: the [build] report).  Shared
//   memory at D = 128 in f32: B1s holds P (128 rows x 132), each row's
//   running max and sum, and a ring of 3 stages of 36,864 B (a 128 x 36
//   chunk of Q and one of K, or 32 x 132 of V): 179,200 B; B2s the same
//   with each row's lse and delta.  B3s holds P^T and dS^T (128 keys x 68
//   each) and 3 stages of 33,792 B (128 x 36 of K or V with 64 x 36 of Q
//   or dO, or 32 x 132 of dO and of Q): 171,008 B.  All fit the 232,448 B
//   a block may use.
// - Copies ran between two barriers with a divide and a modulo per
//   element.  Here each block walks one stream of chunks, and thread i
//   copies 4-element groups i + 256 j of the chunk two ahead (three
//   stages) with 16-byte cp.async while all eight warps compute on the
//   current one: one barrier a chunk both publishes it and frees the
//   stage the next copy overwrites, and a cursor advanced without
//   divisions names the next chunk.  A 16-bit T lands in a raw stage
//   (8-byte cp.async) and the thread that copied a group widens it to
//   f32 once, before that barrier (a 16-bit forward or dq fits two
//   stages).  Operands whose addresses or strides are not multiples of 4
//   elements are copied by plain loads instead (correct, not
//   overlapped).  Inside a chunk, B1s (and B2s for S and dP) loads the
//   next step's operands into a second register buffer while a step's
//   FMAs run; B3s has no registers for that.
// - B3s held 32 keys per block at D = 128, reading Q and dO Sk / 32
//   times per (b, h).  Here it holds 128 keys: Sk / 128 times.
// Causal blocks skip the key tiles above their last row (B1s, B2s) and
// the q tiles below their first key (B3s), and only tiles that cross the
// diagonal or the sequence's end apply the mask; B1s and B2s launch the
// longest q tiles first.  exp(x) is computed as exp2(x log2 e).
//
// Every head dimension.  A block writes 128 columns of o, dq, dk and dv
// (its slice of D; columns past D are zeros it does not store) and
// reduces S = Q K^T (and dP = dO V^T) over all of D in chunks of 32, so
// D > 128 runs ceil(D / 128) slices in the grid, each computing S again,
// and only the first slice writes lse (B1s) or delta (B2s).
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
// Thread t (threadIdx.x unless given) takes the 4-element groups t + 256
// j.  With `vec` (every group aligned: vec_ok) a group is one cp.async:
// into the f32 tile for f32, into `raw` (the same layout in T) for a
// 16-bit T, which widen_tile turns into f32 once it has landed.
// Otherwise the thread loads and stores the elements itself.
template <typename T, int R, int W, int LD>
__device__ __forceinline__ void copy_tile(float* tile, T* raw, const T* base,
                                          int64_t rs, int r0, int rows,
                                          int c0, int D, bool vec,
                                          int t = threadIdx.x) {
  constexpr int kG = W / 4;  // groups per row
  static_assert((R * kG) % kThreads == 0, "whole groups per thread");
#pragma unroll
  for (int j = 0; j < R * kG / kThreads; ++j) {
    const int u = t + j * kThreads;
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

// Four 16-bit elements (8 bytes), widened to f32.
template <typename T>
__device__ __forceinline__ float4 widen4(uint2 bits) {
  const float2 lo = hopper::unpack2<T>(bits.x);
  const float2 hi = hopper::unpack2<T>(bits.y);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// The groups thread t copied into `raw` by copy_tile<T, R, W, LD>,
// widened to f32 in `tile` (16-bit T only).
template <typename T, int R, int W, int LD>
__device__ __forceinline__ void widen_tile(float* tile, const T* raw,
                                           int t = threadIdx.x) {
  constexpr int kG = W / 4;
#pragma unroll
  for (int j = 0; j < R * kG / kThreads; ++j) {
    const int u = t + j * kThreads;
    const int at = (u / kG) * LD + (u % kG) * 4;
    *reinterpret_cast<float4*>(tile + at) =
        widen4<T>(*reinterpret_cast<const uint2*>(raw + at));
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
// B2s: dq, with the delta pre-pass
// ---------------------------------------------------------------------------
//
// B1s's skeleton with three products a K/V tile where B1s has two: S = Q
// K^T and dP = dO V^T as 8 x 8 register tiles (p = exp(s - lse) goes to
// P in shared memory, so that S and dP are never live together, and ds =
// p (dp - delta) is written back over it), then dQ += dS K as B1s's O +=
// P V with dS for P and K's column slice for V.  Shared memory is B1s's
// layout: P (128 rows x 132), each row's lse and delta, and a ring of 3
// stages of 36,864 B at f32 (179,200 B; 2 stages for a 16-bit T).  254
// registers and no spill in each instance (the [build] report).

// The 4 elements at p in f32: one vector load with `vec` (the group is
// aligned and whole: vec_ok), else the first n of them and zeros.
template <typename T>
__device__ __forceinline__ float4 load4(const T* p, int n, bool vec) {
  if (vec) {
    if constexpr (sizeof(T) == 4) {
      return *reinterpret_cast<const float4*>(p);
    } else {
      return widen4<T>(*reinterpret_cast<const uint2*>(p));
    }
  }
  float x[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) x[e] = e < n ? Elem<T>::load(p + e) : 0.f;
  return make_float4(x[0], x[1], x[2], x[3]);
}

// threadIdx.x, read anew where it is called (a volatile read the compiler
// neither hoists nor merges): B2s's copies derive their addresses from it
// at each chunk instead of holding them in registers through the
// products, which left ptxas a few registers short.
__device__ __forceinline__ int tid_now() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}

// One block per (slice of 128 columns of dq, head, batch, 128-row q
// tile).  It first sums delta = rowsum(dO * O) over all of D for its rows
// (a half warp a row; every slice needs it, only the first writes it out
// for the dk/dv launch) while the ring's first copies land.  Its stream
// of chunks, for each K/V tile: the D / 32 chunks of Q and K (S = Q K^T),
// the D / 32 chunks of dO and V (dP = dO V^T), then the 4 chunks of 32
// keys of K's slice (dQ += dS K).  Thread (ty, tx) owns rows ty + 16 i
// and keys tx + 16 j of S and dP (i, j < 8), and rows ty + 16 i by
// columns 4 tx + {0..3} and 64 + 4 tx + {0..3} of dQ.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_simple_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const T* __restrict__ o, const float* __restrict__ lse,
                       float* __restrict__ delta, float* __restrict__ dq,
                       int H, int Sq, int Sk, int D, int causal, int vec,
                       Strides qs, Strides ks, Strides vs, Strides dos,
                       Strides os) {
  using R = Ring<T, kFwdFixed, kFwdSlot>;
  extern __shared__ float4 smem4[];
  float* Ps = reinterpret_cast<float*>(smem4);
  float* Ls = Ps + kFwdRows * kLdp;
  float* Ds = Ls + kFwdRows;
  float* ring = Ps + kFwdFixed;
  T* raw = reinterpret_cast<T*>(ring + R::kStages * kFwdSlot);

  const int n_slices = (D + kCols - 1) / kCols;
  const int h = blockIdx.x / n_slices;
  const int c0 = (blockIdx.x % n_slices) * kCols;
  const int b = blockIdx.y;
  // Longest causal rows first: the last q tile has the most K/V tiles.
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kFwdRows;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const T* db = dout + b * dos.b + h * dos.h;
  // Row q0 of this (b, h) in lse, delta and dq (rows of D).
  const int64_t row0 = static_cast<int64_t>(b * H + h) * Sq + q0;
  const int nd = (D + kChunk - 1) / kChunk;
  const int per = 2 * nd + kFwdKeys / kChunk;  // chunks per K/V tile
  const int kv_end = causal ? min(Sk, q0 + kFwdRows) : Sk;

  // The copy cursor, as in B1s: stage cs, K/V tile ck, place cr in the
  // tile's chunks.
  int cs = 0, ck = 0, cr = 0;
  auto issue = [&]() {
    if (ck < kv_end) {
      float* tile = ring + cs * kFwdSlot;
      T* rt = raw + cs * kFwdSlot;
      const int t = tid_now();
      if (cr < 2 * nd) {
        const bool sc = cr < nd;  // S: Q and K; dP: dO and V
        const int off = (sc ? cr : cr - nd) * kChunk;
        copy_tile<T, kFwdRows, kChunk, kLd>(tile, rt, sc ? qb : db,
                                            sc ? qs.s : dos.s, q0, Sq, off,
                                            D, vec, t);
        copy_tile<T, kFwdKeys, kChunk, kLd>(
            tile + kFwdRows * kLd, rt + kFwdRows * kLd, sc ? kb : vb,
            sc ? ks.s : vs.s, ck, Sk, off, D, vec, t);
      } else {
        copy_tile<T, kChunk, kCols, kLdc>(tile, rt, kb, ks.s,
                                          ck + (cr - 2 * nd) * kChunk, Sk,
                                          c0, D, vec, t);
      }
    }
    cp_async_commit();
    cs = cs + 1 == R::kStages ? 0 : cs + 1;
    if (++cr == per) {
      cr = 0;
      ck += kFwdKeys;
    }
  };

  auto begin = [&](bool d_chunk) -> const float* {
    cp_async_wait<R::kStages - 2>();
    const int bs = cs + 1 == R::kStages ? 0 : cs + 1;
    float* tile = ring + bs * kFwdSlot;
    if constexpr (sizeof(T) < 4) {
      if (vec) {
        const T* rt = raw + bs * kFwdSlot;
        const int t = tid_now();
        if (d_chunk) {  // a chunk of D columns: S or dP
          widen_tile<T, kFwdRows, kChunk, kLd>(tile, rt, t);
          widen_tile<T, kFwdKeys, kChunk, kLd>(tile + kFwdRows * kLd,
                                               rt + kFwdRows * kLd, t);
        } else {
          widen_tile<T, kChunk, kCols, kLdc>(tile, rt, t);
        }
      }
    }
    __syncthreads();
    issue();
    return tile;
  };

#pragma unroll
  for (int n = 0; n < R::kStages - 1; ++n) issue();

  // delta = rowsum(dO * O) in f32, the half warp ty summing rows 8 ty +
  // {0..7} (lane tx the 4-element groups 4 tx + 64 m), and lse, into
  // shared memory (read after the first chunk's barrier).  Not the rows
  // ty + 16 i of the products: the compiler would keep this pass's row
  // indices and bounds for the final store, through the K/V loop.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = 8 * ty + i;
    float sum = 0.f;
    if (q0 + r < Sq) {
      const T* drow = db + (q0 + r) * dos.s;
      const T* orow = o + b * os.b + h * os.h + (q0 + r) * os.s;
      for (int c = 4 * tx; c < D; c += 64) {
        const float4 x = load4(drow + c, D - c, vec);
        const float4 y = load4(orow + c, D - c, vec);
        sum = fmaf(x.w, y.w, fmaf(x.z, y.z, fmaf(x.y, y.y,
                                                 fmaf(x.x, y.x, sum))));
      }
    }
    sum = half_sum(sum);
    if (tx == 0) {
      Ds[r] = sum;
      Ls[r] = q0 + r < Sq ? lse[row0 + r] : 0.f;  // past Sq: ds = 0
      if (q0 + r < Sq && c0 == 0) delta[row0 + r] = sum;
    }
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < kv_end; k0 += kFwdKeys) {
    // S = Q K^T, 32 columns of D a chunk.
    float s[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    for (int dc = 0; dc < nd; ++dc) {
      const float* Qc = begin(true);
      chunk_product<8, 8, true, kFwdPipe>(s, Qc, ty, Qc + kFwdRows * kLd,
                                          tx);
    }
    // p = exp(s - lse), unrounded, into P (each thread its own entries),
    // so that S and dP are never live together.  Only a tile that crosses
    // the diagonal or Sk masks.
    const bool edge =
        k0 + kFwdKeys > Sk || (causal && k0 + kFwdKeys - 1 > q0);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = q0 + ty + 16 * i;
      const float ls = Ls[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + tx + 16 * j;
        const float x = edge && (col >= Sk || (causal && col > row))
                            ? kMasked : s[i][j];
        Ps[(ty + 16 * i) * kLdp + tx + 16 * j] = exp2f((x - ls) * kLog2e);
      }
    }

    // dP = dO V^T.
    float dp[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) dp[i][j] = 0.f;
    for (int dc = 0; dc < nd; ++dc) {
      const float* dOc = begin(true);
      chunk_product<8, 8, true, kFwdPipe>(dp, dOc, ty, dOc + kFwdRows * kLd,
                                          tx);
    }
    // ds = p (dp - delta), rounded to T (k's dtype), over p in P (read by
    // every thread after the next chunk's barrier).
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float dl = Ds[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int at = (ty + 16 * i) * kLdp + tx + 16 * j;
        Ps[at] = Elem<T>::round(Ps[at] * (dp[i][j] - dl));
      }
    }

    // dQ += dS K, 32 keys a chunk.  One operand buffer: with B1s's two,
    // B2s ran slower.
    for (int kc = 0; kc < kFwdKeys / kChunk; ++kc) {
      const float* Kc = begin(false);
      const float* dSc = Ps + kc * kChunk;
      chunk_product_pv<kLdp, false>(acc, dSc, ty, Kc, tx);
    }
  }
  cp_async_wait<0>();

  float* dqrow = dq + (row0 + ty) * D;
#pragma unroll
  for (int i = 0; i < 8; ++i, dqrow += 16 * D) {
    if (q0 + ty + 16 * i >= Sq) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = c0 + (c < 4 ? 4 * tx + c : 60 + 4 * tx + c);
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

// Whether every 4-element group that copy_tile (or B2s's load4) reads
// from the first n operands starts on a 4-element boundary (so that it
// can be one cp.async or vector load): D, their strides and their
// addresses in elements multiples of 4.
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

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* o, const void* lse, void* delta, void* dq, int B,
              int H, int Sq, int Sk, int D, int causal, const int64_t* st,
              cudaStream_t stream) {
  using R = Ring<T, kFwdFixed, kFwdSlot>;
  const int rc = prepare(flash_simple_dq_kernel<T>, R::kBytes);
  if (rc) return rc;
  const void* ptrs[5] = {q, k, v, dout, o};
  const int vec = vec_ok(sizeof(T), D, ptrs, 5, st);
  dim3 grid(H * ((D + kCols - 1) / kCols), B,
            (Sq + kFwdRows - 1) / kFwdRows);
  flash_simple_dq_kernel<T><<<grid, kThreads, R::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const T*>(o), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<float*>(dq), H, Sq, Sk, D,
      causal, vec, strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
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
struct Dq {
  template <typename... A>
  static int run(A... a) { return launch_dq<T>(a...); }
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
      !grid_ok(B, (Sq + kFwdRows - 1) / kFwdRows))
    return static_cast<int>(cudaErrorInvalidValue);
  return by_dtype<Dq>(dtype, q, k, v, dout, o, lse, delta, dq, B, H, Sq, Sk,
                      D, causal, strides, static_cast<cudaStream_t>(stream));
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
