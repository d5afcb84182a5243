// Flash attention backward for Hopper (sm_90a), bf16 in, f32 accumulate
// and out: the dq kernel (B2) and the dk/dv kernel (B3).
//
// Replaces ray_tpu/ops/flash_attention.py:_dq_kernel (:216, reached
// through _bwd_impl's pallas_call at :337) and _dkdv_kernel (:264, call
// at :368).  They compute what those kernels compute, not a
// block-by-block copy of them:
//
//   q, o, do (B, H, Sq, D) and k, v (B, H, Sk, D) bf16, q pre-scaled by
//   D**-0.5 and k/v already at q's heads (the caller expands GQA and
//   group-sums dk/dv afterwards, as the reference does); lse (B, H, Sq)
//   f32 contiguous.  B2 first computes delta = rowsum(do * o) in f32 for
//   its rows (the reference computes it outside its kernels) and writes
//   it to a (B, H, Sq) buffer that B3, launched after it on the same
//   stream, reads.  With s = q k^T (masked to -1e30 where key j > row i
//   under causal), p = exp(s - lse) and ds = p * (do v^T - delta):
//     B2: dq = ds k     (ds rounded to bf16, k's dtype, before the product)
//     B3: dv = p^T do   (p rounded to bf16, do's dtype)
//         dk = ds^T q   (ds rounded to bf16, q's dtype)
//   dq (B, H, Sq, D), dk and dv (B, H, Sk, D) are f32 and contiguous.
//   q, k, v, o and do are addressed through their batch, head and row
//   strides (D contiguous, strides multiples of 8 elements, 16-byte
//   aligned pointers: the wrapper checks), so the model's (B, S, H, D)
//   tensors are read in place.  Any Sq and Sk: the ragged edge is
//   zero-filled on load and masked.
//
// Design of B2 (mma.sync).  One thread block of 4 warps per (b, h, q
// tile of 64 rows); each warp owns 16 rows.  delta comes from the O and
// dO tiles (two threads per row) before the loop.  Q and dO fragments
// stay in registers; the block walks the K/V tiles up to the diagonal
// (all of them when non-causal), double-buffered in shared memory with
// cp.async, recomputes s and dp in two 32-wide halves, and keeps dq in
// f32 registers; every product is mma.sync m16n8k16 bf16 -> f32.
//
// Design of B3 (wgmma + TMA, warp-specialised).  One block of three
// warpgroups per (b, h, k tile of 128 keys), the k tiles with the most
// q tiles launched first.  Warpgroup 0 is the producer: it gives up
// registers (setmaxnreg) and one of its threads issues every load with
// TMA: K and V once, then 64-row tiles of Q and dO through a three-stage
// ring, each stage with a "full" and an "empty" mbarrier; its warp copies
// each tile's lse and delta rows beside them.  Warpgroups 1 and 2 are consumers that own 64
// keys each and keep their dk and dv in f32 registers.  Per q tile a
// consumer computes S^T = K Q^T and dP^T = V dO^T with wgmma m64n64k16
// reading all four tiles from shared memory, p^T = exp(s^T - lse) and
// ds^T = p^T (dp^T - delta) in registers, rounds both to bf16 in place
// (the accumulator layout of S^T is already the A-fragment layout of the
// next product), and computes dV += P^T dO and dK += dS^T Q with the
// register A operand and dO, Q read MN-major (D contiguous) from shared
// memory.  s, p and ds never leave registers.  It walks the q tiles from
// the diagonal to the end (all of them when non-causal); only the tiles
// the diagonal or the ragged edge crosses are masked.  Every block owns
// its rows of dk and dv, so no atomics are needed.  Head dimensions up
// to 64 use one 64-column box per tile, 80 to 128 two; TMA zero-fills
// the columns past D and the rows past Sq or Sk, and neither is stored.
//
// Bound.  At the main path's shape (B=8, H=8, S=2048, D=128, causal;
// 2,098,176 visible (row, key) pairs per (b, h)) B2 does 6*B*H*D*pairs
// = 1.03e11 FLOP and moves ~0.3 GB with the delta pre-pass (0.104 ms at
// 989 TFLOP/s against 0.090 ms at 3.35 TB/s), B3 8*B*H*D*pairs =
// 1.37e11 FLOP and ~0.27 GB (0.139 ms against 0.080 ms): both are bound
// by operations.  What holds B2 back is shared memory: every B operand
// of mma.sync is read from shared memory with ldmatrix by each warp, 256
// bytes per m16n8k16 product (counted from its loop) against the SM's
// 128 bytes a clock and about one such product a clock at the bf16 peak.
// B3's wgmma reads its shared-memory operands without staging them
// through registers; what is left there is the tensor cores, the
// exponentials and one block per SM, with a q tile's elementwise work not
// yet overlapped with the next tile's products inside a warpgroup.  Still
// open: wgmma for B2, and reducing GQA inside B3 instead of expanding K/V
// to q's heads.
//
// Interface: plain C, loaded with ctypes.  Kernels launch on the
// caller's stream and allocate nothing; each launcher returns
// cudaGetLastError() (0 on success).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kTileRows = 64;  // q rows and keys per tile (16 per warp)
constexpr int kHalf = 32;      // columns of s worked at a time
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMasked = -1e30f;  // the reference's mask value

using bf16 = __nv_bfloat16;

// Element strides of a (B, H, S, D) operand; D is contiguous.
struct Strides {
  int64_t b, h, s;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; src_bytes = 0 zero-fills.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col).
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [row0, row0 + 64) of a (rows, D) matrix with row stride `stride`
// (elements) into a shared tile of row stride D + 8 (the pad keeps
// ldmatrix free of bank conflicts); rows at or past `rows` are
// zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* src,
                                          int64_t stride, int row0,
                                          int rows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int kLd = D + 8;
  for (int c = threadIdx.x; c < kTileRows * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    const int gr = row0 + r;
    const bool valid = gr < rows;
    const bf16* p = src + (valid ? gr : 0) * stride + col;
    cp_async_16(tile + r * kLd + col, p, valid);
  }
}

// The A fragment of k-step `kk` for this warp's 16 rows of a shared tile.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int warp, int lane, int kk) {
  constexpr int kLd = D + 8;
  ldmatrix_x4(a, tile + (warp * 16 + (lane % 16)) * kLd + kk * 16
                     + (lane / 16) * 8);
}

// B fragments (two 8-wide n-tiles) of X^T where X is a shared tile whose
// rows are the n index: rows [n0, n0 + 16), k-step `kk` over D.
template <int D>
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4],
                                            const bf16* tile, int lane,
                                            int n0, int kk) {
  constexpr int kLd = D + 8;
  ldmatrix_x4(b, tile + (n0 + (lane % 8) + (lane / 16) * 8) * kLd
                     + kk * 16 + ((lane / 8) % 2) * 8);
}

// B fragments (two 8-wide n-tiles over D) of a shared tile whose rows are
// the reduction index: rows [r0, r0 + 16), columns [np*16, np*16 + 16).
template <int D>
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[4],
                                            const bf16* tile, int lane,
                                            int r0, int np) {
  constexpr int kLd = D + 8;
  ldmatrix_x4_trans(b, tile + (r0 + (lane % 8) + ((lane / 8) % 2) * 8) * kLd
                           + np * 16 + (lane / 16) * 8);
}

// Accumulator fragments of 4 n-tiles (32 columns) -> 2 A fragments.
__device__ __forceinline__ void pack_a(uint32_t (&a)[2][4],
                                       const float (&c)[4][4]) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int half = (n % 2) * 2;
    a[n / 2][half] = pack_bf16(c[n][0], c[n][1]);
    a[n / 2][half + 1] = pack_bf16(c[n][2], c[n][3]);
  }
}

template <int D>
__device__ __forceinline__ void store_rows_f32(float* out, int64_t row0,
                                               int row, int rows, int t,
                                               const float (&acc)[D / 8][4],
                                               int i) {
  if (row >= rows) return;
  float* orow = out + (row0 + row) * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<float2*>(orow + n * 8 + 2 * t) =
        make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

// ---------------------------------------------------------------------------
// B2: dq
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const bf16* __restrict__ dout,
                    const bf16* __restrict__ o,
                    const float* __restrict__ lse,
                    float* __restrict__ delta, float* __restrict__ dq,
                    int H, int Sq, int Sk, int causal, Strides qs,
                    Strides ks, Strides vs, Strides dos, Strides os) {
  static_assert(D % 16 == 0 && D <= 128, "D must be a multiple of 16");
  constexpr int kSteps = D / 16;   // k-steps of Q K^T over D
  constexpr int kTilesO = D / 8;   // 8-wide column tiles of dQ
  constexpr int kTile = kTileRows * (D + 8);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);  // [2][kTile]
  bf16* sV = sK + 2 * kTile;                 // [2][kTile]
  __shared__ float sDelta[kTileRows];

  // Longest causal rows first: the last q tile has the most k tiles.
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row within 8
  const int t = lane & 3;   // fragment column pair
  const int q0 = qt * kTileRows;
  const int64_t row_off = (int64_t)(b * H + h) * Sq;

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  const bf16* dob = dout + b * dos.b + h * dos.h;
  const bf16* ob = o + b * os.b + h * os.h;

  // Q and dO: stage through the second buffers, keep this warp's 16
  // rows as A fragments for the whole loop.  O only feeds delta.
  load_tile<D>(sK + kTile, qb, qs.s, q0, Sq);
  load_tile<D>(sV + kTile, dob, dos.s, q0, Sq);
  load_tile<D>(sK, ob, os.s, q0, Sq);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  {
    // delta = rowsum(dO * O) in f32, two threads per row.
    constexpr int kLd = D + 8;
    const int r = threadIdx.x / 2;
    const int c0 = (threadIdx.x % 2) * (D / 2);
    const bf16* pd = sV + kTile + r * kLd + c0;
    const bf16* po = sK + r * kLd + c0;
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < D / 2; c += 2) {
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(pd + c));
      const float2 b2 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(po + c));
      sum = fmaf(a.x, b2.x, sum);
      sum = fmaf(a.y, b2.y, sum);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (threadIdx.x % 2 == 0) {
      sDelta[r] = sum;
      if (q0 + r < Sq) delta[row_off + q0 + r] = sum;
    }
  }
  uint32_t qf[kSteps][4], dof[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    load_a<D>(qf[kk], sK + kTile, warp, lane, kk);
    load_a<D>(dof[kk], sV + kTile, warp, lane, kk);
  }
  __syncthreads();

  const int row_a = q0 + warp * 16 + g;
  const int row_b = row_a + 8;
  // lse in log2 units; rows past Sq are never stored.
  const float lse2[2] = {
      row_a < Sq ? lse[row_off + row_a] * kLog2e : 0.f,
      row_b < Sq ? lse[row_off + row_b] * kLog2e : 0.f};
  const float dlt[2] = {sDelta[warp * 16 + g], sDelta[warp * 16 + g + 8]};

  float acc[kTilesO][4];
#pragma unroll
  for (int n = 0; n < kTilesO; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }

  const int kv_end = causal ? min(Sk, q0 + kTileRows) : Sk;
  const int n_tiles = (kv_end + kTileRows - 1) / kTileRows;

  // Double-buffered K/V: tile j+1 loads while tile j is worked.  Every
  // step commits one group (empty past the last tile), so wait_group<1>
  // always means "all but the newest".
  if (n_tiles > 0) {
    load_tile<D>(sK, kb, ks.s, 0, Sk);
    load_tile<D>(sV, vb, vs.s, 0, Sk);
  }
  cp_async_commit();

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kTileRows;
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_tile<D>(sK + (buf ^ 1) * kTile, kb, ks.s, k0 + kTileRows, Sk);
      load_tile<D>(sV + (buf ^ 1) * kTile, vb, vs.s, k0 + kTileRows, Sk);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* tK = sK + buf * kTile;
    const bf16* tV = sV + buf * kTile;
    const bool masked = k0 + kTileRows > Sk ||
                        (causal && k0 + kTileRows - 1 > q0);

#pragma unroll
    for (int hf = 0; hf < kTileRows / kHalf; ++hf) {
      // S = Q K^T and dP = dO V^T for 16 rows x 32 keys.
      float s[4][4], dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const int n0 = hf * kHalf + np * 16;
          uint32_t bf[4];
          load_b_rows<D>(bf, tK, lane, n0, kk);
          mma_bf16(s[2 * np], qf[kk], bf[0], bf[1]);
          mma_bf16(s[2 * np + 1], qf[kk], bf[2], bf[3]);
          load_b_rows<D>(bf, tV, lane, n0, kk);
          mma_bf16(dp[2 * np], dof[kk], bf[0], bf[1]);
          mma_bf16(dp[2 * np + 1], dof[kk], bf[2], bf[3]);
        }
      }
      // p = exp(s - lse), ds = p (dp - delta), in place of s.
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float sv = s[n][e];
          if (masked) {
            const int col = k0 + hf * kHalf + n * 8 + 2 * t + (e & 1);
            const int row = e < 2 ? row_a : row_b;
            if (col >= Sk || (causal && col > row)) sv = kMasked;
          }
          const float p = exp2f(fmaf(sv, kLog2e, -lse2[e >> 1]));
          s[n][e] = p * (dp[n][e] - dlt[e >> 1]);
        }
      }
      uint32_t dsf[2][4];
      pack_a(dsf, s);
      // dQ += dS K over this half's 32 keys.
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
        for (int np = 0; np < kTilesO / 2; ++np) {
          uint32_t bf[4];
          load_b_cols<D>(bf, tK, lane, hf * kHalf + kk * 16, np);
          mma_bf16(acc[2 * np], dsf[kk], bf[0], bf[1]);
          mma_bf16(acc[2 * np + 1], dsf[kk], bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with buf before it is reloaded
  }
  cp_async_wait<0>();

  store_rows_f32<D>(dq, row_off, row_a, Sq, t, acc, 0);
  store_rows_f32<D>(dq, row_off, row_b, Sq, t, acc, 1);
}

// ---------------------------------------------------------------------------
// B3: dk, dv (wgmma + TMA, warp-specialised)
// ---------------------------------------------------------------------------

constexpr int kDkdvKeys = 128;    // keys per block, 64 per consumer warpgroup
constexpr int kDkdvRows = 64;     // q rows per tile of the ring
constexpr int kDkdvStages = 3;    // depth of the Q/dO ring
constexpr int kDkdvThreads = 384;  // producer + 2 consumer warpgroups
constexpr int kKeyBox = kDkdvKeys * 128;  // one (128 keys, 64 columns) box
constexpr int kRowBox = kDkdvRows * 128;  // one (64 rows, 64 columns) box

// Shared memory of one B3 block, head dimension padded to DP (64 or 128).
template <int DP>
struct DkdvSmem {
  static constexpr int kKV = DP / 64 * kKeyBox;      // a K or V tile
  static constexpr int kRows = DP / 64 * kRowBox;    // a Q or dO tile
  static constexpr int kK = 0;
  static constexpr int kV = kKV;
  static constexpr int kQ = 2 * kKV;                           // [stages]
  static constexpr int kDo = kQ + kDkdvStages * kRows;         // [stages]
  static constexpr int kLse = kDo + kDkdvStages * kRows;       // [stages][64]
  static constexpr int kDelta = kLse + kDkdvStages * kDkdvRows * 4;
  static constexpr int kBars = kDelta + kDkdvStages * kDkdvRows * 4;
  // full_kv, full[stages], empty[stages]; then the alignment slack.
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kDkdvStages) + 1024;
};

template <int DP>
__global__ void __launch_bounds__(kDkdvThreads, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int H,
                      int Sq, int Sk, int D, int causal) {
  using L = DkdvSmem<DP>;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = full_kv + 1;
  uint64_t* empty = full + kDkdvStages;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  // Causal: the first k tile has the most q tiles, and runs first.
  const int k0 = blockIdx.z * kDkdvKeys;
  // Rows at or below this k tile's diagonal.
  const int first = causal ? k0 / kDkdvRows : 0;
  const int n_qt = (Sq + kDkdvRows - 1) / kDkdvRows;
  const int64_t row_off = static_cast<int64_t>(b * H + h) * Sq;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < kDkdvStages; ++s) {
      // The TMA thread's expect_tx and the 32 lanes that copy lse/delta.
      mbar_init(full + s, 33);
      mbar_init(empty + s, 2);  // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer warpgroup: one thread issues every TMA load; its warp
    // copies each tile's lse and delta rows (64 f32 each, at any
    // alignment) and arrives on the same "full" barrier.
    setmaxnreg_dec<24>();
    if (threadIdx.x < 32 && first < n_qt) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(full_kv, 2 * L::kKV);
        for (int x = 0; x < DP / 64; ++x) {
          tma_load_4d(smem + L::kK + x * kKeyBox, &tk, full_kv, 64 * x, k0,
                      h, b);
          tma_load_4d(smem + L::kV + x * kKeyBox, &tv, full_kv, 64 * x, k0,
                      h, b);
        }
      }
      for (int i = first, it = 0; i < n_qt; ++i, ++it) {
        const int st = it % kDkdvStages;
        mbar_wait(empty + st, ((it / kDkdvStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(full + st, 2 * L::kRows);
          for (int x = 0; x < DP / 64; ++x) {
            tma_load_4d(smem + L::kQ + st * L::kRows + x * kRowBox, &tq,
                        full + st, 64 * x, i * kDkdvRows, h, b);
            tma_load_4d(smem + L::kDo + st * L::kRows + x * kRowBox, &tdo,
                        full + st, 64 * x, i * kDkdvRows, h, b);
          }
        }
        float* tl = reinterpret_cast<float*>(smem + L::kLse) + st * kDkdvRows;
        float* td =
            reinterpret_cast<float*>(smem + L::kDelta) + st * kDkdvRows;
        for (int r = lane; r < kDkdvRows; r += 32) {
          const int row = i * kDkdvRows + r;  // rows past Sq are masked
          tl[r] = row < Sq ? lse[row_off + row] : 0.f;
          td[r] = row < Sq ? delta[row_off + row] : 0.f;
        }
        mbar_arrive(full + st);  // release: the consumers see tl, td
      }
    }
  } else {
    // Consumer warpgroups: 64 keys each.
    setmaxnreg_inc<240>();
    const int tid = threadIdx.x % 128;
    const int wk0 = k0 + (threadIdx.x / 128 - 1) * 64;
    const int key_a = wk0 + (tid / 32) * 16 + (tid % 32) / 4;
    const int key_b = key_a + 8;
    const int t = tid % 4;  // column pair within each 8-column group

    float dk_acc[DP / 2], dv_acc[DP / 2];  // 64 keys x DP each
#pragma unroll
    for (int r = 0; r < DP / 2; ++r) dk_acc[r] = dv_acc[r] = 0.f;

    if (first < n_qt) {
      const uint32_t sk = smem_u32(smem + L::kK) + (wk0 - k0) * 128;
      const uint32_t sv = smem_u32(smem + L::kV) + (wk0 - k0) * 128;
      float s[kDkdvRows / 2], dp[kDkdvRows / 2];  // 64 keys x 64 q rows
      uint32_t pf[kDkdvRows / 16][4], dsf[kDkdvRows / 16][4];
      mbar_wait(full_kv, 0);
      for (int i = first, it = 0; i < n_qt; ++i, ++it) {
        const int st = it % kDkdvStages;
        mbar_wait(full + st, (it / kDkdvStages) & 1);
        const int q0 = i * kDkdvRows;
        const uint32_t sq = smem_u32(smem + L::kQ + st * L::kRows);
        const uint32_t sdo = smem_u32(smem + L::kDo + st * L::kRows);

        // S^T = K Q^T and dP^T = V dO^T: all four tiles K-major; a
        // 16-wide step over D moves 32 bytes inside a 64-column box.  The
        // steps past D add TMA's zero columns.
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const uint32_t a = (kk / 4) * kKeyBox + (kk % 4) * 32;
          const uint32_t c = (kk / 4) * kRowBox + (kk % 4) * 32;
          wgmma_ss<0>(s, desc_sw128(sk + a, 16, 1024),
                      desc_sw128(sq + c, 16, 1024), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const uint32_t a = (kk / 4) * kKeyBox + (kk % 4) * 32;
          const uint32_t c = (kk / 4) * kRowBox + (kk % 4) * 32;
          wgmma_ss<0>(dp, desc_sw128(sv + a, 16, 1024),
                      desc_sw128(sdo + c, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);

        // p^T = exp(s^T - lse), ds^T = p^T (dp^T - delta); columns are q
        // rows, so lse and delta come from the tile's shared copy.  Only
        // tiles the diagonal or the ragged edge crosses are masked.
        const bool masked = q0 + kDkdvRows > Sq ||
                            (causal && wk0 + 63 > q0);
        const float* tl =
            reinterpret_cast<const float*>(smem + L::kLse) + st * kDkdvRows;
        const float* td = reinterpret_cast<const float*>(smem + L::kDelta) +
                          st * kDkdvRows;
#pragma unroll
        for (int n = 0; n < kDkdvRows / 8; ++n) {
          const float2 l2 = *reinterpret_cast<const float2*>(tl + 8 * n + 2 * t);
          const float2 d2 = *reinterpret_cast<const float2*>(td + 8 * n + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 4 * n + e;
            float sv = s[r];
            if (masked) {
              const int row = q0 + 8 * n + 2 * t + (e & 1);
              const int key = (e & 2) ? key_b : key_a;
              if (row >= Sq || (causal && key > row)) sv = kMasked;
            }
            const float lr = (e & 1) ? l2.y : l2.x;
            const float p = exp2f(fmaf(sv, kLog2e, -lr * kLog2e));
            s[r] = p;
            dp[r] = p * (dp[r] - ((e & 1) ? d2.y : d2.x));
          }
          // Accumulator registers 8k..8k+7, in pairs, are the A fragment
          // of q rows 16k..16k+15.
          pf[n / 2][(n % 2) * 2] = hopper::pack_bf16(s[4 * n], s[4 * n + 1]);
          pf[n / 2][(n % 2) * 2 + 1] =
              hopper::pack_bf16(s[4 * n + 2], s[4 * n + 3]);
          dsf[n / 2][(n % 2) * 2] =
              hopper::pack_bf16(dp[4 * n], dp[4 * n + 1]);
          dsf[n / 2][(n % 2) * 2 + 1] =
              hopper::pack_bf16(dp[4 * n + 2], dp[4 * n + 3]);
        }

        // dV += P^T dO and dK += dS^T Q: the A operands from registers,
        // dO and Q MN-major (their rows are the reduction index); a
        // 16-row step moves 2048 bytes.
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDkdvRows / 16; ++kk) {
          wgmma_rs<1>(dv_acc, pf[kk],
                      desc_sw128(sdo + kk * 2048, kRowBox, 1024), 1);
        }
#pragma unroll
        for (int kk = 0; kk < kDkdvRows / 16; ++kk) {
          wgmma_rs<1>(dk_acc, dsf[kk],
                      desc_sw128(sq + kk * 2048, kRowBox, 1024), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv_acc);
        fence_regs(dk_acc);
        fence_regs(pf);
        fence_regs(dsf);
        if (tid == 0) mbar_arrive(empty + st);
      }
    }

    // Each block owns its keys' rows of dk and dv: plain stores.
    const int64_t key_off = static_cast<int64_t>(b * H + h) * Sk;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = i ? key_b : key_a;
      if (key >= Sk) continue;
      float* dkrow = dk + (key_off + key) * D;
      float* dvrow = dv + (key_off + key) * D;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        if (8 * j < D) {
          *reinterpret_cast<float2*>(dkrow + 8 * j + 2 * t) =
              make_float2(dk_acc[4 * j + 2 * i], dk_acc[4 * j + 2 * i + 1]);
          *reinterpret_cast<float2*>(dvrow + 8 * j + 2 * t) =
              make_float2(dv_acc[4 * j + 2 * i], dv_acc[4 * j + 2 * i + 1]);
        }
      }
    }
  }
}

struct Args {
  const bf16 *q, *k, *v, *dout, *o;
  const float* lse;
  float* delta;
  int B, H, Sq, Sk, causal;
  Strides qs, ks, vs, dos, os;
};

template <int D>
int launch_dq(const Args& a, float* dq, cudaStream_t stream) {
  constexpr int smem = 4 * kTileRows * (D + 8) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.Sq + kTileRows - 1) / kTileRows, a.H, a.B);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      a.q, a.k, a.v, a.dout, a.o, a.lse, a.delta, dq, a.H, a.Sq, a.Sk,
      a.causal, a.qs, a.ks, a.vs, a.dos, a.os);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_dkdv(const Args& a, int D, const int64_t* strides, float* dk,
                float* dv, cudaStream_t stream) {
  if (a.B > 65535 || (a.Sk + kDkdvKeys - 1) / kDkdvKeys > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv, tdo;
  int rc = hopper::encode_bhsd(&tq, a.q, a.B, a.H, a.Sq, D, strides,
                               kDkdvRows);
  if (rc == 0)
    rc = hopper::encode_bhsd(&tk, a.k, a.B, a.H, a.Sk, D, strides + 3,
                             kDkdvKeys);
  if (rc == 0)
    rc = hopper::encode_bhsd(&tv, a.v, a.B, a.H, a.Sk, D, strides + 6,
                             kDkdvKeys);
  if (rc == 0)
    rc = hopper::encode_bhsd(&tdo, a.dout, a.B, a.H, a.Sq, D, strides + 9,
                             kDkdvRows);
  if (rc != 0) return rc;
  constexpr int smem = DkdvSmem<DP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(a.H, a.B, (a.Sk + kDkdvKeys - 1) / kDkdvKeys);
  flash_bwd_dkdv_kernel<DP><<<grid, kDkdvThreads, smem, stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, dk, dv, a.H, a.Sq, a.Sk, D, a.causal);
  return static_cast<int>(cudaGetLastError());
}

// Checks the shared arguments; returns 0 or cudaErrorInvalidValue.
int make_args(Args& a, const void* q, const void* k, const void* v,
              const void* dout, const void* o, const void* lse, void* delta,
              int B, int H, int Sq, int Sk, int causal,
              const int64_t* strides) {
  // strides: 15 element strides, (batch, head, row) of q, k, v, do, o.
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 15; ++i)
    if (strides[i] % 8) return static_cast<int>(cudaErrorInvalidValue);
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.o = static_cast<const bf16*>(o);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.B = B;
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  a.causal = causal;
  a.qs = Strides{strides[0], strides[1], strides[2]};
  a.ks = Strides{strides[3], strides[4], strides[5]};
  a.vs = Strides{strides[6], strides[7], strides[8]};
  a.dos = Strides{strides[9], strides[10], strides[11]};
  a.os = Strides{strides[12], strides[13], strides[14]};
  return 0;
}

}  // namespace

#define RT_D_CASES(X) X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128)

// B2, and the delta pre-pass: writes delta (B, H, Sq) f32 and dq.
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const void* o, const void* lse,
                                 void* delta, void* dq, int B, int H,
                                 int Sq, int Sk, int D, int causal,
                                 const int64_t* strides, void* stream) {
  Args a;
  const int rc = make_args(a, q, k, v, dout, o, lse, delta, B, H, Sq, Sk,
                           causal, strides);
  if (rc) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(dq);
  switch (D) {
#define RT_CASE(d) case d: return launch_dq<d>(a, out, s);
    RT_D_CASES(RT_CASE)
#undef RT_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// B3: reads the delta that B2 wrote; writes dk and dv.
extern "C" int flash_bwd_dkdv_bf16(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* o, const void* lse,
                                   void* delta, void* dk, void* dv, int B,
                                   int H, int Sq, int Sk, int D, int causal,
                                   const int64_t* strides, void* stream) {
  Args a;
  const int rc = make_args(a, q, k, v, dout, o, lse, delta, B, H, Sq, Sk,
                           causal, strides);
  if (rc) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D < 16 || D > 128 || D % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  float* odk = static_cast<float*>(dk);
  float* odv = static_cast<float*>(dv);
  if (D <= 64) return launch_dkdv<64>(a, D, strides, odk, odv, s);
  return launch_dkdv<128>(a, D, strides, odk, odv, s);
}
