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
// Both kernels are wgmma + TMA kernels, warp-specialised: one block of
// three warpgroups.  Warpgroup 0 is the producer: it gives up registers
// (setmaxnreg) and one of its threads issues every load with TMA into
// shared memory, the block's own tiles once and the other operand's tiles
// through a three-stage ring, each stage with a "full" and an "empty"
// mbarrier.  Warpgroups 1 and 2 are consumers of 64 rows (B2: q rows;
// B3: keys) each that take the freed registers.  Head dimensions up to 64
// use one 64-column box per tile, 80 to 128 two; TMA zero-fills the
// columns past D and the rows past Sq or Sk, and neither is stored.  Only
// the tiles the causal diagonal or the ragged edge crosses are masked.
//
// Design of B2.  One block per (b, h, q tile of 128 rows), the q tiles
// with the most keys launched first.  Q and dO are loaded once; K and V
// come in 64-key tiles, walked from the diagonal (all of them when
// non-causal) down to the first.  Before the loop each consumer computes
// delta for its rows from O and dO in global memory (the four threads
// that share a row pair in the accumulator layout split the columns and
// sum with quad shuffles) and reads lse with plain loads; once Q and dO
// have landed it keeps its rows of both as register A fragments.  Per K/V
// tile it computes S = Q K^T and dP = dO V^T with wgmma m64n64k16 from
// those registers and K, V read K-major from shared memory, p = exp(s -
// lse) and ds = p (dp - delta) in registers, rounds ds to bf16 in place
// (the accumulator layout of S is already the A-fragment layout of the
// next product), and computes dQ += dS K with dS as the register A
// operand and K read MN-major (D contiguous) from the same tile.  s, p
// and ds never leave registers, and dq stays in f32 registers until the
// end.  The first
// consumer's rows end 64 before the second's, so under causal it skips
// the tile above its diagonal; a consumer whose rows all lie past Sq
// skips every tile.  A skipped tile still releases its stage, once all
// four warps of the warpgroup have seen it land (a named barrier).
//
// Design of B3.  One block per (b, h, k tile of 128 keys), the k tiles
// with the most q tiles launched first.  K and V are loaded once, then
// 64-row tiles of Q and dO come through the ring; the producer's warp
// copies each tile's lse and delta rows beside them.  The consumers keep
// their dk and dv in f32 registers.  Per q tile a consumer computes S^T =
// K Q^T and dP^T = V dO^T with wgmma m64n64k16 reading all four tiles
// from shared memory, p^T = exp(s^T - lse) and ds^T = p^T (dp^T - delta)
// in registers, rounds both to bf16 in place, and computes dV += P^T dO
// and dK += dS^T Q with the register A operand and dO, Q read MN-major
// from shared memory.  It walks the q tiles from the diagonal to the end
// (all of them when non-causal).  Every block owns its rows of dk and dv,
// so no atomics are needed.
//
// Bound.  At the main path's shape (B=8, H=8, S=2048, D=128, causal;
// 2,098,176 visible (row, key) pairs per (b, h)) B2 does 6*B*H*D*pairs
// = 1.03e11 FLOP and moves ~0.24 GB with the delta pre-pass (0.104 ms at
// 989 TFLOP/s against 0.070 ms at 3.35 TB/s), B3 8*B*H*D*pairs =
// 1.37e11 FLOP and ~0.27 GB (0.139 ms against 0.080 ms): both are bound
// by operations.  wgmma reads its shared-memory operands without staging
// them through registers; what is left is the tensor cores, the
// exponentials, one block per SM, and shared memory itself: an m64n64k16
// product with both operands in shared memory reads 4 KB in the 32
// clocks the tensor cores take for it, the SM's 128 bytes a clock.  So
// B2 holds Q and dO in registers, and a consumer reads 48 KB of shared
// memory per 64 x 64 tile instead of 80 KB; B3's S^T and dP^T still read
// both operands there.  A tile's elementwise work is not yet overlapped
// with the next tile's products inside a warpgroup.  Both kernels recompute S and dP: 14
// units of D * pairs FLOP for the pair against 10 for a backward that
// computes dq beside dk/dv with atomics.  Still open: that, and reducing
// GQA inside B3 instead of expanding K/V to q's heads.
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

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMasked = -1e30f;  // the reference's mask value

using bf16 = __nv_bfloat16;

// Element strides of a (B, H, S, D) operand; D is contiguous.
struct Strides {
  int64_t b, h, s;
};

// ---------------------------------------------------------------------------
// B2: dq (wgmma + TMA, warp-specialised)
// ---------------------------------------------------------------------------

constexpr int kDqRows = 128;    // q rows per block, 64 per consumer warpgroup
constexpr int kDqKeys = 64;     // keys per K/V tile of the ring
constexpr int kDqStages = 3;    // depth of the K/V ring
constexpr int kDqThreads = 384;  // producer + 2 consumer warpgroups
constexpr int kDqRowBox = kDqRows * 128;  // one (128 rows, 64 columns) box
constexpr int kDqKeyBox = kDqKeys * 128;  // one (64 keys, 64 columns) box

// Shared memory of one B2 block, head dimension padded to DP (64 or 128).
template <int DP>
struct DqSmem {
  static constexpr int kRows = DP / 64 * kDqRowBox;  // the Q or dO tile
  static constexpr int kKV = DP / 64 * kDqKeyBox;    // a K or V tile
  static constexpr int kQ = 0;
  static constexpr int kDo = kRows;
  static constexpr int kK = 2 * kRows;                  // [stages]
  static constexpr int kV = kK + kDqStages * kKV;       // [stages]
  static constexpr int kBars = kV + kDqStages * kKV;
  // full_q, full[stages], empty[stages]; then the alignment slack.
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kDqStages) + 1024;
};

// acc + sum over 8 columns of a * b, both eight bf16 in 16 bytes.
__device__ __forceinline__ float dot8(uint4 a, uint4 b, float acc) {
  const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(pa[i]);
    const float2 y = __bfloat1622float2(pb[i]);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
  }
  return acc;
}

template <int DP>
__global__ void __launch_bounds__(kDqThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const bf16* __restrict__ dout,
                    const bf16* __restrict__ o,
                    const float* __restrict__ lse,
                    float* __restrict__ delta, float* __restrict__ dq, int H,
                    int Sq, int Sk, int D, int causal, Strides dos,
                    Strides os) {
  using L = DqSmem<DP>;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = full_q + 1;
  uint64_t* empty = full + kDqStages;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  // Causal: the last q tile has the most K/V tiles, and runs first.
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kDqRows;
  const int kv_end = causal ? min(Sk, q0 + kDqRows) : Sk;
  const int n_tiles = (kv_end + kDqKeys - 1) / kDqKeys;
  const int64_t row_off = static_cast<int64_t>(b * H + h) * Sq;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 2);  // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer warpgroup: one thread issues every load, Q and dO once,
    // then the K/V tiles from the last (the diagonal's) to the first.
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_q, 2 * L::kRows);
      for (int x = 0; x < DP / 64; ++x) {
        tma_load_4d(smem + L::kQ + x * kDqRowBox, &tq, full_q, 64 * x, q0,
                    h, b);
        tma_load_4d(smem + L::kDo + x * kDqRowBox, &tdo, full_q, 64 * x, q0,
                    h, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int kt = n_tiles - 1 - it;
        const int st = it % kDqStages;
        mbar_wait(empty + st, ((it / kDqStages) & 1) ^ 1);
        mbar_expect_tx(full + st, 2 * L::kKV);
        for (int x = 0; x < DP / 64; ++x) {
          tma_load_4d(smem + L::kK + st * L::kKV + x * kDqKeyBox, &tk,
                      full + st, 64 * x, kt * kDqKeys, h, b);
          tma_load_4d(smem + L::kV + st * L::kKV + x * kDqKeyBox, &tv,
                      full + st, 64 * x, kt * kDqKeys, h, b);
        }
      }
    }
  } else {
    // Consumer warpgroups: 64 q rows each.
    setmaxnreg_inc<240>();
    const int tid = threadIdx.x % 128;
    const int wq0 = q0 + (threadIdx.x / 128 - 1) * 64;
    const int row_a = wq0 + (tid / 32) * 16 + (tid % 32) / 4;
    const int row_b = row_a + 8;
    const int t = tid % 4;  // column pair within each 8-column group
    const bool live = wq0 < Sq;

    // delta = rowsum(dO * O) in f32 and lse (log2 units) for rows a and
    // b; the quad's four threads take every fourth 16-byte chunk of a
    // row.  Rows past Sq are never stored.
    float dlt[2], lse2[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = i ? row_b : row_a;
      float sum = 0.f;
      if (row < Sq) {
        const bf16* orow = o + b * os.b + h * os.h + row * os.s;
        const bf16* drow = dout + b * dos.b + h * dos.h + row * dos.s;
        for (int c = 8 * t; c < D; c += 32) {
          sum = dot8(*reinterpret_cast<const uint4*>(orow + c),
                     *reinterpret_cast<const uint4*>(drow + c), sum);
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      dlt[i] = sum;
      lse2[i] = row < Sq ? lse[row_off + row] * kLog2e : 0.f;
      if (t == 0 && row < Sq) delta[row_off + row] = sum;
    }

    float acc[DP / 2];  // dQ: 64 rows x DP
#pragma unroll
    for (int r = 0; r < DP / 2; ++r) acc[r] = 0.f;
    float s[kDqKeys / 2], dp[kDqKeys / 2];  // 64 rows x 64 keys
    uint32_t dsf[kDqKeys / 16][4];         // dS as A fragments, 16 keys each

    // This warpgroup's rows of Q and dO as register A fragments, read once
    // from the swizzled tiles, so that S and dP read only K and V from
    // shared memory.  a[j] of a 16-column step holds row r + 8 (j & 1),
    // columns 2t + 8 (j >> 1); the 128-byte swizzle puts 16-byte chunk c
    // of row r at c ^ (r % 8).
    uint32_t qf[DP / 16][4], dof[DP / 16][4];
    mbar_wait(full_q, 0);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = row_a - q0 + (j & 1) * 8;  // row of the 128-row box
        const int off = (kk / 4) * kDqRowBox + r * 128 +
                        ((((kk % 4) * 2 + (j >> 1)) ^ (r & 7)) * 16) + 4 * t;
        qf[kk][j] = *reinterpret_cast<const uint32_t*>(smem + L::kQ + off);
        dof[kk][j] = *reinterpret_cast<const uint32_t*>(smem + L::kDo + off);
      }
    }

    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kDqStages;
      mbar_wait(full + st, (it / kDqStages) & 1);
      const int k0 = (n_tiles - 1 - it) * kDqKeys;
      bool skip = !live || (causal && k0 > wq0 + 63);
      if (skip) {
        // Release the stage only once every warp of the warpgroup has
        // seen this phase of full[st]: after the refill completes the
        // next, a warp still waiting on this parity would wait for a
        // phase that needs its own warpgroup's release.
        bar_sync(threadIdx.x / 128, 128);
        if (tid == 0) mbar_arrive(empty + st);
        continue;
      }
      const uint32_t sk = smem_u32(smem + L::kK + st * L::kKV);
      const uint32_t sv = smem_u32(smem + L::kV + st * L::kKV);

      // S = Q K^T and dP = dO V^T: K and V K-major; a 16-wide step over
      // D moves 32 bytes inside a 64-column box.  The steps past D add
      // TMA's zero columns.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t c = (kk / 4) * kDqKeyBox + (kk % 4) * 32;
        wgmma_rs<0>(s, qf[kk], desc_sw128(sk + c, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t c = (kk / 4) * kDqKeyBox + (kk % 4) * 32;
        wgmma_rs<0>(dp, dof[kk], desc_sw128(sv + c, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // p = exp(s - lse), ds = p (dp - delta), rounded to bf16 in place:
      // accumulator registers 8k..8k+7, in pairs, are the A fragment of
      // keys 16k..16k+15.
      const bool masked = k0 + kDqKeys > Sk ||
                          (causal && k0 + kDqKeys - 1 > wq0);
#pragma unroll
      for (int r = 0; r < kDqKeys / 2; r += 2) {
        const int i = (r >> 1) & 1;  // row a or row b
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[r + e];
          if (masked) {
            const int key = k0 + 8 * (r / 4) + 2 * t + e;
            const int row = i ? row_b : row_a;
            if (key >= Sk || (causal && key > row)) x = kMasked;
          }
          const float p = exp2f(fmaf(x, kLog2e, -lse2[i]));
          ds[e] = p * (dp[r + e] - dlt[i]);
        }
        dsf[r / 8][(r % 8) / 2] = pack_bf16(ds[0], ds[1]);
      }

      // dQ += dS K: dS from registers, K MN-major (its rows are the
      // reduction index); a 16-key step moves 16 rows (2048 bytes).
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDqKeys / 16; ++kk) {
        wgmma_rs<1>(acc, dsf[kk], desc_sw128(sk + kk * 2048, kDqKeyBox, 1024),
                    1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(dsf);
      if (tid == 0) mbar_arrive(empty + st);
    }

    // Each block owns its rows of dq: plain stores.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = i ? row_b : row_a;
      if (row >= Sq) continue;
      float* dqrow = dq + (row_off + row) * D;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        if (8 * j < D) {
          *reinterpret_cast<float2*>(dqrow + 8 * j + 2 * t) =
              make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
        }
      }
    }
  }
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

// The operands and dimensions both launchers share, checked by make_args.
struct Args {
  const bf16 *q, *k, *v, *dout, *o;
  const float* lse;
  float* delta;
  int B, H, Sq, Sk, D, causal;
  const int64_t* strides;  // 15: (batch, head, row) of q, k, v, do, o
  Strides dos, os;
};

// The four TMA maps of a launch: q and do in boxes of `q_rows` rows, k
// and v in boxes of `k_rows` keys.  Returns 0 or a CUDA error code.
int encode_maps(const Args& a, int q_rows, int k_rows, CUtensorMap* tq,
                CUtensorMap* tk, CUtensorMap* tv, CUtensorMap* tdo) {
  const int64_t* st = a.strides;
  int rc = hopper::encode_bhsd(tq, a.q, a.B, a.H, a.Sq, a.D, st, q_rows);
  if (rc == 0)
    rc = hopper::encode_bhsd(tk, a.k, a.B, a.H, a.Sk, a.D, st + 3, k_rows);
  if (rc == 0)
    rc = hopper::encode_bhsd(tv, a.v, a.B, a.H, a.Sk, a.D, st + 6, k_rows);
  if (rc == 0)
    rc = hopper::encode_bhsd(tdo, a.dout, a.B, a.H, a.Sq, a.D, st + 9,
                             q_rows);
  return rc;
}

template <int DP>
int launch_dq(const Args& a, float* dq, cudaStream_t stream) {
  const int n_qt = (a.Sq + kDqRows - 1) / kDqRows;
  if (a.B > 65535 || n_qt > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv, tdo;
  const int rc = encode_maps(a, kDqRows, kDqKeys, &tq, &tk, &tv, &tdo);
  if (rc != 0) return rc;
  constexpr int smem = DqSmem<DP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(a.H, a.B, n_qt);
  flash_bwd_dq_kernel<DP><<<grid, kDqThreads, smem, stream>>>(
      tq, tk, tv, tdo, a.dout, a.o, a.lse, a.delta, dq, a.H, a.Sq, a.Sk, a.D,
      a.causal, a.dos, a.os);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_dkdv(const Args& a, float* dk, float* dv, cudaStream_t stream) {
  if (a.B > 65535 || (a.Sk + kDkdvKeys - 1) / kDkdvKeys > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv, tdo;
  const int rc = encode_maps(a, kDkdvRows, kDkdvKeys, &tq, &tk, &tv, &tdo);
  if (rc != 0) return rc;
  constexpr int smem = DkdvSmem<DP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(a.H, a.B, (a.Sk + kDkdvKeys - 1) / kDkdvKeys);
  flash_bwd_dkdv_kernel<DP><<<grid, kDkdvThreads, smem, stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, dk, dv, a.H, a.Sq, a.Sk, a.D,
      a.causal);
  return static_cast<int>(cudaGetLastError());
}

// Checks the shared arguments; returns 0 or cudaErrorInvalidValue.
int make_args(Args& a, const void* q, const void* k, const void* v,
              const void* dout, const void* o, const void* lse, void* delta,
              int B, int H, int Sq, int Sk, int D, int causal,
              const int64_t* strides) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || D < 16 || D > 128 || D % 16)
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
  a.D = D;
  a.causal = causal;
  a.strides = strides;
  a.dos = Strides{strides[9], strides[10], strides[11]};
  a.os = Strides{strides[12], strides[13], strides[14]};
  return 0;
}

}  // namespace

// B2, and the delta pre-pass: writes delta (B, H, Sq) f32 and dq.
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const void* o, const void* lse,
                                 void* delta, void* dq, int B, int H,
                                 int Sq, int Sk, int D, int causal,
                                 const int64_t* strides, void* stream) {
  Args a;
  const int rc = make_args(a, q, k, v, dout, o, lse, delta, B, H, Sq, Sk, D,
                           causal, strides);
  if (rc) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(dq);
  if (D <= 64) return launch_dq<64>(a, out, s);
  return launch_dq<128>(a, out, s);
}

// B3: reads the delta that B2 wrote; writes dk and dv.
extern "C" int flash_bwd_dkdv_bf16(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* o, const void* lse,
                                   void* delta, void* dk, void* dv, int B,
                                   int H, int Sq, int Sk, int D, int causal,
                                   const int64_t* strides, void* stream) {
  Args a;
  const int rc = make_args(a, q, k, v, dout, o, lse, delta, B, H, Sq, Sk, D,
                           causal, strides);
  if (rc) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* odk = static_cast<float*>(dk);
  float* odv = static_cast<float*>(dv);
  if (D <= 64) return launch_dkdv<64>(a, odk, odv, s);
  return launch_dkdv<128>(a, odk, odv, s);
}
