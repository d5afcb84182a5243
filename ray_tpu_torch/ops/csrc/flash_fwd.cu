// Flash attention forward for Hopper (sm_90a), bf16 in, f32 accumulate.
//
// Replaces ray_tpu/ops/flash_attention.py:_fwd_kernel (the Pallas TPU
// kernel reached through _fwd).  It computes what that kernel computes,
// not a block-by-block copy of it:
//
//   q (B, Hq, Sq, D) pre-scaled by D**-0.5, k/v (B, Hkv, Sk, D), bf16.
//   o (B, Hq, Sq, D) bf16 = softmax(q k^T + mask) v and lse (B, Hq, Sq)
//   f32 (contiguous) = logsumexp of the masked scores.  q, k, v and o
//   are addressed through their batch, head and row strides (D itself
//   contiguous), so the model's (B, S, H, D) tensors are read and
//   written in place, with no transposed copies.  Strides are multiples
//   of 8 elements and pointers 16-byte aligned (the wrapper checks).
//   Causal masks key j for query i when j > i (absolute row/column
//   index, as the reference does).  GQA reads kv head h / (Hq / Hkv); K/V
//   are never expanded.  A row with every key masked gives o = 0,
//   lse = -1e30 (with Sk = 0, every row).
//
// Design (wgmma + TMA, warp-specialised).  One block of three
// warpgroups per (q tile of 128 rows, head, batch), the tiles with the
// most keys launched first.  Warpgroup 0 is the producer: it gives up
// registers (setmaxnreg) and one of its threads issues every load with
// TMA, Q once and K/V 128-key tiles through a two-stage ring in shared
// memory, each stage with a "full" mbarrier for K, one for V and an
// "empty" one the consumers release.  Warpgroups 1 and 2 are consumers
// that own 64 q rows each and take the freed registers.  Per K/V tile a
// consumer computes S = Q K^T with wgmma m64n128k16 reading both
// operands from shared memory, keeps the softmax online in f32 registers
// on S's accumulator fragment (row max and sum reduced over the four
// threads of a row), rounds P to bf16 in registers, where the
// accumulator layout of S is already the A-fragment layout of the next
// product, and computes O += P V with P as the register A operand and V
// read MN-major (D contiguous) from shared memory.  Neither S nor P
// reaches memory.  K/V tiles are walked from the last (the one the causal
// diagonal or the ragged edge crosses: the only ones masked) down to the
// first.  Head dimensions up to 64 use one 64-column box per tile, 80 to
// 128 two; TMA zero-fills the columns past D and the rows past Sq or Sk,
// and neither is stored.
//
// Bound.  At the main path's shape (B=4, H=8, S=2048, D=128, causal)
// one call does ~3.4e10 FLOP and moves ~67 MB: compute-bound on the
// H100 (~35 us at 989 TFLOP/s vs ~20 us at 3.35 TB/s).  wgmma reads its
// operands from shared memory without staging them through registers, so
// the tensor cores, the exponentials and the one-block-per-SM occupancy
// are what is left; the consumers do not yet overlap one tile's softmax
// with the next tile's products inside a warpgroup.
//
// Interface: plain C, loaded with ctypes.  The kernel launches on the
// caller's stream, allocates nothing, and the launcher returns 0 or a
// CUDA error code (cudaGetLastError() after the launch).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBlockM = 128;   // q rows per block, 64 per consumer warpgroup
constexpr int kBlockN = 128;   // keys per K/V tile
constexpr int kStages = 2;     // depth of the K/V ring
constexpr int kThreads = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int kBoxBytes = 128 * 128;  // one (128 rows, 64 columns) bf16 box
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskedLse = -1e30f;

// Element strides of a (B, H, S, D) operand; D is contiguous.
struct Strides {
  int64_t b, h, s;
};

// Shared memory of one block, head dimension padded to DP (64 or 128).
template <int DP>
struct Smem {
  static constexpr int kTile = DP / 64 * kBoxBytes;  // a Q, K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kTile;                    // [kStages]
  static constexpr int kV = kK + kStages * kTile;     // [kStages]
  static constexpr int kBars = kV + kStages * kTile;
  // full_q, full_k[kStages], full_v[kStages], empty[kStages]; then the
  // slack that aligns the base to 1024 bytes.
  static constexpr int kBytes = kBars + 8 * (1 + 3 * kStages) + 1024;
};

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int Hq, int Hkv, int Sq, int Sk, int D, int causal,
                 Strides os) {
  using L = Smem<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty = full_v + kStages;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  // Longest causal rows first: the last q tile has the most K/V tiles.
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBlockM;
  const int kv_end = causal ? min(Sk, q0 + kBlockM) : Sk;
  const int n_tiles = (kv_end + kBlockN - 1) / kBlockN;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + s, 1);
      mbar_init(full_v + s, 1);
      mbar_init(empty + s, 2);  // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer warpgroup: one thread issues every load.
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      const int hk = h / (Hq / Hkv);
      mbar_expect_tx(full_q, L::kTile);
      for (int x = 0; x < DP / 64; ++x) {
        tma_load_4d(smem + L::kQ + x * kBoxBytes, &tq, full_q, 64 * x, q0,
                    h, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int kt = n_tiles - 1 - it;
        const int st = it % kStages;
        mbar_wait(empty + st, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full_k + st, L::kTile);
        for (int x = 0; x < DP / 64; ++x) {
          tma_load_4d(smem + L::kK + st * L::kTile + x * kBoxBytes, &tk,
                      full_k + st, 64 * x, kt * kBlockN, hk, b);
        }
        mbar_expect_tx(full_v + st, L::kTile);
        for (int x = 0; x < DP / 64; ++x) {
          tma_load_4d(smem + L::kV + st * L::kTile + x * kBoxBytes, &tv,
                      full_v + st, 64 * x, kt * kBlockN, hk, b);
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
    const uint32_t sq = smem_u32(smem + L::kQ) + (wq0 - q0) * 128;

    float acc[DP / 2];          // O: 64 rows x DP
    float s[kBlockN / 2];       // S: 64 rows x 128 keys
    uint32_t pf[kBlockN / 16][4];  // P as A fragments, 16 keys each
#pragma unroll
    for (int r = 0; r < DP / 2; ++r) acc[r] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running max (natural units)
    float l[2] = {0.f, 0.f};              // this thread's partial sums

    mbar_wait(full_q, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      mbar_wait(full_k + st, ph);
      const int k0 = (n_tiles - 1 - it) * kBlockN;
      const uint32_t sk = smem_u32(smem + L::kK + st * L::kTile);

      // S = Q K^T, both K-major; a 16-wide step over D moves 32 bytes
      // inside a 64-column box.  The steps past D add TMA's zero columns.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        wgmma_ss<0>(s, desc_sw128(sq + off, 16, 1024),
                    desc_sw128(sk + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // Mask only the tile the diagonal crosses and the ragged edge.
      if (k0 + kBlockN > Sk || (causal && k0 + kBlockN - 1 > wq0)) {
#pragma unroll
        for (int r = 0; r < kBlockN / 2; ++r) {
          const int col = k0 + 8 * (r / 4) + 2 * t + (r & 1);
          const int row = (r & 2) ? row_b : row_a;
          if (col >= Sk || (causal && col > row)) s[r] = -INFINITY;
        }
      }

      // Online softmax: new row max over this tile (4 threads share a
      // row), rescale what was accumulated so far.
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int r = 0; r < kBlockN / 2; r += 4) {
        mx[0] = fmaxf(mx[0], fmaxf(s[r], s[r + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[r + 2], s[r + 3]));
      }
      float mb[2], alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        // Every key so far masked: keep p = 0 (exp2(-inf - 0)).
        mb[i] = mx[i] == -INFINITY ? 0.f : mx[i] * kLog2e;
        alpha[i] = exp2f(m[i] * kLog2e - mb[i]);
        m[i] = mx[i];
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < kBlockN / 2; r += 2) {
        const int i = (r >> 1) & 1;  // row a or row b
        const float p0 = exp2f(fmaf(s[r], kLog2e, -mb[i]));
        const float p1 = exp2f(fmaf(s[r + 1], kLog2e, -mb[i]));
        rs[i] += p0 + p1;
        // Accumulator registers 8k..8k+7, in pairs, are the A fragment
        // of keys 16k..16k+15.
        pf[r / 8][(r % 8) / 2] = pack_bf16(p0, p1);
      }
      l[0] = l[0] * alpha[0] + rs[0];
      l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
      for (int r = 0; r < DP / 2; ++r) acc[r] *= alpha[(r >> 1) & 1];

      // O += P V: P from registers, V MN-major (its rows are the keys);
      // a 16-key step moves 16 rows (2048 bytes).
      mbar_wait(full_v + st, ph);
      const uint32_t sv = smem_u32(smem + L::kV + st * L::kTile);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        wgmma_rs<1>(acc, pf[kk], desc_sw128(sv + kk * 2048, kBoxBytes, 1024),
                    1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pf);
      if (tid == 0) mbar_arrive(empty + st);
    }

    // Finalize: full row sums across the quad, o = acc / l, lse.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = i ? row_b : row_a;
      const bool live = l[i] > 0.f;
      const float inv = live ? 1.f / l[i] : 0.f;
      if (row >= Sq) continue;
      __nv_bfloat16* orow = o + b * os.b + h * os.h + row * os.s;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        if (8 * j < D) {
          *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) = pack_bf16(
              acc[4 * j + 2 * i] * inv, acc[4 * j + 2 * i + 1] * inv);
        }
      }
      if (t == 0) {
        lse[static_cast<int64_t>(b * Hq + h) * Sq + row] =
            live ? m[i] + logf(l[i]) : kMaskedLse;
      }
    }
  }
}

// Sk = 0: every row is fully masked.  (No tensor map can describe an
// empty K/V.)
__global__ void flash_fwd_no_keys(__nv_bfloat16* __restrict__ o,
                                  float* __restrict__ lse, int Hq, int Sq,
                                  int D, Strides os) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  for (int row = threadIdx.x; row < Sq; row += blockDim.x) {
    __nv_bfloat16* orow = o + b * os.b + h * os.h + row * os.s;
    for (int c = 0; c < D; ++c) orow[c] = __float2bfloat16(0.f);
    lse[static_cast<int64_t>(b * Hq + h) * Sq + row] = kMaskedLse;
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int Hq, int Hkv, int Sq, int Sk, int D, int causal,
           const int64_t* strides, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int rc = encode_bhsd(&tq, q, B, Hq, Sq, D, strides, kBlockM);
  if (rc == 0) rc = encode_bhsd(&tk, k, B, Hkv, Sk, D, strides + 3, kBlockN);
  if (rc == 0) rc = encode_bhsd(&tv, v, B, Hkv, Sk, D, strides + 6, kBlockN);
  if (rc != 0) return rc;
  constexpr int smem = Smem<DP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(Hq, B, (Sq + kBlockM - 1) / kBlockM);
  flash_fwd_kernel<DP><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      Hq, Hkv, Sq, Sk, D, causal,
      Strides{strides[9], strides[10], strides[11]});
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int Hq, int Hkv,
                              int Sq, int Sk, int D, int causal,
                              const int64_t* strides, void* stream) {
  // strides: 12 element strides, (batch, head, row) of q, k, v, o.
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || Sq <= 0 || Sk < 0 ||
      B > 65535 || (Sq + kBlockM - 1) / kBlockM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D < 16 || D > 128 || D % 16) return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 12; ++i)
    if (strides[i] % 8) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sk == 0) {
    flash_fwd_no_keys<<<dim3(Hq, B), 128, 0, s>>>(
        static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), Hq, Sq, D,
        Strides{strides[9], strides[10], strides[11]});
    return static_cast<int>(cudaGetLastError());
  }
  if (D <= 64) {
    return launch<64>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, D, causal,
                      strides, s);
  }
  return launch<128>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, D, causal, strides,
                     s);
}
