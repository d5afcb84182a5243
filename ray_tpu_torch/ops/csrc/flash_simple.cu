// Flash attention, the simple family: forward (B1), dq with the delta
// pre-pass (B2) and dk/dv (B3) on the CUDA cores, for what the wgmma
// kernels (flash_fwd.cu, flash_bwd.cu) do not take.
//
// Replaces, for those inputs, ray_tpu/ops/flash_attention.py:_fwd_kernel
// (:96, reached through _fwd's pallas_call at :183), _dq_kernel (:216,
// call at :337) and _dkdv_kernel (:264, call at :368).  The reference's
// kernels run in the inputs' dtype and tile any head dimension up to 128
// and multiples of 128 above it (_supported, :64-69).  The wgmma kernels
// take bf16 and f16 at D in {16, 32, ..., 128}; this family takes f32, bf16
// and f16 (the element type T) at every D <= 128 and at D in {256, 384,
// 512}.  f32 here is a true f32 computation: every product and sum is an
// f32 FMA on the CUDA cores, never tf32, so the f32 gates that need exact
// tokens (dense == paged == spec, first tokens == the forward's argmax)
// hold on the card.
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
// Design.  One block of 128 threads (16 x 8: ty = tid / 8, tx = tid % 8)
// per (row tile, head, batch).  Each operand tile is staged in shared
// memory as f32 with its rows padded by one element (DP + 1), so the
// eight threads of a row group read eight rows of K (or V) at the same
// column from eight banks.  A thread owns TM rows (ty * TM + i) and the
// columns tx + 8 j of every row-by-key and row-by-feature product, so the
// row max and row sum of the online softmax are reduced over the eight
// lanes of its group with shuffles.  P (forward) and dS (backward) go
// through shared memory once per tile, rounded to T, to feed the second
// product.  Head dimensions are padded to DP = 64, 128, 256 or 512 with
// zeros; the tile heights shrink as DP grows so that the per-thread
// accumulators stay at 64 registers (forward and dq: TM x DP / 8; dk/dv:
// two of them).
//
// Bound.  At the main path's shape (B=4, H=8, S=2048, D=128, causal) the
// forward does 4 * B * H * D * pairs = 3.44e10 FLOP (2,098,176 visible
// pairs per (b, h)); on the CUDA cores the card's f32 peak is 67 TFLOP/s,
// so the bound is 0.51 ms, against 0.02 ms for its bytes.  Every product
// is an FMA whose operands come from shared memory (a load for each of
// TM + TN values per TM x TN FMAs), one block of four warps per SM at the
// larger tiles: the kernel is bound by shared-memory issue and latency,
// far from that peak.  Making it fast is later work; it exists to be
// right at every dtype and head dimension the reference takes.
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

constexpr int kThreads = 128;  // 16 row groups x 8 lanes
constexpr float kMasked = -1e30f;  // the reference's mask value

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

// Sum and max over the eight lanes of a row group (lanes 8g .. 8g + 7).
__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}

__device__ __forceinline__ float group_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  return x;
}

// Rows [r0, r0 + ROWS) of one (b, h) slice of a (B, H, S, D) operand into
// a (ROWS, DP + 1) f32 tile; rows past S and columns past D are zeros.
template <typename T, int ROWS, int DP>
__device__ __forceinline__ void load_tile(float* tile, const T* base,
                                          int64_t row_stride, int r0, int S,
                                          int D) {
  for (int i = threadIdx.x; i < ROWS * DP; i += kThreads) {
    const int r = i / DP;
    const int c = i % DP;
    float x = 0.f;
    if (r0 + r < S && c < D) {
      x = Elem<T>::load(base + static_cast<int64_t>(r0 + r) * row_stride + c);
    }
    tile[r * (DP + 1) + c] = x;
  }
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

template <int DP>
struct FwdCfg {
  static constexpr int BM = DP <= 128 ? 64 : (DP == 256 ? 32 : 16);  // rows
  static constexpr int BN = DP <= 256 ? 64 : 32;  // keys per K/V tile
  static constexpr int TM = BM / 16;              // rows per thread
  static constexpr int TN = BN / 8;               // keys per thread
  static constexpr int TC = DP / 8;               // o columns per thread
  static constexpr int LD = DP + 1;
  static constexpr int LP = BN + 1;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + BM * LD;
  static constexpr int kV = kK + BN * LD;
  static constexpr int kP = kV + BN * LD;
  static constexpr int kBytes = (kP + BM * LP) * 4;
};

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_simple_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o,
                        float* __restrict__ lse, int Hq, int Hkv, int Sq,
                        int Sk, int D, int causal, Strides qs, Strides ks,
                        Strides vs, Strides os) {
  using C = FwdCfg<DP>;
  extern __shared__ float smem[];
  float* Qs = smem + C::kQ;
  float* Ks = smem + C::kK;
  float* Vs = smem + C::kV;
  float* Ps = smem + C::kP;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  // Longest causal rows first: the last q tile has the most K/V tiles.
  const int q0 = (gridDim.z - 1 - blockIdx.z) * C::BM;
  const int hk = h / (Hq / Hkv);
  const int ty = threadIdx.x / 8;
  const int tx = threadIdx.x % 8;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  load_tile<T, C::BM, DP>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, Sq, D);

  float acc[C::TM][C::TC];
  float m[C::TM], l[C::TM];
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C::TC; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = causal ? min(Sk, q0 + C::BM) : Sk;
  for (int k0 = 0; k0 < kv_end; k0 += C::BN) {
    __syncthreads();  // the last tile's readers are done
    load_tile<T, C::BN, DP>(Ks, kb, ks.s, k0, Sk, D);
    load_tile<T, C::BN, DP>(Vs, vb, vs.s, k0, Sk, D);
    __syncthreads();

    // S = Q K^T for this thread's rows and keys.
    float s[C::TM][C::TN];
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int j = 0; j < C::TN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float qv[C::TM], kv[C::TN];
#pragma unroll
      for (int i = 0; i < C::TM; ++i) qv[i] = Qs[(ty * C::TM + i) * C::LD + d];
#pragma unroll
      for (int j = 0; j < C::TN; ++j) kv[j] = Ks[(tx + 8 * j) * C::LD + d];
#pragma unroll
      for (int i = 0; i < C::TM; ++i)
#pragma unroll
        for (int j = 0; j < C::TN; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // Online softmax per row, over the row group's eight lanes.
#pragma unroll
    for (int i = 0; i < C::TM; ++i) {
      const int row = q0 + ty * C::TM + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < C::TN; ++j) {
        const int col = k0 + tx + 8 * j;
        if (col >= Sk || (causal && col > row)) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      // Every key so far masked: keep p = 0 (exp(-inf - 0)).
      const float mb = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = m[i] == -INFINITY ? 0.f : expf(m[i] - mb);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < C::TN; ++j) {
        const float p = expf(s[i][j] - mb);
        rs += p;
        Ps[(ty * C::TM + i) * C::LP + tx + 8 * j] = Elem<T>::round(p);
      }
      l[i] = l[i] * alpha + group_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < C::TC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // O += P V.
#pragma unroll 4
    for (int kk = 0; kk < C::BN; ++kk) {
      float pv[C::TM];
#pragma unroll
      for (int i = 0; i < C::TM; ++i) pv[i] = Ps[(ty * C::TM + i) * C::LP + kk];
#pragma unroll
      for (int c = 0; c < C::TC; ++c) {
        const float vv = Vs[kk * C::LD + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < C::TM; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int row = q0 + ty * C::TM + i;
    if (row >= Sq) continue;
    const bool live = l[i] > 0.f;
    const float inv = live ? 1.f / l[i] : 0.f;
    T* orow = o + b * os.b + h * os.h + row * os.s;
#pragma unroll
    for (int c = 0; c < C::TC; ++c) {
      const int col = tx + 8 * c;
      if (col < D) Elem<T>::store(orow + col, acc[i][c] * inv);
    }
    if (tx == 0) {
      lse[static_cast<int64_t>(b * Hq + h) * Sq + row] =
          live ? m[i] + logf(l[i]) : kMasked;
    }
  }
}

// ---------------------------------------------------------------------------
// dq, with the delta pre-pass
// ---------------------------------------------------------------------------

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

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
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

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * C::BM;
  const int ty = threadIdx.x / 8;
  const int tx = threadIdx.x % 8;
  const int64_t row_off = static_cast<int64_t>(b * H + h) * Sq;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  load_tile<T, C::BM, DP>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, Sq, D);
  load_tile<T, C::BM, DP>(Dos, dout + b * dos.b + h * dos.h, dos.s, q0, Sq,
                          D);

  // delta = rowsum(dO * O) in f32 for this thread's rows (the group's
  // eight lanes split the columns), and lse.
  float dl[C::TM], ls[C::TM];
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int row = q0 + ty * C::TM + i;
    float sum = 0.f;
    if (row < Sq) {
      const T* orow = o + b * os.b + h * os.h + row * os.s;
      const T* drow = dout + b * dos.b + h * dos.h + row * dos.s;
      for (int c = tx; c < D; c += 8) {
        sum = fmaf(Elem<T>::load(drow + c), Elem<T>::load(orow + c), sum);
      }
    }
    sum = group_sum(sum);
    dl[i] = sum;
    ls[i] = row < Sq ? lse[row_off + row] : 0.f;
    if (tx == 0 && row < Sq) delta[row_off + row] = sum;
  }

  float acc[C::TM][C::TC];
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int c = 0; c < C::TC; ++c) acc[i][c] = 0.f;

  const int kv_end = causal ? min(Sk, q0 + C::BM) : Sk;
  for (int k0 = 0; k0 < kv_end; k0 += C::BN) {
    __syncthreads();
    load_tile<T, C::BN, DP>(Ks, kb, ks.s, k0, Sk, D);
    load_tile<T, C::BN, DP>(Vs, vb, vs.s, k0, Sk, D);
    __syncthreads();

    // S = Q K^T and dP = dO V^T.
    float s[C::TM][C::TN], dp[C::TM][C::TN];
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int j = 0; j < C::TN; ++j) s[i][j] = dp[i][j] = 0.f;
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
      const int col = tx + 8 * c;
      if (col < D) dqrow[col] = acc[i][c];
    }
  }
}

// ---------------------------------------------------------------------------
// dk, dv
// ---------------------------------------------------------------------------

template <int DP>
struct DkdvCfg {
  static constexpr int BK = DP <= 64 ? 64 : (DP == 128 ? 32 : 16);  // keys
  static constexpr int BQ = DP <= 256 ? 64 : 32;  // rows per Q/dO tile
  static constexpr int TM = BK / 16;              // keys per thread
  static constexpr int TN = BQ / 8;               // rows per thread
  static constexpr int TC = DP / 8;
  static constexpr int LD = DP + 1;
  static constexpr int LP = BQ + 1;
  static constexpr int kK = 0;
  static constexpr int kV = kK + BK * LD;
  static constexpr int kQ = kV + BK * LD;
  static constexpr int kDo = kQ + BQ * LD;
  static constexpr int kP = kDo + BQ * LD;
  static constexpr int kDs = kP + BK * LP;
  static constexpr int kL = kDs + BK * LP;
  static constexpr int kDl = kL + BQ;
  static constexpr int kBytes = (kDl + BQ) * 4;
};

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_simple_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int H, int Sq, int Sk, int D, int causal,
                         Strides qs, Strides ks, Strides vs, Strides dos) {
  using C = DkdvCfg<DP>;
  extern __shared__ float smem[];
  float* Ks = smem + C::kK;
  float* Vs = smem + C::kV;
  float* Qs = smem + C::kQ;
  float* Dos = smem + C::kDo;
  float* Ps = smem + C::kP;
  float* DSs = smem + C::kDs;
  float* Ls = smem + C::kL;
  float* Dl = smem + C::kDl;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * C::BK;
  const int ty = threadIdx.x / 8;
  const int tx = threadIdx.x % 8;
  const int64_t row_off = static_cast<int64_t>(b * H + h) * Sq;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* db = dout + b * dos.b + h * dos.h;
  load_tile<T, C::BK, DP>(Ks, k + b * ks.b + h * ks.h, ks.s, k0, Sk, D);
  load_tile<T, C::BK, DP>(Vs, v + b * vs.b + h * vs.h, vs.s, k0, Sk, D);

  float acc_k[C::TM][C::TC], acc_v[C::TM][C::TC];
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int c = 0; c < C::TC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  // Causal: rows below this key tile's first key see none of its keys.
  const int first = causal ? (k0 / C::BQ) * C::BQ : 0;
  for (int q0 = first; q0 < Sq; q0 += C::BQ) {
    __syncthreads();
    load_tile<T, C::BQ, DP>(Qs, qb, qs.s, q0, Sq, D);
    load_tile<T, C::BQ, DP>(Dos, db, dos.s, q0, Sq, D);
    for (int r = threadIdx.x; r < C::BQ; r += kThreads) {
      const int row = q0 + r;  // rows past Sq are masked
      Ls[r] = row < Sq ? lse[row_off + row] : 0.f;
      Dl[r] = row < Sq ? delta[row_off + row] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for this thread's keys and rows.
    float s[C::TM][C::TN], dp[C::TM][C::TN];
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int j = 0; j < C::TN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DP; ++d) {
      float kv[C::TM], vv[C::TM], qv[C::TN], dov[C::TN];
#pragma unroll
      for (int i = 0; i < C::TM; ++i) {
        kv[i] = Ks[(ty * C::TM + i) * C::LD + d];
        vv[i] = Vs[(ty * C::TM + i) * C::LD + d];
      }
#pragma unroll
      for (int j = 0; j < C::TN; ++j) {
        qv[j] = Qs[(tx + 8 * j) * C::LD + d];
        dov[j] = Dos[(tx + 8 * j) * C::LD + d];
      }
#pragma unroll
      for (int i = 0; i < C::TM; ++i)
#pragma unroll
        for (int j = 0; j < C::TN; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
        }
    }

    // p^T = exp(s^T - lse), ds^T = p^T (dp^T - delta); p rounded to T
    // (do's dtype) for dV, ds to T (q's dtype) for dK.
#pragma unroll
    for (int i = 0; i < C::TM; ++i) {
      const int key = k0 + ty * C::TM + i;
#pragma unroll
      for (int j = 0; j < C::TN; ++j) {
        const int r = tx + 8 * j;
        const int row = q0 + r;
        const float x =
            (row >= Sq || (causal && key > row)) ? kMasked : s[i][j];
        const float p = expf(x - Ls[r]);
        Ps[(ty * C::TM + i) * C::LP + r] = Elem<T>::round(p);
        DSs[(ty * C::TM + i) * C::LP + r] =
            Elem<T>::round(p * (dp[i][j] - Dl[r]));
      }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q.
#pragma unroll 2
    for (int r = 0; r < C::BQ; ++r) {
      float pv[C::TM], dsv[C::TM];
#pragma unroll
      for (int i = 0; i < C::TM; ++i) {
        pv[i] = Ps[(ty * C::TM + i) * C::LP + r];
        dsv[i] = DSs[(ty * C::TM + i) * C::LP + r];
      }
#pragma unroll
      for (int c = 0; c < C::TC; ++c) {
        const float dov = Dos[r * C::LD + tx + 8 * c];
        const float qv = Qs[r * C::LD + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < C::TM; ++i) {
          acc_v[i][c] = fmaf(pv[i], dov, acc_v[i][c]);
          acc_k[i][c] = fmaf(dsv[i], qv, acc_k[i][c]);
        }
      }
    }
  }

  const int64_t key_off = static_cast<int64_t>(b * H + h) * Sk;
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int key = k0 + ty * C::TM + i;
    if (key >= Sk) continue;
    float* dkrow = dk + (key_off + key) * D;
    float* dvrow = dv + (key_off + key) * D;
#pragma unroll
    for (int c = 0; c < C::TC; ++c) {
      const int col = tx + 8 * c;
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

// The padded head dimension of D: 64, 128, 256 or 512; 0 if this family
// does not take D (above 128 only multiples of 128 up to 512).
int padded_dim(int D) {
  if (D < 1) return 0;
  if (D <= 64) return 64;
  if (D <= 128) return 128;
  if (D == 256) return 256;
  if (D == 384 || D == 512) return 512;
  return 0;
}

Strides strides_at(const int64_t* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

template <typename Kernel>
int prepare(Kernel kernel, int smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

template <typename T, int DP>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int Hq, int Hkv, int Sq, int Sk, int D,
               int causal, const int64_t* st, cudaStream_t stream) {
  using C = FwdCfg<DP>;
  const int rc = prepare(flash_simple_fwd_kernel<T, DP>, C::kBytes);
  if (rc) return rc;
  dim3 grid(Hq, B, (Sq + C::BM - 1) / C::BM);
  flash_simple_fwd_kernel<T, DP><<<grid, kThreads, C::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      Hq, Hkv, Sq, Sk, D, causal, strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* o, const void* lse, void* delta, void* dq, int B,
              int H, int Sq, int Sk, int D, int causal, const int64_t* st,
              cudaStream_t stream) {
  using C = DqCfg<DP>;
  const int rc = prepare(flash_simple_dq_kernel<T, DP>, C::kBytes);
  if (rc) return rc;
  dim3 grid(H, B, (Sq + C::BM - 1) / C::BM);
  flash_simple_dq_kernel<T, DP><<<grid, kThreads, C::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const T*>(o), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<float*>(dq), H, Sq, Sk, D,
      causal, strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 3), strides_at(st, 4));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP>
int launch_dkdv(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dk, void* dv, int B, int H, int Sq, int Sk, int D,
                int causal, const int64_t* st, cudaStream_t stream) {
  using C = DkdvCfg<DP>;
  const int rc = prepare(flash_simple_dkdv_kernel<T, DP>, C::kBytes);
  if (rc) return rc;
  dim3 grid(H, B, (Sk + C::BK - 1) / C::BK);
  flash_simple_dkdv_kernel<T, DP><<<grid, kThreads, C::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), H, Sq, Sk, D, causal,
      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 3));
  return static_cast<int>(cudaGetLastError());
}

// Calls F<T, DP>::run(args...) for the runtime dtype code and padded D.
template <template <typename, int> class F, typename... Args>
int dispatch(int dtype, int D, Args... args) {
  const int dp = padded_dim(D);
  switch (dtype * 1000 + dp) {
    case 64: return F<float, 64>::run(args...);
    case 128: return F<float, 128>::run(args...);
    case 256: return F<float, 256>::run(args...);
    case 512: return F<float, 512>::run(args...);
    case 1064: return F<__nv_bfloat16, 64>::run(args...);
    case 1128: return F<__nv_bfloat16, 128>::run(args...);
    case 1256: return F<__nv_bfloat16, 256>::run(args...);
    case 1512: return F<__nv_bfloat16, 512>::run(args...);
    case 2064: return F<__half, 64>::run(args...);
    case 2128: return F<__half, 128>::run(args...);
    case 2256: return F<__half, 256>::run(args...);
    case 2512: return F<__half, 512>::run(args...);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int DP>
struct Fwd {
  template <typename... A>
  static int run(A... a) { return launch_fwd<T, DP>(a...); }
};

template <typename T, int DP>
struct Dq {
  template <typename... A>
  static int run(A... a) { return launch_dq<T, DP>(a...); }
};

template <typename T, int DP>
struct Dkdv {
  template <typename... A>
  static int run(A... a) { return launch_dkdv<T, DP>(a...); }
};

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
      !grid_ok(B, (Sq + 15) / 16) || padded_dim(D) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<Fwd>(dtype, D, q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, D,
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
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 ||
      !grid_ok(B, (Sq + 15) / 16) || padded_dim(D) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<Dq>(dtype, D, q, k, v, dout, o, lse, delta, dq, B, H, Sq,
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
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 ||
      !grid_ok(B, (Sk + 15) / 16) || padded_dim(D) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<Dkdv>(dtype, D, q, k, v, dout,
                        static_cast<const void*>(lse),
                        static_cast<const void*>(delta), dk, dv, B, H, Sq,
                        Sk, D, causal, strides,
                        static_cast<cudaStream_t>(stream));
}
