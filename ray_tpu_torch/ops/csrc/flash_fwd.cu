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
//   index, as the reference does).  GQA reads kv head h / (Hq / Hkv); K/V are never
//   expanded.  A row with every key masked gives o = 0, lse = -1e30.
//
// Design.  One thread block (4 warps) per (q tile of 64 rows, head,
// batch); each warp owns 16 query rows.  The block loops over 64-key
// tiles of K/V, skipping tiles entirely above the causal diagonal, and
// keeps the softmax online in f32 registers (running max m, running sum
// l, accumulator o), so the (Sq, Sk) score matrix never reaches device
// memory.  K/V tiles are staged in shared memory with cp.async
// (zero-filled past Sk), each tile's load overlapping the other
// matrix's product; Q fragments stay in registers for the whole loop.
// Both products (S = Q K^T and O += P V) run on the tensor cores with
// mma.sync m16n8k16 bf16 -> f32; P is rounded to bf16 before the
// PV product exactly as the reference casts p to v's dtype.  Only the
// tile the diagonal crosses and the ragged last tile are masked.
//
// Bound.  At the main path's shape (B=4, H=8, S=2048, D=128, causal)
// one call does ~3.4e10 FLOP and moves ~67 MB: compute-bound on the
// H100 (~35 us at 989 TFLOP/s vs ~20 us at 3.35 TB/s).  This first
// design leaves for later what reaches that bound: wgmma (warpgroup
// MMA reading K/V straight from shared memory), TMA loads with
// mbarriers, a multi-stage K/V ring, and warp specialisation
// (producer warp + consumer warpgroups).
//
// Interface: plain C, loaded with ctypes.  The kernel launches on the
// caller's stream, allocates nothing, and the launcher returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;   // query rows per block (16 per warp)
constexpr int kBlockN = 64;   // keys per K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskedLse = -1e30f;

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
// (elements) into a shared tile of
// row stride D + 8 (the pad keeps ldmatrix free of bank conflicts);
// rows at or past `rows` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile,
                                          const __nv_bfloat16* src,
                                          int64_t stride, int row0,
                                          int rows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int kLd = D + 8;
  for (int c = threadIdx.x; c < kBlockN * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    const int gr = row0 + r;
    const bool valid = gr < rows;
    const __nv_bfloat16* p = src + (valid ? gr : 0) * stride + col;
    cp_async_16(tile + r * kLd + col, p, valid);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse,
                 int Hq, int Hkv, int Sq, int Sk, int causal,
                 Strides qs, Strides ks, Strides vs, Strides os) {
  static_assert(D % 16 == 0 && D <= 128, "D must be a multiple of 16");
  constexpr int kLd = D + 8;
  constexpr int kSteps = D / 16;       // k-steps of Q K^T
  constexpr int kTilesS = kBlockN / 8; // 8-wide column tiles of S
  constexpr int kTilesO = D / 8;       // 8-wide column tiles of O

  __shared__ __align__(128) __nv_bfloat16 sK[kBlockN * kLd];
  __shared__ __align__(128) __nv_bfloat16 sV[kBlockN * kLd];

  // Longest causal rows first: the last q tile has the most k tiles.
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row within 8
  const int t = lane & 3;   // fragment column pair
  const int q0 = qt * kBlockM;

  const size_t lse_off = (size_t)(b * Hq + h) * Sq;
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + hk * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + hk * vs.h;
  __nv_bfloat16* ob = o + b * os.b + h * os.h;

  // Q tile: stage through sK, keep this warp's 16 rows as A fragments.
  uint32_t qf[kSteps][4];
  load_tile<D>(sK, qb, qs.s, q0, Sq);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    ldmatrix_x4(qf[kk], sK + (warp * 16 + (lane % 16)) * kLd + kk * 16
                            + (lane / 16) * 8);
  }
  __syncthreads();

  float acc[kTilesO][4];
#pragma unroll
  for (int n = 0; n < kTilesO; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }
  float m[2] = {-INFINITY, -INFINITY};  // running max (natural units)
  float l[2] = {0.f, 0.f};              // this thread's partial sums
  const int row_a = q0 + warp * 16 + g;
  const int row_b = row_a + 8;

  const int kv_end = causal ? min(Sk, q0 + kBlockM) : Sk;
  const int n_tiles = (kv_end + kBlockN - 1) / kBlockN;

  // Two-deep copy pipeline on single K and V buffers: K of tile j+1
  // loads while tile j's softmax and PV product run, V of tile j+1 while
  // tile j+1's QK^T runs.  Every step commits one group (empty past the
  // last tile), so wait_group<1> always means "all but the newest".
  if (n_tiles > 0) load_tile<D>(sK, kb, ks.s, 0, Sk);
  cp_async_commit();
  if (n_tiles > 0) load_tile<D>(sV, vb, vs.s, 0, Sk);
  cp_async_commit();

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBlockN;
    cp_async_wait<1>();  // K_j landed; V_j may still be in flight
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys.
    float s[kTilesS][4];
#pragma unroll
    for (int n = 0; n < kTilesS; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
      for (int np = 0; np < kTilesS / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, sK + (np * 16 + (lane % 8) + (lane / 16) * 8) * kLd
                            + kk * 16 + ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * np], qf[kk], bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with sK
    if (j + 1 < n_tiles) load_tile<D>(sK, kb, ks.s, k0 + kBlockN, Sk);
    cp_async_commit();

    // Mask only the tile the diagonal crosses and the ragged edge.
    const bool ragged = k0 + kBlockN > Sk;
    const bool diag = causal && (k0 + kBlockN - 1 > q0);
    if (ragged || diag) {
#pragma unroll
      for (int n = 0; n < kTilesS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + n * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          const bool ok = col < Sk && (!causal || col <= row);
          if (!ok) s[n][e] = -INFINITY;
        }
      }
    }

    // Online softmax: new row max over this tile (quad of 4 lanes
    // shares a row), rescale what was accumulated so far.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kTilesS; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
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

    uint32_t pf[kTilesS / 2][4];  // P as A fragments, 16 keys each
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kTilesS; ++n) {
      const float p0 = exp2f(fmaf(s[n][0], kLog2e, -mb[0]));
      const float p1 = exp2f(fmaf(s[n][1], kLog2e, -mb[0]));
      const float p2 = exp2f(fmaf(s[n][2], kLog2e, -mb[1]));
      const float p3 = exp2f(fmaf(s[n][3], kLog2e, -mb[1]));
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      const int half = (n % 2) * 2;
      pf[n / 2][half] = pack_bf16(p0, p1);
      pf[n / 2][half + 1] = pack_bf16(p2, p3);
    }
    l[0] = l[0] * alpha[0] + rs[0];
    l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
    for (int n = 0; n < kTilesO; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    cp_async_wait<1>();  // V_j landed; K_{j+1} may still be in flight
    __syncthreads();
    // O += P V.
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kTilesO / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4_trans(
            bf, sV + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * kLd
                    + np * 16 + (lane / 16) * 8);
        mma_bf16(acc[2 * np], pf[kk], bf[0], bf[1]);
        mma_bf16(acc[2 * np + 1], pf[kk], bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with sV
    if (j + 1 < n_tiles) load_tile<D>(sV, vb, vs.s, k0 + kBlockN, Sk);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // Finalize: full row sums across the quad, o = acc / l, lse.
  float inv[2], row_lse[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const bool live = l[i] > 0.f;
    inv[i] = live ? 1.f / l[i] : 0.f;
    row_lse[i] = live ? m[i] + logf(l[i]) : kMaskedLse;
  }
  const int rows[2] = {row_a, row_b};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= Sq) continue;
    __nv_bfloat16* orow = ob + rows[i] * os.s;
#pragma unroll
    for (int n = 0; n < kTilesO; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
          pack_bf16(acc[n][2 * i] * inv[i], acc[n][2 * i + 1] * inv[i]);
    }
    if (t == 0) lse[lse_off + rows[i]] = row_lse[i];
  }
}

template <int D>
void launch(const void* q, const void* k, const void* v, void* o,
            void* lse, int B, int Hq, int Hkv, int Sq, int Sk,
            int causal, Strides qs, Strides ks, Strides vs, Strides os,
            cudaStream_t stream) {
  dim3 grid((Sq + kBlockM - 1) / kBlockM, Hq, B);
  flash_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), Hq, Hkv,
      Sq, Sk, causal, qs, ks, vs, os);
}

}  // namespace

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int Hq, int Hkv,
                              int Sq, int Sk, int D, int causal,
                              const int64_t* strides, void* stream) {
  // strides: 12 element strides, (batch, head, row) of q, k, v, o.
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || Sq <= 0 || Sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 12; ++i)
    if (strides[i] % 8) return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
#define RT_CASE(d) \
    case d: launch<d>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, causal, qs, ks, \
                      vs, os, s); break;
    RT_CASE(16) RT_CASE(32) RT_CASE(48) RT_CASE(64)
    RT_CASE(80) RT_CASE(96) RT_CASE(112) RT_CASE(128)
#undef RT_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
