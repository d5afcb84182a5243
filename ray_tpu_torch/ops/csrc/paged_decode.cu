// Paged decode attention: each slot's one new query attends its own cached
// keys 0..p, read in place from the KV pool through its block table.
//
// Replaces no Pallas kernel: the JAX package's paged decode
// (ray_tpu/serve/llm.py) gathers every slot's table into a dense layout
// with plain jnp and attends it there.  The port did the same
// (serve/llm.py _gather, 16 steps of _cache_attend, _scatter), which on
// the card moved the whole gathered bucket, cast to f32, on every layer of
// every step.  This kernel is the decode step's attention on the pool
// itself: the step writes its new K/V row into the pool block first, then
// one launch (plus a small combine) attends every slot's table.
//
// Contract.  q (B, 1, Hq, D) contiguous in T; pool_k, pool_v
// (N, L, bs, Hkv, D) contiguous in T (block-major: block n of layer l is a
// (bs, Hkv, D) slab); table (B, nb) int64 block ids; lens (B,) int64, the
// query's position p; active (B,) bool.  For an active slot the query of
// head hq attends keys 0..min(p, nb*bs - 1) of its table at kv head
// hq / G (G = Hq / Hkv, the grouping of models/llama.py _softmax_attend):
// f32 scores q.k times scale, f32 softmax, f32 sum of p v; out (B, 1, Hq,
// D) in T.  An inactive slot's output is zero.  T is f32, bf16 or f16;
// D is 64, 128 or 256; G is 1, 2, 4 or 8.
//
// Bound.  ~4 FLOP a byte of K/V (a bf16 row of D = 128 is 256 bytes; it
// meets G = 4 queries for 2 x 4 x 128 FLOP in q.k and as many in p v), far
// below the ~295 FLOP a byte at which an H100's tensor cores would
// matter: the kernel is bound by the live K/V bytes, read once.  The serve
// cell's step (Mistral-7B, 8 kv heads of 128, bf16) at ~14 slots of ~1,700
// positions reads ~97.5 MB a layer (29 us at 3.35 TB/s); all 32 slots at
// 4,096 positions 537 MB (160 us).  What the design does about it:
// - K and V are read once, 16 bytes a load (8 bf16/f16 or 4 f32), the
//   lanes that share a key on consecutive 16-byte chunks of its row: a
//   (position, kv head) row of D = 128 bf16 is 256 contiguous bytes.
// - One CTA holds the G query heads of one kv head, in f32 registers, so
//   each K and V row is loaded once for all G of them.
// - The sequence is split across CTAs (flash-decoding's split-K): a few
//   active slots times 8 kv heads alone cannot fill 132 SMs.  Each split
//   of split_len keys writes its unnormalised sum with its max and sum of
//   exponentials; a combine launch rescales them by their log-sum-exp.
//   With one split the first launch writes the output itself.
// - The split count is chosen on the host from the table width nb and
//   the slot count, never from the lengths (the engine's launch path reads
//   nothing back); CTAs of inactive slots, or of splits past a slot's
//   length, exit at once, and the combine reads only the splits a slot
//   used.
// - Each lane group loads two keys (one, where a lane holds four or more
//   chunks of a key) and each thread four value rows before their
//   arithmetic, so that a CTA keeps 4-8 KB of loads in flight.  Scores and
//   probabilities stay in shared memory (G x split_len f32); the partial
//   outputs of the value stripes are summed there once.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// Keys a lane group loads before their dot products, and value rows a
// thread loads before their FMAs.
constexpr int kKeyUnroll = 2;
constexpr int kValUnroll = 4;
// Dynamic shared memory a block may use without opting in.
constexpr int kDefaultSmem = 48 * 1024;

// 16 bytes of T widened to f32.
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void widen(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ float store(float x) { return x; }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void widen(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float x) {
    return __float2bfloat16_rn(x);
  }
};

template <>
struct Pack<__half> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void widen(const uint4& u, float* f) {
    const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __half22float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  static __device__ __forceinline__ __half store(float x) {
    return __float2half_rn(x);
  }
};

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Keys of slot b that its query attends: 0 for an inactive slot, else
// min(p + 1, nb * bs).
__device__ __forceinline__ int keys_of(const int64_t* lens, const bool* active,
                                       int b, int width) {
  if (!active[b]) return 0;
  const int64_t n = lens[b] + 1;
  return n < 0 ? 0 : (n < width ? static_cast<int>(n) : width);
}

// The layout of one instance: V elements a 16-byte chunk, CH chunks a
// row; LPP lanes share a key (each CPL chunks of it, so that a lane holds
// G * D / LPP <= 64 query floats); STRIPES value rows are read at once.
template <typename T, int G, int D>
struct Shape {
  static constexpr int V = Pack<T>::N;
  static constexpr int CH = D / V;
  static constexpr int LPP_WANT = G * D / 64 < 1 ? 1 : G * D / 64;
  static constexpr int LPP = LPP_WANT > CH ? CH : LPP_WANT;
  static constexpr int CPL = CH / LPP;
  static constexpr int KPW = 32 / LPP;  // keys a warp reads at once
  static constexpr int STRIPES = kThreads / CH;
  static_assert(CH * V == D && CH % LPP == 0 && 32 % LPP == 0 &&
                    kThreads % CH == 0,
                "unsupported head dim for this element type");

  static int smem_bytes(int split_len) {
    return static_cast<int>(sizeof(float)) *
           (G * split_len + STRIPES * G * D);
  }
};

// Grid (splits, Hkv, B), kThreads threads.  Split s of slot b covers keys
// [s * split_len, (s + 1) * split_len) of its table at kv head blockIdx.y.
// One split: writes out.  Several: writes part_o (B, Hq, splits, D), the
// unnormalised sum of p v, and part_ml (B, Hq, splits, 2), the split's max
// score and sum of exp(score - max).
template <typename T, int G, int D>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                        const T* __restrict__ pool_v,
                        const int64_t* __restrict__ table,
                        const int64_t* __restrict__ lens,
                        const bool* __restrict__ active, T* __restrict__ out,
                        float* __restrict__ part_o,
                        float* __restrict__ part_ml, int layer, int n_layers,
                        int bs, int nb, int split_len, float scale) {
  using S = Shape<T, G, D>;
  constexpr int V = S::V, LPP = S::LPP, CPL = S::CPL, KPW = S::KPW,
                CH = S::CH, STRIPES = S::STRIPES;
  extern __shared__ float smem[];
  float* s_p = smem;                    // [G][split_len]: scores, then p
  float* s_red = smem + G * split_len;  // [STRIPES][G][D]
  __shared__ float s_m[G], s_l[G];

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x, hkv = gridDim.y;
  const int hq_n = hkv * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t head0 = static_cast<int64_t>(b) * hq_n + h * G;

  const int j0 = split * split_len;
  const int n_keys = keys_of(lens, active, b, nb * bs);
  const int n = min(n_keys - j0, split_len);  // keys of this split
  if (n <= 0) {
    if (splits == 1) {  // inactive: a zero output
      T* o = out + head0 * D;
      for (int i = tid; i < G * D; i += kThreads) o[i] = Pack<T>::store(0.f);
    }
    return;
  }

  const int64_t* bt = table + static_cast<int64_t>(b) * nb;
  const int64_t row = static_cast<int64_t>(hkv) * D;  // a position's stride
  // Element offset of key j0 + jj's row at kv head h, layer `layer`.
  auto key_at = [&](int jj) -> int64_t {
    const int j = j0 + jj;
    const int64_t blk =
        __ldg(reinterpret_cast<const long long*>(bt) + j / bs);
    return ((blk * n_layers + layer) * bs + j % bs) * row +
           static_cast<int64_t>(h) * D;
  };

  // q . k: lanes grp*LPP .. grp*LPP + LPP - 1 share a key; lane gl of them
  // holds chunks gl, gl + LPP, ... of each of the G query rows.
  const int grp = lane / LPP, gl = lane % LPP;
  float qr[G][CPL][V];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      Pack<T>::widen(load16(q + (head0 + g) * D + (gl + c * LPP) * V),
                     qr[g][c]);

  // A lane that holds 4 or more chunks of a key has loads enough in flight.
  constexpr int KU = CPL >= 4 ? 1 : kKeyUnroll;
  constexpr int kWarpKeys = KPW * KU;
  for (int base = warp * kWarpKeys; base < n; base += kWarps * kWarpKeys) {
    // Uniform across the warp: every lane takes part in the shuffles.
    uint4 raw[KU][CPL];
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      const int jj = base + u * KPW + grp;
      if (jj < n) {
        const T* kp = pool_k + key_at(jj);
#pragma unroll
        for (int c = 0; c < CPL; ++c)
          raw[u][c] = load16(kp + (gl + c * LPP) * V);
      } else {
#pragma unroll
        for (int c = 0; c < CPL; ++c) raw[u][c] = make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      float dot[G];
#pragma unroll
      for (int g = 0; g < G; ++g) dot[g] = 0.f;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        float f[V];
        Pack<T>::widen(raw[u][c], f);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < V; ++e) dot[g] = fmaf(qr[g][c][e], f[e], dot[g]);
      }
#pragma unroll
      for (int off = LPP / 2; off > 0; off >>= 1)
#pragma unroll
        for (int g = 0; g < G; ++g)
          dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], off);
      const int jj = base + u * KPW + grp;
      if (jj < n && gl == 0)
#pragma unroll
        for (int g = 0; g < G; ++g) s_p[g * split_len + jj] = dot[g] * scale;
    }
  }
  __syncthreads();

  // Softmax over the split's keys, one warp a head.
  for (int g = warp; g < G; g += kWarps) {
    float* sp = s_p + g * split_len;
    float m = -INFINITY;
    for (int i = lane; i < n; i += 32) m = fmaxf(m, sp[i]);
    m = warp_max(m);
    float l = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float e = expf(sp[i] - m);
      sp[i] = e;
      l += e;
    }
    l = warp_sum(l);
    if (lane == 0) {
      s_m[g] = m;
      s_l[g] = l;
    }
  }
  __syncthreads();

  // p v: thread (r, c) sums chunk c of value rows r, r + STRIPES, ...
  const int c = tid % CH, r = tid / CH;
  float acc[G][V];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[g][e] = 0.f;
  for (int jj = r; jj < n; jj += STRIPES * kValUnroll) {
    uint4 raw[kValUnroll];
#pragma unroll
    for (int u = 0; u < kValUnroll; ++u) {
      const int j = jj + u * STRIPES;
      raw[u] = j < n ? load16(pool_v + key_at(j) + c * V)
                     : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kValUnroll; ++u) {
      const int j = jj + u * STRIPES;
      if (j < n) {
        float f[V];
        Pack<T>::widen(raw[u], f);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float p = s_p[g * split_len + j];
#pragma unroll
          for (int e = 0; e < V; ++e) acc[g][e] = fmaf(p, f[e], acc[g][e]);
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < V; ++e) s_red[(r * G + g) * D + c * V + e] = acc[g][e];
  __syncthreads();

  for (int i = tid; i < G * D; i += kThreads) {
    float o = 0.f;
#pragma unroll
    for (int rr = 0; rr < STRIPES; ++rr) o += s_red[rr * G * D + i];
    const int g = i / D, d = i % D;
    if (splits == 1) {
      out[(head0 + g) * D + d] = Pack<T>::store(o / s_l[g]);
    } else {
      part_o[((head0 + g) * splits + split) * D + d] = o;
    }
  }
  if (splits > 1 && tid < G) {
    float* ml = part_ml + ((head0 + tid) * splits + split) * 2;
    ml[0] = s_m[tid];
    ml[1] = s_l[tid];
  }
}

// Grid (Hq, B), kThreads threads: out[b, hq] = the splits' sums rescaled
// to their common max, over their common sum.  Reads only the splits that
// slot b used; an inactive slot gets zeros.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_decode_combine_kernel(const float* __restrict__ part_o,
                                const float* __restrict__ part_ml,
                                const int64_t* __restrict__ lens,
                                const bool* __restrict__ active,
                                T* __restrict__ out, int D, int width,
                                int splits, int split_len) {
  const int hq = blockIdx.x, b = blockIdx.y, hq_n = gridDim.x;
  const int64_t head = static_cast<int64_t>(b) * hq_n + hq;
  T* o = out + head * D;
  const int n_keys = keys_of(lens, active, b, width);
  const int used = (n_keys + split_len - 1) / split_len;
  if (used <= 0) {
    for (int d = threadIdx.x; d < D; d += kThreads)
      o[d] = Pack<T>::store(0.f);
    return;
  }
  const float* ml = part_ml + head * splits * 2;
  const float* po = part_o + head * splits * D;
  float m = -INFINITY;
  for (int s = 0; s < used; ++s) m = fmaxf(m, ml[2 * s]);
  float l = 0.f;
  for (int s = 0; s < used; ++s) l += ml[2 * s + 1] * expf(ml[2 * s] - m);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float acc = 0.f;
    for (int s = 0; s < used; ++s)
      acc = fmaf(po[s * D + d], expf(ml[2 * s] - m), acc);
    o[d] = Pack<T>::store(acc / l);
  }
}

struct Args {
  const void *q, *pool_k, *pool_v, *table, *lens, *active;
  void *out, *part_o, *part_ml;
  int B, hkv, layer, n_layers, bs, nb, splits, split_len;
  float scale;
  cudaStream_t stream;
};

template <typename T, int G, int D>
int launch(const Args& a) {
  auto kernel = paged_decode_kernel<T, G, D>;
  const int smem = Shape<T, G, D>::smem_bytes(a.split_len);
  // The static s_m and s_l count against the same limit.
  if (smem + 2 * G * static_cast<int>(sizeof(float)) > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(a.splits, a.hkv, a.B), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.pool_k),
      static_cast<const T*>(a.pool_v),
      static_cast<const int64_t*>(a.table),
      static_cast<const int64_t*>(a.lens),
      static_cast<const bool*>(a.active), static_cast<T*>(a.out),
      static_cast<float*>(a.part_o), static_cast<float*>(a.part_ml),
      a.layer, a.n_layers, a.bs, a.nb, a.split_len, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int by_group(int G, const Args& a) {
  switch (G) {
    case 1: return launch<T, 1, D>(a);
    case 2: return launch<T, 2, D>(a);
    case 4: return launch<T, 4, D>(a);
    case 8: return launch<T, 8, D>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int by_dim(int G, int D, const Args& a) {
  switch (D) {
    case 64: return by_group<T, 64>(G, a);
    case 128: return by_group<T, 128>(G, a);
    case 256: return by_group<T, 256>(G, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int combine(const void* part_o, const void* part_ml, const void* lens,
            const void* active, void* out, int B, int hq, int D, int width,
            int splits, int split_len, cudaStream_t stream) {
  paged_decode_combine_kernel<T><<<dim3(hq, B), kThreads, 0, stream>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_ml),
      static_cast<const int64_t*>(lens), static_cast<const bool*>(active),
      static_cast<T*>(out), D, width, splits, split_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The split launch.  dtype: 0 f32, 1 bf16, 2 f16.  With splits == 1 it
// writes out; with more it writes part_o and part_ml for
// paged_decode_combine.  Returns a cudaError_t (cudaErrorInvalidValue for
// a shape it does not take).
extern "C" int paged_decode(int dtype, int G, int D, const void* q,
                            const void* pool_k, const void* pool_v,
                            const void* table, const void* lens,
                            const void* active, void* out, void* part_o,
                            void* part_ml, int B, int hkv, int layer,
                            int n_layers, int bs, int nb, int splits,
                            int split_len, float scale, void* stream) {
  if (B <= 0 || B > 65535 || hkv <= 0 || hkv > 65535 || layer < 0 ||
      layer >= n_layers || bs <= 0 || nb <= 0 || splits <= 0 ||
      split_len <= 0 || static_cast<int64_t>(splits) * split_len <
                            static_cast<int64_t>(nb) * bs ||
      static_cast<int64_t>(nb) * bs > (int64_t{1} << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, pool_k, pool_v, table, lens, active, out, part_o, part_ml,
               B, hkv, layer, n_layers, bs, nb, splits, split_len, scale,
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return by_dim<float>(G, D, a);
    case 1: return by_dim<__nv_bfloat16>(G, D, a);
    case 2: return by_dim<__half>(G, D, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The combine launch after a paged_decode of splits > 1: out (B, 1, Hq,
// D) in the element type of dtype.
extern "C" int paged_decode_combine(int dtype, const void* part_o,
                                    const void* part_ml, const void* lens,
                                    const void* active, void* out, int B,
                                    int hq, int D, int nb, int bs,
                                    int splits, int split_len, void* stream) {
  if (B <= 0 || B > 65535 || hq <= 0 || D <= 0 || splits <= 0 ||
      split_len <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int width = nb * bs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return combine<float>(part_o, part_ml, lens, active, out, B, hq, D,
                            width, splits, split_len, s);
    case 1:
      return combine<__nv_bfloat16>(part_o, part_ml, lens, active, out, B,
                                    hq, D, width, splits, split_len, s);
    case 2:
      return combine<__half>(part_o, part_ml, lens, active, out, B, hq, D,
                             width, splits, split_len, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
