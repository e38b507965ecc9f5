// Decode attention against a contiguous KV cache, for Hopper (sm_90a):
// split-K across blocks (flash-decoding) and a deterministic merge.
//
// Replaces the Pallas kernel deepspeed_tpu/ops/pallas/decode_attention.py
// decode_attention (body _decode_kernel): one query token per (batch, query
// head) attends the rows 0..pos of its batch entry's cache [Smax, KV, D]
// (pos inclusive, one pos for the whole batch), online softmax in f32,
// output acc / max(l, 1e-30) in the query's dtype. GQA: query head h reads
// kv head h / (H / KV). Offline generate runs it once per layer and decode
// step, on a layer's slice of the [L, B, Smax, H, D] cache. pos is read from
// device memory (an int32 [1] tensor), as the TPU kernel takes it by scalar
// prefetch: a launch depends on shapes alone, so a captured CUDA graph
// replays it at every step of a generation.
//
// What bounds it on the card: HBM bytes. Each live key and value row is
// read once and used for 2*D flops per query head, ~1 flop per byte; the
// least time is the K+V bytes of rows 0..pos over 3.35 TB/s. At generate's
// shape (B8 H16 D64 bf16, pos 128..254) that is ~2 us, so the kernel is
// bound by how many bytes it keeps in flight, not by its arithmetic: HBM
// needs ~15 KB or more in flight per SM to reach its rate.
//
// What this design does about it:
//  - 16-byte loads: a key row is TPR lanes x 16 bytes (D64 bf16: 8 lanes,
//    so one warp instruction reads 4 rows) and each lane keeps U = 4 rows
//    of K and V in flight before it uses any. A block of W = 16 warps so
//    covers 256 rows in one pass at D64 bf16, with 64 KB of K and V in
//    flight: generate's cache (<= 256 rows) takes one block a head and no
//    merge;
//  - split-K for longer caches: the rows 0..Smax-1 are cut into `splits`
//    chunks of `chunk` rows (ops/decode_attention.py kernel_plan: 4-warp
//    blocks, whole passes, about 4 blocks a SM, planned from Smax alone),
//    one block per (chunk, batch, head group); a 4096-row cache at B2 H16
//    takes 16 chunks. A chunk wholly past pos reads nothing and leaves an
//    empty partial (m = -1e30, l = 0, acc = 0), which the merge weighs by
//    exp2(-1e30 - max) = 0 (no branch: the merge's loads stay pipelined);
//  - the dot products of the U rows reduce across their TPR lanes together
//    (independent shuffles), and the online softmax runs once per U rows in
//    log2 units on exp2;
//  - GQA: one block serves G query heads of one KV head (G = the largest
//    of 8, 4, 2, 1 that divides H / KV), so each K/V byte is read once per
//    group of up to 8 heads;
//  - each block writes its partial (m, l, unnormalised acc) in f32 to a
//    scratch tensor and counts itself on its head block's counter; the
//    block that arrives last merges the chunks in chunk order by their
//    log-sum-exp and resets the counter (no atomic sums: the result does
//    not depend on the order blocks finish and repeats bit for bit, and no
//    reset launch is needed). One device launch a call; with one chunk (a
//    short cache) the block writes the output directly;
//  - rows past pos are never read (the TPU kernel read all of Smax and
//    masked them); the cache is read through its batch, sequence and head
//    strides (unit-stride last dim), so a layer's slice of the stacked
//    cache is passed without a copy.
// What it does not do: TMA or cp.async.bulk (16-byte register loads keep
// enough in flight at these sizes); reading the H heads of one MHA row as
// one contiguous H*D run (each block reads its own head's 128-byte
// pieces, so at MHA the row is still read once, by H blocks); overlapping
// its launch with the previous kernel's tail (at ~2 us of bytes, the launch
// and one HBM round trip are most of a call).
//
// On P's rounding: P is kept in f32 for the weighted sum at every dtype, as
// the paged decode kernel does (the TPU kernel rounded P to the cache dtype
// before P.V); the plain version (the JAX package's jnp fallback) does the
// same.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kU = 4;      // rows in flight per lane
constexpr int kMaxG = 8;   // query heads a block serves
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_float<__half>(float x) { return __float2half_rn(x); }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// the lane layout of one D-wide row read with 16-byte loads by W warps
template <typename T, int D, int W>
struct Lay {
  static constexpr int VEC = 16 / (int)sizeof(T);             // elements a load
  static constexpr int TPR = D / VEC < 32 ? D / VEC : 32;     // lanes a row
  static constexpr int E = D / TPR;                           // elements a lane
  static constexpr int RPW = 32 / TPR;                        // rows a warp covers
  static constexpr int RPB = RPW * W;                         // rows a block covers
};

template <typename T, int E>
struct Raw {
  uint4 u[E * sizeof(T) / 16];
};

template <typename T, int E>
__device__ __forceinline__ void load_raw(Raw<T, E>& r, const T* __restrict__ p) {
#pragma unroll
  for (int i = 0; i < (int)(E * sizeof(T) / 16); ++i)
    r.u[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
}

template <typename T, int E>
__device__ __forceinline__ void raw_floats(const Raw<T, E>& r, float (&x)[E]) {
  const T* t = reinterpret_cast<const T*>(r.u);
#pragma unroll
  for (int j = 0; j < E; ++j) x[j] = to_float(t[j]);
}

// N contiguous elements of T at p (aligned to their size, 4 to 32 bytes)
// into floats: q, whose dtype may be narrower than the cache's
template <typename T, int N>
__device__ __forceinline__ void load_floats(const T* __restrict__ p, float (&x)[N]) {
  constexpr int kBytes = N * sizeof(T);
  static_assert(kBytes % 4 == 0 && (kBytes <= 16 || kBytes % 16 == 0), "load width");
  alignas(16) uint32_t buf[kBytes / 4];
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i)
      reinterpret_cast<uint4*>(buf)[i] = reinterpret_cast<const uint4*>(p)[i];
  } else if constexpr (kBytes == 8) {
    *reinterpret_cast<uint2*>(buf) = *reinterpret_cast<const uint2*>(p);
  } else {
    buf[0] = *reinterpret_cast<const uint32_t*>(p);
  }
  const T* t = reinterpret_cast<const T*>(buf);
#pragma unroll
  for (int j = 0; j < N; ++j) x[j] = to_float(t[j]);
}

// one block: G query heads (h0 .. h0+G-1, all reading kv head g) of batch
// entry b over the cache rows [r0, r1). final: write o; else the partial
// (m in log2 units, l, acc) of chunk `split` to the scratch tensors.
template <typename TQ, typename TKV, int D, int G, int W>
__global__ void __launch_bounds__(W * 32)
decode_split_kernel(const TQ* __restrict__ q,     // [B, H, D] contiguous
                    const TKV* __restrict__ k,    // [B, Smax, KV, D] strided
                    const TKV* __restrict__ v,
                    TQ* __restrict__ out,         // [B, H, D] contiguous
                    float* __restrict__ part_ml,  // [B, H, splits, 2]
                    float* __restrict__ part_acc, // [B, H, splits, D]
                    int* __restrict__ counters,   // [head blocks], zero between calls
                    const int* __restrict__ pos,  // [1] the last live row
                    int H, int KV, int S, int chunk, int splits,
                    long long k_sb, long long k_ss, long long k_sh,
                    long long v_sb, long long v_ss, long long v_sh, float scale2) {
  using L = Lay<TKV, D, W>;
  constexpr int E = L::E;
  const int split = blockIdx.x;
  const int hb = blockIdx.y;               // head block over B * KV * (rep / G)
  const int rep = H / KV;
  const int per_kv = rep / G;
  const int b = hb / (KV * per_kv);
  const int g = (hb / per_kv) % KV;
  const int h0 = g * rep + (hb % per_kv) * G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane % L::TPR;           // which E columns of the row
  const int rgrp = lane / L::TPR;          // which row of the warp's RPW
  const int col = sub * E;
  // rows 0..min(pos, S-1) are live; a chunk past them is empty (its loop
  // does not run: m = -1e30, l = 0, acc = 0)
  const int n_rows = min(max(__ldg(pos), 0), S - 1) + 1;
  const int r0 = split * chunk;
  const int r1 = min(r0 + chunk, n_rows);

  float qv[G][E];
#pragma unroll
  for (int hh = 0; hh < G; ++hh)
    load_floats<TQ, E>(q + ((size_t)b * H + h0 + hh) * D + col, qv[hh]);
  const TKV* kb = k + b * k_sb + g * k_sh + col;
  const TKV* vb = v + b * v_sb + g * v_sh + col;

  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int hh = 0; hh < G; ++hh) {
    m[hh] = kMasked;
    l[hh] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[hh][e] = 0.f;
  }

  // the loop bound is the block's, so every lane reaches the shuffles
  for (int base = r0; base < r1; base += L::RPB * kU) {
    const int s0 = base + warp * L::RPW + rgrp;
    // issue every load of the U rows before using any
    Raw<TKV, E> kr[kU], vr[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int s = s0 + u * L::RPB;
      if (s < r1) {
        load_raw<TKV, E>(kr[u], kb + s * k_ss);
        load_raw<TKV, E>(vr[u], vb + s * v_ss);
      } else {
#pragma unroll
        for (int i = 0; i < (int)(E * sizeof(TKV) / 16); ++i) {
          kr[u].u[i] = make_uint4(0, 0, 0, 0);
          vr[u].u[i] = make_uint4(0, 0, 0, 0);
        }
      }
    }
    float sc[G][kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float kk[E];
      raw_floats<TKV, E>(kr[u], kk);
#pragma unroll
      for (int hh = 0; hh < G; ++hh) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) part = fmaf(qv[hh][e], kk[e], part);
        sc[hh][u] = part;
      }
    }
#pragma unroll
    for (int o = L::TPR / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int hh = 0; hh < G; ++hh)
#pragma unroll
        for (int u = 0; u < kU; ++u) sc[hh][u] += __shfl_xor_sync(0xffffffffu, sc[hh][u], o);
    }
    float vv[kU][E];
#pragma unroll
    for (int u = 0; u < kU; ++u) raw_floats<TKV, E>(vr[u], vv[u]);
#pragma unroll
    for (int hh = 0; hh < G; ++hh) {
      float mx = m[hh];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        sc[hh][u] = (s0 + u * L::RPB < r1) ? sc[hh][u] * scale2 : kMasked;
        mx = fmaxf(mx, sc[hh][u]);
      }
      const float corr = exp2f(m[hh] - mx);
      m[hh] = mx;
      l[hh] *= corr;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[hh][e] *= corr;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const float p = (s0 + u * L::RPB < r1) ? exp2f(sc[hh][u] - mx) : 0.f;
        l[hh] += p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[hh][e] = fmaf(p, vv[u][e], acc[hh][e]);
      }
    }
  }

  // merge the warp's row groups (lanes that own the same columns)
#pragma unroll
  for (int o = L::TPR; o < 32; o <<= 1) {
#pragma unroll
    for (int hh = 0; hh < G; ++hh) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[hh], o);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[hh], o);
      const float mn = fmaxf(m[hh], m2);
      const float c1 = exp2f(m[hh] - mn), c2 = exp2f(m2 - mn);
      m[hh] = mn;
      l[hh] = l[hh] * c1 + l2 * c2;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float a2 = __shfl_xor_sync(0xffffffffu, acc[hh][e], o);
        acc[hh][e] = acc[hh][e] * c1 + a2 * c2;
      }
    }
  }

  // then the block's warps, through shared memory
  __shared__ float sm_m[W][G];
  __shared__ float sm_l[W][G];
  __shared__ __align__(16) float sm_acc[W][G][D];
  if (rgrp == 0) {
#pragma unroll
    for (int hh = 0; hh < G; ++hh) {
      if (sub == 0) {
        sm_m[warp][hh] = m[hh];
        sm_l[warp][hh] = l[hh];
      }
#pragma unroll
      for (int e = 0; e < E; ++e) sm_acc[warp][hh][col + e] = acc[hh][e];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += W * 32) {
    const int hh = idx / D, d = idx % D;
    float mm = kMasked;
#pragma unroll
    for (int w = 0; w < W; ++w) mm = fmaxf(mm, sm_m[w][hh]);
    float ll = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float c = exp2f(sm_m[w][hh] - mm);
      ll = fmaf(sm_l[w][hh], c, ll);
      a = fmaf(sm_acc[w][hh][d], c, a);
    }
    const size_t bh = (size_t)b * H + h0 + hh;
    if (splits == 1) {
      out[bh * D + d] = from_float<TQ>(a / fmaxf(ll, 1e-30f));
    } else {
      part_acc[(bh * splits + split) * D + d] = a;
      if (d == 0) {
        part_ml[(bh * splits + split) * 2] = mm;
        part_ml[(bh * splits + split) * 2 + 1] = ll;
      }
    }
  }
  if (splits == 1) return;

  // the last of the head block's chunks to finish merges them, in chunk
  // order (the result does not depend on which block is last), and resets
  // the counter for the next call; an empty chunk's weight is 0 (chunk 0
  // always holds row 0, so the max is finite)
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&counters[hb], 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int idx = threadIdx.x; idx < G * D; idx += W * 32) {
    const int hh = idx / D, d = idx % D;
    const size_t bh = (size_t)b * H + h0 + hh;
    const float* ml = part_ml + bh * splits * 2;
    const float* pa = part_acc + bh * splits * D + d;
    float mm = kMasked;
    for (int i = 0; i < splits; ++i) mm = fmaxf(mm, __ldcg(ml + 2 * i));
    float ll = 0.f, a = 0.f;
    for (int i = 0; i < splits; ++i) {
      const float c = exp2f(__ldcg(ml + 2 * i) - mm);
      ll = fmaf(__ldcg(ml + 2 * i + 1), c, ll);
      a = fmaf(__ldcg(pa + (size_t)i * D), c, a);
    }
    out[bh * D + d] = from_float<TQ>(a / fmaxf(ll, 1e-30f));
  }
  if (threadIdx.x == 0) counters[hb] = 0;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* part_ml;
  float* part_acc;
  int* counters;
  const int* pos;
  int B, H, KV, S, chunk, splits, G, warps;
  long long k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale2;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int D, int G, int W>
cudaError_t launch(const Args& a) {
  const dim3 grid(a.splits, a.B * a.KV * (a.H / a.KV / G));
  decode_split_kernel<TQ, TKV, D, G, W><<<grid, W * 32, 0, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k), static_cast<const TKV*>(a.v),
      static_cast<TQ*>(a.out), a.part_ml, a.part_acc, a.counters, a.pos, a.H, a.KV, a.S, a.chunk,
      a.splits, a.k_sb, a.k_ss, a.k_sh, a.v_sb, a.v_ss, a.v_sh, a.scale2);
  return cudaGetLastError();
}

// 16 warps a block for 1 or 2 heads (one pass then covers 256 rows at D64
// bf16: generate's cache in one block a head, no merge); 4 warps for
// longer caches (more, smaller blocks resident a SM) and for 4 or 8 heads
// (whose registers hold 4 or 8 heads' q and accumulators)
template <typename TQ, typename TKV, int D, int G>
cudaError_t dispatch_w(const Args& a) {
  if (a.warps == 4) return launch<TQ, TKV, D, G, 4>(a);
  if constexpr (G <= 2) {
    if (a.warps == 16) return launch<TQ, TKV, D, G, 16>(a);
  }
  return cudaErrorInvalidValue;
}

template <typename TQ, typename TKV, int D>
cudaError_t dispatch_g(const Args& a) {
  switch (a.G) {
    case 1: return dispatch_w<TQ, TKV, D, 1>(a);
    case 2: return dispatch_w<TQ, TKV, D, 2>(a);
    case 4: return dispatch_w<TQ, TKV, D, 4>(a);
    case 8: return dispatch_w<TQ, TKV, D, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TQ, typename TKV>
cudaError_t dispatch_d(int D, const Args& a) {
  switch (D) {
    case 64: return dispatch_g<TQ, TKV, 64>(a);
    case 128: return dispatch_g<TQ, TKV, 128>(a);
    case 256: return dispatch_g<TQ, TKV, 256>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TQ>
cudaError_t dispatch_kv(int kv_dtype, int D, const Args& a) {
  switch (kv_dtype) {
    case 0: return dispatch_d<TQ, float>(D, a);
    case 1: return dispatch_d<TQ, __half>(D, a);
    case 2: return dispatch_d<TQ, __nv_bfloat16>(D, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 float32, 1 float16, 2 bfloat16. Strides in elements; the
// head dim is unit-stride. pos is an int32 [1] in device memory (the last
// live row; below 0 it counts as 0, past S-1 as S-1), never read on the
// host. The rows 0..S-1 are cut into `splits` chunks of `chunk` rows (every
// chunk holds a row of the cache; those past pos are empty at run time);
// with splits > 1 part_ml [B, H, splits, 2] and part_acc [B, H, splits, D]
// are f32 scratch and counters [B * H / G] int32 zeros (left zero by every
// call).
// G query heads a block (1, 2, 4 or 8, dividing H / KV), `warps` warps a
// block (4, or 16 for G <= 2). Returns the CUDA
// error of the launch (0 on success); cudaErrorInvalidValue for shapes or
// dtypes the kernel does not take. Asynchronous on `stream`.
extern "C" int decode_attention_launch(const void* q, const void* k_cache,
                                       const void* v_cache, void* out, void* part_ml,
                                       void* part_acc, void* counters, const void* pos, int B,
                                       int S, int H, int KV, int D, int splits, int chunk, int G,
                                       int warps,
                                       long long k_sb, long long k_ss, long long k_sh,
                                       long long v_sb, long long v_ss, long long v_sh,
                                       float sm_scale,
                                       int q_dtype, int kv_dtype, void* stream) {
  if (B < 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || !pos || G <= 0 ||
      G > kMaxG || (H / KV) % G != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return 0;
  // every chunk holds at least one row and together they hold exactly S
  if (splits <= 0 || chunk <= 0 || (long long)splits * chunk < S ||
      (long long)(splits - 1) * chunk >= S ||
      (splits > 1 && (!part_ml || !part_acc || !counters))) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{q, k_cache, v_cache, out, static_cast<float*>(part_ml),
               static_cast<float*>(part_acc), static_cast<int*>(counters),
               static_cast<const int*>(pos), B, H, KV, S, chunk, splits, G, warps,
               k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, sm_scale * kLog2e,
               static_cast<cudaStream_t>(stream)};
  switch (q_dtype) {
    case 0: return (int)dispatch_kv<float>(kv_dtype, D, a);
    case 1: return (int)dispatch_kv<__half>(kv_dtype, D, a);
    case 2: return (int)dispatch_kv<__nv_bfloat16>(kv_dtype, D, a);
    default: return (int)cudaErrorInvalidValue;
  }
}
