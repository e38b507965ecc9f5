// Paged decode attention for Hopper (sm_90a): 16-byte loads, GQA groups a
// block, split-K over whole pages and a deterministic in-kernel merge.
//
// Replaces the Pallas kernel deepspeed_tpu/ops/pallas/decode_attention.py
// paged_decode_attention (body _paged_kernel): one query token per serving
// slot attends that slot's logical KV cache, the pages
// block_tables[b, 0..n) of a shared pool [P, KV, page, D], keys at
// positions > pos[b] masked (pos inclusive), online softmax in f32,
// output acc / max(l, 1e-30) in the query's dtype. GQA: query head h reads
// kv head h / (H / KV).
//
// int8 mode (the TPU kernel's `quantized`): the pool holds int8 codes and
// scales [P, KV, 2] f32 holds one K and one V scale per (page, kv head).
// Codes are converted four at a time (prmt into the mantissa of 2^23, one
// subtraction each: exact); the K scale multiplies the score and the V
// scale the probability (two multiplies a key, not 2 D), so q.k and p.v
// run on the codes and the result is the TPU kernel's dequantize-to-f32
// up to f32 rounding. A fresh page's scale is 0, so its keys score 0 and its
// values add 0; masked keys (past pos) get probability exactly 0.
//
// What bounds it on the card: HBM bytes. Each live key and value row is
// read once and used for 2*D flops per query head, ~1 flop per byte; the
// least time is the K+V bytes of the live rows over 3.35 TB/s, a few us at
// the serving shapes, so a launch and the bytes kept in flight decide it.
//
// What this design does about it (the contiguous decode kernel's, over
// pages):
//  - 16-byte loads: a row is TPR lanes x 16 bytes (D64 bf16: 8 lanes, 4 rows
//    a warp load; D64 int8: 4 lanes, 8 rows) and each lane keeps U = 4
//    consecutive rows of one page in flight (pages are a multiple of 4
//    rows), so it reads the page's table entry (and its scales) once for
//    the four;
//  - the U rows' dot products reduce across their TPR lanes together, and
//    the online softmax runs once per U rows in log2 units on exp2;
//  - GQA: one block serves G query heads of one KV head (the largest of 8,
//    4, 2, 1 dividing H / KV whose q and accumulators fit in registers), so
//    the group's rows are read once;
//  - split-K: the table's n * page rows are cut into `splits` chunks of
//    `chunk` rows, whole pages and whole passes each, planned on the host
//    from shapes alone (ops/paged_decode_attention.py kernel_plan; never
//    from pos, which lives on the device), one block per (chunk, slot, head
//    group). A chunk past pos[b] exits at once; the others write their
//    partial (m, l, acc) in f32 and count themselves on the (slot, group)
//    counter, and the block that arrives last merges the live chunks in
//    chunk order by their log-sum-exp and resets the counter: no atomic
//    sums, the result repeats bit for bit, one device launch a call. A
//    slot with one live chunk has it write the output directly; a table
//    that one 16-warp pass covers takes one block a group and no merge;
//  - rows past pos are never read (the TPU kernel copied every page in and
//    skipped only their compute).
// What it does not do: TMA or cp.async.bulk (16-byte register loads keep
// enough in flight at these sizes); overlapping its launch with the
// previous kernel's tail.
//
// On P's rounding: P is kept in f32 for the weighted sum at every dtype
// (not rounded to the cache dtype as the TPU kernel's bf16 path does), as
// the plain version computes it.
//
// Inactive serving slots point every table entry at the scratch page 0,
// whose contents are garbage; every page index is clamped to [0, P) and
// the rows to the table's n pages, so no read leaves the pool. A slot with
// pos < 0 reads nothing and gets zeros.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kU = 4;      // consecutive rows in flight per lane
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
  static constexpr int RPW = 32 / TPR;                        // row groups a warp
  static constexpr int RPB = RPW * W * kU;                    // rows a block pass
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

// the E elements as floats; int8 codes four at a time: byte i of w ^
// 0x80808080 (code + 128) placed under the exponent of 2^23, minus 2^23 + 128
template <typename T, int E>
__device__ __forceinline__ void raw_floats(const Raw<T, E>& r, float (&x)[E]) {
  if constexpr (std::is_same<T, int8_t>::value) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(r.u);
#pragma unroll
    for (int j = 0; j < E / 4; ++j) {
      const uint32_t biased = w[j] ^ 0x80808080u;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        x[4 * j + i] = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7440 + i)) - 8388736.f;
    }
  } else {
    const T* t = reinterpret_cast<const T*>(r.u);
#pragma unroll
    for (int j = 0; j < E; ++j) x[j] = to_float(t[j]);
  }
}

// N contiguous elements of T at p (aligned to their size, 4 to 64 bytes)
// into floats: q, whose dtype may differ from the pool's
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

// one block: G query heads (h0 .. h0+G-1, all reading kv head g) of slot b
// over the rows [r0, r1) of chunk `split`
template <typename TQ, typename TKV, int D, int G, int W>
__global__ void __launch_bounds__(W * 32)
paged_split_kernel(const TQ* __restrict__ q,                  // [B, H, D]
                   const TKV* __restrict__ k_pool,            // [P, KV, page, D]
                   const TKV* __restrict__ v_pool,            // [P, KV, page, D]
                   const int32_t* __restrict__ block_tables,  // [B, n]
                   const int32_t* __restrict__ pos,           // [B]
                   const float* __restrict__ scales,          // [P, KV, 2] (int8 pools)
                   TQ* __restrict__ out,                      // [B, H, D]
                   float* __restrict__ part_ml,               // [B, H, splits, 2]
                   float* __restrict__ part_acc,              // [B, H, splits, D]
                   int* __restrict__ counters,                // [B * H / G], zero between calls
                   int H, int KV, int P, int page, int n, int chunk, int splits, float scale2) {
  using L = Lay<TKV, D, W>;
  constexpr int E = L::E;
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  const int split = blockIdx.x;
  const int hb = blockIdx.y;  // head block over B * KV * (rep / G)
  const int rep = H / KV;
  const int per_kv = rep / G;
  const int b = hb / (KV * per_kv);
  const int g = (hb / per_kv) % KV;
  const int h0 = g * rep + (hb % per_kv) * G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane % L::TPR;   // which E columns of the row
  const int rgrp = lane / L::TPR;  // which row group of the warp
  const int col = sub * E;

  // live rows 0 .. n_rows - 1 of this slot, in `live` chunks
  const int n_rows = max(0, min(pos[b], n * page - 1) + 1);
  const int live = (n_rows + chunk - 1) / chunk;
  const int r0 = split * chunk;
  const int r1 = min(r0 + chunk, n_rows);

  if (r0 < n_rows) {  // block-uniform
    float qv[G][E];
#pragma unroll
    for (int hh = 0; hh < G; ++hh)
      load_floats<TQ, E>(q + ((size_t)b * H + h0 + hh) * D + col, qv[hh]);
    const int32_t* bt = block_tables + (size_t)b * n;
    const size_t head_off = (size_t)g * page * D + col;

    float m[G], l[G], acc[G][E];
#pragma unroll
    for (int hh = 0; hh < G; ++hh) {
      m[hh] = kMasked;
      l[hh] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[hh][e] = 0.f;
    }

    // the loop bound is the block's, so every lane reaches the shuffles
    for (int base = r0; base < r1; base += L::RPB) {
      const int s0 = base + (warp * L::RPW + rgrp) * kU;  // U rows of one page
      Raw<TKV, E> kr[kU], vr[kU];
      float k_scale = 1.f, v_scale = 1.f;
      if (s0 < r1) {
        const int pg = min(max(bt[s0 / page], 0), P - 1);
        const TKV* kp = k_pool + ((size_t)pg * KV * page + s0 % page) * D + head_off;
        const TKV* vp = v_pool + ((size_t)pg * KV * page + s0 % page) * D + head_off;
        if constexpr (kQuant) {
          const float2 sc = __ldg(reinterpret_cast<const float2*>(scales) + (size_t)pg * KV + g);
          k_scale = sc.x;
          v_scale = sc.y;
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          if (s0 + u < r1) {
            load_raw<TKV, E>(kr[u], kp + u * D);
            load_raw<TKV, E>(vr[u], vp + u * D);
          } else {
#pragma unroll
            for (int i = 0; i < (int)(E * sizeof(TKV) / 16); ++i)
              kr[u].u[i] = vr[u].u[i] = make_uint4(0, 0, 0, 0);
          }
        }
      } else {
#pragma unroll
        for (int u = 0; u < kU; ++u)
#pragma unroll
          for (int i = 0; i < (int)(E * sizeof(TKV) / 16); ++i)
            kr[u].u[i] = vr[u].u[i] = make_uint4(0, 0, 0, 0);
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
      const float ks2 = k_scale * scale2;
      float vv[kU][E];
#pragma unroll
      for (int u = 0; u < kU; ++u) raw_floats<TKV, E>(vr[u], vv[u]);
#pragma unroll
      for (int hh = 0; hh < G; ++hh) {
        float mx = m[hh];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          sc[hh][u] = (s0 + u < r1) ? sc[hh][u] * ks2 : kMasked;
          mx = fmaxf(mx, sc[hh][u]);
        }
        const float corr = exp2f(m[hh] - mx);
        m[hh] = mx;
        l[hh] *= corr;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[hh][e] *= corr;
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const float p = (s0 + u < r1) ? exp2f(sc[hh][u] - mx) : 0.f;
          l[hh] += p;
          const float pv = kQuant ? p * v_scale : p;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[hh][e] = fmaf(pv, vv[u][e], acc[hh][e]);
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
      if (live == 1) {
        out[bh * D + d] = from_float<TQ>(a / fmaxf(ll, 1e-30f));
      } else {
        part_acc[(bh * splits + split) * D + d] = a;
        if (d == 0) {
          part_ml[(bh * splits + split) * 2] = mm;
          part_ml[(bh * splits + split) * 2 + 1] = ll;
        }
      }
    }
  } else if (split == 0) {  // no live row: zeros
    for (int idx = threadIdx.x; idx < G * D; idx += W * 32)
      out[((size_t)b * H + h0 + idx / D) * D + idx % D] = from_float<TQ>(0.f);
  }
  if (splits == 1) return;

  // the last of the (slot, group)'s chunks to finish merges the live ones
  // in chunk order (the result does not depend on which block is last) and
  // resets the counter for the next call
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&counters[hb], 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  if (threadIdx.x == 0) counters[hb] = 0;
  if (live < 2) return;
  __threadfence();
  for (int idx = threadIdx.x; idx < G * D; idx += W * 32) {
    const int hh = idx / D, d = idx % D;
    const size_t bh = (size_t)b * H + h0 + hh;
    const float* ml = part_ml + bh * splits * 2;
    const float* pa = part_acc + bh * splits * D + d;
    float mm = kMasked;
    for (int i = 0; i < live; ++i) mm = fmaxf(mm, __ldcg(ml + 2 * i));
    float ll = 0.f, a = 0.f;
    for (int i = 0; i < live; ++i) {
      const float c = exp2f(__ldcg(ml + 2 * i) - mm);
      ll = fmaf(__ldcg(ml + 2 * i + 1), c, ll);
      a = fmaf(__ldcg(pa + (size_t)i * D), c, a);
    }
    out[bh * D + d] = from_float<TQ>(a / fmaxf(ll, 1e-30f));
  }
}

struct Args {
  const void *q, *k, *v, *bt, *pos, *scales;
  void* out;
  float* part_ml;
  float* part_acc;
  int* counters;
  int B, H, KV, P, page, n, chunk, splits, G, warps;
  float scale2;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int D, int G, int W>
cudaError_t launch(const Args& a) {
  const dim3 grid(a.splits, a.B * a.KV * (a.H / a.KV / G));
  paged_split_kernel<TQ, TKV, D, G, W><<<grid, W * 32, 0, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k), static_cast<const TKV*>(a.v),
      static_cast<const int32_t*>(a.bt), static_cast<const int32_t*>(a.pos),
      static_cast<const float*>(a.scales), static_cast<TQ*>(a.out), a.part_ml, a.part_acc,
      a.counters, a.H, a.KV, a.P, a.page, a.n, a.chunk, a.splits, a.scale2);
  return cudaGetLastError();
}

// 16 warps a block for 1 or 2 heads over a table one pass covers (one block
// a head group, no merge); 4 warps for longer tables and for 4 or 8 heads.
// A lane holds q and the accumulator of its E columns for each of the G
// heads: G * E at most kMaxHeadElems (the plan's MAX_HEAD_ELEMENTS), so no
// instance spills
constexpr int kMaxHeadElems = 64;

template <typename TQ, typename TKV, int D, int G>
cudaError_t dispatch_w(const Args& a) {
  if constexpr (G * Lay<TKV, D, 4>::E <= kMaxHeadElems) {
    if (a.warps == 4) return launch<TQ, TKV, D, G, 4>(a);
    if constexpr (G <= 2) {
      if (a.warps == 16) return launch<TQ, TKV, D, G, 16>(a);
    }
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
    case 3:
      if (a.scales == nullptr) return cudaErrorInvalidValue;
      return dispatch_d<TQ, int8_t>(D, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q dtype codes: 0 float32, 1 float16, 2 bfloat16; kv dtype codes the same
// plus 3 int8 (then `scales` [P, KV, 2] f32 is required; it is ignored
// otherwise). The table's n * page rows are cut into `splits` chunks of
// `chunk` rows (whole pages; every chunk non-empty); with splits > 1
// part_ml [B, H, splits, 2] and part_acc [B, H, splits, D] are f32 scratch
// and counters [B * H / G] int32 zeros (left zero by every call). G query
// heads a block (1, 2, 4 or 8, dividing H / KV, G * E <= 64), `warps` warps
// a block (4, or 16 for G <= 2); page a multiple of 4. Returns the CUDA error of the
// launch (0 on success); cudaErrorInvalidValue for shapes or dtypes the
// kernel does not take. Asynchronous on `stream`.
extern "C" int paged_decode_attention_launch(const void* q, const void* k_pool,
                                             const void* v_pool, const void* block_tables,
                                             const void* pos, const void* scales, void* out,
                                             void* part_ml, void* part_acc, void* counters,
                                             int B, int H, int KV, int P, int page, int n, int D,
                                             int splits, int chunk, int G, int warps,
                                             float sm_scale, int q_dtype, int kv_dtype,
                                             void* stream) {
  if (B < 0 || H <= 0 || KV <= 0 || H % KV != 0 || P <= 0 || page <= 0 || page % kU != 0 ||
      n <= 0 || G <= 0 || G > kMaxG || (H / KV) % G != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return 0;
  const long long rows = (long long)n * page;
  if (splits <= 0 || chunk <= 0 || chunk % page != 0 || (long long)splits * chunk < rows ||
      (long long)(splits - 1) * chunk >= rows ||
      (splits > 1 && (!part_ml || !part_acc || !counters))) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{q, k_pool, v_pool, block_tables, pos, scales, out,
               static_cast<float*>(part_ml), static_cast<float*>(part_acc),
               static_cast<int*>(counters), B, H, KV, P, page, n, chunk, splits, G, warps,
               sm_scale * kLog2e, static_cast<cudaStream_t>(stream)};
  switch (q_dtype) {
    case 0: return (int)dispatch_kv<float>(kv_dtype, D, a);
    case 1: return (int)dispatch_kv<__half>(kv_dtype, D, a);
    case 2: return (int)dispatch_kv<__nv_bfloat16>(kv_dtype, D, a);
    default: return (int)cudaErrorInvalidValue;
  }
}
