// Paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel deepspeed_tpu/ops/pallas/decode_attention.py
// paged_decode_attention (body _paged_kernel): one query token per serving
// slot attends that slot's logical KV cache, the pages
// block_tables[b, 0..n) of a shared pool [P, KV, page, D], keys at
// positions > pos[b] masked (pos inclusive), online softmax in f32,
// output acc / max(l, 1e-30) in the query's dtype.
//
// What bounds it on the card: HBM bytes. Each live key and value row is
// read once and used for 2*D flops, so the work is ~1 flop per byte, two
// orders of magnitude under the H100's ridge point; the least time is the
// K+V bytes of the live pages over 3.35 TB/s.
//
// What this simple design does about that:
//  - one block per (slot, query head); the block walks the slot's block
//    table itself and keeps the softmax state in registers, so nothing
//    carries across blocks (the TPU grid carried m/l/acc across its page
//    axis, which Hopper's unordered blocks cannot do);
//  - only tokens 0..min(pos[b], n*page-1) are read: pages past pos are
//    never touched (the TPU kernel still copied them in and skipped only
//    their compute);
//  - each warp owns a lane-contiguous slice of D (D/32 elements a lane,
//    read with one vector load), so a key row is one coalesced warp load;
//    each warp keeps kUnroll tokens in flight per iteration and the
//    block's warps stride over the tokens, then merge their (m, l, acc)
//    through shared memory at the end.
// What it does not do yet: TMA, split-K across blocks for long caches
// (a slot's cache is walked by one block), sharing one K/V read between
// the query heads of a GQA group (each head's block re-reads its group's
// rows, from L2 after the first), or the int8 pool mode.
//
// Inactive serving slots point every table entry at the scratch page 0,
// whose contents are garbage; every page index is clamped to [0, P) and
// the token loop to the table's n pages, so no read leaves the pool.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;   // warps per block
constexpr int kUnroll = 4;  // tokens in flight per warp per iteration

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

// N contiguous elements of T at p (aligned to N * sizeof(T), at most 16
// bytes a load) into floats.
template <typename T, int N>
__device__ __forceinline__ void load_floats(const T* __restrict__ p, float (&x)[N]) {
  constexpr int kBytes = N * sizeof(T);
  if constexpr (kBytes % 16 == 0) {
    uint4 buf[kBytes / 16];
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) buf[i] = reinterpret_cast<const uint4*>(p)[i];
    const T* t = reinterpret_cast<const T*>(buf);
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = to_float(t[j]);
  } else if constexpr (kBytes == 8) {
    uint2 buf = *reinterpret_cast<const uint2*>(p);
    const T* t = reinterpret_cast<const T*>(&buf);
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = to_float(t[j]);
  } else if constexpr (kBytes == 4) {
    uint32_t buf = *reinterpret_cast<const uint32_t*>(p);
    const T* t = reinterpret_cast<const T*>(&buf);
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = to_float(t[j]);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = to_float(p[j]);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const TQ* __restrict__ q,                  // [B, H, D]
                    const TKV* __restrict__ k_pool,            // [P, KV, page, D]
                    const TKV* __restrict__ v_pool,            // [P, KV, page, D]
                    const int32_t* __restrict__ block_tables,  // [B, n]
                    const int32_t* __restrict__ pos,           // [B]
                    TQ* __restrict__ out,                      // [B, H, D]
                    int H, int KV, int P, int page, int n, float sm_scale) {
  constexpr int E = D / 32;  // elements of D per lane
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int g = h / (H / KV);  // this head's kv column (GQA)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float qv[E];
  load_floats<TQ, E>(q + ((size_t)b * H + h) * D + lane * E, qv);

  // live tokens 0..last of this slot (last < 0: none)
  const int last = min(pos[b], n * page - 1);
  const int32_t* bt = block_tables + (size_t)b * n;
  const size_t page_stride = (size_t)KV * page * D;
  const size_t col = (size_t)g * page * D + lane * E;

  float m = -1e30f, l = 0.f;
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;

  for (int s0 = warp * kUnroll; s0 <= last; s0 += kWarps * kUnroll) {
    float sc[kUnroll];
    float vv[kUnroll][E];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u;
      float part = 0.f;
      if (s <= last) {
        const int pg = min(max(bt[s / page], 0), P - 1);
        const size_t off = (size_t)pg * page_stride + col + (size_t)(s % page) * D;
        float kk[E];
        load_floats<TKV, E>(k_pool + off, kk);
        load_floats<TKV, E>(v_pool + off, vv[u]);
#pragma unroll
        for (int e = 0; e < E; ++e) part += qv[e] * kk[e];
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) vv[u][e] = 0.f;
      }
      sc[u] = part;
    }
    float mx = -1e30f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      // s0 <= last, so at least sc[0] is a live score and m_new is finite;
      // masked slots get -1e30 and contribute exp(-1e30 - m_new) == 0
      sc[u] = (s0 + u <= last) ? warp_sum(sc[u]) * sm_scale : -1e30f;
      mx = fmaxf(mx, sc[u]);
    }
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= corr;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float p = expf(sc[u] - m_new);
      l += p;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] += p * vv[u][e];
    }
    m = m_new;
  }

  // merge the warps' partial softmax states
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][D];
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) sm_acc[warp][lane * E + e] = acc[e];
  __syncthreads();
  float mm = -1e30f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sm_m[w]);
  float c[kWarps];
  float ll = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    c[w] = expf(sm_m[w] - mm);
    ll += sm_l[w] * c[w];
  }
  const float inv = 1.f / fmaxf(ll, 1e-30f);
  TQ* o = out + ((size_t)b * H + h) * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc_d = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc_d += sm_acc[w][d] * c[w];
    o[d] = from_float<TQ>(acc_d * inv);
  }
}

template <typename TQ, typename TKV, int D>
void launch(const void* q, const void* k, const void* v, const void* bt, const void* pos,
            void* out, int B, int H, int KV, int P, int page, int n, float sm_scale,
            cudaStream_t stream) {
  paged_decode_kernel<TQ, TKV, D><<<B * H, kWarps * 32, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<const int32_t*>(bt), static_cast<const int32_t*>(pos), static_cast<TQ*>(out),
      H, KV, P, page, n, sm_scale);
}

template <typename TQ, typename TKV>
bool dispatch_d(int D, const void* q, const void* k, const void* v, const void* bt,
                const void* pos, void* out, int B, int H, int KV, int P, int page, int n,
                float sm_scale, cudaStream_t stream) {
  switch (D) {
    case 64: launch<TQ, TKV, 64>(q, k, v, bt, pos, out, B, H, KV, P, page, n, sm_scale, stream); return true;
    case 128: launch<TQ, TKV, 128>(q, k, v, bt, pos, out, B, H, KV, P, page, n, sm_scale, stream); return true;
    case 256: launch<TQ, TKV, 256>(q, k, v, bt, pos, out, B, H, KV, P, page, n, sm_scale, stream); return true;
    default: return false;
  }
}

template <typename TQ>
bool dispatch_kv(int kv_dtype, int D, const void* q, const void* k, const void* v,
                 const void* bt, const void* pos, void* out, int B, int H, int KV, int P,
                 int page, int n, float sm_scale, cudaStream_t stream) {
  switch (kv_dtype) {
    case 0: return dispatch_d<TQ, float>(D, q, k, v, bt, pos, out, B, H, KV, P, page, n, sm_scale, stream);
    case 1: return dispatch_d<TQ, __half>(D, q, k, v, bt, pos, out, B, H, KV, P, page, n, sm_scale, stream);
    case 2: return dispatch_d<TQ, __nv_bfloat16>(D, q, k, v, bt, pos, out, B, H, KV, P, page, n, sm_scale, stream);
    default: return false;
  }
}

}  // namespace

// dtype codes: 0 float32, 1 float16, 2 bfloat16. Returns the CUDA error of
// the launch (0 on success); cudaErrorInvalidValue for shapes or dtypes the
// kernel does not take. The launch is asynchronous on `stream`.
extern "C" int paged_decode_attention_launch(const void* q, const void* k_pool,
                                             const void* v_pool, const void* block_tables,
                                             const void* pos, void* out, int B, int H, int KV,
                                             int P, int page, int n, int D, float sm_scale,
                                             int q_dtype, int kv_dtype, void* stream) {
  if (B < 0 || H <= 0 || KV <= 0 || H % KV != 0 || P <= 0 || page <= 0 || n <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok;
  switch (q_dtype) {
    case 0: ok = dispatch_kv<float>(kv_dtype, D, q, k_pool, v_pool, block_tables, pos, out, B, H, KV, P, page, n, sm_scale, s); break;
    case 1: ok = dispatch_kv<__half>(kv_dtype, D, q, k_pool, v_pool, block_tables, pos, out, B, H, KV, P, page, n, sm_scale, s); break;
    case 2: ok = dispatch_kv<__nv_bfloat16>(kv_dtype, D, q, k_pool, v_pool, block_tables, pos, out, B, H, KV, P, page, n, sm_scale, s); break;
    default: ok = false;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
