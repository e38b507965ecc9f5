// Decode attention against a contiguous KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas kernel deepspeed_tpu/ops/pallas/decode_attention.py
// decode_attention (body _decode_kernel): one query token per (batch, query
// head) attends the rows 0..pos of its batch entry's cache [Smax, KV, D]
// (pos inclusive, one pos for the whole batch), online softmax in f32,
// output acc / max(l, 1e-30) in the query's dtype. GQA: query head h reads
// kv head h / (H / KV). Offline generate runs it once per layer and decode
// step, on a layer's slice of the [L, B, Smax, H, D] cache.
//
// What bounds it on the card: HBM bytes. Each live key and value row is
// read once and used for 2*D flops, ~1 flop per byte; the least time is the
// K+V bytes of rows 0..pos over 3.35 TB/s.
//
// What this simple design does about that:
//  - one block per (batch, query head), the design of the paged decode
//    kernel: the block walks its rows itself and keeps the softmax state
//    in registers, so nothing carries across blocks (the TPU grid carried
//    m/l/acc across its S blocks inside one program);
//  - rows past pos are never read (the TPU kernel read all of Smax and
//    masked the rows past pos);
//  - each warp owns a lane-contiguous slice of D (D/32 elements a lane, one
//    vector load), so a key row is one coalesced warp load; each warp keeps
//    kUnroll rows in flight per iteration, the block's warps stride over the
//    rows, then merge their (m, l, acc) through shared memory;
//  - the cache is read through its batch, sequence and head strides (the
//    last dimension unit-stride), so a layer's slice of the stacked cache
//    is passed without a copy.
// What it does not do yet: split-K across blocks for long caches (a batch
// entry's rows are walked by one block per head), sharing one K/V read
// between the query heads of a GQA group, TMA.
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

constexpr int kWarps = 4;   // warps per block
constexpr int kUnroll = 4;  // rows in flight per warp per iteration

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
decode_kernel(const TQ* __restrict__ q,     // [B, H, D] contiguous
              const TKV* __restrict__ k,    // [B, Smax, KV, D] strided
              const TKV* __restrict__ v,    // [B, Smax, KV, D] strided
              TQ* __restrict__ out,         // [B, H, D] contiguous
              int H, int KV, int last,      // last = the last live row (pos, within Smax)
              long long k_sb, long long k_ss, long long k_sh,
              long long v_sb, long long v_ss, long long v_sh, float sm_scale) {
  constexpr int E = D / 32;  // elements of D per lane
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int g = h / (H / KV);  // this head's kv column (GQA)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float qv[E];
  load_floats<TQ, E>(q + ((size_t)b * H + h) * D + lane * E, qv);

  const TKV* kb = k + b * k_sb + g * k_sh + lane * E;
  const TKV* vb = v + b * v_sb + g * v_sh + lane * E;

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
        float kk[E];
        load_floats<TKV, E>(kb + s * k_ss, kk);
        load_floats<TKV, E>(vb + s * v_ss, vv[u]);
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
      // rows past last get -1e30 and contribute exp(-1e30 - m_new) == 0
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

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int B, H, KV, last;
  long long k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float sm_scale;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int D>
void launch(const Args& a) {
  decode_kernel<TQ, TKV, D><<<a.B * a.H, kWarps * 32, 0, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k), static_cast<const TKV*>(a.v),
      static_cast<TQ*>(a.out), a.H, a.KV, a.last, a.k_sb, a.k_ss, a.k_sh, a.v_sb, a.v_ss,
      a.v_sh, a.sm_scale);
}

template <typename TQ, typename TKV>
bool dispatch_d(int D, const Args& a) {
  switch (D) {
    case 64: launch<TQ, TKV, 64>(a); return true;
    case 128: launch<TQ, TKV, 128>(a); return true;
    case 256: launch<TQ, TKV, 256>(a); return true;
    default: return false;
  }
}

template <typename TQ>
bool dispatch_kv(int kv_dtype, int D, const Args& a) {
  switch (kv_dtype) {
    case 0: return dispatch_d<TQ, float>(D, a);
    case 1: return dispatch_d<TQ, __half>(D, a);
    case 2: return dispatch_d<TQ, __nv_bfloat16>(D, a);
    default: return false;
  }
}

}  // namespace

// dtype codes: 0 float32, 1 float16, 2 bfloat16. Strides in elements; the
// head dim is unit-stride. Returns the CUDA error of the launch (0 on
// success); cudaErrorInvalidValue for shapes or dtypes the kernel does not
// take. The launch is asynchronous on `stream`.
extern "C" int decode_attention_launch(const void* q, const void* k_cache,
                                       const void* v_cache, void* out, int B, int S, int H,
                                       int KV, int D, int pos, long long k_sb, long long k_ss,
                                       long long k_sh, long long v_sb, long long v_ss,
                                       long long v_sh, float sm_scale, int q_dtype,
                                       int kv_dtype, void* stream) {
  if (B < 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || pos < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return 0;
  const Args a{q, k_cache, v_cache, out, B, H, KV, pos < S ? pos : S - 1,
               k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, sm_scale,
               static_cast<cudaStream_t>(stream)};
  bool ok;
  switch (q_dtype) {
    case 0: ok = dispatch_kv<float>(kv_dtype, D, a); break;
    case 1: ok = dispatch_kv<__half>(kv_dtype, D, a); break;
    case 2: ok = dispatch_kv<__nv_bfloat16>(kv_dtype, D, a); break;
    default: ok = false;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
