// Paged multi-token attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel deepspeed_tpu/ops/pallas/decode_attention.py
// paged_multitoken_attention (body _paged_multitoken_kernel): T query
// tokens per serving slot attend that slot's logical KV cache, the pages
// block_tables[b, 0..n) of a shared pool [P, KV, page, D]. Query t of slot
// b sits at position base[b] + t and sees keys at positions <= base[b] + t
// (the chunk's own K/V is already in the pool: update-then-attend). Online
// softmax in f32, output acc / max(l, 1e-30) in the query's dtype,
// [B, T, H, D]. GQA: query head h reads kv head h / (H / KV).
//
// int8 mode (the TPU kernel's `quantized`): the pool holds int8 codes and
// scales [P, KV, 2] f32 one K and one V scale per (page, kv head). A chunk
// row's 16-byte vectors of codes are converted with one cvt each and
// multiplied by the row's page scales (read beside the row's table entry),
// and the chunk lands in shared memory as f32, so both products run on f32
// values, as the TPU kernel's dequantize-to-f32 does. A fresh page's scale
// is 0, so its values are 0; masked keys still get probability exactly 0.
//
// What bounds it on the card: at the chunk widths serving uses (T <= ~256)
// the bytes of the live K/V rows. Each row is read once per block and used
// by the block's TQ queries (2*D flops each), so a block does ~TQ flops per
// byte; the card's ridge point is ~295 bf16 flops per byte, so until T and
// the tile grow far past that the least time is the live K+V bytes over
// 3.35 TB/s. Beyond it (long chunks over long caches) it turns bound by
// its flops, which this kernel does on the FMA pipes, not the tensor cores.
//
// What this simple design does about that:
//  - one block per (slot, query head, tile of kTQ queries); the block walks
//    the slot's block table itself and keeps every query's softmax state in
//    registers, so nothing carries across blocks (the TPU grid carried
//    m/l/acc across its page axis in scratch, which Hopper's unordered
//    blocks cannot do);
//  - each chunk of NK keys is loaded once into shared memory (16-byte
//    vector loads, kept in the pool's dtype) and applied to all of the
//    tile's queries: that reuse is the point of a T-query kernel over T
//    calls of the decode kernel;
//  - only keys 0..min(base + t_last, n*page - 1) are read, t_last the
//    tile's last query: pages past it are never touched (the TPU kernel
//    still copied them in and skipped only their compute);
//  - scores: lane j of a warp owns key j of the chunk (rows padded by one
//    word in shared memory so the lanes' reads fall in distinct banks) and
//    walks D against the query rows, which every lane reads at once; the
//    weighted sum: each lane owns D/32 elements of D and takes the keys'
//    probabilities from their lanes by shuffle.
// What it does not do yet: tensor cores (mma.sync / wgmma) for the two
// products, TMA or cp.async double-buffering of the chunks, sharing one
// K/V read between the query heads of a GQA group, split-K over pages for
// long caches, or keeping int8 codes (not f32) in shared memory.
//
// Bounds: every page id is clamped to [0, P); the key loop stops at the
// table's n pages; query rows past T are neither read nor written; key rows
// past the block's last live key are zero-filled in shared memory. Chunk
// tables are scratch-padded past the prompt's pages, and inactive slots
// point at the scratch page 0, whose contents are garbage: no read leaves
// the pool whatever the table holds. base[b] must be >= 0.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;               // warps per block
constexpr int kQW = 4;                  // queries a warp owns
constexpr int kTQ = kWarps * kQW;       // queries a block owns
constexpr int kSmemBudget = 48 * 1024;  // static shared memory of one block

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

// two consecutive elements at p (4-byte aligned for 16-bit types) as floats
__device__ __forceinline__ float2 load2(const float* p) { return make_float2(p[0], p[1]); }
__device__ __forceinline__ float2 load2(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// shared-memory layout of one block, for chunks held as TKV: KS = a K/V
// chunk row's stride (D plus one 32-bit word), NK = keys per chunk, 32 (one
// a lane) where the two chunks and the query tile fit the static budget
template <typename TKV, int D>
struct Smem {
  static constexpr int KS = D + 4 / (int)sizeof(TKV);
  static constexpr int kRow = 2 * KS * (int)sizeof(TKV);  // a key's K+V bytes
  static constexpr int kQ = kTQ * D * (int)sizeof(float);
  static constexpr int NK = 32 * kRow + kQ <= kSmemBudget ? 32
                            : 16 * kRow + kQ <= kSmemBudget ? 16 : 8;
};

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kWarps * 32)
paged_multitoken_kernel(const TQ* __restrict__ q,                  // [B, T, H, D]
                        const TKV* __restrict__ k_pool,            // [P, KV, page, D]
                        const TKV* __restrict__ v_pool,            // [P, KV, page, D]
                        const int32_t* __restrict__ block_tables,  // [B, n]
                        const int32_t* __restrict__ base,          // [B]
                        const float* __restrict__ scales,          // [P, KV, 2] (int8 pools)
                        TQ* __restrict__ out,                      // [B, T, H, D]
                        int T, int H, int KV, int P, int page, int n, float sm_scale) {
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  // the chunks' type in shared memory: the pool's, f32 for int8 codes
  using TS = typename std::conditional<kQuant, float, TKV>::type;
  constexpr int NK = Smem<TS, D>::NK;
  constexpr int KS = Smem<TS, D>::KS;
  constexpr int E = D / 32;                    // elements of D per lane
  constexpr int VEC = 16 / (int)sizeof(TKV);   // pool elements per 16-byte load
  constexpr int RV = D / VEC;                  // 16-byte loads per row
  // raw bytes, so no element type's constructor runs on shared memory
  __shared__ __align__(16) unsigned char smem_k[NK * KS * sizeof(TS)];
  __shared__ __align__(16) unsigned char smem_v[NK * KS * sizeof(TS)];
  __shared__ __align__(16) float qs[kTQ * D];
  TS* ks = reinterpret_cast<TS*>(smem_k);
  TS* vs = reinterpret_cast<TS*>(smem_v);

  const int n_tiles = (T + kTQ - 1) / kTQ;
  const int tile = blockIdx.x % n_tiles;
  const int h = (blockIdx.x / n_tiles) % H;
  const int b = blockIdx.x / (n_tiles * H);
  const int g = h / (H / KV);  // this head's kv column (GQA)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t0 = tile * kTQ;

  const int b0 = base[b];
  const int last_key = n * page - 1;
  // the block's live keys: 0..last (the tile's last query's horizon)
  const int last = min(b0 + min(t0 + kTQ, T) - 1, last_key);

  for (int i = threadIdx.x; i < kTQ * D; i += blockDim.x) {
    const int t = t0 + i / D;
    qs[i] = t < T ? to_float(q[(((size_t)b * T + t) * H + h) * D + i % D]) : 0.f;
  }

  // this warp's queries: t0 + warp*kQW + i; lim[i] = last visible key, or
  // -1 for a row past T (then nothing is live for it and it is not written)
  int lim[kQW];
  int warp_lim = -1;
#pragma unroll
  for (int i = 0; i < kQW; ++i) {
    const int t = t0 + warp * kQW + i;
    lim[i] = t < T ? min(b0 + t, last_key) : -1;
    warp_lim = max(warp_lim, lim[i]);
  }

  float m[kQW], l[kQW], acc[kQW][E];
#pragma unroll
  for (int i = 0; i < kQW; ++i) {
    m[i] = -1e30f;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
  }

  const int32_t* bt = block_tables + (size_t)b * n;
  const size_t page_stride = (size_t)KV * page * D;
  const size_t col = (size_t)g * page * D;
  const float* qw = qs + warp * kQW * D;

  for (int s0 = 0; s0 <= last; s0 += NK) {
    __syncthreads();  // the previous chunk is consumed (and qs is written)
    for (int v = threadIdx.x; v < NK * RV; v += blockDim.x) {
      const int r = v / RV;
      const int c = (v % RV) * VEC;
      const int s = s0 + r;
      uint4 kb = make_uint4(0u, 0u, 0u, 0u), vb = kb;
      float k_scale = 0.f, v_scale = 0.f;
      if (s <= last) {
        const int pg = min(max(bt[s / page], 0), P - 1);
        const size_t off = (size_t)pg * page_stride + col + (size_t)(s % page) * D + c;
        kb = *reinterpret_cast<const uint4*>(k_pool + off);
        vb = *reinterpret_cast<const uint4*>(v_pool + off);
        if constexpr (kQuant) {
          k_scale = scales[((size_t)pg * KV + g) * 2];
          v_scale = scales[((size_t)pg * KV + g) * 2 + 1];
        }
      }
      const TKV* kt = reinterpret_cast<const TKV*>(&kb);
      const TKV* vt = reinterpret_cast<const TKV*>(&vb);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        if constexpr (kQuant) {
          ks[r * KS + c + i] = static_cast<float>(kt[i]) * k_scale;
          vs[r * KS + c + i] = static_cast<float>(vt[i]) * v_scale;
        } else {
          ks[r * KS + c + i] = kt[i];
          vs[r * KS + c + i] = vt[i];
        }
      }
    }
    __syncthreads();
    if (s0 > warp_lim) continue;  // every query of this warp is done

    // scores: lane owns key s0 + lane (lanes past NK own nothing)
    const int kr = lane < NK ? lane : 0;
    float sc[kQW];
#pragma unroll
    for (int i = 0; i < kQW; ++i) sc[i] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; d += 2) {
      const float2 kk = load2(ks + kr * KS + d);
#pragma unroll
      for (int i = 0; i < kQW; ++i) {
        const float2 qq = *reinterpret_cast<const float2*>(qw + i * D + d);
        sc[i] = fmaf(qq.x, kk.x, fmaf(qq.y, kk.y, sc[i]));
      }
    }
    const int s = s0 + lane;
    float p[kQW];
#pragma unroll
    for (int i = 0; i < kQW; ++i) {
      const bool live = lane < NK && s <= lim[i];
      const float x = sc[i] * sm_scale;
      const float m_new = fmaxf(m[i], warp_max(live ? x : -1e30f));
      const float corr = expf(m[i] - m_new);
      p[i] = live ? expf(x - m_new) : 0.f;
      l[i] = l[i] * corr + warp_sum(p[i]);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] *= corr;
      m[i] = m_new;
    }
    // weighted sum: lane owns elements lane*E .. lane*E + E - 1 of D
#pragma unroll 4
    for (int j = 0; j < NK; ++j) {
      float vv[E];
#pragma unroll
      for (int e = 0; e < E; ++e) vv[e] = to_float(vs[j * KS + lane * E + e]);
#pragma unroll
      for (int i = 0; i < kQW; ++i) {
        const float pj = __shfl_sync(0xffffffffu, p[i], j);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[i][e] = fmaf(pj, vv[e], acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kQW; ++i) {
    const int t = t0 + warp * kQW + i;
    if (t >= T) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    TQ* o = out + (((size_t)b * T + t) * H + h) * D + lane * E;
#pragma unroll
    for (int e = 0; e < E; ++e) o[e] = from_float<TQ>(acc[i][e] * inv);
  }
}

template <typename TQ, typename TKV, int D>
void launch(const void* q, const void* k, const void* v, const void* bt, const void* base,
            const void* scales, void* out, int B, int T, int H, int KV, int P, int page, int n,
            float sm_scale, cudaStream_t stream) {
  const int n_tiles = (T + kTQ - 1) / kTQ;
  paged_multitoken_kernel<TQ, TKV, D><<<B * H * n_tiles, kWarps * 32, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<const int32_t*>(bt), static_cast<const int32_t*>(base),
      static_cast<const float*>(scales), static_cast<TQ*>(out), T, H, KV, P, page, n,
      sm_scale);
}

template <typename TQ, typename TKV>
bool dispatch_d(int D, const void* q, const void* k, const void* v, const void* bt,
                const void* base, const void* sc, void* out, int B, int T, int H, int KV,
                int P, int page, int n, float sm_scale, cudaStream_t stream) {
  switch (D) {
    case 64: launch<TQ, TKV, 64>(q, k, v, bt, base, sc, out, B, T, H, KV, P, page, n, sm_scale, stream); return true;
    case 128: launch<TQ, TKV, 128>(q, k, v, bt, base, sc, out, B, T, H, KV, P, page, n, sm_scale, stream); return true;
    case 256: launch<TQ, TKV, 256>(q, k, v, bt, base, sc, out, B, T, H, KV, P, page, n, sm_scale, stream); return true;
    default: return false;
  }
}

template <typename TQ>
bool dispatch_kv(int kv_dtype, int D, const void* q, const void* k, const void* v,
                 const void* bt, const void* base, const void* sc, void* out, int B, int T,
                 int H, int KV, int P, int page, int n, float sm_scale, cudaStream_t stream) {
  switch (kv_dtype) {
    case 0: return dispatch_d<TQ, float>(D, q, k, v, bt, base, sc, out, B, T, H, KV, P, page, n, sm_scale, stream);
    case 1: return dispatch_d<TQ, __half>(D, q, k, v, bt, base, sc, out, B, T, H, KV, P, page, n, sm_scale, stream);
    case 2: return dispatch_d<TQ, __nv_bfloat16>(D, q, k, v, bt, base, sc, out, B, T, H, KV, P, page, n, sm_scale, stream);
    case 3: return sc != nullptr &&
                   dispatch_d<TQ, int8_t>(D, q, k, v, bt, base, sc, out, B, T, H, KV, P, page, n, sm_scale, stream);
    default: return false;
  }
}

}  // namespace

// q dtype codes: 0 float32, 1 float16, 2 bfloat16; kv dtype codes the same
// plus 3 int8 (then `scales` [P, KV, 2] f32 is required; it is ignored
// otherwise). Returns the CUDA error of the launch (0 on success);
// cudaErrorInvalidValue for shapes or dtypes the kernel does not take. The
// launch is asynchronous on `stream`.
extern "C" int paged_multitoken_attention_launch(const void* q, const void* k_pool,
                                                 const void* v_pool, const void* block_tables,
                                                 const void* base, const void* scales,
                                                 void* out, int B, int T, int H, int KV, int P,
                                                 int page, int n, int D, float sm_scale,
                                                 int q_dtype, int kv_dtype, void* stream) {
  if (B < 0 || T <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || P <= 0 || page <= 0 || n <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok;
  switch (q_dtype) {
    case 0: ok = dispatch_kv<float>(kv_dtype, D, q, k_pool, v_pool, block_tables, base, scales, out, B, T, H, KV, P, page, n, sm_scale, s); break;
    case 1: ok = dispatch_kv<__half>(kv_dtype, D, q, k_pool, v_pool, block_tables, base, scales, out, B, T, H, KV, P, page, n, sm_scale, s); break;
    case 2: ok = dispatch_kv<__nv_bfloat16>(kv_dtype, D, q, k_pool, v_pool, block_tables, base, scales, out, B, T, H, KV, P, page, n, sm_scale, s); break;
    default: ok = false;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
