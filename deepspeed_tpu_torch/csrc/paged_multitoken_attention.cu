// Paged multi-token attention for Hopper (sm_90a): tensor cores, split-K
// over whole pages and a deterministic in-kernel merge.
//
// Replaces the Pallas kernel deepspeed_tpu/ops/pallas/decode_attention.py
// _paged_multitoken_kernel (:258, pallas_call :362, entry
// paged_multitoken_attention :317): T query tokens per serving slot attend
// that slot's logical KV cache, the pages block_tables[b, 0..n) of a shared
// pool [P, KV, page, D]. Query t of slot b sits at position base[b] + t and
// sees keys at positions <= base[b] + t (the chunk's own K/V is already in
// the pool: update-then-attend). Online softmax in f32, output acc /
// max(l, 1e-30) in the query's dtype, [B, T, H, D]. GQA: query head h reads
// kv head h / (H / KV). int8 mode (the TPU kernel's `quantized`, :294-295):
// the pool holds int8 codes and scales [P, KV, 2] f32 one K and one V scale
// per (page, kv head). Chunked prefill, prefix-cache tails and copy-on-write
// run it (3b's chunk program: 24 launches a call at B1 T64 H16 D64, page 16,
// a 36-page table).
//
// What bounds it on the card: at that shape the live K/V rows (64 to 512
// keys; ~1.3 MB a call, the mean over the chunk starts of a 512-token
// prompt) against ~59 MFLOP of products: 0.0004 ms at 3.35 TB/s, far below
// what one launch and a few dependent HBM round trips take. So the design
// fills the card and keeps the chain of each block short; with 64 queries
// a tile it does 64 flops per byte of K/V it reads, so the products belong
// on the tensor cores.
//
// The tensor-core route (q bf16/fp16, a pool of q's dtype or int8, D 64 or
// 128, a page a multiple of 8 rows; the wrapper's rule on shapes alone):
//  - a unit is 64 query rows of one (slot, kv head): up to 64 tokens of one
//    query head, or, for T < 64, the T tokens of gh query heads of the GQA
//    group stacked on the rows (gh * T <= 64), so one K/V read serves the
//    group. A block of 4 warps owns a unit, a warp 16 rows; both products
//    run as mma.sync m16n8k16 with f32 accumulators, q's fragments held in
//    registers for the whole walk;
//  - split-K: the table's n * page rows are cut into chunks of whole pages
//    and whole 64-key tiles, planned on the host from shapes alone
//    (ops/paged_multitoken_attention.py kernel_plan, never from base, which
//    lives on the device), one block per (chunk, unit). A chunk wholly past
//    the unit's last query (base + t_last) exits at once; the others walk
//    their keys in 64-key tiles through a double-buffered cp.async ring
//    (each row gathered through its table entry, the page id clamped to
//    [0, P), rows past the unit's last live key zero-filled and never
//    read), write their partial (m, l, acc) in f32 and count themselves on
//    the unit's counter; the last to arrive merges the live chunks in chunk
//    order by their log-sum-exp (each row's weights through shared memory,
//    the loads of four chunks in flight together) and resets the counter:
//    no atomic sums, the result repeats bit for bit, one device launch a
//    call. A unit with one live chunk writes the output directly;
//  - the online softmax in log2 units on exp2, the mask (key > base + t,
//    the chunk's end) as compares against per-row limits under one
//    warp-uniform branch that tiles with nothing masked skip, the
//    accumulator rescaled only when a row's max moved; P is rounded to q's
//    dtype for P V, as the JAX kernel's bf16 path does (:307);
//  - int8: the codes stay int8 in shared memory (half the bytes of bf16)
//    and are converted to q's 16-bit type in registers (integers up to 127
//    are exact in bf16 and fp16). K's fragments are 4-byte loads: the
//    reduction dim of each k16 step is permuted (lane t takes d 4t..4t+3,
//    in q's fragments the same), which leaves the dot product unchanged;
//    V's are byte loads. The K scale multiplies the score and the V scale
//    is folded into p before p is rounded (an 8-key column tile of the
//    products lies in one page), so a page at scale 0 gives 0 and masked
//    keys keep p = 0 exactly.
// Why mma.sync and not wgmma: a block's work is one or a few 64 x 64 tiles
// per product; wgmma's operands would have to be staged in the swizzled
// layout a descriptor reads (TMA boxes of whole pages, or a re-layout
// pass), and its asynchrony has nothing to overlap in a chain this short.
// Measured (tools/kernel_ablation.py, H100 80GB HBM3 at 700 W): at 3b's
// shape the call takes ~0.0092 ms, ~0.0084 without its products and
// ~0.0069 without the split's merge, so faster products could save at
// most a tenth; wgmma was not built.
//
// Other shapes (fp32 q or pools, D 256, a pool of another 16-bit dtype
// than q's, a page off the 8-row grid) keep the FMA kernel below: one
// block per (slot, query head, tile of 16 queries), each chunk of NK keys
// loaded once into shared memory (int8 codes dequantized to f32 there)
// and applied to all of the tile's queries, lane j owning key j for the
// scores and D/32 output columns for the weighted sum, P kept in f32. It is
// the exact kernel phase 4's fp32 streams compare with the CPU.
//
// Not done yet: wgmma; a transposed int8 V tile (4-byte fragment loads);
// pipelining the first tile's loads with the previous launch's tail.
//
// Bounds: every page id is clamped to [0, P); the key walk stops at the
// table's n pages; query rows past T are neither read nor written. Chunk
// tables are scratch-padded past the prompt's pages, and inactive slots
// point at the scratch page 0, whose contents are garbage: no read leaves
// the pool whatever the table holds. base[b] must be >= 0.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_attention_common.cuh"

namespace {

using namespace flash;

// ---- fp32, D 256 and mixed dtypes: the FMA kernel --------------------------


constexpr int kWarps = 4;               // warps per block
constexpr int kQW = 4;                  // queries a warp owns
constexpr int kTQ = kWarps * kQW;       // queries a block owns
constexpr int kSmemBudget = 48 * 1024;  // static shared memory of one block

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
paged_multitoken_fma(const TQ* __restrict__ q,                  // [B, T, H, D]
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
void launch_fma(const void* q, const void* k, const void* v, const void* bt, const void* base,
            const void* scales, void* out, int B, int T, int H, int KV, int P, int page, int n,
            float sm_scale, cudaStream_t stream) {
  const int n_tiles = (T + kTQ - 1) / kTQ;
  paged_multitoken_fma<TQ, TKV, D><<<B * H * n_tiles, kWarps * 32, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<const int32_t*>(bt), static_cast<const int32_t*>(base),
      static_cast<const float*>(scales), static_cast<TQ*>(out), T, H, KV, P, page, n,
      sm_scale);
}


// ---- the tensor-core route ----------------------------------------------------

constexpr int kUnitRows = 64;  // query rows of a unit: 4 warps x 16
constexpr int kKeyTile = 64;   // keys a tile of the ring
constexpr int kMtThreads = 128;
constexpr int kMaxSplits = 64;  // chunks a table (the plan's SPLIT_MAX)

// shared memory of a block: two stages of a K and a V tile (rows padded so
// the fragment loads hit distinct banks), the stages' int8 scales
template <typename TKV, int D>
struct MtCfg {
  static constexpr bool Q8 = std::is_same<TKV, int8_t>::value;
  static constexpr int LDE = D + 8;                     // 16-bit elements a staged row
  static constexpr int LDB = Q8 ? D + 16 : 2 * LDE;     // bytes a staged row
  static constexpr int TILE_BYTES = kKeyTile * LDB;
  static constexpr int SCALE_FLOATS = 2 * (kKeyTile / 8) * 2;  // [stage][8-key tile][K, V]
  static constexpr size_t STAGE_SMEM = 4 * (size_t)TILE_BYTES + SCALE_FLOATS * 4;
  // the merge reuses it: (m, l) and a weight per (chunk, row), each row's 1 / l
  static constexpr size_t MERGE_SMEM = (3 * kMaxSplits + 1) * kUnitRows * 4;
  static constexpr size_t SMEM = STAGE_SMEM > MERGE_SMEM ? STAGE_SMEM : MERGE_SMEM;
};

struct MtArgs {
  const void *q, *k, *v;
  const int32_t* bt;    // [B, n]
  const int32_t* base;  // [B]
  const float* scales;  // [P, KV, 2] (int8 pools)
  void* out;            // [B, T, H, D]
  float* part_ml;       // [units, splits, 64, 2]
  float* part_acc;      // [units, splits, 64, D]
  int* counters;        // [units], zero between calls
  int T, H, KV, P, page, n, gh, tq, splits, chunk;
  float scale2;  // sm_scale * log2 e
};

// the 16-bit pair (lo, hi) of two int8 codes, exact
template <typename T>
__device__ __forceinline__ uint32_t codes2(int lo, int hi) {
  return pack2<T>(static_cast<float>(lo), static_cast<float>(hi));
}

// the 16-bit pair (hi, lo) of two floats x0, x1: hi their rounding to T, lo
// the rounding of what is left (x = hi + lo to ~2^-17 of x)
template <typename T>
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack2<T>(x0, x1);
  const T* h = reinterpret_cast<const T*>(&hi);
  lo = pack2<T>(x0 - to_float(h[0]), x1 - to_float(h[1]));
}

// one block: unit blockIdx.y (slot, kv head, head group, token tile) over
// the keys of chunk blockIdx.x
template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kMtThreads)
paged_multitoken_mma(const MtArgs a) {
  using C = MtCfg<TKV, D>;
  constexpr bool kQuant = C::Q8;
  constexpr int LDB = C::LDB;
  constexpr int VPR = D * (int)sizeof(TKV) / 16;          // 16-byte vectors a row
  constexpr int NV = kKeyTile * VPR / kMtThreads;         // vectors a thread a tile
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* Kst = smem;                       // stage s at s * TILE_BYTES
  unsigned char* Vst = smem + 2 * C::TILE_BYTES;
  float* Sc = reinterpret_cast<float*>(smem + 4 * C::TILE_BYTES);
  __shared__ int is_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int split = blockIdx.x, u = blockIdx.y;
  const int rep = a.H / a.KV, ntt = (a.T + a.tq - 1) / a.tq;
  int rest = u;
  const int tt = rest % ntt;
  rest /= ntt;
  const int hg = rest % (rep / a.gh);
  rest /= rep / a.gh;
  const int kvh = rest % a.KV;
  const int b = rest / a.KV;
  const int t0 = tt * a.tq, h0 = kvh * rep + hg * a.gh;
  const int rows = a.n * a.page;
  const int c_lo = split * a.chunk;
  const int c_hi = min(c_lo + a.chunk, rows);
  const int32_t* bt = a.bt + (size_t)b * a.n;
  const int b0 = a.base[b];

  // the page of each row the thread copies in a tile (from the table alone,
  // so the first tile's reads go out beside base's)
  auto tile_pages = [&](int s0, int (&pg)[NV]) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int s = s0 + (tid + j * kMtThreads) / VPR;
      pg[j] = s < c_hi ? min(max(bt[s / a.page], 0), a.P - 1) : 0;
    }
  };
  int pg[NV];
  tile_pages(c_lo, pg);

  // the thread's rows r = 16 warp + g + 8 i: token t0 + r % tq of head h0 +
  // r / tq, and q's A fragments of every k16 step
  int tok[2];
  TQ* orow[2];
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g + 8 * i;
    const int j = r / a.tq, tk = t0 + r % a.tq;
    const bool valid = j < a.gh && tk < a.T;
    tok[i] = valid ? tk : -1;
    const size_t off = valid ? (((size_t)b * a.T + tk) * a.H + h0 + j) * D : 0;
    orow[i] = valid ? static_cast<TQ*>(a.out) + off : nullptr;
    const TQ* qr = static_cast<const TQ*>(a.q) + off;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      // the k16 step's columns this lane holds: (2t, 2t+1) and (2t+8, 2t+9),
      // or, against int8 K, (4t, 4t+1) and (4t+2, 4t+3)
      const int c0 = kk * 16 + (kQuant ? 4 * t : 2 * t);
      const int c1 = c0 + (kQuant ? 2 : 8);
      qa[kk][i] = valid ? *reinterpret_cast<const uint32_t*>(qr + c0) : 0u;
      qa[kk][2 + i] = valid ? *reinterpret_cast<const uint32_t*>(qr + c1) : 0u;
    }
  }

  // the unit's last live key (its last query's horizon) and live chunks
  const int last = min(b0 + min(t0 + a.tq, a.T) - 1, rows - 1);
  if (c_lo > last) return;  // wholly past every query of the unit
  const int live = last / a.chunk + 1;
  const int kend = min(c_hi, last + 1);  // this block's keys [c_lo, kend)
  // the last key each row keeps in this chunk (-1: none)
  const int hi[2] = {tok[0] < 0 ? -1 : min(b0 + tok[0], kend - 1),
                     tok[1] < 0 ? -1 : min(b0 + tok[1], kend - 1)};

  const TKV* kp = static_cast<const TKV*>(a.k);
  const TKV* vp = static_cast<const TKV*>(a.v);
  // keys s0 .. s0 + 63 into stage `buf` (pages pg from tile_pages): rows at
  // or past kend zero-filled, never read
  auto load_tile = [&](int s0, int buf, const int (&pg)[NV]) {
    unsigned char* kd = Kst + buf * C::TILE_BYTES;
    unsigned char* vd = Vst + buf * C::TILE_BYTES;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = tid + j * kMtThreads;
      const int r = v / VPR, c = v % VPR;
      const int s = s0 + r;
      const bool ok = s < kend;
      const size_t off =
          ok ? (((size_t)pg[j] * a.KV + kvh) * a.page + s % a.page) * D + c * (16 / sizeof(TKV))
             : 0;
      cp_async16(kd + r * LDB + c * 16, kp + off, ok);
      cp_async16(vd + r * LDB + c * 16, vp + off, ok);
    }
    if constexpr (kQuant) {
      if (tid < kKeyTile / 8) {  // the scales of each 8-key column tile's page
        const int s = s0 + 8 * tid;
        float2 sc = make_float2(0.f, 0.f);
        if (s < kend) {
          const int p8 = min(max(bt[s / a.page], 0), a.P - 1);
          sc = *reinterpret_cast<const float2*>(a.scales + ((size_t)p8 * a.KV + kvh) * 2);
        }
        Sc[(buf * (kKeyTile / 8) + tid) * 2] = sc.x;
        Sc[(buf * (kKeyTile / 8) + tid) * 2 + 1] = sc.y;
      }
    }
  };

  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int ntiles = (kend - c_lo + kKeyTile - 1) / kKeyTile;
  load_tile(c_lo, 0, pg);
  cp_async_commit();
  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    const int s0 = c_lo + it * kKeyTile;
    if (it + 1 < ntiles) {
      tile_pages(s0 + kKeyTile, pg);
      load_tile(s0 + kKeyTile, buf ^ 1, pg);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* Kt = Kst + buf * C::TILE_BYTES;
    const unsigned char* Vt = Vst + buf * C::TILE_BYTES;

    // s = q k^T for the warp's 16 rows and the tile's 64 keys
    float s[kKeyTile / 8][4];
#pragma unroll
    for (int n = 0; n < kKeyTile / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      if constexpr (kQuant) {
#pragma unroll
        for (int n = 0; n < kKeyTile / 8; ++n) {
          const uint32_t w =
              *reinterpret_cast<const uint32_t*>(Kt + (n * 8 + g) * LDB + kk * 16 + 4 * t);
          const uint32_t bb[2] = {
              codes2<TQ>((int)(int8_t)(w & 0xff), (int)(int8_t)((w >> 8) & 0xff)),
              codes2<TQ>((int)(int8_t)((w >> 16) & 0xff), (int)(int8_t)(w >> 24))};
          mma16816<TQ>(s[n], qa[kk], bb);
        }
      } else {
#pragma unroll
        for (int n = 0; n < kKeyTile / 8; n += 2) {
          uint32_t bb[4];
          load_b_rows<TQ, C::LDE>(bb, reinterpret_cast<const TQ*>(Kt), n * 8, kk * 16, lane);
          mma16816<TQ>(s[n], qa[kk], bb);
          mma16816<TQ>(s[n + 1], qa[kk], bb + 2);
        }
      }
    }

    // scores in log2 units (int8: times the page's K scale), the mask, the
    // online softmax over the thread's rows
    float vs[kKeyTile / 8];
#pragma unroll
    for (int n = 0; n < kKeyTile / 8; ++n) {
      float ks = a.scale2;
      vs[n] = 1.f;
      if constexpr (kQuant) {
        ks *= Sc[(buf * (kKeyTile / 8) + n) * 2];
        vs[n] = Sc[(buf * (kKeyTile / 8) + n) * 2 + 1];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= ks;
    }
    const bool whole = __all_sync(0xffffffffu, s0 + kKeyTile - 1 <= min(hi[0], hi[1]));
    if (!whole) {
#pragma unroll
      for (int n = 0; n < kKeyTile / 8; ++n) {
        const int col = s0 + n * 8 + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = col + (e & 1) <= hi[e >> 1] ? s[n][e] : -INFINITY;
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = s[0][2 * i];
#pragma unroll
      for (int n = 0; n < kKeyTile / 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
      const float mn = fmaxf(m[i], quad_max(mx));
      corr[i] = ex2(m[i] - mn);
      m[i] = mn;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < kKeyTile / 8; ++n) {
        s[n][2 * i] = ex2(s[n][2 * i] - mn);
        s[n][2 * i + 1] = ex2(s[n][2 * i + 1] - mn);
        sum += s[n][2 * i] + s[n][2 * i + 1];
      }
      l[i] = fmaf(l[i], corr[i], quad_sum(sum));
    }
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {  // a max moved
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }
    }

    // acc += P v: P rounded to q's dtype; int8: p times the page's V scale,
    // as two 16-bit terms (one rounding of p * scale would cost the output
    // up to an ulp of itself)
#pragma unroll
    for (int kk = 0; kk < kKeyTile / 16; ++kk) {
      if constexpr (kQuant) {
        uint32_t ph[4], pl[4];
        const float v0 = vs[2 * kk], v1 = vs[2 * kk + 1];
        split2<TQ>(s[2 * kk][0] * v0, s[2 * kk][1] * v0, ph[0], pl[0]);
        split2<TQ>(s[2 * kk][2] * v0, s[2 * kk][3] * v0, ph[1], pl[1]);
        split2<TQ>(s[2 * kk + 1][0] * v1, s[2 * kk + 1][1] * v1, ph[2], pl[2]);
        split2<TQ>(s[2 * kk + 1][2] * v1, s[2 * kk + 1][3] * v1, ph[3], pl[3]);
        const int8_t* v8 = reinterpret_cast<const int8_t*>(Vt) + (kk * 16 + 2 * t) * LDB + g;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const int8_t* c = v8 + n * 8;
          const uint32_t bb[2] = {codes2<TQ>(c[0], c[LDB]), codes2<TQ>(c[8 * LDB], c[9 * LDB])};
          mma16816<TQ>(acc[n], ph, bb);
          mma16816<TQ>(acc[n], pl, bb);
        }
      } else {
        uint32_t pa[4];
        a_from_c<TQ>(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int n = 0; n < D / 8; n += 2) {
          uint32_t bb[4];
          load_b_cols<TQ, C::LDE>(bb, reinterpret_cast<const TQ*>(Vt), kk * 16, n * 8, lane);
          mma16816<TQ>(acc[n], pa, bb);
          mma16816<TQ>(acc[n + 1], pa, bb + 2);
        }
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

  if (live == 1) {  // the unit's only live chunk: the output directly
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (orow[i] == nullptr) continue;
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(orow[i] + n * 8 + 2 * t) =
            pack2<TQ>(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    }
    return;
  }

  // this chunk's partial (m, l in log2 units, acc) for every row of the unit
  const size_t prow = ((size_t)u * a.splits + split) * kUnitRows;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g + 8 * i;
    if (t == 0)
      *reinterpret_cast<float2*>(a.part_ml + (prow + r) * 2) = make_float2(m[i], l[i]);
    float* pr = a.part_acc + (prow + r) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(pr + n * 8) = make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
  }
  // the last of the unit's live chunks to finish merges them in chunk order
  // (the result does not depend on which block is last) and resets the
  // counter for the next call
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&a.counters[u], 1) == live - 1;
  __syncthreads();
  if (!is_last) return;
  if (tid == 0) a.counters[u] = 0;
  __threadfence();
  // the chunks' (m, l) into shared memory, then each row's weights
  // exp2(m_chunk - m_row) and 1 / l_row
  float2* ml = reinterpret_cast<float2*>(smem);         // [chunk][row]
  float* wt = reinterpret_cast<float*>(ml + kMaxSplits * kUnitRows);  // [chunk][row]
  float* rinv = wt + kMaxSplits * kUnitRows;            // [row]
  const size_t urow = (size_t)u * a.splits * kUnitRows;
  const float2* pml = reinterpret_cast<const float2*>(a.part_ml) + urow;
#pragma unroll 4
  for (int i = tid; i < live * kUnitRows; i += kMtThreads) ml[i] = __ldcg(pml + i);
  __syncthreads();
  if (tid < kUnitRows) {
    float mm = kMasked;
    for (int c = 0; c < live; ++c) mm = fmaxf(mm, ml[c * kUnitRows + tid].x);
    float ll = 0.f;
    for (int c = 0; c < live; ++c) {
      const float w = ex2(ml[c * kUnitRows + tid].x - mm);
      wt[c * kUnitRows + tid] = w;
      ll = fmaf(ml[c * kUnitRows + tid].y, w, ll);
    }
    rinv[tid] = 1.f / fmaxf(ll, 1e-30f);
  }
  __syncthreads();
  // the outputs, 16 float2 pairs (row r, columns d, d + 1) a thread a
  // pass (D / 32 passes), the loads of four chunks in flight together
  constexpr int PER = 16;
  const float2* pacc = reinterpret_cast<const float2*>(a.part_acc) + urow * (D / 2);
#pragma unroll 1
  for (int i0 = 0; i0 < kUnitRows * D / 2; i0 += PER * kMtThreads) {
    float2 x[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) x[j] = make_float2(0.f, 0.f);
#pragma unroll 4
    for (int c = 0; c < live; ++c) {
      const float2* src = pacc + (size_t)c * kUnitRows * (D / 2) + i0 + tid;
      float2 y[PER];
#pragma unroll
      for (int j = 0; j < PER; ++j) y[j] = __ldcg(src + j * kMtThreads);
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const float w = wt[c * kUnitRows + (i0 + tid + j * kMtThreads) / (D / 2)];
        x[j].x = fmaf(y[j].x, w, x[j].x);
        x[j].y = fmaf(y[j].y, w, x[j].y);
      }
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int idx = i0 + tid + j * kMtThreads;
      const int r = idx / (D / 2), d = (idx % (D / 2)) * 2;
      const int jh = r / a.tq, tk = t0 + r % a.tq;
      if (jh >= a.gh || tk >= a.T) continue;
      TQ* o = static_cast<TQ*>(a.out) + (((size_t)b * a.T + tk) * a.H + h0 + jh) * D + d;
      *reinterpret_cast<uint32_t*>(o) = pack2<TQ>(x[j].x * rinv[r], x[j].y * rinv[r]);
    }
  }
}

template <typename TQ, typename TKV, int D>
cudaError_t launch_mma(const MtArgs& a, int units, cudaStream_t stream) {
  using C = MtCfg<TKV, D>;
  auto kern = paged_multitoken_mma<TQ, TKV, D>;
  cudaError_t err = allow_smem(kern, C::SMEM);
  if (err != cudaSuccess) return err;
  kern<<<dim3(a.splits, units), kMtThreads, C::SMEM, stream>>>(a);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t mma_by_d(int D, const MtArgs& a, int units, cudaStream_t s) {
  switch (D) {
    case 64: return launch_mma<TQ, TKV, 64>(a, units, s);
    case 128: return launch_mma<TQ, TKV, 128>(a, units, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TQ, typename TKV>
bool fma_by_d(int D, const void* q, const void* k, const void* v, const void* bt,
              const void* base, const void* sc, void* out, int B, int T, int H, int KV, int P,
              int page, int n, float sm_scale, cudaStream_t stream) {
  switch (D) {
    case 64: launch_fma<TQ, TKV, 64>(q, k, v, bt, base, sc, out, B, T, H, KV, P, page, n, sm_scale, stream); return true;
    case 128: launch_fma<TQ, TKV, 128>(q, k, v, bt, base, sc, out, B, T, H, KV, P, page, n, sm_scale, stream); return true;
    case 256: launch_fma<TQ, TKV, 256>(q, k, v, bt, base, sc, out, B, T, H, KV, P, page, n, sm_scale, stream); return true;
    default: return false;
  }
}

template <typename TQ>
bool fma_by_kv(int kv_dtype, int D, const void* q, const void* k, const void* v,
               const void* bt, const void* base, const void* sc, void* out, int B, int T, int H,
               int KV, int P, int page, int n, float sm_scale, cudaStream_t stream) {
  switch (kv_dtype) {
    case 0: return fma_by_d<TQ, float>(D, q, k, v, bt, base, sc, out, B, T, H, KV, P, page, n, sm_scale, stream);
    case 1: return fma_by_d<TQ, __half>(D, q, k, v, bt, base, sc, out, B, T, H, KV, P, page, n, sm_scale, stream);
    case 2: return fma_by_d<TQ, __nv_bfloat16>(D, q, k, v, bt, base, sc, out, B, T, H, KV, P, page, n, sm_scale, stream);
    case 3: return sc != nullptr &&
                   fma_by_d<TQ, int8_t>(D, q, k, v, bt, base, sc, out, B, T, H, KV, P, page, n, sm_scale, stream);
    default: return false;
  }
}

}  // namespace

// q dtype codes: 0 float32, 1 float16, 2 bfloat16; kv dtype codes the same
// plus 3 int8 (then `scales` [P, KV, 2] f32 is required; it is ignored
// otherwise). The tensor-core route (q 1 or 2, the pools q's dtype or int8,
// D 64 or 128, page % 8 == 0) takes the plan: heads_per_unit query heads of
// a GQA group times tokens_per_unit tokens a unit (their product <= 64;
// tokens_per_unit == 64 when heads_per_unit == 1 and T >= 64, else T), the
// table's n * page rows cut into `splits` chunks of `chunk` rows (whole
// pages; every chunk non-empty; splits <= 64), part_ml [units, splits, 64,
// 2] and part_acc [units, splits, 64, D] f32 scratch and counters [units]
// int32 zeros (left zero by every call), units = B * KV * (H / KV /
// heads_per_unit) * ceil(T / tokens_per_unit). Other shapes run the FMA
// kernel and ignore the plan. Returns the CUDA error of the launch (0 on
// success); cudaErrorInvalidValue for shapes, dtypes or plans the kernels
// do not take. The launch is asynchronous on `stream`.
extern "C" int paged_multitoken_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* block_tables,
    const void* base, const void* scales, void* out, void* part_ml, void* part_acc,
    void* counters, int B, int T, int H, int KV, int P, int page, int n, int D,
    int heads_per_unit, int tokens_per_unit, int splits, int chunk, float sm_scale, int q_dtype,
    int kv_dtype, void* stream) {
  if (B < 0 || T <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || P <= 0 || page <= 0 || n <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tc = (q_dtype == 1 || q_dtype == 2) && (kv_dtype == q_dtype || kv_dtype == 3) &&
                  (D == 64 || D == 128) && page % 8 == 0;
  if (tc) {
    const int gh = heads_per_unit, tq = tokens_per_unit;
    const long long rows = (long long)n * page;
    if (gh <= 0 || (H / KV) % gh != 0 || tq <= 0 || gh * tq > kUnitRows ||
        (gh > 1 && tq != T) || (tq != T && tq != kUnitRows) || splits <= 0 ||
        splits > kMaxSplits || chunk <= 0 || chunk % page != 0 ||
        (long long)splits * chunk < rows || (long long)(splits - 1) * chunk >= rows ||
        !part_ml || !part_acc || !counters || (kv_dtype == 3 && scales == nullptr)) {
      return (int)cudaErrorInvalidValue;
    }
    const int units = B * KV * (H / KV / gh) * ((T + tq - 1) / tq);
    const MtArgs a{q, k_pool, v_pool, static_cast<const int32_t*>(block_tables),
                   static_cast<const int32_t*>(base), static_cast<const float*>(scales), out,
                   static_cast<float*>(part_ml), static_cast<float*>(part_acc),
                   static_cast<int*>(counters), T, H, KV, P, page, n, gh, tq, splits, chunk,
                   sm_scale * kLog2e};
    const bool q8 = kv_dtype == 3;
    if (q_dtype == 1)
      return (int)(q8 ? mma_by_d<__half, int8_t>(D, a, units, s)
                      : mma_by_d<__half, __half>(D, a, units, s));
    return (int)(q8 ? mma_by_d<__nv_bfloat16, int8_t>(D, a, units, s)
                    : mma_by_d<__nv_bfloat16, __nv_bfloat16>(D, a, units, s));
  }
  bool ok;
  switch (q_dtype) {
    case 0: ok = fma_by_kv<float>(kv_dtype, D, q, k_pool, v_pool, block_tables, base, scales, out, B, T, H, KV, P, page, n, sm_scale, s); break;
    case 1: ok = fma_by_kv<__half>(kv_dtype, D, q, k_pool, v_pool, block_tables, base, scales, out, B, T, H, KV, P, page, n, sm_scale, s); break;
    case 2: ok = fma_by_kv<__nv_bfloat16>(kv_dtype, D, q, k_pool, v_pool, block_tables, base, scales, out, B, T, H, KV, P, page, n, sm_scale, s); break;
    default: ok = false;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
