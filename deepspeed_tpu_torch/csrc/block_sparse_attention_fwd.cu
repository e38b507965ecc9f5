// Block-sparse attention forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel deepspeed_tpu/ops/pallas/block_sparse_attention.py
// _fwd_kernel (:63, pallas_call :176, entry _fwd :172): flash attention over
// the key blocks that each query block's row of kidx lists, o [B, S, H, D]
// in q's dtype plus the per-row log-sum-exp lse [B, H, S] f32. Inside a
// visited block the causal rule masks key j > query i with -1e30. A query
// row whose every visited score is masked (a custom layout that only lists
// blocks above the diagonal, or an empty list) gets o = 0 and lse = +1e30:
// the JAX kernel's poison values (:93-100), which make the backward give 0
// for that row.
//
// What bounds it on the card: its flops. At the GPT-2 shape (B2 S4096 H16
// D64 bf16, the fixed unidirectional layout of block 64: 10240 of 65536
// blocks active) the two products of the visited pairs are ~21 GFLOP
// against ~34 MB of q/k/v/o/lse: 0.022 ms at 989 TFLOP/s against 0.010 ms
// at 3.35 TB/s. At the BERT shape (B16 S512 H16 D64 bf16, fixed
// bidirectional, block 16, density 0.344) it is bound by bytes instead:
// ~5.9 GFLOP (0.006 ms) against ~68 MB (0.020 ms).
//
// What this design does about it:
//  - bf16/fp16: both products on the tensor cores (mma.sync m16n8k16, f32
//    accumulate). A unit of R = min(blk, 64) query rows of one (batch,
//    head, query block), one warp per 16 rows, loads its own kidx row (the
//    TPU delivered it by scalar prefetch) and streams the listed key blocks
//    as tiles of R keys through a double-buffered cp.async ring, so the next
//    tile's copy overlaps this tile's products; m, l and the accumulator
//    stay in registers, P is rounded to the storage dtype and fed to P·V
//    from registers, the softmax runs in log2 units on exp2, and the causal
//    test runs only in tiles that straddle the diagonal (tiles wholly past
//    it are skipped: they add p = 0). Blocks of 16 and 32 pack 4 and 2 units
//    into one thread block (4 warps), each unit on its own named barrier.
//    The TPU carried m/l/acc over a sequential grid axis and used the
//    sparsity block as its MXU tile; here the loop over the list is inside
//    the unit and the tile is at most 64 keys.
//  - fp32: the same walk on the FMA pipes (no tensor-core path keeps fp32
//    exact): units of min(blk, 32) rows, 8 a warp, lane j owning key j of a
//    chunk of min(blk, 32) keys for the scores and D/32 output columns for
//    the sum.
// What it does not do yet: wgmma, TMA, warp specialisation, a persistent
// schedule ordered by list length.

#include "block_sparse_attention_common.cuh"

namespace {

using namespace bsparse;

template <typename T, int D, int TW>
struct FwdCfg {
  static constexpr int R = TW;                   // query rows a unit owns
  static constexpr int UW = R / 16;              // warps a unit
  static constexpr int G = UW >= 4 ? 1 : 4 / UW;  // units a block
  static constexpr int UT = UW * 32;
  static constexpr int NT = G * UT;
  static constexpr int LD = D + 8;  // padded row: the fragment reads hit distinct banks
  static constexpr int USMEM = (R + 4 * TW) * LD;  // elements: Q, two K and two V tiles
  static constexpr size_t SMEM = (size_t)G * USMEM * sizeof(T);
};

template <typename T, int D, int TW>
__global__ void __launch_bounds__(FwdCfg<T, D, TW>::NT)
bs_fwd_mma(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ o, float* __restrict__ lse, const BsParams p) {
  using C = FwdCfg<T, D, TW>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int unit = threadIdx.x / C::UT;
  const int ut = threadIdx.x % C::UT, lane = ut & 31, warp = ut >> 5;
  const int g = lane >> 2, t = lane & 3;
  Unit U;
  if (!unit_of((long long)blockIdx.x * C::G + unit, C::R, p, U)) return;
  T* Qs = reinterpret_cast<T*>(smem_raw) + unit * C::USMEM;
  T* Ks = Qs + C::R * C::LD;       // two buffers of TW rows
  T* Vs = Ks + 2 * TW * C::LD;     // two buffers of TW rows

  const int q0 = U.row0;
  const int* lst = p.idx + ((long long)U.h * p.nblk + U.bi) * p.maxl;
  const int per = p.blk / TW;
  const int nt = query_unit_tiles(lst, p.cnt[U.h * p.nblk + U.bi], q0, C::R, p, TW);
  const T* kb = k + U.b * p.k_sb + U.h * p.k_sh;
  const T* vb = v + U.b * p.v_sb + U.h * p.v_sh;

  load_rows_async<T, C::R, D, C::LD, C::UT>(Qs, q + U.b * p.q_sb + U.h * p.q_sh, p.q_ss, q0,
                                             p.S, ut);
  if (nt > 0) {
    const int c = tile_row0(lst, 0, per, p.blk, TW);
    load_rows_async<T, TW, D, C::LD, C::UT>(Ks, kb, p.k_ss, c, p.S, ut);
    load_rows_async<T, TW, D, C::LD, C::UT>(Vs, vb, p.v_ss, c, p.S, ut);
  }
  cp_async_commit();

  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  // scores and the running max m in log2 units: exp2 is one SFU op
  const float scale2 = p.scale * kLog2e;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < nt; ++it) {
    const int buf = it & 1;
    if (it + 1 < nt) {
      const int c = tile_row0(lst, it + 1, per, p.blk, TW);
      load_rows_async<T, TW, D, C::LD, C::UT>(Ks + (buf ^ 1) * TW * C::LD, kb, p.k_ss, c, p.S,
                                               ut);
      load_rows_async<T, TW, D, C::LD, C::UT>(Vs + (buf ^ 1) * TW * C::LD, vb, p.v_ss, c, p.S,
                                               ut);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    unit_sync(unit, C::UT);
    const T* Kt = Ks + buf * TW * C::LD;
    const T* Vt = Vs + buf * TW * C::LD;
    const int c0 = tile_row0(lst, it, per, p.blk, TW);

    // s = q k^T for this warp's 16 rows and the tile's TW keys
    float s[TW / 8][4];
#pragma unroll
    for (int n = 0; n < TW / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4];
      load_a<T, C::LD>(a, Qs, warp * 16, kk, lane);
#pragma unroll
      for (int n = 0; n < TW / 8; n += 2) {
        uint32_t bb[4];
        load_b_rows<T, C::LD>(bb, Kt, n * 8, kk, lane);
        mma16816<T>(s[n], a, bb);
        mma16816<T>(s[n + 1], a, bb + 2);
      }
    }

    // scale (to log2 units), the causal mask inside a diagonal tile, online
    // softmax over rows row[0], row[1]
    const bool full = !p.causal || c0 + TW - 1 <= q0 + warp * 16;
    float tmax[2] = {kMasked, kMasked};
#pragma unroll
    for (int n = 0; n < TW / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + n * 8 + 2 * t + (e & 1);
        const float x = full || col <= row[e >> 1] ? s[n][e] * scale2 : kMasked;
        s[n][e] = x;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
      }
    }
    float corr[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mn = fmaxf(m[i], quad_max(tmax[i]));
      corr[i] = exp2f(m[i] - mn);
      m[i] = mn;
    }
#pragma unroll
    for (int n = 0; n < TW / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[n][e] - m[e >> 1]);
        s[n][e] = pe;
        rsum[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + quad_sum(rsum[i]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // acc += P v, P rounded to the storage dtype
#pragma unroll
    for (int kk = 0; kk < TW / 16; ++kk) {
      uint32_t a[4];
      a_from_c<T>(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t bb[4];
        load_b_cols<T, C::LD>(bb, Vt, kk * 16, n * 8, lane);
        mma16816<T>(acc[n], a, bb);
        mma16816<T>(acc[n + 1], a, bb + 2);
      }
    }
    unit_sync(unit, C::UT);  // this buffer is consumed before it is refilled
  }
  cp_async_wait<0>();

  // a row that saw no kept score: o = 0, lse = +1e30 (the JAX kernel's poison)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool valid = m[i] > kMasked * 0.5f;
    const float lc = fmaxf(l[i], 1e-30f);
    if (t == 0) {
      lse[((long long)U.b * p.H + U.h) * p.S + row[i]] =
          valid ? m[i] * kLn2 + logf(lc) : -kMasked;
    }
    const float inv = valid ? 1.f / lc : 0.f;
    T* orow = o + (((long long)U.b * p.S + row[i]) * p.H + U.h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack2<T>(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    }
  }
}

// ---- fp32: FMA pipes -------------------------------------------------------

template <int D, int NK>
struct FwdCfg32 {
  static constexpr int QW = 8;       // query rows a warp owns
  static constexpr int R = NK;       // query rows a unit owns
  static constexpr int UW = R / QW;  // warps a unit
  static constexpr int G = 4 / UW;   // units a block
  static constexpr int UT = UW * 32;
  static constexpr int NT = G * UT;
  static constexpr int KLD = D + 1;
  static constexpr int USMEM = R * D + 2 * NK * KLD;  // floats: Q, a K and a V chunk
  static constexpr size_t SMEM = (size_t)G * USMEM * sizeof(float);
};

template <int D, int NK>
__global__ void __launch_bounds__(FwdCfg32<D, NK>::NT)
bs_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
           const BsParams p) {
  using C = FwdCfg32<D, NK>;
  constexpr int E = D / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int unit = threadIdx.x / C::UT;
  const int ut = threadIdx.x % C::UT, lane = ut & 31, warp = ut >> 5;
  Unit U;
  if (!unit_of((long long)blockIdx.x * C::G + unit, C::R, p, U)) return;
  float* Qs = reinterpret_cast<float*>(smem_raw) + unit * C::USMEM;
  float* Ks = Qs + C::R * D;
  float* Vs = Ks + NK * C::KLD;

  const int q0 = U.row0;
  const int* lst = p.idx + ((long long)U.h * p.nblk + U.bi) * p.maxl;
  const int per = p.blk / NK;
  const int nt = query_unit_tiles(lst, p.cnt[U.h * p.nblk + U.bi], q0, C::R, p, NK);
  const float* kb = k + U.b * p.k_sb + U.h * p.k_sh;
  const float* vb = v + U.b * p.v_sb + U.h * p.v_sh;
  load_rows_f32<C::R, D, D, C::UT>(Qs, q + U.b * p.q_sb + U.h * p.q_sh, p.q_ss, q0, p.S, ut);

  float m[C::QW], l[C::QW], acc[C::QW][E];
#pragma unroll
  for (int i = 0; i < C::QW; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
  }
  const float* qw = Qs + warp * C::QW * D;
  const int kr = lane < NK ? lane : 0;  // lanes past the chunk read row 0 and are masked

  for (int it = 0; it < nt; ++it) {
    const int c0 = tile_row0(lst, it, per, p.blk, NK);
    unit_sync(unit, C::UT);
    load_rows_f32<NK, D, C::KLD, C::UT>(Ks, kb, p.k_ss, c0, p.S, ut);
    load_rows_f32<NK, D, C::KLD, C::UT>(Vs, vb, p.v_ss, c0, p.S, ut);
    unit_sync(unit, C::UT);
    float sc[C::QW];
#pragma unroll
    for (int i = 0; i < C::QW; ++i) sc[i] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kk = Ks[kr * C::KLD + d];
#pragma unroll
      for (int i = 0; i < C::QW; ++i) sc[i] = fmaf(qw[i * D + d], kk, sc[i]);
    }
    const int key = c0 + lane;
    float pr[C::QW];
#pragma unroll
    for (int i = 0; i < C::QW; ++i) {
      const int r = q0 + warp * C::QW + i;
      const bool kept = lane < NK && (!p.causal || key <= r);
      const float x = kept ? sc[i] * p.scale : kMasked;
      const float mn = fmaxf(m[i], warp_max(x));
      const float corr = expf(m[i] - mn);
      pr[i] = expf(x - mn);
      l[i] = l[i] * corr + warp_sum(pr[i]);
      m[i] = mn;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] *= corr;
    }
#pragma unroll 4
    for (int jj = 0; jj < NK; ++jj) {
      float vv[E];
#pragma unroll
      for (int e = 0; e < E; ++e) vv[e] = Vs[jj * C::KLD + lane + 32 * e];
#pragma unroll
      for (int i = 0; i < C::QW; ++i) {
        const float pj = __shfl_sync(0xffffffffu, pr[i], jj);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[i][e] = fmaf(pj, vv[e], acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < C::QW; ++i) {
    const int r = q0 + warp * C::QW + i;
    const bool valid = m[i] > kMasked * 0.5f;
    const float lc = fmaxf(l[i], 1e-30f);
    const float inv = valid ? 1.f / lc : 0.f;
    float* orow = o + (((long long)U.b * p.S + r) * p.H + U.h) * D;
#pragma unroll
    for (int e = 0; e < E; ++e) orow[lane + 32 * e] = acc[i][e] * inv;
    if (lane == 0)
      lse[((long long)U.b * p.H + U.h) * p.S + r] = valid ? m[i] + logf(lc) : -kMasked;
  }
}

template <typename T, int D, int TW>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, float* lse,
                       const BsParams& p, cudaStream_t stream) {
  using C = FwdCfg<T, D, TW>;
  auto kern = bs_fwd_mma<T, D, TW>;
  cudaError_t err = allow_smem(kern, C::SMEM);
  if (err != cudaSuccess) return err;
  const long long blocks = (units(p, C::R) + C::G - 1) / C::G;
  kern<<<(unsigned)blocks, C::NT, C::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, p);
  return cudaGetLastError();
}

template <int D, int NK>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, float* lse,
                       const BsParams& p, cudaStream_t stream) {
  using C = FwdCfg32<D, NK>;
  auto kern = bs_fwd_f32<D, NK>;
  cudaError_t err = allow_smem(kern, C::SMEM);
  if (err != cudaSuccess) return err;
  const long long blocks = (units(p, C::R) + C::G - 1) / C::G;
  kern<<<(unsigned)blocks, C::NT, C::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t by_block(const void* q, const void* k, const void* v, void* o, float* lse,
                     const BsParams& p, cudaStream_t s) {
  switch (p.blk) {
    case 16: return launch_mma<T, D, 16>(q, k, v, o, lse, p, s);
    case 32: return launch_mma<T, D, 32>(q, k, v, o, lse, p, s);
    default: return launch_mma<T, D, 64>(q, k, v, o, lse, p, s);  // 64, 128
  }
}

template <int D>
cudaError_t dispatch_dtype(int dtype, const void* q, const void* k, const void* v, void* o,
                           float* lse, const BsParams& p, cudaStream_t s) {
  switch (dtype) {
    case 0:
      return p.blk == 16 ? launch_f32<D, 16>(q, k, v, o, lse, p, s)
                         : launch_f32<D, 32>(q, k, v, o, lse, p, s);
    case 1: return by_block<__half, D>(q, k, v, o, lse, p, s);
    case 2: return by_block<__nv_bfloat16, D>(q, k, v, o, lse, p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 float32, 1 float16, 2 bfloat16 (q, k, v and o share it).
// kidx [H, S/blk, maxK] and kcnt [H, S/blk] int32; o [B, S, H, D] and lse
// [B, H, S] f32 contiguous. Returns the CUDA error of the launch (0 on
// success), cudaErrorInvalidValue for shapes the kernel does not take
// (blk outside 16/32/64/128, S not a multiple of blk, D outside 64/128).
// Asynchronous on `stream`.
extern "C" int block_sparse_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* o, void* lse, const void* kidx,
    const void* kcnt, int B, int S, int H, int D, int blk, int maxK, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, int causal, float sm_scale, int dtype,
    void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || maxK <= 0) return (int)cudaErrorInvalidValue;
  if ((blk != 16 && blk != 32 && blk != 64 && blk != 128) || S % blk != 0)
    return (int)cudaErrorInvalidValue;
  BsParams p{};
  p.B = B; p.S = S; p.H = H; p.blk = blk; p.nblk = S / blk; p.maxl = maxK;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.idx = static_cast<const int*>(kidx);
  p.cnt = static_cast<const int*>(kcnt);
  p.causal = causal;
  p.scale = sm_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (D) {
    case 64: return (int)dispatch_dtype<64>(dtype, q, k, v, o, l, p, s);
    case 128: return (int)dispatch_dtype<128>(dtype, q, k, v, o, l, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
