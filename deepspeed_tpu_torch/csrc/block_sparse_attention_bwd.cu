// Block-sparse attention backward for Hopper (sm_90a): the dq and the
// dk/dv kernels.
//
// Replaces the Pallas kernels deepspeed_tpu/ops/pallas/block_sparse_attention.py
// _bwd_dq_kernel (:104, pallas_call :208) and _bwd_dkv_kernel (:131,
// pallas_call :226), entry _bwd (:199): the gradients of the block-sparse
// forward given its lse and delta = rowsum(dO * O) (a torch op outside the
// kernels, as the JAX entry computes it at :201), with p recomputed as
// exp(s - lse) inside the visited blocks (0 where the causal rule masks),
// ds = p * (dp - delta), dq and dk scaled by sm_scale once at the end. A
// row the forward poisoned (lse = +1e30, o = 0, delta = 0) gives p = 0 and
// so no contribution.
//
//  - dq: a unit of query rows of one (batch, head, query block) walks the
//    key blocks of its kidx row (as the forward does): s = q k^T, dp =
//    dO v^T, dq += ds k.
//  - dk/dv: a unit of key rows of one (batch, head, key block) walks the
//    query blocks of its row of the transposed lists qidx: s^T = k q^T,
//    dv += p^T dO, dp^T = v dO^T, dk += ds^T q.
// Both are deterministic and use no atomics: every output row is written by
// the one unit that owns it (that is why the JAX package builds qidx).
//
// What bounds them on the card: their flops. dq does 3 products per visited
// (query, key) pair and dk/dv 4, against the 5 the backward needs (s and dp
// are recomputed in both): at the GPT-2 shape (B2 S4096 H16 D64 bf16,
// 10240 of 65536 blocks) ~31 and ~41 GFLOP, 0.031 and 0.041 ms at 989
// TFLOP/s, above the 0.025 and 0.030 ms their ~84 and ~102 MB of operands
// take at 3.35 TB/s. At the BERT shape (B16 S512 H16, block 16) the bytes
// bound them (0.025 and 0.030 ms against 0.009 and 0.012 ms of flops).
// bf16/fp16 run every product on the tensor cores (mma.sync m16n8k16, f32
// accumulate): units of R = min(blk, 64) rows, a warp per 16 rows (dk/dv at
// D128: two warps per 16 keys, each owning 64 of the output columns so the
// accumulators fit in registers), the streamed operand double-buffered
// through cp.async as tiles of R rows, fragments by ldmatrix, p and ds
// rounded to the storage dtype and fed to the next product from registers,
// p by exp2 in log2 units, the causal test only in tiles that straddle the
// diagonal (tiles wholly masked are skipped), and 4 or 2 units packed into a
// thread block for blocks of 16 and 32, each on its own named barrier.
// fp32 runs the same walks on the FMA pipes (lane j owns row j of a chunk
// of min(blk, 32) streamed rows). What they do not do yet: wgmma, TMA, one
// shared recompute of s and dp for dq and dk/dv.

#include "block_sparse_attention_common.cuh"

namespace {

using namespace bsparse;

// ---- dq (bf16 / fp16) -----------------------------------------------------

template <typename T, int D, int TW>
struct DqCfg {
  static constexpr int R = TW;
  static constexpr int UW = R / 16;
  static constexpr int G = UW >= 4 ? 1 : 4 / UW;
  static constexpr int UT = UW * 32;
  static constexpr int NT = G * UT;
  static constexpr int LD = D + 8;
  static constexpr int USMEM = (2 * R + 4 * TW) * LD;  // Q, dO, two K and two V tiles
  static constexpr size_t SMEM = (size_t)G * USMEM * sizeof(T);
};

template <typename T, int D, int TW>
__global__ void __launch_bounds__(DqCfg<T, D, TW>::NT)
bs_dq_mma(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, const BsParams p) {
  using C = DqCfg<T, D, TW>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int unit = threadIdx.x / C::UT;
  const int ut = threadIdx.x % C::UT, lane = ut & 31, warp = ut >> 5;
  const int g = lane >> 2, t = lane & 3;
  Unit U;
  if (!unit_of((long long)blockIdx.x * C::G + unit, C::R, p, U)) return;
  T* Qs = reinterpret_cast<T*>(smem_raw) + unit * C::USMEM;
  T* Os = Qs + C::R * C::LD;      // dO
  T* Ks = Os + C::R * C::LD;      // two buffers of TW rows
  T* Vs = Ks + 2 * TW * C::LD;    // two buffers of TW rows

  const int q0 = U.row0;
  const int* lst = p.idx + ((long long)U.h * p.nblk + U.bi) * p.maxl;
  const int per = p.blk / TW;
  const int nt = query_unit_tiles(lst, p.cnt[U.h * p.nblk + U.bi], q0, C::R, p, TW);
  const T* kb = k + U.b * p.k_sb + U.h * p.k_sh;
  const T* vb = v + U.b * p.v_sb + U.h * p.v_sh;

  load_rows_async<T, C::R, D, C::LD, C::UT>(Qs, q + U.b * p.q_sb + U.h * p.q_sh, p.q_ss, q0,
                                             p.S, ut);
  load_rows_async<T, C::R, D, C::LD, C::UT>(Os, dout + U.b * p.do_sb + U.h * p.do_sh, p.do_ss,
                                             q0, p.S, ut);
  if (nt > 0) {
    const int c = tile_row0(lst, 0, per, p.blk, TW);
    load_rows_async<T, TW, D, C::LD, C::UT>(Ks, kb, p.k_ss, c, p.S, ut);
    load_rows_async<T, TW, D, C::LD, C::UT>(Vs, vb, p.v_ss, c, p.S, ut);
  }
  cp_async_commit();

  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const long long rowbase = ((long long)U.b * p.H + U.h) * p.S;
  const float scale2 = p.scale * kLog2e;
  float lrow[2], drow[2];  // lse in log2 units, delta
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lrow[i] = lse[rowbase + row[i]] * kLog2e;
    drow[i] = delta[rowbase + row[i]];
  }
  float dqa[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;

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

    // s = q k^T and dp = dO v^T for this warp's 16 rows
    float s[TW / 8][4], dp[TW / 8][4];
#pragma unroll
    for (int n = 0; n < TW / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4], ao[4];
      load_a<T, C::LD>(a, Qs, warp * 16, kk, lane);
      load_a<T, C::LD>(ao, Os, warp * 16, kk, lane);
#pragma unroll
      for (int n = 0; n < TW / 8; n += 2) {
        uint32_t bk[4], bv[4];
        load_b_rows<T, C::LD>(bk, Kt, n * 8, kk, lane);
        load_b_rows<T, C::LD>(bv, Vt, n * 8, kk, lane);
        mma16816<T>(s[n], a, bk);
        mma16816<T>(s[n + 1], a, bk + 2);
        mma16816<T>(dp[n], ao, bv);
        mma16816<T>(dp[n + 1], ao, bv + 2);
      }
    }
    // ds = p (dp - delta), p = exp(s * scale - lse) (exp2 in log2 units),
    // 0 where the causal rule masks
    const bool full = !p.causal || c0 + TW - 1 <= q0 + warp * 16;
#pragma unroll
    for (int n = 0; n < TW / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int col = c0 + n * 8 + 2 * t + (e & 1);
        const float pe = full || col <= row[i] ? exp2f(s[n][e] * scale2 - lrow[i]) : 0.f;
        s[n][e] = pe * (dp[n][e] - drow[i]);
      }
    }
    // dq += dS k
#pragma unroll
    for (int kk = 0; kk < TW / 16; ++kk) {
      uint32_t a[4];
      a_from_c<T>(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t bb[4];
        load_b_cols<T, C::LD>(bb, Kt, kk * 16, n * 8, lane);
        mma16816<T>(dqa[n], a, bb);
        mma16816<T>(dqa[n + 1], a, bb + 2);
      }
    }
    unit_sync(unit, C::UT);  // this buffer is consumed before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    T* out = dq + (((long long)U.b * p.S + row[i]) * p.H + U.h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(out + n * 8) =
          pack2<T>(dqa[n][2 * i] * p.scale, dqa[n][2 * i + 1] * p.scale);
    }
  }
}

// ---- dk, dv (bf16 / fp16) -------------------------------------------------

template <typename T, int D, int TW>
struct DkvCfg {
  static constexpr int R = TW;           // keys a unit owns
  static constexpr int DSPLIT = D / 64;  // warps sharing 16 keys, 64 output columns each
  static constexpr int RG = R / 16;      // row groups of 16 keys
  static constexpr int UW = RG * DSPLIT;
  static constexpr int G = UW >= 4 ? 1 : 4 / UW;
  static constexpr int UT = UW * 32;
  static constexpr int NT = G * UT;
  static constexpr int LD = D + 8;
  static constexpr int DC = 64;
  // K, V, two Q and two dO tiles, then lse and delta for two tiles
  static constexpr size_t USMEM = (size_t)(2 * R + 4 * TW) * LD * sizeof(T) + 4 * TW * sizeof(float);
  static constexpr size_t SMEM = G * USMEM;
};

template <typename T, int D, int TW>
__global__ void __launch_bounds__(DkvCfg<T, D, TW>::NT)
bs_dkv_mma(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
           const BsParams p) {
  using C = DkvCfg<T, D, TW>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int unit = threadIdx.x / C::UT;
  const int ut = threadIdx.x % C::UT, lane = ut & 31, warp = ut >> 5;
  const int rg = warp % C::RG, part = warp / C::RG;
  const int qg = lane >> 2, t = lane & 3;
  Unit U;
  if (!unit_of((long long)blockIdx.x * C::G + unit, C::R, p, U)) return;
  T* Ks = reinterpret_cast<T*>(smem_raw + unit * C::USMEM);
  T* Vs = Ks + C::R * C::LD;
  T* Qs = Vs + C::R * C::LD;          // two buffers of TW rows
  T* Os = Qs + 2 * TW * C::LD;        // dO, two buffers of TW rows
  float* Ls = reinterpret_cast<float*>(Os + 2 * TW * C::LD);  // lse (log2 units), two buffers
  float* Dl = Ls + 2 * TW;                                      // delta, two buffers

  const int k0 = U.row0;
  const int* lst = p.idx + ((long long)U.h * p.nblk + U.bi) * p.maxl;
  const int per = p.blk / TW;
  const int n_all = p.cnt[U.h * p.nblk + U.bi] * per;
  const int lo = key_unit_first_tile(lst, p.cnt[U.h * p.nblk + U.bi], k0, p, TW);
  const T* qb = q + U.b * p.q_sb + U.h * p.q_sh;
  const T* ob = dout + U.b * p.do_sb + U.h * p.do_sh;
  const long long rowbase = ((long long)U.b * p.H + U.h) * p.S;

  load_rows_async<T, C::R, D, C::LD, C::UT>(Ks, k + U.b * p.k_sb + U.h * p.k_sh, p.k_ss, k0,
                                             p.S, ut);
  load_rows_async<T, C::R, D, C::LD, C::UT>(Vs, v + U.b * p.v_sb + U.h * p.v_sh, p.v_ss, k0,
                                             p.S, ut);
  // stream query tile `it` of the list into buffer `buf`
  auto issue = [&](int it, int buf) {
    const int c = tile_row0(lst, it, per, p.blk, TW);
    load_rows_async<T, TW, D, C::LD, C::UT>(Qs + buf * TW * C::LD, qb, p.q_ss, c, p.S, ut);
    load_rows_async<T, TW, D, C::LD, C::UT>(Os + buf * TW * C::LD, ob, p.do_ss, c, p.S, ut);
    for (int r = ut; r < TW; r += C::UT) {
      Ls[buf * TW + r] = lse[rowbase + c + r] * kLog2e;
      Dl[buf * TW + r] = delta[rowbase + c + r];
    }
  };
  if (lo < n_all) issue(lo, 0);
  cp_async_commit();

  const int key[2] = {k0 + rg * 16 + qg, k0 + rg * 16 + qg + 8};
  const float scale2 = p.scale * kLog2e;
  float dka[C::DC / 8][4], dva[C::DC / 8][4];
#pragma unroll
  for (int n = 0; n < C::DC / 8; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }

  for (int it = lo; it < n_all; ++it) {
    const int buf = (it - lo) & 1;
    if (it + 1 < n_all) {
      issue(it + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    unit_sync(unit, C::UT);
    const T* Qt = Qs + buf * TW * C::LD;
    const T* Ot = Os + buf * TW * C::LD;
    const float* Lt = Ls + buf * TW;
    const float* Dt = Dl + buf * TW;
    const int c0 = tile_row0(lst, it, per, p.blk, TW);

    // s^T = k q^T: this warp's 16 keys x the tile's TW queries
    float st[TW / 8][4];
#pragma unroll
    for (int n = 0; n < TW / 8; ++n) st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4];
      load_a<T, C::LD>(a, Ks, rg * 16, kk, lane);
#pragma unroll
      for (int n = 0; n < TW / 8; n += 2) {
        uint32_t bb[4];
        load_b_rows<T, C::LD>(bb, Qt, n * 8, kk, lane);
        mma16816<T>(st[n], a, bb);
        mma16816<T>(st[n + 1], a, bb + 2);
      }
    }
    // p^T = exp(s^T * scale - lse[query]) (exp2 in log2 units), 0 where the
    // causal rule masks (query < key)
    const bool full = !p.causal || c0 >= k0 + rg * 16 + 15;
#pragma unroll
    for (int n = 0; n < TW / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = n * 8 + 2 * t + (e & 1);
        st[n][e] = full || c0 + ql >= key[e >> 1] ? exp2f(st[n][e] * scale2 - Lt[ql]) : 0.f;
      }
    }
    // dv += P^T dO
#pragma unroll
    for (int kk = 0; kk < TW / 16; ++kk) {
      uint32_t a[4];
      a_from_c<T>(a, st[2 * kk], st[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < C::DC / 8; n += 2) {
        uint32_t bb[4];
        load_b_cols<T, C::LD>(bb, Ot, kk * 16, part * C::DC + n * 8, lane);
        mma16816<T>(dva[n], a, bb);
        mma16816<T>(dva[n + 1], a, bb + 2);
      }
    }
    // dp^T = v dO^T
    float dpt[TW / 8][4];
#pragma unroll
    for (int n = 0; n < TW / 8; ++n) dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4];
      load_a<T, C::LD>(a, Vs, rg * 16, kk, lane);
#pragma unroll
      for (int n = 0; n < TW / 8; n += 2) {
        uint32_t bb[4];
        load_b_rows<T, C::LD>(bb, Ot, n * 8, kk, lane);
        mma16816<T>(dpt[n], a, bb);
        mma16816<T>(dpt[n + 1], a, bb + 2);
      }
    }
    // ds^T = p^T (dp^T - delta[query])
#pragma unroll
    for (int n = 0; n < TW / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] *= dpt[n][e] - Dt[n * 8 + 2 * t + (e & 1)];
    }
    // dk += dS^T q
#pragma unroll
    for (int kk = 0; kk < TW / 16; ++kk) {
      uint32_t a[4];
      a_from_c<T>(a, st[2 * kk], st[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < C::DC / 8; n += 2) {
        uint32_t bb[4];
        load_b_cols<T, C::LD>(bb, Qt, kk * 16, part * C::DC + n * 8, lane);
        mma16816<T>(dka[n], a, bb);
        mma16816<T>(dka[n + 1], a, bb + 2);
      }
    }
    unit_sync(unit, C::UT);  // this buffer is consumed before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long off = (((long long)U.b * p.S + key[i]) * p.H + U.h) * D + part * C::DC + 2 * t;
#pragma unroll
    for (int n = 0; n < C::DC / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + n * 8) =
          pack2<T>(dka[n][2 * i] * p.scale, dka[n][2 * i + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dv + off + n * 8) = pack2<T>(dva[n][2 * i], dva[n][2 * i + 1]);
    }
  }
}

// ---- fp32: FMA pipes -------------------------------------------------------

template <int D, int NK>
struct Bwd32 {
  static constexpr int RW = 8;       // rows a warp owns
  static constexpr int R = NK;       // rows a unit owns
  static constexpr int UW = R / RW;
  static constexpr int G = 4 / UW;
  static constexpr int UT = UW * 32;
  static constexpr int NT = G * UT;
  static constexpr int LD = D + 1;
  // the unit's rows (two operands), a chunk of NK streamed rows (two
  // operands), and (dk/dv) the chunk's lse and delta
  static constexpr int USMEM = 2 * R * D + 2 * NK * LD + 2 * NK;
  static constexpr size_t SMEM = (size_t)G * USMEM * sizeof(float);
};

template <int D, int NK>
__global__ void __launch_bounds__(Bwd32<D, NK>::NT)
bs_dq_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          const float* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, float* __restrict__ dq, const BsParams p) {
  using C = Bwd32<D, NK>;
  constexpr int E = D / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int unit = threadIdx.x / C::UT;
  const int ut = threadIdx.x % C::UT, lane = ut & 31, warp = ut >> 5;
  Unit U;
  if (!unit_of((long long)blockIdx.x * C::G + unit, C::R, p, U)) return;
  float* Qs = reinterpret_cast<float*>(smem_raw) + unit * C::USMEM;  // the unit's queries
  float* Os = Qs + C::R * D;                                          // their dO
  float* Ks = Os + C::R * D;                                          // key chunk
  float* Vs = Ks + NK * C::LD;

  const int q0 = U.row0;
  const int* lst = p.idx + ((long long)U.h * p.nblk + U.bi) * p.maxl;
  const int per = p.blk / NK;
  const int nt = query_unit_tiles(lst, p.cnt[U.h * p.nblk + U.bi], q0, C::R, p, NK);
  const float* kb = k + U.b * p.k_sb + U.h * p.k_sh;
  const float* vb = v + U.b * p.v_sb + U.h * p.v_sh;
  load_rows_f32<C::R, D, D, C::UT>(Qs, q + U.b * p.q_sb + U.h * p.q_sh, p.q_ss, q0, p.S, ut);
  load_rows_f32<C::R, D, D, C::UT>(Os, dout + U.b * p.do_sb + U.h * p.do_sh, p.do_ss, q0, p.S,
                                   ut);

  const long long rowbase = ((long long)U.b * p.H + U.h) * p.S;
  float lrow[C::RW], drow[C::RW], dqa[C::RW][E];
#pragma unroll
  for (int i = 0; i < C::RW; ++i) {
    const int r = q0 + warp * C::RW + i;
    lrow[i] = lse[rowbase + r];
    drow[i] = delta[rowbase + r];
#pragma unroll
    for (int e = 0; e < E; ++e) dqa[i][e] = 0.f;
  }
  const float* qw = Qs + warp * C::RW * D;
  const float* ow = Os + warp * C::RW * D;
  const int kr = lane < NK ? lane : 0;

  for (int it = 0; it < nt; ++it) {
    const int c0 = tile_row0(lst, it, per, p.blk, NK);
    unit_sync(unit, C::UT);
    load_rows_f32<NK, D, C::LD, C::UT>(Ks, kb, p.k_ss, c0, p.S, ut);
    load_rows_f32<NK, D, C::LD, C::UT>(Vs, vb, p.v_ss, c0, p.S, ut);
    unit_sync(unit, C::UT);
    // lane owns key c0 + lane
    float sc[C::RW], dp[C::RW];
#pragma unroll
    for (int i = 0; i < C::RW; ++i) sc[i] = dp[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kk = Ks[kr * C::LD + d];
      const float vv = Vs[kr * C::LD + d];
#pragma unroll
      for (int i = 0; i < C::RW; ++i) {
        sc[i] = fmaf(qw[i * D + d], kk, sc[i]);
        dp[i] = fmaf(ow[i * D + d], vv, dp[i]);
      }
    }
    const int key = c0 + lane;
    float ds[C::RW];
#pragma unroll
    for (int i = 0; i < C::RW; ++i) {
      const int r = q0 + warp * C::RW + i;
      const bool kept = lane < NK && (!p.causal || key <= r);
      const float pe = kept ? expf(sc[i] * p.scale - lrow[i]) : 0.f;
      ds[i] = pe * (dp[i] - drow[i]);
    }
#pragma unroll 4
    for (int jj = 0; jj < NK; ++jj) {
      float kv[E];
#pragma unroll
      for (int e = 0; e < E; ++e) kv[e] = Ks[jj * C::LD + lane + 32 * e];
#pragma unroll
      for (int i = 0; i < C::RW; ++i) {
        const float dsj = __shfl_sync(0xffffffffu, ds[i], jj);
#pragma unroll
        for (int e = 0; e < E; ++e) dqa[i][e] = fmaf(dsj, kv[e], dqa[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < C::RW; ++i) {
    const int r = q0 + warp * C::RW + i;
    float* out = dq + (((long long)U.b * p.S + r) * p.H + U.h) * D;
#pragma unroll
    for (int e = 0; e < E; ++e) out[lane + 32 * e] = dqa[i][e] * p.scale;
  }
}

template <int D, int NK>
__global__ void __launch_bounds__(Bwd32<D, NK>::NT)
bs_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dk, float* __restrict__ dv, const BsParams p) {
  using C = Bwd32<D, NK>;
  constexpr int E = D / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int unit = threadIdx.x / C::UT;
  const int ut = threadIdx.x % C::UT, lane = ut & 31, warp = ut >> 5;
  Unit U;
  if (!unit_of((long long)blockIdx.x * C::G + unit, C::R, p, U)) return;
  float* Ks = reinterpret_cast<float*>(smem_raw) + unit * C::USMEM;  // the unit's keys
  float* Vs = Ks + C::R * D;
  float* Qs = Vs + C::R * D;   // query chunk
  float* Os = Qs + NK * C::LD; // its dO
  float* Ls = Os + NK * C::LD;
  float* Dl = Ls + NK;

  const int k0 = U.row0;
  const int* lst = p.idx + ((long long)U.h * p.nblk + U.bi) * p.maxl;
  const int per = p.blk / NK;
  const int n_all = p.cnt[U.h * p.nblk + U.bi] * per;
  const int lo = key_unit_first_tile(lst, p.cnt[U.h * p.nblk + U.bi], k0, p, NK);
  const float* qb = q + U.b * p.q_sb + U.h * p.q_sh;
  const float* ob = dout + U.b * p.do_sb + U.h * p.do_sh;
  const long long rowbase = ((long long)U.b * p.H + U.h) * p.S;
  load_rows_f32<C::R, D, D, C::UT>(Ks, k + U.b * p.k_sb + U.h * p.k_sh, p.k_ss, k0, p.S, ut);
  load_rows_f32<C::R, D, D, C::UT>(Vs, v + U.b * p.v_sb + U.h * p.v_sh, p.v_ss, k0, p.S, ut);

  float dka[C::RW][E], dva[C::RW][E];
#pragma unroll
  for (int i = 0; i < C::RW; ++i) {
#pragma unroll
    for (int e = 0; e < E; ++e) dka[i][e] = dva[i][e] = 0.f;
  }
  const float* kw = Ks + warp * C::RW * D;
  const float* vw = Vs + warp * C::RW * D;
  const int qr = lane < NK ? lane : 0;

  for (int it = lo; it < n_all; ++it) {
    const int c0 = tile_row0(lst, it, per, p.blk, NK);
    unit_sync(unit, C::UT);
    load_rows_f32<NK, D, C::LD, C::UT>(Qs, qb, p.q_ss, c0, p.S, ut);
    load_rows_f32<NK, D, C::LD, C::UT>(Os, ob, p.do_ss, c0, p.S, ut);
    for (int r = ut; r < NK; r += C::UT) {
      Ls[r] = lse[rowbase + c0 + r];
      Dl[r] = delta[rowbase + c0 + r];
    }
    unit_sync(unit, C::UT);
    // lane owns query c0 + lane: s and dp for each of the warp's keys
    float sc[C::RW], dp[C::RW];
#pragma unroll
    for (int i = 0; i < C::RW; ++i) sc[i] = dp[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qq = Qs[qr * C::LD + d];
      const float oo = Os[qr * C::LD + d];
#pragma unroll
      for (int i = 0; i < C::RW; ++i) {
        sc[i] = fmaf(kw[i * D + d], qq, sc[i]);
        dp[i] = fmaf(vw[i * D + d], oo, dp[i]);
      }
    }
    const int qi = c0 + lane;
    float pr[C::RW], ds[C::RW];
#pragma unroll
    for (int i = 0; i < C::RW; ++i) {
      const int key = k0 + warp * C::RW + i;
      const bool kept = lane < NK && (!p.causal || qi >= key);
      pr[i] = kept ? expf(sc[i] * p.scale - Ls[qr]) : 0.f;
      ds[i] = pr[i] * (dp[i] - Dl[qr]);
    }
#pragma unroll 4
    for (int jj = 0; jj < NK; ++jj) {
      float qv[E], ov[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        qv[e] = Qs[jj * C::LD + lane + 32 * e];
        ov[e] = Os[jj * C::LD + lane + 32 * e];
      }
#pragma unroll
      for (int i = 0; i < C::RW; ++i) {
        const float pj = __shfl_sync(0xffffffffu, pr[i], jj);
        const float dsj = __shfl_sync(0xffffffffu, ds[i], jj);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          dva[i][e] = fmaf(pj, ov[e], dva[i][e]);
          dka[i][e] = fmaf(dsj, qv[e], dka[i][e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < C::RW; ++i) {
    const int key = k0 + warp * C::RW + i;
    const long long off = (((long long)U.b * p.S + key) * p.H + U.h) * D;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      dk[off + lane + 32 * e] = dka[i][e] * p.scale;
      dv[off + lane + 32 * e] = dva[i][e];
    }
  }
}

// ---- launches ---------------------------------------------------------------

struct Ptrs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
};

template <typename T, int D, int TW>
cudaError_t launch_dq_mma(const Ptrs& a, const BsParams& p, cudaStream_t s) {
  using C = DqCfg<T, D, TW>;
  auto kern = bs_dq_mma<T, D, TW>;
  cudaError_t err = allow_smem(kern, C::SMEM);
  if (err != cudaSuccess) return err;
  kern<<<(unsigned)((units(p, C::R) + C::G - 1) / C::G), C::NT, C::SMEM, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dq), p);
  return cudaGetLastError();
}

template <typename T, int D, int TW>
cudaError_t launch_dkv_mma(const Ptrs& a, const BsParams& p, cudaStream_t s) {
  using C = DkvCfg<T, D, TW>;
  auto kern = bs_dkv_mma<T, D, TW>;
  cudaError_t err = allow_smem(kern, C::SMEM);
  if (err != cudaSuccess) return err;
  kern<<<(unsigned)((units(p, C::R) + C::G - 1) / C::G), C::NT, C::SMEM, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), p);
  return cudaGetLastError();
}

template <int D, int NK>
cudaError_t launch_dq_f32(const Ptrs& a, const BsParams& p, cudaStream_t s) {
  using C = Bwd32<D, NK>;
  auto kern = bs_dq_f32<D, NK>;
  cudaError_t err = allow_smem(kern, C::SMEM);
  if (err != cudaSuccess) return err;
  kern<<<(unsigned)((units(p, C::R) + C::G - 1) / C::G), C::NT, C::SMEM, s>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      static_cast<float*>(a.dq), p);
  return cudaGetLastError();
}

template <int D, int NK>
cudaError_t launch_dkv_f32(const Ptrs& a, const BsParams& p, cudaStream_t s) {
  using C = Bwd32<D, NK>;
  auto kern = bs_dkv_f32<D, NK>;
  cudaError_t err = allow_smem(kern, C::SMEM);
  if (err != cudaSuccess) return err;
  kern<<<(unsigned)((units(p, C::R) + C::G - 1) / C::G), C::NT, C::SMEM, s>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), p);
  return cudaGetLastError();
}

// which = 0: dq, 1: dk/dv
template <typename T, int D>
cudaError_t by_block(int which, const Ptrs& a, const BsParams& p, cudaStream_t s) {
  switch (p.blk) {
    case 16: return which ? launch_dkv_mma<T, D, 16>(a, p, s) : launch_dq_mma<T, D, 16>(a, p, s);
    case 32: return which ? launch_dkv_mma<T, D, 32>(a, p, s) : launch_dq_mma<T, D, 32>(a, p, s);
    default: return which ? launch_dkv_mma<T, D, 64>(a, p, s) : launch_dq_mma<T, D, 64>(a, p, s);
  }
}

template <int D>
cudaError_t dispatch_dtype(int which, int dtype, const Ptrs& a, const BsParams& p,
                           cudaStream_t s) {
  switch (dtype) {
    case 0:
      if (p.blk == 16) return which ? launch_dkv_f32<D, 16>(a, p, s) : launch_dq_f32<D, 16>(a, p, s);
      return which ? launch_dkv_f32<D, 32>(a, p, s) : launch_dq_f32<D, 32>(a, p, s);
    case 1: return by_block<__half, D>(which, a, p, s);
    case 2: return by_block<__nv_bfloat16, D>(which, a, p, s);
    default: return cudaErrorInvalidValue;
  }
}

int run(int which, const Ptrs& a, int B, int S, int H, int D, int blk, int maxl, const int* idx,
        const int* cnt, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
        long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
        long long do_sb, long long do_ss, long long do_sh, int causal, float sm_scale,
        int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || maxl <= 0) return (int)cudaErrorInvalidValue;
  if ((blk != 16 && blk != 32 && blk != 64 && blk != 128) || S % blk != 0)
    return (int)cudaErrorInvalidValue;
  BsParams p{};
  p.B = B; p.S = S; p.H = H; p.blk = blk; p.nblk = S / blk; p.maxl = maxl;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.do_sb = do_sb; p.do_ss = do_ss; p.do_sh = do_sh;
  p.idx = idx;
  p.cnt = cnt;
  p.causal = causal;
  p.scale = sm_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)dispatch_dtype<64>(which, dtype, a, p, s);
    case 128: return (int)dispatch_dtype<128>(which, dtype, a, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 float32, 1 float16, 2 bfloat16 (every tensor operand but
// lse and delta shares it). q/k/v/dO strided as documented in the common
// header; lse and delta [B, H, S] f32 contiguous; dq, dk, dv [B, S, H, D]
// contiguous. The lists: kidx [H, S/blk, maxK] / kcnt for dq, qidx [H,
// S/blk, maxQ] / qcnt for dk/dv, int32. Each returns the CUDA error of its
// launch (0 on success), cudaErrorInvalidValue for shapes the kernels do
// not take. Asynchronous on `stream`.
extern "C" int block_sparse_attention_dq_launch(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dq, const void* kidx, const void* kcnt, int B, int S, int H, int D,
    int blk, int maxK, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long do_sb, long long do_ss, long long do_sh, int causal, float sm_scale, int dtype,
    void* stream) {
  Ptrs a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
         dq, nullptr, nullptr};
  return run(0, a, B, S, H, D, blk, maxK, static_cast<const int*>(kidx),
             static_cast<const int*>(kcnt), q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
             do_sb, do_ss, do_sh, causal, sm_scale, dtype, stream);
}

extern "C" int block_sparse_attention_dkv_launch(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dk, void* dv, const void* qidx, const void* qcnt, int B, int S,
    int H, int D, int blk, int maxQ, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long do_sb, long long do_ss, long long do_sh, int causal,
    float sm_scale, int dtype, void* stream) {
  Ptrs a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
         nullptr, dk, dv};
  return run(1, a, B, S, H, D, blk, maxQ, static_cast<const int*>(qidx),
             static_cast<const int*>(qcnt), q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
             do_sb, do_ss, do_sh, causal, sm_scale, dtype, stream);
}
