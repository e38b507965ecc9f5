// Flash attention backward for Hopper (sm_90a).
//
// Replaces the Pallas kernels deepspeed_tpu/ops/pallas/flash_attention.py
// _bwd_fused_kernel (pallas_call :428, entries _bwd_fused :459 and
// _bwd_fused_bse :927), _bwd_dq_kernel / _bwd_dkv_kernel (:506 / :525,
// entry _bwd :477) and their KV-blocked grid variants (:748 / :769, entry
// _bwd_grid :738): dq, dk, dv of the forward given o, lse and dO, with P
// recomputed as exp(s - lse), delta = rowsum(dO * O), ds = p * (dp - delta),
// dq and dk scaled by sm_scale once at the end, and dk/dv summed over the
// GQA group with one rounding. The TPU needed the fused/split and
// resident/grid variants for its VMEM budget; Hopper streams every operand
// through shared memory at any length, so one entry serves all of them.
//
// One entry launches three kernels on the stream, in order:
//  1. delta = rowsum(dO * O) in f32, [B, H, S];
//  2. dk/dv: one block per (batch, kv head, tile of keys). It keeps its K/V
//     tile and the dk/dv accumulators in shared memory / registers and loops
//     over the q heads of its GQA group and over the query tiles that can see
//     the key tile (the bounds of _causal_lo :193 and _window_hi_q :207),
//     recomputing P^T and dS^T per (query tile, key tile) pair. Looping over
//     the group inside the block replaces the TPU's per-q-head f32 staging
//     (:465-471) and its summing pass;
//  3. dq: one block per (batch, head, tile of queries) walking the key tiles
//     the query tile sees (as the forward does).
// Both are deterministic: no atomics, every output written by one block.
// The cost is 7 products per (query tile, key tile) pair (dkv: K Q^T, P^T
// dO, V dO^T, dS^T Q; dq: Q K^T, dO V^T, dS K) against the fused TPU
// kernel's 5, which shared one recompute of s, p, dp and ds across dq and
// dk/dv through a whole-sequence scratch that unordered blocks cannot share.
//
// What bounds it on the card: its flops. At the training shape (B8 H16
// S1024 D64 bf16, causal) the five products the function needs are 43
// GFLOP against ~84 MB of q/k/v/o/dO/dq/dk/dv: 0.044 ms at 989 TFLOP/s.
// bf16/fp16 run every product on the tensor cores (mma.sync m16n8k16, f32
// accumulate) with 4 warps of 16 rows (more warps at D >= 128, each owning
// 64 or 128 output columns so the accumulators fit in registers), the
// streamed operand double-buffered through cp.async, fragments loaded by
// ldmatrix, p and ds rounded to the storage dtype and fed back to the next
// product from registers, p recomputed with exp2 in log2 units, and tiles
// wholly inside the mask skipping the per-element test. fp32 runs the same
// loops on the FMA pipes (lane j owns row j of a 32-row chunk).
// What it does not do yet: wgmma, TMA, sharing one recompute between dq
// and dk/dv.
//
// Ragged S: rows and keys past S are zero-filled and masked (p = 0), and
// nothing past S is written.

#include "flash_attention_common.cuh"

namespace {

using namespace flash;

// ---- delta = rowsum(dO * O) ------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(256)
flash_delta(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
            const Params p) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);  // one warp per (b, s, h)
  const int lane = threadIdx.x & 31;
  if (row >= p.B * p.S * p.H) return;
  const int h = row % p.H;
  const int s = (row / p.H) % p.S;
  const int b = row / (p.H * p.S);
  const T* orow = o + b * p.o_sb + s * p.o_ss + h * p.o_sh;
  const T* drow = dout + b * p.do_sb + s * p.do_ss + h * p.do_sh;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) acc = fmaf(to_float(drow[d]), to_float(orow[d]), acc);
  acc = warp_sum(acc);
  if (lane == 0) delta[((long long)b * p.H + h) * p.S + s] = acc;
}

// ---- dk, dv (bf16 / fp16) -------------------------------------------------

template <typename T, int D>
struct DkvCfg {
  static constexpr int DSPLIT = D / 64;              // 64 output columns a warp
  static constexpr int RG = DSPLIT == 4 ? 2 : 4;     // row groups of 16 keys
  static constexpr int NW = RG * DSPLIT;
  static constexpr int NT = NW * 32;
  static constexpr int BKK = 16 * RG;  // keys a block owns
  static constexpr int BQ = 64;        // queries per streamed tile
  static constexpr int LD = D + 8;
  static constexpr int DC = 64;
  static constexpr size_t SMEM =
      (size_t)(2 * BKK + 4 * BQ) * LD * sizeof(T) + (size_t)4 * BQ * sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(DkvCfg<T, D>::NT)
flash_bwd_dkv_mma(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                  const Params p) {
  using C = DkvCfg<T, D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + C::BKK * C::LD;
  T* Qs = Vs + C::BKK * C::LD;        // two buffers of BQ rows
  T* Os = Qs + 2 * C::BQ * C::LD;     // dO, two buffers of BQ rows
  float* Ls = reinterpret_cast<float*>(Os + 2 * C::BQ * C::LD);  // lse, two buffers
  float* Dl = Ls + 2 * C::BQ;                                    // delta, two buffers

  const int nkt = (p.S + C::BKK - 1) / C::BKK;
  const int kt = blockIdx.x % nkt;  // tile 0 sees the most queries: scheduled first
  const int bg = blockIdx.x / nkt;
  const int g = bg % p.KV;
  const int b = bg / p.KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp % C::RG, part = warp / C::RG;
  const int qg = lane >> 2, t = lane & 3;
  const int k0 = kt * C::BKK;

  const int nq = (p.S + C::BQ - 1) / C::BQ;
  int qlo = 0, qhi = nq;
  if (p.causal) {
    qlo = k0 / C::BQ;
    if (p.window > 0) qhi = min(nq, (k0 + C::BKK + p.window - 2) / C::BQ + 1);
  }
  const int ntiles = qhi - qlo;
  const int total = p.rep * ntiles;

  load_rows_async<T, C::BKK, D, C::LD, C::NT>(Ks, k + b * p.k_sb + g * p.k_sh, p.k_ss, k0, p.S,
                                               tid);
  load_rows_async<T, C::BKK, D, C::LD, C::NT>(Vs, v + b * p.v_sb + g * p.v_sh, p.v_ss, k0, p.S,
                                               tid);

  // stream (q head r, query tile i) number `it` into buffer `buf`
  auto issue = [&](int it, int buf) {
    const int h = g * p.rep + it / ntiles;
    const int q0 = (qlo + it % ntiles) * C::BQ;
    load_rows_async<T, C::BQ, D, C::LD, C::NT>(Qs + buf * C::BQ * C::LD,
                                                q + b * p.q_sb + h * p.q_sh, p.q_ss, q0, p.S, tid);
    load_rows_async<T, C::BQ, D, C::LD, C::NT>(Os + buf * C::BQ * C::LD,
                                                dout + b * p.do_sb + h * p.do_sh, p.do_ss, q0,
                                                p.S, tid);
    const long long rowbase = ((long long)b * p.H + h) * p.S;
    for (int c = tid; c < C::BQ; c += C::NT) {
      const int qi = q0 + c;
      Ls[buf * C::BQ + c] = qi < p.S ? lse[rowbase + qi] * kLog2e : 0.f;  // log2 units
      Dl[buf * C::BQ + c] = qi < p.S ? delta[rowbase + qi] : 0.f;
    }
  };
  if (total > 0) issue(0, 0);
  cp_async_commit();

  const int key[2] = {k0 + rg * 16 + qg, k0 + rg * 16 + qg + 8};
  const float scale2 = p.scale * kLog2e;
  float dka[C::DC / 8][4], dva[C::DC / 8][4];
#pragma unroll
  for (int n = 0; n < C::DC / 8; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }

  for (int it = 0; it < total; ++it) {
    const int buf = it & 1;
    if (it + 1 < total) {
      issue(it + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Qt = Qs + buf * C::BQ * C::LD;
    const T* Ot = Os + buf * C::BQ * C::LD;
    const float* Lt = Ls + buf * C::BQ;
    const float* Dt = Dl + buf * C::BQ;
    const int q0 = (qlo + it % ntiles) * C::BQ;

    // s^T = k q^T: this warp's 16 keys x the tile's 64 queries
    float st[C::BQ / 8][4];
#pragma unroll
    for (int n = 0; n < C::BQ / 8; ++n) st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4];
      load_a<T, C::LD>(a, Ks, rg * 16, kk, lane);
#pragma unroll
      for (int n = 0; n < C::BQ / 8; n += 2) {
        uint32_t bb[4];
        load_b_rows<T, C::LD>(bb, Qt, n * 8, kk, lane);
        mma16816<T>(st[n], a, bb);
        mma16816<T>(st[n + 1], a, bb + 2);
      }
    }
    // p^T = exp(s^T * scale - lse[query]) (as exp2 in log2 units), 0 where masked
    const bool full = all_kept(q0, q0 + C::BQ - 1, k0 + rg * 16, k0 + rg * 16 + 15, p);
#pragma unroll
    for (int n = 0; n < C::BQ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = n * 8 + 2 * t + (e & 1);
        st[n][e] = full || keep(q0 + ql, key[e >> 1], p) ? exp2f(st[n][e] * scale2 - Lt[ql])
                                                         : 0.f;
      }
    }
    // dv += P^T dO
#pragma unroll
    for (int kk = 0; kk < C::BQ / 16; ++kk) {
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
    float dpt[C::BQ / 8][4];
#pragma unroll
    for (int n = 0; n < C::BQ / 8; ++n) dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4];
      load_a<T, C::LD>(a, Vs, rg * 16, kk, lane);
#pragma unroll
      for (int n = 0; n < C::BQ / 8; n += 2) {
        uint32_t bb[4];
        load_b_rows<T, C::LD>(bb, Ot, n * 8, kk, lane);
        mma16816<T>(dpt[n], a, bb);
        mma16816<T>(dpt[n + 1], a, bb + 2);
      }
    }
    // ds^T = p^T (dp^T - delta[query])
#pragma unroll
    for (int n = 0; n < C::BQ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = n * 8 + 2 * t + (e & 1);
        st[n][e] *= dpt[n][e] - Dt[ql];
      }
    }
    // dk += dS^T q
#pragma unroll
    for (int kk = 0; kk < C::BQ / 16; ++kk) {
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
    __syncthreads();  // this buffer is consumed before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= p.S) continue;
    const long long off = (((long long)b * p.S + key[i]) * p.KV + g) * D + part * C::DC + 2 * t;
#pragma unroll
    for (int n = 0; n < C::DC / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + n * 8) =
          pack2<T>(dka[n][2 * i] * p.scale, dka[n][2 * i + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dv + off + n * 8) = pack2<T>(dva[n][2 * i], dva[n][2 * i + 1]);
    }
  }
}

// ---- dq (bf16 / fp16) -----------------------------------------------------

template <typename T, int D>
struct DqCfg {
  static constexpr int DSPLIT = D > 128 ? 2 : 1;
  static constexpr int RG = 4;
  static constexpr int NW = RG * DSPLIT;
  static constexpr int NT = NW * 32;
  static constexpr int BQ = 16 * RG;
  static constexpr int BK = 64;
  static constexpr int LD = D + 8;
  static constexpr int DC = D / DSPLIT;
  static constexpr size_t SMEM = (size_t)(2 * BQ + 4 * BK) * LD * sizeof(T);
};

template <typename T, int D>
__global__ void __launch_bounds__(DqCfg<T, D>::NT)
flash_bwd_dq_mma(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq, const Params p) {
  using C = DqCfg<T, D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Os = Qs + C::BQ * C::LD;      // dO
  T* Ks = Os + C::BQ * C::LD;      // two buffers of BK rows
  T* Vs = Ks + 2 * C::BK * C::LD;  // two buffers of BK rows

  const int nq = (p.S + C::BQ - 1) / C::BQ;
  const int qt = nq - 1 - (int)(blockIdx.x % nq);
  const int bh = blockIdx.x / nq;
  const int h = bh % p.H;
  const int b = bh / p.H;
  const int kvh = h / p.rep;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp % C::RG, part = warp / C::RG;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * C::BQ;
  const T* kb = k + b * p.k_sb + kvh * p.k_sh;
  const T* vb = v + b * p.v_sb + kvh * p.v_sh;

  const int nk = (p.S + C::BK - 1) / C::BK;
  int lo = 0, hi = nk;
  if (p.causal) {
    hi = min((q0 + C::BQ + C::BK - 1) / C::BK, nk);
    if (p.window > 0) lo = max(0, q0 - p.window + 1) / C::BK;
  }

  load_rows_async<T, C::BQ, D, C::LD, C::NT>(Qs, q + b * p.q_sb + h * p.q_sh, p.q_ss, q0, p.S,
                                              tid);
  load_rows_async<T, C::BQ, D, C::LD, C::NT>(Os, dout + b * p.do_sb + h * p.do_sh, p.do_ss, q0,
                                              p.S, tid);
  load_rows_async<T, C::BK, D, C::LD, C::NT>(Ks, kb, p.k_ss, lo * C::BK, p.S, tid);
  load_rows_async<T, C::BK, D, C::LD, C::NT>(Vs, vb, p.v_ss, lo * C::BK, p.S, tid);
  cp_async_commit();

  const int row[2] = {q0 + rg * 16 + g, q0 + rg * 16 + g + 8};
  const long long rowbase = ((long long)b * p.H + h) * p.S;
  const float scale2 = p.scale * kLog2e;
  float lrow[2], drow[2];  // lse in log2 units, delta
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lrow[i] = row[i] < p.S ? lse[rowbase + row[i]] * kLog2e : 0.f;
    drow[i] = row[i] < p.S ? delta[rowbase + row[i]] : 0.f;
  }
  float dqa[C::DC / 8][4];
#pragma unroll
  for (int n = 0; n < C::DC / 8; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;

  for (int j = lo; j < hi; ++j) {
    const int buf = (j - lo) & 1;
    if (j + 1 < hi) {
      const int nb = buf ^ 1;
      load_rows_async<T, C::BK, D, C::LD, C::NT>(Ks + nb * C::BK * C::LD, kb, p.k_ss,
                                                  (j + 1) * C::BK, p.S, tid);
      load_rows_async<T, C::BK, D, C::LD, C::NT>(Vs + nb * C::BK * C::LD, vb, p.v_ss,
                                                  (j + 1) * C::BK, p.S, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Kt = Ks + buf * C::BK * C::LD;
    const T* Vt = Vs + buf * C::BK * C::LD;

    // s = q k^T and dp = dO v^T for this warp's 16 rows
    float s[C::BK / 8][4], dp[C::BK / 8][4];
#pragma unroll
    for (int n = 0; n < C::BK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4], ao[4];
      load_a<T, C::LD>(a, Qs, rg * 16, kk, lane);
      load_a<T, C::LD>(ao, Os, rg * 16, kk, lane);
#pragma unroll
      for (int n = 0; n < C::BK / 8; n += 2) {
        uint32_t bk[4], bv[4];
        load_b_rows<T, C::LD>(bk, Kt, n * 8, kk, lane);
        load_b_rows<T, C::LD>(bv, Vt, n * 8, kk, lane);
        mma16816<T>(s[n], a, bk);
        mma16816<T>(s[n + 1], a, bk + 2);
        mma16816<T>(dp[n], ao, bv);
        mma16816<T>(dp[n + 1], ao, bv + 2);
      }
    }
    // ds = p (dp - delta), p = exp(s * scale - lse) (as exp2 in log2 units),
    // 0 where masked
    const bool full = all_kept(q0 + rg * 16, q0 + rg * 16 + 15, j * C::BK,
                               j * C::BK + C::BK - 1, p);
#pragma unroll
    for (int n = 0; n < C::BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int col = j * C::BK + n * 8 + 2 * t + (e & 1);
        const float pe =
            full || keep(row[i], col, p) ? exp2f(s[n][e] * scale2 - lrow[i]) : 0.f;
        s[n][e] = pe * (dp[n][e] - drow[i]);
      }
    }
    // dq += dS k
#pragma unroll
    for (int kk = 0; kk < C::BK / 16; ++kk) {
      uint32_t a[4];
      a_from_c<T>(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < C::DC / 8; n += 2) {
        uint32_t bb[4];
        load_b_cols<T, C::LD>(bb, Kt, kk * 16, part * C::DC + n * 8, lane);
        mma16816<T>(dqa[n], a, bb);
        mma16816<T>(dqa[n + 1], a, bb + 2);
      }
    }
    __syncthreads();  // this buffer is consumed before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= p.S) continue;
    T* out = dq + (((long long)b * p.S + row[i]) * p.H + h) * D + part * C::DC + 2 * t;
#pragma unroll
    for (int n = 0; n < C::DC / 8; ++n) {
      *reinterpret_cast<uint32_t*>(out + n * 8) =
          pack2<T>(dqa[n][2 * i] * p.scale, dqa[n][2 * i + 1] * p.scale);
    }
  }
}

// ---- fp32: FMA pipes -------------------------------------------------------

constexpr int kNW32 = 4;
constexpr int kRW32 = 8;                 // rows a warp owns
constexpr int kB32 = kNW32 * kRW32;      // rows a block owns
constexpr int kNC32 = 32;                // streamed rows per chunk, one a lane

template <int D>
struct Bwd32 {
  static constexpr int LD = D + 1;
  static constexpr size_t SMEM = (size_t)(2 * kB32 * D + 2 * kNC32 * LD + 2 * kNC32) * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(kNW32 * 32)
flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dk, float* __restrict__ dv, const Params p) {
  constexpr int E = D / 32;
  constexpr int NT = kNW32 * 32;
  constexpr int LD = Bwd32<D>::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);  // the block's keys, [kB32][D]
  float* Vs = Ks + kB32 * D;
  float* Qs = Vs + kB32 * D;     // query chunk, [kNC32][LD]
  float* Os = Qs + kNC32 * LD;   // dO chunk
  float* Ls = Os + kNC32 * LD;
  float* Dl = Ls + kNC32;

  const int nkt = (p.S + kB32 - 1) / kB32;
  const int kt = blockIdx.x % nkt;
  const int bg = blockIdx.x / nkt;
  const int g = bg % p.KV;
  const int b = bg / p.KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = kt * kB32;

  int qlo = 0, qhi = p.S;  // queries [qlo, qhi)
  if (p.causal) {
    qlo = k0 / kNC32 * kNC32;
    if (p.window > 0) qhi = min(p.S, k0 + kB32 - 1 + p.window);
  }
  load_rows_f32<kB32, D, D, NT>(Ks, k + b * p.k_sb + g * p.k_sh, p.k_ss, k0, p.S, tid);
  load_rows_f32<kB32, D, D, NT>(Vs, v + b * p.v_sb + g * p.v_sh, p.v_ss, k0, p.S, tid);

  float dka[kRW32][E], dva[kRW32][E];
#pragma unroll
  for (int i = 0; i < kRW32; ++i) {
#pragma unroll
    for (int e = 0; e < E; ++e) dka[i][e] = dva[i][e] = 0.f;
  }
  const float* kw = Ks + warp * kRW32 * D;
  const float* vw = Vs + warp * kRW32 * D;

  for (int r = 0; r < p.rep; ++r) {
    const int h = g * p.rep + r;
    const long long rowbase = ((long long)b * p.H + h) * p.S;
    for (int s0 = qlo; s0 < qhi; s0 += kNC32) {
      __syncthreads();
      load_rows_f32<kNC32, D, LD, NT>(Qs, q + b * p.q_sb + h * p.q_sh, p.q_ss, s0, p.S, tid);
      load_rows_f32<kNC32, D, LD, NT>(Os, dout + b * p.do_sb + h * p.do_sh, p.do_ss, s0, p.S,
                                      tid);
      if (tid < kNC32) {
        const int qi = s0 + tid;
        Ls[tid] = qi < p.S ? lse[rowbase + qi] : 0.f;
        Dl[tid] = qi < p.S ? delta[rowbase + qi] : 0.f;
      }
      __syncthreads();
      // lane owns query s0 + lane: s and dp for each of the warp's keys
      float sc[kRW32], dp[kRW32];
#pragma unroll
      for (int i = 0; i < kRW32; ++i) sc[i] = dp[i] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float qq = Qs[lane * LD + d];
        const float oo = Os[lane * LD + d];
#pragma unroll
        for (int i = 0; i < kRW32; ++i) {
          sc[i] = fmaf(kw[i * D + d], qq, sc[i]);
          dp[i] = fmaf(vw[i * D + d], oo, dp[i]);
        }
      }
      const int qi = s0 + lane;
      float pr[kRW32], ds[kRW32];
#pragma unroll
      for (int i = 0; i < kRW32; ++i) {
        const int key = k0 + warp * kRW32 + i;
        pr[i] = keep(qi, key, p) ? expf(sc[i] * p.scale - Ls[lane]) : 0.f;
        ds[i] = pr[i] * (dp[i] - Dl[lane]);
      }
#pragma unroll 4
      for (int jj = 0; jj < kNC32; ++jj) {
        float qv[E], ov[E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          qv[e] = Qs[jj * LD + lane + 32 * e];
          ov[e] = Os[jj * LD + lane + 32 * e];
        }
#pragma unroll
        for (int i = 0; i < kRW32; ++i) {
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
  }

#pragma unroll
  for (int i = 0; i < kRW32; ++i) {
    const int key = k0 + warp * kRW32 + i;
    if (key >= p.S) continue;
    const long long off = (((long long)b * p.S + key) * p.KV + g) * D;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      dk[off + lane + 32 * e] = dka[i][e] * p.scale;
      dv[off + lane + 32 * e] = dva[i][e];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kNW32 * 32)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dq, const Params p) {
  constexpr int E = D / 32;
  constexpr int NT = kNW32 * 32;
  constexpr int LD = Bwd32<D>::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // the block's queries, [kB32][D]
  float* Os = Qs + kB32 * D;                       // their dO
  float* Ks = Os + kB32 * D;                       // key chunk, [kNC32][LD]
  float* Vs = Ks + kNC32 * LD;

  const int nq = (p.S + kB32 - 1) / kB32;
  const int qt = nq - 1 - (int)(blockIdx.x % nq);
  const int bh = blockIdx.x / nq;
  const int h = bh % p.H;
  const int b = bh / p.H;
  const int kvh = h / p.rep;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = qt * kB32;
  const float* kb = k + b * p.k_sb + kvh * p.k_sh;
  const float* vb = v + b * p.v_sb + kvh * p.v_sh;

  int lo = 0, hi = p.S;
  if (p.causal) {
    hi = min(q0 + kB32, p.S);
    if (p.window > 0) lo = max(0, q0 - p.window + 1) / kNC32 * kNC32;
  }
  load_rows_f32<kB32, D, D, NT>(Qs, q + b * p.q_sb + h * p.q_sh, p.q_ss, q0, p.S, tid);
  load_rows_f32<kB32, D, D, NT>(Os, dout + b * p.do_sb + h * p.do_sh, p.do_ss, q0, p.S, tid);

  const long long rowbase = ((long long)b * p.H + h) * p.S;
  float lrow[kRW32], drow[kRW32], dqa[kRW32][E];
#pragma unroll
  for (int i = 0; i < kRW32; ++i) {
    const int r = q0 + warp * kRW32 + i;
    lrow[i] = r < p.S ? lse[rowbase + r] : 0.f;
    drow[i] = r < p.S ? delta[rowbase + r] : 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) dqa[i][e] = 0.f;
  }
  const float* qw = Qs + warp * kRW32 * D;
  const float* ow = Os + warp * kRW32 * D;

  for (int s0 = lo; s0 < hi; s0 += kNC32) {
    __syncthreads();
    load_rows_f32<kNC32, D, LD, NT>(Ks, kb, p.k_ss, s0, p.S, tid);
    load_rows_f32<kNC32, D, LD, NT>(Vs, vb, p.v_ss, s0, p.S, tid);
    __syncthreads();
    // lane owns key s0 + lane
    float sc[kRW32], dp[kRW32];
#pragma unroll
    for (int i = 0; i < kRW32; ++i) sc[i] = dp[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kk = Ks[lane * LD + d];
      const float vv = Vs[lane * LD + d];
#pragma unroll
      for (int i = 0; i < kRW32; ++i) {
        sc[i] = fmaf(qw[i * D + d], kk, sc[i]);
        dp[i] = fmaf(ow[i * D + d], vv, dp[i]);
      }
    }
    const int key = s0 + lane;
    float ds[kRW32];
#pragma unroll
    for (int i = 0; i < kRW32; ++i) {
      const int r = q0 + warp * kRW32 + i;
      const float pe = keep(r, key, p) ? expf(sc[i] * p.scale - lrow[i]) : 0.f;
      ds[i] = pe * (dp[i] - drow[i]);
    }
#pragma unroll 4
    for (int jj = 0; jj < kNC32; ++jj) {
      float kv[E];
#pragma unroll
      for (int e = 0; e < E; ++e) kv[e] = Ks[jj * LD + lane + 32 * e];
#pragma unroll
      for (int i = 0; i < kRW32; ++i) {
        const float dsj = __shfl_sync(0xffffffffu, ds[i], jj);
#pragma unroll
        for (int e = 0; e < E; ++e) dqa[i][e] = fmaf(dsj, kv[e], dqa[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRW32; ++i) {
    const int r = q0 + warp * kRW32 + i;
    if (r >= p.S) continue;
    float* out = dq + (((long long)b * p.S + r) * p.H + h) * D;
#pragma unroll
    for (int e = 0; e < E; ++e) out[lane + 32 * e] = dqa[i][e] * p.scale;
  }
}

// ---- launches ---------------------------------------------------------------

struct Ptrs {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
};

template <typename T, int D>
cudaError_t launch_delta(const Ptrs& a, const Params& p, cudaStream_t s) {
  const long long rows = (long long)p.B * p.S * p.H;
  flash_delta<T, D><<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.delta, p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_mma(const Ptrs& a, const Params& p, cudaStream_t s) {
  cudaError_t err = launch_delta<T, D>(a, p, s);
  if (err != cudaSuccess) return err;
  {
    using C = DkvCfg<T, D>;
    auto kern = flash_bwd_dkv_mma<T, D>;
    if ((err = allow_smem(kern, C::SMEM)) != cudaSuccess) return err;
    const int nkt = (p.S + C::BKK - 1) / C::BKK;
    kern<<<(unsigned)(p.B * p.KV * nkt), C::NT, C::SMEM, s>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  {
    using C = DqCfg<T, D>;
    auto kern = flash_bwd_dq_mma<T, D>;
    if ((err = allow_smem(kern, C::SMEM)) != cudaSuccess) return err;
    const int nq = (p.S + C::BQ - 1) / C::BQ;
    kern<<<(unsigned)(p.B * p.H * nq), C::NT, C::SMEM, s>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dq), p);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Ptrs& a, const Params& p, cudaStream_t s) {
  cudaError_t err = launch_delta<float, D>(a, p, s);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = Bwd32<D>::SMEM;
  auto dkv = flash_bwd_dkv_f32<D>;
  if ((err = allow_smem(dkv, smem)) != cudaSuccess) return err;
  const int nkt = (p.S + kB32 - 1) / kB32;
  dkv<<<(unsigned)(p.B * p.KV * nkt), kNW32 * 32, smem, s>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  auto dqk = flash_bwd_dq_f32<D>;
  if ((err = allow_smem(dqk, smem)) != cudaSuccess) return err;
  dqk<<<(unsigned)(p.B * p.H * nkt), kNW32 * 32, smem, s>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      static_cast<float*>(a.dq), p);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_dtype(int dtype, const Ptrs& a, const Params& p, cudaStream_t s) {
  switch (dtype) {
    case 0: return launch_f32<D>(a, p, s);
    case 1: return launch_mma<__half, D>(a, p, s);
    case 2: return launch_mma<__nv_bfloat16, D>(a, p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 float32, 1 float16, 2 bfloat16 (every tensor operand but
// lse and delta shares it). q/k/v/o/dO strided as documented in the common
// header; lse and delta [B, H, S] f32 contiguous (delta is written here);
// dq [B, S, H, D] and dk/dv [B, S, KV, D] contiguous. Returns the first
// CUDA error of the three launches (0 on success), cudaErrorInvalidValue
// for shapes the kernels do not take. Asynchronous on `stream`.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int S, int H, int KV,
    int D, long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, long long do_sb, long long do_ss, long long do_sh,
    int causal, int window, float sm_scale, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  Params p{};
  p.B = B; p.S = S; p.H = H; p.KV = KV; p.rep = H / KV;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.do_sb = do_sb; p.do_ss = do_ss; p.do_sh = do_sh;
  p.causal = causal; p.window = window; p.scale = sm_scale;
  Ptrs a{q, k, v, o, dout, static_cast<const float*>(lse), static_cast<float*>(delta),
         dq, dk, dv};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)dispatch_dtype<64>(dtype, a, p, s);
    case 128: return (int)dispatch_dtype<128>(dtype, a, p, s);
    case 256: return (int)dispatch_dtype<256>(dtype, a, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
