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
// What bounds it on the card: its flops. At the training shape (B8 H16
// S1024 D64 bf16, causal) the five products the function needs are 43
// GFLOP against ~84 MB of q/k/v/o/dO/dq/dk/dv: 0.044 ms at 989 TFLOP/s.
// Only wgmma reaches the tensor cores' rate.
//
// One entry launches three kernels on the stream, in order. At bf16/fp16
// and D 64/128 (the forward's TMA route):
//  1. prep: delta = rowsum(dO * O) read with 16-byte loads (a D64 row is 8
//     lanes, 4 rows a warp load), written with lse in log2 units as [B, H,
//     2, Sp] f32, so one TMA box carries a query tile's lse and delta;
//  2. dk/dv, persistent: min(items, SMs) blocks of three warpgroups, an item
//     being a key tile of 128 of one (batch, kv head), heaviest first, dealt
//     in rounds as the forward deals its items. A producer warp loads each
//     item's K and V by TMA into one of two buffers (the next item's while
//     this one runs), then streams, for each q head of the GQA group and
//     each query tile that can see the key tile (the bounds of _causal_lo
//     :193 and _window_hi_q :207), the Q and dO tiles and their lse/delta
//     slice through an mbarrier ring that runs on across items. Each
//     consumer warpgroup owns 64 keys: S^T = K Q^T, then dP^T = V dO^T, by
//     wgmma from shared memory (K, Q, V, dO K-major, 128-byte swizzled as
//     TMA wrote them), P^T = exp2(S^T scale2 - lse2) while dP^T runs, dS^T =
//     P^T (dP^T - delta) in registers (the mask as selects on the tiles that
//     cross it), then dV += P^T dO and dK += dS^T Q with P^T and dS^T
//     rounded to the storage dtype as register A operands and dO, Q
//     MN-major. dK and dV stay in registers over the item (the group's q
//     heads summed in f32) and are stored once. Query tiles of 128 at D64,
//     64 at D128 (whose two 64 x 128 f32 accumulators leave no room for 64 x
//     128 S^T and dP^T);
//  3. dq, persistent the same way over query tiles of 128 (the forward's
//     items): Q and dO double-buffered, K/V tiles (128 keys at D64, 64 at
//     D128) streamed, S = Q K^T and dP = dO V^T from shared memory, dS in
//     registers, dQ += dS K with K MN-major, left running while the next
//     tile's S and dP are issued.
// setmaxnreg moves registers from the producer (40) to the consumers (232).
// Both are deterministic: no atomics, every output written by one block,
// every sum in a fixed order. The cost is 7 products per (query tile, key
// tile) pair (dk/dv: 4, dq: 3) against the fused TPU kernel's 5, which
// shared one recompute of s, p, dp and ds across dq and dk/dv through a
// whole-sequence scratch; a fused kernel here would have to sum dq across
// key-tile blocks, and an unordered float sum would not repeat bit for bit.
// What holds it back (the training shape on an H100 80GB HBM3 at 700 W,
// tools/flash_bwd_ablation.py): each product runs at ~40% of the tensor
// cores' rate. Without its exponentials dk/dv is ~6% faster and dq ~3%;
// without its last product each loses 20-30% of its time, so the products,
// not the softmax, set the pace. A warpgroup waits for its own
// products before its elementwise work (registers leave no room for a
// second set of S^T and dP^T in flight), and the two warpgroups overlap
// each other only as the schedule lets them (a ping-pong on named barriers
// was slower here).
//
// D 256 keeps the mma.sync design below (m16n8k16 products from ldmatrix
// fragments, the streamed operand double-buffered through cp.async, 2 warps
// of 16 keys x 4 column groups): its 64 x 256 f32 accumulators leave no room
// for the scores beside them in a warpgroup. fp32 runs the same loops on the
// FMA pipes (lane j owns row j of a 32-row chunk); both read delta from the
// row-per-warp delta kernel.
//
// Ragged S: rows and keys past S are zero-filled (TMA's out-of-bounds fill,
// or cp.async's) and masked (p = 0), and nothing past S is written.

#include <cuda.h>

#include <algorithm>
#include <type_traits>

#include "flash_attention_common.cuh"
#include "hopper.cuh"

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

// ---- bf16/fp16 at D 64 and 128: TMA, wgmma, warp specialisation ------------

// lse in log2 units and delta of every (b, h, query), [B, H, 2, Sp] f32 (Sp
// = S rounded up to 4, so a row is a whole number of 16-byte units for its
// TMA map; entries S .. Sp-1 zero): the dk/dv kernel reads each query
// tile's slice as one TMA box beside its Q and dO. delta = rowsum(dO * O)
// with 16-byte loads: TPR lanes a row, 32 / TPR rows a warp
template <typename T, int D>
__global__ void __launch_bounds__(256)
flash_bwd_prep(const T* __restrict__ o, const T* __restrict__ dout,
               const float* __restrict__ lse, float* __restrict__ aux, const Params p, int Sp) {
  constexpr int TPR = D / 8;             // lanes a row (8 16-bit elements a 16-byte load)
  constexpr int RPW = 32 / TPR;          // rows a warp
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane % TPR;
  const int nsb = (Sp + 8 * RPW - 1) / (8 * RPW);  // blocks a (b, h)
  const int bh = blockIdx.x / nsb;       // the block's rows are consecutive s of one (b, h)
  const int b = bh / p.H, h = bh % p.H;
  const int s = ((blockIdx.x % nsb) * 8 + warp) * RPW + lane / TPR;
  float acc = 0.f;
  if (s < p.S) {
    const uint4 ov = *reinterpret_cast<const uint4*>(o + b * p.o_sb + s * p.o_ss + h * p.o_sh +
                                                     sub * 8);
    const uint4 dv = *reinterpret_cast<const uint4*>(dout + b * p.do_sb + s * p.do_ss +
                                                     h * p.do_sh + sub * 8);
    const T* ot = reinterpret_cast<const T*>(&ov);
    const T* dt = reinterpret_cast<const T*>(&dv);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc = fmaf(to_float(dt[e]), to_float(ot[e]), acc);
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (sub == 0 && s < Sp) {  // s in S .. Sp - 1: zeros
    float* a = aux + (long long)bh * 2 * Sp;
    a[s] = s < p.S ? lse[(long long)bh * p.S + s] * kLog2e : 0.f;
    a[Sp + s] = acc;
  }
}

template <typename T, int D>
struct DkvWg {
  static constexpr int BK = 128;                 // keys an item: 2 consumer warpgroups x 64
  static constexpr int BQ = D == 64 ? 128 : 64;  // queries a streamed tile
  static constexpr int STAGES = D == 64 ? 4 : 2;
  static constexpr int NT = 384;                 // producer + 2 consumer warpgroups
  static constexpr int ATOMS = D / 64;           // 128-byte column atoms a row
  static constexpr uint32_t KV_BYTES = BK * D * 2;   // a K tile (V the same)
  static constexpr uint32_t Q_BYTES = BQ * D * 2;    // a Q tile (dO the same)
  static constexpr uint32_t AUX_BYTES = 2 * BQ * 4;  // its lse and delta
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = 232;
  // 1024 bytes of slack to align the tiles; two K/V buffers (the next
  // item's load while this one runs), the Q and dO stages, the lse/delta
  // stages, the barriers
  static constexpr size_t SMEM = 1024 + 4 * KV_BYTES + (size_t)STAGES * (2 * Q_BYTES + AUX_BYTES) +
                                 8 * (4 + 2 * STAGES);
};

// a dk/dv item: a key tile of one (batch, kv head), the heaviest (first,
// under causal masking) key tiles first, and the query tiles that see it
struct DkvItem {
  int b, g, k0, qlo, ntiles, total;
};

template <int BK, int BQ>
__device__ __forceinline__ DkvItem dkv_item(int i, const Params& p) {
  DkvItem w;
  const int nbg = p.B * p.KV;
  w.k0 = (i / nbg) * BK;
  w.g = (i % nbg) % p.KV;
  w.b = (i % nbg) / p.KV;
  const int nq = (p.S + BQ - 1) / BQ;
  int qhi = nq;
  w.qlo = 0;
  if (p.causal) {
    w.qlo = w.k0 / BQ;
    if (p.window > 0) qhi = min(nq, (w.k0 + BK + p.window - 2) / BQ + 1);
  }
  w.ntiles = qhi - w.qlo;
  w.total = p.rep * w.ntiles;
  return w;
}

// dk, dv: persistent, min(items, SMs) blocks of three warpgroups walking
// the items of the schedule. A producer warp loads each item's K and V by
// TMA into one of two buffers (the next item's while this one runs), then
// streams, for each q head of the GQA group and each query tile that sees
// the key tile, Q, dO and their lse/delta slice through a ring of stages
// that runs on across items. Consumer warpgroup cw owns keys k0 + 64 cw ..
// + 63: S^T = K Q^T and dP^T = V dO^T from shared memory, P^T = exp2(S^T
// scale2 - lse2) and dS^T = P^T (dP^T - delta) in registers, then dV +=
// P^T dO and dK += dS^T Q with P^T and dS^T as register A operands; dK and
// dV stay in registers across the item's loop and are stored once
template <typename T, int D>
__global__ void __launch_bounds__(384, 1)
flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap taux, T* __restrict__ dk,
                    T* __restrict__ dv, const Params p, int n_items) {
  using C = DkvWg<T, D>;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* KVs = base;                                    // buffer k: K at 2k, V at 2k + 1
  unsigned char* Qs = KVs + 4 * C::KV_BYTES;                    // stage s at s * Q_BYTES
  unsigned char* Os = Qs + (size_t)C::STAGES * C::Q_BYTES;      // dO, the same
  float* Aux = reinterpret_cast<float*>(Os + (size_t)C::STAGES * C::Q_BYTES);  // [stage][2][BQ]
  uint64_t* bars = reinterpret_cast<uint64_t*>(Aux + C::STAGES * 2 * C::BQ);
  uint64_t* kv_full = bars;
  uint64_t* kv_empty = bars + 2;
  uint64_t* full = bars + 4;
  uint64_t* empty = bars + 4 + C::STAGES;

  if (threadIdx.x == 0) {
    for (int k = 0; k < 2; ++k) {
      mbar_init(&kv_full[k], 1);
      mbar_init(&kv_empty[k], 2);
    }
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every load --------------------------
    regs_dec<C::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int it = 0;  // Q/dO stages loaded, over all items
      for (int r = 0, ki = 0; r * (int)gridDim.x < n_items; ++r) {
        const int i = round_item(r, n_items);
        if (i < 0) continue;
        const DkvItem w = dkv_item<C::BK, C::BQ>(i, p);
        const int kb = ki % 2;
        mbar_wait(&kv_empty[kb], ((ki / 2) & 1) ^ 1);
        mbar_arrive_tx(&kv_full[kb], 2 * C::KV_BYTES);
        unsigned char* Kt = KVs + (size_t)(2 * kb) * C::KV_BYTES;
        for (int a = 0; a < C::ATOMS; ++a) {
          tma_load_4d(Kt + a * C::BK * 128, &tk, &kv_full[kb], a * 64, w.g, w.k0, w.b);
          tma_load_4d(Kt + C::KV_BYTES + a * C::BK * 128, &tv, &kv_full[kb], a * 64, w.g, w.k0,
                      w.b);
        }
        for (int t = 0; t < w.total; ++t, ++it) {
          const int h = w.g * p.rep + t / w.ntiles;
          const int q0 = (w.qlo + t % w.ntiles) * C::BQ;
          const int s = it % C::STAGES;
          mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);
          mbar_arrive_tx(&full[s], 2 * C::Q_BYTES + C::AUX_BYTES);
          for (int a = 0; a < C::ATOMS; ++a) {
            tma_load_4d(Qs + (size_t)s * C::Q_BYTES + a * C::BQ * 128, &tq, &full[s], a * 64, h,
                        q0, w.b);
            tma_load_4d(Os + (size_t)s * C::Q_BYTES + a * C::BQ * 128, &tdo, &full[s], a * 64, h,
                        q0, w.b);
          }
          tma_load_4d(Aux + s * 2 * C::BQ, &taux, &full[s], q0, 0, h, w.b);
        }
        ++ki;
      }
    }
    return;
  }

  // ---- consumers ------------------------------------------------------------
  regs_inc<C::CONSUMER_REGS>();
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3;
  const float scale2 = p.scale * kLog2e;

  float dka[D / 2], dva[D / 2];
  float st[C::BQ / 2], dpt[C::BQ / 2];
  uint32_t pa[C::BQ / 16][4], da[C::BQ / 16][4];

  int it = 0;  // Q/dO stages consumed, over all items
  for (int r = 0, ki = 0; r * (int)gridDim.x < n_items; ++r) {
    const int i = round_item(r, n_items);
    if (i < 0) continue;
    const DkvItem w = dkv_item<C::BK, C::BQ>(i, p);
    const int kw0 = w.k0 + cw * 64 + warp * 16;  // this warp's first key
    const int kb = ki % 2;
    const uint32_t k_addr = smem_addr(KVs) + (2 * kb) * C::KV_BYTES + cw * 64 * 128;
    const uint32_t v_addr = k_addr + C::KV_BYTES;
    // key row kw0 + (lane >> 2) + 8 i sees the queries [qlo_r, qhi_r]
    int qlo_r[2], qhi_r[2];
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      const int key = kw0 + (lane >> 2) + 8 * i2;
      qlo_r[i2] = p.causal ? key : 0;
      qhi_r[i2] = key >= p.S ? -1
                             : (p.causal && p.window > 0 ? min(key + p.window - 1, p.S - 1)
                                                         : p.S - 1);
    }
#pragma unroll
    for (int k = 0; k < D / 2; ++k) dka[k] = dva[k] = 0.f;
    mbar_wait(&kv_full[kb], (ki / 2) & 1);

    for (int tt = 0; tt < w.total; ++tt, ++it) {
      const int q0 = (w.qlo + tt % w.ntiles) * C::BQ;
      const int s = it % C::STAGES;
      mbar_wait(&full[s], (it / C::STAGES) & 1);
      const uint32_t q_addr = smem_addr(Qs) + s * C::Q_BYTES;
      const uint32_t do_addr = smem_addr(Os) + s * C::Q_BYTES;
      const float* lse2 = Aux + s * 2 * C::BQ;
      const float* dlt = lse2 + C::BQ;

      // S^T = K Q^T, then dP^T = V dO^T, two commit groups: P^T's
      // exponentials run while dP^T is on the tensor cores
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
      issue_ss<T, D, C::BQ>(st, k_addr, C::BK * 128, q_addr, C::BQ * 128);
      wgmma_commit();
      issue_ss<T, D, C::BQ>(dpt, v_addr, C::BK * 128, do_addr, C::BQ * 128);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(st);

      // P^T; masked (key, query) pairs get P = 0, as selects
      const bool whole = all_kept(q0, q0 + C::BQ - 1, kw0, kw0 + 15, p);
#pragma unroll
      for (int n = 0; n < C::BQ / 8; ++n) {
        const int ql = n * 8 + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(lse2 + ql);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pe = ex2(fmaf(st[4 * n + e], scale2, -((e & 1) ? l2.y : l2.x)));
          if (!whole) {
            const int qi = q0 + ql + (e & 1);
            pe = qi >= qlo_r[e >> 1] && qi <= qhi_r[e >> 1] ? pe : 0.f;
          }
          st[4 * n + e] = pe;
        }
      }
      pack_a<T, C::BQ>(pa, st);
      wgmma_wait<0>();
      fence_regs(dpt);
      // dS^T = P^T (dP^T - delta)
#pragma unroll
      for (int n = 0; n < C::BQ / 8; ++n) {
        const float2 d2 = *reinterpret_cast<const float2*>(dlt + n * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[4 * n + e] = st[4 * n + e] * (dpt[4 * n + e] - ((e & 1) ? d2.y : d2.x));
      }
      pack_a<T, C::BQ>(da, dpt);

      // dV += P^T dO, dK += dS^T Q
      fence_regs(dva);
      fence_regs(dka);
      fence_regs(pa);
      fence_regs(da);
      wgmma_fence();
      issue_rs<T, D, C::BQ>(dva, pa, do_addr);
      issue_rs<T, D, C::BQ>(dka, da, q_addr);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
      fence_regs(pa);
      fence_regs(da);
      if (tid == 0) mbar_arrive(&empty[s]);  // the stage's last reads are done
    }
    if (tid == 0) mbar_arrive(&kv_empty[kb]);  // K and V's last reads are done

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int key = kw0 + (lane >> 2) + 8 * hr;
      if (key >= p.S) continue;
      const long long off = (((long long)w.b * p.S + key) * p.KV + w.g) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<uint32_t*>(dk + off + n * 8) =
            pack2<T>(dka[4 * n + 2 * hr] * p.scale, dka[4 * n + 2 * hr + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(dv + off + n * 8) =
            pack2<T>(dva[4 * n + 2 * hr], dva[4 * n + 2 * hr + 1]);
      }
    }
    ++ki;
  }
}

template <typename T, int D>
struct DqWg {
  static constexpr int BQ = 128;                 // queries an item: 2 consumer warpgroups x 64
  static constexpr int BK = D == 64 ? 128 : 64;  // keys a streamed tile
  static constexpr int STAGES = D == 64 ? 4 : 2;
  static constexpr int NT = 384;
  static constexpr int ATOMS = D / 64;
  static constexpr uint32_t Q_BYTES = BQ * D * 2;   // Q (dO the same)
  static constexpr uint32_t T_BYTES = BK * D * 2;   // one K or V tile
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = 232;
  // two Q/dO buffers (the next item's load while this one runs), the K/V
  // stages, the barriers
  static constexpr size_t SMEM = 1024 + 4 * Q_BYTES + (size_t)STAGES * 2 * T_BYTES +
                                 8 * (4 + 2 * STAGES);
};

// a dq item: a query tile of one (batch, head), the heaviest (last, under
// causal masking) query tiles first, and the key tiles it sees (the
// forward's bounds)
struct DqItem {
  int b, h, kvh, q0, lo, hi;
};

template <int BQ, int BK>
__device__ __forceinline__ DqItem dq_item(int i, const Params& p) {
  DqItem w;
  const int nq = (p.S + BQ - 1) / BQ;
  const int nbh = p.B * p.H;
  w.q0 = (nq - 1 - i / nbh) * BQ;
  w.h = (i % nbh) % p.H;
  w.b = (i % nbh) / p.H;
  w.kvh = w.h / p.rep;
  const int nk = (p.S + BK - 1) / BK;
  w.lo = 0;
  w.hi = nk;
  if (p.causal) {
    w.hi = min((w.q0 + BQ + BK - 1) / BK, nk);
    if (p.window > 0) w.lo = max(0, w.q0 - p.window + 1) / BK;
  }
  return w;
}

// dq: persistent as dk/dv. A producer warp loads each item's Q and dO into
// one of two buffers and streams the K/V tiles the query tile sees through
// a ring of stages that runs on across items. Consumer warpgroup cw owns
// queries q0 + 64 cw .. + 63: S = Q K^T and dP = dO V^T from shared
// memory, dS = P (dP - delta) in registers, dQ += dS K with dS as the
// register A operand and K MN-major; tile j's S and dP are issued while
// tile j - 1's dQ product runs
template <typename T, int D>
__global__ void __launch_bounds__(384, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ aux, T* __restrict__ dq, const Params p, int Sp,
                   int n_items) {
  using C = DqWg<T, D>;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* QOs = base;                     // buffer k: Q at 2k, dO at 2k + 1
  unsigned char* KVs = QOs + 4 * C::Q_BYTES;     // stage s: K at 2s, V at 2s + 1
  uint64_t* bars = reinterpret_cast<uint64_t*>(KVs + (size_t)C::STAGES * 2 * C::T_BYTES);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + 2;
  uint64_t* full = bars + 4;
  uint64_t* empty = bars + 4 + C::STAGES;

  if (threadIdx.x == 0) {
    for (int k = 0; k < 2; ++k) {
      mbar_init(&q_full[k], 1);
      mbar_init(&q_empty[k], 2);
    }
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    regs_dec<C::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int it = 0;  // K/V stages loaded, over all items
      for (int r = 0, qi = 0; r * (int)gridDim.x < n_items; ++r) {
        const int i = round_item(r, n_items);
        if (i < 0) continue;
        const DqItem w = dq_item<C::BQ, C::BK>(i, p);
        const int qb = qi % 2;
        mbar_wait(&q_empty[qb], ((qi / 2) & 1) ^ 1);
        mbar_arrive_tx(&q_full[qb], 2 * C::Q_BYTES);
        unsigned char* Qt = QOs + (size_t)(2 * qb) * C::Q_BYTES;
        for (int a = 0; a < C::ATOMS; ++a) {
          tma_load_4d(Qt + a * C::BQ * 128, &tq, &q_full[qb], a * 64, w.h, w.q0, w.b);
          tma_load_4d(Qt + C::Q_BYTES + a * C::BQ * 128, &tdo, &q_full[qb], a * 64, w.h, w.q0,
                      w.b);
        }
        for (int j = w.lo; j < w.hi; ++j, ++it) {
          const int s = it % C::STAGES;
          mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);
          mbar_arrive_tx(&full[s], 2 * C::T_BYTES);
          unsigned char* Kt = KVs + (size_t)(2 * s) * C::T_BYTES;
          for (int a = 0; a < C::ATOMS; ++a) {
            tma_load_4d(Kt + a * C::BK * 128, &tk, &full[s], a * 64, w.kvh, j * C::BK, w.b);
            tma_load_4d(Kt + C::T_BYTES + a * C::BK * 128, &tv, &full[s], a * 64, w.kvh,
                        j * C::BK, w.b);
          }
        }
        ++qi;
      }
    }
    return;
  }

  regs_inc<C::CONSUMER_REGS>();
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3;
  const float scale2 = p.scale * kLog2e;
  const uint32_t kv_addr = smem_addr(KVs);

  float dqa[D / 2];
  float s[C::BK / 2], dp[C::BK / 2];
  uint32_t da[C::BK / 16][4];

  int it = 0;  // K/V stages consumed, over all items
  for (int r = 0, qi = 0; r * (int)gridDim.x < n_items; ++r) {
    const int i = round_item(r, n_items);
    if (i < 0) continue;
    const DqItem w = dq_item<C::BQ, C::BK>(i, p);
    const int rw0 = w.q0 + cw * 64 + warp * 16;  // this warp's first query
    const int qb = qi % 2;
    const uint32_t q_addr = smem_addr(QOs) + (2 * qb) * C::Q_BYTES + cw * 64 * 128;
    const uint32_t do_addr = q_addr + C::Q_BYTES;
    // row rw0 + (lane >> 2) + 8 i: lse (log2 units), delta, its keys [lo_r, hi_r]
    float lrow[2], drow[2];
    int lo_r[2], hi_r[2];
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      const int row = rw0 + (lane >> 2) + 8 * i2;
      const float* a = aux + ((long long)w.b * p.H + w.h) * 2 * Sp;
      lrow[i2] = row < p.S ? a[row] : 0.f;
      drow[i2] = row < p.S ? a[Sp + row] : 0.f;
      hi_r[i2] = row >= p.S ? -1 : (p.causal ? min(row, p.S - 1) : p.S - 1);
      lo_r[i2] = p.causal && p.window > 0 ? row - p.window + 1 : 0;
    }
#pragma unroll
    for (int k = 0; k < D / 2; ++k) dqa[k] = 0.f;
    mbar_wait(&q_full[qb], (qi / 2) & 1);

    int prev = 0;
    for (int j = w.lo; j < w.hi; ++j, ++it) {
      const int st = it % C::STAGES;
      mbar_wait(&full[st], (it / C::STAGES) & 1);
      const uint32_t k_addr = kv_addr + (2 * st) * C::T_BYTES;
      const uint32_t v_addr = k_addr + C::T_BYTES;

      // S = Q K^T, then dP = dO V^T, two commit groups
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      issue_ss<T, D, C::BK>(s, q_addr, C::BQ * 128, k_addr, C::BK * 128);
      wgmma_commit();
      issue_ss<T, D, C::BK>(dp, do_addr, C::BQ * 128, v_addr, C::BK * 128);
      wgmma_commit();
      wgmma_wait<2>();  // tile j-1's dQ product (none on an item's first tile)
      fence_regs(dqa);
      fence_regs(da);
      if (j > w.lo && tid == 0) mbar_arrive(&empty[prev]);
      wgmma_wait<1>();
      fence_regs(s);

      // P = exp2(S scale2 - lse2), 0 where masked; dS = P (dP - delta)
      const int c0 = j * C::BK;
      const bool whole = all_kept(rw0, rw0 + 15, c0, c0 + C::BK - 1, p);
#pragma unroll
      for (int n = 0; n < C::BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i2 = e >> 1;
          float pe = ex2(fmaf(s[4 * n + e], scale2, -lrow[i2]));
          if (!whole) {
            const int col = c0 + n * 8 + 2 * t + (e & 1);
            pe = col >= lo_r[i2] && col <= hi_r[i2] ? pe : 0.f;
          }
          s[4 * n + e] = pe;
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int n = 0; n < C::BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[4 * n + e] = s[4 * n + e] * (dp[4 * n + e] - drow[e >> 1]);
      }
      pack_a<T, C::BK>(da, dp);

      // dQ += dS K, left running into the next tile
      fence_regs(dqa);
      fence_regs(da);
      wgmma_fence();
      issue_rs<T, D, C::BK>(dqa, da, k_addr);
      wgmma_commit();
      prev = st;
    }
    wgmma_wait<0>();
    fence_regs(dqa);
    fence_regs(da);
    if (tid == 0) {
      if (w.hi > w.lo) mbar_arrive(&empty[prev]);
      mbar_arrive(&q_empty[qb]);  // Q and dO's last reads are done
    }

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = rw0 + (lane >> 2) + 8 * hr;
      if (row >= p.S) continue;
      T* out = dq + (((long long)w.b * p.S + row) * p.H + w.h) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<uint32_t*>(out + n * 8) =
            pack2<T>(dqa[4 * n + 2 * hr] * p.scale, dqa[4 * n + 2 * hr + 1] * p.scale);
      }
    }
    ++qi;
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

// delta and lse (prep), dk/dv, dq: the TMA + wgmma kernels. `a.delta` is
// the [B, H, 2, Sp] f32 scratch of flash_bwd_prep
template <typename T, int D>
cudaError_t launch_wgmma(const Ptrs& a, const Params& p, cudaStream_t s) {
  using K = DkvWg<T, D>;
  using Q = DqWg<T, D>;
  constexpr bool half = std::is_same<T, __half>::value;
  const int Sp = (p.S + 3) & ~3;
  {
    constexpr int rows_a_block = 8 * (32 / (D / 8));  // 8 warps
    const unsigned grid = (unsigned)((Sp + rows_a_block - 1) / rows_a_block) * p.B * p.H;
    flash_bwd_prep<T, D><<<grid, 256, 0, s>>>(
        static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.lse, a.delta, p, Sp);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  using hopper::make_map;
  CUtensorMap tq, tk, tv, tdo, taux, tq2, tk2, tv2, tdo2;
  const cuuint64_t aux_dims[4] = {(cuuint64_t)Sp, 2, (cuuint64_t)p.H, (cuuint64_t)p.B};
  const cuuint64_t aux_strides[3] = {(cuuint64_t)Sp * 4, (cuuint64_t)Sp * 8,
                                     (cuuint64_t)p.H * Sp * 8};
  const cuuint32_t aux_box[4] = {(cuuint32_t)K::BQ, 2, 1, 1};
  if (!make_map(&tq, half, a.q, p.B, p.S, p.H, D, p.q_sb, p.q_ss, p.q_sh, K::BQ) ||
      !make_map(&tdo, half, a.dout, p.B, p.S, p.H, D, p.do_sb, p.do_ss, p.do_sh, K::BQ) ||
      !make_map(&tk, half, a.k, p.B, p.S, p.KV, D, p.k_sb, p.k_ss, p.k_sh, K::BK) ||
      !make_map(&tv, half, a.v, p.B, p.S, p.KV, D, p.v_sb, p.v_ss, p.v_sh, K::BK) ||
      !hopper::make_map_4d(&taux, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, a.delta, aux_dims,
                           aux_strides, aux_box, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !make_map(&tq2, half, a.q, p.B, p.S, p.H, D, p.q_sb, p.q_ss, p.q_sh, Q::BQ) ||
      !make_map(&tdo2, half, a.dout, p.B, p.S, p.H, D, p.do_sb, p.do_ss, p.do_sh, Q::BQ) ||
      !make_map(&tk2, half, a.k, p.B, p.S, p.KV, D, p.k_sb, p.k_ss, p.k_sh, Q::BK) ||
      !make_map(&tv2, half, a.v, p.B, p.S, p.KV, D, p.v_sb, p.v_ss, p.v_sh, Q::BK)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err;
  {
    auto kern = flash_bwd_dkv_wgmma<T, D>;
    if ((err = allow_smem(kern, K::SMEM)) != cudaSuccess) return err;
    const int n_items = (p.S + K::BK - 1) / K::BK * p.B * p.KV;
    kern<<<(unsigned)std::min(n_items, hopper::sm_count()), K::NT, K::SMEM, s>>>(
        tq, tk, tv, tdo, taux, static_cast<T*>(a.dk), static_cast<T*>(a.dv), p, n_items);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  {
    auto kern = flash_bwd_dq_wgmma<T, D>;
    if ((err = allow_smem(kern, Q::SMEM)) != cudaSuccess) return err;
    const int n_items = (p.S + Q::BQ - 1) / Q::BQ * p.B * p.H;
    kern<<<(unsigned)std::min(n_items, hopper::sm_count()), Q::NT, Q::SMEM, s>>>(
        tq2, tk2, tv2, tdo2, a.delta, static_cast<T*>(a.dq), p, Sp, n_items);
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
    case 1:
      if constexpr (D <= 128) return launch_wgmma<__half, D>(a, p, s);
      else return launch_mma<__half, D>(a, p, s);
    case 2:
      if constexpr (D <= 128) return launch_wgmma<__nv_bfloat16, D>(a, p, s);
      else return launch_mma<__nv_bfloat16, D>(a, p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 float32, 1 float16, 2 bfloat16 (every tensor operand but
// lse and delta shares it). q/k/v/o/dO strided as documented in the common
// header; lse [B, H, S] f32 contiguous; delta f32 scratch of B * H * 2 * Sp
// floats, Sp = S rounded up to a multiple of 4 (written here: [B, H, S] on
// the fp32 and D256 paths, [B, H, 2, Sp] lse in log2 units and delta on the
// TMA path);
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
