// Flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas kernels deepspeed_tpu/ops/pallas/flash_attention.py
// _fwd_kernel (pallas_call :262, entries _fwd :282 and _fwd_bse :913) and
// _fwd_grid_kernel (pallas_call :643, entry _fwd_grid :633): causal or
// full online-softmax attention with an optional sliding window and GQA,
// o [B, S, H, D] in q's dtype plus the per-row log-sum-exp lse [B, H, S]
// f32 that the backward recomputes P from. The TPU needed two variants
// (whole K/V resident in VMEM up to 4 MB, else K/V blocked over the grid);
// here one kernel streams K/V through shared memory at any length.
//
// What bounds it on the card: its flops, then its exponentials. At the
// training shape (B8 H16 S1024 D64 bf16, causal) one call does 2 * 2 *
// B*H*S*S/2*D = 17.2 GFLOP against 67 MB of q/k/v/o, ~255 flops a byte,
// near the H100's bf16 ridge (~295): 0.017 ms at 989 TFLOP/s against 0.020
// ms at 3.35 TB/s. Only wgmma reaches the tensor cores' rate (mma.sync
// tops out near a third of it). At D64 each (query, key) pair is 4*D = 256
// flops and one exp2: at 989 TFLOP/s that is ~3.9 T exponentials a second,
// about all the SMs' MUFU units give, so softmax that does not overlap the
// products caps the kernel near half the tensor-core rate.
//
// What this design does about it (bf16/fp16, D 64 and 128; FlashAttention-
// 3's shape):
//  - persistent: min(items, SMs) blocks of three warpgroups, an item being
//    a tile of BQ = 128 queries of one (batch, head); items are dealt in
//    rounds, heaviest (last) query tiles first, every other round in
//    reverse, so the blocks' causal work evens out;
//  - a producer warp loads Q and K/V tiles of BK = 128 keys with TMA
//    (tensor maps built on the host through the runtime's driver entry
//    point, so the library links no libcuda) into a ring of stages that
//    runs on across items, each load completing on an mbarrier with its
//    byte count; rows past S arrive zero-filled. At D64 the next item's Q
//    loads into a second buffer while this one runs;
//  - two consumer warpgroups each own 64 query rows: S = Q K^T by wgmma
//    with both operands in shared memory (128-byte swizzled, as TMA wrote
//    them), the online softmax in registers (log2 units: one FFMA and one
//    ex2 an element, max and sum as trees, the mask as selects on the
//    tiles that cross it, O rescaled only when a row's max moved), then
//    O += P V by wgmma with P from registers (rounded to the storage
//    dtype, the accumulator's n8 tiles reused as A fragments) and V through
//    the transposed-B form. m, l and O stay in registers;
//  - the warpgroups ping-pong on named barriers: each issues its S_j and
//    its previous tile's P V in its turn and hands the tensor cores to the
//    other, and runs its softmax of S_j while its P V is in flight; a stage
//    goes back to the producer (an mbarrier arrival per warpgroup) once its
//    last product has completed, Q once its last S has;
//  - setmaxnreg moves registers from the producer (40) to the consumers
//    (232); at D64 O goes out through shared memory by TMA stores.
// D 256 keeps the mma.sync design (below: mma.sync m16n8k16 from ldmatrix
// fragments, a double-buffered cp.async ring, 4 or 8 warps over 64
// queries): its 64 x 256 f32 accumulator a warpgroup leaves no room for S
// beside it at BK = 128. fp32 runs on the FMA pipes (no tensor-core path
// keeps fp32 exact): 32 queries a block, lane j of a warp owns key j of a
// 32-key chunk for the scores and D/32 output columns for the sum.
// What it does not do yet: the products and the softmax overlap less than
// the ping-pong intends (at the training shape each alone takes 65-85% of
// the whole); an item's first S and last P V run without the other
// product beside them; on a causal diagonal tile the first warpgroup
// computes the 64 keys past its rows and masks them.
//
// Ragged S: rows and keys past S are zero-filled in shared memory (TMA's
// out-of-bounds fill on the wgmma path) and masked; nothing past S is
// written.

#include <cuda.h>

#include <algorithm>
#include <type_traits>

#include "flash_attention_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;

template <typename T, int D>
struct FwdCfg {
  static constexpr int DSPLIT = D > 128 ? 2 : 1;  // warps sharing a row group
  static constexpr int RG = 4;                     // row groups of 16 queries
  static constexpr int NW = RG * DSPLIT;
  static constexpr int NT = NW * 32;
  static constexpr int BQ = 16 * RG;
  static constexpr int BK = 64;
  static constexpr int LD = D + 8;  // padded row: the fragment reads hit distinct banks
  static constexpr int DC = D / DSPLIT;
  static constexpr size_t SMEM = (size_t)(BQ + 4 * BK) * LD * sizeof(T);
};

template <typename T, int D>
__global__ void __launch_bounds__(FwdCfg<T, D>::NT)
flash_fwd_mma(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ o, float* __restrict__ lse, const Params p) {
  using C = FwdCfg<T, D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + C::BQ * C::LD;      // two buffers of BK rows
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

  const T* qb = q + b * p.q_sb + h * p.q_sh;
  const T* kb = k + b * p.k_sb + kvh * p.k_sh;
  const T* vb = v + b * p.v_sb + kvh * p.v_sh;

  const int nk = (p.S + C::BK - 1) / C::BK;
  int lo = 0, hi = nk;
  if (p.causal) {
    hi = min((q0 + C::BQ + C::BK - 1) / C::BK, nk);
    if (p.window > 0) lo = max(0, q0 - p.window + 1) / C::BK;
  }

  load_rows_async<T, C::BQ, D, C::LD, C::NT>(Qs, qb, p.q_ss, q0, p.S, tid);
  load_rows_async<T, C::BK, D, C::LD, C::NT>(Ks, kb, p.k_ss, lo * C::BK, p.S, tid);
  load_rows_async<T, C::BK, D, C::LD, C::NT>(Vs, vb, p.v_ss, lo * C::BK, p.S, tid);
  cp_async_commit();

  const int row[2] = {q0 + rg * 16 + g, q0 + rg * 16 + g + 8};
  // scores and the running max m in log2 units: exp2 is one SFU op
  const float scale2 = p.scale * kLog2e;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  float acc[C::DC / 8][4];
#pragma unroll
  for (int n = 0; n < C::DC / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

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

    // s = q k^T for this warp's 16 rows and the tile's 64 keys
    float s[C::BK / 8][4];
#pragma unroll
    for (int n = 0; n < C::BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4];
      load_a<T, C::LD>(a, Qs, rg * 16, kk, lane);
#pragma unroll
      for (int n = 0; n < C::BK / 8; n += 2) {
        uint32_t bb[4];
        load_b_rows<T, C::LD>(bb, Kt, n * 8, kk, lane);
        mma16816<T>(s[n], a, bb);
        mma16816<T>(s[n + 1], a, bb + 2);
      }
    }

    // scale (to log2 units), mask, online softmax (rows row[0], row[1])
    const int c0 = j * C::BK;
    const bool full = all_kept(q0 + rg * 16, q0 + rg * 16 + 15, c0, c0 + C::BK - 1, p);
    float tmax[2] = {kMasked, kMasked};
#pragma unroll
    for (int n = 0; n < C::BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + n * 8 + 2 * t + (e & 1);
        const float x = full || keep(row[e >> 1], col, p) ? s[n][e] * scale2 : kMasked;
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
    for (int n = 0; n < C::BK / 8; ++n) {
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
    for (int n = 0; n < C::DC / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // acc += P v, P rounded to the storage dtype (this warp's DC columns)
#pragma unroll
    for (int kk = 0; kk < C::BK / 16; ++kk) {
      uint32_t a[4];
      a_from_c<T>(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < C::DC / 8; n += 2) {
        uint32_t bb[4];
        load_b_cols<T, C::LD>(bb, Vt, kk * 16, part * C::DC + n * 8, lane);
        mma16816<T>(acc[n], a, bb);
        mma16816<T>(acc[n + 1], a, bb + 2);
      }
    }
    __syncthreads();  // this buffer is consumed before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= p.S) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    if (part == 0 && t == 0) {
      lse[((long long)b * p.H + h) * p.S + row[i]] = m[i] * kLn2 + logf(lc);
    }
    T* orow = o + b * p.o_sb + row[i] * p.o_ss + h * p.o_sh + part * C::DC + 2 * t;
#pragma unroll
    for (int n = 0; n < C::DC / 8; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack2<T>(acc[n][2 * i] / lc, acc[n][2 * i + 1] / lc);
    }
  }
}

// ---- fp32: FMA pipes -------------------------------------------------------

template <int D>
struct FwdCfg32 {
  static constexpr int NW = 4;
  static constexpr int QW = 8;  // queries a warp owns
  static constexpr int BQ = NW * QW;
  static constexpr int NT = NW * 32;
  static constexpr int NK = 32;  // keys per chunk, one a lane
  static constexpr int KLD = D + 1;
  static constexpr size_t SMEM = (size_t)(BQ * D + 2 * NK * KLD) * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(FwdCfg32<D>::NT)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
              const Params p) {
  using C = FwdCfg32<D>;
  constexpr int E = D / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + C::BQ * D;
  float* Vs = Ks + C::NK * C::KLD;

  const int nq = (p.S + C::BQ - 1) / C::BQ;
  const int qt = nq - 1 - (int)(blockIdx.x % nq);
  const int bh = blockIdx.x / nq;
  const int h = bh % p.H;
  const int b = bh / p.H;
  const int kvh = h / p.rep;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = qt * C::BQ;
  const float* kb = k + b * p.k_sb + kvh * p.k_sh;
  const float* vb = v + b * p.v_sb + kvh * p.v_sh;

  int lo = 0, hi = p.S;  // keys [lo, hi)
  if (p.causal) {
    hi = min(q0 + C::BQ, p.S);
    if (p.window > 0) lo = max(0, q0 - p.window + 1) / C::NK * C::NK;
  }
  load_rows_f32<C::BQ, D, D, C::NT>(Qs, q + b * p.q_sb + h * p.q_sh, p.q_ss, q0, p.S, tid);

  float m[C::QW], l[C::QW], acc[C::QW][E];
#pragma unroll
  for (int i = 0; i < C::QW; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
  }
  const float* qw = Qs + warp * C::QW * D;

  for (int s0 = lo; s0 < hi; s0 += C::NK) {
    __syncthreads();
    load_rows_f32<C::NK, D, C::KLD, C::NT>(Ks, kb, p.k_ss, s0, p.S, tid);
    load_rows_f32<C::NK, D, C::KLD, C::NT>(Vs, vb, p.v_ss, s0, p.S, tid);
    __syncthreads();
    float sc[C::QW];
#pragma unroll
    for (int i = 0; i < C::QW; ++i) sc[i] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kk = Ks[lane * C::KLD + d];
#pragma unroll
      for (int i = 0; i < C::QW; ++i) sc[i] = fmaf(qw[i * D + d], kk, sc[i]);
    }
    const int key = s0 + lane;
    float pr[C::QW];
#pragma unroll
    for (int i = 0; i < C::QW; ++i) {
      const int r = q0 + warp * C::QW + i;
      const float x = keep(r, key, p) ? sc[i] * p.scale : kMasked;
      const float mn = fmaxf(m[i], warp_max(x));
      const float corr = expf(m[i] - mn);
      pr[i] = expf(x - mn);
      l[i] = l[i] * corr + warp_sum(pr[i]);
      m[i] = mn;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] *= corr;
    }
#pragma unroll 4
    for (int jj = 0; jj < C::NK; ++jj) {
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
    if (r >= p.S) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    float* orow = o + b * p.o_sb + r * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int e = 0; e < E; ++e) orow[lane + 32 * e] = acc[i][e] / lc;
    if (lane == 0) lse[((long long)b * p.H + h) * p.S + r] = m[i] + logf(lc);
  }
}

// ---- bf16/fp16 at D 64 and 128: TMA, wgmma, warp specialisation ------------

template <typename T, int D>
struct WgCfg {
  static constexpr int BQ = 128;             // 2 consumer warpgroups x 64 rows
  static constexpr int BK = 128;             // keys a tile
  // D64: 4 K/V stages, two Q buffers (the next item's Q loads during this
  // one) and O staged in shared memory for a TMA store (177 KB); D128: 3
  // stages and one Q buffer fill 225 KB of the 227, O is stored from
  // registers
  static constexpr int STAGES = D == 64 ? 4 : 3;
  static constexpr int NQ = D == 64 ? 2 : 1;
  static constexpr bool O_TMA = D == 64;
  static constexpr int NT = 384;             // producer + 2 consumer warpgroups
  static constexpr int ATOMS = D / 64;       // 128-byte column atoms a row
  static constexpr uint32_t Q_BYTES = BQ * D * 2;
  static constexpr uint32_t T_BYTES = BK * D * 2;  // one K or V tile
  static constexpr uint32_t O_BYTES = O_TMA ? BQ * D * 2 : 0;
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = 232;
  // 1024 bytes of slack to align the tiles; Q, the stages, O, the barriers
  static constexpr size_t SMEM = 1024 + NQ * Q_BYTES + (size_t)STAGES * 2 * T_BYTES + O_BYTES +
                                 8 * (2 * NQ + 2 * STAGES);
};

constexpr int kTurnBar = 8;   // named barriers kTurnBar + w: consumer w's turn
constexpr int kWgBar = 10;    // named barriers kWgBar + w: consumer w alone

// the consumers' turns on the tensor cores (both warpgroups, 256 threads)
__device__ __forceinline__ void turn_wait(int bar) { hopper::named_sync(bar, 256); }
__device__ __forceinline__ void turn_pass(int bar) { hopper::named_arrive(bar, 256); }

// S = Q K^T for the warpgroup's 64 rows and a tile of BK keys: D / 16 k16
// steps, both operands K-major in 128-byte swizzled atoms of 128 rows
template <typename T, int D, int BK>
__device__ __forceinline__ void issue_s(float (&s)[BK / 2], uint32_t q_addr, uint32_t k_addr) {
  using namespace hopper;
  fence_regs(s);
  wgmma_fence();
  issue_ss<T, D, BK>(s, q_addr, 128 * 128, k_addr, BK * 128);
  wgmma_commit();
  fence_regs(s);
}

// O += P V: BK / 16 k16 steps, P's A fragments from registers, V MN-major
template <typename T, int D, int BK>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2], uint32_t (&pa)[BK / 16][4],
                                         uint32_t v_addr) {
  using namespace hopper;
  fence_regs(acc);
  fence_regs(pa);
  wgmma_fence();
  issue_rs<T, D, BK>(acc, pa, v_addr);
  wgmma_commit();
  fence_regs(acc);
  fence_regs(pa);
}

// the online softmax of this thread's rows row0 (elements 4n, 4n+1) and
// row0 + 8 (4n+2, 4n+3) over keys c0 .. c0 + BK - 1, on the raw scores s:
// masked scores become -inf (only where the tile is not wholly kept), the
// running max m is kept in log2 units (scale2 = sm_scale * log2 e > 0, so
// the max of the raw scores scales to the max of the scaled ones), and s
// becomes P = exp2(s * scale2 - m) by one FFMA and one ex2 an element;
// corr is the factor for the accumulator; l is per lane (quad-summed at the
// end). Fully masked rows keep m at its start value and add nothing.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], bool whole, int c0, int row0,
                                             int t, float scale2, const Params& p) {
  if (!whole) {
    // row r keeps the keys [lo_r, hi_r]: two compares and a select each
    int lo_r[2], hi_r[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      hi_r[i] = row >= p.S ? -1 : (p.causal ? min(row, p.S - 1) : p.S - 1);
      lo_r[i] = p.causal && p.window > 0 ? row - p.window + 1 : 0;
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + n * 8 + 2 * t + (e & 1);
        const bool ok = col >= lo_r[e >> 1] && col <= hi_r[e >> 1];
        s[4 * n + e] = ok ? s[4 * n + e] : -INFINITY;
      }
    }
  }
  float mx[2][BK / 8];
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
    mx[0][n] = fmaxf(s[4 * n + 0], s[4 * n + 1]);
    mx[1][n] = fmaxf(s[4 * n + 2], s[4 * n + 3]);
  }
  float mb[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float mn = fmaxf(m[i], quad_max(tree_max<BK / 8>(mx[i])) * scale2);
    corr[i] = ex2(m[i] - mn);
    m[i] = mn;
    mb[i] = -mn;
  }
  float sum[2][BK / 8];
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[4 * n + e] = ex2(fmaf(s[4 * n + e], scale2, mb[e >> 1]));
    sum[0][n] = s[4 * n + 0] + s[4 * n + 1];
    sum[1][n] = s[4 * n + 2] + s[4 * n + 3];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = fmaf(l[i], corr[i], tree_sum<BK / 8>(sum[i]));
}

// one work item: a tile of BQ queries of one (batch, head), and the K/V
// tiles [lo, hi) it attends
struct Item {
  int b, h, kvh, q0, lo, hi;
};

// item i of the schedule: the heaviest query tiles (the last, under causal
// masking) of every (batch, head) first
template <int BQ, int BK>
__device__ __forceinline__ Item item_at(int i, const Params& p) {
  const int nq = (p.S + BQ - 1) / BQ;
  const int nbh = p.B * p.H;
  Item it;
  const int qt = nq - 1 - i / nbh;
  const int bh = i % nbh;
  it.h = bh % p.H;
  it.b = bh / p.H;
  it.kvh = it.h / p.rep;
  it.q0 = qt * BQ;
  const int nk = (p.S + BK - 1) / BK;
  it.lo = 0;
  it.hi = nk;
  if (p.causal) {
    it.hi = min((it.q0 + BQ + BK - 1) / BK, nk);
    if (p.window > 0) it.lo = max(0, it.q0 - p.window + 1) / BK;
  }
  return it;
}

// persistent: each block walks its items of the schedule; the K/V ring and
// its phases run on across items, so the producer loads the next item's Q
// and first tiles while the consumers finish this one
template <typename T, int D>
__global__ void __launch_bounds__(384, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                T* __restrict__ o, float* __restrict__ lse, const Params p, int n_items) {
  using C = WgCfg<T, D>;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Qs = base;                      // buffer k: ATOMS atoms of BQ x 64
  unsigned char* KVs = base + C::NQ * C::Q_BYTES;  // stage s: K at 2s, V at 2s+1
  unsigned char* Os = KVs + (size_t)C::STAGES * 2 * C::T_BYTES;  // BQ x 64, swizzled
  uint64_t* bars = reinterpret_cast<uint64_t*>(Os + C::O_BYTES);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + C::NQ;
  uint64_t* full = bars + 2 * C::NQ;
  uint64_t* empty = bars + 2 * C::NQ + C::STAGES;

  if (threadIdx.x == 0) {
    for (int k = 0; k < C::NQ; ++k) {
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
    // ---- producer: one thread issues every load --------------------------
    regs_dec<C::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int it = 0;  // K/V tiles loaded, over all items
      for (int r = 0, qi = 0; r * (int)gridDim.x < n_items; ++r) {
        const int i = round_item(r, n_items);
        if (i < 0) continue;
        const Item w = item_at<C::BQ, C::BK>(i, p);
        // the buffer's previous item has had its last S
        const int qb = qi % C::NQ;
        mbar_wait(&q_empty[qb], ((qi / C::NQ) & 1) ^ 1);
        mbar_arrive_tx(&q_full[qb], C::Q_BYTES);
        for (int a = 0; a < C::ATOMS; ++a)
          tma_load_4d(Qs + qb * C::Q_BYTES + a * C::BQ * 128, &tq, &q_full[qb], a * 64, w.h,
                      w.q0, w.b);
        for (int j = w.lo; j < w.hi; ++j, ++it) {
          const int s = it % C::STAGES;
          mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);
          mbar_arrive_tx(&full[s], 2 * C::T_BYTES);
          unsigned char* Kt = KVs + (size_t)(2 * s) * C::T_BYTES;
          unsigned char* Vt = Kt + C::T_BYTES;
          for (int a = 0; a < C::ATOMS; ++a) {
            tma_load_4d(Kt + a * C::BK * 128, &tk, &full[s], a * 64, w.kvh, j * C::BK, w.b);
            tma_load_4d(Vt + a * C::BK * 128, &tv, &full[s], a * 64, w.kvh, j * C::BK, w.b);
          }
        }
        ++qi;
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns query rows q0 + 64 cw .. + 63 -----------
  regs_inc<C::CONSUMER_REGS>();
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3;
  const float scale2 = p.scale * kLog2e;
  const uint32_t kv_addr = smem_addr(KVs);

  float m[2], l[2];
  float acc[D / 2];
  float s[C::BK / 2];
  uint32_t pa[C::BK / 16][4];

  if (cw == 1) turn_pass(kTurnBar + 0);  // consumer 0 goes first
  int it = 0;  // K/V tiles consumed, over all items
  for (int r = 0, qi = 0; r * (int)gridDim.x < n_items; ++r) {
    const int i = round_item(r, n_items);
    if (i < 0) continue;
    const Item w = item_at<C::BQ, C::BK>(i, p);
    const bool last_item = (r + 1) * (int)gridDim.x >= n_items || round_item(r + 1, n_items) < 0;
    const int r0 = w.q0 + cw * 64 + warp * 16;  // this warp's first row
    const int row0 = r0 + (lane >> 2);
    m[0] = m[1] = kMasked;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int k = 0; k < D / 2; ++k) acc[k] = 0.f;
    const int qb = qi % C::NQ;
    const uint32_t q_addr = smem_addr(Qs) + qb * C::Q_BYTES + cw * 64 * 128;
    mbar_wait(&q_full[qb], (qi / C::NQ) & 1);

    // the first tile: S only (no P V pending), so no wgmma is issued or
    // waited for conditionally inside the tile loop
    int st = it % C::STAGES;
    mbar_wait(&full[st], (it / C::STAGES) & 1);
    turn_wait(kTurnBar + cw);
    issue_s<T, D, C::BK>(s, q_addr, kv_addr + (2 * st) * C::T_BYTES);
    if (!(cw == 1 && last_item && w.lo == w.hi - 1)) turn_pass(kTurnBar + (cw ^ 1));
    wgmma_wait<0>();
    fence_regs(s);
    if (w.lo == w.hi - 1 && tid == 0) mbar_arrive(&q_empty[qb]);
    {
      float corr[2];
      const int c0 = w.lo * C::BK;
      softmax_tile<C::BK>(s, m, l, corr, all_kept(r0, r0 + 15, c0, c0 + C::BK - 1, p), c0,
                          row0, t, scale2, p);
    }
    pack_a<T, C::BK>(pa, s);
    ++it;

    for (int j = w.lo + 1; j < w.hi; ++j, ++it) {
      const int prev = st;  // the stage whose V the pending P V reads
      st = it % C::STAGES;
      mbar_wait(&full[st], (it / C::STAGES) & 1);

      // this warpgroup's turn on the tensor cores: S_j, then P_{j-1} V_{j-1}
      turn_wait(kTurnBar + cw);
      issue_s<T, D, C::BK>(s, q_addr, kv_addr + (2 * st) * C::T_BYTES);
      issue_pv<T, D, C::BK>(acc, pa, kv_addr + (2 * prev + 1) * C::T_BYTES);
      if (!(cw == 1 && last_item && j == w.hi - 1)) turn_pass(kTurnBar + (cw ^ 1));
      wgmma_wait<1>();
      fence_regs(s);
      if (j == w.hi - 1 && tid == 0) mbar_arrive(&q_empty[qb]);  // Q's last use has run
      float corr[2];
      const int c0 = j * C::BK;
      softmax_tile<C::BK>(s, m, l, corr, all_kept(r0, r0 + 15, c0, c0 + C::BK - 1, p), c0,
                          row0, t, scale2, p);
      // P_{j-1} V_{j-1} done: the accumulator is ours again, stage prev free
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      if (tid == 0) mbar_arrive(&empty[prev]);
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {  // a max moved
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          acc[4 * n + 0] *= corr[0];
          acc[4 * n + 1] *= corr[0];
          acc[4 * n + 2] *= corr[1];
          acc[4 * n + 3] *= corr[1];
        }
      }
      pack_a<T, C::BK>(pa, s);
    }

    // the last tile's P V; its stage goes back to the producer
    issue_pv<T, D, C::BK>(acc, pa, kv_addr + (2 * st + 1) * C::T_BYTES);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    if (tid == 0) mbar_arrive(&empty[st]);

    float inv[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row0 + 8 * hr;
      const float lc = fmaxf(quad_sum(l[hr]), 1e-30f);
      inv[hr] = 1.f / lc;
      if (t == 0 && row < p.S)
        lse[((long long)w.b * p.H + w.h) * p.S + row] = m[hr] * kLn2 + logf(lc);
    }
    if constexpr (C::O_TMA) {
      // O through shared memory (the 128-byte swizzle: a quad's 4-byte
      // writes of 8 rows hit distinct banks) and one TMA store a warpgroup;
      // rows past S are clipped by the store
      unsigned char* ot = Os + cw * 64 * 128;
      if (tid == 0) bulk_wait_read();  // this buffer's previous store has read it
      named_sync(kWgBar + cw, 128);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int rl = warp * 16 + (lane >> 2) + 8 * hr;  // row within the warpgroup's 64
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          *reinterpret_cast<uint32_t*>(ot + rl * 128 + ((n ^ (rl & 7)) << 4) + 4 * t) =
              pack2<T>(acc[4 * n + 2 * hr] * inv[hr], acc[4 * n + 2 * hr + 1] * inv[hr]);
        }
      }
      fence_async_smem();
      named_sync(kWgBar + cw, 128);
      if (tid == 0) {
        tma_store_4d(&to, ot, 0, w.h, w.q0 + cw * 64, w.b);
        bulk_commit();
      }
    } else {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = row0 + 8 * hr;
        if (row >= p.S) continue;
        T* orow = o + w.b * p.o_sb + row * p.o_ss + w.h * p.o_sh + 2 * t;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          *reinterpret_cast<uint32_t*>(orow + n * 8) =
              pack2<T>(acc[4 * n + 2 * hr] * inv[hr], acc[4 * n + 2 * hr + 1] * inv[hr]);
        }
      }
    }
    ++qi;
  }
  if constexpr (C::O_TMA) {
    if (tid == 0) bulk_wait();  // the last store is done before the block exits
  }
}

using hopper::make_map;
using hopper::sm_count;

template <typename T, int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse,
                         const Params& p, cudaStream_t stream) {
  using C = WgCfg<T, D>;
  constexpr bool half = std::is_same<T, __half>::value;
  CUtensorMap tq, tk, tv, to;
  if (!make_map(&tq, half, q, p.B, p.S, p.H, D, p.q_sb, p.q_ss, p.q_sh, C::BQ) ||
      !make_map(&tk, half, k, p.B, p.S, p.KV, D, p.k_sb, p.k_ss, p.k_sh, C::BK) ||
      !make_map(&tv, half, v, p.B, p.S, p.KV, D, p.v_sb, p.v_ss, p.v_sh, C::BK) ||
      (C::O_TMA && !make_map(&to, half, o, p.B, p.S, p.H, D, p.o_sb, p.o_ss, p.o_sh, 64))) {
    return cudaErrorInvalidValue;
  }
  if (!C::O_TMA) to = tq;  // unused
  auto kern = flash_fwd_wgmma<T, D>;
  cudaError_t err = allow_smem(kern, C::SMEM);
  if (err != cudaSuccess) return err;
  const int n_items = p.B * p.H * ((p.S + C::BQ - 1) / C::BQ);
  const int grid = std::min(n_items, sm_count());
  kern<<<grid, C::NT, C::SMEM, stream>>>(tq, tk, tv, to, static_cast<T*>(o), lse, p, n_items);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   const Params& p, cudaStream_t stream) {
  using C = FwdCfg<T, D>;
  auto kern = flash_fwd_mma<T, D>;
  cudaError_t err = allow_smem(kern, C::SMEM);
  if (err != cudaSuccess) return err;
  const int nq = (p.S + C::BQ - 1) / C::BQ;
  kern<<<(unsigned)(p.B * p.H * nq), C::NT, C::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, float* lse,
                       const Params& p, cudaStream_t stream) {
  using C = FwdCfg32<D>;
  auto kern = flash_fwd_f32<D>;
  cudaError_t err = allow_smem(kern, C::SMEM);
  if (err != cudaSuccess) return err;
  const int nq = (p.S + C::BQ - 1) / C::BQ;
  kern<<<(unsigned)(p.B * p.H * nq), C::NT, C::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_dtype(int dtype, const void* q, const void* k, const void* v, void* o,
                           float* lse, const Params& p, cudaStream_t s) {
  switch (dtype) {
    case 0: return launch_f32<D>(q, k, v, o, lse, p, s);
    case 1:
      if constexpr (D <= 128) return launch_wgmma<__half, D>(q, k, v, o, lse, p, s);
      else return launch<__half, D>(q, k, v, o, lse, p, s);
    case 2:
      if constexpr (D <= 128) return launch_wgmma<__nv_bfloat16, D>(q, k, v, o, lse, p, s);
      else return launch<__nv_bfloat16, D>(q, k, v, o, lse, p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 float32, 1 float16, 2 bfloat16 (q, k, v and o share it).
// o is [B, S, H, D] with strides o_*; lse is [B, H, S] f32 contiguous.
// Returns the CUDA error of the launch (0 on success), cudaErrorInvalidValue
// for shapes the kernel does not take. Asynchronous on `stream`.
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* o, void* lse, int B, int S, int H, int KV,
    int D, long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, int causal, int window, float sm_scale, int dtype,
    void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  Params p{};
  p.B = B; p.S = S; p.H = H; p.KV = KV; p.rep = H / KV;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.causal = causal; p.window = window; p.scale = sm_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (D) {
    case 64: return (int)dispatch_dtype<64>(dtype, q, k, v, o, l, p, s);
    case 128: return (int)dispatch_dtype<128>(dtype, q, k, v, o, l, p, s);
    case 256: return (int)dispatch_dtype<256>(dtype, q, k, v, o, l, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
