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
// blocks active, ~79.8M computed pairs) the two products are ~20.4 GFLOP
// against ~34 MB of q/k/v/o/lse: 0.021 ms at 989 TFLOP/s against 0.010 ms
// at 3.35 TB/s. At the BERT shape (B16 S512 H16 D64 bf16, fixed
// bidirectional, block 16, density 0.344) it is bound by bytes instead:
// ~5.9 GFLOP (0.006 ms) against ~68 MB (0.020 ms).
//
// bf16/fp16 at D 64/128 run the TMA + wgmma kernel below at every block on
// the dq kernel's schedule: the forward walks the same tiles as dq (a query
// unit's kidx rows, cut by the causal rule where a tile starts past the
// unit's last query), so the host plan ops/block_sparse_attention.py
// bwd_plan("dq", causal) is the forward's too, and the schedule's decoding,
// the producer's loads and the masks come from
// block_sparse_attention_common.cuh:
//  - persistent: min(items, SMs) blocks of three warpgroups deal the plan's
//    items heaviest first in rounds (the GPT-2 layout lists 1 to 19 key
//    blocks a query block); an item is two 64-row query units of one
//    (batch, head) whose rows share the most tiles;
//  - a unit: at blocks of 64 and 128, 64 consecutive queries; at 16 and
//    32, up to 64 / blk query blocks whose kidx rows are equal first (BERT's
//    fixed layout: the 4 blocks of a window), short units merged while that
//    costs no more tiles (dkv_group_plan(..., "dq")); a tile is 64
//    consecutive keys, or 64 / blk key blocks of the union of the unit's
//    lists under a mask bit per (query block, key block);
//  - a producer warp loads by TMA the item's 128 query rows once, into one
//    of two buffers (the next item's while this one runs), and streams the
//    K and V tiles of the item's entries, two 64-row tiles a step at D64
//    and one at D128, through a ring of stages that runs on across items;
//    blocks that are consecutive go as one 64-row box, others a box each;
//  - consumer warpgroup c owns unit c's 64 queries: S = Q K^T by wgmma from
//    shared memory, the online softmax in registers (log2 units on exp2, O
//    rescaled only when a row's max moved), O += P V by wgmma with P as a
//    register A operand rounded to the storage dtype and V through the
//    transposed-B form; S of a step is issued beside the previous step's
//    P V, so the softmax runs while P V is on the tensor cores, and the two
//    warpgroups take turns on the tensor cores (named barriers), as in the
//    flash forward: one's products run while the other's softmax does.
//    m, l and O stay in registers over the item; O goes out once through
//    shared memory by TMA stores (a warpgroup's 64 rows, or on the grouped
//    plan a warp's 16 rows of one query block), lse by the quad's first
//    lane; each row is stored by the one warp that owns it (no atomics: the
//    result repeats bit for bit);
//  - the mask (a tile or block the warp's query block does not walk, a
//    padding slot: -inf and no change of max; the causal rule) as compares
//    against per-row limits under one warp-uniform branch that steps with
//    nothing masked skip;
//  - q, k and v stay strided views of GPT-2's [B, S, 3E] projection, read
//    through tensor maps.
// An item none of whose rows walks a tile streams one tile that neither
// unit walks, so every item has a first step and no wgmma is issued or
// waited for in a branch. fp32 runs the same walk on the FMA pipes (no
// tensor-core path keeps fp32 exact): units of min(blk, 32) rows, 8 a warp,
// lane j owning key j of a chunk of min(blk, 32) keys for the scores and
// D/32 output columns for the sum. Which kernel a call takes is a rule on
// dtype and head dim alone (the wrapper's wgmma_route); a call never falls
// back from one to another.
//
// What holds it back (tools/kernel_ablation.py, H100 80GB HBM3 at 700 W):
// at the GPT-2 shape it takes ~0.075 ms, ~0.066 without the exponentials,
// ~0.070 without its O and lse stores, ~0.085 without the warpgroups'
// turns; an item is ~5 steps, and its first S and last P V run with no
// product of the same warpgroup beside them. At the BERT shape (4 items a
// head, 18 tiles, ~2.5 steps an item) it takes ~0.049 ms, where the
// mma.sync kernel it replaced (one 16-row query block a unit, K/V tiles by
// cp.async) took ~0.090: ~0.045 without its stores or its P V, ~0.0475
// without the exponentials, and the producer alone (the consumers handing
// each stage straight back) ~0.030, as at the GPT-2 shape with 2.5 times
// the bytes: the per-item loads of short items set the pace, and one box
// a tile instead of one a block cuts that only by ~0.005. A deeper ring, a
// third Q buffer, the boxes issued from 16 lanes and items ordered by head
// did not move it.

#include <cuda.h>

#include <algorithm>
#include <type_traits>

#include "block_sparse_attention_common.cuh"

namespace {

using namespace bsparse;

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

// ---- bf16/fp16 at D 64/128, every block: TMA, wgmma, warp specialisation

// the forward's ring: deeper than dq's at D128 (no dO beside Q)
constexpr int kFwdStages = 4;

template <typename T, int D, int G>
constexpr size_t fwd_smem() {
  using W = WgCfg<T, D>;
  // 1024 bytes of slack to align the tiles; two buffers of the item's Q,
  // the two warpgroups' O tiles (staged for TMA stores), the K and V
  // stages, the stages' tile entries (G ints a tile), the barriers: 225 KB
  // at D128
  return 1024 + 3 * (size_t)W::PAIR_BYTES + (size_t)kFwdStages * 2 * W::STEP_BYTES +
         (kFwdStages * W::P * G + 2) * 4 + 8 * (4 + 2 * kFwdStages);
}

// the entries of a tile that neither unit walks (block or row 0, no bit;
// the grouped plan's other slots padding): an item with no tiles streams
// it, so every item has a first step
__device__ const int kNoTile[4] = {0, -1, -1, -1};

__device__ __forceinline__ Item fwd_item(int i, const int* __restrict__ plan, int n_pairs,
                                         const BsParams& p) {
  Item w = plan_item(i, plan, n_pairs, p);
  if (w.n == 0) {
    w.tiles = kNoTile;
    w.n = 1;
  }
  return w;
}

template <int G>
__device__ __forceinline__ GroupItem fwd_group_item(int i, const int* __restrict__ plan,
                                                    int n_pairs, const BsParams& p) {
  GroupItem w = group_item<G>(i, plan, n_pairs, p);
  if (w.n == 0) {
    w.tiles = kNoTile;
    w.n = 1;
  }
  return w;
}

// the online softmax of one step for the thread's rows row0 (elements 4n,
// 4n+1) and row0 + 8 (4n+2, 4n+3) on the raw scores s of the step's TN
// keys, the masked ones already -inf (mask_keys): the running max m is kept
// in log2 units (scale2 = sm_scale * log2 e > 0), and s becomes P =
// exp2(s * scale2 - m); corr is the accumulator's factor, l is per lane
// (quad-summed at the end). A row with nothing kept yet keeps m at -1e30
// and adds p = 0.
template <int TN>
__device__ __forceinline__ void softmax_step(float (&s)[TN / 2], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], float scale2) {
  float mx[2][TN / 8];
#pragma unroll
  for (int n = 0; n < TN / 8; ++n) {
    mx[0][n] = fmaxf(s[4 * n + 0], s[4 * n + 1]);
    mx[1][n] = fmaxf(s[4 * n + 2], s[4 * n + 3]);
  }
  float mb[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float mn = fmaxf(m[i], quad_max(tree_max<TN / 8>(mx[i])) * scale2);
    corr[i] = ex2(m[i] - mn);
    m[i] = mn;
    mb[i] = -mn;
  }
  float sum[2][TN / 8];
#pragma unroll
  for (int n = 0; n < TN / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[4 * n + e] = ex2(fmaf(s[4 * n + e], scale2, mb[e >> 1]));
    sum[0][n] = s[4 * n + 0] + s[4 * n + 1];
    sum[1][n] = s[4 * n + 2] + s[4 * n + 3];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = fmaf(l[i], corr[i], tree_sum<TN / 8>(sum[i]));
}

// S = Q K^T for the warpgroup's 64 rows and a step's TN keys
template <typename T, int D, int TN>
__device__ __forceinline__ void issue_s(float (&s)[TN / 2], uint32_t q_addr, uint32_t k_addr) {
  using namespace hopper;
  fence_regs(s);
  wgmma_fence();
  issue_ss<T, D, TN>(s, q_addr, 2 * kRows * 128, k_addr, TN * 128);
  wgmma_commit();
  fence_regs(s);
}

// O += P V over a step's TN keys: P's A fragments from registers, V MN-major
template <typename T, int D, int TN>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2], uint32_t (&pa)[TN / 16][4],
                                         uint32_t v_addr) {
  using namespace hopper;
  fence_regs(acc);
  fence_regs(pa);
  wgmma_fence();
  issue_rs<T, D, TN>(acc, pa, v_addr);
  wgmma_commit();
  fence_regs(acc);
  fence_regs(pa);
}

constexpr int kTurnBar = 8;   // named barriers kTurnBar + w: consumer w's turn
constexpr int kWgBar = 10;    // named barriers kWgBar + w: consumer w alone

// the consumers' turns on the tensor cores (both warpgroups, 256 threads)
__device__ __forceinline__ void turn_wait(int bar) { hopper::named_sync(bar, 256); }
__device__ __forceinline__ void turn_pass(int bar) { hopper::named_arrive(bar, 256); }

// persistent over the dq plan's items, dealt heaviest first in rounds. The
// producer warp loads each item's Q (its two units' 64 rows) into one of
// two buffers and streams the K and V tiles of its entries, P a step;
// consumer warpgroup c owns unit c's queries.
//
// BLK 64 takes blocks of 64 and 128 (a unit is 64 consecutive queries, a
// tile 64 consecutive keys: bwd_plan), O goes out through shared memory by
// a warpgroup's TMA stores of 64-row boxes. BLK 16 and 32 take the query
// side's grouped plan (dkv_group_plan(..., "dq")): a unit is up to G = 64 /
// BLK query blocks (those with equal key lists first), loaded by
// load_group (BERT's 4 blocks of a window as one 64-row box through tq,
// others a block a box through tqb); a tile is G key blocks of the union
// of their lists, one 64-row box through tk / tv when they are
// consecutive, else a block a box through tkb / tvb. A warp's 16 queries
// lie in one query block, so a tile entry's bit for that block masks a key
// block the warp does not list, as a padding slot and a pair the causal
// rule drops are masked (-inf); a warp stores its own 16 rows of O (a
// 16-row TMA box through `to`) and lse, a padding warp nothing
template <typename T, int D, int BLK>
__global__ void __launch_bounds__(384, 1)
bs_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
             const __grid_constant__ CUtensorMap tqb, const __grid_constant__ CUtensorMap tkb,
             const __grid_constant__ CUtensorMap tvb, const int* __restrict__ plan, int n_pairs,
             float* __restrict__ lse, const BsParams p, int n_items) {
  using W = WgCfg<T, D>;
  constexpr int G = kRows / BLK;  // query blocks a unit, key blocks a tile (1: blocks 64/128)
  constexpr int TN = W::TN, P = W::P, STAGES = kFwdStages;
  constexpr int QB = 2;  // buffers of an item's Q
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Qs = base;                                   // buffer k at k * PAIR_BYTES
  unsigned char* Os = Qs + QB * W::PAIR_BYTES;                // warpgroup c at c * SUB_BYTES
  unsigned char* Ks = Os + W::PAIR_BYTES;                     // stage s at s * STEP_BYTES
  unsigned char* Vs = Ks + (size_t)STAGES * W::STEP_BYTES;    // V, the same
  int* entries = reinterpret_cast<int*>(Vs + (size_t)STAGES * W::STEP_BYTES);  // [s][tile][G]
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(entries + STAGES * P * G + (STAGES * P * G) % 2);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + QB;
  uint64_t* full = bars + 2 * QB;
  uint64_t* empty = full + STAGES;

  if (threadIdx.x == 0) {
    for (int k = 0; k < QB; ++k) {
      mbar_init(&q_full[k], 1);
      mbar_init(&q_empty[k], 2);
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: warp 0 reads the entries, its lane 0 issues every load --
    regs_dec<W::PRODUCER_REGS>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    int it = 0;  // steps loaded, over all items
    for (int r = 0, ki = 0; r * (int)gridDim.x < n_items; ++r) {
      const int i = round_item(r, n_items);
      if (i < 0) continue;
      const int qb = ki % QB;
      unsigned char* Qt = Qs + (size_t)qb * W::PAIR_BYTES;
      if constexpr (G == 1) {
        const Item w = fwd_item(i, plan, n_pairs, p);
        if (lane == 0) {
          mbar_wait(&q_empty[qb], ((ki / QB) & 1) ^ 1);
          mbar_arrive_tx(&q_full[qb], W::PAIR_BYTES);
          load_pair<W::ATOMS>(Qt, &tq, &q_full[qb], w);
        }
        stream_steps<P, STAGES>(w, lane, empty, entries, it, [&](int s, const int (&row)[P]) {
          mbar_arrive_tx(&full[s], 2 * W::STEP_BYTES);
          load_tiles<P, W::ATOMS>(Ks + (size_t)s * W::STEP_BYTES, &tk, &full[s], w, row);
          load_tiles<P, W::ATOMS>(Vs + (size_t)s * W::STEP_BYTES, &tv, &full[s], w, row);
        });
      } else {
        const GroupItem w = fwd_group_item<G>(i, plan, n_pairs, p);
        if (lane == 0) {
          mbar_wait(&q_empty[qb], ((ki / QB) & 1) ^ 1);
          mbar_arrive_tx(&q_full[qb], W::PAIR_BYTES);
          load_group<W::ATOMS, BLK>(Qt, &tq, &tqb, &q_full[qb], w);
        }
        stream_group<P, STAGES, G>(w, lane, empty, entries, it, [&](int s, const int (&t)[P][G]) {
          mbar_arrive_tx(&full[s], 2 * W::STEP_BYTES);
#pragma unroll
          for (int q = 0; q < P; ++q) {
            int kb[G];
            const bool run = tile_blocks<G>(t[q], kb);
            load_group_tile<P, W::ATOMS, BLK, G>(Ks + (size_t)s * W::STEP_BYTES, &tk, &tkb,
                                                 &full[s], q, run, kb, w.h, w.b);
            load_group_tile<P, W::ATOMS, BLK, G>(Vs + (size_t)s * W::STEP_BYTES, &tv, &tvb,
                                                 &full[s], q, run, kb, w.h, w.b);
          }
        });
      }
      ++ki;
    }
    return;
  }

  // ---- consumers ------------------------------------------------------------
  regs_inc<W::CONSUMER_REGS>();
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3;
  const float scale2 = p.scale * kLog2e;
  const bool causal = p.causal != 0;
  const uint32_t k_base = smem_addr(Ks), v_base = smem_addr(Vs);

  float m[2], l[2];
  float acc[D / 2];
  float s[TN / 2];
  uint32_t pa[TN / 16][4];

  if (cw == 1) turn_pass(kTurnBar + 0);  // consumer 0 goes first
  int it = 0;  // steps consumed, over all items
  for (int r = 0, ki = 0; r * (int)gridDim.x < n_items; ++r) {
    const int i = round_item(r, n_items);
    if (i < 0) continue;
    const bool last_item = (r + 1) * (int)gridDim.x >= n_items || round_item(r + 1, n_items) < 0;
    // the item's batch row, head and tile count; this warp's first query,
    // whether its 16 queries are real rows of this warpgroup's unit, and
    // the bit of its query block in a tile entry's masks
    int ib, ih, n_tiles, rw0, kbit = cw, mine0 = 0;
    bool owned;
    if constexpr (G == 1) {
      const Item w = fwd_item(i, plan, n_pairs, p);
      mine0 = cw ? w.r0[1] : w.r0[0];
      owned = mine0 >= 0;
      rw0 = (owned ? mine0 : w.r0[0]) + warp * 16;
      ib = w.b, ih = w.h, n_tiles = w.n;
    } else {
      const GroupItem w = fwd_group_item<G>(i, plan, n_pairs, p);
      const int slot = warp * 16 / BLK;
      const int qblk = __ldg(w.keys + cw * G + slot);
      owned = qblk >= 0;
      rw0 = owned ? qblk * BLK + (warp * 16) % BLK : 0;
      kbit = 4 * cw + slot;
      ib = w.b, ih = w.h, n_tiles = w.n;
    }
    const int row[2] = {rw0 + (lane >> 2), rw0 + (lane >> 2) + 8};
    const int qb = ki % QB;
    const uint32_t q_addr = smem_addr(Qs) + qb * W::PAIR_BYTES + cw * kRows * 128;
    const int nsteps = (n_tiles + P - 1) / P;  // >= 1
    m[0] = m[1] = kMasked;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int k = 0; k < D / 2; ++k) acc[k] = 0.f;
    mbar_wait(&q_full[qb], (ki / QB) & 1);

    // the first step: S only (no P V pending), so no wgmma is issued or
    // waited for conditionally inside the step loop
    int st = it % STAGES;
    mbar_wait(&full[st], (it / STAGES) & 1);
    int koff[P][G], hi[2];
    bool whole =
        query_masks<P, G, BLK>(entries + st * P * G, kbit, owned, causal, row, rw0, koff, hi);
    // this warpgroup's turn on the tensor cores
    turn_wait(kTurnBar + cw);
    issue_s<T, D, TN>(s, q_addr, k_base + st * W::STEP_BYTES);
    if (!(cw == 1 && last_item && nsteps == 1)) turn_pass(kTurnBar + (cw ^ 1));
    wgmma_wait<0>();
    fence_regs(s);
    if (nsteps == 1 && tid == 0) mbar_arrive(&q_empty[qb]);  // Q's last S has run
    float corr[2];
    if (!whole) mask_keys<TN, G>(s, koff, hi, t, -INFINITY);
    softmax_step<TN>(s, m, l, corr, scale2);
    pack_a<T, TN>(pa, s);
    ++it;

    for (int u = 1; u < nsteps; ++u, ++it) {
      const int prev = st;  // the stage whose V the pending P V reads
      st = it % STAGES;
      mbar_wait(&full[st], (it / STAGES) & 1);
      whole =
          query_masks<P, G, BLK>(entries + st * P * G, kbit, owned, causal, row, rw0, koff, hi);
      // S of this step, then the previous step's P V: the softmax below
      // runs while P V is on the tensor cores
      turn_wait(kTurnBar + cw);
      issue_s<T, D, TN>(s, q_addr, k_base + st * W::STEP_BYTES);
      issue_pv<T, D, TN>(acc, pa, v_base + prev * W::STEP_BYTES);
      if (!(cw == 1 && last_item && u == nsteps - 1)) turn_pass(kTurnBar + (cw ^ 1));
      wgmma_wait<1>();
      fence_regs(s);
      if (u == nsteps - 1 && tid == 0) mbar_arrive(&q_empty[qb]);
      if (!whole) mask_keys<TN, G>(s, koff, hi, t, -INFINITY);
      softmax_step<TN>(s, m, l, corr, scale2);
      // P V done: the accumulator is ours again, stage prev free
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
      pack_a<T, TN>(pa, s);
    }

    // the last step's P V; its stage goes back to the producer
    issue_pv<T, D, TN>(acc, pa, v_base + st * W::STEP_BYTES);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    if (tid == 0) mbar_arrive(&empty[st]);

    // a row that kept no score: o = 0, lse = +1e30 (the JAX kernel's poison)
    float inv[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const bool valid = m[hr] > kMasked * 0.5f;
      const float lc = fmaxf(quad_sum(l[hr]), 1e-30f);
      inv[hr] = valid ? 1.f / lc : 0.f;
      if (owned && t == 0)
        lse[((long long)ib * p.H + ih) * p.S + row[hr]] = valid ? m[hr] * kLn2 + logf(lc)
                                                                : -kMasked;
    }
    if constexpr (G > 1) {
      // a warp's 16 rows (one query block's) by a 16-row TMA box
      if (owned)
        store_warp_rows<T, D>(&to, Os + cw * W::SUB_BYTES, acc, inv, warp, lane, ih, rw0, ib);
    } else if (owned) {
      // O through shared memory (the 128-byte swizzle: a quad's 4-byte
      // writes of 8 rows hit distinct banks) and TMA stores, one a column
      // atom, issued by one thread of the warpgroup
      unsigned char* ot = Os + cw * W::SUB_BYTES;
      if (tid == 0) bulk_wait_read();  // this buffer's previous store has read it
      named_sync(kWgBar + cw, 128);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int rl = warp * 16 + (lane >> 2) + 8 * hr;  // row within the unit
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          *reinterpret_cast<uint32_t*>(ot + (n / 8) * kRows * 128 + rl * 128 +
                                       (((n % 8) ^ (rl & 7)) << 4) + 4 * t) =
              pack2<T>(acc[4 * n + 2 * hr] * inv[hr], acc[4 * n + 2 * hr + 1] * inv[hr]);
        }
      }
      fence_async_smem();
      named_sync(kWgBar + cw, 128);
      if (tid == 0) {
        for (int a = 0; a < W::ATOMS; ++a)
          tma_store_4d(&to, ot + a * kRows * 128, a * 64, ih, mine0, ib);
        bulk_commit();
      }
    }
    ++ki;
  }
  if (G == 1 ? tid == 0 : lane == 0) bulk_wait();  // the last stores are done before exit
}

// q, k, v and o through TMA maps: at blocks of 64 and 128 64-row boxes and
// dq's plan of paired 64-row units (H * ceil(S / 128) headers); at 16 and
// 32 q, k and v in 64-row and in block boxes (tqb, tkb, tvb), o in 16-row
// boxes (a warp's rows), and the query side's grouped plan of n_pairs
// headers
template <typename T, int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse,
                         const int* plan, int n_pairs, const BsParams& p, cudaStream_t stream) {
  constexpr bool half = std::is_same<T, __half>::value;
  using hopper::make_map;
  const bool grouped = p.blk < kRows;
  // a map's box may not exceed its tensor: below 64 rows only a block's boxes
  const int wide = p.S >= kRows ? kRows : p.blk;
  CUtensorMap tq, tk, tv, to;
  const long long o_ss = (long long)p.H * D;
  if (plan == nullptr ||
      !make_map(&tq, half, q, p.B, p.S, p.H, D, p.q_sb, p.q_ss, p.q_sh, wide) ||
      !make_map(&tk, half, k, p.B, p.S, p.H, D, p.k_sb, p.k_ss, p.k_sh, wide) ||
      !make_map(&tv, half, v, p.B, p.S, p.H, D, p.v_sb, p.v_ss, p.v_sh, wide) ||
      !make_map(&to, half, o, p.B, p.S, p.H, D, p.S * o_ss, o_ss, D, grouped ? 16 : kRows))
    return cudaErrorInvalidValue;
  CUtensorMap tqb = tq, tkb = tk, tvb = tv;
  if (grouped && (!make_map(&tqb, half, q, p.B, p.S, p.H, D, p.q_sb, p.q_ss, p.q_sh, p.blk) ||
                  !make_map(&tkb, half, k, p.B, p.S, p.H, D, p.k_sb, p.k_ss, p.k_sh, p.blk) ||
                  !make_map(&tvb, half, v, p.B, p.S, p.H, D, p.v_sb, p.v_ss, p.v_sh, p.blk)))
    return cudaErrorInvalidValue;
  if (!grouped && n_pairs != p.H * ((p.nblk * (p.blk / kRows) + 1) / 2))
    return cudaErrorInvalidValue;
  const int n_items = p.B * n_pairs;
  if (n_items <= 0) return cudaErrorInvalidValue;
  const unsigned grid = (unsigned)std::min(n_items, hopper::sm_count());
  auto go = [&](auto kern, auto smem) {
    cudaError_t err = allow_smem(kern, smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, WgCfg<T, D>::NT, smem, stream>>>(tq, tk, tv, to, tqb, tkb, tvb, plan, n_pairs,
                                                  lse, p, n_items);
    return cudaGetLastError();
  };
  switch (p.blk) {
    case 16: return go(bs_fwd_wgmma<T, D, 16>, fwd_smem<T, D, 4>());
    case 32: return go(bs_fwd_wgmma<T, D, 32>, fwd_smem<T, D, 2>());
    default: return go(bs_fwd_wgmma<T, D, 64>, fwd_smem<T, D, 1>());  // 64, 128
  }
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

// the kernel a shape takes: bf16/fp16 the TMA + wgmma kernel (a plan
// required), fp32 the FMA kernel
template <int D>
cudaError_t dispatch_dtype(int dtype, const void* q, const void* k, const void* v, void* o,
                           float* lse, const int* plan, int n_pairs, const BsParams& p,
                           cudaStream_t s) {
  switch (dtype) {
    case 0:
      return p.blk == 16 ? launch_f32<D, 16>(q, k, v, o, lse, p, s)
                         : launch_f32<D, 32>(q, k, v, o, lse, p, s);
    case 1: return launch_wgmma<__half, D>(q, k, v, o, lse, plan, n_pairs, p, s);
    case 2: return launch_wgmma<__nv_bfloat16, D>(q, k, v, o, lse, plan, n_pairs, p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 float32, 1 float16, 2 bfloat16 (q, k, v and o share it).
// kidx [H, S/blk, maxK] and kcnt [H, S/blk] int32; o [B, S, H, D] and lse
// [B, H, S] f32 contiguous. plan: at bf16/fp16 the dq kernel's schedule of
// n_pairs headers (int32; at blocks of 64 and 128 H * ceil(S / 128)
// headers (unit, unit or -1, offset, tile count), heaviest first, then the
// tile entries, see plan_item; at 16 and 32 the query side's grouped plan,
// see group_item), q, k and v then read through TMA maps (positive strides
// under 2^40 bytes); null on the fp32 route. Returns the CUDA error of the
// launch (0 on success), cudaErrorInvalidValue for shapes the kernel does
// not take (blk outside 16/32/64/128, S not a multiple of blk, D outside
// 64/128, no plan on the wgmma route, a header count that does not fit the
// plan of blocks of 64 and 128). Asynchronous on `stream`.
extern "C" int block_sparse_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* o, void* lse, const void* kidx,
    const void* kcnt, const void* plan, int n_pairs, int B, int S, int H, int D, int blk,
    int maxK, long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh, int causal, float sm_scale,
    int dtype, void* stream) {
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
  const int* pl = static_cast<const int*>(plan);
  switch (D) {
    case 64: return (int)dispatch_dtype<64>(dtype, q, k, v, o, l, pl, n_pairs, p, s);
    case 128: return (int)dispatch_dtype<128>(dtype, q, k, v, o, l, pl, n_pairs, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
