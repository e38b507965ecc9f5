// Block-sparse attention backward for Hopper (sm_90a): the dq and the
// dk/dv kernels.
//
// Replaces the Pallas kernels deepspeed_tpu/ops/pallas/block_sparse_attention.py
// _bwd_dq_kernel (:104, pallas_call :208) and _bwd_dkv_kernel (:131,
// pallas_call :226), entry _bwd (:199): the gradients of the block-sparse
// forward given its lse and delta = rowsum(dO * O) (a torch op outside the
// kernels, as the JAX entry computes it at :201), with p recomputed as
// exp(s - lse) inside the visited blocks (0 where the causal rule masks),
// ds = p * (dp - delta), dq and dk scaled by sm_scale once at the end, dv =
// P^T dO. A row the forward poisoned (lse = +1e30, o = 0, delta = 0) gives
// p = 0 and so no contribution. dq walks each query block's kidx row, dk/dv
// each key block's qidx row, so every output row is written by the one
// unit that owns it: deterministic, no atomics.
//
// What bounds them on the card: their flops. dq does 3 products per visited
// (query, key) pair and dk/dv 4, against the 5 the backward needs (s and dp
// are recomputed in both): at the GPT-2 shape (B2 S4096 H16 D64 bf16, fixed
// unidirectional, block 64: 10240 of 65536 blocks, ~84M computed pairs) ~31
// and ~41 GFLOP, 0.031 and 0.041 ms at 989 TFLOP/s, above the 0.025 and
// 0.030 ms their operands take at 3.35 TB/s. At the BERT shape (B16 S512
// H16, block 16) the bytes bound them (0.025 and 0.030 ms).
//
// bf16/fp16 at D 64/128 run the TMA + wgmma kernels at every block, the
// flash backward's design (flash_attention_bwd.cu) on the host's schedule
// (ops/block_sparse_attention.py bwd_plan):
//  - a unit is 64 rows (wgmma's M) of one (head, block): queries for dq,
//    keys for dk/dv. An item is two units of one (batch, head) whose list
//    rows share the most 64-row tiles, one a consumer warpgroup; it walks
//    the union of their tiles after the causal cut, each tile's entry
//    marking the units that walk it. So every streamed tile is loaded once
//    for both warpgroups (a lone unit's item of 64 rows streamed its tiles
//    for one warpgroup: twice the L2 traffic, ~5 TB/s at 0.042 ms of dq);
//  - persistent: min(items, SMs) blocks deal the plan's items heaviest
//    first in rounds (the GPT-2 layout lists a global key block under 61
//    query blocks and a local one under 1-4);
//  - a producer warp reads an item's entries 32 at a time and loads by TMA
//    the item's own 128 rows (K/V, or Q/dO) into one of two buffers and the
//    streamed tiles, two 64-row tiles side by side a step at D64 (N 128),
//    one at D128 (its registers, as in the flash backward), into a ring of
//    stages that runs on across items; a tile's coordinates come from its
//    entry, and a step's missing second tile repeats the first, masked;
//  - consumer warpgroups: dk/dv S^T = K Q^T and dP^T = V dO^T, dV += P^T
//    dO, dK += dS^T Q; dq S = Q K^T, dP = dO V^T, dQ += dS K (left running
//    under the next step's S and dP); P and dS in registers as register A
//    operands; the mask (a tile the unit does not walk, and the causal rule)
//    as compares against per-row limits under one warp-uniform branch that
//    steps with nothing masked skip. Written as a select per element inside
//    the branch, the mask compiled into a branch and convergence barrier per
//    element, and ptxas then waited for dQ at the loop's end: dq took 0.131
//    ms and dk/dv 0.168 (H100 80GB HBM3 at 700 W);
//  - accumulators stay in registers over the item and are stored once.
// What holds them back (tools/kernel_ablation.py, H100 80GB HBM3 at
// 700 W): at the GPT-2 shape dq takes ~0.082 ms and dk/dv ~0.118; without
// the exponentials 0.073 / 0.109; without the last product 0.042 / 0.096.
// dq without its last product moves its ~217 MB of L2 reads at ~5 TB/s:
// the loads and the products take turns more than they overlap.
//
// At blocks of 16 and 32 (BERT's default is 16) both kernels run on
// grouped units (ops/block_sparse_attention.py dkv_group_plan): up to 64 /
// blk blocks (those whose lists are equal first) fill a 64-row unit, a TMA
// box a block or one 64-row box when they are consecutive, and the union
// of their lists streams 64 rows at a time under a mask per (unit block,
// tile block). For dk/dv a unit gathers key blocks: BERT's fixed layout at
// S512 gives a head 8 units of 3 local blocks (one tile each) and 2 of 4
// global blocks (8 tiles, shared). For dq (and the forward) a unit gathers
// query blocks: BERT's 4 blocks of a window list the same 11 key blocks, so
// a head has 8 full units in 4 items streaming 18 tiles. Both score 98,304
// pairs a head against the layout's 90,112. At B16 S512 H16 D64 bf16 dk/dv
// takes ~0.068 ms and dq ~0.054, where the mma.sync kernels they replaced
// took ~0.225 and ~0.096 (H100 80GB HBM3, 700 W; tools/
// time_attention_kernels.py). dq's units store their rows by 16-row TMA
// boxes through shared memory, one query block a warp.
//
// What holds dq back at the BERT shape (tools/kernel_ablation.py): ~0.039
// ms without its last product, ~0.052 without the exponentials, ~0.034 for
// the producer alone: items of ~2.5 steps leave the last dQ product and
// the per-item loads in the open. fp32 runs dq and dk/dv on the FMA pipes
// (lane j owns row j of a chunk of min(blk, 32) streamed rows). Which
// kernel a call takes is a rule on dtype and head dim alone (the wrapper's
// wgmma_route); a call never falls back from one to another.
//
// Not done yet: one shared recompute of s and dp for dq and dk/dv (5
// products instead of 7: dq would need a deterministic sum across blocks);
// delta and lse in log2 units as one prep pass.

#include <cuda.h>

#include <algorithm>
#include <type_traits>

#include "block_sparse_attention_common.cuh"

namespace {

using namespace bsparse;

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

// ---- bf16/fp16 at D 64/128, blocks of 64 and 128: TMA, wgmma, warp specialisation
// (the schedule, the loads and the masks: block_sparse_attention_common.cuh)

// dk, dv: persistent, min(items, SMs) blocks of three warpgroups walking
// the plan's items heaviest first, dealt in rounds. A producer warp loads
// each item's K and V (its two units' 64 keys each, one 128-row tile) by TMA
// into one of two buffers (the next item's while this one runs), then
// streams the Q and dO tiles of the item's entries, P tiles a step side by
// side with their lse and delta slices, through an mbarrier ring that runs
// on across items. Consumer warpgroup c owns unit c's keys: S^T = K Q^T and
// dP^T = V dO^T from shared memory, P^T = exp2(S^T scale2 - lse2) and dS^T
// = P^T (dP^T - delta) in registers (selects to 0 on a tile its unit does
// not walk and on the pairs the causal rule masks), then dV += P^T dO and
// dK += dS^T Q with P^T and dS^T as register A operands; dK and dV stay in
// registers over the item and are stored once.
//
// BLK 64 takes blocks of 64 and 128 (a unit is 64 consecutive keys, a tile
// 64 consecutive queries: bwd_plan). BLK 16 and 32 take the grouped plan
// (dkv_group_plan): a unit is up to G = 64 / BLK key blocks (those with
// equal query lists first), loaded as load_group does (one 64-row box
// through tk / tv when consecutive, else a block a box through tkb / tvb);
// a tile is G query blocks of the union of their lists, one
// 64-row box through tq / tdo when they are consecutive (BERT's windows and
// its global list), else a block a box through tqb / tdob, with lse and
// delta by bulk copies of the same rows. A warp's 16 keys lie in one key
// block, so a tile entry's bit for that block masks a query block the warp
// does not list, as a padding slot (a repeated block) and a pair the
// causal rule drops are masked: p = 0. A padding warp stores nothing
template <typename T, int D, int BLK>
__global__ void __launch_bounds__(384, 1)
bs_dkv_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
             const __grid_constant__ CUtensorMap tlse, const __grid_constant__ CUtensorMap tdelta,
             const __grid_constant__ CUtensorMap tqb, const __grid_constant__ CUtensorMap tkb,
             const __grid_constant__ CUtensorMap tvb, const __grid_constant__ CUtensorMap tdob,
             const float* __restrict__ lse, const float* __restrict__ delta,
             const int* __restrict__ plan, int n_pairs, T* __restrict__ dk, T* __restrict__ dv,
             const BsParams p, int n_items) {
  using W = WgCfg<T, D>;
  constexpr int TN = W::TN, P = W::P, STAGES = W::STAGES;
  constexpr int G = kRows / BLK;  // key blocks a unit, query blocks a tile (1: blocks 64/128)
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* KVs = base;                                  // buffer k: K at 2k, V at 2k + 1
  unsigned char* Qs = KVs + 4 * W::PAIR_BYTES;                // stage s at s * STEP_BYTES
  unsigned char* Os = Qs + (size_t)STAGES * W::STEP_BYTES;    // dO, the same
  float* Aux = reinterpret_cast<float*>(Os + (size_t)STAGES * W::STEP_BYTES);  // [s][tile][2][64]
  int* entries = reinterpret_cast<int*>(Aux + STAGES * W::AUX_FLOATS);        // [s][tile][G]
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(entries + STAGES * P * G + (STAGES * P * G) % 2);
  uint64_t* kv_full = bars;
  uint64_t* kv_empty = bars + 2;
  uint64_t* full = bars + 4;
  uint64_t* empty = bars + 4 + STAGES;

  if (threadIdx.x == 0) {
    for (int k = 0; k < 2; ++k) {
      mbar_init(&kv_full[k], 1);
      mbar_init(&kv_empty[k], 2);
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
    const CUtensorMap *mq = &tq, *mdo = &tdo, *mlse = &tlse, *mdelta = &tdelta;
    int it = 0;  // steps loaded, over all items
    for (int r = 0, ki = 0; r * (int)gridDim.x < n_items; ++r) {
      const int i = round_item(r, n_items);
      if (i < 0) continue;
      const int kb = ki % 2;
      unsigned char* Kt = KVs + (size_t)(2 * kb) * W::PAIR_BYTES;
      if constexpr (G == 1) {
        const Item w = plan_item(i, plan, n_pairs, p);
        if (lane == 0) {
          mbar_wait(&kv_empty[kb], ((ki / 2) & 1) ^ 1);
          mbar_arrive_tx(&kv_full[kb], 2 * W::PAIR_BYTES);
          load_pair<W::ATOMS>(Kt, &tk, &kv_full[kb], w);
          load_pair<W::ATOMS>(Kt + W::PAIR_BYTES, &tv, &kv_full[kb], w);
        }
        stream_steps<P, STAGES>(w, lane, empty, entries, it, [&](int s, const int (&row)[P]) {
          mbar_arrive_tx(&full[s], 2 * W::STEP_BYTES + P * 2 * kRows * 4);
          load_tiles<P, W::ATOMS>(Qs + (size_t)s * W::STEP_BYTES, mq, &full[s], w, row);
          load_tiles<P, W::ATOMS>(Os + (size_t)s * W::STEP_BYTES, mdo, &full[s], w, row);
          for (int q = 0; q < P; ++q) {
            float* aux = Aux + s * W::AUX_FLOATS + q * 2 * kRows;
            tma_load_4d(aux, mlse, &full[s], row[q], w.h, w.b, 0);
            tma_load_4d(aux + kRows, mdelta, &full[s], row[q], w.h, w.b, 0);
          }
        });
      } else {
        const GroupItem w = group_item<G>(i, plan, n_pairs, p);
        if (lane == 0) {
          mbar_wait(&kv_empty[kb], ((ki / 2) & 1) ^ 1);
          mbar_arrive_tx(&kv_full[kb], 2 * W::PAIR_BYTES);
          load_group<W::ATOMS, BLK>(Kt, &tk, &tkb, &kv_full[kb], w);
          load_group<W::ATOMS, BLK>(Kt + W::PAIR_BYTES, &tv, &tvb, &kv_full[kb], w);
        }
        const long long rows = ((long long)w.b * p.H + w.h) * p.S;  // lse / delta row 0
        stream_group<P, STAGES, G>(w, lane, empty, entries, it, [&](int s, const int (&t)[P][G]) {
          mbar_arrive_tx(&full[s], 2 * W::STEP_BYTES + P * 2 * kRows * 4);
          for (int q = 0; q < P; ++q) {
            int qb[G];
            const bool run = tile_blocks<G>(t[q], qb);
            load_group_tile<P, W::ATOMS, BLK, G>(Qs + (size_t)s * W::STEP_BYTES, mq, &tqb,
                                                 &full[s], q, run, qb, w.h, w.b);
            load_group_tile<P, W::ATOMS, BLK, G>(Os + (size_t)s * W::STEP_BYTES, mdo, &tdob,
                                                 &full[s], q, run, qb, w.h, w.b);
            float* aux = Aux + s * W::AUX_FLOATS + q * 2 * kRows;
            if (run) {
              bulk_load(aux, lse + rows + qb[0] * BLK, kRows * 4, &full[s]);
              bulk_load(aux + kRows, delta + rows + qb[0] * BLK, kRows * 4, &full[s]);
            } else {
#pragma unroll
              for (int g = 0; g < G; ++g) {
                bulk_load(aux + g * BLK, lse + rows + qb[g] * BLK, BLK * 4, &full[s]);
                bulk_load(aux + kRows + g * BLK, delta + rows + qb[g] * BLK, BLK * 4, &full[s]);
              }
            }
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

  float dka[D / 2], dva[D / 2];
  float st[TN / 2], dpt[TN / 2];
  uint32_t pa[TN / 16][4], da[TN / 16][4];

  int it = 0;  // steps consumed, over all items
  for (int r = 0, ki = 0; r * (int)gridDim.x < n_items; ++r) {
    const int i = round_item(r, n_items);
    if (i < 0) continue;
    // the item's batch row, head and tile count; this warp's first key,
    // whether its 16 keys are real rows of this warpgroup's unit, and (the
    // grouped plan) the bit of its key block in a tile entry's masks
    int ib, ih, n_tiles, kw0, kbit = 0;
    bool owned;
    if constexpr (G == 1) {
      const Item w = plan_item(i, plan, n_pairs, p);
      const int mine0 = cw ? w.r0[1] : w.r0[0];
      owned = mine0 >= 0;
      kw0 = (owned ? mine0 : w.r0[0]) + warp * 16;
      ib = w.b, ih = w.h, n_tiles = w.n;
    } else {
      const GroupItem w = group_item<G>(i, plan, n_pairs, p);
      const int slot = warp * 16 / BLK;
      const int kblk = __ldg(w.keys + cw * G + slot);
      owned = kblk >= 0;
      kw0 = owned ? kblk * BLK + (warp * 16) % BLK : 0;
      kbit = 4 * cw + slot;
      ib = w.b, ih = w.h, n_tiles = w.n;
    }
    const int key[2] = {kw0 + (lane >> 2), kw0 + (lane >> 2) + 8};
    const int kb = ki % 2;
    const uint32_t k_addr = smem_addr(KVs) + (2 * kb) * W::PAIR_BYTES + cw * kRows * 128;
    const uint32_t v_addr = k_addr + W::PAIR_BYTES;
    const int nsteps = (n_tiles + P - 1) / P;
#pragma unroll
    for (int k = 0; k < D / 2; ++k) dka[k] = dva[k] = 0.f;
    mbar_wait(&kv_full[kb], (ki / 2) & 1);

    for (int u = 0; u < nsteps; ++u, ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      // column ql of tile q's slot g is query qoff[q][g] + ql, kept for the
      // thread's key row i iff it is >= lo[i]: the key under the causal rule,
      // 0 otherwise, INT_MAX on a padding warp; a slot the warp's keys do not
      // take (or padding) has a qoff below every lo
      int qoff[P][G], lo[2];
      bool whole = owned;
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) lo[i2] = !owned ? INT_MAX : causal ? key[i2] : 0;
#pragma unroll
      for (int q = 0; q < P; ++q) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int e = entries[(s * P + q) * G + g];
          // the slot's first query, and whether this warp's keys take it
          // (64/128: entry row * 4 + a bit a unit; grouped: block * 256 +
          // a bit a key block)
          const bool on = e >= 0 && (G == 1 ? (e >> cw) & 1 : (e >> kbit) & 1);
          const int row0 = G == 1 ? e >> 2 : (e >> 8) * BLK;
          qoff[q][g] = on ? row0 - g * BLK : INT_MIN / 2;
          whole = whole && on && (!causal || row0 >= kw0 + 15);
        }
      }
      const uint32_t q_addr = smem_addr(Qs) + s * W::STEP_BYTES;
      const uint32_t do_addr = smem_addr(Os) + s * W::STEP_BYTES;
      const float* aux = Aux + s * W::AUX_FLOATS;

      // S^T = K Q^T, then dP^T = V dO^T, two commit groups: P^T's
      // exponentials run while dP^T is on the tensor cores
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
      issue_ss<T, D, TN>(st, k_addr, 2 * kRows * 128, q_addr, TN * 128);
      wgmma_commit();
      issue_ss<T, D, TN>(dpt, v_addr, 2 * kRows * 128, do_addr, TN * 128);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(st);

      // P^T, then 0 where lo masks (selects; a step with nothing masked skips them)
#pragma unroll
      for (int n = 0; n < TN / 8; ++n) {
        const int q = n / (kRows / 8);
        const int ql = (n % (kRows / 8)) * 8 + 2 * t;
        const float2 l = *reinterpret_cast<const float2*>(aux + q * 2 * kRows + ql);
        const float l2[2] = {l.x * kLog2e, l.y * kLog2e};
#pragma unroll
        for (int e = 0; e < 4; ++e) st[4 * n + e] = ex2(fmaf(st[4 * n + e], scale2, -l2[e & 1]));
      }
      if (!whole) {
#pragma unroll
        for (int n = 0; n < TN / 8; ++n) {
          const int q = n / (kRows / 8);
          const int ql = (n % (kRows / 8)) * 8;
          const int qi = qoff[q][ql / BLK % G] + ql + 2 * t;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            st[4 * n + e] = qi + (e & 1) >= lo[e >> 1] ? st[4 * n + e] : 0.f;
        }
      }
      pack_a<T, TN>(pa, st);
      wgmma_wait<0>();
      fence_regs(dpt);
      // dS^T = P^T (dP^T - delta)
#pragma unroll
      for (int n = 0; n < TN / 8; ++n) {
        const int q = n / (kRows / 8);
        const float2 d2 = *reinterpret_cast<const float2*>(
            aux + q * 2 * kRows + kRows + (n % (kRows / 8)) * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[4 * n + e] = st[4 * n + e] * (dpt[4 * n + e] - ((e & 1) ? d2.y : d2.x));
      }
      pack_a<T, TN>(da, dpt);

      // dV += P^T dO, dK += dS^T Q
      fence_regs(dva);
      fence_regs(dka);
      fence_regs(pa);
      fence_regs(da);
      wgmma_fence();
      issue_rs<T, D, TN>(dva, pa, do_addr);
      issue_rs<T, D, TN>(dka, da, q_addr);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
      fence_regs(pa);
      fence_regs(da);
      if (tid == 0) mbar_arrive(&empty[s]);  // the stage's last reads are done
    }
    if (tid == 0) mbar_arrive(&kv_empty[kb]);  // K and V's last reads are done
    if (owned) {
      store_rows<T, D>(dk, dka, {p.scale, p.scale}, p, ib, ih, kw0, lane);
      store_rows<T, D>(dv, dva, {1.f, 1.f}, p, ib, ih, kw0, lane);
    }
    ++ki;
  }
}

// dq: persistent as dk/dv over items of two query units. The producer
// loads each item's Q and dO (one 128-row tile of each) into one of two
// buffers and streams the K/V tiles of its entries, P a step; consumer
// warpgroup c owns unit c's queries: S = Q K^T and dP = dO V^T from shared
// memory, dS = P (dP - delta) in registers (0 where query_masks drops the
// key), dQ += dS K with dS as the register A operand and K MN-major, left
// running while the next step's S and dP are issued.
//
// BLK 64 takes blocks of 64 and 128 (bwd_plan's paired 64-row units). BLK
// 16 and 32 take the query side's grouped plan, which the forward walks
// too (dkv_group_plan(..., "dq")): a unit is up to G = 64 / BLK query
// blocks, Q and dO loaded by load_group (BERT's 4 blocks of a window as
// one 64-row box through tq / tdo, others a block a box through tqb /
// tdob); a tile is G key blocks, one 64-row box through tk / tv when they
// are consecutive, else a block a box through tkb / tvb; lse and delta of
// a warp's rows come from global memory, as at 64/128. A warp's 16 queries
// lie in one query block (the bit of a tile entry's masks it reads); a
// padding warp stores nothing
template <typename T, int D, int BLK>
__global__ void __launch_bounds__(384, 1)
bs_dq_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
            const __grid_constant__ CUtensorMap tqb, const __grid_constant__ CUtensorMap tkb,
            const __grid_constant__ CUtensorMap tvb, const __grid_constant__ CUtensorMap tdob,
            const __grid_constant__ CUtensorMap tdq, const float* __restrict__ lse,
            const float* __restrict__ delta, const int* __restrict__ plan, int n_pairs,
            T* __restrict__ dq, const BsParams p, int n_items) {
  using W = WgCfg<T, D>;
  constexpr int G = kRows / BLK;  // query blocks a unit, key blocks a tile (1: blocks 64/128)
  constexpr int TN = W::TN, P = W::P, STAGES = W::STAGES;
  constexpr int QB = 2;  // buffers of an item's Q and dO
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* QOs = base;                                  // buffer k: Q at 2k, dO at 2k + 1
  unsigned char* Ks = QOs + 2 * QB * W::PAIR_BYTES;           // stage s at s * STEP_BYTES
  unsigned char* Vs = Ks + (size_t)STAGES * W::STEP_BYTES;    // V, the same
  unsigned char* Ds = Vs + (size_t)STAGES * W::STEP_BYTES;    // grouped: dQ staged, c * SUB_BYTES
  int* entries = reinterpret_cast<int*>(Ds + (G > 1 ? W::PAIR_BYTES : 0));  // [s][tile][G]
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
    regs_dec<W::PRODUCER_REGS>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    const CUtensorMap *mk = &tk, *mv = &tv;
    int it = 0;  // steps loaded, over all items
    for (int r = 0, ki = 0; r * (int)gridDim.x < n_items; ++r) {
      const int i = round_item(r, n_items);
      if (i < 0) continue;
      const int qb = ki % QB;
      unsigned char* Qt = QOs + (size_t)(2 * qb) * W::PAIR_BYTES;
      if constexpr (G == 1) {
        const Item w = plan_item(i, plan, n_pairs, p);
        if (lane == 0) {
          mbar_wait(&q_empty[qb], ((ki / QB) & 1) ^ 1);
          mbar_arrive_tx(&q_full[qb], 2 * W::PAIR_BYTES);
          load_pair<W::ATOMS>(Qt, &tq, &q_full[qb], w);
          load_pair<W::ATOMS>(Qt + W::PAIR_BYTES, &tdo, &q_full[qb], w);
        }
        stream_steps<P, STAGES>(w, lane, empty, entries, it, [&](int s, const int (&row)[P]) {
          mbar_arrive_tx(&full[s], 2 * W::STEP_BYTES);
          load_tiles<P, W::ATOMS>(Ks + (size_t)s * W::STEP_BYTES, mk, &full[s], w, row);
          load_tiles<P, W::ATOMS>(Vs + (size_t)s * W::STEP_BYTES, mv, &full[s], w, row);
        });
      } else {
        const GroupItem w = group_item<G>(i, plan, n_pairs, p);
        if (lane == 0) {
          mbar_wait(&q_empty[qb], ((ki / QB) & 1) ^ 1);
          mbar_arrive_tx(&q_full[qb], 2 * W::PAIR_BYTES);
          load_group<W::ATOMS, BLK>(Qt, &tq, &tqb, &q_full[qb], w);
          load_group<W::ATOMS, BLK>(Qt + W::PAIR_BYTES, &tdo, &tdob, &q_full[qb], w);
        }
        stream_group<P, STAGES, G>(w, lane, empty, entries, it, [&](int s, const int (&t)[P][G]) {
          mbar_arrive_tx(&full[s], 2 * W::STEP_BYTES);
#pragma unroll
          for (int q = 0; q < P; ++q) {
            int kb[G];
            const bool run = tile_blocks<G>(t[q], kb);
            load_group_tile<P, W::ATOMS, BLK, G>(Ks + (size_t)s * W::STEP_BYTES, mk, &tkb,
                                                 &full[s], q, run, kb, w.h, w.b);
            load_group_tile<P, W::ATOMS, BLK, G>(Vs + (size_t)s * W::STEP_BYTES, mv, &tvb,
                                                 &full[s], q, run, kb, w.h, w.b);
          }
        });
      }
      ++ki;
    }
    return;
  }

  regs_inc<W::CONSUMER_REGS>();
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3;
  const float scale2 = p.scale * kLog2e;
  const bool causal = p.causal != 0;

  float dqa[D / 2];
  float s[TN / 2], dp[TN / 2];
  uint32_t da[TN / 16][4];

  int it = 0;  // steps consumed, over all items
  for (int r = 0, ki = 0; r * (int)gridDim.x < n_items; ++r) {
    const int i = round_item(r, n_items);
    if (i < 0) continue;
    // the item's batch row, head and tile count; this warp's first query,
    // whether its 16 queries are real rows of this warpgroup's unit, and
    // the bit of its query block in a tile entry's masks
    int ib, ih, n_tiles, rw0, kbit = cw;
    bool owned;
    if constexpr (G == 1) {
      const Item w = plan_item(i, plan, n_pairs, p);
      const int mine0 = cw ? w.r0[1] : w.r0[0];
      owned = mine0 >= 0;
      rw0 = (owned ? mine0 : w.r0[0]) + warp * 16;
      ib = w.b, ih = w.h, n_tiles = w.n;
    } else {
      const GroupItem w = group_item<G>(i, plan, n_pairs, p);
      const int slot = warp * 16 / BLK;
      const int qblk = __ldg(w.keys + cw * G + slot);
      owned = qblk >= 0;
      rw0 = owned ? qblk * BLK + (warp * 16) % BLK : 0;
      kbit = 4 * cw + slot;
      ib = w.b, ih = w.h, n_tiles = w.n;
    }
    const int row[2] = {rw0 + (lane >> 2), rw0 + (lane >> 2) + 8};
    const int qb = ki % QB;
    const uint32_t q_addr = smem_addr(QOs) + (2 * qb) * W::PAIR_BYTES + cw * kRows * 128;
    const uint32_t do_addr = q_addr + W::PAIR_BYTES;
    const long long rowbase = ((long long)ib * p.H + ih) * p.S;
    float lrow[2], drow[2];  // lse in log2 units, delta
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      lrow[i2] = __ldg(lse + rowbase + row[i2]) * kLog2e;
      drow[i2] = __ldg(delta + rowbase + row[i2]);
    }
    const int nsteps = (n_tiles + P - 1) / P;
#pragma unroll
    for (int k = 0; k < D / 2; ++k) dqa[k] = 0.f;
    mbar_wait(&q_full[qb], (ki / QB) & 1);

    int prev = 0;  // the stage of the previous step
    for (int u = 0; u < nsteps; ++u, ++it) {
      const int st = it % STAGES;
      mbar_wait(&full[st], (it / STAGES) & 1);
      int koff[P][G], hi[2];
      const bool whole =
          query_masks<P, G, BLK>(entries + st * P * G, kbit, owned, causal, row, rw0, koff, hi);
      const uint32_t k_addr = smem_addr(Ks) + st * W::STEP_BYTES;
      const uint32_t v_addr = smem_addr(Vs) + st * W::STEP_BYTES;

      // S = Q K^T, then dP = dO V^T, two commit groups
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      issue_ss<T, D, TN>(s, q_addr, 2 * kRows * 128, k_addr, TN * 128);
      wgmma_commit();
      issue_ss<T, D, TN>(dp, do_addr, 2 * kRows * 128, v_addr, TN * 128);
      wgmma_commit();
      wgmma_wait<2>();  // the previous step's dQ product (none on the item's first)
      fence_regs(dqa);
      fence_regs(da);
      if (u > 0 && tid == 0) mbar_arrive(&empty[prev]);
      wgmma_wait<1>();
      fence_regs(s);

      // P = exp2(S scale2 - lse2), then 0 where the masks drop the key
      // (selects; a step with nothing masked skips them)
#pragma unroll
      for (int n = 0; n < TN / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[4 * n + e] = ex2(fmaf(s[4 * n + e], scale2, -lrow[e >> 1]));
      }
      if (!whole) mask_keys<TN, G>(s, koff, hi, t, 0.f);
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int n = 0; n < TN / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[4 * n + e] = s[4 * n + e] * (dp[4 * n + e] - drow[e >> 1]);
      }
      pack_a<T, TN>(da, dp);

      // dQ += dS K, left running into the next step
      fence_regs(dqa);
      fence_regs(da);
      wgmma_fence();
      issue_rs<T, D, TN>(dqa, da, k_addr);
      wgmma_commit();
      prev = st;
    }
    wgmma_wait<0>();
    fence_regs(dqa);
    fence_regs(da);
    if (tid == 0) {
      if (nsteps > 0) mbar_arrive(&empty[prev]);
      mbar_arrive(&q_empty[qb]);  // Q and dO's last reads are done
    }
    if constexpr (G > 1) {
      // a warp's 16 rows (one query block's) by a 16-row TMA box
      if (owned)
        store_warp_rows<T, D>(&tdq, Ds + cw * W::SUB_BYTES, dqa, {p.scale, p.scale}, warp, lane,
                              ih, rw0, ib);
    } else if (owned) {
      store_rows<T, D>(dq, dqa, {p.scale, p.scale}, p, ib, ih, rw0, lane);
    }
    ++ki;
  }
  if (G > 1 && lane == 0) bulk_wait();  // the last stores are done before the block exits
}

// ---- launches ---------------------------------------------------------------

struct Ptrs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
};

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

// the map of a [B, H, S] f32 row tensor (lse, delta) as dims (S, H, B, 1),
// boxes of 64 rows of one (batch, head)
inline bool make_rows_map(CUtensorMap* map, const float* ptr, const BsParams& p) {
  const cuuint64_t dims[4] = {(cuuint64_t)p.S, (cuuint64_t)p.H, (cuuint64_t)p.B, 1};
  const cuuint64_t strides[3] = {(cuuint64_t)p.S * 4, (cuuint64_t)p.H * p.S * 4,
                                 (cuuint64_t)p.B * p.H * p.S * 4};
  const cuuint32_t box[4] = {(cuuint32_t)kRows, 1, 1, 1};
  return hopper::make_map_4d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ptr, dims, strides, box,
                             CU_TENSOR_MAP_SWIZZLE_NONE);
}

// q, k, v, dO through TMA maps of 64-row boxes (tq, tk, tv, tdo) and, at
// blocks of 16 and 32, of a block's rows (tqb, tkb, tvb, tdob): which = 0:
// dq, 1: dk/dv, over n_pairs headers of its plan
template <typename T, int D>
cudaError_t launch_wgmma(int which, const Ptrs& a, const BsParams& p, const int* plan,
                         int n_pairs, cudaStream_t s) {
  constexpr bool half = std::is_same<T, __half>::value;
  using hopper::make_map;
  if (plan == nullptr) return cudaErrorInvalidValue;
  const bool grouped = p.blk < kRows;
  // a map's box may not exceed its tensor: below 64 rows only a block's boxes
  const int wide = p.S >= kRows ? kRows : p.blk;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, half, a.q, p.B, p.S, p.H, D, p.q_sb, p.q_ss, p.q_sh, wide) ||
      !make_map(&tk, half, a.k, p.B, p.S, p.H, D, p.k_sb, p.k_ss, p.k_sh, wide) ||
      !make_map(&tv, half, a.v, p.B, p.S, p.H, D, p.v_sb, p.v_ss, p.v_sh, wide) ||
      !make_map(&tdo, half, a.dout, p.B, p.S, p.H, D, p.do_sb, p.do_ss, p.do_sh, wide))
    return cudaErrorInvalidValue;
  CUtensorMap tqb = tq, tkb = tk, tvb = tv, tdob = tdo;
  if (grouped &&
      (!make_map(&tqb, half, a.q, p.B, p.S, p.H, D, p.q_sb, p.q_ss, p.q_sh, p.blk) ||
       !make_map(&tkb, half, a.k, p.B, p.S, p.H, D, p.k_sb, p.k_ss, p.k_sh, p.blk) ||
       !make_map(&tvb, half, a.v, p.B, p.S, p.H, D, p.v_sb, p.v_ss, p.v_sh, p.blk) ||
       !make_map(&tdob, half, a.dout, p.B, p.S, p.H, D, p.do_sb, p.do_ss, p.do_sh, p.blk)))
    return cudaErrorInvalidValue;
  const int per_head = p.H * ((p.nblk * (p.blk / kRows) + 1) / 2);  // the 64/128 plan's
  if (!grouped && n_pairs != per_head) return cudaErrorInvalidValue;
  const int n_items = p.B * n_pairs;
  if (n_items <= 0) return cudaErrorInvalidValue;
  const unsigned grid = (unsigned)std::min(n_items, hopper::sm_count());
  using W = WgCfg<T, D>;
  cudaError_t err;
  if (which) {
    CUtensorMap tlse{}, tdelta{};
    if (!grouped && (!make_rows_map(&tlse, a.lse, p) || !make_rows_map(&tdelta, a.delta, p)))
      return cudaErrorInvalidValue;
    auto go = [&](auto kern, int G) {
      if ((err = allow_smem(kern, W::smem(true, G))) != cudaSuccess) return err;
      kern<<<grid, W::NT, W::smem(true, G), s>>>(tq, tk, tv, tdo, tlse, tdelta, tqb, tkb, tvb,
                                                 tdob, a.lse, a.delta, plan, n_pairs,
                                                 static_cast<T*>(a.dk), static_cast<T*>(a.dv), p,
                                                 n_items);
      return cudaGetLastError();
    };
    switch (p.blk) {
      case 16: return go(bs_dkv_wgmma<T, D, 16>, 4);
      case 32: return go(bs_dkv_wgmma<T, D, 32>, 2);
      default: return go(bs_dkv_wgmma<T, D, 64>, 1);
    }
  }
  // dq through 16-row boxes (a warp's rows) on the grouped plan
  CUtensorMap tdq = tq;
  const long long dq_ss = (long long)p.H * D;
  if (grouped && !make_map(&tdq, half, a.dq, p.B, p.S, p.H, D, p.S * dq_ss, dq_ss, D, 16))
    return cudaErrorInvalidValue;
  auto go = [&](auto kern, auto g) {
    constexpr int G = decltype(g)::value;
    // the grouped kernel stages its dQ rows in shared memory for TMA stores
    constexpr size_t smem = W::smem(false, G) + (G > 1 ? W::PAIR_BYTES : 0);
    if ((err = allow_smem(kern, smem)) != cudaSuccess) return err;
    kern<<<grid, W::NT, smem, s>>>(tq, tk, tv, tdo, tqb, tkb, tvb, tdob, tdq, a.lse, a.delta,
                                   plan, n_pairs, static_cast<T*>(a.dq), p, n_items);
    return cudaGetLastError();
  };
  switch (p.blk) {
    case 16: return go(bs_dq_wgmma<T, D, 16>, std::integral_constant<int, 4>());
    case 32: return go(bs_dq_wgmma<T, D, 32>, std::integral_constant<int, 2>());
    default: return go(bs_dq_wgmma<T, D, 64>, std::integral_constant<int, 1>());
  }
}

// the kernel a shape takes (the wrapper's wgmma_route): bf16/fp16 the TMA +
// wgmma kernels at every block (a plan required), fp32 the FMA kernels
template <int D>
cudaError_t dispatch_dtype(int which, int dtype, const Ptrs& a, const BsParams& p,
                           const int* plan, int n_pairs, cudaStream_t s) {
  switch (dtype) {
    case 0:
      if (p.blk == 16) return which ? launch_dkv_f32<D, 16>(a, p, s) : launch_dq_f32<D, 16>(a, p, s);
      return which ? launch_dkv_f32<D, 32>(a, p, s) : launch_dq_f32<D, 32>(a, p, s);
    case 1: return launch_wgmma<__half, D>(which, a, p, plan, n_pairs, s);
    case 2: return launch_wgmma<__nv_bfloat16, D>(which, a, p, plan, n_pairs, s);
    default: return cudaErrorInvalidValue;
  }
}

int run(int which, const Ptrs& a, int B, int S, int H, int D, int blk, int maxl, const int* idx,
        const int* cnt, const int* plan, int n_pairs, long long q_sb, long long q_ss, long long q_sh,
        long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
        long long v_sh, long long do_sb, long long do_ss, long long do_sh, int causal,
        float sm_scale, int dtype, void* stream) {
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
    case 64: return (int)dispatch_dtype<64>(which, dtype, a, p, plan, n_pairs, s);
    case 128: return (int)dispatch_dtype<128>(which, dtype, a, p, plan, n_pairs, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 float32, 1 float16, 2 bfloat16 (every tensor operand but
// lse and delta shares it). q/k/v/dO strided as documented in the common
// header (read through TMA maps on the wgmma route: positive strides under
// 2^40 bytes); lse and delta [B, H, S] f32 contiguous; dq, dk, dv [B, S, H,
// D] contiguous. The lists: kidx [H, S/blk, maxK] / kcnt for dq, qidx [H,
// S/blk, maxQ] / qcnt for dk/dv, int32. plan: the wgmma route's schedule
// (int32; null on the fp32 route) of n_pairs headers: at blocks of 64 and
// 128 H * ceil(S / 128) headers (unit, unit or -1, offset, tile count),
// heaviest first, then the tile entries (see plan_item); at blocks of 16
// and 32 the grouped plan of that side (dq's query units, dk/dv's key
// units), its headers, then their tiles (see group_item). Each returns the
// CUDA error of its launch (0 on success), cudaErrorInvalidValue for shapes
// the kernels do not take. Asynchronous on `stream`.
extern "C" int block_sparse_attention_dq_launch(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dq, const void* kidx, const void* kcnt, const void* plan,
    int n_pairs, int B, int S, int H, int D, int blk, int maxK, long long q_sb, long long q_ss,
    long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long do_sb, long long do_ss, long long do_sh, int causal,
    float sm_scale, int dtype, void* stream) {
  Ptrs a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
         dq, nullptr, nullptr};
  return run(0, a, B, S, H, D, blk, maxK, static_cast<const int*>(kidx),
             static_cast<const int*>(kcnt), static_cast<const int*>(plan), n_pairs, q_sb, q_ss,
             q_sh,
             k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh, causal, sm_scale, dtype,
             stream);
}

extern "C" int block_sparse_attention_dkv_launch(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dk, void* dv, const void* qidx, const void* qcnt, const void* plan,
    int n_pairs, int B, int S, int H, int D, int blk, int maxQ, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long do_sb, long long do_ss, long long do_sh,
    int causal, float sm_scale, int dtype, void* stream) {
  Ptrs a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
         nullptr, dk, dv};
  return run(1, a, B, S, H, D, blk, maxQ, static_cast<const int*>(qidx),
             static_cast<const int*>(qcnt), static_cast<const int*>(plan), n_pairs, q_sb, q_ss,
             q_sh,
             k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh, causal, sm_scale, dtype,
             stream);
}
