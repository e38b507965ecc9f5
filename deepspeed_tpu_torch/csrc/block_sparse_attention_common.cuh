// Shared pieces of the block-sparse attention kernels
// (block_sparse_attention_fwd.cu, block_sparse_attention_bwd.cu) for
// Hopper (sm_90a). The row loads, packing and exp2 softmax helpers come
// from flash_attention_common.cuh, the TMA, mbarrier and wgmma wrappers
// from hopper.cuh.
//
// Layout: q/k/v/dO [B, S, H, D] with explicit batch / sequence / head
// strides in elements and a contiguous last dim; o, dq, dk, dv [B, S, H, D]
// contiguous; lse and delta [B, H, S] f32. A static layout of blk x blk
// blocks arrives as index lists: idx [H, nblk, maxl] (ascending, zero
// padded) with counts cnt [H, nblk]. The forward and dq kernels get kidx
// (the key blocks of each query block), dk/dv gets qidx (the query blocks
// of each key block).
//
// The fp32 kernels cut work into units: R = min(blk, 32) consecutive rows
// (queries, or keys for dk/dv) of one block of one (batch, head). A unit
// walks its list row as tiles of R rows of the other operand, streamed
// through shared memory. A thread block holds G units so that it has 4
// warps; the units of a block are independent and synchronise on their own
// named barriers.
//
// The TMA + wgmma kernels (bf16/fp16, D 64/128, every block; the forward
// in block_sparse_attention_fwd.cu, dq and dk/dv in
// block_sparse_attention_bwd.cu) walk a host-built schedule of paired
// 64-row units instead; its decoding, the producer's loads and the
// query-side masks are at the end of this file, then the grouped units of
// blocks of 16 and 32 (key blocks for dk/dv, query blocks for the forward
// and dq).

#pragma once

#include <climits>

#include "flash_attention_common.cuh"
#include "hopper.cuh"

namespace bsparse {

using namespace flash;

struct BsParams {
  int B, S, H, blk, nblk, maxl;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;  // dO (backward)
  const int* idx;                 // [H, nblk, maxl]
  const int* cnt;                 // [H, nblk]
  int causal;
  float scale;
};

// barrier over the `nthreads` threads of unit `unit` of this block (named
// barrier unit + 1; barrier 0 is __syncthreads)
__device__ __forceinline__ void unit_sync(int unit, int nthreads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(unit + 1), "r"(nthreads) : "memory");
}

struct Unit {
  int b, h, bi, row0;  // batch, head, block index, first row of the unit
};

// unit number u of R rows a unit → false past the last unit
__device__ __forceinline__ bool unit_of(long long u, int R, const BsParams& p, Unit& out) {
  const int nsub = p.blk / R;
  if (u >= (long long)p.B * p.H * p.nblk * nsub) return false;
  const int sub = (int)(u % nsub);
  long long rest = u / nsub;
  out.bi = (int)(rest % p.nblk);
  rest /= p.nblk;
  out.h = (int)(rest % p.H);
  out.b = (int)(rest / p.H);
  out.row0 = out.bi * p.blk + sub * R;
  return true;
}

// first row of tile t of a list row: tile t is sub-tile t % per of the
// listed block t / per, per = blk / TW. The list ascends, so the tiles do.
__device__ __forceinline__ int tile_row0(const int* lst, int t, int per, int blk, int TW) {
  return lst[t / per] * blk + (t % per) * TW;
}

// the tiles of key rows a query unit [r0, r0 + R) needs: [0, n). Under the
// causal mask a tile starting past the unit's last row is wholly masked
// and skipped (exact: it adds p = 0), and those tiles are the list's tail.
__device__ __forceinline__ int query_unit_tiles(const int* lst, int count, int r0, int R,
                                                const BsParams& p, int TW) {
  const int per = p.blk / TW;
  int n = count * per;
  if (p.causal)
    while (n > 0 && tile_row0(lst, n - 1, per, p.blk, TW) > r0 + R - 1) --n;
  return n;
}

// the tiles of query rows a key unit [k0, k0 + R) needs: [lo, count * per).
// Under the causal mask a tile ending before the unit's first key is
// wholly masked, and those tiles are the list's head.
__device__ __forceinline__ int key_unit_first_tile(const int* lst, int count, int k0,
                                                   const BsParams& p, int TW) {
  const int per = p.blk / TW;
  const int n = count * per;
  int lo = 0;
  if (p.causal)
    while (lo < n && tile_row0(lst, lo, per, p.blk, TW) + TW - 1 < k0) ++lo;
  return lo;
}

inline __host__ __device__ long long units(const BsParams& p, int R) {
  return (long long)p.B * p.H * p.nblk * (p.blk / R);
}

// ---- the TMA + wgmma route's schedule, loads and masks -----------------------

constexpr int kRows = 64;  // rows of a unit (wgmma's M) and of one listed tile

// the route's tile geometry and the backward's ring: TN streamed rows a
// step (two 64-row tiles side by side at D64, one at D128: its registers)
template <typename T, int D>
struct WgCfg {
  static constexpr int TN = D == 64 ? 128 : 64;  // streamed rows a step
  static constexpr int P = TN / kRows;           // tiles a step
  static constexpr int STAGES = D == 64 ? 4 : 2;
  static constexpr int NT = 384;                 // producer + 2 consumer warpgroups
  static constexpr int ATOMS = D / 64;           // 128-byte column atoms a row
  static constexpr uint32_t SUB_BYTES = kRows * D * 2;    // one 64-row tile of one operand
  static constexpr uint32_t PAIR_BYTES = 2 * SUB_BYTES;   // an item's two units of one operand
  static constexpr uint32_t STEP_BYTES = P * SUB_BYTES;   // one operand's tiles of a step
  static constexpr int AUX_FLOATS = P * 2 * kRows;        // a dk/dv step's lse and delta
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = 232;
  // 1024 bytes of slack to align the tiles; two buffers of the item's own
  // operands (K/V for dk/dv, Q/dO for dq: the next item's load while this
  // one runs), the streamed stages (and dk/dv's lse/delta), the stages'
  // tile entries (G ints a tile: dk/dv's grouped plan), the barriers
  static constexpr size_t smem(bool aux, int G = 1) {
    return 1024 + 4 * (size_t)PAIR_BYTES + (size_t)STAGES * 2 * STEP_BYTES +
           (aux ? (size_t)STAGES * AUX_FLOATS * 4 : 0) + (STAGES * P * G + 2) * 4 +
           8 * (4 + 2 * STAGES);
  }
};

// an item: two units (64 rows each: keys for dk/dv, queries for the
// forward and dq) of one (batch, head), the second absent (row -1) when
// the head's units are odd, and the n entries of the tiles they walk: the
// union of the units' list rows after the causal cut, ascending, each
// entry (first row of a 64-row tile) * 4 + (bit c: unit c walks it)
struct Item {
  int b, h, r0[2], n;
  const int* tiles;
};

// item i of the schedule. The plan (built on the host, one batch row's
// worth): n_pairs headers (unit 0, unit 1 or -1, offset, tile count),
// heaviest first, then the tile entries; each header is B items, one a
// batch row
__device__ __forceinline__ Item plan_item(int i, const int* __restrict__ plan, int n_pairs,
                                          const BsParams& p) {
  Item w;
  const int* hd = plan + 4 * (i / p.B);
  w.b = i % p.B;
  const int nu = p.nblk * (p.blk / kRows);  // units a head
  const int u0 = __ldg(hd), u1 = __ldg(hd + 1);
  w.h = u0 / nu;
  w.r0[0] = (u0 % nu) * kRows;
  w.r0[1] = u1 < 0 ? -1 : (u1 % nu) * kRows;
  w.tiles = plan + 4 * n_pairs + __ldg(hd + 2);
  w.n = __ldg(hd + 3);
  return w;
}

// the producer's load of an item's own rows of one operand by TMA: its two
// units' 64 rows (the first unit's again when there is no second) side by
// side in each column atom (atom a of unit c at (2a + c) * 64 rows * 128 B)
template <int ATOMS>
__device__ __forceinline__ void load_pair(unsigned char* dst, const CUtensorMap* map,
                                          uint64_t* bar, const Item& w) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int row = w.r0[c] >= 0 ? w.r0[c] : w.r0[0];
#pragma unroll
    for (int a = 0; a < ATOMS; ++a)
      hopper::tma_load_4d(dst + (2 * a + c) * kRows * 128, map, bar, a * 64, w.h, row, w.b);
  }
}

// ... and of a step's P streamed 64-row tiles of one operand, starting at
// rows row[0..P), side by side in each column atom (atom a of tile q at
// (P a + q) * 64 rows * 128 B)
template <int P, int ATOMS>
__device__ __forceinline__ void load_tiles(unsigned char* dst, const CUtensorMap* map,
                                           uint64_t* bar, const Item& w, const int (&row)[P]) {
#pragma unroll
  for (int q = 0; q < P; ++q)
#pragma unroll
    for (int a = 0; a < ATOMS; ++a)
      hopper::tma_load_4d(dst + (P * a + q) * kRows * 128, map, bar, a * 64, w.h, row[q], w.b);
}

// the producer warp's walk over an item's tile entries, P a step: lane l
// holds entry t0 + l (-1 past the last), and lane 0 writes each step's
// entries beside its stage and hands the step to issue(stage, first rows)
// once the stage is free. A step's missing second tile repeats the first
// tile's rows with no unit's bit set. `it` counts steps over all items
template <int P, int STAGES, typename Issue>
__device__ __forceinline__ void stream_steps(const Item& w, int lane, uint64_t* empty,
                                             int* entries, int& it, Issue issue) {
  using namespace hopper;
  for (int t0 = 0; t0 < w.n; t0 += 32) {
    const int e = t0 + lane < w.n ? __ldg(w.tiles + t0 + lane) : -1;
    const int cnt = min(32, w.n - t0);
    for (int j = 0; j < cnt; j += P, ++it) {
      int r[P];
#pragma unroll
      for (int q = 0; q < P; ++q) r[q] = __shfl_sync(0xffffffffu, e, j + q);
      if (lane == 0) {
        const int s = it % STAGES;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        int row[P];
#pragma unroll
        for (int q = 0; q < P; ++q) {
          entries[s * P + q] = r[q] >= 0 ? r[q] : r[0] & ~3;
          row[q] = (r[q] >= 0 ? r[q] : r[0]) >> 2;
        }
        issue(s, row);
      }
    }
  }
}

// the forward's and dq's mask of one step for a consumer warp whose 16
// queries (rw0 the first, row[i] the thread's two) are real rows when
// `owned` and lie in one slot of its unit (kbit: the slot's bit in a tile
// entry's masks; cw at G 1). A tile holds G slots of 64 / G keys (G = 64 /
// BLK on the grouped plan, 1 at blocks of 64 and 128); column ql of tile
// q's slot g is key koff[q][g] + ql, kept for row i iff it is <= hi[i]:
// the row under the causal rule, every key otherwise, none on a padding
// warp; a slot the warp's block does not list (a tile its unit does not
// walk, a padding slot) has a koff past every hi. Entries are G ints a
// tile: a 64-row tile's first row * 4 + a bit a unit (G 1), or block * 256
// + a bit a unit block, -1 past the tile's last block. → whether the warp
// keeps every key of the step (warp-uniform: the masks can be skipped)
template <int P, int G, int BLK>
__device__ __forceinline__ bool query_masks(const int* entries, int kbit, bool owned,
                                            bool causal, const int (&row)[2], int rw0,
                                            int (&koff)[P][G], int (&hi)[2]) {
  constexpr int SLOT = kRows / G;
  bool whole = owned;
#pragma unroll
  for (int i = 0; i < 2; ++i) hi[i] = !owned ? -1 : causal ? row[i] : INT_MAX / 4;
#pragma unroll
  for (int q = 0; q < P; ++q) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int e = entries[q * G + g];
      const bool on = e >= 0 && ((e >> kbit) & 1);
      const int c0 = G == 1 ? e >> 2 : (e >> 8) * BLK;
      koff[q][g] = on ? c0 - g * SLOT : INT_MAX / 2;
      whole = whole && on && (!causal || c0 + SLOT - 1 <= rw0);
    }
  }
  return whole;
}

// a step's scores or probabilities s (TN keys, P = TN / 64 tiles) set to
// `fill` where query_masks' limits drop the key
template <int TN, int G>
__device__ __forceinline__ void mask_keys(float (&s)[TN / 2], const int (&koff)[TN / kRows][G],
                                          const int (&hi)[2], int t, float fill) {
#pragma unroll
  for (int n = 0; n < TN / 8; ++n) {
    const int ql = (n % (kRows / 8)) * 8;
    const int key = koff[n / (kRows / 8)][ql / (kRows / G)] + ql + 2 * t;
#pragma unroll
    for (int e = 0; e < 4; ++e) s[4 * n + e] = key + (e & 1) <= hi[e >> 1] ? s[4 * n + e] : fill;
  }
}

// one unit's 64 x D accumulator rows r0.. to [B, S, H, D] contiguous, the
// thread's rows g times mul[0] and g + 8 times mul[1]
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[D / 2],
                                           const float (&mul)[2], const BsParams& p, int b,
                                           int h, int r0, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + (lane >> 2) + 8 * hr;
    T* dst = out + (((long long)b * p.S + row) * p.H + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) =
          pack2<T>(acc[4 * n + 2 * hr] * mul[hr], acc[4 * n + 2 * hr + 1] * mul[hr]);
  }
}

// a warp's 16 accumulator rows (the thread's rows g times mul[0] and g + 8
// times mul[1]) to global memory: into its rows of a unit's 64-row staging
// tile ot in shared memory (the 128-byte swizzle: a quad's 4-byte writes
// of 8 rows hit distinct banks), then out by one 16-row TMA box a column
// atom through `map`, rows row0.., issued by the warp's first lane, which
// first waits for its previous stores to have read the tile
template <typename T, int D>
__device__ __forceinline__ void store_warp_rows(const CUtensorMap* map, unsigned char* ot,
                                                const float (&acc)[D / 2], const float (&mul)[2],
                                                int warp, int lane, int h, int row0, int b) {
  const int t = lane & 3;
  if (lane == 0) hopper::bulk_wait_read();
  __syncwarp();
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int rl = warp * 16 + (lane >> 2) + 8 * hr;  // row within the unit
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(ot + (n / 8) * kRows * 128 + rl * 128 +
                                   (((n % 8) ^ (rl & 7)) << 4) + 4 * t) =
          pack2<T>(acc[4 * n + 2 * hr] * mul[hr], acc[4 * n + 2 * hr + 1] * mul[hr]);
  }
  hopper::fence_async_smem();
  __syncwarp();
  if (lane == 0) {
#pragma unroll
    for (int a = 0; a < D / 64; ++a)
      hopper::tma_store_4d(map, ot + a * kRows * 128 + warp * 16 * 128, a * 64, h, row0, b);
    hopper::bulk_commit();
  }
}

// ---- blocks of 16 and 32: grouped units -----------------------------------

// an item of the grouped plan (ops/block_sparse_attention.py
// dkv_group_plan; dk/dv's, or the query side's that the forward and dq
// walk): two units of one (batch, head), each up to G = 64 / blk blocks
// (key blocks for dk/dv, query blocks for the forward and dq), and the n
// tiles they walk, each G blocks of the other side. keys: unit 0's G
// blocks, then unit 1's (-1 past a unit's last, all -1 when there is no
// unit 1); a tile: G ints, block * 256 + m1 * 16 + m0, -1 past its last
// block, bit j of m_c set when block j of unit c lists it
struct GroupItem {
  int b, h, n;
  const int* keys;
  const int* tiles;
};

// item i of the grouped plan: n_pairs headers of 4 + 2 G ints (head,
// offset, tile count, 0, the units' key blocks), heaviest first, then the
// tiles; each header is B items, one a batch row
template <int G>
__device__ __forceinline__ GroupItem group_item(int i, const int* __restrict__ plan, int n_pairs,
                                                const BsParams& p) {
  const int* hd = plan + (4 + 2 * G) * (i / p.B);
  GroupItem w;
  w.b = i % p.B;
  w.h = __ldg(hd);
  w.tiles = plan + (4 + 2 * G) * n_pairs + G * __ldg(hd + 1);
  w.n = __ldg(hd + 2);
  w.keys = hd + 4;
  return w;
}

// the producer's load of an item's two units of one operand (K or V for
// dk/dv, Q or dO for the forward and dq) by TMA: a unit whose G blocks are
// consecutive as one 64-row box a column atom through `wide` (BERT's query
// units), any other one box of blk rows a block through `narrow`. A unit's
// 64 rows lie in each column atom as load_pair lays them (atom a of unit c
// at (2a + c) * 64 rows * 128 B), block slot j at j * blk rows. A padding
// slot repeats the unit's first block and a missing unit 1 takes unit 0's
// blocks, so every row holds finite data (masked in the products)
template <int ATOMS, int BLK>
__device__ __forceinline__ void load_group(unsigned char* dst, const CUtensorMap* wide,
                                           const CUtensorMap* narrow, uint64_t* bar,
                                           const GroupItem& w) {
  constexpr int G = kRows / BLK;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    int blk[G];
    bool run = true;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      blk[j] = __ldg(w.keys + c * G + j);
      run = run && blk[j] >= 0 && (j == 0 || blk[j] == blk[0] + j);
      if (blk[j] < 0) blk[j] = __ldg(w.keys + c * G);
      if (blk[j] < 0) blk[j] = __ldg(w.keys);
    }
    unsigned char* d = dst + c * kRows * 128;
    if (run) {
#pragma unroll
      for (int a = 0; a < ATOMS; ++a)
        hopper::tma_load_4d(d + 2 * a * kRows * 128, wide, bar, a * 64, w.h, blk[0] * BLK, w.b);
    } else {
#pragma unroll
      for (int j = 0; j < G; ++j)
#pragma unroll
        for (int a = 0; a < ATOMS; ++a)
          hopper::tma_load_4d(d + 2 * a * kRows * 128 + j * BLK * 128, narrow, bar, a * 64, w.h,
                              blk[j] * BLK, w.b);
    }
  }
}

// the producer warp's walk over a grouped item's tiles, P a step, as
// stream_steps: lane l holds tile t0 + l's G ints (-1 past the last tile),
// and lane 0 writes each step's P x G ints beside its stage and hands the
// step to issue(stage, tiles) once the stage is free. A step's missing
// second tile repeats the first tile's blocks with no key block's bit set
template <int P, int STAGES, int G, typename Issue>
__device__ __forceinline__ void stream_group(const GroupItem& w, int lane, uint64_t* empty,
                                             int* entries, int& it, Issue issue) {
  using namespace hopper;
  for (int t0 = 0; t0 < w.n; t0 += 32) {
    int e[G];
#pragma unroll
    for (int g = 0; g < G; ++g) e[g] = t0 + lane < w.n ? __ldg(w.tiles + (t0 + lane) * G + g) : -1;
    const int cnt = min(32, w.n - t0);
    for (int j = 0; j < cnt; j += P, ++it) {
      int r[P][G];
#pragma unroll
      for (int q = 0; q < P; ++q)
#pragma unroll
        for (int g = 0; g < G; ++g) r[q][g] = __shfl_sync(0xffffffffu, e[g], j + q);
      if (lane == 0) {
        const int s = it % STAGES;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
#pragma unroll
        for (int q = 0; q < P; ++q) {
          const bool missing = r[q][0] < 0;
#pragma unroll
          for (int g = 0; g < G; ++g) {
            if (missing) r[q][g] = r[0][g] >= 0 ? r[0][g] & ~255 : -1;
            entries[(s * P + q) * G + g] = r[q][g];
          }
        }
        issue(s, r);
      }
    }
  }
}

// a grouped tile's G ints → its blocks (a padding slot, -1, takes the first
// block's rows) and whether they are G consecutive blocks (one 64-row box)
template <int G>
__device__ __forceinline__ bool tile_blocks(const int (&t)[G], int (&blk)[G]) {
  bool run = true;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    blk[g] = (t[g] >= 0 ? t[g] : t[0]) >> 8;
    run = run && t[g] >= 0 && blk[g] == blk[0] + g;
  }
  return run;
}

// the producer's load of tile q of a step of one streamed operand by TMA
// into the stage at dst (atom a of tile q at (P a + q) * 64 rows * 128 B):
// a 64-row box a column atom through `wide` when the blocks run, else a
// BLK-row box a block through `narrow`
template <int P, int ATOMS, int BLK, int G>
__device__ __forceinline__ void load_group_tile(unsigned char* dst, const CUtensorMap* wide,
                                                const CUtensorMap* narrow, uint64_t* bar, int q,
                                                bool run, const int (&blk)[G], int h, int b) {
  unsigned char* d = dst + q * kRows * 128;
  if (run) {
#pragma unroll
    for (int a = 0; a < ATOMS; ++a)
      hopper::tma_load_4d(d + P * a * kRows * 128, wide, bar, a * 64, h, blk[0] * BLK, b);
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int a = 0; a < ATOMS; ++a)
        hopper::tma_load_4d(d + P * a * kRows * 128 + g * BLK * 128, narrow, bar, a * 64, h,
                            blk[g] * BLK, b);
  }
}

}  // namespace bsparse
