// Shared pieces of the block-sparse attention kernels
// (block_sparse_attention_fwd.cu, block_sparse_attention_bwd.cu) for
// Hopper (sm_90a). The mma.sync fragments, ldmatrix loads, cp.async copies
// and the exp2 softmax helpers come from flash_attention_common.cuh.
//
// Layout: q/k/v/dO [B, S, H, D] with explicit batch / sequence / head
// strides in elements and a contiguous last dim; o, dq, dk, dv [B, S, H, D]
// contiguous; lse and delta [B, H, S] f32. A static layout of blk x blk
// blocks arrives as index lists: idx [H, nblk, maxl] (ascending, zero
// padded) with counts cnt [H, nblk]. The forward and dq kernels get kidx
// (the key blocks of each query block), dk/dv gets qidx (the query blocks
// of each key block).
//
// Work is cut into units: R consecutive rows (queries, or keys for dk/dv)
// of one block of one (batch, head), R = min(blk, 64) (fp32: min(blk, 32)).
// A unit walks its list row as tiles of TW = R rows of the other operand
// (a block of 128 is two tiles), streamed through shared memory. A thread
// block holds G units so that it has at least 4 warps (blocks of 16 and 32
// would otherwise make thin blocks of 1-2 warps); the units of a block are
// independent and synchronise on their own named barriers. (The backward's
// TMA + wgmma kernels at blocks of 64 and 128 walk a host-built schedule
// of paired 64-row units instead: block_sparse_attention_bwd.cu.)

#pragma once

#include "flash_attention_common.cuh"

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

}  // namespace bsparse
