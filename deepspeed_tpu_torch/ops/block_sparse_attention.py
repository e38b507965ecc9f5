"""Block-sparse attention: the CUDA kernels' wrappers, their plain versions,
the cached index lists and the autograd Function that ties them together.

Counterpart of ``deepspeed_tpu/ops/pallas/block_sparse_attention.py``. The
kernels replace the Pallas forward (``_fwd_kernel``, ``pallas_call`` :176),
dq (``_bwd_dq_kernel``, :208) and dk/dv (``_bwd_dkv_kernel``, :226):
``csrc/block_sparse_attention_fwd.cu`` holds the first,
``csrc/block_sparse_attention_bwd.cu`` the other two. A static layout
``[H, nQ, nK]`` of ``block``-sized blocks becomes index lists: ``kidx [H,
nQ, maxK]`` with counts ``kcnt [H, nQ]`` (the key blocks each query block
visits, ascending), and the transposed ``qidx [H, nK, maxQ]`` / ``qcnt``,
which the dk/dv kernel walks so that both backward kernels write their
outputs without atomics.

Which kernel a call takes is a rule on dtype and head dim (:func:`wgmma_route`):
at bf16/fp16 and D 64 or 128 the forward, dq and dk/dv run the TMA + wgmma
kernels at every block (16, 32, 64, 128), fp32 the FMA kernels. The wgmma
kernels' items (two 64-row units of one head that share tiles) are dealt
heaviest first by a schedule built here from the layout (:func:`bwd_plan`,
cached beside the index lists in :class:`IndexLists`; the forward walks
dq's). At blocks of 16 and 32 a unit gathers up to 64 / block blocks, those
whose lists are equal first (key blocks and their query lists for dk/dv,
query blocks and their key lists for the forward and dq), and streams the
union of their lists 64 rows at a time under a mask per (unit block, tile
block) (:func:`dkv_group_plan`). No call falls back from one kernel to
another.

Layout: q/k/v ``[B, S, H, D]`` with any batch / sequence / head strides and
a contiguous last dim (so GPT-2's q, k and v stay views of the ``[B, S,
3E]`` projection); lse and delta ``[B, H, S]`` f32 (the TPU's 128-lane
broadcast is gone).

The precision contract is the JAX kernels': scores from storage-dtype
operands with an f32 accumulator, ``sm_scale`` applied to the f32 scores,
masked scores -1e30 (inside a visited block, key j is kept for query i iff
``j <= i`` when causal), P rounded to the storage dtype before P·V, ``l``
clamped at 1e-30; a query row whose every visited score is masked gets o =
0 and lse = +1e30, so that its backward contributions vanish. Backward:
``p = exp(s - lse)``, ``ds = p (dp - delta)`` rounded to the storage dtype
before dS·K and dSᵀ·Q, dq and dk scaled once at the end; ``delta =
rowsum(dO * O)`` is a torch op outside the kernels, as in the JAX package.
The plain versions compute the same formulas with whole ``[S, S]`` score
matrices under the dense mask of the layout.

:class:`BlockSparseAttention` runs the kernels for CUDA tensors and the
plain versions for CPU tensors; a CUDA tensor never reaches a plain
version. The layout and its index lists are built once per (sparsity
config, S, device) and kept (:func:`index_lists`): the JAX package builds
them at trace time, and an eager port would otherwise rebuild them in
every layer of every step.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .flash_attention import (DTYPE_CODES, TMA_DTYPES, _check_tma, _scale, _strides3,
                              _strides_ok, _tma_strides_ok)
from .launches import LAUNCHES, register

# its launches in the registry, per kernel (the main path's proof that it
# ran here)
KERNELS = register("block_sparse_attention_fwd", "block_sparse_attention_dq",
                   "block_sparse_attention_dkv")
# calls of the masked-dense path (sparse_attention with a key_mask, or
# impl="jnp"), which materializes [B, H, S, S] scores: a kernel run shows 0
DENSE_CALLS = {"sparse_attention_dense": 0}
# the index-list cache's lookups
CACHE_STATS = {"hits": 0, "misses": 0}

BLOCKS = (16, 32, 64, 128)
HEAD_DIMS = (64, 128)
NEG_INF = -1e30
# the TMA + wgmma kernels' rows of a unit and of a streamed tile
TILE = 64


def layout_to_index_lists(layout: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                                        np.ndarray]:
    """``[H, nQ, nK]`` bool → (kidx ``[H, nQ, maxK]``, kcnt ``[H, nQ]``, qidx
    ``[H, nK, maxQ]``, qcnt ``[H, nK]``), int32, each row ascending and
    zero-padded: the forward and dq walk kidx, dk/dv walks qidx."""
    H, nQ, nK = layout.shape
    kcnt = layout.sum(axis=2).astype(np.int32)
    qcnt = layout.sum(axis=1).astype(np.int32)
    maxK = max(1, int(kcnt.max()))
    maxQ = max(1, int(qcnt.max()))
    kidx = np.zeros((H, nQ, maxK), np.int32)
    qidx = np.zeros((H, nK, maxQ), np.int32)
    for h in range(H):
        for i in range(nQ):
            cols = np.nonzero(layout[h, i])[0]
            kidx[h, i, : len(cols)] = cols
        for j in range(nK):
            rows = np.nonzero(layout[h, :, j])[0]
            qidx[h, j, : len(rows)] = rows
    return kidx, kcnt, qidx, qcnt


def _unit_tiles(layout: np.ndarray, block: int, causal: bool, which: str) -> np.ndarray:
    """``[H, U, U]`` bool, U = S / 64: the 64-row tiles each 64-row unit of
    kernel ``which`` walks. A unit is 64 rows of one head, queries for "dq"
    and keys for "dkv" (unit u holds rows ``64 u .. 64 u + 63``); it walks
    the tiles of its block's list row (kidx for dq, qidx for dk/dv; a listed
    block of 128 is two tiles) except, under the causal rule, those wholly
    masked: for dq the tiles starting past the unit's last query, for dk/dv
    those ending before its first key (the cuts of ``query_unit_tiles`` and
    ``key_unit_first_tile`` in ``csrc/block_sparse_attention_common.cuh``)."""
    if block % TILE or which not in ("dq", "dkv"):
        raise ValueError(f"bwd_plan: block {block} is not a multiple of {TILE}, or kernel "
                         f"{which!r} is not 'dq' / 'dkv'")
    layout = np.asarray(layout, bool)
    per = block // TILE
    lay = layout if which == "dq" else layout.transpose(0, 2, 1)  # [H, unit block, tile block]
    walk = lay.repeat(per, axis=1).repeat(per, axis=2)
    if causal:
        u, t = np.indices(walk.shape[1:])
        walk = walk & ((t <= u) if which == "dq" else (t >= u))[None]
    return walk


def _pair_units(walk: np.ndarray):
    """One head's units (``[U, U]`` bool, :func:`_unit_tiles`) in pairs:
    each unit in order of tile count (heaviest first, ties by unit) not yet
    taken takes the free unit it shares the most tiles with (then the fewest
    unshared, then the nearest); an odd unit out pairs with none (-1)."""
    n = walk.shape[0]
    cnt = walk.sum(1)
    w = walk.astype(np.int32)
    shared = w @ w.T
    free = np.ones(n, bool)
    pairs = []
    for u in np.lexsort((np.arange(n), -cnt)):
        if not free[u]:
            continue
        free[u] = False
        cand = np.nonzero(free)[0]
        if cand.size == 0:
            pairs.append((int(u), -1))
            continue
        o = shared[u, cand]
        v = int(cand[np.lexsort((np.abs(cand - u), cnt[u] + cnt[cand] - 2 * o, -o))[0]])
        free[v] = False
        pairs.append((int(u), v))
    return pairs


def bwd_plan(layout: np.ndarray, block: int, causal: bool, which: str) -> np.ndarray:
    """The wgmma route's schedule of kernel ``which`` ("dq" or "dkv") for one
    batch row → flat int32. At blocks of 16 and 32 it is the grouped plan
    of that side (:func:`dkv_group_plan`); at 64 and 128: ``H * ceil(U /
    2)`` headers ``(unit 0, unit 1 or -1, offset, tile count)``, then the
    tile entries. The forward walks the same tiles as dq at every block (a
    query unit's kidx rows, cut by the causal rule where a tile starts past
    the unit's last query), so "dq" is the forward's schedule too: no second
    plan is built.

    An item is two units of one head (numbered ``h * U + u``, U = S / 64,
    paired by :func:`_pair_units` for the tiles they share), the two
    consumer warpgroups of the kernel's block one unit each: every tile
    either walks is loaded once for both. Its entries (from the offset on,
    after the headers) are the union of the units' tiles
    (:func:`_unit_tiles`), ascending, each ``first row * 4 + (bit c: unit c
    walks it)``. Headers are sorted by tile count, heaviest first, ties by
    unit 0. The kernel runs each header once per batch row, the B items of
    a header one after another, and deals the items to its persistent
    blocks in that order."""
    if block in GROUP_BLOCKS:
        return dkv_group_plan(layout, block, causal, which)[0]
    walk = _unit_tiles(layout, block, causal, which)
    H, U, _ = walk.shape
    heads, runs = [], []
    for h in range(H):
        for a, b in _pair_units(walk[h]):
            either = walk[h, a] | (walk[h, b] if b >= 0 else False)
            tiles = np.nonzero(either)[0]
            bits = walk[h, a, tiles] + (2 * walk[h, b, tiles] if b >= 0 else 0)
            heads.append((h * U + a, h * U + b if b >= 0 else -1, len(tiles)))
            runs.append(tiles * TILE * 4 + bits)
    order = sorted(range(len(heads)), key=lambda i: (-heads[i][2], heads[i][0]))
    header = np.zeros((len(heads), 4), np.int32)
    offset = 0
    for r, i in enumerate(order):
        header[r] = (heads[i][0], heads[i][1], offset, heads[i][2])
        offset += heads[i][2]
    return np.concatenate([header.ravel()] + [runs[i] for i in order]).astype(np.int32)


# blocks whose units gather several blocks (64 / block of them): key blocks
# for dk/dv, query blocks for the forward and dq
GROUP_BLOCKS = (16, 32)


def _union_tiles(blocks, lists, G: int, causal: bool, which: str):
    """A unit's tiles: the union of its blocks' lists, ascending, G blocks
    at a time (the last tile short); under the causal rule the blocks
    wholly masked for every block of the unit are dropped first: for dk/dv
    the query blocks before its first key block, for dq the key blocks
    after its last query block."""
    union = sorted(set().union(*(lists[j] for j in blocks)))
    if causal:
        union = ([b for b in union if b >= min(blocks)] if which == "dkv" else
                 [b for b in union if b <= max(blocks)])
    return [tuple(union[t: t + G]) for t in range(0, len(union), G)]


def _group_units(lists, block: int, causal: bool, which: str):
    """One head's units at a block of 16 or 32 → [unit blocks], each list
    ascending and up to ``G = 64 / block`` long, from ``lists[j]``, the
    blocks that block j walks (for dk/dv key block j's query list, a qidx
    row; for dq query block j's key list, a kidx row). Blocks whose lists
    are equal form groups, cut into units of G blocks in order (BERT's fixed
    layout: for dk/dv the 3 local key blocks of a window and 4 of its 8
    global ones, for dq the 4 query blocks of a window). A short unit left
    over then takes other short units, the best of the next 8 (the nearest
    on a tie), while that costs no more tiles than walking them apart
    (:func:`_union_tiles`: the union of the lists a tile per G blocks), so
    layouts whose lists rarely repeat (bigbird's random blocks) still fill
    their 64-row units. A block with an empty list stays in a unit, which
    stores its zeros (dk/dv) or its poisoned rows (the forward)."""
    G = TILE // block
    groups: Dict[tuple, list] = {}
    for j, lst in enumerate(lists):
        groups.setdefault(tuple(sorted(lst)), []).append(j)
    full, short = [], []
    for blocks in groups.values():
        for s in range(0, len(blocks), G):
            (full if len(blocks[s: s + G]) == G else short).append(blocks[s: s + G])
    short.sort()
    units, window = full, 8
    cost = lambda blocks: len(_union_tiles(blocks, lists, G, causal, which))  # noqa: E731
    while short:
        unit = short.pop(0)
        while len(unit) < G:
            best, saving = None, -1
            for i, other in enumerate(short[:window]):
                if len(unit) + len(other) <= G:
                    d = cost(unit) + cost(other) - cost(unit + other)
                    if d > saving:
                        best, saving = i, d
            if best is None:
                break
            unit = sorted(unit + short.pop(best))
        units.append(unit)
    return [(sorted(u), _union_tiles(u, lists, G, causal, which)) for u in units]


def dkv_group_plan(layout: np.ndarray, block: int, causal: bool,
                   which: str = "dkv") -> Tuple[np.ndarray, int]:
    """The grouped schedule at blocks of 16 and 32 for one batch row →
    (flat int32, the number of headers): dk/dv's (``which`` "dkv"), or the
    query side's mirror (``which`` "dq"), which dq and the forward both
    walk. A unit is up to ``G = 64 / block`` blocks of one head (key blocks
    for dk/dv, query blocks for dq; :func:`_group_units`, on the layout's
    columns for dk/dv and its rows for dq), loaded into one 64-row tile a
    block at a time; rows past its blocks are padding, masked and never
    stored. An item is two units of one head paired by :func:`_pair_units`
    for the tiles they share, each a consumer warpgroup's. A header is ``4 +
    2 G`` ints: (head, offset, tile count, 0, unit 0's blocks, unit 1's
    blocks), -1 past a unit's blocks and for a missing unit 1; headers
    heaviest first, ties by head and first block. From the offset on (after
    the headers), a tile is G ints, the blocks of the other side (query
    blocks for dk/dv, key blocks for dq), ``block * 256 + m1 * 16 + m0``, -1
    past the last (padding): bit j of ``m_c`` says that block j of unit c
    lists this block (0 where unit c does not walk the tile). The kernels
    load a tile whose G blocks are consecutive as one 64-row box, any other
    a block at a time."""
    if block not in GROUP_BLOCKS or which not in ("dq", "dkv"):
        raise ValueError(f"dkv_group_plan: block {block} not in {GROUP_BLOCKS}, or kernel "
                         f"{which!r} is not 'dq' / 'dkv'")
    layout = np.asarray(layout, bool)
    G = TILE // block
    heads, runs = [], []
    for h in range(layout.shape[0]):
        lay = layout[h] if which == "dkv" else layout[h].T  # [other block, unit block]
        lists = [set(np.nonzero(lay[:, j])[0].tolist()) for j in range(lay.shape[1])]
        units = _group_units(lists, block, causal, which)
        names = sorted({t for _, tiles in units for t in tiles})
        walk = np.zeros((len(units), len(names)), bool)
        for u, (_, tiles) in enumerate(units):
            walk[u, [names.index(t) for t in tiles]] = True
        for a, b in _pair_units(walk):
            either = np.nonzero(walk[a] | (walk[b] if b >= 0 else False))[0]
            recs = np.full((len(either), G), -1, np.int64)
            for r, t in enumerate(either):
                for g, ob in enumerate(names[t]):
                    masks = [sum(1 << j for j, ub in enumerate(units[u][0]) if ob in lists[ub])
                             if u >= 0 and walk[u, t] else 0 for u in (a, b)]
                    recs[r, g] = ob * 256 + masks[1] * 16 + masks[0]
            blocks = np.full(2 * G, -1, np.int64)
            for c, u in enumerate((a, b)):
                if u >= 0:
                    blocks[c * G: c * G + len(units[u][0])] = units[u][0]
            heads.append((h, blocks))
            runs.append(recs)
    order = sorted(range(len(heads)), key=lambda i: (-len(runs[i]), heads[i][0],
                                                     heads[i][1][0]))
    header = np.zeros((len(heads), 4 + 2 * G), np.int64)
    offset = 0
    for r, i in enumerate(order):
        header[r, :3] = (heads[i][0], offset, len(runs[i]))
        header[r, 4:] = heads[i][1]
        offset += len(runs[i])
    body = [runs[i].ravel() for i in order]
    return np.concatenate([header.ravel()] + body).astype(np.int32), len(heads)


@dataclass(frozen=True, eq=False)
class IndexLists:
    """A layout and its index lists on one device, and the wgmma kernels'
    schedules (:func:`bwd_plan`: "dq", which the forward walks too, and
    "dkv"), built at first use and kept."""

    layout: np.ndarray  # [H, nQ, nK] bool, on the host
    block: int
    kidx: torch.Tensor  # [H, nQ, maxK] int32
    kcnt: torch.Tensor  # [H, nQ] int32
    qidx: torch.Tensor  # [H, nK, maxQ] int32
    qcnt: torch.Tensor  # [H, nK] int32
    plans: Dict[tuple, Tuple[torch.Tensor, int]] = field(default_factory=dict, repr=False)

    def _plan(self, which: str, causal: bool) -> Tuple[torch.Tensor, int]:
        key = (which, bool(causal))
        hit = self.plans.get(key)
        if hit is None:
            if self.block in GROUP_BLOCKS:
                flat, n = dkv_group_plan(self.layout, self.block, causal, which)
            else:  # ceil(U / 2) headers a head, U = S / 64
                flat = bwd_plan(self.layout, self.block, causal, which)
                H, nb = self.layout.shape[:2]
                n = H * ((nb * self.block // TILE + 1) // 2)
            hit = (torch.from_numpy(flat).to(self.kidx.device), n)
            self.plans[key] = hit
        return hit

    def bwd_plan(self, which: str, causal: bool) -> torch.Tensor:
        """The schedule of kernel ``which`` ("dq", which the forward walks
        too, or "dkv") under ``causal`` as an int32 tensor on the lists'
        device: the same tensor on every call."""
        return self._plan(which, causal)[0]

    def plan_items(self, which: str, causal: bool) -> int:
        """The number of headers of that schedule (items a batch row)."""
        return self._plan(which, causal)[1]

    def dense_mask(self, device) -> torch.Tensor:
        """``[H, S, S]`` bool: the layout's element mask (what the plain
        versions and the library yardstick use)."""
        lay = torch.from_numpy(self.layout).to(device)
        return lay.repeat_interleave(self.block, 1).repeat_interleave(self.block, 2)


_CACHE: Dict[tuple, IndexLists] = {}


def _freeze(x):
    return tuple(_freeze(v) for v in x) if isinstance(x, (list, tuple)) else x


def _lists(key, make_layout, block: int, device) -> IndexLists:
    hit = _CACHE.get(key)
    if hit is not None:
        CACHE_STATS["hits"] += 1
        return hit
    CACHE_STATS["misses"] += 1
    layout = np.asarray(make_layout(), bool)
    kidx, kcnt, qidx, qcnt = (torch.from_numpy(a).to(device)
                              for a in layout_to_index_lists(layout))
    lists = IndexLists(layout, int(block), kidx, kcnt, qidx, qcnt)
    _CACHE[key] = lists
    return lists


def index_lists(sparsity_config, seq_len: int, device) -> IndexLists:
    """The layout of ``sparsity_config`` at ``seq_len`` and its index lists
    on ``device``, built once and kept. The key is the config's class and
    field values (not its identity), so an equal config shares the entry
    and a changed one gets its own."""
    device = torch.device(device)
    fields = tuple(sorted((k, _freeze(v)) for k, v in vars(sparsity_config).items()))
    key = ("config", type(sparsity_config).__name__, fields, int(seq_len), str(device))
    return _lists(key, lambda: sparsity_config.make_layout(int(seq_len)),
                  sparsity_config.block, device)


def lists_from_layout(layout: np.ndarray, block: int, device) -> IndexLists:
    """The index lists of an explicit ``[H, nQ, nK]`` layout on ``device``
    (cached by the layout's bytes)."""
    layout = np.asarray(layout, bool)
    device = torch.device(device)
    key = ("layout", layout.shape, layout.tobytes(), int(block), str(device))
    return _lists(key, lambda: layout, block, device)


def _check_layout(name, q, lists: IndexLists):
    B, S, H, D = q.shape
    nQ = S // lists.block
    if S % lists.block or lists.layout.shape != (H, nQ, nQ):
        raise ValueError(
            f"{name}: layout {lists.layout.shape} (block {lists.block}) does not fit q "
            f"{tuple(q.shape)}: expected ({H}, {nQ}, {nQ}) with S a multiple of the block"
        )


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _keep(lists: IndexLists, causal: bool, device) -> torch.Tensor:
    """``[H, S, S]`` bool: key j computed for query i (the layout's mask,
    and j <= i when causal)."""
    keep = lists.dense_mask(device)
    if causal:
        S = keep.shape[-1]
        keep = keep & torch.ones(S, S, dtype=torch.bool, device=device).tril()
    return keep


def _scores(q, k, keep, scale):
    """Masked scaled scores ``[B, H, S, S]`` f32."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    return s.masked_fill(~keep, NEG_INF)


def block_sparse_attention_fwd_ref(q, k, v, lists: IndexLists, causal: bool = False,
                                   sm_scale: Optional[float] = None):
    """Plain PyTorch forward → ``(o [B, S, H, D] in q.dtype, lse [B, H, S]
    f32)``; a row with no kept score gets o = 0 and lse = +1e30."""
    _check_layout("block_sparse_attention_fwd_ref", q, lists)
    s = _scores(q, k, _keep(lists, causal, q.device), _scale(q.shape[-1], sm_scale))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = o / l.permute(0, 2, 1, 3)
    valid = m > NEG_INF * 0.5  # [B, H, S, 1]
    o = torch.where(valid.permute(0, 2, 1, 3), o, torch.zeros_like(o))
    lse = torch.where(valid, m + torch.log(l), torch.full_like(m, -NEG_INF))
    return o.to(q.dtype), lse[..., 0]


def block_sparse_delta(o, do):
    """``delta = rowsum(dO * O)`` → ``[B, H, S]`` f32 (outside the kernels,
    as in the JAX package)."""
    return (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()


def _p_ds(q, k, v, do, lse, delta, lists, causal, scale):
    """The backward's recomputed ``p`` and ``ds`` (rounded to q's dtype),
    ``[B, H, S, S]`` f32."""
    p = torch.exp(_scores(q, k, _keep(lists, causal, q.device), scale) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    return p, ds


def block_sparse_attention_dq_ref(q, k, v, do, lse, delta, lists: IndexLists,
                                  causal: bool = False, sm_scale: Optional[float] = None):
    """Plain version of the dq kernel → dq ``[B, S, H, D]`` in q's dtype."""
    _check_layout("block_sparse_attention_dq_ref", q, lists)
    scale = _scale(q.shape[-1], sm_scale)
    _, ds = _p_ds(q, k, v, do, lse, delta, lists, causal, scale)
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale).to(q.dtype)


def block_sparse_attention_dkv_ref(q, k, v, do, lse, delta, lists: IndexLists,
                                   causal: bool = False, sm_scale: Optional[float] = None):
    """Plain version of the dk/dv kernel → (dk, dv) ``[B, S, H, D]``."""
    _check_layout("block_sparse_attention_dkv_ref", q, lists)
    scale = _scale(q.shape[-1], sm_scale)
    p, ds = _p_ds(q, k, v, do, lse, delta, lists, causal, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def block_sparse_attention_bwd_ref(q, k, v, o, lse, do, lists: IndexLists,
                                   causal: bool = False, sm_scale: Optional[float] = None):
    """Plain PyTorch backward → ``(dq, dk, dv)`` from the saved ``o`` and
    ``lse`` by the kernels' recompute formula."""
    delta = block_sparse_delta(o, do)
    dq = block_sparse_attention_dq_ref(q, k, v, do, lse, delta, lists, causal, sm_scale)
    dk, dv = block_sparse_attention_dkv_ref(q, k, v, do, lse, delta, lists, causal, sm_scale)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

def _check(name, q, lists: IndexLists, tensors):
    if q.dim() != 4:
        raise ValueError(f"{name}: expected q [B, S, H, D], got {tuple(q.shape)}")
    B, S, H, D = q.shape
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: q is {q.dtype}; the kernels take float32, float16, bfloat16")
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} not in {HEAD_DIMS} (the kernels are built "
                         "for these; the JAX kernel takes any multiple of 8)")
    if lists.block not in BLOCKS:
        raise ValueError(f"{name}: sparsity block {lists.block} not in {BLOCKS} (the kernels "
                         "are built for these; the JAX kernel takes any multiple of 8)")
    _check_layout(name, q, lists)
    if lists.kidx.device != q.device:
        raise ValueError(f"{name}: index lists on {lists.kidx.device}, q on {q.device}")
    for what, t in tensors.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name}: {what} is on {t.device}, expected every operand on "
                             "the one CUDA device of q")
        if t.shape != q.shape:
            raise ValueError(f"{name}: {what} {tuple(t.shape)} must be q's shape "
                             f"{tuple(q.shape)}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: {what} is {t.dtype}, expected q's dtype {q.dtype}")
        if not _strides_ok(t):
            raise ValueError(
                f"{name}: {what} needs a contiguous last dim, 16-byte aligned data and "
                f"strides that are multiples of 16 bytes; got strides {t.stride()}"
            )


def wgmma_route(q) -> bool:
    """The kernels' rule on q's dtype and head dim alone: bf16/fp16 at head
    dim 64 or 128 take the TMA + wgmma kernels, the forward, dq and dk/dv
    alike, at every block (q, k, v and dO read through TMA tensor maps,
    which need positive batch, sequence and head strides under 2^40 bytes;
    at blocks of 16 and 32 a unit gathers query blocks for the forward and
    dq, key blocks for dk/dv, into 64 rows). fp32 takes the FMA kernels;
    other head dims raise."""
    return q.dtype in TMA_DTYPES and q.shape[-1] in HEAD_DIMS


def _plan_args(name, which, lists: IndexLists, causal, **tensors) -> Tuple[int, int]:
    """The schedule's pointer and header count on the wgmma route (after the
    TMA maps' stride check of ``tensors``), (0, 0) on the others. The
    forward walks dq's schedule."""
    if not wgmma_route(tensors["q"]):
        return 0, 0
    _check_tma(name, tensors)
    return lists.bwd_plan(which, causal).data_ptr(), lists.plan_items(which, causal)


def _check_rows(name, q, **rows):
    B, S, H, _ = q.shape
    for what, t in rows.items():
        if (t.dtype != torch.float32 or tuple(t.shape) != (B, H, S) or not t.is_contiguous()
                or t.device != q.device or t.data_ptr() % 16):
            raise ValueError(f"{name}: {what} must be a contiguous, 16-byte aligned [B, H, S] "
                             "float32 tensor on q's device")


def _stream(q) -> int:
    return torch.cuda.current_stream(q.device).cuda_stream


def block_sparse_attention_fwd(q, k, v, lists: IndexLists, causal: bool = False,
                               sm_scale: Optional[float] = None):
    """Launch the forward kernel on ``torch.cuda.current_stream()`` → ``(o
    [B, S, H, D] contiguous in q.dtype, lse [B, H, S] f32)``. The kernel is
    the one :func:`wgmma_route` names for the shape; on the wgmma route it
    walks dq's cached schedule ``lists.bwd_plan("dq", causal)`` (the same
    tiles). Raises on what the kernels do not take (device, dtype, head
    dim, block, strides; on the wgmma route strides a TMA map cannot take)."""
    name = "block_sparse_attention_fwd"
    _check(name, q, lists, {"q": q, "k": k, "v": v})
    B, S, H, D = q.shape
    o = torch.empty(B, S, H, D, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    if B == 0:
        return o, lse
    plan, n_headers = _plan_args(name, "dq", lists, causal, q=q, k=k, v=v)
    from .op_builder import load

    lib = load(name)
    err = lib.block_sparse_attention_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        lists.kidx.data_ptr(), lists.kcnt.data_ptr(), plan, n_headers,
        B, S, H, D, lists.block, lists.kidx.shape[2],
        *_strides3(q), *_strides3(k), *_strides3(v),
        int(bool(causal)), ctypes.c_float(_scale(D, sm_scale)), DTYPE_CODES[q.dtype], _stream(q),
    )
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {err}")
    LAUNCHES[name] += 1
    return o, lse


def block_sparse_attention_dq(q, k, v, do, lse, delta, lists: IndexLists, causal: bool = False,
                              sm_scale: Optional[float] = None):
    """Launch the dq kernel → dq ``[B, S, H, D]`` contiguous in q's dtype.
    The kernel is the one :func:`wgmma_route` names for the shape; on the
    wgmma route it walks the cached schedule ``lists.bwd_plan("dq",
    causal)``. Raises on what the kernels do not take (as the forward, and
    on the wgmma route strides a TMA map cannot take)."""
    name = "block_sparse_attention_dq"
    _check(name, q, lists, {"q": q, "k": k, "v": v, "do": do})
    _check_rows(name, q, lse=lse, delta=delta)
    B, S, H, D = q.shape
    dq = torch.empty(B, S, H, D, dtype=q.dtype, device=q.device)
    if B == 0:
        return dq
    plan, n_headers = _plan_args(name, "dq", lists, causal, q=q, k=k, v=v, do=do)
    from .op_builder import load

    lib = load("block_sparse_attention_bwd")
    err = lib.block_sparse_attention_dq_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), lists.kidx.data_ptr(), lists.kcnt.data_ptr(), plan,
        n_headers, B, S, H, D, lists.block, lists.kidx.shape[2],
        *_strides3(q), *_strides3(k), *_strides3(v), *_strides3(do),
        int(bool(causal)), ctypes.c_float(_scale(D, sm_scale)), DTYPE_CODES[q.dtype], _stream(q),
    )
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {err}")
    LAUNCHES[name] += 1
    return dq


def block_sparse_attention_dkv(q, k, v, do, lse, delta, lists: IndexLists,
                               causal: bool = False, sm_scale: Optional[float] = None):
    """Launch the dk/dv kernel → (dk, dv) ``[B, S, H, D]`` contiguous. The
    kernel is the one :func:`wgmma_route` names for the shape (the wgmma
    kernel at every block in bf16/fp16), walking the cached schedule
    ``lists.bwd_plan("dkv", causal)`` (grouped units at blocks of 16 and
    32); it raises as dq's."""
    name = "block_sparse_attention_dkv"
    _check(name, q, lists, {"q": q, "k": k, "v": v, "do": do})
    _check_rows(name, q, lse=lse, delta=delta)
    B, S, H, D = q.shape
    dk = torch.empty(B, S, H, D, dtype=q.dtype, device=q.device)
    dv = torch.empty(B, S, H, D, dtype=q.dtype, device=q.device)
    if B == 0:
        return dk, dv
    plan, n_headers = _plan_args(name, "dkv", lists, causal, q=q, k=k, v=v, do=do)
    from .op_builder import load

    lib = load("block_sparse_attention_bwd")
    err = lib.block_sparse_attention_dkv_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), lists.qidx.data_ptr(),
        lists.qcnt.data_ptr(), plan, n_headers, B, S, H, D, lists.block, lists.qidx.shape[2],
        *_strides3(q), *_strides3(k), *_strides3(v), *_strides3(do),
        int(bool(causal)), ctypes.c_float(_scale(D, sm_scale)), DTYPE_CODES[q.dtype], _stream(q),
    )
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {err}")
    LAUNCHES[name] += 1
    return dk, dv


def block_sparse_attention_bwd(q, k, v, o, lse, do, lists: IndexLists, causal: bool = False,
                               sm_scale: Optional[float] = None):
    """delta (a torch op), then the dq and dk/dv kernels → ``(dq, dk, dv)``."""
    delta = block_sparse_delta(o, do)
    dq = block_sparse_attention_dq(q, k, v, do, lse, delta, lists, causal, sm_scale)
    dk, dv = block_sparse_attention_dkv(q, k, v, do, lse, delta, lists, causal, sm_scale)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

def _kernel_layouts(*tensors):
    """The layouts the kernels read (16-byte strides; TMA maps on the wgmma
    route), not another route: a tensor that has them as it is, else a
    contiguous copy."""
    return tuple(x if _strides_ok(x) and _tma_strides_ok(x) else x.contiguous()
                 for x in tensors)


def _on(device, kernel, plain, what):
    if device.type == "cuda":
        return kernel
    if device.type == "cpu":
        return plain
    raise ValueError(f"block-sparse attention {what}: no implementation for device {device}")


def forward_backward(device):
    """``(forward, backward)`` for tensors on ``device``: the kernels for
    CUDA, the plain versions for the CPU; any other device raises."""
    return (_on(device, block_sparse_attention_fwd, block_sparse_attention_fwd_ref, "forward"),
            _on(device, block_sparse_attention_bwd, block_sparse_attention_bwd_ref, "backward"))


class BlockSparseAttention(torch.autograd.Function):
    """o = block-sparse attention(q, k, v); saves ``(q, k, v, o, lse)``.
    CUDA tensors run the kernels, CPU tensors their plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, lists, causal, sm_scale):
        fwd = _on(q.device, block_sparse_attention_fwd, block_sparse_attention_fwd_ref,
                  "forward")
        if q.device.type == "cuda":
            q, k, v = _kernel_layouts(q, k, v)
        o, lse = fwd(q, k, v, lists, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = (lists, causal, sm_scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = _on(q.device, block_sparse_attention_bwd, block_sparse_attention_bwd_ref,
                  "backward")
        if do.device.type == "cuda":
            q, k, v, do = _kernel_layouts(q, k, v, do)
        dq, dk, dv = bwd(q, k, v, o, lse, do, *ctx.opts)
        return dq, dk, dv, None, None, None


def block_sparse(q, k, v, lists: IndexLists, causal: bool = False,
                 sm_scale: Optional[float] = None):
    """The autograd Function over prepared index lists."""
    _check_layout("block_sparse_attention", q, lists)
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"block_sparse_attention: k {tuple(k.shape)} / v {tuple(v.shape)} "
                         f"must be q's shape {tuple(q.shape)}")
    return BlockSparseAttention.apply(q, k, v, lists, bool(causal), sm_scale)


def block_sparse_attention(q, k, v, layout: np.ndarray, block: int, causal: bool = False,
                           sm_scale: Optional[float] = None):
    """``[B, S, H, D]`` block-sparse attention under a static ``[H, nQ, nK]``
    layout (the JAX entry's signature, without ``interpret``)."""
    B, S, H, D = q.shape
    nQ = S // block
    layout = np.asarray(layout, bool)
    if layout.shape != (H, nQ, nQ):
        raise ValueError(f"layout {layout.shape} != {(H, nQ, nQ)}")
    return block_sparse(q, k, v, lists_from_layout(layout, block, q.device), causal, sm_scale)
