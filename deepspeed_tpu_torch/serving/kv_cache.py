"""Paged KV cache: a fixed pool of fixed-size pages and a free-list
allocator (counterpart of ``deepspeed_tpu/serving/kv_cache.py``).

One preallocated device pool ``[L, P, KV, page, D]`` is carved into pages;
each in-flight sequence owns a list of pages (its block-table row), so
sequences of very different lengths share the pool with at most
``page_size - 1`` wasted slots each.

Page 0 is a permanently reserved scratch page: inactive slots and the
padded tail of block-table rows point at it, so every gather and scatter
index is valid without masking, and garbage writes land where no active
slot reads.

:class:`PrefixCache` indexes full prompt pages by a chained hash so a later
prompt with the same page-aligned prefix maps those pages (refcounted)
instead of recomputing them.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

SCRATCH_PAGE = 0  # reserved: never allocated, absorbs inactive-slot writes


class PageAllocatorError(RuntimeError):
    pass


class PageAllocator:
    """Refcounted free-list allocator over pages ``1..num_pages-1`` (0 =
    scratch). LIFO reuse; ``alloc`` is all-or-nothing at refcount 1;
    ``retain`` adds a reference; ``free`` drops one and returns the page to
    the free list at refcount 0. Double frees, foreign ids and retaining a
    free page raise."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(f"num_pages must be >= 2 (page 0 is scratch), got {num_pages}")
        self.num_pages = int(num_pages)
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))
        self._refs: Dict[int, int] = {}  # page -> refcount (in-use pages only)
        self.cow_forks_total = 0  # bumped by the scheduler's copy-on-write path
        # optional KVHeatLedger (telemetry/kv_heat.py): its hooks fire after
        # each mutation (one None check when heat tracing is off)
        self.heat = None

    @property
    def capacity(self) -> int:
        """Allocatable pages (excludes the scratch page)."""
        return self.num_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return len(self._refs)

    @property
    def pages_shared(self) -> int:
        return sum(1 for c in self._refs.values() if c > 1)

    def refcount(self, page: int) -> int:
        return self._refs.get(int(page), 0)

    def refcounts(self) -> Dict[int, int]:
        """A copy of the page → refcount table (seeds a heat ledger that
        attaches mid-run)."""
        return dict(self._refs)

    def alloc(self, n: int) -> List[int]:
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            raise PageAllocatorError(
                f"KV pool exhausted: need {n} pages, {len(self._free)} free "
                f"of {self.capacity}"
            )
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        if self.heat is not None:
            self.heat.alloc(pages)
        return pages

    def retain(self, pages: Sequence[int]) -> None:
        for p in pages:
            p = int(p)
            if p == SCRATCH_PAGE:
                raise PageAllocatorError("cannot retain the scratch page")
            if p not in self._refs:
                raise PageAllocatorError(f"retain of free/foreign page {p}")
        for p in pages:
            self._refs[int(p)] += 1
        if self.heat is not None:
            self.heat.retain(pages)

    def free(self, pages: Sequence[int]) -> None:
        for p in pages:
            p = int(p)
            if p == SCRATCH_PAGE:
                raise PageAllocatorError("cannot free the scratch page")
            if p not in self._refs:
                raise PageAllocatorError(f"double free / foreign page {p}")
        for p in pages:
            p = int(p)
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                self._free.append(p)
        if self.heat is not None:
            self.heat.free(pages)

    def check_consistent(self) -> Optional[str]:
        """None when the free list and the refcount table partition the
        pool exactly, else a one-line description of the corruption."""
        fset = set(self._free)
        if len(fset) != len(self._free):
            dups = sorted(p for p in fset if self._free.count(p) > 1)
            return f"free list has duplicate pages: {dups[:4]}"
        if SCRATCH_PAGE in fset or SCRATCH_PAGE in self._refs:
            return "scratch page entered the pool"
        overlap = fset & set(self._refs)
        if overlap:
            return f"pages both free and in use: {sorted(overlap)[:4]}"
        bad = sorted(p for p, c in self._refs.items() if c < 1)
        if bad:
            return f"pages with non-positive refcounts: {bad[:4]}"
        if len(fset) + len(self._refs) != self.capacity:
            return (
                f"page conservation violated: {len(fset)} free + "
                f"{len(self._refs)} in use != capacity {self.capacity}"
            )
        oob = sorted(p for p in fset | set(self._refs) if not 1 <= p < self.num_pages)
        if oob:
            return f"page ids out of range: {oob[:4]}"
        return None

    def check_no_leaks(self, allowed: Optional[Sequence[int]] = None) -> None:
        """Raise unless every in-use page is in ``allowed`` (default: none)
        and every allowed page holds exactly one reference."""
        err = self.check_consistent()
        if err:
            raise PageAllocatorError(f"allocator state corrupt: {err}")
        allowed_set = {int(p) for p in (allowed or ())}
        leaked = sorted(p for p in self._refs if p not in allowed_set)
        if leaked:
            raise PageAllocatorError(f"leaked pages: {leaked}")
        over = sorted((p, c) for p, c in self._refs.items() if c != 1)
        if over:
            raise PageAllocatorError(f"pages with nonzero extra refcounts at drain: {over}")


class SlotTable:
    """Host-side per-slot block tables, sequence lengths, last tokens and
    sampling keys (``[max_slots, 2]`` uint32): the inputs of the batched
    decode step. The scheduler mutates them in place (admission writes a
    row, finish clears it).

    ``staging`` (optional): int32 arrays to hold them instead of fresh ones,
    by name (``block_tables``, ``seq_lens``, ``tokens``, ``keys``; any
    subset). The scheduler passes the decode (or verify) program's pinned
    staging arrays, so the table is what one copy uploads each step."""

    def __init__(self, max_slots: int, pages_per_slot: int, staging=None):
        self.max_slots = int(max_slots)
        self.pages_per_slot = int(pages_per_slot)
        shapes = {"block_tables": (max_slots, pages_per_slot), "seq_lens": (max_slots,),
                  "tokens": (max_slots,), "keys": (max_slots, 2)}
        arrays = {}
        for name, shape in shapes.items():
            a = (staging or {}).get(name)
            if a is None:
                a = np.zeros(shape, np.int32)
            elif a.shape != shape or a.dtype != np.int32:
                raise ValueError(f"SlotTable: staging {name} {a.shape} {a.dtype}, expected "
                                 f"{shape} int32")
            arrays[name] = a
        self.block_tables = arrays["block_tables"]
        self.block_tables[:] = SCRATCH_PAGE
        self.seq_lens = arrays["seq_lens"]
        self.seq_lens[:] = 0
        self.tokens = arrays["tokens"]
        self.tokens[:] = 0
        self.keys = arrays["keys"].view(np.uint32)
        self.keys[:] = 0

    def assign(self, slot: int, pages: List[int]) -> None:
        if len(pages) > self.pages_per_slot:
            raise ValueError(
                f"slot {slot}: {len(pages)} pages > table width {self.pages_per_slot}"
            )
        row = self.block_tables[slot]
        row[:] = SCRATCH_PAGE
        row[: len(pages)] = pages

    def clear(self, slot: int) -> None:
        self.block_tables[slot, :] = SCRATCH_PAGE
        self.seq_lens[slot] = 0
        self.tokens[slot] = 0
        self.keys[slot] = 0


def pages_for(tokens: int, page_size: int) -> int:
    """Pages needed to hold ``tokens`` cache entries."""
    return -(-int(tokens) // int(page_size))


def init_pools(n_layer: int, num_pages: int, n_kv_head: int, page_size: int,
               head_dim: int, dtype: torch.dtype = torch.bfloat16, device=None):
    """The shared K and V pools, ``[L, P, KV, page, D]`` zeros on ``device``,
    and the scales pool → ``(k_pool, v_pool, scales)``. Per layer a pool is
    ``[P, KV, page, D]``, the layout the paged kernels read a page row from
    directly.

    An int8 pool holds codes, and ``scales`` is ``[L, P, KV, 2]`` f32 zeros:
    one scale per (layer, page, kv head) for K (index 0) and V (index 1),
    indexed by page id like the pool, so a shared page shares its scale row
    and a recomputed fork writes its own. A full-precision pool has
    ``scales = None``."""
    shape = (n_layer, num_pages, n_kv_head, page_size, head_dim)
    scales = (torch.zeros((n_layer, num_pages, n_kv_head, 2), dtype=torch.float32, device=device)
              if dtype == torch.int8 else None)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device), scales)


def pool_bytes(n_layer: int, num_pages: int, n_kv_head: int, page_size: int,
               head_dim: int, itemsize: int = 2) -> int:
    """Device footprint of the K+V pools (``itemsize`` 1 for int8 codes;
    the scales are counted by :func:`scales_bytes`)."""
    return 2 * n_layer * num_pages * n_kv_head * page_size * head_dim * itemsize


def scales_bytes(n_layer: int, num_pages: int, n_kv_head: int) -> int:
    """Device footprint of an int8 pool's ``[L, P, KV, 2]`` f32 scales."""
    return n_layer * num_pages * n_kv_head * 2 * 4


# ---------------------------------------------------------------------------
# shared-prefix index
# ---------------------------------------------------------------------------

class PrefixCache:
    """Chained-hash index over FULL prompt pages: key (parent key, the
    page's tokens) → the pool page holding that page's K/V (counterpart of
    ``deepspeed_tpu/serving/kv_cache.py`` ``PrefixCache``, with its heat
    hooks and the host tier's demote and adopt hooks).

    After a prompt prefills, each of its full pages is registered here (the
    index ``retain``s the page, so it outlives the request); a later prompt
    walks its own pages through the chain and maps every matching page into
    its block table. The same tokens at the same positions give the same
    K/V, so a mapped page holds what prefill would have written.

    :meth:`lookup` never returns the page holding the prompt's last token
    (the ``(plen-1)//page`` cap): the tail always re-runs through the model
    so the first sampled token has logits. A page-aligned prompt whose last
    page is indexed too is a full hit: that page is reported as
    ``cow_page`` and the scheduler recomputes it into a private page
    (copy-on-write by recompute; the shared original is never written).

    Eviction: LRU among LEAF entries only (evicting a parent would orphan
    its descendants). ``max_pages`` caps the index; the scheduler also
    evicts on pool pressure.

    The host tier's hooks: ``demote_sink`` (a
    :class:`~.tiering.KVTieringEngine`) receives ``(key, pid)`` BEFORE an
    evicted leaf's device page frees, when the index holds the page's last
    reference: the page moves to the host tier instead of vanishing.
    ``victim_order`` ranks the evictable leaves (``[(key, pid)]`` → the
    chosen pair) under the spill policy; None keeps the LRU order.
    :meth:`adopt` re-inserts a restored page under its chain key."""

    def __init__(self, allocator: PageAllocator, page_size: int, max_pages: int = 0):
        self.allocator = allocator
        self.page_size = int(page_size)
        self.max_pages = int(max_pages)
        # key -> page id, in LRU order (move_to_end on every hit)
        self._entries: "OrderedDict[Tuple, int]" = OrderedDict()
        self._children: Dict[Tuple, int] = {}  # key -> number of direct extensions
        self._parent: Dict[Tuple, Optional[Tuple]] = {}
        self.hits_full = 0
        self.hits_partial = 0
        self.misses = 0
        self.evictions = 0
        # optional KVHeatLedger (register/hit/evict hooks)
        self.heat = None
        # the host tier's hooks (class docstring)
        self.demote_sink = None
        self.victim_order = None
        self.demotions = 0
        self.adoptions = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def held_pages(self) -> List[int]:
        return list(self._entries.values())

    @staticmethod
    def _key(parent: Optional[Tuple], tokens) -> Tuple:
        return (parent, tuple(int(t) for t in tokens))

    def _walk(self, prompt, refresh: bool):
        """The indexed chain of ``prompt``'s mappable pages → (page ids,
        last key matched)."""
        plen = int(np.asarray(prompt).shape[-1])
        page = self.page_size
        pages: List[int] = []
        parent: Optional[Tuple] = None
        for j in range(max(0, (plen - 1) // page)):  # last token never shared
            key = self._key(parent, prompt[j * page:(j + 1) * page])
            pid = self._entries.get(key)
            if pid is None:
                break
            if refresh:
                self._entries.move_to_end(key)
            pages.append(pid)
            parent = key
        return pages, parent

    def lookup(self, prompt) -> Tuple[List[int], int, Optional[int]]:
        """→ (shared page ids, shared token count, cow_page), counting the
        hit or miss and refreshing the LRU order of what it matched."""
        plen = int(np.asarray(prompt).shape[-1])
        page = self.page_size
        limit = max(0, (plen - 1) // page)
        pages, parent = self._walk(prompt, refresh=True)
        cow_page: Optional[int] = None
        # a one-page prompt (limit == 0) has nothing to reuse: the tail IS
        # the prompt, so it is a plain miss, never a phantom full hit
        if pages and len(pages) == limit and plen % page == 0:
            key = self._key(parent, prompt[limit * page: plen])
            pid = self._entries.get(key)
            if pid is not None:
                self._entries.move_to_end(key)
                cow_page = pid
        if cow_page is not None:
            self.hits_full += 1
        elif pages:
            self.hits_partial += 1
        else:
            self.misses += 1
        if self.heat is not None and (pages or cow_page is not None):
            hit_pages = pages + ([cow_page] if cow_page is not None else [])
            self.heat.hit(hit_pages, "full" if cow_page is not None else "partial")
        return pages, len(pages) * page, cow_page

    def probe(self, prompt) -> int:
        """How many pages :meth:`lookup` would map right now, without
        counting or refreshing anything (the admission gate calls it every
        step while a request heads the queue)."""
        return len(self._walk(prompt, refresh=False)[0])

    def insert(self, prompt, pages: Sequence[int]) -> int:
        """Register the full pages of ``prompt`` (whose K/V lives in
        ``pages``, the slot's block-table prefix). Pages already indexed are
        refreshed; new ones are ``retain``ed by the index. → pages newly
        indexed."""
        page = self.page_size
        plen = int(np.asarray(prompt).shape[-1])
        parent: Optional[Tuple] = None
        added = 0
        new_pages: List[int] = []
        for j in range(min(plen // page, len(pages))):
            key = self._key(parent, prompt[j * page:(j + 1) * page])
            if key in self._entries:
                self._entries.move_to_end(key)
            else:
                pid = int(pages[j])
                self.allocator.retain([pid])
                self._entries[key] = pid
                self._parent[key] = parent
                self._children[key] = 0
                if parent is not None:
                    self._children[parent] += 1
                added += 1
                new_pages.append(pid)
            parent = key
        if self.heat is not None and new_pages:
            self.heat.register(new_pages)
        if self.max_pages > 0:
            self.evict(keep=self.max_pages)
        return added

    def _evict_one(self) -> bool:
        """Release one evictable LEAF entry: the LRU one, unless a
        ``victim_order`` policy reranks the candidates. → False if none.

        With a ``demote_sink`` wired and the index holding the page's LAST
        reference (a still-shared page stays live with its other holder:
        a host copy would fork ownership), the sink copies the page to the
        host tier FIRST: its ledger D event lands before the F/E pair
        below, so no trace prefix shows the page in neither tier."""
        leaves = [(key, pid) for key, pid in self._entries.items()
                  if self._children.get(key, 0) == 0]
        if not leaves:
            return False
        key, pid = (self.victim_order(leaves) if self.victim_order is not None
                    else leaves[0])  # insertion (recency) order = LRU
        self._entries.pop(key)
        parent = self._parent.pop(key)
        self._children.pop(key, None)
        if parent is not None and parent in self._children:
            self._children[parent] -= 1
        demoted = False
        if self.demote_sink is not None and self.allocator.refcount(pid) == 1:
            if self.demote_sink.demote_begin(key, pid) is not None:
                self.demotions += 1
                demoted = True
        self.allocator.free([pid])
        if self.heat is not None:
            self.heat.evict(pid)
        self.evictions += 1
        if not demoted and self.demote_sink is not None:
            # the key left the device index WITHOUT reaching the host tier
            # (a shared page, or the sink declined): its host-held children
            # just became unreachable; drop them now (ledger V events,
            # after the F/E pair)
            self.demote_sink.drop_orphans()
        return True

    def adopt(self, key: Tuple, pid: int) -> None:
        """Re-insert a host-restored page under its chain ``key`` (the
        restore path). The caller hands over a freshly allocated refcount-1
        page whose K/V was just restored: ownership moves to the index (no
        extra retain), undoing what demotion's free released. The parent
        link must already be resident (restores walk the chain root to
        leaf)."""
        parent = key[0]
        if key in self._entries:
            raise PageAllocatorError(f"prefix key already resident: {key!r}")
        if parent is not None and parent not in self._entries:
            raise PageAllocatorError("adopt out of chain order: parent key not resident")
        self._entries[key] = int(pid)
        self._parent[key] = parent
        self._children[key] = 0
        if parent is not None:
            self._children[parent] += 1
        if self.heat is not None:
            self.heat.register([int(pid)])
        self.adoptions += 1

    def chain_keys(self, prompt) -> List[Tuple]:
        """The prompt's chain keys root to leaf (the ``(plen-1)//page`` cap
        of :meth:`lookup`), resident or not: the restore prefetch walks
        this list checking each tier."""
        plen = int(np.asarray(prompt).shape[-1])
        page = self.page_size
        keys: List[Tuple] = []
        parent: Optional[Tuple] = None
        for j in range(max(0, (plen - 1) // page)):
            key = self._key(parent, prompt[j * page:(j + 1) * page])
            keys.append(key)
            parent = key
        return keys

    def evict(self, keep: Optional[int] = None, need_free: int = 0) -> int:
        """Evict LRU leaves until the index holds at most ``keep`` entries
        (when given) and the allocator has at least ``need_free`` free pages
        (when given); each goal stops mattering once met, so a pressure
        eviction frees only what it needs. An evicted page frees only if the
        index held its last reference. → entries evicted."""
        n = 0
        while self._entries:
            over_cap = keep is not None and len(self._entries) > keep
            starved = need_free > 0 and self.allocator.free_pages < need_free
            if not (over_cap or starved) or not self._evict_one():
                break
            n += 1
        return n

    def clear(self) -> int:
        """Release every index reference (teardown, leak accounting)."""
        return self.evict(keep=0)

    def host_metadata_bytes(self) -> int:
        """Rough host-side footprint of the index structures (the JAX
        package's estimate, so ``stats()`` reports the same number)."""
        import sys

        total = sys.getsizeof(self._entries)
        for key in self._entries:
            total += sys.getsizeof(key) + 2 * len(key[1] or ()) * 28
        return total
