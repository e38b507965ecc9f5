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
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

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
    """Host-side per-slot block tables, sequence lengths and last tokens:
    the inputs of the batched decode step. The scheduler mutates them in
    place (admission writes a row, finish clears it)."""

    def __init__(self, max_slots: int, pages_per_slot: int):
        self.max_slots = int(max_slots)
        self.pages_per_slot = int(pages_per_slot)
        self.block_tables = np.full((max_slots, pages_per_slot), SCRATCH_PAGE, np.int32)
        self.seq_lens = np.zeros((max_slots,), np.int32)
        self.tokens = np.zeros((max_slots,), np.int32)

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


def pages_for(tokens: int, page_size: int) -> int:
    """Pages needed to hold ``tokens`` cache entries."""
    return -(-int(tokens) // int(page_size))


def init_pools(n_layer: int, num_pages: int, n_kv_head: int, page_size: int,
               head_dim: int, dtype: torch.dtype = torch.bfloat16, device=None):
    """The shared K and V pools, ``[L, P, KV, page, D]`` zeros on ``device``
    → ``(k_pool, v_pool)``. Per layer a pool is ``[P, KV, page, D]``, the
    layout the decode kernel reads a page row from directly."""
    shape = (n_layer, num_pages, n_kv_head, page_size, head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def pool_bytes(n_layer: int, num_pages: int, n_kv_head: int, page_size: int,
               head_dim: int, itemsize: int = 2) -> int:
    """Device footprint of the K+V pools."""
    return 2 * n_layer * num_pages * n_kv_head * page_size * head_dim * itemsize
