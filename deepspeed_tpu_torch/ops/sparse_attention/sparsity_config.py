"""Block-sparsity patterns (counterpart of
``deepspeed_tpu/ops/sparse_attention/sparsity_config.py``, kept as its own
copy: numpy only).

A config produces a *layout*: a bool array ``[num_heads, n_blocks,
n_blocks]`` marking which (query block, key block) pairs are computed. The
layout feeds the block-sparse kernels (``ops/block_sparse_attention.py``,
which skip inactive blocks) or the masked-dense plain path. Layouts are
identical bit for bit to the JAX package's, and the constructors raise the
same errors.

Patterns:
- **Dense**: everything active (causality applied at run time).
- **Fixed** (Sparse Transformers): blocks attend within their local window
  plus to the window-tail global blocks; optionally different global
  choices per head.
- **BSLongformer**: sliding diagonal window + global blocks with full rows
  and columns.
- **BigBird**: sliding window + global first/last blocks + per-row random
  blocks (seeded ``np.random.RandomState``).
- **Variable**: custom-size local windows + explicit global block indices.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


class SparsityConfig:
    """Base: common fields + helpers (reference SparsityConfig)."""

    def __init__(self, num_heads: int, block: int = 16, different_layout_per_head: bool = False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head

    def setup_layout(self, seq_len: int) -> np.ndarray:
        if seq_len % self.block != 0:
            raise ValueError(f"seq_len {seq_len} not a multiple of block {self.block}")
        n = seq_len // self.block
        return np.zeros((self.num_heads, n, n), dtype=bool)

    def make_layout(self, seq_len: int) -> np.ndarray:
        raise NotImplementedError


class DenseSparsityConfig(SparsityConfig):
    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        layout[:] = True
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Sparse-Transformers-style fixed pattern (reference FixedSparsityConfig).

    Each block attends to all blocks of its own local stride window
    (``num_local_blocks``); additionally the last ``num_global_blocks`` of
    each window act as global summary blocks every later block attends to.
    ``attention='unidirectional'`` restricts to j <= i at runtime;
    ``horizontal_global_attention`` gives global blocks full rows too.
    ``num_different_global_patterns`` rotates which window-tail block is
    global across head groups.
    """

    def __init__(
        self,
        num_heads: int,
        block: int = 16,
        different_layout_per_head: bool = False,
        num_local_blocks: int = 4,
        num_global_blocks: int = 1,
        attention: str = "bidirectional",
        horizontal_global_attention: bool = False,
        num_different_global_patterns: int = 1,
    ):
        super().__init__(num_heads, block, different_layout_per_head)
        if attention not in ("unidirectional", "bidirectional"):
            raise ValueError(f"invalid attention {attention!r}")
        if horizontal_global_attention and attention != "bidirectional":
            raise ValueError("horizontal_global_attention requires bidirectional attention")
        if num_different_global_patterns > 1 and not different_layout_per_head:
            raise ValueError("num_different_global_patterns > 1 requires different_layout_per_head")
        if num_different_global_patterns > num_local_blocks // num_global_blocks:
            raise ValueError(
                f"num_different_global_patterns {num_different_global_patterns} exceeds "
                f"num_local_blocks/num_global_blocks = {num_local_blocks}/{num_global_blocks}"
            )
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.num_different_global_patterns = num_different_global_patterns

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        H, n, _ = layout.shape
        L, G = self.num_local_blocks, self.num_global_blocks
        for h in range(H):
            pat = (h % self.num_different_global_patterns) if self.different_layout_per_head else 0
            for i in range(n):
                w = i // L
                # local: own window
                lo = w * L
                layout[h, i, lo : min(lo + L, n)] = True
                # global columns: the pattern-selected tail blocks of every window
                for w2 in range(n // L + 1):
                    g_end = min((w2 + 1) * L, n)
                    g_start = max(0, g_end - G * (pat + 1))
                    g_stop = max(0, g_end - G * pat)
                    layout[h, i, g_start:g_stop] = True
            if self.horizontal_global_attention:
                for w2 in range(n // L + 1):
                    g_end = min((w2 + 1) * L, n)
                    pat0 = 0
                    g_start = max(0, g_end - G * (pat0 + 1))
                    layout[h, g_start:g_end, :] = True
        if self.attention == "unidirectional":
            tril = np.tril(np.ones((n, n), dtype=bool))
            layout &= tril[None]
        return layout


class BSLongformerSparsityConfig(SparsityConfig):
    """Block-sparse Longformer: sliding window + global blocks
    (reference BSLongformerSparsityConfig)."""

    def __init__(
        self,
        num_heads: int,
        block: int = 16,
        different_layout_per_head: bool = False,
        num_sliding_window_blocks: int = 3,
        global_block_indices: Sequence[int] = (0,),
        global_block_end_indices: Optional[Sequence[int]] = None,
        attention: str = "bidirectional",
    ):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = list(global_block_indices)
        self.global_block_end_indices = (
            list(global_block_end_indices) if global_block_end_indices else None
        )
        self.attention = attention

    def _global_ranges(self, n: int):
        if self.global_block_end_indices is None:
            return [(i, i + 1) for i in self.global_block_indices if i < n]
        return [
            (s, min(e, n))
            for s, e in zip(self.global_block_indices, self.global_block_end_indices)
            if s < n
        ]

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        H, n, _ = layout.shape
        w = self.num_sliding_window_blocks // 2
        for i in range(n):
            layout[:, i, max(0, i - w) : min(n, i + w + 1)] = True
        for s, e in self._global_ranges(n):
            layout[:, :, s:e] = True  # global columns
            layout[:, s:e, :] = True  # global rows
        if self.attention == "unidirectional":
            layout &= np.tril(np.ones((n, n), dtype=bool))[None]
        return layout


class BigBirdSparsityConfig(SparsityConfig):
    """BigBird: window + global + random blocks (reference BigBirdSparsityConfig)."""

    def __init__(
        self,
        num_heads: int,
        block: int = 16,
        different_layout_per_head: bool = False,
        num_random_blocks: int = 1,
        num_sliding_window_blocks: int = 3,
        num_global_blocks: int = 1,
        attention: str = "bidirectional",
        seed: int = 0,
    ):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.seed = seed

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        H, n, _ = layout.shape
        g, w = self.num_global_blocks, self.num_sliding_window_blocks // 2
        rng = np.random.RandomState(self.seed)
        for i in range(n):
            layout[:, i, max(0, i - w) : min(n, i + w + 1)] = True
        layout[:, :g, :] = True
        layout[:, :, :g] = True
        layout[:, -g:, :] = True
        layout[:, :, -g:] = True
        n_heads_random = H if self.different_layout_per_head else 1
        for h in range(n_heads_random):
            for i in range(n):
                k = min(self.num_random_blocks, n)
                cols = rng.choice(n, size=k, replace=False)
                layout[h, i, cols] = True
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        if self.attention == "unidirectional":
            layout &= np.tril(np.ones((n, n), dtype=bool))[None]
        return layout


class VariableSparsityConfig(SparsityConfig):
    """Custom local windows + explicit global blocks (reference
    VariableSparsityConfig). ``local_window_blocks`` lists consecutive window
    sizes from sequence start; the last size repeats to cover the rest."""

    def __init__(
        self,
        num_heads: int,
        block: int = 16,
        different_layout_per_head: bool = False,
        num_random_blocks: int = 0,
        local_window_blocks: Sequence[int] = (4,),
        global_block_indices: Sequence[int] = (0,),
        global_block_end_indices: Optional[Sequence[int]] = None,
        attention: str = "bidirectional",
        horizontal_global_attention: bool = False,
        seed: int = 0,
    ):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = list(local_window_blocks)
        self.global_block_indices = list(global_block_indices)
        self.global_block_end_indices = (
            list(global_block_end_indices) if global_block_end_indices else None
        )
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.seed = seed

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        H, n, _ = layout.shape
        # local windows of varying size
        start = 0
        sizes = list(self.local_window_blocks)
        while start < n:
            size = sizes.pop(0) if sizes else self.local_window_blocks[-1]
            end = min(start + size, n)
            layout[:, start:end, start:end] = True
            start = end
        # globals
        if self.global_block_end_indices is None:
            ranges = [(i, i + 1) for i in self.global_block_indices if i < n]
        else:
            ranges = [
                (s, min(e, n))
                for s, e in zip(self.global_block_indices, self.global_block_end_indices)
                if s < n
            ]
        for s, e in ranges:
            layout[:, :, s:e] = True
            if self.horizontal_global_attention:
                layout[:, s:e, :] = True
        # random
        if self.num_random_blocks:
            rng = np.random.RandomState(self.seed)
            n_heads_random = H if self.different_layout_per_head else 1
            for h in range(n_heads_random):
                for i in range(n):
                    cols = rng.choice(n, size=min(self.num_random_blocks, n), replace=False)
                    layout[h, i, cols] = True
            if not self.different_layout_per_head:
                layout[1:] = layout[0]
        if self.attention == "unidirectional":
            layout &= np.tril(np.ones((n, n), dtype=bool))[None]
        return layout


def layout_to_dense_mask(layout: np.ndarray, block: int) -> np.ndarray:
    """[H, nQ, nK] block layout → [H, S, S] element mask."""
    return np.repeat(np.repeat(layout, block, axis=1), block, axis=2)


def layout_density(layout: np.ndarray) -> float:
    return float(layout.mean())


def from_ds_config(section, num_heads: int) -> SparsityConfig:
    """Map the ``sparse_attention`` config section (runtime/config.py
    SparseAttentionConfig; reference ``get_sparse_attention_config``,
    deepspeed/__init__.py + ops/sparse_attention) to a SparsityConfig.

    ``section`` may be the typed dataclass or a plain dict with the DS JSON
    keys (``mode`` selects the pattern class; remaining keys are that
    pattern's constructor args)."""
    get = section.get if isinstance(section, dict) else lambda k, d=None: getattr(section, k, d)
    mode = (get("mode", "fixed") or "fixed").lower()
    common = dict(
        num_heads=num_heads,
        block=int(get("block", 16)),
        different_layout_per_head=bool(get("different_layout_per_head", False)),
    )
    if mode == "dense":
        return DenseSparsityConfig(**common)
    if mode == "fixed":
        return FixedSparsityConfig(
            **common,
            num_local_blocks=int(get("num_local_blocks", 4)),
            num_global_blocks=int(get("num_global_blocks", 1)),
            attention=get("attention", "bidirectional"),
            horizontal_global_attention=bool(get("horizontal_global_attention", False)),
            num_different_global_patterns=int(get("num_different_global_patterns", 1)),
        )
    nrb = get("num_random_blocks", None)  # None = mode-specific default
    if mode == "bigbird":
        return BigBirdSparsityConfig(
            **common,
            num_random_blocks=1 if nrb is None else int(nrb),
            num_sliding_window_blocks=int(get("num_sliding_window_blocks", 3)),
            num_global_blocks=int(get("num_global_blocks", 1)),
            attention=get("attention", "bidirectional"),
        )
    if mode == "bslongformer":
        return BSLongformerSparsityConfig(
            **common,
            num_sliding_window_blocks=int(get("num_sliding_window_blocks", 3)),
            global_block_indices=get("global_block_indices", [0]) or [0],
            global_block_end_indices=get("global_block_end_indices", None),
            attention=get("attention", "bidirectional"),
        )
    if mode == "variable":
        return VariableSparsityConfig(
            **common,
            num_random_blocks=0 if nrb is None else int(nrb),
            local_window_blocks=get("local_window_blocks", [4]) or [4],
            global_block_indices=get("global_block_indices", [0]) or [0],
            global_block_end_indices=get("global_block_end_indices", None),
            attention=get("attention", "bidirectional"),
            horizontal_global_attention=bool(get("horizontal_global_attention", False)),
        )
    raise ValueError(f"unknown sparse_attention mode {mode!r}")
