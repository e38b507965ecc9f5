"""ProgramSet: what the serving programs run on, kept together
(counterpart of ``deepspeed_tpu/serving/placement.py`` for one device).

A :class:`ProgramSet` holds the parameters on the device, the two paged
pools ``[L, P, KV, page, D]`` and the page allocator that hands out page ids
in them. Tensor parallelism, meshes and disaggregated placements are not
ported yet; the config refuses them before a ProgramSet is built.
"""

from __future__ import annotations

from typing import Any

import torch

from ..utils.weights import tree_map
from .kv_cache import PageAllocator, init_pools

PyTree = Any


class ProgramSet:
    def __init__(self, mcfg, num_pages: int, page_size: int,
                 cache_dtype: torch.dtype, params: PyTree, device):
        self.device = torch.device(device)
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.n_layer = int(mcfg.n_layer)
        self.n_kv_head = int(mcfg.n_head)
        self.head_dim = int(mcfg.head_dim)
        self.k_pool, self.v_pool = init_pools(
            self.n_layer, self.num_pages, self.n_kv_head, self.page_size,
            self.head_dim, dtype=cache_dtype, device=self.device,
        )
        self.allocator = PageAllocator(self.num_pages)
        self.params = tree_map(lambda x: x.to(self.device), params)
