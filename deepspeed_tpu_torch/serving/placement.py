"""Placement + ProgramSet: where each serving program runs, and on what
(counterpart of ``deepspeed_tpu/serving/placement.py``).

A :class:`Placement` is a named set of ranks (``tp`` consecutive ranks of
the default process group, or one) plus the sharding-spec table that maps
the gpt2 serving tree onto it. A :class:`ProgramSet` is what lives
together on one placement: this rank's slices of the parameters, its
``KV/tp`` heads of the paged K/V pools (and of the int8 scales), and the
page allocator that hands out page ids in that pool.

**The process model.** The JAX package is single-controller: one host
drives a ``Mesh``. The port is SPMD in torch's idiom:

- *One rank is one device.* The placements take ranks ``[0, n)`` of the
  default process group, in JAX's device order: decode (or shared) is
  ``[0, decode_tp)``, prefill ``[decode_tp, decode_tp + prefill_tp)``;
  ``n`` is ``decode_tp (+ prefill_tp)``; a rank past ``n`` holds no
  placement and mirrors the host side. At tp 1 without disaggregation
  the engine serves alone, as rank 0 of its one placement, whether or not
  a process group is up (each rank of a job may serve its own replica):
  no collective, and the programs are the single-device ones, launch for
  launch.
- *Every rank of the default group runs the same host scheduler*
  (admission, block tables, the prefix index, the drafter, both
  allocators), and every call that moves the engine (``submit``,
  ``step``, ``run``, ``drain``, attaching the heat tracer) is collective:
  each rank makes it, in the same order. The scheduler's clock is rank
  0's, broadcast at each reading a decision makes (deadlines, backoff,
  drain, the tier's victim order, the heat ledger's times), over the
  default group when it is gloo and else a gloo group of the same ranks,
  so no reading syncs the card. What only the telemetry records (the
  request tracer, the journal, the watchdog's straggler scan) and
  ``stats()`` read the rank's own clock moved onto rank 0's, with no
  collective: a tracer on one rank, or a ``stats()`` on one rank, changes
  no rank's collectives. What steers the scheduler beyond the config (the
  heat tracer, whose ledger orders the tier's victims, and the fault
  injector) is checked equal on every rank when the engine is built.
  Within a placement the
  row-parallel all-reduce hands every rank identical hidden states, so
  logits and tokens are identical by construction. Where a rank is outside
  the executing placement (disaggregation, ranks past ``n``), whatever the
  host reads from a program's outputs (the prefill's first token, the
  decode and verify tokens, margins) is broadcast over that host group
  from the placement's first rank.
- *The handoff* replaces JAX's ``device_put`` across placements: each
  prefill rank gathers its packed local-head pages (and their int8
  scales) and sends to every decode rank the heads ``[h0, h1)`` that rank
  owns, which scatters them into its pool; ``decode_tp != prefill_tp``
  re-shards the heads this way (``comm.send_recv``: device tensors over
  NCCL, pinned host buffers over gloo, whose send and receive read host
  memory).
- *Capture.* The programs of a placement whose tp group is on NCCL
  capture its all-reduce inside the CUDA graph. A gloo group cannot be
  captured, so such a placement's programs are built eager on purpose,
  decided from the group's backend when the program is built; nothing
  falls back after a failed capture. Programs of a tp-1 placement (the
  handoff pair, and every program under tp-1 disaggregation, whose
  broadcasts run between programs) capture as before.

The spec table (:data:`GPT2_SERVING_RULES`, JAX's, first match wins)
builds each rank's slices (:meth:`Placement.shard_params`): ``c_attn`` is
column-parallel with rank-major QKV columns
(``module_inject.tp_shard``), attention runs over the local ``H/tp``
heads against the rank's ``KV/tp`` pool heads, and ``attn/c_proj`` and
``mlp/c_proj`` are row-parallel: two all-reduces a layer, each before the
replicated bias.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..module_inject.tp_shard import local_slice, tp_shard_serving_params
from ..utils.weights import tree_map
from .kv_cache import PageAllocator, init_pools

PyTree = Any

TP_AXIS = "tp"

# JAX's committed table for the gpt2 serving tree (first match wins,
# ``re.search``; None entries are replicated dims):
#   c_attn:   column-parallel (rank-major QKV columns, tp_shard permute)
#   attn/c_proj, mlp/c_proj: row-parallel, bias replicated, added after
#             the all-reduce
#   mlp/c_fc: column-parallel, bias sharded with its columns
#   ln_* / wte / wpe: replicated
GPT2_SERVING_RULES: List[Tuple[str, list]] = [
    ("attn/c_attn_w$", [None, None, TP_AXIS]),
    ("attn/c_attn_b$", [None, TP_AXIS]),
    ("attn/c_proj_w$", [None, TP_AXIS, None]),
    ("attn/c_proj_b$", []),
    ("mlp/c_fc_w$", [None, None, TP_AXIS]),
    ("mlp/c_fc_b$", [None, TP_AXIS]),
    ("mlp/c_proj_w$", [None, TP_AXIS, None]),
    ("mlp/c_proj_b$", []),
    ("ln_[12f]/(scale|bias)$", []),
    ("^w[tp]e$", []),
]


def _compile_table(rules):
    """JAX ``analysis/sharding_rules.py`` ``_compile_table``."""
    return [(pat, re.compile(pat), list(spec) if spec is not None else [])
            for pat, spec in rules]


def _first_match(compiled, path: str):
    """JAX ``analysis/sharding_rules.py`` ``_first_match``: the one
    first-match-wins resolution → (spec, matched)."""
    for _pat, rx, spec in compiled:
        if rx.search(path):
            return spec, True
    return (), False


def _with_paths(tree: PyTree, fn, prefix: str = ""):
    """``fn(path, leaf)`` over a nested dict, paths joined by ``/`` (JAX's
    ``_path_of``)."""
    if isinstance(tree, dict):
        return {k: _with_paths(v, fn, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


class Placement:
    """A named rank set: ``tp`` consecutive ranks of the default process
    group and the spec table that places the serving tree on them.
    ``group`` is their process group (None at tp 1: no collective).
    ``device`` is this rank's device and ``rank`` this process's rank
    among the serving ranks (0 for an engine that runs alone, whatever its
    rank in a process group of its own job); a rank outside ``ranks``
    holds no slice of this placement (``member`` False)."""

    def __init__(self, name: str, ranks: Sequence[int], tp: int = 1, group=None,
                 device="cpu", rules: Optional[Sequence[Tuple[str, list]]] = None,
                 rank: int = 0):
        self.name = str(name)
        self.ranks = [int(r) for r in ranks]
        self.tp = int(tp)
        if self.tp < 1:
            raise ValueError(f"placement {name!r}: tp must be >= 1, got {tp}")
        if len(self.ranks) != self.tp:
            raise ValueError(f"placement {name!r}: got {len(self.ranks)} ranks for tp={self.tp}")
        self.rules = list(rules) if rules is not None else list(GPT2_SERVING_RULES)
        self.group = group if self.tp > 1 else None
        self.device = torch.device(device)
        self.member = int(rank) in self.ranks
        self.tp_rank = self.ranks.index(int(rank)) if self.member else None

    def __repr__(self):
        return f"Placement({self.name!r}, tp={self.tp}, ranks={self.ranks})"

    @property
    def root(self) -> int:
        """The placement's first rank (its outputs are broadcast from it)."""
        return self.ranks[0]

    @property
    def captures(self) -> bool:
        """Its programs capture on the card: no group, or one on NCCL (a
        gloo group's collectives cannot be captured)."""
        if self.group is None:
            return True
        # a rank outside the group holds a stand-in for it: read the
        # backend the group was made with, the default group's
        return dist.get_backend(self.group if self.member else None) == "nccl"

    def suffix(self) -> str:
        """Program-name suffix (JAX's): ``_tp{n}`` at tp > 1."""
        return f"_tp{self.tp}" if self.tp > 1 else ""

    # -- model / pool geometry ------------------------------------------

    def local_model_config(self, cfg):
        """The per-rank model config the programs run with: ``n_embd`` and
        ``n_head`` divided by tp (``head_dim`` is kept). Identity at tp 1."""
        if self.tp == 1:
            return cfg
        E, H = int(cfg.n_embd), int(cfg.n_head)
        if E % self.tp or H % self.tp:
            raise ValueError(
                f"placement {self.name!r}: n_embd={E}/n_head={H} not divisible by tp={self.tp}")
        return dataclasses.replace(cfg, n_embd=E // self.tp, n_head=H // self.tp)

    def kv_heads(self, n_kv_head: int, tp_rank: Optional[int] = None) -> Tuple[int, int]:
        """The KV-head range ``[h0, h1)`` a member (this rank by default)
        holds: the counterpart of JAX's ``pool_spec``, which shards the
        KV-head axis (dim 2 of ``[L, P, KV, ...]``) over tp. ``(0, 0)`` on
        a rank outside the placement."""
        r = self.tp_rank if tp_rank is None else tp_rank
        if r is None:
            return 0, 0
        n = int(n_kv_head) // self.tp
        return r * n, (r + 1) * n

    # -- params ----------------------------------------------------------

    def spec_for(self, path: str) -> tuple:
        spec, _ = _first_match(_compile_table(self.rules), path)
        return tuple(spec)

    def param_spec_tree(self, params: PyTree) -> PyTree:
        """A tree of specs (tuples, JAX's ``PartitionSpec`` entries)
        matching ``params``, resolved first match wins."""
        compiled = _compile_table(self.rules)
        return _with_paths(params, lambda path, _leaf: tuple(_first_match(compiled, path)[0]))

    def shard_params(self, params: PyTree) -> PyTree:
        """This rank's slices of the QKV-permuted tree, on its device. tp
        = 1: the tree moved to the device (no permute)."""
        if self.tp == 1:
            return tree_map(lambda x: x.to(self.device), params)
        permuted = tp_shard_serving_params(params, self.tp)
        specs = self.param_spec_tree(permuted)

        def take(x, spec):
            return local_slice(x, spec, self.tp_rank, self.tp).contiguous().to(self.device)

        def walk(tree, sp):
            if isinstance(tree, dict):
                return {k: walk(v, sp[k]) for k, v in tree.items()}
            return take(tree, sp)

        return walk(permuted, specs)


class ProgramSet:
    """One placement's working set: this rank's parameter slices, its
    ``KV/tp`` heads of the paged pools ``[L, P, KV/tp, page, D]`` (and of
    an int8 pool's scales ``[L, P, KV/tp, 2]``, else None), and the page
    allocator for that pool, whose page ids are global: every rank runs
    it. A rank outside the placement keeps the allocator and pools of zero
    heads (nothing to compute on; the host tier's bookkeeping runs on them
    unchanged) and no parameters."""

    def __init__(self, placement: Placement, mcfg, num_pages: int, page_size: int,
                 cache_dtype: torch.dtype, params: PyTree):
        self.placement = placement
        self.device = placement.device
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.n_layer = int(mcfg.n_layer)
        self.n_kv_head = int(mcfg.n_head)
        self.head_dim = int(mcfg.head_dim)
        h0, h1 = placement.kv_heads(self.n_kv_head)
        self.k_pool, self.v_pool, self.scales = init_pools(
            self.n_layer, self.num_pages, h1 - h0, self.page_size, self.head_dim,
            dtype=cache_dtype, device=self.device,
        )
        self.allocator = PageAllocator(self.num_pages)
        self.params = placement.shard_params(params) if placement.member else None

    @property
    def quantized(self) -> bool:
        return self.scales is not None

    def pools(self) -> list:
        """k, v (and the scales): what the handoff and the migration move."""
        return [self.k_pool, self.v_pool] + ([self.scales] if self.scales is not None else [])

    # -- geometry (per rank at tp > 1; JAX's per-device numbers) ---------

    def local_kv_heads(self) -> int:
        return self.n_kv_head // self.placement.tp

    def packed_dims(self, n_pages: int) -> str:
        """Per-rank shape of the gather/scatter handoff payload over
        ``n_pages`` pages."""
        return (f"{self.n_layer},{int(n_pages)},{self.local_kv_heads()},"
                f"{self.page_size},{self.head_dim}")

    def local_pool_bytes(self) -> int:
        """Per-rank K+V pool bytes of a member of the placement."""
        return (2 * self.n_layer * self.num_pages * self.local_kv_heads()
                * self.page_size * self.head_dim * self.k_pool.element_size())

    def local_scales_bytes(self) -> int:
        if self.scales is None:
            return 0
        return self.n_layer * self.num_pages * self.local_kv_heads() * 2 * 4
