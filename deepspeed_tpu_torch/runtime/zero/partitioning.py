"""ZeRO stages 0-3 as a sharding policy over the ``dp`` axis.

Counterpart of ``deepspeed_tpu/runtime/zero/partitioning.py``. The policy
is the JAX package's, decision for decision: a spec is a tuple with one
entry per dim (a mesh-axis name or None, trailing Nones dropped), where
JAX's is a ``PartitionSpec``; tensor parallelism maps logical axes first
(``DEFAULT_LOGICAL_RULES``), then ZeRO shards the largest still-free dim
that the axis size divides, leaving tensors under a size threshold whole:

    stage 0: params, grads, optimizer state replicated over dp
    stage 1: optimizer state sharded over dp
    stage 2: + gradients (the accumulation) sharded over dp (reduce-scatter)
    stage 3: + parameters sharded over dp (all-gather at each use)

with ``min_size_to_shard`` (params; 2**14, or at stage 3 the engine's
``stage3_param_persistence_threshold``) and ``grad_min_size_to_shard``
(2**7: gradients and optimizer state).

Where XLA places shards from these specs, the port stores them: rank r of
``n`` holds the r-th contiguous chunk of the sharded dim, as an owned
contiguous tensor (:func:`shard_of`), because a strided view would break
the fused kernels and the collectives. :func:`init_partitioned` (the
``zero.Init`` analog) keeps this rank's shards of a fresh tree;
:func:`gather_full` (``GatheredParameters``) all-gathers them back. The
compressed gathers of the JAX module (``gather_full_compressed``,
``supports_compressed_*``, ``residual_shardings``) wait for
``comm/compressed.py``: ROADMAP queue 1 item 12.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

PyTree = Any
Spec = Tuple[Optional[Any], ...]

DEFAULT_LOGICAL_RULES: Tuple[Tuple[str, Optional[str]], ...] = (
    ("batch", "dp"),
    ("vocab", "tp"),
    ("embed", None),
    ("mlp", "tp"),
    ("heads", "tp"),
    ("kv", None),
    ("qkv", "tp"),
    ("expert", "ep"),
    ("expert_mlp", "tp"),
    ("seq", "sp"),
    ("layers", "pp"),
    ("stack", None),
)


def _axis_size(mesh, axis: str) -> int:
    return int(mesh.shape.get(axis, 1)) if mesh is not None else 1


def logical_to_spec(
    logical_axes: Sequence[Optional[str]],
    rules: Sequence[Tuple[str, Optional[str]]] = DEFAULT_LOGICAL_RULES,
    mesh=None,
) -> Spec:
    """A tuple of logical axis names → a spec via ``rules``. Mesh axes absent
    from ``mesh`` (or of size 1) degrade to replicated."""
    rule_map = dict(rules)
    out = []
    used = set()
    for name in logical_axes:
        mesh_axis = rule_map.get(name) if name is not None else None
        if mesh_axis is not None and mesh is not None:
            if _axis_size(mesh, mesh_axis) <= 1:
                mesh_axis = None
        if mesh_axis in used:  # a mesh axis may shard only one dim
            mesh_axis = None
        if mesh_axis is not None:
            used.add(mesh_axis)
        out.append(mesh_axis)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def add_zero_axis(
    spec: Spec,
    shape: Tuple[int, ...],
    mesh,
    zero_axis: str = "dp",
    min_size_to_shard: int = 2**14,
) -> Spec:
    """Shard the largest still-free dim over ``zero_axis``: dims already
    sharded keep their assignment, the chosen dim must be divisible by the
    axis size after them, and tensors of fewer than ``min_size_to_shard``
    elements stay replicated."""
    n = _axis_size(mesh, zero_axis)
    if n <= 1:
        return tuple(spec)
    if int(np.prod(shape)) < min_size_to_shard:
        return tuple(spec)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    flat_used = {a for e in entries if e is not None for a in (e if isinstance(e, tuple) else (e,))}
    if zero_axis in flat_used:
        return tuple(spec)
    best_dim, best_size = -1, 0
    for d, dim_size in enumerate(shape):
        existing = entries[d]
        existing_axes = existing if isinstance(existing, tuple) else ((existing,) if existing else ())
        denom = int(np.prod([_axis_size(mesh, a) for a in existing_axes])) if existing_axes else 1
        eff = dim_size // denom
        if dim_size % denom == 0 and eff % n == 0 and eff > best_size:
            best_dim, best_size = d, eff
    if best_dim < 0:
        return tuple(spec)  # nothing divisible: replicated
    existing = entries[best_dim]
    if existing is None:
        entries[best_dim] = zero_axis
    elif isinstance(existing, tuple):
        entries[best_dim] = existing + (zero_axis,)
    else:
        entries[best_dim] = (existing, zero_axis)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def zero_dim(spec: Spec, zero_axis: str = "dp") -> Optional[int]:
    """The dim ``spec`` shards over ``zero_axis`` alone, or None."""
    for d, entry in enumerate(spec):
        if entry == zero_axis:
            return d
    return None


class ZeroShardingPolicy:
    """The param / grad / optimizer-state specs of a ZeRO stage."""

    def __init__(
        self,
        mesh,
        stage: int = 0,
        rules: Sequence[Tuple[str, Optional[str]]] = DEFAULT_LOGICAL_RULES,
        min_size_to_shard: int = 2**14,
        grad_min_size_to_shard: int = 2**7,
        zero_axis: str = "dp",
    ):
        assert 0 <= stage <= 3
        self.mesh = mesh
        self.stage = stage
        self.rules = tuple(rules)
        self.min_size_to_shard = min_size_to_shard
        self.grad_min_size_to_shard = grad_min_size_to_shard
        self.zero_axis = zero_axis

    def tp_spec(self, logical_axes: Sequence[Optional[str]]) -> Spec:
        return logical_to_spec(logical_axes, self.rules, self.mesh)

    def param_spec(self, logical_axes, shape) -> Spec:
        spec = self.tp_spec(logical_axes)
        if self.stage >= 3:
            spec = add_zero_axis(spec, shape, self.mesh, self.zero_axis, self.min_size_to_shard)
        return spec

    def grad_spec(self, logical_axes, shape) -> Spec:
        spec = self.tp_spec(logical_axes)
        if self.stage >= 2:
            spec = add_zero_axis(spec, shape, self.mesh, self.zero_axis,
                                 self.grad_min_size_to_shard)
        return spec

    def opt_spec(self, logical_axes, shape) -> Spec:
        spec = self.tp_spec(logical_axes)
        if self.stage >= 1:
            spec = add_zero_axis(spec, shape, self.mesh, self.zero_axis,
                                 self.grad_min_size_to_shard)
        return spec

    def grad_reduce_op(self) -> str:
        """The collective of the gradient reduction at this stage: stage >= 2
        keeps the accumulation sharded (reduce-scatter), below it the grads
        stay replicated (all-reduce)."""
        return "reduce_scatter" if self.stage >= 2 else "all_reduce"

    # -- pytree-level: a tree of tensors (or shapes) → a tree of specs
    def param_shardings(self, params: PyTree, logical_axes: Optional[PyTree] = None) -> PyTree:
        return _tree_specs(params, logical_axes, self.param_spec)

    def grad_shardings(self, params: PyTree, logical_axes: Optional[PyTree] = None) -> PyTree:
        return _tree_specs(params, logical_axes, self.grad_spec)

    def opt_shardings_for_params(self, params: PyTree,
                                 logical_axes: Optional[PyTree] = None) -> PyTree:
        return _tree_specs(params, logical_axes, self.opt_spec)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def _tree_specs(params: PyTree, logical_axes: Optional[PyTree], spec_fn) -> PyTree:
    if isinstance(params, dict):
        return {k: _tree_specs(v, None if logical_axes is None else logical_axes.get(k),
                               spec_fn) for k, v in params.items()}
    shape = _shape(params)
    axes = tuple(logical_axes) if logical_axes is not None else (None,) * len(shape)
    return spec_fn(axes, shape)


# ---------------------------------------------------------------------------
# shards: this rank's chunk, and the gather back
# ---------------------------------------------------------------------------

def shard_of(t: torch.Tensor, spec: Spec, rank: int, world: int,
             zero_axis: str = "dp") -> torch.Tensor:
    """Rank ``rank``'s chunk of ``t`` under ``spec`` (the r-th contiguous
    chunk of the sharded dim) as an owned contiguous tensor; a copy of
    ``t`` when the spec shards nothing over ``zero_axis``."""
    d = zero_dim(spec, zero_axis)
    if d is None or world <= 1:
        return t.clone(memory_format=torch.contiguous_format)
    c = t.shape[d] // world
    return t.narrow(d, rank * c, c).clone(memory_format=torch.contiguous_format)


def init_partitioned(init_fn: Callable[..., PyTree], shardings: PyTree, *args,
                     rank: int = 0, world: int = 1) -> PyTree:
    """Initialize params and keep this rank's shards (the ``zero.Init``
    analog, reference partition_parameters.py:537): ``init_fn(*args)``'s
    tree, each leaf cut by its spec in ``shardings``. The full tree lives
    only while it is cut."""
    return _map2(lambda t, s: shard_of(t, s, rank, world), init_fn(*args), shardings)


def gather_full(tree: PyTree, shardings: PyTree, group=None) -> PyTree:
    """Full tensors from this rank's shards (the ``GatheredParameters``
    analog, reference partition_parameters.py:1512): an all-gather over
    ``group`` along each sharded dim; whole leaves are returned as they are."""
    from ...comm import all_gather

    def full(t, spec):
        d = zero_dim(spec)
        return t if d is None else all_gather(t, group, gather_dim=d)

    return _map2(full, tree, shardings)


def _map2(fn, tree: PyTree, specs: PyTree) -> PyTree:
    if isinstance(tree, dict):
        return {k: _map2(fn, v, specs[k]) for k, v in tree.items()}
    return fn(tree, specs)


# ---------------------------------------------------------------------------
# the training engine's layout: which leaves it stores as shards
# ---------------------------------------------------------------------------

def zero_shard_dim(shape: Sequence[int], n: int, min_size_to_shard: int) -> Optional[int]:
    """The dim :func:`add_zero_axis` shards for a leaf without tensor
    parallelism (the first of the largest dims that ``n`` divides), or None
    below ``min_size_to_shard`` elements or with no such dim. Unlike
    :func:`add_zero_axis` it answers at ``n = 1`` too: a one-rank group
    runs the same shards (each the whole leaf) and collectives as a larger
    one."""
    if int(np.prod(shape)) < min_size_to_shard:
        return None
    best_dim, best_size = None, 0
    for d, size in enumerate(shape):
        if size % n == 0 and size > best_size:
            best_dim, best_size = d, size
    return best_dim


class ZeroLayout:
    """Per leaf of a parameter tree (``tree_leaves`` order), the dim this
    stage stores sharded over ``n`` ranks, or None for a whole leaf:
    ``opt`` (optimizer state and the update: stage >= 1), ``grad`` (the
    gradient accumulation: stage >= 2, the same dims) and ``param`` (the
    fp32 master: stage 3, leaves of at least ``param_min_size``
    elements). A leaf whose master is sharded updates on its shard, so its
    optimizer state is a shard too even below ``grad_min_size`` (the JAX
    policy would keep that state whole on every rank: the numbers are the
    same)."""

    def __init__(self, shapes: Sequence[Sequence[int]], stage: int, n: int,
                 param_min_size: int = 2**14, grad_min_size: int = 2**7):
        self.stage, self.n = int(stage), int(n)
        self.opt, self.grad, self.param = [], [], []
        for shape in shapes:
            dim = zero_shard_dim(shape, self.n, grad_min_size) if stage >= 1 else None
            pdim = zero_shard_dim(shape, self.n, param_min_size) if stage >= 3 else None
            if pdim is not None:
                dim = pdim
            self.opt.append(dim)
            self.grad.append(dim if stage >= 2 else None)
            self.param.append(pdim)

    def plan(self, gas: int, fp16: bool = False, lamb: bool = False) -> dict:
        """The collectives of one training step by kind: the whole
        gradients' all-reduces, the loss's, at stage >= 2 the norm's (and
        fp16's overflow flag's), LAMB's norm sums over shards; the
        accumulation's reduce-scatters (stage 3's at each micro-batch's
        use); the master's all-gathers (stage 3's at each use)."""
        whole = sum(1 for d in self.grad if d is None)
        sharded = len(self.grad) - whole
        ar = whole + 1
        if self.stage >= 2:
            ar += 1 + int(fp16)
        if lamb and any(d is not None for d in self.opt):
            ar += 1
        at_use = sum(1 for d in self.param if d is not None)
        ag = gas * at_use + sum(1 for d, p in zip(self.opt, self.param)
                                if d is not None and p is None)
        return {"all_reduce": ar, "reduce_scatter": gas * sharded, "all_gather": ag}


class GatherAtUse(torch.autograd.Function):
    """A stage-3 leaf at its use: its shard cast to ``dtype`` (the compute
    dtype) and all-gathered along ``dim``; the backward reduce-scatters the
    leaf's gradient in the shard's own dtype (the gradient-accumulation
    dtype, in which stages 0-2 reduce too), summed by autograd over every
    use first (GPT-2's tied embedding is used twice, and reduced once)."""

    @staticmethod
    def forward(ctx, shard, group, dim, dtype):
        from ...comm import all_gather

        ctx.group, ctx.dim, ctx.dtype = group, dim, shard.dtype
        return all_gather(shard.to(dtype), group, gather_dim=dim)

    @staticmethod
    def backward(ctx, g):
        from ...comm import reduce_scatter

        return reduce_scatter(g.to(ctx.dtype), ctx.group, scatter_dim=ctx.dim), None, None, None
