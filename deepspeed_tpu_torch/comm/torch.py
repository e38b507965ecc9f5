"""The ``torch.distributed`` backend: NCCL on the card, gloo on the CPU.

Counterpart of ``deepspeed_tpu/comm/xla.py``, whose collectives are
``jax.lax`` primitives over a named mesh axis. Here each takes the axis's
process group (``None`` is the default, world group; ``parallel.topology``
``ProcessGroups`` makes one group per axis) in place of the axis name, and
runs as a call on the group: eager on the CPU, and on the card on the
current stream, so a training step captured into a CUDA graph captures its
NCCL collectives too (the communicator must exist before the capture: the
engine runs one eager collective on each group first).

Primitive mapping (``xla.py`` → here):

- ``all_reduce`` (``psum`` / ``pmean`` / ``pmax`` / ``pmin``) →
  ``dist.all_reduce``, in place;
- ``all_gather`` (``lax.all_gather``) → ``all_gather_into_tensor``;
- ``reduce_scatter`` (``psum_scatter``) → ``reduce_scatter_tensor``;
- ``all_to_all`` (``lax.all_to_all``) → ``all_to_all_single``;
- ``broadcast`` → ``dist.broadcast`` from the group's ``root``-th rank;
- ``ppermute`` / ``ring_shift`` (``lax.ppermute``) → ``batch_isend_irecv``;
- ``barrier`` → ``dist.barrier``.

Beyond JAX's primitives, the serving placements need :func:`send_recv`
(a batch of point-to-point moves between global ranks: the disaggregated
KV handoff, where the JAX package calls ``device_put`` across placements) and
:func:`subgroup` (the process group of a rank list, made once a process).

Gloo moves host memory. Its ``all_reduce`` and ``broadcast`` take CUDA
tensors themselves (gloo stages them through pinned buffers, ordered
with the current stream), so :func:`all_reduce` and :func:`broadcast`
hand them over as they are. Its send, receive, all-gather,
reduce-scatter and all-to-all do not: :func:`send_recv`,
:func:`ppermute` / :func:`ring_shift`, :func:`all_gather`,
:func:`reduce_scatter` and :func:`all_to_all` move a CUDA tensor on a
gloo group from a pinned host copy into a pinned host buffer, then back
to the card. That is a property of the transport, not a fallback: a CUDA
tensor on a gloo group always takes it, and nothing else does. Each
staged call adds its seconds to :data:`STAGING` (the host copies, the
transfer and the wait on the peers, timed on the host from the moment
the card's queued work is done: the caller's measure of what loopback
costs beside the kernels).

Training differentiates through some collectives. :func:`all_to_all_grad`
(backward: the all-to-all with split and concat swapped), and Megatron's
pair for tensor parallelism, :func:`copy_to_group` (identity forward,
all-reduce backward: a column-parallel layer's input) and
:func:`reduce_from_group` (all-reduce forward, identity backward: a
row-parallel layer's output), are ``torch.autograd.Function`` forms of
the calls above. Autograd runs a collective's backward only where the
rank's graph used its output, so every rank's graph must use it alike;
the sequence-parallel rings, whose causal masks skip blocks by rank, are
whole Functions with explicit backward rings instead of a differentiable
``ring_shift``.

A dim other than 0 is moved to the front (one contiguous copy) so that the
collective's flat layout is rank-major, as ``tiled`` JAX collectives lay
out their shards. Each call records its input's bytes in the comms logger
(``comm.py``), as JAX's ``_record`` does at trace time.
"""

from __future__ import annotations

import time
import warnings
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .backend import Backend

# torch 2.13 renames all_gather_into_tensor and reduce_scatter_tensor (and
# warns); the card's 2.11 has only the old names, which both accept
warnings.filterwarnings(
    "ignore", message=r".*(all_gather_into_tensor|reduce_scatter_tensor).* is deprecated")

# a process group → the axis name the comms logger files it under
_GROUP_NAMES: Dict[int, str] = {}


def name_group(group, name: str) -> None:
    """File ``group``'s collectives under the axis ``name`` in the logger."""
    _GROUP_NAMES[id(group)] = str(name)


def group_name(group) -> str:
    return _GROUP_NAMES.get(id(group), "world" if group is None else "group")


class TorchBackend(Backend):
    """Process-level init over ``torch.distributed`` (the reference's
    TorchBackend). ``backend`` is ``"nccl"`` (the card) or ``"gloo"`` (the
    CPU, asked for by the caller); nothing falls back from one to the
    other."""

    def __init__(self, backend: str = "nccl"):
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"TorchBackend: backend {backend!r} (nccl | gloo)")
        super().__init__(name=backend)

    def init_process_group(self, init_method: Optional[str] = None, world_size: int = 1,
                           rank: int = 0, timeout=None):
        if self.name == "nccl" and not torch.cuda.is_available():
            raise RuntimeError("the nccl backend needs a CUDA device and none is available; "
                               "pass dist_backend='gloo' to run the ranks on the CPU")
        kw = {} if timeout is None else {"timeout": timeout}
        if init_method is None:
            if world_size != 1:
                raise ValueError(f"world size {world_size} needs an init_method "
                                 "(MASTER_ADDR/MASTER_PORT or a file:// store)")
            # one process: an in-memory store, no rendezvous
            dist.init_process_group(self.name, store=dist.HashStore(), world_size=1, rank=0,
                                    **kw)
        else:
            dist.init_process_group(self.name, init_method=init_method,
                                    world_size=int(world_size), rank=int(rank), **kw)
        self.world_size = dist.get_world_size()
        self.world_rank = dist.get_rank()
        self.initialized = True

    def new_group(self, ranks):
        return dist.new_group(list(ranks))

    def destroy_process_group(self):
        if dist.is_initialized():
            dist.destroy_process_group()
        _GROUP_NAMES.clear()
        _SUBGROUPS.clear()
        self.initialized = False


# ---------------------------------------------------------------------------
# collectives over a process group
# ---------------------------------------------------------------------------

def _record(op_name: str, group, x) -> None:
    """The comms logger's account of one call (lazy import: comm.py
    imports this module)."""
    from .comm import comms_logger, record

    if comms_logger.enabled:
        record(op_name, group_name(group), x, world=dist.get_world_size(group))


_TORCH_OPS = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
              "min": dist.ReduceOp.MIN, "prod": dist.ReduceOp.PRODUCT}


def _through_host(x: torch.Tensor, group) -> bool:
    """A CUDA tensor on a gloo group: a point-to-point move, an all-gather,
    a reduce-scatter or an all-to-all goes through a pinned host copy
    (gloo's send, receive and those collectives read host memory)."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


# the host staging of CUDA tensors on gloo groups: calls and seconds
STAGING = {"calls": 0, "seconds": 0.0}


def reset_staging() -> None:
    STAGING.update(calls=0, seconds=0.0)


def _staged(x: torch.Tensor, group, fn):
    """``fn(x)`` for a collective that reads and writes host memory: a CUDA
    tensor on a gloo group goes down to a pinned host copy and the result
    comes back to x's device (timed into :data:`STAGING`: from the moment
    the device's queued work is done, so it holds the copies, the
    transfer and the wait on the peers inside gloo, not this rank's
    compute); anything else is handed over as it is."""
    if not _through_host(x, group):
        return fn(x)
    torch.cuda.current_stream(x.device).synchronize()
    t0 = time.perf_counter()
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    out = fn(host).to(x.device)
    STAGING["calls"] += 1
    STAGING["seconds"] += time.perf_counter() - t0
    return out


def all_reduce(x: torch.Tensor, group=None, op: str = "sum") -> torch.Tensor:
    """Reduce ``x`` over the group IN PLACE (sum, mean, max, min, prod) and
    return it."""
    if op not in _TORCH_OPS:
        raise ValueError(f"unknown reduce op {op}")
    _record("all_reduce", group, x)
    dist.all_reduce(x, op=_TORCH_OPS[op], group=group)
    if op == "mean":
        x.div_(dist.get_world_size(group))
    return x


def _to_front(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x`` with ``dim`` split into ``[n, size / n]`` and the ``n`` moved
    to the front, contiguous: rank j's chunk is row j."""
    d = dim % x.dim()
    if x.shape[d] % n:
        raise ValueError(f"dim {d} of {tuple(x.shape)} is not divisible by the group size {n}")
    return x.unflatten(d, (n, x.shape[d] // n)).movedim(d, 0).contiguous()


def _from_front(rows: torch.Tensor, dim: int) -> torch.Tensor:
    """Inverse of :func:`_to_front`: ``[n, ...chunk]`` → the chunks
    concatenated along ``dim``."""
    d = dim % (rows.dim() - 1)
    return rows.movedim(0, d).flatten(d, d + 1)


def all_gather(x: torch.Tensor, group=None, *, gather_dim: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``gather_dim`` (``tiled``), or
    stacked in a new dim there → a new tensor."""
    _record("all_gather", group, x)
    n = dist.get_world_size(group)

    def gather(t):
        out = t.new_empty((n * t.numel(),))
        dist.all_gather_into_tensor(out, t.contiguous().view(-1), group=group)
        return out

    rows = _staged(x, group, gather).view((n,) + tuple(x.shape))
    if not tiled:
        return rows.movedim(0, gather_dim % (x.dim() + 1))
    return _from_front(rows, gather_dim)


def reduce_scatter(x: torch.Tensor, group=None, *, scatter_dim: int = 0,
                   tiled: bool = True) -> torch.Tensor:
    """The sum over the group of ``x``, of which this rank keeps the
    ``rank``-th chunk along ``scatter_dim`` → a new, contiguous tensor."""
    if not tiled:
        raise ValueError("reduce_scatter: only the tiled form is implemented")
    _record("reduce_scatter", group, x)
    n = dist.get_world_size(group)
    rows = _to_front(x, scatter_dim, n)

    def scatter(t):
        out = t.new_empty((t[0].numel(),))
        dist.reduce_scatter_tensor(out, t.view(-1), op=dist.ReduceOp.SUM, group=group)
        return out

    return _staged(rows, group, scatter).view(rows.shape[1:])


def all_to_all(x: torch.Tensor, group=None, *, split_dim: int, concat_dim: int,
               tiled: bool = True) -> torch.Tensor:
    """``x`` split in ``n`` chunks along ``split_dim``, chunk j sent to
    rank j, and the chunks received concatenated along ``concat_dim`` in
    rank order (``lax.all_to_all``, tiled) → a new tensor."""
    if not tiled:
        raise ValueError("all_to_all: only the tiled form is implemented")
    _record("all_to_all", group, x)
    n = dist.get_world_size(group)
    rows = _to_front(x, split_dim, n)

    def exchange(t):
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=group)
        return out

    return _from_front(_staged(rows, group, exchange), concat_dim)


def broadcast(x: torch.Tensor, group=None, root: int = 0) -> torch.Tensor:
    """Every rank gets the group's ``root``-th rank's ``x``, in place."""
    _record("broadcast", group, x)
    src = root if group is None else dist.get_global_rank(group, root)
    dist.broadcast(x, src=src, group=group)
    return x


def send_recv(sends: Sequence[Tuple[torch.Tensor, int]] = (),
              recvs: Sequence[Tuple[torch.Tensor, int]] = (), group=None) -> None:
    """Point to point between global ranks, in one batch: each ``(x,
    peer)`` of ``sends`` goes to ``peer``, each ``(y, peer)`` of ``recvs``
    is filled from ``peer`` (in place). Every rank of the move calls it
    with its own lists; the sender's and the receiver's tensors of one
    pair have one shape and dtype. Recorded as ``send_recv`` with the
    bytes this rank sends. Over gloo, CUDA tensors travel through pinned
    host buffers."""
    for x, _peer in sends:
        _record("send_recv", group, x)
    staged = []
    ops = []
    for x, peer in sends:
        x = x.contiguous()
        if _through_host(x, group):
            x = x.to("cpu").pin_memory()
        ops.append(dist.P2POp(dist.isend, x, int(peer), group))
    for y, peer in recvs:
        buf = y
        if _through_host(y, group) or not y.is_contiguous():
            buf = torch.empty(y.shape, dtype=y.dtype,
                              device="cpu" if _through_host(y, group) else y.device,
                              pin_memory=_through_host(y, group))
            staged.append((y, buf))
        ops.append(dist.P2POp(dist.irecv, buf, int(peer), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for y, buf in staged:
        y.copy_(buf)


# (rank list, backend) -> its process group, per default group (made once
# a process)
_SUBGROUPS: Dict[Tuple[Tuple[int, ...], Optional[str]], object] = {}


def subgroup(ranks: Sequence[int], name: Optional[str] = None,
             backend: Optional[str] = None):
    """The process group of global ``ranks`` (on ``backend``, the default
    group's when None), made on first use and kept for the process: every
    later call with the same ranks and backend returns it. Making one is
    collective over the default group (``dist.new_group``), so every rank
    calls this in the same order, member or not. ``name`` files its
    collectives in the comms logger."""
    key = (tuple(int(r) for r in ranks), backend)
    g = _SUBGROUPS.get(key)
    if g is None:
        g = _SUBGROUPS[key] = dist.new_group(list(key[0]), backend=backend)
    if name is not None:
        name_group(g, name)
    return g


def ppermute(x: torch.Tensor, group=None,
             perm: Sequence[Tuple[int, int]] = ()) -> torch.Tensor:
    """Point to point (``lax.ppermute``): group rank ``dst`` gets ``src``'s
    ``x`` for each ``(src, dst)`` pair of ``perm``; a rank no pair sends to
    gets zeros → a new tensor."""
    _record("ppermute", group, x)
    return _permute(x, group, perm)


def _permute(x: torch.Tensor, group, perm) -> torch.Tensor:
    """The moves of ``perm`` (a CUDA tensor on gloo through pinned host
    buffers, :func:`_staged`)."""
    me = dist.get_rank(group)

    def glob(r):
        return r if group is None else dist.get_global_rank(group, r)

    def move(t):
        t = t.contiguous()
        out = torch.zeros_like(t)
        ops = []
        for src, dst in perm:
            if src == me and dst == me:
                out.copy_(t)
            elif src == me:
                ops.append(dist.P2POp(dist.isend, t, glob(dst), group))
            elif dst == me:
                ops.append(dist.P2POp(dist.irecv, out, glob(src), group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out

    return _staged(x, group, move)


def ring_shift(x: torch.Tensor, group=None, shift: int = 1,
               axis_size: Optional[int] = None) -> torch.Tensor:
    """Rank i's ``x`` to rank ``(i + shift) % n``. Unrecorded, as JAX's
    ``ring_shift`` goes to ``lax.ppermute`` directly."""
    n = axis_size if axis_size is not None else dist.get_world_size(group)
    return _permute(x, group, [(i, (i + shift) % n) for i in range(n)])


# ---------------------------------------------------------------------------
# differentiable forms (training through a collective)
# ---------------------------------------------------------------------------

class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        return all_to_all(x, group, split_dim=split_dim, concat_dim=concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return all_to_all(g.contiguous(), ctx.group, split_dim=concat_dim,
                          concat_dim=split_dim), None, None, None


def all_to_all_grad(x: torch.Tensor, group=None, *, split_dim: int,
                    concat_dim: int) -> torch.Tensor:
    """:func:`all_to_all` (tiled) whose backward is the all-to-all with the
    split and concat dims swapped."""
    return _AllToAll.apply(x, group, int(split_dim), int(concat_dim))


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's ``f``: ``x`` itself forward, the gradient all-reduced
    (summed) over ``group`` backward: the replicated input of a
    column-parallel layer, whose ranks each see a part of its gradient."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's ``g``: ``x`` all-reduced (summed) over ``group`` forward,
    the gradient as it is backward: a row-parallel layer's partial
    products, whose sum every rank then holds."""
    return _ReduceFromGroup.apply(x, group)


def axis_index(group=None) -> int:
    return dist.get_rank(group)


def axis_size(group=None) -> int:
    return dist.get_world_size(group)


def barrier(group=None) -> None:
    dist.barrier(group=group)
