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

A dim other than 0 is moved to the front (one contiguous copy) so that the
collective's flat layout is rank-major, as ``tiled`` JAX collectives lay
out their shards. Each call records its input's bytes in the comms logger
(``comm.py``), as JAX's ``_record`` does at trace time.
"""

from __future__ import annotations

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
    out = x.new_empty((n * x.numel(),))
    dist.all_gather_into_tensor(out, x.contiguous().view(-1), group=group)
    rows = out.view((n,) + tuple(x.shape))
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
    out = x.new_empty((rows[0].numel(),))
    dist.reduce_scatter_tensor(out, rows.view(-1), op=dist.ReduceOp.SUM, group=group)
    return out.view(rows.shape[1:])


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
    out = torch.empty_like(rows)
    dist.all_to_all_single(out, rows, group=group)
    return _from_front(out, concat_dim)


def broadcast(x: torch.Tensor, group=None, root: int = 0) -> torch.Tensor:
    """Every rank gets the group's ``root``-th rank's ``x``, in place."""
    _record("broadcast", group, x)
    src = root if group is None else dist.get_global_rank(group, root)
    dist.broadcast(x, src=src, group=group)
    return x


def ppermute(x: torch.Tensor, group=None,
             perm: Sequence[Tuple[int, int]] = ()) -> torch.Tensor:
    """Point to point (``lax.ppermute``): group rank ``dst`` gets ``src``'s
    ``x`` for each ``(src, dst)`` pair of ``perm``; a rank no pair sends to
    gets zeros → a new tensor."""
    _record("ppermute", group, x)
    return _permute(x, group, perm)


def _permute(x: torch.Tensor, group, perm) -> torch.Tensor:
    me = dist.get_rank(group)
    out = torch.zeros_like(x)
    x = x.contiguous()

    def glob(r):
        return r if group is None else dist.get_global_rank(group, r)

    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x, glob(dst), group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out, glob(src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def ring_shift(x: torch.Tensor, group=None, shift: int = 1,
               axis_size: Optional[int] = None) -> torch.Tensor:
    """Rank i's ``x`` to rank ``(i + shift) % n``. Unrecorded, as JAX's
    ``ring_shift`` goes to ``lax.ppermute`` directly."""
    n = axis_size if axis_size is not None else dist.get_world_size(group)
    return _permute(x, group, [(i, (i + shift) % n) for i in range(n)])


def axis_index(group=None) -> int:
    return dist.get_rank(group)


def axis_size(group=None) -> int:
    return dist.get_world_size(group)


def barrier(group=None) -> None:
    dist.barrier(group=group)
