"""Decode attention against a contiguous KV cache: the CUDA kernel's wrapper
and its plain version.

The kernel (``csrc/decode_attention.cu``) replaces the Pallas kernel
``deepspeed_tpu/ops/pallas/decode_attention.py`` ``decode_attention`` (body
``_decode_kernel``): one query token per (batch, head) attends rows
``0..pos`` of its ``[Smax, KV, D]`` cache (one ``pos`` for the batch),
online softmax in f32; rows past ``pos`` are never read. ``pos`` is an
int32 ``[1]`` tensor on the card, read by the kernel, as the Pallas kernel
takes it by scalar prefetch: a launch depends on shapes alone, so a
captured CUDA graph replays one decode step at every position. Offline
``generate`` runs it once per layer and decode step. :func:`kernel_plan`
gives a cache that one 16-warp pass covers (generate's) one block a head;
a longer one is cut into chunks across blocks (split-K, :func:`plan_splits`
over all ``Smax`` rows; a chunk past ``pos`` is empty at run time) and the
last block of each head group to finish merges the live chunks' partial
softmax states by their log-sum-exp in chunk order (:func:`merge_partials`
is the merge's plain form). One device launch a call.

:func:`decode_attention_ref` is the plain PyTorch version (the grouped
einsum with the mask ``s <= pos`` and f32 probabilities, as the JAX
package's jnp fallback of ``cached_attention`` computes it); it and
:func:`decode_attention_split_ref` take ``pos`` as a Python int or a
tensor, and never read a tensor ``pos`` on the host. The dispatcher
``ops.attention.cached_attention`` uses it for CPU tensors; for CUDA tensors
it calls :func:`decode_attention`, which launches the kernel or raises.
:func:`decode_attention_split_ref` is the split computation in plain
PyTorch (per-chunk partials, then the merge); nothing on the card's path
calls it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..utils.graphs import hold
from .launches import LAUNCHES, register

# the C entries' dtype codes (the paged kernels add int8 pools) and the
# head dims the decode kernels are built for
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
HEAD_DIMS = (64, 128, 256)

# its launches in the registry (the main path's proof that it ran here);
# one a call
KERNELS = register("decode_attention")

# split-K planning: rows a lane keeps in flight (the kernel's U), the most
# chunks, and the 4-warp blocks a SM that the chunks aim at
ROWS_IN_FLIGHT = 4
SPLIT_MAX = 64
BLOCKS_PER_SM = 4
# query heads one block serves: the largest of these dividing H / KV
HEADS_PER_BLOCK = (8, 4, 2, 1)


def heads_per_block(rep: int) -> int:
    """Query heads of one KV group that one kernel block serves."""
    return next(g for g in HEADS_PER_BLOCK if rep % g == 0)


def rows_per_pass(D: int, itemsize: int, warps: int) -> int:
    """Cache rows one block reads in one pass: 16-byte loads, a row over
    min(D / (16 / itemsize), 32) lanes, ROWS_IN_FLIGHT rows a lane."""
    lanes = min(D // (16 // itemsize), 32)
    return warps * (32 // lanes) * ROWS_IN_FLIGHT


def plan_splits(B: int, KV: int, n_rows: int, sm_count: int, head_blocks: int = 1,
                rows_pass: int = 64):
    """``(splits, chunk)``: rows ``0..n_rows-1`` cut into ``splits`` chunks
    of ``chunk`` rows, a whole number of ``rows_pass`` passes each (the
    last chunk may be shorter, none is empty): enough chunks that ``B x KV
    x head_blocks`` blocks a chunk give about ``BLOCKS_PER_SM`` blocks a
    SM, at most one chunk a pass (so one for a cache one pass covers) and
    ``SPLIT_MAX`` chunks."""
    if n_rows <= 0:
        raise ValueError(f"plan_splits: {n_rows} rows")
    blocks = max(1, B * KV * head_blocks)
    fill = -(-BLOCKS_PER_SM * sm_count // blocks)
    splits = max(1, min(-(-n_rows // rows_pass), fill, SPLIT_MAX))
    chunk = -(-n_rows // splits)
    chunk = -(-chunk // rows_pass) * rows_pass  # whole passes
    return -(-n_rows // chunk), chunk


@functools.lru_cache(maxsize=1024)
def kernel_plan(B: int, H: int, KV: int, D: int, itemsize: int, n_rows: int, sm_count: int):
    """The kernel's launch for one call → ``(G, W, splits, chunk)``: heads
    and warps a block and the rows' chunks. 1 or 2 heads a block over a
    cache that one 16-warp pass covers: 16 warps, one chunk (no merge);
    otherwise 4-warp blocks over :func:`plan_splits`' chunks."""
    G = heads_per_block(H // KV)
    one_pass = rows_per_pass(D, itemsize, 16)
    if G <= 2 and n_rows <= one_pass:
        return G, 16, 1, one_pass
    splits, chunk = plan_splits(B, KV, n_rows, sm_count, H // KV // G,
                                rows_per_pass(D, itemsize, 4))
    return G, 4, splits, chunk


_SM_COUNT = {}
# the merge's arrival counters, zero between calls, per (device, stream)
_COUNTERS = {}
# the chunks' f32 partials, per (device, stream): a call's blocks write and
# merge them inside its one launch, so calls in stream order share them
_PARTIALS = {}


def _counters(device, stream, n: int):
    key = (device, stream)
    c = _COUNTERS.get(key)
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[key] = c
    return hold(c)


def split_scratch(device, stream, B: int, H: int, splits: int, D: int, G: int):
    """Pointers of a split launch's scratch: the partials' (m, l) [B, H,
    splits, 2] and acc [B, H, splits, D] f32, and the counters [B * H /
    G]; reused across calls on one stream, grown when a call needs more
    (a graph being captured holds what it points at: ``utils.graphs.hold``)."""
    n = B * H * splits * (2 + D)
    buf = _PARTIALS.get((device, stream))
    if buf is None or buf.numel() < n:
        buf = torch.empty(max(n, 1 << 16), dtype=torch.float32, device=device)
        _PARTIALS[(device, stream)] = buf
    ml = hold(buf).data_ptr()
    return ml, ml + B * H * splits * 2 * 4, _counters(device, stream, B * H // G).data_ptr()


def _sm_count(device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SM_COUNT[idx]


def _check_shapes(q, k_cache, v_cache):
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(
            f"expected q [B,H,D] and caches [B,Smax,KV,D]; got {tuple(q.shape)}, "
            f"{tuple(k_cache.shape)}"
        )
    B, H, D = q.shape
    Bk, S, KV, Dk = k_cache.shape
    if v_cache.shape != k_cache.shape or Bk != B or Dk != D:
        raise ValueError(
            f"cache shapes {tuple(k_cache.shape)}/{tuple(v_cache.shape)} do not "
            f"match q {tuple(q.shape)}"
        )
    if H % KV != 0:
        raise ValueError(f"q heads {H} must divide by KV heads {KV}")


def _live_rows(pos, S: int, device):
    """``[S]`` bool: rows ``0..pos`` (``pos`` a Python int or a one-element
    tensor, compared on the device; never read on the host)."""
    if isinstance(pos, torch.Tensor):
        pos = pos.reshape(-1)[:1].to(device)
    return torch.arange(S, device=device) <= pos


def decode_attention_ref(q, k_cache, v_cache, pos, sm_scale: Optional[float] = None):
    """Plain PyTorch decode attention → ``[B, H, D]`` in ``q.dtype``;
    scores, softmax and the probability-weighted sum in f32, keys past
    ``pos`` (an int or a one-element tensor) masked (their contents never
    reach the output)."""
    _check_shapes(q, k_cache, v_cache)
    B, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    mask = _live_rows(pos, S, q.device)  # [S]
    qg = q.reshape(B, KV, H // KV, D)
    scores = torch.einsum("bgrd,bsgd->bgrs", qg.float(), k_cache.float()) * scale
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum("bgrs,bsgd->bgrd", probs, v_cache.float())
    return o.reshape(B, H, D).to(q.dtype)


def merge_partials(m, l, acc):
    """Merge chunks' partial softmax states in chunk order → the
    normalised output in f32: ``m``, ``l`` ``[..., splits]`` (the running
    max and mass of each chunk), ``acc`` ``[..., splits, D]`` (its
    unnormalised weighted sum)."""
    mm = m.amax(dim=-1, keepdim=True)
    w = torch.exp(m - mm)
    ll = (l * w).sum(-1)
    a = (acc * w[..., None]).sum(-2)
    return a / ll.clamp_min(1e-30)[..., None]


def decode_attention_split_ref(q, k_cache, v_cache, pos, splits: int,
                               sm_scale: Optional[float] = None):
    """Plain PyTorch of the kernel's split computation → ``[B, H, D]`` in
    ``q.dtype``: the ``Smax`` rows in ``splits`` chunks of ``ceil(Smax /
    splits)`` rows (fewer chunks when the last ones would be empty), each
    chunk's ``(m, l, acc)`` in f32 over its rows ``<= pos`` (a chunk past
    ``pos`` is empty: m = -1e30, l = 0, acc = 0), merged by
    :func:`merge_partials`. ``pos`` an int or a one-element tensor, never
    read on the host."""
    _check_shapes(q, k_cache, v_cache)
    B, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    chunk = -(-S // max(1, int(splits)))
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    qg = q.reshape(B, KV, H // KV, D).float()
    live = _live_rows(pos, S, q.device)
    ms, ls, accs = [], [], []
    for r0 in range(0, S, chunk):
        r1 = min(r0 + chunk, S)
        kc = k_cache[:, r0:r1].float()
        vc = torch.where(live[r0:r1, None, None], v_cache[:, r0:r1].float(), 0.0)
        s = torch.einsum("bgrd,bsgd->bgrs", qg, kc) * scale
        s = torch.where(live[r0:r1], s, float("-inf"))
        m = s.amax(-1).clamp_min(-1e30)
        p = torch.exp(s - m[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bgrs,bsgd->bgrd", p, vc))
    o = merge_partials(torch.stack(ms, -1), torch.stack(ls, -1), torch.stack(accs, -2))
    return o.reshape(B, H, D).to(q.dtype)


def decode_attention(q, k_cache, v_cache, pos, sm_scale: Optional[float] = None):
    """Launch the CUDA kernel on ``torch.cuda.current_stream()`` → a new
    ``[B, H, D]`` tensor in ``q.dtype``. q contiguous, the caches any
    strides with a unit-stride head dim and 16-byte aligned rows, all on
    one CUDA device, float32, float16 or bfloat16 (the caches one dtype);
    ``pos`` an int32 tensor of one element on the same device (the last
    live row; past ``Smax - 1`` it means every row), read by the kernel and
    never on the host. Raises on anything else."""
    _check_shapes(q, k_cache, v_cache)
    tensors = {"q": q, "k_cache": k_cache, "v_cache": v_cache}
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(
                f"decode_attention: {name} is on {t.device}, expected every "
                "operand on the one CUDA device of q"
            )
    if not q.is_contiguous():
        raise ValueError("decode_attention: q must be contiguous")
    if q.dtype not in DTYPE_CODES or k_cache.dtype not in DTYPE_CODES:
        raise TypeError(
            f"decode_attention: q {q.dtype} / caches {k_cache.dtype} must be "
            "float32, float16 or bfloat16"
        )
    if v_cache.dtype != k_cache.dtype:
        raise TypeError(f"k_cache {k_cache.dtype} and v_cache {v_cache.dtype} differ")
    B, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {D} not in {HEAD_DIMS}")
    if (not isinstance(pos, torch.Tensor) or pos.dtype != torch.int32 or pos.numel() != 1
            or pos.device != q.device):
        raise TypeError("decode_attention: pos must be an int32 tensor of one element on "
                        f"{q.device} (the kernel reads it; no host value per call)")
    item = k_cache.element_size()
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.stride(3) != 1:
            raise ValueError(f"decode_attention: {name} head dim must be unit-stride")
        if t.data_ptr() % 16 or any(st * item % 16 for st in t.stride()[:3]):
            raise ValueError(f"decode_attention: {name} rows are not 16-byte aligned")
    if q.data_ptr() % 16:
        raise ValueError("decode_attention: q is not 16-byte aligned")
    out = torch.empty_like(q)
    if B == 0:
        return out
    from .op_builder import load

    lib = load("decode_attention")
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    G, W, splits, chunk = kernel_plan(B, H, KV, D, item, S, _sm_count(q.device))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scratch = split_scratch(q.device, stream, B, H, splits, D, G) if splits > 1 else (None,) * 3
    err = lib.decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(), *scratch,
        pos.data_ptr(), B, S, H, KV, D, splits, chunk, G, W,
        *k_cache.stride()[:3], *v_cache.stride()[:3],
        ctypes.c_float(scale), DTYPE_CODES[q.dtype], DTYPE_CODES[k_cache.dtype], stream,
    )
    if err != 0:
        raise RuntimeError(f"decode_attention: kernel launch failed, CUDA error {err}")
    LAUNCHES["decode_attention"] += 1
    return out
