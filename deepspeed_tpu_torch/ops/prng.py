"""JAX's threefry random streams in PyTorch (the subset of ``jax.random``
that the JAX package uses), bit for bit.

The port must draw what the JAX package draws: sampled serving and
``generate`` (``ops/sampling.py``), GPT-2's dropout masks
(``models/gpt2.py``) and the weight quantizer's stochastic rounding
(``ops/quantizer.py``) all take their bits from keys derived by the same
schedule. This module holds the hash and the functions built on it, as
jax 0.9.0 computes them with its defaults (``jax_default_prng_impl =
threefry2x32``, ``jax_threefry_partitionable = True``):

- :func:`threefry2x32`: 20 rounds of add / rotate / xor and 5 key
  injections over counter pairs (jax ``_src/prng.py``
  ``_threefry2x32_lowering``);
- :func:`PRNGKey`: ``[0, seed]`` for a seed in int32 range (jax
  ``threefry_seed``);
- :func:`split`: the fold-like split, key i = the hash of the counter pair
  (hi32(i), lo32(i)) of the flat index (``_threefry_split_foldlike``);
- :func:`fold_in`: the hash of the pair ``(0, data)`` (``_threefry_fold_in``);
- :func:`random_bits`: 32-bit bits, element i = x0 ^ x1 of the hash of
  (hi32(i), lo32(i)) (``_threefry_random_bits_partitionable``);
- :func:`uniform` (jax ``_src/random.py`` ``_uniform``): the top 23 bits as
  the mantissa of a float in [1, 2), minus 1, then ``* (max - min) + min``
  and ``max(min, .)`` in f32; :func:`bernoulli` (low mode: ``uniform < p``),
  :func:`gumbel` (low mode: ``-log(-log(uniform(tiny, 1)))``) and
  :func:`categorical` (argmax of logits + gumbel).

Keys are ``[..., 2]`` uint32 values: numpy ``uint32`` arrays on the host,
where the key schedules run (a key derivation is a handful of elements and
costs no device work), or int64 tensors on any device. A key function
returns the kind it was given. Key functions take a batch of keys
``[..., 2]`` where JAX takes one (``split`` of ``[L, 2]`` keys is JAX's
``vmap`` of ``split``). The draws (:func:`uniform_rows` and what is built
on it) also take *device keys*: an int32 tensor ``[R, 2]`` (``[2]`` for one
key) holding the keys' 32-bit patterns, which a captured program keeps in
a static buffer; they are used where they lie, with no copy and no host
read (:func:`device_keys` makes them from host keys).

The plain version of the bits is torch int64 arithmetic masked to 32 bits
(PyTorch's uint32 lacks shifts and xor on CUDA); the host's key math is
numpy uint32. This module also binds the hand-written kernel of
``csrc/threefry.cu``: :func:`uniform_rows_kernel` and
:func:`dropout_kernel` (``ops/dropout.py`` builds the differentiable
dropout on it), counted in ``LAUNCHES`` (``ops/launches.py``). On the card,
:func:`uniform_rows` (and so :func:`uniform`, :func:`bernoulli`,
:func:`gumbel`, :func:`categorical`) launches the kernel, which launches or
raises; on the CPU it runs the plain version; any other device raises.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from ..utils.graphs import hold
from .launches import LAUNCHES, register

MASK32 = 0xFFFFFFFF
KS_PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
TINY_F32 = float(np.finfo(np.float32).tiny)

Key = Union[np.ndarray, torch.Tensor]


@functools.lru_cache(maxsize=256)
def _device_scalar(value: float, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.full((), value, dtype=dtype, device=device)


def device_scalar(value: float, device: torch.device,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``value`` as a 0-d ``dtype`` tensor on ``device``, made once and
    reused (read only): an operand on the other operand's device, so the
    card divides exactly as the CPU does (by a CPU scalar it multiplies by
    the reciprocal), and no call pays a host-to-device copy. A graph being
    captured holds the tensor (``utils.graphs.hold``): the cache may drop
    it, the graph still reads it."""
    return hold(_device_scalar(value, device, dtype))


device_scalar.cache_clear = _device_scalar.cache_clear


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 of the counter pairs ``(x0, x1)`` under the key ``(k0,
    k1)`` → ``(y0, y1)``. Operands broadcast together; they are numpy
    uint32 arrays (arithmetic wraps) or int64 tensors holding 32-bit values
    (masked after every add and shift)."""
    if isinstance(x0, torch.Tensor) or isinstance(k0, torch.Tensor):
        def add(a, b):
            return (a + b) & MASK32

        def rotl(v, r):
            return ((v << r) & MASK32) | (v >> (32 - r))
    else:
        def add(a, b):
            return a + b

        def rotl(v, r):
            return (v << np.uint32(r)) | (v >> np.uint32(32 - r))

    ks = (k0, k1, k0 ^ k1 ^ (KS_PARITY if isinstance(k0, torch.Tensor) else np.uint32(KS_PARITY)))
    one = 1 if isinstance(k0, torch.Tensor) else np.uint32(1)
    with np.errstate(over="ignore"):
        x0 = add(x0, ks[0])
        x1 = add(x1, ks[1])
        for i in range(5):
            for r in ROTATIONS[i % 2]:
                x0 = add(x0, x1)
                x1 = rotl(x1, r) ^ x0
            x0 = add(x0, ks[(i + 1) % 3])
            x1 = add(add(x1, ks[(i + 2) % 3]), one * (i + 1))
    return x0, x1


# ---------------------------------------------------------------------------
# keys (host numpy, or int64 tensors)
# ---------------------------------------------------------------------------

def _as_np(key) -> Tuple[np.ndarray, object]:
    """``key`` as numpy uint32 ``[..., 2]`` and how to return a result of
    the same kind (a tensor: int64 on its device)."""
    if isinstance(key, torch.Tensor):
        dev = key.device
        arr = key.detach().cpu().numpy().astype(np.uint32)
        return arr, lambda a: torch.from_numpy(a.astype(np.int64)).to(dev)
    arr = np.asarray(key)
    if arr.dtype != np.uint32:
        arr = arr.astype(np.uint32)
    return arr, lambda a: a


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s data: ``[0, seed mod 2**32]`` for a
    seed in int32 range, as a uint32 ``[2]`` host array."""
    seed = int(seed)
    if not -(2 ** 31) <= seed < 2 ** 31:
        raise OverflowError(f"PRNGKey seed {seed} is out of int32 range (jax without x64)")
    return np.array([0, seed & MASK32], np.uint32)


def _hash_counts(key: np.ndarray, hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Threefry of the counters ``(hi, lo) [*shape]`` under every key of
    ``key [..., 2]`` → ``[..., *shape, 2]``."""
    lead = key.shape[:-1]
    extra = (1,) * hi.ndim
    k0 = key[..., 0].reshape(lead + extra)
    k1 = key[..., 1].reshape(lead + extra)
    y0, y1 = threefry2x32(k0, k1, hi, lo)
    y0, y1 = np.broadcast_arrays(y0, y1)
    return np.stack([y0, y1], axis=-1).astype(np.uint32)


def _iota_2x32(shape) -> Tuple[np.ndarray, np.ndarray]:
    """The flat index of ``shape`` as (hi32, lo32) uint32 arrays (jax
    ``iota_2x32_shape``)."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64).reshape(shape)
    return (idx >> np.uint64(32)).astype(np.uint32), (idx & np.uint64(MASK32)).astype(np.uint32)


def split(key: Key, num: Union[int, Sequence[int]] = 2) -> Key:
    """``jax.random.split(key, num)``: ``[..., 2]`` keys → ``[..., *num,
    2]``."""
    arr, back = _as_np(key)
    shape = tuple(num) if isinstance(num, (tuple, list)) else (int(num),)
    hi, lo = _iota_2x32(shape)
    return back(_hash_counts(arr, hi, lo))


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``: the hash of ``(0, data)`` under
    each key of ``[..., 2]``; ``data`` a uint32 value."""
    arr, back = _as_np(key)
    data = int(data)
    if not 0 <= data <= MASK32:
        raise OverflowError(f"fold_in data {data} is not a uint32 value")
    hi = np.zeros((), np.uint32)
    lo = np.asarray(data, np.uint32)
    y0, y1 = threefry2x32(arr[..., 0], arr[..., 1], hi, lo)
    return back(np.stack(np.broadcast_arrays(y0, y1), axis=-1).astype(np.uint32))


def is_device_key(key) -> bool:
    """An int32 tensor of keys' bit patterns (the draws' no-copy form)."""
    return isinstance(key, torch.Tensor) and key.dtype == torch.int32


def device_keys(keys: Key, device=None) -> torch.Tensor:
    """Host keys ``[..., 2]`` as device keys: an int32 tensor of the same
    bits on ``device`` (one copy; a captured program instead refills a
    static buffer)."""
    arr, _ = _as_np(keys)
    return torch.from_numpy(np.ascontiguousarray(arr).view(np.int32)).to(
        torch.device("cpu" if device is None else device))


def key_words(key: Key) -> Tuple[int, int]:
    """One key as two Python ints (the kernel's by-value arguments)."""
    arr, _ = _as_np(key)
    if arr.shape != (2,):
        raise ValueError(f"expected one key of shape [2], got {arr.shape}")
    return int(arr[0]), int(arr[1])


# ---------------------------------------------------------------------------
# bits and distributions: plain versions (torch int64, any device)
# ---------------------------------------------------------------------------

def random_bits_rows(keys: Key, n: int, device=None, offset=None) -> torch.Tensor:
    """Row r: ``random_bits(keys[r], (n,))`` → int64 ``[R, n]`` of 32-bit
    values (the plain version; torch ops on ``device``). Device keys are
    widened on their device, never read on the host. ``offset``: an int64
    element offset into the draw (an int, or a 0-d tensor on ``device``):
    the row holds elements ``[offset, offset + n)``."""
    dev = torch.device("cpu" if device is None else device)
    if is_device_key(keys):
        k = keys.reshape(-1, 2).to(dev).long() & MASK32
    else:
        arr, _ = _as_np(keys)
        k = torch.from_numpy(arr.reshape(-1, 2).astype(np.int64)).to(dev)
    idx = torch.arange(int(n), dtype=torch.int64, device=dev)[None, :]
    if offset is not None:
        idx = idx + offset
    y0, y1 = threefry2x32(k[:, :1], k[:, 1:], idx >> 32, idx & MASK32)
    return y0 ^ y1


def random_bits(key: Key, shape, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 values (plain)."""
    shape = tuple(shape)
    return random_bits_rows(key, math.prod(shape), device).reshape(shape)


def bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """32-bit values → f32 in [0, 1): the top 23 bits as the mantissa of a
    float in [1, 2), minus 1 (exact)."""
    fb = (bits >> 9) | 0x3F800000
    return fb.to(torch.int32).view(torch.float32) - 1.0


def _range_f32(minval: float, maxval: float) -> Tuple[float, float]:
    """``minval`` and ``maxval - minval`` as f32 values (jax converts both
    bounds to the dtype, then subtracts in it)."""
    lo = np.float32(minval)
    return float(lo), float(np.float32(np.float32(maxval) - lo))


def scale_unit(f: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    """``max(min, f * (max - min) + min)`` in f32 with the product and the
    sum rounded once, as a fused multiply-add: XLA's CPU build contracts
    jax's ``floats * (maxval - minval) + minval`` into one, and the kernel
    does the same (``__fmaf_rn``). Here the product is exact in f64 (24 x
    24 bits) and the sum rounds to f64, then to f32. Over [0, 1) and
    [tiny, 1) the span is 1, so every form agrees exactly."""
    lo, span = _range_f32(minval, maxval)
    v = (f.double() * span + lo).float()
    return torch.maximum(device_scalar(lo, f.device), v)


def uniform_rows_ref(keys: Key, n: int, minval: float = 0.0, maxval: float = 1.0,
                     device=None, offset=None) -> torch.Tensor:
    """Plain version of the kernel's ``uniform_rows``: row r is
    ``uniform(keys[r], (n,), f32, minval, maxval)`` (from element
    ``offset`` of the draw) → f32 ``[R, n]``."""
    return scale_unit(bits_to_unit_float(random_bits_rows(keys, n, device, offset)), minval,
                      maxval)


def shard_key(key, shard: int) -> np.ndarray:
    """A dropout key with a shard index: uint32 ``[4]``, the key's two
    words then ``shard`` as a 64-bit word pair (low, high). A dropout of an
    ``n``-element x under it draws elements ``[shard n, (shard + 1) n)`` of
    the key's draw: rank ``shard``'s slice of a batch split over data
    parallelism (``jax_threefry_partitionable``'s counters)."""
    k0, k1 = key_words(key)
    s = int(shard)
    return np.asarray([k0, k1, s & 0xFFFFFFFF, s >> 32], np.uint32)


def host_dropout_key(key) -> np.ndarray:
    """A host dropout key (numpy or an int64 tensor) as uint32 ``[2]`` or,
    with a shard index, ``[4]``."""
    arr = _as_np(key)[0].reshape(-1)
    if arr.size not in (2, 4):
        raise ValueError(f"a dropout key has 2 words (or 4 with a shard index), got {arr.size}")
    return arr


def shard_offset(key: torch.Tensor, n: int) -> torch.Tensor:
    """A ``[4]`` device key's element offset ``shard * n``, an int64 0-d
    tensor on its device (torch ops: nothing is read on the host)."""
    w = key.reshape(4).long() & MASK32
    return (w[2] | (w[3] << 32)) * int(n)


# ---------------------------------------------------------------------------
# the kernel (csrc/threefry.cu): its two wrappers
# ---------------------------------------------------------------------------

# its launches in the registry (the main path's proof that it ran here)
KERNELS = register("threefry_dropout", "threefry_uniform_rows")

DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def check_rate(rate: float) -> float:
    rate = float(rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} must be in [0, 1)")
    return rate


@functools.lru_cache(maxsize=None)
def keep_scale(rate: float, dtype: torch.dtype):
    """``(p, c)`` of a dropout at ``rate``: the keep probability ``f32(1 -
    rate)`` the uniform is compared against, and ``1 - rate`` in ``dtype``,
    the divisor (jax turns the Python float into x's dtype first)."""
    p = float(np.float32(1.0 - rate))
    c = float(torch.tensor(1.0 - rate, dtype=torch.float64).to(dtype))
    return p, c


def keep_threshold(p: float) -> int:
    """The kernel's integer keep test: ``bits <= keep_threshold(p)`` is
    ``uniform(bits) < p`` for every 32-bit ``bits`` and f32 ``p`` in (0, 1].
    The uniform is ``m / 2^23`` with ``m = bits >> 9``, so ``u < p`` is ``m
    < ceil(p 2^23)`` (p 2^23 exact in f64), and that is ``bits <= ceil(p
    2^23) 2^9 - 1``, at most ``2^32 - 1``."""
    t = math.ceil(float(np.float32(p)) * 2.0 ** 23)
    if not 1 <= t <= 2 ** 23:
        raise ValueError(f"keep_threshold: p {p} is not in (0, 1]")
    return t * 512 - 1


@functools.lru_cache(maxsize=None)
def reciprocal_is_exact(rate: float, dtype: torch.dtype) -> Tuple[float, bool]:
    """``(r, exact)``: r = f32(1 / c) for the dropout's divisor c
    (:func:`keep_scale`), and whether ``dtype(f32(x) * r)`` equals the
    correctly rounded quotient ``dtype(f32(x) / c)`` for every one of the
    65,536 values x of a 16-bit ``dtype`` (NaNs aside), checked here
    exhaustively in numpy's IEEE f32 arithmetic: then the kernel multiplies,
    else (and for f32) it divides."""
    _, c = keep_scale(check_rate(rate), dtype)
    c32 = np.float32(c)
    r = np.float32(1.0) / c32
    if dtype not in (torch.float16, torch.bfloat16):
        return float(r), False
    x = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16).view(dtype)
    xf = x.float().numpy()
    with np.errstate(over="ignore", invalid="ignore"):
        by_mul = torch.from_numpy(xf * r).to(dtype).view(torch.int16)
        by_div = torch.from_numpy(xf / c32).to(dtype).view(torch.int16)
    num = ~torch.from_numpy(np.isnan(xf))
    return float(r), bool(torch.equal(by_mul[num], by_div[num]))


def dropout_kernel(x: torch.Tensor, key: Key, rate: float) -> torch.Tensor:
    """Launch the dropout kernel on ``torch.cuda.current_stream()``: ``keep
    ? x / c : 0`` with ``keep = uniform(key, x.shape) < p`` (``keep_scale``;
    in the kernel ``bits <= keep_threshold(p)``, and the quotient ``x * (1 /
    c)`` where :func:`reciprocal_is_exact` proves it equal) for x contiguous
    f32 / fp16 / bf16 on a CUDA device → a new tensor. The kernel reads the
    key's words where they lie: a device key (int32 ``[2]``, or ``[4]`` with
    a shard index, :func:`shard_key`; contiguous on x's device; a captured
    step's key table slot) is used as it is, a host key is copied up first.
    With a shard index s, x is elements ``[s n, (s + 1) n)`` of the draw.
    Raises on anything else."""
    if x.device.type != "cuda":
        raise ValueError(f"dropout_kernel: the kernel takes CUDA tensors, not {x.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"dropout_kernel: dtype {x.dtype} (float32, float16, bfloat16)")
    if not x.is_contiguous():
        raise ValueError("dropout_kernel: x must be contiguous")
    p, c = keep_scale(check_rate(rate), x.dtype)
    r, mul = reciprocal_is_exact(rate, x.dtype)
    if is_device_key(key):
        if key.numel() not in (2, 4) or key.device != x.device or not key.is_contiguous():
            raise ValueError(f"dropout_kernel: a device key must be one contiguous [2] (or "
                             f"[4], with a shard index) int32 key on {x.device}, got "
                             f"{tuple(key.shape)} on {key.device}")
    else:
        key = device_keys(host_dropout_key(key), x.device)
    from .op_builder import load

    lib = load("threefry")
    y = torch.empty_like(x)
    err = lib.threefry_dropout_launch(x.data_ptr(), y.data_ptr(), x.numel(), key.data_ptr(),
                                      keep_threshold(p), c, r, int(mul), DTYPES[x.dtype],
                                      key.numel(), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dropout_kernel: kernel launch failed, CUDA error {err}")
    LAUNCHES["threefry_dropout"] += 1
    return y


def uniform_rows_kernel(keys: Key, n: int, minval: float = 0.0, maxval: float = 1.0,
                        device=None) -> torch.Tensor:
    """Launch the uniform kernel: ``keys [R, 2]`` (at most 65535 rows) →
    f32 ``[R, n]`` on the CUDA ``device``, one launch. Device keys on
    ``device`` are read by the kernel where they lie (no copy); host keys
    are copied up first. Raises on any other device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise ValueError(f"uniform_rows_kernel: the kernel takes a CUDA device, not {dev}")
    if is_device_key(keys):
        k = keys.reshape(-1, 2)
        if k.device != dev or not k.is_contiguous():
            raise ValueError(f"uniform_rows_kernel: device keys must be contiguous on {dev}, "
                             f"got {k.device}")
    else:
        arr, _ = _as_np(keys)
        k = torch.from_numpy(np.ascontiguousarray(arr.reshape(-1, 2)).view(np.int32)).to(
            dev, non_blocking=True)
    R = k.shape[0]
    out = torch.empty((R, int(n)), dtype=torch.float32, device=dev)
    lo, span = _range_f32(minval, maxval)
    from .op_builder import load

    lib = load("threefry")
    err = lib.threefry_uniform_rows_launch(k.data_ptr(), out.data_ptr(), R, int(n), lo, span,
                                           torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"uniform_rows_kernel: kernel launch failed, CUDA error {err}")
    LAUNCHES["threefry_uniform_rows"] += 1
    return out


# ---------------------------------------------------------------------------
# the draws: the kernel on the card, the plain versions on the CPU
# ---------------------------------------------------------------------------

def uniform_rows(keys: Key, n: int, minval: float = 0.0, maxval: float = 1.0,
                 device=None) -> torch.Tensor:
    """Row r is ``jax.random.uniform(keys[r], (n,), f32, minval, maxval)``
    → f32 ``[R, n]`` on ``device``: the kernel on the card (one launch),
    the plain version on the CPU; any other device raises."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda":
        return uniform_rows_kernel(keys, n, minval, maxval, dev)
    if dev.type != "cpu":
        raise ValueError(f"uniform_rows: no implementation for device {dev}")
    return uniform_rows_ref(keys, n, minval, maxval, dev)


def uniform(key: Key, shape, minval: float = 0.0, maxval: float = 1.0,
            device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, f32, minval, maxval)``."""
    shape = tuple(shape)
    row = key.reshape(1, 2) if is_device_key(key) else key_words(key)
    return uniform_rows(row, math.prod(shape), minval, maxval, device).reshape(shape)


def bernoulli(key: Key, p: float, shape, device=None) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` (low mode, p an f32 value):
    ``uniform < p``."""
    u = uniform(key, shape, device=device)
    return u < device_scalar(float(np.float32(p)), u.device)


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """``-log(-log(u))`` (jax ``_gumbel``, low mode, after its uniform)."""
    return -torch.log(-torch.log(u))


def gumbel(key: Key, shape, device=None) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, f32)`` (low mode)."""
    return gumbel_from_uniform(uniform(key, shape, TINY_F32, 1.0, device))


def categorical(key: Key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` for f32 ``logits``:
    the first index of the largest ``gumbel + logits``."""
    return torch.argmax(gumbel(key, logits.shape, logits.device) + logits, dim=-1)


def categorical_rows(keys: Key, logits: torch.Tensor) -> torch.Tensor:
    """Row r: ``categorical(keys[r], logits[r:r+1])[0]`` for ``logits [R,
    V]`` (the serving programs' ``vmap`` over per-slot keys); one
    ``uniform_rows`` for all rows."""
    R, V = logits.shape
    u = uniform_rows(keys, V, TINY_F32, 1.0, logits.device)
    if u.shape[0] != R:
        raise ValueError(f"categorical_rows: {u.shape[0]} keys for {R} rows")
    return torch.argmax(gumbel_from_uniform(u) + logits, dim=-1)
