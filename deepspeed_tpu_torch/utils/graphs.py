"""Compiled programs on the card: captured CUDA graphs over static buffers.

The JAX package never runs its paths op by op: ``generate`` is one
compiled executable per key (``deepspeed_tpu/inference/engine.py``
``_generate_cache``), the serving engine runs a fixed, config-derived set
of compiled programs (``deepspeed_tpu/serving/scheduler.py``
``ServingEngine.executables``), and the training engine jits one step
program and one eval program (``deepspeed_tpu/runtime/engine.py``
``_train_step``, ``_eval_step``; ``InferenceEngine.forward`` jits
``apply_fn``). Here each such executable is a :class:`CapturedProgram`: a
step function and the static buffers it reads and writes. A training
step is one program too: the forward passes, ``torch.autograd.grad`` over
the micro-batches, the unscale, the overflow flag, the norm, the clipping,
the optimizer's update and the loss-scale transition, all captured in one
graph whose scalars (the scale, the counts, the learning rate, the skip
flag, the dropout keys) live in device memory.

- Inputs: :class:`StaticInputs`, named arrays (int32 unless another dtype
  is given) packed in one device buffer. The host writes a staging copy
  (pinned memory on the card) and each call refills the device buffer by
  one asynchronous copy.
- Outputs: what the step function returns when it is captured, rewritten
  by every replay (read them before the next call, or build the program
  with ``copy_outputs`` to get fresh copies), plus whatever state the
  function updates in place (KV caches, positions, token buffers; a
  training step's parameters, optimizer state and loss scale).

On a CUDA device the first call runs the step function eagerly on the
program's capture stream: the warm-up, a real step, in which the kernels'
libraries, cuBLAS handles, the kernels' split scratch and the cached
device scalars are made outside any graph's pool. The second call captures
the function into a ``torch.cuda.CUDAGraph`` with a private memory pool
and replays it; later calls replay. A capture that fails raises: nothing
falls back to eager. The kernel wrappers count their launches in one
registry (``ops/launches.py``), which a replay skips, so the program
records the registry's increase during the capture, restores it (a capture
launches nothing) and adds the increase on every replay: the counts equal
an eager run's. A graph reads its buffers by address, so tensors that a
cache of the ops hands to the step function (the device scalars of
``ops/prng.py``, the kernels' split scratch, the block-sparse index lists
and schedules) are passed through
:func:`hold` and the program keeps them for its lifetime: a cache that
drops or replaces one frees nothing a graph still reads.
:meth:`CapturedProgram.free` releases the graph, its pool and what it
holds.

On the CPU (asked for explicitly, as the tests do) the same program calls
its step function on the same buffers at every call.

The telemetry plane's compile families count these compiles
(``telemetry/compile_stats.py``): a capture is one ``jit_compiles_total``
and its wall time ``jit_compile_seconds_total``; the warm-up step's wall
time is ``jit_trace_seconds_total``.

``_EAGER`` is private and never a config key: programs built while it is
true run their step functions eagerly on the card too. It exists for the
capture-against-eager comparisons of ``chip_smoke.py`` phase 21 and the
profiling tools' ``--eager``.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..ops.launches import LAUNCHES
from ..telemetry import compile_stats

_EAGER = False

# what the capture in progress reads from the ops' caches (:func:`hold`)
_HELD: Optional[List[torch.Tensor]] = None


def hold(t: torch.Tensor) -> torch.Tensor:
    """``t``, kept alive by the program being captured, if any: a cache of
    the ops passes every tensor it hands to a step function through here."""
    if _HELD is not None:
        _HELD.append(t)
    return t


_CAPTURE_STREAMS: Dict[int, torch.cuda.Stream] = {}


def capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The side stream every program of ``device`` warms up and captures
    on (the kernels' per-stream scratch is made once for it)."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    s = _CAPTURE_STREAMS.get(idx)
    if s is None:
        s = _CAPTURE_STREAMS[idx] = torch.cuda.Stream(device=idx)
    return s


# the dtypes a staging array can take (numpy's views of the pinned buffer)
_NP_DTYPES = {torch.int32: np.int32, torch.int64: np.int64, torch.float32: np.float32,
              torch.float64: np.float64, torch.float16: np.float16, torch.uint8: np.uint8,
              torch.int8: np.int8, torch.int16: np.int16, torch.bool: np.bool_}


class StaticInputs:
    """A program's inputs: named arrays of fixed shapes in one device
    buffer (each 16-byte aligned), with a host staging copy of the same
    layout (pinned on the card). ``shapes`` maps a name to a shape (int32)
    or to ``(shape, dtype)``. Write the arrays of :meth:`staging` (numpy
    views), then :meth:`upload` copies all of them in one asynchronous
    copy; ``dev`` holds the device views the step function reads."""

    def __init__(self, shapes: Dict[str, Any], device):
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        spans, n = {}, 0
        for name, spec in shapes.items():
            shape, dtype = ((spec[0], spec[1]) if len(spec) == 2
                            and isinstance(spec[1], torch.dtype) else (spec, torch.int32))
            if dtype not in _NP_DTYPES:
                raise TypeError(f"StaticInputs: {name} has dtype {dtype} (one of "
                                f"{sorted(map(str, _NP_DTYPES))})")
            shape = tuple(int(d) for d in shape)
            nbytes = math.prod(shape) * dtype.itemsize
            spans[name] = (n, nbytes, shape, dtype)
            n += -(-nbytes // 16) * 16
        self._dev = torch.zeros(max(n, 16), dtype=torch.uint8, device=self.device)
        self._host = torch.zeros(max(n, 16), dtype=torch.uint8, pin_memory=cuda)
        flat = self._host.numpy()
        self._arrays = {name: flat[o:o + nb].view(_NP_DTYPES[dt]).reshape(shape)
                        for name, (o, nb, shape, dt) in spans.items()}
        self.dev = {name: self._dev[o:o + nb].view(dt).view(shape)
                    for name, (o, nb, shape, dt) in spans.items()}
        self._copy = None

    def staging(self):
        """The host arrays (numpy int32 views), once the last upload has
        read them."""
        if self._copy is not None:
            self._copy.synchronize()
            self._copy = None
        return self._arrays

    def upload(self) -> None:
        """One host-to-device copy of every input, asynchronous on the
        card (the next :meth:`staging` waits for it)."""
        self._dev.copy_(self._host, non_blocking=True)
        if self.device.type == "cuda":
            self._copy = torch.cuda.Event()
            self._copy.record(torch.cuda.current_stream(self.device))


def _clone(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, dict):
        return {k: _clone(v) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return type(out)(_clone(v) for v in out)
    return out


class CapturedProgram:
    """One compiled program: ``fn()`` → outputs, over static buffers the
    closure holds (``inputs``' device views among them), captured on the
    card (module docstring), run directly on the CPU. Call it after
    writing the inputs' staging arrays; it uploads them (a program without
    host inputs uploads nothing) and runs one step. ``copy_outputs``: a
    replay returns copies of the graph's outputs (device copies, no sync),
    which the next replay leaves alone, as a JAX call returns new arrays."""

    def __init__(self, name: str, fn: Callable[[], Any], device,
                 inputs: Optional[StaticInputs] = None, copy_outputs: bool = False):
        self.name = name
        self.fn = fn
        self.inputs = inputs
        self.copy_outputs = bool(copy_outputs)
        self.device = torch.device(device)
        self.captures = self.device.type == "cuda" and not _EAGER
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._out: Any = None
        self._delta: Dict[str, int] = {}
        self._held: List[torch.Tensor] = []
        self._warm = False
        self.capture_ms: Optional[float] = None
        self.calls = 0
        self.replays = 0

    def __call__(self):
        if self.inputs is not None:
            self.inputs.upload()
        self.calls += 1
        if not self.captures:
            return self.fn()
        if not self._warm:
            self._warm = True
            return self._warm_up()
        if self.graph is None:
            self._capture()
        self.graph.replay()
        for name, n in self._delta.items():
            LAUNCHES[name] += n
        self.replays += 1
        return _clone(self._out) if self.copy_outputs else self._out

    def _warm_up(self):
        """One eager step on the capture stream."""
        cur = torch.cuda.current_stream(self.device)
        s = capture_stream(self.device)
        t0 = time.perf_counter()
        s.wait_stream(cur)
        with torch.cuda.stream(s):
            out = self.fn()
        cur.wait_stream(s)
        compile_stats.note_warmup(time.perf_counter() - t0)
        return out

    def _capture(self) -> None:
        global _HELD
        cur = torch.cuda.current_stream(self.device)
        s = capture_stream(self.device)
        graph = torch.cuda.CUDAGraph()
        before = dict(LAUNCHES)
        t0 = time.perf_counter()
        s.wait_stream(cur)
        _HELD = []
        try:
            with torch.cuda.graph(graph, pool=torch.cuda.graph_pool_handle(), stream=s):
                out = self.fn()
        finally:
            after = dict(LAUNCHES)
            for name in after:
                LAUNCHES[name] = before.get(name, 0)
            held, _HELD = _HELD, None
        cur.wait_stream(s)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        compile_stats.note_capture(self.capture_ms / 1e3)
        self._delta = {k: n - before.get(k, 0) for k, n in after.items()
                       if n != before.get(k, 0)}
        self.graph, self._out, self._held = graph, out, held

    def free(self) -> None:
        """Release the graph, its memory pool, its outputs, what it holds
        and what the step function holds; the program cannot run again."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self._out = self.fn = self.inputs = None
        self._held = []
