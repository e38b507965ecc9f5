"""Reductions of a ``torch.profiler`` trace, shared by the profiling tools.

The trace records the device a moment after the profiler starts, and a
captured graph replayed at once loses its first records (on an H100, 2 to
~80 of a replay or a ``generate`` call begun at the profiler's start). A
tool that counts a program's kernels therefore runs it once under the
profiler, launches :data:`MARKER` (:func:`mark`), runs it again, and
reduces only the device events after the marker (``since=MARKER``)."""

from __future__ import annotations

from collections import defaultdict

# ATen's spin_kernel, which ``torch.cuda._sleep`` launches
MARKER = "spin_kernel"


def mark() -> None:
    """Launch the marker kernel on the current stream."""
    import torch

    torch.cuda._sleep(1000)


def _device_spans(prof, since=None):
    """The device events ``(start, end, name)`` in time order; with
    ``since`` (a name fragment), only those after its last event."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if since is not None:
        t0 = max(start for start, _, name in spans if since in name)
        spans = [s for s in spans if s[0] > t0]
    return spans


def device_time(prof, since=None):
    """Device activity of a ``torch.profiler`` run (after the ``since``
    marker, if given) → (µs by kernel name, µs the device was busy: the
    union of the kernels' intervals)."""
    spans = _device_spans(prof, since)
    by_name = defaultdict(float)
    busy_us, cur_start, cur_end = 0.0, None, None
    for start, end, name in spans:
        by_name[name] += end - start
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy_us += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy_us += cur_end - cur_start
    return dict(by_name), busy_us


def runtime_calls(prof):
    """The host side of the CUDA runtime in a ``torch.profiler`` run → {call
    name: (µs on the host, calls)}: where a host-bound loop waits (a
    ``cudaStreamSynchronize`` or a blocking ``cudaMemcpyAsync``) or spends
    its launches."""
    from torch.autograd import DeviceType

    out = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith("cuda"):
            out[e.name][0] += e.time_range.end - e.time_range.start
            out[e.name][1] += 1
    return {name: (us, n) for name, (us, n) in out.items()}


# the inference programs' kernels in a trace (their csrc entry points'
# names), each with the registry entries that count its launches
# (ops/launches.py)
PROGRAM_KERNEL_EVENTS = (
    ("::decode_split_kernel<", ("decode_attention",)),
    ("::paged_split_kernel<", ("paged_decode_attention", "paged_decode_attention_int8")),
    ("::paged_multitoken_", ("paged_multitoken_attention",
                             "paged_multitoken_attention_int8")),
    ("uniform_rows_kernel<", ("threefry_uniform_rows",)),
)


# the training step's kernels: one event a launch counted (the flash
# backward's launch runs a prep kernel, dk/dv and one dq kernel; LAMB's
# launch counts 2, its two stages)
TRAINING_KERNEL_EVENTS = (
    ("flash_fwd_", ("flash_attention_fwd",)),
    ("flash_bwd_dq_", ("flash_attention_bwd",)),
    ("bs_fwd_", ("block_sparse_attention_fwd",)),
    ("bs_dq_", ("block_sparse_attention_dq",)),
    ("bs_dkv_", ("block_sparse_attention_dkv",)),
    ("::adam_kernel<", ("fused_adamw",)),
    ("::lamb_stage", ("fused_lamb",)),
    ("::dropout_kernel<", ("threefry_dropout",)),
)


def traced_launches(prof, launched, events=PROGRAM_KERNEL_EVENTS, since=None):
    """The programs' kernels that a ``torch.profiler`` run saw on the device
    against the launches the registry counted over the same run
    (``launched``: entry → launches; a captured graph's replay adds its
    capture's count, and the trace sees each of its kernel nodes) →
    ``[(kernel name, kernels in the trace, launches counted)]``; ``events``
    the (name fragment, registry entries) pairs to count. ``since``: a name
    fragment of a marker kernel; only the events after its last one count."""
    names = [name for _, _, name in _device_spans(prof, since)]
    return [(pattern, sum(pattern in n for n in names), sum(launched.get(k, 0) for k in entries))
            for pattern, entries in events]
