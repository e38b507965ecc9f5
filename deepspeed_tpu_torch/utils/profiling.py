"""Reductions of a ``torch.profiler`` trace, shared by the profiling tools."""

from __future__ import annotations

from collections import defaultdict


def device_time(prof):
    """Device activity of a ``torch.profiler`` run → (µs by kernel name, µs
    the device was busy: the union of the kernels' intervals)."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
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


def traced_launches(prof, launched):
    """The programs' kernels that a ``torch.profiler`` run saw on the device
    against the launches the registry counted over the same run
    (``launched``: entry → launches; a captured graph's replay adds its
    capture's count, and the trace sees each of its kernel nodes) →
    ``[(kernel name, kernels in the trace, launches counted)]``."""
    from torch.autograd import DeviceType

    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    return [(pattern, sum(pattern in n for n in names), sum(launched.get(k, 0) for k in entries))
            for pattern, entries in PROGRAM_KERNEL_EVENTS]
