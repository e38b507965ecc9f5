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
