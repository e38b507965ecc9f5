"""Where offline ``generate``'s time goes on the card.

Usage, on a machine with one CUDA card, from the repository root:

    python -m deepspeed_tpu_torch.tools.profile_generate [--model gpt2-medium]
        [--batch 8] [--prompt 128] [--new 128] [--seed 0] [--top 12] [--eager]

Builds the model in bf16 with random weights, runs
``InferenceEngine.generate`` twice to warm up (kernel build, cuBLAS
handles, allocator; the first call runs the generate entry's programs
eagerly, the second captures them as CUDA graphs), then under
``torch.profiler`` once, a marker kernel and the profiled call, replaying
the graphs (the numbers are the device events after the marker: the
trace's start loses records). Prints the device time by kernel
(the ``--top`` largest), the contiguous decode kernel's share and its time
per decode step, the device's busy and idle shares of the profiled call's
wall time, the entry's graphs and their capture ms, each program kernel's
events in the trace against the launches its wrapper counted
(``ops/launches.py``), then one JSON line with the same numbers. The profiler's own host overhead lengthens the wall time,
so the idle share it reports is an upper bound. ``--eager`` runs the same
programs without capturing them (``utils.graphs._EAGER``, the A/B's other
side; not a configuration of the package).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from deepspeed_tpu_torch.ops.launches import LAUNCHES
from deepspeed_tpu_torch.utils import graphs
from deepspeed_tpu_torch.utils.profiling import MARKER, device_time, mark, traced_launches


def profile_generate(eng, ids, new: int, eager: bool = False, **sampling) -> dict:
    """Two warm-up calls of ``eng.generate(ids, max_new_tokens=new,
    **sampling)``, then under ``torch.profiler`` a third, the marker and
    the profiled call → the numbers of the JSON line, from the device
    events after the marker (the trace's start loses records:
    ``utils/profiling.py``): device time by kernel in ``by_name``, µs;
    ``traced``: each program kernel's events in the trace against the
    launches counted in the profiled call,
    ``utils.profiling.traced_launches``. ``eager`` builds the entry's
    programs uncaptured."""
    from torch.profiler import ProfilerActivity, profile

    prev, graphs._EAGER = graphs._EAGER, eager
    try:
        for _ in range(2):
            eng.generate(ids, max_new_tokens=new, **sampling)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            eng.generate(ids, max_new_tokens=new, **sampling)
            torch.cuda.synchronize()
            before = dict(LAUNCHES)
            mark()
            t0 = time.perf_counter()
            eng.generate(ids, max_new_tokens=new, **sampling)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
    finally:
        graphs._EAGER = prev
    launched = {k: n - before.get(k, 0) for k, n in LAUNCHES.items()}
    progs = [p for entry in eng._generate_cache.values() for p in entry.programs]
    by_name, busy_us = device_time(prof, since=MARKER)
    return {"wall_s": wall_s, "by_name": by_name, "device_busy_s": busy_us / 1e6,
            "idle_share": 1 - busy_us / 1e6 / wall_s, "eager": eager,
            "graphs": sum(p.graph is not None for p in progs),
            "capture_ms": sum(p.capture_ms or 0.0 for p in progs),
            "traced": traced_launches(prof, launched, since=MARKER)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="gpt2-medium")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=128)
    ap.add_argument("--new", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--eager", action="store_true",
                    help="run the programs without capturing them (the A/B's other side)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_generate: needs a CUDA device", file=sys.stderr)
        return 1

    import deepspeed_tpu_torch as dtt

    eng = dtt.init_inference(args.model, dtype=torch.bfloat16, seed=0)
    ids = np.random.RandomState(args.seed).randint(
        0, eng.model_config.vocab_size, (args.batch, args.prompt)).astype(np.int32)
    r = profile_generate(eng, ids, args.new, args.eager)
    by_name, busy_us, wall_s = r["by_name"], r["device_busy_s"] * 1e6, r["wall_s"]
    if not by_name:
        print("profile_generate: the profiler recorded no device activity", file=sys.stderr)
        return 1
    total_us = sum(by_name.values())
    # the contiguous kernel (csrc/decode_attention.cu), not the paged one
    dec_us = sum(t for n, t in by_name.items() if "::decode_split_kernel<" in n)
    steps = args.new - 1
    print(f"{torch.cuda.get_device_name(0)}; generate B{args.batch} prompt {args.prompt} "
          f"+ {args.new} new tokens ({steps} decode steps), wall {wall_s:.3f} s under the "
          f"profiler; {'eager' if args.eager else 'captured'}: {r['graphs']} graphs, capture "
          f"{r['capture_ms']:.1f} ms")
    print(f"device busy {busy_us / 1e6:.4f} s = {busy_us / 1e6 / wall_s:.3f} of wall; "
          f"idle share {1 - busy_us / 1e6 / wall_s:.3f}")
    print(f"decode kernel {dec_us / 1e6:.4f} s = {dec_us / total_us:.3f} of device time, "
          f"{dec_us / max(steps, 1):.1f} us per decode step")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[: args.top]:
        print(f"  {t / 1e3:10.3f} ms  {t / total_us:6.3f}  {name[:100]}")
    print("kernels in the trace / launches counted: " + ", ".join(
        f"{name} {seen} / {counted}" for name, seen, counted in r["traced"]))
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "wall_s": wall_s,
        "device_busy_s": busy_us / 1e6, "idle_share": 1 - busy_us / 1e6 / wall_s,
        "batch": args.batch, "prompt": args.prompt, "new_tokens": args.new,
        "eager": args.eager, "graphs": r["graphs"], "capture_ms": r["capture_ms"],
        "decode_kernel_s": dec_us / 1e6, "decode_kernel_share_of_device": dec_us / total_us,
        "traced_launches": r["traced"],
        "top": [[name, t / 1e6] for name, t in
                sorted(by_name.items(), key=lambda kv: -kv[1])[: args.top]],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
