"""Where offline ``generate``'s time goes on the card.

Usage, on a machine with one CUDA card, from the repository root:

    python -m deepspeed_tpu_torch.tools.profile_generate [--model gpt2-medium]
        [--batch 8] [--prompt 128] [--new 128] [--seed 0] [--top 12]

Builds the model in bf16 with random weights, runs
``InferenceEngine.generate`` once to warm up (kernel build, cuBLAS
handles, allocator), then once more under ``torch.profiler``. Prints the
device time by kernel (the ``--top`` largest), the contiguous decode
kernel's share and its time per decode step, and the device's busy and
idle shares of the profiled call's wall time, then one JSON line with the
same numbers. The profiler's own host overhead lengthens the wall time, so
the idle share it reports is an upper bound.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from deepspeed_tpu_torch.utils.profiling import device_time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="gpt2-medium")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=128)
    ap.add_argument("--new", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_generate: needs a CUDA device", file=sys.stderr)
        return 1

    from torch.profiler import ProfilerActivity, profile

    import deepspeed_tpu_torch as dtt

    eng = dtt.init_inference(args.model, dtype=torch.bfloat16, seed=0)
    ids = np.random.RandomState(args.seed).randint(
        0, eng.model_config.vocab_size, (args.batch, args.prompt)).astype(np.int32)
    eng.generate(ids, max_new_tokens=args.new)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate(ids, max_new_tokens=args.new)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0

    by_name, busy_us = device_time(prof)
    if not by_name:
        print("profile_generate: the profiler recorded no device activity", file=sys.stderr)
        return 1
    total_us = sum(by_name.values())
    # the contiguous kernel, not paged_decode_kernel
    dec_us = sum(t for n, t in by_name.items() if "::decode_kernel<" in n)
    steps = args.new - 1
    print(f"{torch.cuda.get_device_name(0)}; generate B{args.batch} prompt {args.prompt} "
          f"+ {args.new} new tokens ({steps} decode steps), wall {wall_s:.3f} s under the "
          "profiler")
    print(f"device busy {busy_us / 1e6:.4f} s = {busy_us / 1e6 / wall_s:.3f} of wall; "
          f"idle share {1 - busy_us / 1e6 / wall_s:.3f}")
    print(f"decode kernel {dec_us / 1e6:.4f} s = {dec_us / total_us:.3f} of device time, "
          f"{dec_us / max(steps, 1):.1f} us per decode step")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[: args.top]:
        print(f"  {t / 1e3:10.3f} ms  {t / total_us:6.3f}  {name[:100]}")
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "wall_s": wall_s,
        "device_busy_s": busy_us / 1e6, "idle_share": 1 - busy_us / 1e6 / wall_s,
        "batch": args.batch, "prompt": args.prompt, "new_tokens": args.new,
        "decode_kernel_s": dec_us / 1e6, "decode_kernel_share_of_device": dec_us / total_us,
        "top": [[name, t / 1e6] for name, t in
                sorted(by_name.items(), key=lambda kv: -kv[1])[: args.top]],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
