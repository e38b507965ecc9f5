"""Where the serving main path's time goes on the card.

Usage, on a machine with one CUDA card, from the repository root:

    python -m deepspeed_tpu_torch.tools.profile_serving [--model gpt2-medium]
        [--requests 16] [--seed 1234] [--top 12]

Serves mixed requests (prompts of 8..128 tokens, budgets of 16..64, drawn
from ``--seed``) through the model in bf16 with random weights and the
default serving section: once to warm up (kernel build, cuBLAS handles,
allocator), then again under ``torch.profiler``. Prints the device time by
kernel (the ``--top`` largest), the paged decode kernel's share, and the
device's busy and idle shares of the profiled run's wall time, then one
JSON line with the same numbers. The profiler's own host overhead lengthens
the wall time, so the idle share it reports is an upper bound.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict

import numpy as np
import torch


def _serve_once(eng, n_requests: int, seed: int):
    srv = eng.serve()
    vocab = eng.model_config.vocab_size
    rs = np.random.RandomState(seed)
    for i in range(n_requests):  # the same draws as chip_smoke.py's phase 3
        plen = int(rs.randint(8, 129))
        budget = int(rs.randint(16, 65))
        srv.submit(rs.randint(0, vocab, plen), max_new_tokens=budget, seed=i)
    t0 = time.perf_counter()
    srv.run()
    torch.cuda.synchronize()
    return srv, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="gpt2-medium")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_serving: needs a CUDA device", file=sys.stderr)
        return 1

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import deepspeed_tpu_torch as dtt

    eng = dtt.init_inference(args.model, dtype=torch.bfloat16, seed=0)
    _serve_once(eng, args.requests, args.seed)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        srv, wall_s = _serve_once(eng, args.requests, args.seed)

    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events() if e.device_type == DeviceType.CUDA
    )
    if not spans:
        print("profile_serving: the profiler recorded no device activity", file=sys.stderr)
        return 1
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
    busy_us += cur_end - cur_start
    total_us = sum(by_name.values())
    paged_us = sum(t for n, t in by_name.items() if "paged_decode_kernel" in n)
    steps = srv.stats()["decode_steps"]

    print(f"{torch.cuda.get_device_name(0)}; {args.requests} requests, {steps} decode steps, "
          f"wall {wall_s:.3f} s under the profiler")
    print(f"device busy {busy_us / 1e6:.4f} s = {busy_us / 1e6 / wall_s:.3f} of wall; "
          f"idle share {1 - busy_us / 1e6 / wall_s:.3f}")
    print(f"paged decode kernel {paged_us / 1e6:.4f} s = {paged_us / total_us:.3f} of device time, "
          f"{paged_us / max(steps, 1):.1f} us per decode step")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[: args.top]:
        print(f"  {t / 1e3:10.3f} ms  {t / total_us:6.3f}  {name[:100]}")
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "wall_s": wall_s,
        "device_busy_s": busy_us / 1e6, "idle_share": 1 - busy_us / 1e6 / wall_s,
        "decode_steps": steps, "paged_decode_kernel_s": paged_us / 1e6,
        "paged_decode_share_of_device": paged_us / total_us,
        "top": [[name, t / 1e6] for name, t in
                sorted(by_name.items(), key=lambda kv: -kv[1])[: args.top]],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
