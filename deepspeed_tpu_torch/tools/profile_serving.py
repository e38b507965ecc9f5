"""Where the serving paths' time goes on the card.

Usage, on a machine with one CUDA card, from the repository root:

    python -m deepspeed_tpu_torch.tools.profile_serving [--model gpt2-medium]
        [--requests 16] [--seed 1234] [--top 12] [--features] [--int8]
        [--sampled] [--timed N] [--eager]

Serves requests through the model in bf16 with random weights: once to
warm up (kernel build, cuBLAS handles, allocator), then again under
``torch.profiler``. By default the traffic is mixed requests (prompts of
8..128 tokens, budgets of 16..64, drawn from ``--seed``) through the
default serving section; with ``--features`` it is the shared-prefix
traffic through :data:`FEATURES_SECTION` (speculation k=4, the prefix
cache, 64-token chunks), as ``chip_smoke.py`` phase 3b serves it; with
``--int8`` the pool holds int8 pages (``kv_cache_dtype="int8"``; with
``--features`` that is phase 3c's configuration); with ``--sampled`` the
requests are sampled at ``chip_smoke.py`` phase 20's temperature 0.8,
top-k 50, top-p 0.95 (greedy otherwise). Prints
the device time by kernel (the ``--top`` largest), the paged kernels'
shares, the device's busy and idle shares of the profiled run's wall
time and the host's time in the CUDA runtime calls that take most of it
(a sync, a blocking copy, the launches), then one JSON line with the same
numbers. The profiler's own host
overhead lengthens the wall time, so the idle share it reports is an upper
bound. It also counts each program kernel's events in the trace against
the launches the kernels' wrappers counted (``ops/launches.py``) in the
same run.

The serving programs run as captured CUDA graphs (``utils/graphs.py``);
the output names the programs' graphs and their capture ms. ``--eager``
builds them uncaptured (``utils.graphs._EAGER``, the A/B's other side; not
a configuration of the package; a tree older than the graphs has no such
switch and always runs eager).

``--timed N`` replaces the profiled run with N runs without the profiler
and prints each run's end-to-end numbers as ``chip_smoke.py`` reads them
(decode tokens/s, tokens/s, TTFT and TPOT p50, wall), then one JSON line.
TTFT and TPOT are exact percentiles over the run's requests (each
request's TTFT and mean TPOT, ``np.percentile``): ``stats()`` interpolates
its quantiles over histogram buckets, which between 2.5 and 5 ms are as
coarse as the bucket.
The script uses only the serving entry points, so it also times an older
tree of the package: run it by path with that tree first on
``PYTHONPATH``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from deepspeed_tpu_torch.utils.profiling import device_time, runtime_calls

try:
    from deepspeed_tpu_torch.utils import graphs
except ImportError:  # a tree from before the captured programs
    graphs = None

# the serving section of the feature path at gpt2-medium's positions
FEATURES_SECTION = {
    "max_prompt_len": 512, "max_new_tokens": 64, "max_slots": 8, "page_size": 16,
    "num_pages": 512, "prefill_chunk_tokens": 64, "prefix_cache": {"enabled": True},
    "speculative": {"enabled": True, "k": 4},
}
SAMPLED = {"temperature": 0.8, "top_k": 50, "top_p": 0.95}


def mixed_requests(srv, n, vocab, seed):
    """``n`` requests with prompts of 8..128 tokens and budgets of 16..64,
    drawn from ``seed`` → [(request, budget)]."""
    rs = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        plen = int(rs.randint(8, 129))
        budget = int(rs.randint(16, 65))
        reqs.append((srv.submit(rs.randint(0, vocab, plen), max_new_tokens=budget, seed=i), budget))
    return reqs


def shared_prefix_requests(srv, vocab, seed, n_shared=8, n_cold=8, system_len=256,
                           tails=(8, 128), cold_lens=(64, 512), budgets=(16, 64)):
    """``n_shared`` prompts = one ``system_len``-token system prompt + their
    own tail, interleaved with ``n_cold`` cold prompts; lengths and budgets
    drawn from ``seed`` in the inclusive ranges given → [(request, budget)]."""
    rs = np.random.RandomState(seed)
    system = rs.randint(0, vocab, system_len)
    prompts = []
    for i in range(max(n_shared, n_cold)):
        if i < n_shared:
            tail = rs.randint(0, vocab, int(rs.randint(tails[0], tails[1] + 1)))
            prompts.append(np.concatenate([system, tail]))
        if i < n_cold:
            prompts.append(rs.randint(0, vocab, int(rs.randint(cold_lens[0], cold_lens[1] + 1))))
    reqs = []
    for i, p in enumerate(prompts):
        budget = int(rs.randint(budgets[0], budgets[1] + 1))
        reqs.append((srv.submit(p, max_new_tokens=budget, seed=i), budget))
    return reqs


def program_numbers(srv) -> dict:
    """The serving engine's programs: how many, how many captured, their
    capture ms (none before the captured programs)."""
    progs = getattr(srv, "executables", [])
    return {"programs": len(progs),
            "graphs": sum(getattr(p, "graph", None) is not None for p in progs),
            "capture_ms": sum(getattr(p, "capture_ms", None) or 0.0 for p in progs)}


def _serve_once(eng, n_requests: int, seed: int, features: bool, int8: bool,
                sampled: bool = False, eager: bool = False):
    vocab = eng.model_config.vocab_size
    section = dict(FEATURES_SECTION) if features else {}
    if int8:
        section["kv_cache_dtype"] = "int8"
    if sampled:
        section.update(SAMPLED)
    if graphs is not None:
        prev, graphs._EAGER = graphs._EAGER, eager
    try:
        srv = eng.serve(section or None)
    finally:
        if graphs is not None:
            graphs._EAGER = prev
    if features:
        shared_prefix_requests(srv, vocab, seed, n_shared=n_requests // 2,
                               n_cold=n_requests - n_requests // 2)
    else:
        mixed_requests(srv, n_requests, vocab, seed)
    t0 = time.perf_counter()
    srv.run()
    torch.cuda.synchronize()
    return srv, time.perf_counter() - t0


def profile_serve(eng, n_requests: int, seed: int, features: bool = False, int8: bool = False,
                  sampled: bool = False, eager: bool = False) -> dict:
    """One warm-up run of the traffic, then one under ``torch.profiler`` →
    the profiled run's engine (``srv``), ``wall_s``, the device time by
    kernel (``by_name``, µs), ``busy_us`` (the union of the kernels'
    intervals), and ``traced``: each program kernel's events in the trace
    against the launches the registry counted in that run
    (``utils.profiling.traced_launches``)."""
    from torch.profiler import ProfilerActivity, profile

    from deepspeed_tpu_torch.ops.launches import LAUNCHES
    from deepspeed_tpu_torch.utils.profiling import traced_launches

    _serve_once(eng, n_requests, seed, features, int8, sampled, eager)
    before = dict(LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        srv, wall_s = _serve_once(eng, n_requests, seed, features, int8, sampled, eager)
    launched = {k: n - before.get(k, 0) for k, n in LAUNCHES.items()}
    by_name, busy_us = device_time(prof)
    return {"srv": srv, "wall_s": wall_s, "by_name": by_name, "busy_us": busy_us,
            "traced": traced_launches(prof, launched), "runtime_calls": runtime_calls(prof)}


def exact_ms(requests, attr, q):
    """The exact q-th percentile (``np.percentile``) of a request attribute
    (``ttft_s``, ``tpot_s``) over the requests that have one, in ms."""
    vals = [getattr(r, attr) for r in requests if getattr(r, attr) is not None]
    return float(np.percentile(vals, q)) * 1e3 if vals else None


def _timed(eng, args) -> int:
    runs = []
    for i in range(args.timed):
        srv, wall_s = _serve_once(eng, args.requests, args.seed, args.features, args.int8,
                                  args.sampled, args.eager)
        st = srv.stats()
        done = srv.completed
        runs.append({"decode_tokens_per_s": st["decode_tokens_per_s"],
                     "tokens_per_s": st["tokens_per_s"],
                     "ttft_p50_ms": exact_ms(done, "ttft_s", 50),
                     "tpot_p50_ms": exact_ms(done, "tpot_s", 50),
                     "tpot_p99_ms": exact_ms(done, "tpot_s", 99), "wall_s": wall_s,
                     **program_numbers(srv)})
        print(f"run {i}: decode tokens/s {runs[-1]['decode_tokens_per_s']:.1f}, tokens/s "
              f"{runs[-1]['tokens_per_s']:.1f}, TTFT p50 {runs[-1]['ttft_p50_ms']:.2f} ms, "
              f"TPOT p50 {runs[-1]['tpot_p50_ms']:.3f} ms, p99 {runs[-1]['tpot_p99_ms']:.3f} ms "
              "(exact percentiles over the requests), "
              f"wall {wall_s:.3f} s; {runs[-1]['graphs']} graphs of {runs[-1]['programs']} "
              f"programs, capture {runs[-1]['capture_ms']:.1f} ms", flush=True)
        del srv
    import deepspeed_tpu_torch

    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "package": deepspeed_tpu_torch.__file__, "features": args.features,
                      "int8": args.int8, "sampled": args.sampled, "seed": args.seed,
                      "eager": args.eager, "runs": runs}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="gpt2-medium")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--features", action="store_true",
                    help="serve the shared-prefix traffic with speculation, the prefix "
                         "cache and chunked prefill on")
    ap.add_argument("--int8", action="store_true", help="int8 KV pages")
    ap.add_argument("--sampled", action="store_true",
                    help="sample at temperature 0.8, top-k 50, top-p 0.95")
    ap.add_argument("--timed", type=int, default=0,
                    help="N runs without the profiler, end-to-end numbers only")
    ap.add_argument("--eager", action="store_true",
                    help="run the programs without capturing them (the A/B's other side)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_serving: needs a CUDA device", file=sys.stderr)
        return 1

    import deepspeed_tpu_torch as dtt

    eng = dtt.init_inference(args.model, dtype=torch.bfloat16, seed=0)
    if args.timed:
        _serve_once(eng, args.requests, args.seed, args.features, args.int8, args.sampled,
                    args.eager)
        return _timed(eng, args)
    r = profile_serve(eng, args.requests, args.seed, args.features, args.int8, args.sampled,
                      args.eager)
    srv, wall_s, by_name, busy_us = r["srv"], r["wall_s"], r["by_name"], r["busy_us"]
    if not by_name:
        print("profile_serving: the profiler recorded no device activity", file=sys.stderr)
        return 1
    total_us = sum(by_name.values())
    # the kernels' entry names: paged_split_kernel (csrc/paged_decode_attention.cu),
    # paged_multitoken_mma / _fma (csrc/paged_multitoken_attention.cu)
    paged_us = sum(t for n, t in by_name.items() if "::paged_split_kernel<" in n)
    mt_us = sum(t for n, t in by_name.items() if "::paged_multitoken_" in n)
    st = srv.stats()
    steps, chunks = st["decode_steps"], st["chunk_prefills"]

    print(f"{torch.cuda.get_device_name(0)}; {args.requests} requests"
          f"{' (speculation, prefix cache, chunked prefill)' if args.features else ''}"
          f"{', int8 KV pages' if args.int8 else ''}, "
          f"{steps} decode steps, {chunks} chunk-program calls, wall {wall_s:.3f} s under "
          f"the profiler; {'eager' if args.eager else 'captured'}: "
          f"{program_numbers(srv)}")
    print(f"device busy {busy_us / 1e6:.4f} s = {busy_us / 1e6 / wall_s:.3f} of wall; "
          f"idle share {1 - busy_us / 1e6 / wall_s:.3f}")
    print(f"paged decode kernel {paged_us / 1e6:.4f} s = {paged_us / total_us:.3f} of device time, "
          f"{paged_us / max(steps, 1):.1f} us per decode step")
    print(f"paged multitoken kernel {mt_us / 1e6:.4f} s = {mt_us / total_us:.3f} of device time, "
          f"{mt_us / max(chunks, 1):.1f} us per chunk-program call")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[: args.top]:
        print(f"  {t / 1e3:10.3f} ms  {t / total_us:6.3f}  {name[:100]}")
    print("kernels in the trace / launches counted: " + ", ".join(
        f"{name} {seen} / {counted}" for name, seen, counted in r["traced"]))
    host = sorted(r["runtime_calls"].items(), key=lambda kv: -kv[1][0])[:6]
    print("host time in CUDA runtime calls: " + ", ".join(
        f"{name} {us / 1e3:.3f} ms / {n}" for name, (us, n) in host))
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "wall_s": wall_s,
        "device_busy_s": busy_us / 1e6, "idle_share": 1 - busy_us / 1e6 / wall_s,
        "features": args.features, "int8": args.int8, "eager": args.eager,
        **program_numbers(srv), "decode_steps": steps,
        "chunk_prefills": chunks,
        "paged_decode_kernel_s": paged_us / 1e6,
        "paged_decode_share_of_device": paged_us / total_us,
        "paged_multitoken_kernel_s": mt_us / 1e6,
        "paged_multitoken_share_of_device": mt_us / total_us,
        "top": [[name, t / 1e6] for name, t in
                sorted(by_name.items(), key=lambda kv: -kv[1])[: args.top]],
        "runtime_calls_s": [[name, us / 1e6, n] for name, (us, n) in host],
        "traced_launches": r["traced"],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
