"""Device time of the contiguous decode kernel and the flash-attention forward
at the shapes of offline ``generate`` and GPT-2 training, for comparing two
trees of this package on one card.

Usage, on a machine with one CUDA card:

    PYTHONPATH=<tree> python <this tree>/deepspeed_tpu_torch/tools/time_attention_kernels.py
        [--label NAME] [--library]

Run as a file (not with ``-m``), so that ``deepspeed_tpu_torch`` is imported
from ``<tree>``: an unpacked older commit times that commit's kernels through
the same public wrappers (``ops.decode_attention.decode_attention``,
``ops.flash_attention.flash_attention_fwd``), which build its own sources
into its own ``_build/``. Alternate the trees within one call (older, newer,
newer, older): calls and cards differ by several percent. Prints one JSON
line: ms per call (device time, CUDA events, the host's enqueueing hidden
behind a device-side sleep) for each case, ``--library`` adds SDPA on the
same inputs. Inputs come from a seeded generator on the card. The time
function is the one ``chip_smoke.py`` uses.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch
import torch.nn.functional as F


def _events_ms(fn, iters, sleep_cycles=0):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if sleep_cycles:
        torch.cuda._sleep(sleep_cycles)
    start.record()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    host_s = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_s


def time_ms(fn, iters, warmup=10):
    """(device ms per call, host-inclusive ms per call). The first is taken
    with CUDA events around ``iters`` calls enqueued behind a device-side
    sleep long enough to hide the host's enqueueing, so it counts device
    execution only; the second is the same loop without the sleep, where a
    host slower than the device leaves gaps between launches."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    call_ms, host_s = _events_ms(fn, iters)
    probe = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    probe[0].record()
    torch.cuda._sleep(10_000_000)
    probe[1].record()
    torch.cuda.synchronize()
    cycles_per_ms = 10_000_000 / probe[0].elapsed_time(probe[1])
    sleep_ms = 4 * host_s * 1e3
    device_ms, host_s2 = _events_ms(fn, iters, int(sleep_ms * cycles_per_ms))
    if host_s2 * 1e3 > sleep_ms:
        print(f"note: enqueueing took {host_s2 * 1e3:.2f} ms > the {sleep_ms:.2f} ms sleep; "
              "the device time includes host gaps")
    return device_ms, call_ms


# (label, B, Smax, H, KV, D, layers, positions): generate's decode step
# (a layer's slice of a 24-layer cache, over positions its steps pass) and
# a long cache at its last row
DECODE_CASES = [
    ("decode B8 Smax256 H16 D64 bf16", 8, 256, 16, 16, 64, 24, [128, 160, 192, 224, 254]),
    ("decode B2 Smax4096 H16 D64 bf16 pos 4095", 2, 4096, 16, 16, 64, 4, [4095]),
]
# (label, B, S, H, KV, D, causal): training's shape, generate's prefill
# bucket, one long sequence, D128
FLASH_CASES = [
    ("flash fwd B8 S1024 H16 D64 bf16 causal", 8, 1024, 16, 16, 64, True),
    ("flash fwd B8 S128 H16 D64 bf16 causal", 8, 128, 16, 16, 64, True),
    ("flash fwd B1 S8192 H4 D64 bf16 causal", 1, 8192, 4, 4, 64, True),
    ("flash fwd B2 S1024 H8 D128 bf16 causal", 2, 1024, 8, 8, 128, True),
]


def time_decode(case, library):
    from deepspeed_tpu_torch.ops import decode_attention as tda

    label, B, S, H, KV, D, L, positions = case
    g = torch.Generator(device="cuda").manual_seed(31)
    q = torch.randn(B, H, D, generator=g, device="cuda").to(torch.bfloat16)
    k = torch.randn(L, B, S, KV, D, generator=g, device="cuda").to(torch.bfloat16)
    v = torch.randn(L, B, S, KV, D, generator=g, device="cuda").to(torch.bfloat16)
    n = len(positions)
    out = {label: time_ms(lambda i: tda.decode_attention(q, k[i % L], v[i % L],
                                                         positions[i % n]), 480)[0]}
    if library:
        def lib(i):
            p = positions[i % n]
            return F.scaled_dot_product_attention(
                q[:, :, None], k[i % L][:, : p + 1].transpose(1, 2),
                v[i % L][:, : p + 1].transpose(1, 2))
        out[label + " library"] = time_ms(lib, 96)[0]
    return out


def time_flash(case, library):
    from deepspeed_tpu_torch.ops import flash_attention as fa

    label, B, S, H, KV, D, causal = case
    g = torch.Generator(device="cuda").manual_seed(10)
    q = torch.randn(B, S, H, D, generator=g, device="cuda").to(torch.bfloat16)
    k = torch.randn(B, S, KV, D, generator=g, device="cuda").to(torch.bfloat16)
    v = torch.randn(B, S, KV, D, generator=g, device="cuda").to(torch.bfloat16)
    out = {label: time_ms(lambda i: fa.flash_attention_fwd(q, k, v, causal), 60)[0]}
    if library:
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        out[label + " library"] = time_ms(
            lambda i: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal), 60)[0]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="tree")
    ap.add_argument("--library", action="store_true", help="also time SDPA on the same inputs")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_attention_kernels: no CUDA device; the times are the card's", file=sys.stderr)
        return 1
    import deepspeed_tpu_torch

    times = {}
    for case in DECODE_CASES:
        times.update(time_decode(case, args.library))
        torch.cuda.empty_cache()
    for case in FLASH_CASES:
        times.update(time_flash(case, args.library))
        torch.cuda.empty_cache()
    print(json.dumps({"label": args.label, "package": deepspeed_tpu_torch.__file__,
                      "device": torch.cuda.get_device_name(0), "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
