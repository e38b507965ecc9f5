"""Where a training step's time goes on the card.

Usage, on a machine with one CUDA card, from the repository root:

    python -m deepspeed_tpu_torch.tools.profile_training [--pad-vocab N]

Trains gpt2-medium as ``chip_smoke.py``'s training phase does (bf16 on an
fp32 master, micro 8 x gas 2 x S1024, AdamW, WarmupLR, clipping 1.0, one
seeded token batch repeated, random weights) through
``deepspeed_tpu_torch.initialize``: two steps to warm up (kernel build,
cuBLAS handles, allocator), then two under ``torch.profiler``. Prints the
device time by kernel (the 12 largest), the flash kernels' shares, and the
device's busy and idle shares of the profiled wall time, then one JSON line
with the same numbers. The profiler's own host overhead lengthens the wall
time, so the idle share is an upper bound. ``--pad-vocab N`` pads the
embedding table to a multiple of N rows (the logical vocabulary and the
loss stay the same; the head GEMMs get aligned leading dimensions).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from deepspeed_tpu_torch.utils.profiling import device_time

# the kernels of the flash path, by the names their launches carry
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "flash_delta")


def train_config(micro: int = 8, gas: int = 2) -> dict:
    """The training section chip_smoke's training phase uses: bf16 on an
    fp32 master, AdamW (lr 3e-4, betas 0.9/0.95, wd 0.1), WarmupLR over 4
    steps, gradient clipping 1.0."""
    return {
        "train_micro_batch_size_per_gpu": micro,
        "gradient_accumulation_steps": gas,
        "bf16": {"enabled": True},
        "gradient_clipping": 1.0,
        "steps_per_print": 1000,
        "optimizer": {"type": "AdamW",
                      "params": {"lr": 3e-4, "betas": [0.9, 0.95], "weight_decay": 0.1}},
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 3e-4,
                                 "warmup_num_steps": 4}},
    }


def analytic_train_flops_per_token(L: int, h: int, vocab: int, S: int) -> float:
    """GPT-2 training flops per token: forward matmuls 2 (12 L h^2 + V h) plus
    attention's 4 L S h (QK^T and PV), times 3 for forward and backward
    (the count ``bench.py`` uses for MFU)."""
    fwd = 2.0 * (12.0 * L * h * h + vocab * h) + 4.0 * L * S * h
    return 3.0 * fwd


def profile_steps(engine, batch, steps: int, top: int = 12) -> dict:
    """``steps`` train steps on ``batch`` under the profiler → the breakdown."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.train_batch(batch)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    by_name, busy_us = device_time(prof)
    if not by_name:
        raise RuntimeError("the profiler recorded no device activity")
    total_us = sum(by_name.values())
    flash = {k: sum(t for n, t in by_name.items() if k in n) / total_us for k in FLASH_KERNELS}
    return {
        "steps": steps, "wall_s": wall_s, "device_busy_s": busy_us / 1e6,
        "idle_share": 1 - busy_us / 1e6 / wall_s, "device_s": total_us / 1e6,
        "flash_share_of_device": flash,
        "top": [[name, t / 1e6, t / total_us] for name, t in
                sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
    }


def print_profile(p: dict) -> None:
    print(f"profiled {p['steps']} steps: wall {p['wall_s']:.4f} s, device busy "
          f"{p['device_busy_s']:.4f} s, idle share {p['idle_share']:.4f} (an upper bound: the "
          "profiler lengthens the host's time)")
    print("flash kernels' shares of device time: " + ", ".join(
        f"{k} {v:.4f}" for k, v in p["flash_share_of_device"].items()))
    for name, s, share in p["top"]:
        print(f"  {s * 1e3:10.3f} ms  {share:6.4f}  {name[:100]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pad-vocab", type=int, default=1,
                    help="pad the embedding table to a multiple of this many rows")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_training: needs a CUDA device", file=sys.stderr)
        return 1

    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models import gpt2

    cfg = gpt2.get_config("gpt2-medium", pad_vocab_multiple=args.pad_vocab)
    eng, *_ = dtt.initialize(model=gpt2.make_module(cfg), config=train_config(), seed=0)
    ids = np.random.RandomState(5).randint(
        0, cfg.vocab_size, (eng.train_batch_size, cfg.n_positions)).astype(np.int32)
    batch = {"input_ids": ids}
    for _ in range(2):
        eng.train_batch(batch)
    p = profile_steps(eng, batch, 2)
    print(f"{torch.cuda.get_device_name(0)}; gpt2-medium bf16, micro 8 x gas 2 x seq "
          f"{cfg.n_positions}, embedding rows {cfg.padded_vocab_size}")
    print_profile(p)
    print(json.dumps(dict(p, device=torch.cuda.get_device_name(0),
                          padded_vocab=cfg.padded_vocab_size)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
