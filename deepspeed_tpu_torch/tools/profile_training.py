"""Where a training step's time goes on the card.

Usage, on a machine with one CUDA card, from the repository root:

    python -m deepspeed_tpu_torch.tools.profile_training [--pad-vocab N]
    python -m deepspeed_tpu_torch.tools.profile_training --sparse
    python -m deepspeed_tpu_torch.tools.profile_training --model bert-large --sparse
    python -m deepspeed_tpu_torch.tools.profile_training --model bert-large --optimizer Lamb
    python -m deepspeed_tpu_torch.tools.profile_training --dropout 0.1 [--timed 10]

Trains one of ``chip_smoke.py``'s training workloads through
``deepspeed_tpu_torch.initialize`` (bf16 on an fp32 master, clipping 1.0,
WarmupLR, one seeded batch repeated, random weights):

- default: gpt2-medium, micro 8 x gas 2 x S1024, AdamW (phase 6);
- ``--sparse``: gpt2-medium at S4096 with the fixed unidirectional
  ``sparse_attention`` section of block 64, micro 2 x gas 2, AdamW (phase 11);
- ``--model bert-large [--sparse]``: BERT-large MLM + NSP pre-training at
  S512, micro 16, Adam, with the default ``sparse_attention`` section under
  ``--sparse`` (fixed bidirectional, block 16; phase 12), else dense;
- ``--model bert-large --optimizer Lamb``: dense BERT-large at S128, micro
  64, LAMB (lr 1e-3, betas 0.9/0.999, eps 1e-6, wd 0.01), the S128 stage of
  DeepSpeed's BERT LAMB recipe (phase 15);
- ``--dropout 0.1``: GPT-2 at that dropout rate (phase 17 with the
  default workload).

``--timed N`` times N steps without the profiler instead (each closed by a
sync; the median, as ``chip_smoke.py`` reports step ms): run this file by
path with an older tree first on ``PYTHONPATH`` to time that tree, older
and newer alternating in one call. ``--eager`` runs the training step's
program uncaptured (``utils/graphs.py``'s private switch), the A/B against
the captured step (an older tree's training step is eager either way).

Two steps warm up (kernel build, cuBLAS handles, allocator; the first
runs the step eagerly, the second captures it), then two run under
``torch.profiler``. Prints the device time by kernel (the 12
largest), the attention and optimizer kernels' shares, and the device's
busy and idle shares of the profiled wall time, then one JSON line with the same numbers.
The profiler's own host overhead lengthens the wall time, so the idle share
is an upper bound. ``--pad-vocab N`` pads GPT-2's embedding table to a
multiple of N rows (the logical vocabulary and the loss stay the same; the
head GEMMs get aligned leading dimensions).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time

import numpy as np
import torch

from deepspeed_tpu_torch.ops.launches import LAUNCHES
from deepspeed_tpu_torch.utils.profiling import (MARKER, TRAINING_KERNEL_EVENTS, device_time,
                                                 mark, traced_launches)

# the attention kernels of each path, by the names their launches carry
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "flash_bwd_prep", "flash_delta")
BLOCK_SPARSE_KERNELS = ("bs_fwd", "bs_dq", "bs_dkv")
# the fused optimizer kernels (csrc/fused_adam.cu)
OPTIMIZER_KERNELS = ("adam_kernel", "lamb_stage1", "lamb_stage2")
# the GPT-2 sparse workload's section: local windows of 4 blocks of 64 plus
# one global block per window, causal (10240 of 65536 blocks at S4096, H16)
GPT2_SPARSE_SECTION = {"mode": "fixed", "block": 64, "num_local_blocks": 4,
                       "num_global_blocks": 1, "attention": "unidirectional"}


OPTIMIZER_PARAMS = {
    "AdamW": {"lr": 3e-4, "betas": [0.9, 0.95], "weight_decay": 0.1},
    "Adam": {"lr": 3e-4},
    "Lamb": {"lr": 1e-3, "betas": [0.9, 0.999], "eps": 1e-6, "weight_decay": 0.01},
}


def train_config(micro: int = 8, gas: int = 2, optimizer: str = "AdamW") -> dict:
    """The training section chip_smoke's training phases use: bf16 on an
    fp32 master, the optimizer with its :data:`OPTIMIZER_PARAMS`, WarmupLR
    to its lr over 4 steps, gradient clipping 1.0."""
    params = dict(OPTIMIZER_PARAMS[optimizer])
    return {
        "train_micro_batch_size_per_gpu": micro,
        "gradient_accumulation_steps": gas,
        "bf16": {"enabled": True},
        "gradient_clipping": 1.0,
        "steps_per_print": 1000,
        "optimizer": {"type": optimizer, "params": params},
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_min_lr": 0.0, "warmup_max_lr": params["lr"],
                                 "warmup_num_steps": 4}},
    }


def bert_batch(vocab: int, rows: int, S: int, seed: int) -> dict:
    """A BERT pre-training batch: 15% of the tokens masked (token 103) with
    their labels, -100 elsewhere; two segments; next-sentence labels; no
    attention mask (full-length rows keep every layer on the kernels)."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(1000, vocab, (rows, S)).astype(np.int32)
    labels = np.full((rows, S), -100, np.int32)
    pick = rs.rand(rows, S) < 0.15
    labels[pick] = ids[pick]
    ids[pick] = 103
    return {"input_ids": ids, "labels": labels,
            "token_type_ids": np.repeat((np.arange(S)[None] >= S // 2), rows, 0).astype(np.int32),
            "next_sentence_label": rs.randint(0, 2, (rows,)).astype(np.int32)}


def workload(model: str = "gpt2-medium", sparse: bool = False, pad_vocab: int = 1,
             n_layer=None, seq=None, micro=None, gas=None, seed: int = 5, optimizer=None):
    """(model config, ModuleSpec, training config, one batch) of a training
    workload, at its own sizes unless overridden. BERT with ``optimizer=
    "Lamb"`` is the LAMB recipe's S128 stage (micro 64)."""
    from deepspeed_tpu_torch.models import bert, gpt2
    from deepspeed_tpu_torch.ops.sparse_attention import from_ds_config
    from deepspeed_tpu_torch.runtime.config import SparseAttentionConfig

    depth = {} if n_layer is None else {"n_layer": n_layer}
    if model.startswith("bert"):
        lamb = optimizer == "Lamb"
        S = seq or (128 if lamb else 512)
        extra = {}
        if sparse:
            extra = dict(attn_impl="sparse", sparsity_config=from_ds_config(
                SparseAttentionConfig(), bert.PRESETS[model]["n_head"]))
        cfg = bert.get_config(model, pretraining=True, **depth, **extra)
        conf = train_config(micro or (64 if lamb else 16), gas or 1,
                            optimizer=optimizer or "Adam")
        rows = conf["train_micro_batch_size_per_gpu"] * conf["gradient_accumulation_steps"]
        return cfg, bert.make_module(cfg), conf, bert_batch(cfg.vocab_size, rows, S, seed)
    if sparse:
        S = seq or 4096
        cfg = gpt2.get_config(model, n_positions=max(S, 1024), pad_vocab_multiple=pad_vocab,
                              sparse_attention=GPT2_SPARSE_SECTION, **depth)
        conf = train_config(micro or 2, gas or 2, optimizer=optimizer or "AdamW")
    else:
        S = seq or 1024
        cfg = gpt2.get_config(model, pad_vocab_multiple=pad_vocab, **depth)
        conf = train_config(micro or 8, gas or 2, optimizer=optimizer or "AdamW")
    rows = conf["train_micro_batch_size_per_gpu"] * conf["gradient_accumulation_steps"]
    ids = np.random.RandomState(seed).randint(0, cfg.vocab_size, (rows, S)).astype(np.int32)
    return cfg, gpt2.make_module(cfg), conf, {"input_ids": ids}


def analytic_train_flops_per_token(L: int, h: int, vocab: int, S: int) -> float:
    """GPT-2 training flops per token: forward matmuls 2 (12 L h^2 + V h) plus
    attention's 4 L S h (QK^T and PV), times 3 for forward and backward
    (the count ``bench.py`` uses for MFU)."""
    fwd = 2.0 * (12.0 * L * h * h + vocab * h) + 4.0 * L * S * h
    return 3.0 * fwd


def profile_steps(engine, batch, steps: int, top: int = 12,
                  kernels=FLASH_KERNELS + OPTIMIZER_KERNELS) -> dict:
    """``steps`` train steps on ``batch`` under the profiler → the breakdown;
    ``kernels``: the name fragments of the kernels whose shares to report."""
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
    shares = {k: sum(t for n, t in by_name.items() if k in n) / total_us for k in kernels}
    return {
        "steps": steps, "wall_s": wall_s, "device_busy_s": busy_us / 1e6,
        "idle_share": 1 - busy_us / 1e6 / wall_s, "device_s": total_us / 1e6,
        "kernel_share_of_device": shares,
        "top": [[name, t / 1e6, t / total_us] for name, t in
                sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
    }


def traced_step(engine, batch) -> list:
    """Each training kernel's events in a ``torch.profiler`` trace of one
    step against the launches counted over that step (a replay adds its
    capture's count): ``utils.profiling.traced_launches``, counted after
    the marker that follows a first, uncounted step (the trace's start
    loses records: ``utils/profiling.py``)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.train_batch(batch)
        torch.cuda.synchronize()
        before = dict(LAUNCHES)
        mark()
        engine.train_batch(batch)
        torch.cuda.synchronize()
    launched = {k: n - before.get(k, 0) for k, n in LAUNCHES.items()}
    return traced_launches(prof, launched, TRAINING_KERNEL_EVENTS, since=MARKER)


def print_profile(p: dict) -> None:
    print(f"profiled {p['steps']} steps: wall {p['wall_s']:.4f} s, device busy "
          f"{p['device_busy_s']:.4f} s, idle share {p['idle_share']:.4f} (an upper bound: the "
          "profiler lengthens the host's time)")
    print("kernels' shares of device time: " + ", ".join(
        f"{k} {v:.4f}" for k, v in p["kernel_share_of_device"].items()))
    for name, s, share in p["top"]:
        print(f"  {s * 1e3:10.3f} ms  {share:6.4f}  {name[:100]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="gpt2-medium", choices=("gpt2-medium", "bert-large"))
    ap.add_argument("--sparse", action="store_true",
                    help="block-sparse attention (GPT-2: phase 11's section; BERT: the default)")
    ap.add_argument("--pad-vocab", type=int, default=1,
                    help="pad GPT-2's embedding table to a multiple of this many rows")
    ap.add_argument("--optimizer", choices=tuple(OPTIMIZER_PARAMS), default=None,
                    help="the optimizer (default: AdamW for GPT-2, Adam for BERT; Lamb for "
                         "BERT is the S128 stage of the LAMB recipe)")
    ap.add_argument("--dropout", type=float, default=0.0, help="GPT-2's dropout rate")
    ap.add_argument("--timed", type=int, default=0,
                    help="time this many steps without the profiler instead")
    ap.add_argument("--eager", action="store_true",
                    help="run the training step uncaptured (the A/B against the graph)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_training: needs a CUDA device", file=sys.stderr)
        return 1

    import deepspeed_tpu_torch as dtt

    cfg, module, conf, batch = workload(args.model, args.sparse, args.pad_vocab,
                                        optimizer=args.optimizer)
    if args.dropout:
        from deepspeed_tpu_torch.models import gpt2

        if args.model != "gpt2-medium":
            raise SystemExit("profile_training: --dropout applies to GPT-2")
        module = gpt2.make_module(dataclasses.replace(cfg, dropout=args.dropout))
    eng, *_ = dtt.initialize(model=module, config=conf, seed=0)
    if args.eager:
        from deepspeed_tpu_torch.utils import graphs

        graphs._EAGER = True  # the programs built below run uncaptured
    for _ in range(2):
        eng.train_batch(batch)
    if args.timed:
        step_s = []
        for _ in range(args.timed):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.train_batch(batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        print(json.dumps({"device": torch.cuda.get_device_name(0), "model": args.model,
                          "sparse": args.sparse, "dropout": args.dropout,
                          "eager": args.eager,
                          "package": dtt.__file__,
                          "step_ms_median": statistics.median(step_s) * 1e3,
                          "step_ms": [x * 1e3 for x in step_s]}))
        return 0
    p = profile_steps(eng, batch, 2, kernels=(BLOCK_SPARSE_KERNELS if args.sparse
                                              else FLASH_KERNELS) + OPTIMIZER_KERNELS)
    S = batch["input_ids"].shape[1]
    print(f"{torch.cuda.get_device_name(0)}; {args.model} bf16"
          f"{' block-sparse' if args.sparse else ''}, micro "
          f"{eng.micro_batch_size} x gas {eng.gradient_accumulation_steps} x seq {S}")
    print_profile(p)
    print(json.dumps(dict(p, device=torch.cuda.get_device_name(0), model=args.model,
                          sparse=args.sparse, seq=S,
                          optimizer=conf["optimizer"]["type"])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
