"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

Usage, from the root of the repository:  python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  0  card: the name and power limit as nvidia-smi reports them; TF32 off.
  1  build: every CUDA source under deepspeed_tpu_torch/csrc/ compiled with
     nvcc for sm_90a (one nvcc per source, in parallel), with build seconds.
  2  kernels against their plain PyTorch versions on the card, at the
     serving paths' shapes and at other dtypes / head dims / GQA / ragged
     query counts: the paged decode kernel and the paged multi-token
     kernel (at T=1 also against the decode kernel); each timed with CUDA
     events at its main shape (device time, the host's enqueueing hidden
     behind a device-side sleep; and per call with the host's launch path)
     beside the plain version, one PyTorch library call computing the same
     function, and the bound (bytes moved over 3.35 TB/s, or operations
     over peak).
  3  serve: gpt2-medium in bf16 (seeded random weights) through
     init_inference(...).serve() with the default serving section; 16
     requests of mixed lengths must all finish with their full token count
     and no leaked pages, and the decode kernel must have launched exactly
     n_layer times per decode step.
  3b serve gpt2-medium bf16 with speculative decode (k=4), the prefix cache
     and chunked prefill (64-token chunks) on: 16 requests, 8 sharing a
     256-token system prompt, 8 cold up to 512 tokens. All must finish with
     no leaked pages and nonzero prefix hits, chunk prefills and verify
     steps; the multi-token kernel must have launched n_layer times per
     chunk-program call and the decode kernel n_layer x (k+1) times per
     verify step.
  4  fp32 greedy streams at gpt2-medium width and 4 layers, from one set
     of weights: the default path on the card (kernels) against the CPU
     (plain versions); then with the three features on, the card against
     the CPU and the card against the card's features-off streams. Each
     pair must be identical, except at a tie (top-2 logit margin < 1e-4),
     which is reported as such.
  5  one JSON line of per-kernel numbers, then the last line
     {"ok": true, "device": {...}} with "count": 1, the cards the run used.

Without a CUDA device it exits 1 before printing any result. It imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

import deepspeed_tpu_torch as dtt
from deepspeed_tpu_torch.models import gpt2
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops import paged_decode_attention as pda
from deepspeed_tpu_torch.ops import paged_multitoken_attention as pma
from deepspeed_tpu_torch.serving import RequestStatus
from deepspeed_tpu_torch.tools.profile_serving import (
    FEATURES_SECTION,
    mixed_requests,
    shared_prefix_requests,
)
from deepspeed_tpu_torch.utils.weights import params_from_numpy, params_to_numpy

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 1e-5, torch.float16: 1e-2, torch.bfloat16: 1e-2}
TIE_MARGIN = 1e-4


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def phase(n, title):
    print(f"== phase {n}: {title}", flush=True)


# ---------------------------------------------------------------------------
# phase 2 helpers
# ---------------------------------------------------------------------------

def make_case(B, H, KV, D, page, P, n, pos, dtype, inactive=(), layers=1, seed=0, T=None):
    """Random q ([B, H, D], or [B, T, H, D] given T) and pools on the card,
    distinct pages per active slot, scratch-page tables for the inactive
    slots, and the per-slot position (``pos`` of the decode kernel, ``base``
    of the multi-token kernel)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(*((B, H, D) if T is None else (B, T, H, D)), generator=g,
                    device="cuda").to(dtype)
    k = torch.randn(layers, P, KV, page, D, generator=g, device="cuda").to(dtype)
    v = torch.randn(layers, P, KV, page, D, generator=g, device="cuda").to(dtype)
    rs = np.random.RandomState(seed)
    bt = rs.choice(np.arange(1, P), (B, n), replace=False).astype(np.int32)
    for b in inactive:
        bt[b] = 0
    return (q, k, v, torch.from_numpy(bt).cuda(),
            torch.tensor(pos, dtype=torch.int32, device="cuda"))


# (kernel wrapper, its plain version)
DECODE = (pda.paged_decode_attention, pda.paged_decode_attention_ref)
MULTITOKEN = (pma.paged_multitoken_attention, pma.paged_multitoken_attention_ref)


def kernel_error(kernel, plain, q, k, v, bt, pos):
    """Max abs error of ``kernel`` against its f32 ``plain`` version."""
    out = kernel(q, k, v, bt, pos)
    torch.cuda.synchronize()
    check(out.shape == q.shape and out.dtype == q.dtype, "kernel output shape/dtype")
    check(bool(torch.isfinite(out).all()), "kernel output not finite")
    ref = plain(q.float(), k.float(), v.float(), bt, pos)
    return float((out.float() - ref).abs().max())


def library_attention(q, k, v, bt, pos):
    """The same function as one PyTorch library call (timed as a yardstick
    only; the port never calls it): gather the pages, then SDPA with the
    position mask. ``q [B, H, D]`` is one query at ``pos``; ``q [B, T, H,
    D]`` has query t at ``pos + t`` (the [B, 1, T, S] mask)."""
    one = q.dim() == 3
    if one:
        q = q[:, None]
    B, T, H, D = q.shape
    KV = k.shape[1]
    kd = k[bt.long()].transpose(2, 3).reshape(B, -1, KV, D).transpose(1, 2)
    vd = v[bt.long()].transpose(2, 3).reshape(B, -1, KV, D).transpose(1, 2)
    S = kd.shape[2]
    mask = (torch.arange(S, device=q.device)[None, None, :]
            <= pos.long()[:, None, None] + torch.arange(T, device=q.device)[None, :, None])
    gqa = {"enable_gqa": True} if KV != H else {}
    o = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), kd, vd, attn_mask=mask[:, None], **gqa
    ).transpose(1, 2)
    return o[:, 0] if one else o


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


def bound(q, k_layer, bt, pos):
    """Least time for one call (``q`` and ``pos`` as in
    :func:`library_attention`): the live K/V rows (keys up to each slot's
    last query, within its table), q, the output, the table and pos each
    moved once over HBM, against the score and weighted-sum flops of every
    query's visible keys at the inputs' peak; the larger wins."""
    if q.dim() == 3:
        q = q[:, None]
    B, T, H, D = q.shape
    KV = k_layer.shape[1]
    cap = bt.shape[1] * k_layer.shape[2]
    p = pos.long().cpu()
    n_live = (p + T).clamp(max=cap)
    kv_bytes = int(2 * n_live.sum() * KV * D * k_layer.element_size())
    nbytes = kv_bytes + 2 * q.numel() * q.element_size() + bt.numel() * 4 + pos.numel() * 4
    visible = (p[:, None] + torch.arange(T)[None, :] + 1).clamp(max=cap)
    flops = int(4 * visible.sum() * H * D)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS_PER_S[k_layer.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3/4 helpers
# ---------------------------------------------------------------------------

def compare_streams(label, a_reqs, b_reqs):
    """Greedy streams identical, except at a tie (top-2 margin < TIE_MARGIN
    in either run at the first differing token). → ties."""
    ties = 0
    for i, (a, b) in enumerate(zip(a_reqs, b_reqs)):
        if a.tokens == b.tokens:
            continue
        t = next(j for j, (x, y) in enumerate(zip(a.tokens, b.tokens)) if x != y)
        margin = min(a.margins[t], b.margins[t])
        print(f"{label}: request {i}: streams differ at token {t}, top-2 logit margin "
              f"{margin:.3e}")
        check(margin < TIE_MARGIN, f"{label}: request {i} differs at token {t} with margin "
                                   f"{margin:.3e} >= {TIE_MARGIN} (not a tie)")
        print(f"{label}: request {i}: a tie (margin < {TIE_MARGIN}), not a fault")
        ties += 1
    n_tok = sum(len(r.tokens) for r in a_reqs)
    print(f"{label}: {len(a_reqs) - ties} of {len(a_reqs)} identical, {ties} ties, "
          f"{n_tok} tokens compared")
    return ties


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; the port's smoke run needs the card",
              file=sys.stderr)
        return 1

    phase(0, "card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    phase(1, "build")
    built = op_builder.build()
    for name, secs in built.items():
        log = op_builder.BUILD_LOG.get(name, {}).get("log", "")
        regs = [int(w.split()[w.split().index("Used") + 1])
                for w in log.splitlines() if "Used" in w and "registers" in w]
        spills = [int(ln.split("bytes spill stores")[0].split(",")[-1])
                  for ln in log.splitlines() if "spill stores" in ln]
        print(f"built {name}: {secs:.2f} s"
              + (f", {len(regs)} kernels, registers {min(regs)}..{max(regs)}, spill stores "
                 f"in {sum(1 for b in spills if b)} (max {max(spills, default=0)} bytes)"
                 if regs else " (cached)"))
    print(f"build total (parallel): {max(built.values()):.2f} s")

    phase(2, "kernels against their plain versions")
    # the serving main path's shape: 8 slots, gpt2-medium heads, page 16,
    # 512-page bf16 pools, 12 pages a slot (128 prompt + 64 new tokens);
    # ragged pos with page-boundary values, two inactive slots on scratch.
    # 24 layers of pools, as the decode step has, so the timed loop walks
    # 24 distinct layers' pages (the live K/V of all of them exceeds L2)
    L = 24
    main_pos = [0, 15, 16, 17, 100, 191, 0, 0]
    q, k, v, bt, pos = make_case(8, 16, 16, 64, 16, 512, 12, main_pos, torch.bfloat16,
                                 inactive=(6, 7), layers=L, seed=1)
    errs = {}
    errs["main bf16 B8 H16 D64 page16"] = kernel_error(*DECODE, q, k[0], v[0], bt, pos)
    cases = [
        ("fp32 pool", dict(B=8, H=16, KV=16, D=64, page=16, P=128, n=12, pos=main_pos,
                           dtype=torch.float32, inactive=(6, 7))),
        ("GQA H16 KV8 fp32", dict(B=4, H=16, KV=8, D=64, page=16, P=64, n=8,
                                  pos=[3, 40, 127, 64], dtype=torch.float32)),
        ("D128 bf16", dict(B=4, H=8, KV=8, D=128, page=16, P=64, n=8,
                           pos=[0, 31, 32, 100], dtype=torch.bfloat16)),
        ("D256 fp16 page64", dict(B=3, H=4, KV=2, D=256, page=64, P=16, n=4,
                                  pos=[63, 64, 255], dtype=torch.float16)),
        ("page8 fp32 long + pos past table", dict(B=2, H=4, KV=4, D=64, page=8, P=160,
                                                   n=64, pos=[511, 1000], dtype=torch.float32)),
    ]
    for label, c in cases:
        dtype = c["dtype"]
        cq, ck, cv, cbt, cpos = make_case(**c, seed=2)
        errs[label] = kernel_error(*DECODE, cq, ck[0], cv[0], cbt, cpos)
        check(errs[label] <= TOL[dtype], f"{label}: max abs err {errs[label]} > {TOL[dtype]}")
    check(errs["main bf16 B8 H16 D64 page16"] <= TOL[torch.bfloat16],
          f"main shape: max abs err {errs['main bf16 B8 H16 D64 page16']}")
    for label, e in errs.items():
        print(f"paged_decode_attention {label}: max abs err {e:.3e}")
    lib_err = float((library_attention(q, k[0], v[0], bt, pos).float()
                     - pda.paged_decode_attention_ref(q.float(), k[0].float(), v[0].float(), bt, pos)
                     ).abs().max())
    check(lib_err <= TOL[torch.bfloat16], f"library yardstick disagrees: {lib_err}")

    ms, call_ms = time_ms(lambda i: pda.paged_decode_attention(q, k[i % L], v[i % L], bt, pos), 480)
    plain_ms, plain_call_ms = time_ms(
        lambda i: pda.paged_decode_attention_ref(q, k[i % L], v[i % L], bt, pos), 32)
    lib_ms, lib_call_ms = time_ms(lambda i: library_attention(q, k[i % L], v[i % L], bt, pos), 32)
    bound_ms, bound_by = bound(q, k[0], bt, pos)
    print(f"paged_decode_attention main shape, device ms per call: kernel {ms:.4f}, "
          f"plain {plain_ms:.4f}, library {lib_ms:.4f}, bound {bound_ms:.5f} ({bound_by}), "
          f"kernel at {bound_ms / ms:.3f} of bound")
    print(f"  per call with the host's launch path in the loop: kernel {call_ms:.4f} ms, "
          f"plain {plain_call_ms:.4f} ms, library {lib_call_ms:.4f} ms")
    del k, v

    # the chunk program's shape on phase 3b's path: one slot, a 64-token
    # chunk, gpt2-medium heads, page 16, 512-page bf16 pools, the table of
    # a 512 + 64-token reservation (36 pages); the chunks of a 512-token
    # prompt start at 0, 64, ..., 448. 24 layers of pools, as the chunk
    # program has.
    mt_bases = [0, 64, 256, 448]
    mq, mk, mv, mbt, _ = make_case(1, 16, 16, 64, 16, 512, 36, [0], torch.bfloat16,
                                   layers=L, seed=3, T=64)
    mbase = [torch.tensor([b0], dtype=torch.int32, device="cuda") for b0 in mt_bases]
    mt_errs = {}
    for b0, bb in zip(mt_bases, mbase):
        mt_errs[f"main bf16 B1 T64 H16 D64 page16 base {b0}"] = kernel_error(
            *MULTITOKEN, mq, mk[0], mv[0], mbt, bb)
    mt_main_err = max(mt_errs.values())
    check(mt_main_err <= TOL[torch.bfloat16], f"multitoken main shape: max abs err {mt_main_err}")
    mt_cases = [
        ("ragged B4 T5 bf16, one slot on scratch", dict(
            B=4, T=5, H=16, KV=16, D=64, page=16, P=64, n=6, pos=[14, 30, 47, 0],
            dtype=torch.bfloat16, inactive=(3,))),
        ("GQA H16 KV8 fp32", dict(B=2, T=16, H=16, KV=8, D=64, page=16, P=64, n=8,
                                  pos=[5, 40], dtype=torch.float32)),
        ("D128 bf16", dict(B=2, T=16, H=8, KV=8, D=128, page=16, P=64, n=8,
                           pos=[0, 33], dtype=torch.bfloat16)),
        ("ragged T37 fp16 page8", dict(B=2, T=37, H=16, KV=16, D=64, page=8, P=64, n=24,
                                       pos=[0, 100], dtype=torch.float16)),
        ("D256 fp32 page64", dict(B=2, T=9, H=4, KV=2, D=256, page=64, P=16, n=4,
                                  pos=[60, 130], dtype=torch.float32)),
    ]
    for label, c in mt_cases:
        cq, ck, cv, cbt, cbase = make_case(**c, seed=4)
        mt_errs[label] = kernel_error(*MULTITOKEN, cq, ck[0], cv[0], cbt, cbase)
        check(mt_errs[label] <= TOL[c["dtype"]],
              f"multitoken {label}: max abs err {mt_errs[label]} > {TOL[c['dtype']]}")
    # T = 1: the multi-token kernel against the decode kernel, fp32 and bf16
    for dtype in (torch.float32, torch.bfloat16):
        cq, ck, cv, cbt, cbase = make_case(8, 16, 16, 64, 16, 128, 12, main_pos, dtype,
                                           inactive=(6, 7), seed=5, T=1)
        label = f"T1 {str(dtype).replace('torch.', '')}"
        mt_errs[label] = kernel_error(*MULTITOKEN, cq, ck[0], cv[0], cbt, cbase)
        dec = pda.paged_decode_attention(cq[:, 0].contiguous(), ck[0], cv[0], cbt, cbase)
        mt = pma.paged_multitoken_attention(cq, ck[0], cv[0], cbt, cbase)
        torch.cuda.synchronize()
        vs_dec = float((mt[:, 0].float() - dec.float()).abs().max())
        mt_errs[f"{label} vs decode kernel"] = vs_dec
        check(max(mt_errs[label], vs_dec) <= TOL[dtype],
              f"multitoken {label}: err {mt_errs[label]}, vs decode kernel {vs_dec}")
    for label, e in mt_errs.items():
        print(f"paged_multitoken_attention {label}: max abs err {e:.3e}")
    mt_lib_err = float((library_attention(mq, mk[0], mv[0], mbt, mbase[3]).float()
                        - pma.paged_multitoken_attention_ref(
                            mq.float(), mk[0].float(), mv[0].float(), mbt, mbase[3])
                        ).abs().max())
    check(mt_lib_err <= TOL[torch.bfloat16], f"multitoken library yardstick disagrees: {mt_lib_err}")
    # timed over the four chunk starts in turn (and the 24 layers), so each
    # number is the mean per call over the chunks of a 512-token prompt
    nb = len(mt_bases)
    mt_ms, mt_call_ms = time_ms(
        lambda i: pma.paged_multitoken_attention(mq, mk[i % L], mv[i % L], mbt, mbase[i % nb]),
        480)
    mt_plain_ms, mt_plain_call_ms = time_ms(
        lambda i: pma.paged_multitoken_attention_ref(mq, mk[i % L], mv[i % L], mbt,
                                                     mbase[i % nb]), 32)
    mt_lib_ms, mt_lib_call_ms = time_ms(
        lambda i: library_attention(mq, mk[i % L], mv[i % L], mbt, mbase[i % nb]), 32)
    bounds = [bound(mq, mk[0], mbt, bb) for bb in mbase]
    mt_bound_ms = sum(b[0] for b in bounds) / nb
    mt_bound_by = max(set(b[1] for b in bounds), key=[b[1] for b in bounds].count)
    print(f"paged_multitoken_attention main shape (mean over chunk starts {mt_bases}), device "
          f"ms per call: kernel {mt_ms:.4f}, plain {mt_plain_ms:.4f}, library {mt_lib_ms:.4f}, "
          f"bound {mt_bound_ms:.5f} ({mt_bound_by}; per start "
          + ", ".join(f"{b[0]:.5f} {b[1]}" for b in bounds)
          + f"), kernel at {mt_bound_ms / mt_ms:.3f} of bound")
    print(f"  per call with the host's launch path in the loop: kernel {mt_call_ms:.4f} ms, "
          f"plain {mt_plain_call_ms:.4f} ms, library {mt_lib_call_ms:.4f} ms")
    del mk, mv

    phase(3, "serve gpt2-medium bf16 (the main path)")
    cfg = gpt2.get_config("gpt2-medium")
    eng = dtt.init_inference(cfg, dtype=torch.bfloat16, seed=0)
    srv = eng.serve()
    reqs = mixed_requests(srv, 16, cfg.vocab_size, seed=1234)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pda.LAUNCHES = 0
    t0 = time.perf_counter()
    done = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pda.LAUNCHES
    st = srv.stats()
    check(len(done) == 16, f"{len(done)} of 16 requests completed")
    for req, budget in reqs:
        check(req.status == RequestStatus.FINISHED, f"request {req.id}: {req.status} {req.detail}")
        check(len(req.tokens) == budget, f"request {req.id}: {len(req.tokens)} of {budget} tokens")
        check(all(0 <= t < cfg.vocab_size for t in req.tokens), f"request {req.id}: token out of vocab")
    srv.check_no_leaks()
    steps = st["decode_steps"]
    check(steps > 0 and launches == cfg.n_layer * steps,
          f"kernel launches {launches} != n_layer {cfg.n_layer} x decode steps {steps}")
    print(f"requests {len(done)} finished, decode steps {steps}, kernel launches {launches} "
          f"(= {cfg.n_layer} x {steps}), wall {wall:.3f} s")
    print(f"decode tokens/s {st['decode_tokens_per_s']:.1f} (host clock over steps ending in "
          f"the token read), tokens/s end to end {st['tokens_per_s']:.1f}, "
          f"TTFT p50 {st['ttft']['p50_s'] * 1e3:.2f} ms, TPOT p50 {st['tpot']['p50_s'] * 1e3:.3f} ms, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del srv

    phase("3b", "serve gpt2-medium bf16 with speculation, the prefix cache and chunked "
                "prefill (the slice's path)")
    spec_k = FEATURES_SECTION["speculative"]["k"]
    srv = eng.serve(FEATURES_SECTION)
    reqs = shared_prefix_requests(srv, cfg.vocab_size, seed=4321, n_shared=8, n_cold=8,
                                  system_len=256, tails=(8, 128), cold_lens=(64, 512),
                                  budgets=(16, 64))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pda.LAUNCHES = 0
    pma.LAUNCHES = 0
    t0 = time.perf_counter()
    done = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dec_launches_3b, mt_launches = pda.LAUNCHES, pma.LAUNCHES
    st = srv.stats()
    check(len(done) == 16, f"{len(done)} of 16 requests completed")
    for req, budget in reqs:
        check(req.status == RequestStatus.FINISHED, f"request {req.id}: {req.status} {req.detail}")
        check(len(req.tokens) == budget, f"request {req.id}: {len(req.tokens)} of {budget} tokens")
        check(all(0 <= t < cfg.vocab_size for t in req.tokens), f"request {req.id}: token out of vocab")
    srv.check_no_leaks()
    released = srv.release_prefix_cache()
    srv.allocator.check_no_leaks()
    hits = st["prefix_hits_partial"] + st["prefix_hits_full"]
    check(hits > 0, f"no prefix hits: {st}")
    check(st["chunk_prefills"] > 0 and st["spec_steps"] > 0, f"no chunks or verify steps: {st}")
    check(mt_launches == cfg.n_layer * st["chunk_prefills"],
          f"multitoken launches {mt_launches} != n_layer {cfg.n_layer} x chunk-program calls "
          f"{st['chunk_prefills']}")
    check(dec_launches_3b == cfg.n_layer * (spec_k + 1) * st["spec_steps"],
          f"decode launches {dec_launches_3b} != {cfg.n_layer} x {spec_k + 1} x verify steps "
          f"{st['spec_steps']}")
    print(f"requests {len(done)} finished, prefix hits {hits} (full {st['prefix_hits_full']}, "
          f"partial {st['prefix_hits_partial']}, misses {st['prefix_misses']}, evictions "
          f"{st['prefix_evictions']}, {released} index pages released at the end), chunk-program "
          f"calls {st['chunk_prefills']}, verify steps {st['spec_steps']}, wall {wall:.3f} s")
    print(f"kernel launches: multitoken {mt_launches} (= {cfg.n_layer} x {st['chunk_prefills']}), "
          f"decode {dec_launches_3b} (= {cfg.n_layer} x {spec_k + 1} x {st['spec_steps']})")
    print(f"prefix hit rate {st['prefix_hit_rate']:.4f}, mean accept length "
          f"{st['spec_accept_len_mean']:.4f} tokens per slot-step, decode tokens/s "
          f"{st['decode_tokens_per_s']:.1f}, tokens/s end to end {st['tokens_per_s']:.1f}, "
          f"TTFT p50 {st['ttft']['p50_s'] * 1e3:.2f} ms, TPOT p50 {st['tpot']['p50_s'] * 1e3:.3f} ms, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del srv, eng

    phase(4, "fp32 streams: card against CPU, features on against off")
    cfg4 = gpt2.get_config("gpt2-medium", n_layer=4)
    tree = params_to_numpy(gpt2.init_params(
        cfg4, torch.Generator(device="cuda").manual_seed(7), "cuda", torch.float32))
    # 4 slots, so the second wave of the shared-prefix traffic finds the
    # first wave's prompt pages in the index
    feat_cfg = {"max_slots": 4, "max_prompt_len": 128, "prefill_chunk_tokens": 32,
                "prefix_cache": {"enabled": True}, "speculative": {"enabled": True, "k": 4}}
    runs = {  # name -> (serving section, the traffic)
        "default": (None, lambda s: mixed_requests(s, 8, cfg4.vocab_size, seed=99)),
        "features": (feat_cfg, lambda s: shared_prefix_requests(
            s, cfg4.vocab_size, seed=77, n_shared=4, n_cold=4, system_len=64,
            tails=(1, 64), cold_lens=(8, 128), budgets=(16, 64))),
    }
    # the features' traffic with the features off
    runs["features off"] = ({"max_slots": 4}, runs["features"][1])
    streams = {}
    for dev in ("cuda", "cpu"):
        e = dtt.init_inference(cfg4, params=params_from_numpy(tree, dev),
                               dtype=torch.float32, device=dev)
        for name, (section, traffic) in runs.items():
            if dev == "cpu" and name == "features off":
                continue
            s = e.serve(section, track_margins=True)
            rq = traffic(s)
            s.run()
            s.check_no_leaks()
            for req, budget in rq:
                check(req.status == RequestStatus.FINISHED and len(req.tokens) == budget,
                      f"{dev} {name} request {req.id}: {req.status}, "
                      f"{len(req.tokens)} of {budget}")
            if name == "features":
                st4 = s.stats()
                check(st4["prefix_hits_partial"] + st4["prefix_hits_full"] > 0
                      and st4["chunk_prefills"] > 0 and st4["spec_steps"] > 0,
                      f"{dev}: the features did not run: {st4}")
            streams[dev, name] = [r for r, _ in rq]
    compare_streams("default path, card vs CPU", streams["cuda", "default"],
                    streams["cpu", "default"])
    compare_streams("features on, card vs CPU", streams["cuda", "features"],
                    streams["cpu", "features"])
    compare_streams("card, features on vs off", streams["cuda", "features"],
                    streams["cuda", "features off"])

    phase(5, "summary")
    # launches: each kernel's count on the path of the slice that ported it
    # (the decode kernel: phase 3's default path; the multi-token kernel:
    # phase 3b's feature path)
    print(json.dumps({"kernels": [{
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/paged_decode_attention.cu",
        "replaces": "deepspeed_tpu/ops/pallas/decode_attention.py:185",
        "launches": launches,
        "max_abs_err": errs["main bf16 B8 H16 D64 page16"],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": lib_ms,
    }, {
        "name": "paged_multitoken_attention",
        "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/paged_multitoken_attention.cu",
        "replaces": "deepspeed_tpu/ops/pallas/decode_attention.py:317",
        "launches": mt_launches,
        "max_abs_err": mt_main_err,
        "ms": mt_ms,
        "plain_ms": mt_plain_ms,
        "bound_ms": mt_bound_ms,
        "bound_by": mt_bound_by,
        "library_ms": mt_lib_ms,
    }]}))
    # the run uses one card, whatever the machine holds
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
