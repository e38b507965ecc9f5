"""Device time of the port's attention kernels and its threefry kernel at
the shapes of its paths, for comparing two trees of this package on one
card: the contiguous decode
kernel (offline ``generate``), the paged decode kernel in both modes
(serving's decode and verify), the paged multi-token kernel in both modes
(serving's chunk program: ``chip_smoke.py`` phase 3b's and 3c's chunk
shape, the mean over the chunk starts of a 512-token prompt, and one
longer chunk over a longer cache), the flash-attention forward and
backward (GPT-2 and BERT training), the block-sparse forward, dq and
dk/dv at ``chip_smoke.py`` phase 10's two main shapes (GPT-2 sparse and
BERT sparse training) and seven more, and the threefry kernel's dropout and
uniform_rows at ``chip_smoke.py`` phase 16's shapes.

Usage, on a machine with one CUDA card:

    PYTHONPATH=<tree> python <this tree>/deepspeed_tpu_torch/tools/time_attention_kernels.py
        [--label NAME] [--library]
        [--only decode,paged,multitoken,multitoken_int8,flash_fwd,flash_bwd,
                bsparse_fwd,bsparse_dq,bsparse_dkv,dropout,uniform_rows]

Run as a file (not with ``-m``), so that ``deepspeed_tpu_torch`` is imported
from ``<tree>``: an unpacked older commit times that commit's kernels through
the same public wrappers (``ops.decode_attention.decode_attention``,
``ops.paged_decode_attention.paged_decode_attention``,
``ops.paged_multitoken_attention.paged_multitoken_attention``,
``ops.flash_attention.flash_attention_fwd`` / ``flash_attention_bwd``,
``ops.block_sparse_attention.block_sparse_attention_fwd`` / ``_dq`` /
``_dkv`` over ``index_lists``, ``ops.prng.dropout_kernel`` /
``uniform_rows_kernel``), which build its own sources into its own
``_build/``. Alternate the trees
within one call (older, newer, newer, older): calls and cards differ by
several percent. Prints one JSON line: ms per call (device time, CUDA
events, the host's enqueueing hidden behind a device-side sleep) for each
case, ``--library`` adds one PyTorch call on the same inputs (SDPA; for the
paged kernels a page gather and SDPA, with the position mask for the
multi-token kernel; for the block-sparse kernels SDPA
with the layout's dense boolean mask; for a backward SDPA's
forward+backward for the same grads minus its forward; ``F.dropout`` and
``torch.rand``, other streams of bits, for the threefry kernel). Inputs come from a seeded generator on
the card. The time function is the one ``chip_smoke.py`` uses.
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
# (a layer's slice of a 24-layer cache, over positions its steps pass), and
# a long cache at its last row and early in a generation (the kernel plans
# its chunks from Smax; a tree from before device pos planned them from pos)
DECODE_CASES = [
    ("decode B8 Smax256 H16 D64 bf16", 8, 256, 16, 16, 64, 24, [128, 160, 192, 224, 254]),
    ("decode B2 Smax4096 H16 D64 bf16 pos 4095", 2, 4096, 16, 16, 64, 4, [4095]),
    ("decode B2 Smax4096 H16 D64 bf16 pos 100", 2, 4096, 16, 16, 64, 4, [100]),
]
# (label, B, H, KV, D, page, pool pages, table pages, pos, int8): phase 2's
# decode shape (bf16, two slots inactive on scratch), 3c's verify shape
# (int8, pos 256..575), and a long cache at its last row; 24 layers of
# pools, walked in turn, as the decode step does
PAGED_CASES = [
    ("paged bf16 B8 H16 D64 page16 12 pages pos<=191", 8, 16, 16, 64, 16, 512, 12,
     [0, 15, 16, 17, 100, 191, 0, 0], False),
    ("paged int8 B8 H16 D64 page16 36 pages pos 256..575", 8, 16, 16, 64, 16, 512, 36,
     [256, 271, 300, 383, 384, 575, 0, 0], True),
    ("paged bf16 B2 H16 D64 256 pages of 16 pos 4095", 2, 16, 16, 64, 16, 520, 256,
     [4095, 4095], False),
    ("paged int8 B2 H16 D64 256 pages of 16 pos 4095", 2, 16, 16, 64, 16, 520, 256,
     [4095, 4095], True),
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
    # pos as the kernel reads it: an int32 [1] tensor on the card (a tree
    # older than that takes a Python int)
    pos = [torch.full((1,), p, dtype=torch.int32, device="cuda") for p in positions]
    try:
        tda.decode_attention(q, k[0], v[0], pos[0])
    except TypeError:
        pos = positions
    out = {label: time_ms(lambda i: tda.decode_attention(q, k[i % L], v[i % L],
                                                         pos[i % n]), 480)[0]}
    if library:
        def lib(i):
            p = positions[i % n]
            return F.scaled_dot_product_attention(
                q[:, :, None], k[i % L][:, : p + 1].transpose(1, 2),
                v[i % L][:, : p + 1].transpose(1, 2))
        out[label + " library"] = time_ms(lib, 96)[0]
    return out


def time_paged(case, library):
    from deepspeed_tpu_torch.ops import paged_decode_attention as pda

    label, B, H, KV, D, page, P, n, pos, int8 = case
    L = 24 if P * n < 20000 else 4
    g = torch.Generator(device="cuda").manual_seed(21)
    q = torch.randn(B, H, D, generator=g, device="cuda").to(torch.bfloat16)
    rs = torch.randperm(P - 1, generator=g, device="cuda")[: B * n].add(1)
    bt = rs.reshape(B, n).int()
    for b, p in enumerate(pos):
        if p == 0 and b >= B - 2 and B > 2:
            bt[b] = 0  # an inactive slot on the scratch page
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    shape = (L, P, KV, page, D)
    if int8:
        k = torch.randint(-127, 128, shape, generator=g, device="cuda").to(torch.int8)
        v = torch.randint(-127, 128, shape, generator=g, device="cuda").to(torch.int8)
        sc = torch.rand(L, P, KV, 2, generator=g, device="cuda") * 0.02
        fn = lambda i: pda.paged_decode_attention(q, k[i % L], v[i % L], bt, pos_t,  # noqa: E731
                                                  scales=sc[i % L])
    else:
        k = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
        v = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
        fn = lambda i: pda.paged_decode_attention(q, k[i % L], v[i % L], bt, pos_t)  # noqa: E731
    out = {label: time_ms(fn, 480)[0]}
    if library:
        def lib(i):
            kd, vd = k[i % L][bt.long()], v[i % L][bt.long()]  # [B, n, KV, page, D]
            if int8:
                s = sc[i % L][bt.long()]
                kd, vd = kd.float() * s[..., 0, None, None], vd.float() * s[..., 1, None, None]
            kd = kd.to(q.dtype).transpose(2, 3).reshape(B, -1, KV, D).transpose(1, 2)
            vd = vd.to(q.dtype).transpose(2, 3).reshape(B, -1, KV, D).transpose(1, 2)
            mask = torch.arange(kd.shape[2], device="cuda")[None, :] <= pos_t.long()[:, None]
            return F.scaled_dot_product_attention(q[:, :, None], kd, vd,
                                                  attn_mask=mask[:, None, None])
        out[label + " library"] = time_ms(lib, 48)[0]
    return out


# (label, B, T, H, KV, D, page, pool pages, table pages, chunk starts,
# layers): 3b's and 3c's chunk program (a 64-token chunk of a 512-token
# prompt against the 36-page table of a 512 + 64-token reservation, 24
# layers of pools walked in turn, the mean over the chunk starts) and one
# longer, flop-heavier chunk (512 tokens at 1536 against a 2048-row table)
MULTITOKEN_CASES = [
    ("multitoken B1 T64 H16 D64 page16 36 pages, bases 0/64/256/448", 1, 64, 16, 16, 64, 16,
     512, 36, [0, 64, 256, 448], 24),
    ("multitoken B1 T512 H16 D64 page16 128 pages, base 1536", 1, 512, 16, 16, 64, 16, 130,
     128, [1536], 4),
]


def time_multitoken(case, library, int8):
    from deepspeed_tpu_torch.ops import paged_multitoken_attention as pma

    label, B, T, H, KV, D, page, P, n, bases, L = case
    label = label.replace("multitoken", "multitoken int8" if int8 else "multitoken bf16")
    g = torch.Generator(device="cuda").manual_seed(23)
    q = torch.randn(B, T, H, D, generator=g, device="cuda").to(torch.bfloat16)
    bt = torch.randperm(P - 1, generator=g, device="cuda")[: B * n].add(1).reshape(B, n).int()
    base_t = [torch.tensor([b0] * B, dtype=torch.int32, device="cuda") for b0 in bases]
    nb = len(bases)
    shape = (L, P, KV, page, D)
    if int8:
        k = torch.randint(-127, 128, shape, generator=g, device="cuda").to(torch.int8)
        v = torch.randint(-127, 128, shape, generator=g, device="cuda").to(torch.int8)
        sc = torch.rand(L, P, KV, 2, generator=g, device="cuda") * 0.02
    else:
        k = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
        v = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
        sc = None
    kw = (lambda i: {"scales": sc[i % L]}) if int8 else (lambda i: {})
    out = {label: time_ms(lambda i: pma.paged_multitoken_attention(
        q, k[i % L], v[i % L], bt, base_t[i % nb], **kw(i)), 480 if T <= 64 else 60)[0]}
    if library:
        def lib(i):
            kd, vd = k[i % L][bt.long()], v[i % L][bt.long()]  # [B, n, KV, page, D]
            if int8:
                s = sc[i % L][bt.long()]
                kd, vd = kd.float() * s[..., 0, None, None], vd.float() * s[..., 1, None, None]
            kd = kd.to(q.dtype).transpose(2, 3).reshape(B, -1, KV, D).transpose(1, 2)
            vd = vd.to(q.dtype).transpose(2, 3).reshape(B, -1, KV, D).transpose(1, 2)
            mask = (torch.arange(kd.shape[2], device="cuda")[None, None, :]
                    <= base_t[i % nb].long()[:, None, None]
                    + torch.arange(T, device="cuda")[None, :, None])
            return F.scaled_dot_product_attention(q.transpose(1, 2), kd, vd,
                                                  attn_mask=mask[:, None])
        out[label + " library"] = time_ms(lib, 48 if T <= 64 else 12)[0]
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


# (label, B, S, H, KV, D, causal): training's shape, D128, BERT's S128
# (non-causal too), one long sequence
FLASH_BWD_CASES = [
    ("flash bwd B8 S1024 H16 D64 bf16 causal", 8, 1024, 16, 16, 64, True),
    ("flash bwd B2 S1024 H8 D128 bf16 causal", 2, 1024, 8, 8, 128, True),
    ("flash bwd B8 S128 H16 D64 bf16 causal", 8, 128, 16, 16, 64, True),
    ("flash bwd B8 S128 H16 D64 bf16 non-causal", 8, 128, 16, 16, 64, False),
    ("flash bwd B1 S8192 H4 D64 bf16 causal", 1, 8192, 4, 4, 64, True),
]


def time_flash_bwd(case, library):
    from deepspeed_tpu_torch.ops import flash_attention as fa

    label, B, S, H, KV, D, causal = case
    g = torch.Generator(device="cuda").manual_seed(10)
    q, k, v = (torch.randn(B, S, h, D, generator=g, device="cuda").to(torch.bfloat16)
               for h in (H, KV, KV))
    do = (torch.randn(B, S, H, D, generator=g, device="cuda") * 0.1).to(torch.bfloat16)
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    out = {label: time_ms(lambda i: fa.flash_attention_bwd(q, k, v, o, lse, do, causal), 30)[0]}
    if library:
        leaves = [x.detach().transpose(1, 2).requires_grad_(True) for x in (q, k, v)]
        dot = do.transpose(1, 2)

        def fb(_):
            o_l = F.scaled_dot_product_attention(*leaves, is_causal=causal)
            return torch.autograd.grad(o_l, leaves, dot)

        fwd = time_ms(lambda i: F.scaled_dot_product_attention(*leaves, is_causal=causal), 30)[0]
        out[label + " library"] = time_ms(fb, 30)[0] - fwd
    return out


# (label, B, S, H, D, sparse_attention section, causal): chip_smoke.py
# phase 10's main shapes, GPT-2's section (phase 11) and BERT's default
# Fixed layout (phase 12), then shapes off those paths that the wgmma
# kernels also take (D128 with blocks of 128; per-head random layouts;
# dk/dv's grouped units at blocks of 16 and 32 with lists that rarely
# repeat)
BSPARSE_CASES = [
    ("GPT-2 bf16 B2 S4096 H16 D64 fixed-uni blk64", 2, 4096, 16, 64,
     {"mode": "fixed", "block": 64, "num_local_blocks": 4, "num_global_blocks": 1,
      "attention": "unidirectional"}, True),
    ("BERT bf16 B16 S512 H16 D64 fixed-bi blk16", 16, 512, 16, 64, {"mode": "fixed"}, False),
    ("bf16 B2 S2048 H16 D128 bslongformer-uni blk128", 2, 2048, 16, 128,
     {"mode": "bslongformer", "block": 128, "attention": "unidirectional"}, True),
    ("bf16 B4 S2048 H16 D64 bigbird-bi blk64", 4, 2048, 16, 64,
     {"mode": "bigbird", "block": 64, "different_layout_per_head": True,
      "num_random_blocks": 2}, False),
    ("bf16 B16 S512 H16 D64 bigbird-bi blk16", 16, 512, 16, 64,
     {"mode": "bigbird", "block": 16, "different_layout_per_head": True,
      "num_random_blocks": 2}, False),
    ("bf16 B8 S1024 H16 D64 variable-bi blk32", 8, 1024, 16, 64,
     {"mode": "variable", "block": 32, "num_random_blocks": 1,
      "local_window_blocks": [2, 4], "global_block_indices": [0, 5]}, False),
    # chip_smoke.py phase 10's smaller block-16/32 cases, in bf16
    ("bf16 B2 S1024 H4 D64 fixed-uni blk16", 2, 1024, 4, 64,
     {"mode": "fixed", "block": 16, "num_local_blocks": 4, "attention": "unidirectional"}, True),
    ("bf16 B2 S1024 H8 D64 bigbird-bi blk32", 2, 1024, 8, 64,
     {"mode": "bigbird", "block": 32, "different_layout_per_head": True,
      "num_random_blocks": 2}, False),
    ("bf16 B4 S128 H4 D128 bigbird-uni blk16", 4, 128, 4, 128,
     {"mode": "bigbird", "block": 16, "different_layout_per_head": True,
      "num_random_blocks": 2, "attention": "unidirectional"}, True),
]


def time_threefry(which, library):
    """The threefry kernel at phase 16's main shapes: dropout of [8, 1024,
    1024] bf16 at rate 0.1, uniform_rows at R16 x 50257 and R1 x 8 x 50257
    over [tiny, 1)."""
    from deepspeed_tpu_torch.ops import prng

    out = {}
    key = prng.fold_in(prng.PRNGKey(1), 16)
    if which == "dropout":
        g = torch.Generator(device="cuda").manual_seed(16)
        x = torch.randn(8, 1024, 1024, generator=g, device="cuda").to(torch.bfloat16)
        out["dropout bf16 [8, 1024, 1024] rate 0.1"] = time_ms(
            lambda i: prng.dropout_kernel(x, key, 0.1), 50)[0]
        if library:
            out["dropout bf16 [8, 1024, 1024] rate 0.1 library"] = time_ms(
                lambda i: F.dropout(x, 0.1, training=True), 50)[0]
        return out
    tiny = float(torch.finfo(torch.float32).tiny)
    for R, n in ((16, 50257), (1, 8 * 50257)):
        keys = prng.split(prng.PRNGKey(R), R)
        name = f"uniform_rows R{R} x {n}"
        out[name] = time_ms(lambda i: prng.uniform_rows_kernel(keys, n, tiny, 1.0, "cuda"), 50)[0]
        if library:
            out[name + " library"] = time_ms(lambda i: torch.rand(R, n, device="cuda"), 50)[0]
    return out


def time_bsparse(case, library, which):
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops.sparse_attention import from_ds_config

    label, B, S, H, D, section, causal = case
    lists = bsa.index_lists(from_ds_config(section, H), S, "cuda")
    g = torch.Generator(device="cuda").manual_seed(40)
    qkv = torch.randn(B, S, 3 * H * D, generator=g, device="cuda").to(torch.bfloat16)
    q, k, v = (t.unflatten(-1, (H, D)) for t in qkv.split(H * D, dim=-1))
    do = (torch.randn(B, S, H, D, generator=g, device="cuda") * 0.1).to(torch.bfloat16)
    o, lse = bsa.block_sparse_attention_fwd(q, k, v, lists, causal)
    delta = bsa.block_sparse_delta(o, do)
    fn = {"fwd": lambda i: bsa.block_sparse_attention_fwd(q, k, v, lists, causal),
          "dq": lambda i: bsa.block_sparse_attention_dq(q, k, v, do, lse, delta, lists, causal),
          "dkv": lambda i: bsa.block_sparse_attention_dkv(q, k, v, do, lse, delta, lists,
                                                          causal)}[which]
    name = f"bsparse {which} {label}"
    out = {name: time_ms(fn, 40)[0]}
    if library:
        keep = lists.dense_mask("cuda")
        if causal:
            keep = keep & torch.ones(S, S, dtype=torch.bool, device="cuda").tril()
        leaves = [x.detach().transpose(1, 2).requires_grad_(True) for x in (q, k, v)]
        fwd = time_ms(lambda i: F.scaled_dot_product_attention(*leaves, attn_mask=keep[None]),
                      20)[0]
        if which == "fwd":
            out[name + " library"] = fwd
        else:
            wrt = leaves[:1] if which == "dq" else leaves[1:]
            dot = do.transpose(1, 2)

            def fb(_):
                o_l = F.scaled_dot_product_attention(*leaves, attn_mask=keep[None])
                return torch.autograd.grad(o_l, wrt, dot)

            out[name + " library"] = time_ms(fb, 10)[0] - fwd
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="tree")
    ap.add_argument("--library", action="store_true", help="also time SDPA on the same inputs")
    ap.add_argument("--only", default="decode,paged,flash_fwd,flash_bwd",
                    help="comma-separated kernels to time")
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    if not torch.cuda.is_available():
        print("time_attention_kernels: no CUDA device; the times are the card's", file=sys.stderr)
        return 1
    import deepspeed_tpu_torch

    times = {}
    for name, cases, fn in (("decode", DECODE_CASES, time_decode),
                            ("paged", PAGED_CASES, time_paged),
                            ("multitoken", MULTITOKEN_CASES,
                             lambda case, lib: time_multitoken(case, lib, False)),
                            ("multitoken_int8", MULTITOKEN_CASES,
                             lambda case, lib: time_multitoken(case, lib, True)),
                            ("flash_fwd", FLASH_CASES, time_flash),
                            ("flash_bwd", FLASH_BWD_CASES, time_flash_bwd),
                            *((f"bsparse_{w}", BSPARSE_CASES,
                               lambda case, lib, w=w: time_bsparse(case, lib, w))
                              for w in ("fwd", "dq", "dkv")),
                            *((w, (w,), time_threefry) for w in ("dropout", "uniform_rows"))):
        if name not in only:
            continue
        for case in cases:
            times.update(fn(case, args.library))
            torch.cuda.empty_cache()
    print(json.dumps({"label": args.label, "package": deepspeed_tpu_torch.__file__,
                      "device": torch.cuda.get_device_name(0), "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
