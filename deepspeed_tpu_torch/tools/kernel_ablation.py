"""Where the redesigned attention kernels' time goes on the card: each
timed whole and with parts left out.

Usage, on a machine with one CUDA card, from the repository root:

    python -m deepspeed_tpu_torch.tools.kernel_ablation [--only bsparse_fwd,bsparse_bwd,multitoken]

Builds a patched copy of each kernel's source once per variant into
``deepspeed_tpu_torch/_build/ablation/`` and times it through the port's
wrapper, in turns over the variants, twice, by ``time_ms`` (CUDA events,
the host's enqueueing hidden). The variants other than "whole" and "no
turns" compute wrong outputs and exist only to be timed.

- ``bsparse_fwd`` (``csrc/block_sparse_attention_fwd.cu``): whole; without
  the exponentials (each ``ex2`` call replaced by its argument); without
  the two consumer warpgroups' turns on the tensor cores; without its O
  and lse stores; without its last product (O += P V); the producer only
  (the consumers release each stage as it lands: the pace of the loads);
  on the grouped plan (blocks of 16 and 32) each streamed tile loaded as
  one 64-row box, whole and producer only (wrong data, the same bytes:
  whether the count of TMA boxes sets the producer's pace).
- ``bsparse_bwd`` (``csrc/block_sparse_attention_bwd.cu``): dq and dk/dv
  whole; without the exponentials; without each kernel's last product
  (dK += dS^T Q in dk/dv, dQ += dS K in dq); without both; dq's producer
  only, dq's tiles one box each, and both (dk/dv whole in these three).
  Both block-sparse kernels at ``chip_smoke.py`` phase 10's GPT-2 shape (B2
  S4096 H16 D64 bf16, fixed unidirectional block 64), at B1 H4 (an eighth
  of its work: few items a block, so the time per step shows), and at its
  BERT shape (B16 S512 H16 D64 bf16, fixed bidirectional block 16: the
  grouped units).
- ``multitoken`` (``csrc/paged_multitoken_attention.cu``, its tensor-core
  route): whole; without its products (every ``mma.sync`` left out, with
  the fragment loads that feed them); without the merge of the split's
  chunks (the last block resets the counter and returns). At phase 3b's chunk shape (B1 T64 H16
  D64 bf16, page 16, a 36-page table), bf16 and int8 pools, for each
  chunk start of a 512-token prompt (0, 64, 256, 448).

Prints one JSON line of ms per call.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import torch

from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops import paged_multitoken_attention as pma
from deepspeed_tpu_torch.ops.sparse_attention import from_ds_config
from deepspeed_tpu_torch.tools.profile_training import GPT2_SPARSE_SECTION
from deepspeed_tpu_torch.tools.time_attention_kernels import time_ms

EXP = ('#include "block_sparse_attention_common.cuh"\n',
       '#include "block_sparse_attention_common.cuh"\n#ifdef ABLATE_EXP\n#define ex2(x) (x)\n'
       '#endif\n')
# the grouped forward's and dq's streamed K/V tiles each as one 64-row box
# (wrong data, the same bytes: whether the boxes' count holds the producer)
ONEBOX = ("            const bool run = tile_blocks<G>(t[q], kb);\n",
          "#ifdef ABLATE_ONEBOX\n            const bool run = (tile_blocks<G>(t[q], kb), true);\n"
          "#else\n            const bool run = tile_blocks<G>(t[q], kb);\n#endif\n")


def producer_only(item):
    """Code put before a consumer's first line: under ABLATE_PRODUCER it
    waits for each item's own rows and each step's stage and hands them
    straight back, then returns (``item`` is the tile count of item i)."""
    return ("#ifdef ABLATE_PRODUCER\n"
            "  for (int r = 0, ki = 0, it = 0; r * (int)gridDim.x < n_items; ++r) {\n"
            "    const int i = round_item(r, n_items);\n"
            "    if (i < 0) continue;\n"
            "    int n;\n"
            f"    if constexpr (G == 1) n = {item[0]}; else n = {item[1]};\n"
            "    mbar_wait(&q_full[ki % QB], (ki / QB) & 1);\n"
            "    for (int u = 0; u < (n + P - 1) / P; ++u, ++it) {\n"
            "      mbar_wait(&full[it % STAGES], (it / STAGES) & 1);\n"
            "      if (threadIdx.x % 128 == 0) mbar_arrive(&empty[it % STAGES]);\n"
            "    }\n"
            "    if (threadIdx.x % 128 == 0) mbar_arrive(&q_empty[ki % QB]);\n"
            "    ++ki;\n"
            "  }\n"
            "  return;\n"
            "#endif\n")
# per kernel: its source, (text in the source, its replacement) each
# guarded by a macro, and the variants' macros
KERNELS = {
    "bsparse_fwd": ("block_sparse_attention_fwd", {
        "ABLATE_EXP": EXP,
        "ABLATE_TURNS": ("__device__ __forceinline__ void turn_wait(int bar) { hopper::named_sync",
                         "#ifdef ABLATE_TURNS\n"
                         "__device__ __forceinline__ void turn_wait(int) {}\n"
                         "__device__ __forceinline__ void turn_pass(int) {}\n#else\n"
                         "__device__ __forceinline__ void turn_wait(int bar) { hopper::named_sync"),
        "ABLATE_TURNS_END": ("__device__ __forceinline__ void turn_pass(int bar) "
                             "{ hopper::named_arrive(bar, 256); }\n",
                             "__device__ __forceinline__ void turn_pass(int bar) "
                             "{ hopper::named_arrive(bar, 256); }\n#endif\n"),
        "ABLATE_STORE": ("    } else if (owned) {\n      // O through shared memory",
                         "#ifdef ABLATE_STORE\n    } else if (owned && inv[0] == -1.f) {\n#else\n"
                         "    } else if (owned) {\n#endif\n      // O through shared memory"),
        "ABLATE_STORE_WARP": ("      if (owned)\n        store_warp_rows<T, D>(&to,",
                              "#ifndef ABLATE_STORE\n      if (owned)\n#else\n"
                              "      if (owned && inv[0] == -1.f)\n#endif\n"
                              "        store_warp_rows<T, D>(&to,"),
        "ABLATE_STORE_LSE": ("      if (owned && t == 0)\n",
                             "#ifdef ABLATE_STORE\n      if (owned && t == 0 && inv[hr] == -1.f)\n"
                             "#else\n      if (owned && t == 0)\n#endif\n"),
        "ABLATE_LAST": ("  issue_rs<T, D, TN>(acc, pa, v_addr);\n",
                        "#ifndef ABLATE_LAST\n  issue_rs<T, D, TN>(acc, pa, v_addr);\n#endif\n"),
        "ABLATE_PRODUCER": ("  float m[2], l[2];\n",
                            producer_only(("fwd_item(i, plan, n_pairs, p).n",
                                           "fwd_group_item<G>(i, plan, n_pairs, p).n"))
                            + "  float m[2], l[2];\n"),
        "ABLATE_ONEBOX": ONEBOX,
    }, {
        "whole": [],
        "no exponentials": ["-DABLATE_EXP"],
        "no turns": ["-DABLATE_TURNS"],
        "no O/lse stores": ["-DABLATE_STORE"],
        "no last product": ["-DABLATE_LAST"],
        "producer only": ["-DABLATE_PRODUCER"],
        "one box a tile": ["-DABLATE_ONEBOX"],
        "producer only, one box a tile": ["-DABLATE_PRODUCER", "-DABLATE_ONEBOX"],
    }),
    "bsparse_bwd": ("block_sparse_attention_bwd", {
        "ABLATE_EXP": EXP,
        "ABLATE_LAST_DKV": ("      issue_rs<T, D, TN>(dka, da, q_addr);\n",
                            "#ifndef ABLATE_LAST\n      issue_rs<T, D, TN>(dka, da, q_addr);\n"
                            "#endif\n"),
        "ABLATE_LAST_DQ": ("      issue_rs<T, D, TN>(dqa, da, k_addr);\n",
                           "#ifndef ABLATE_LAST\n      issue_rs<T, D, TN>(dqa, da, k_addr);\n"
                           "#endif\n"),
        "ABLATE_PRODUCER": ("  float dqa[D / 2];\n",
                            producer_only(("plan_item(i, plan, n_pairs, p).n",
                                           "group_item<G>(i, plan, n_pairs, p).n"))
                            + "  float dqa[D / 2];\n"),
        "ABLATE_ONEBOX": ONEBOX,
    }, {
        "whole": [],
        "no exponentials": ["-DABLATE_EXP"],
        "no last product": ["-DABLATE_LAST"],
        "no exponentials, no last product": ["-DABLATE_EXP", "-DABLATE_LAST"],
        "dq producer only": ["-DABLATE_PRODUCER"],
        "dq one box a tile": ["-DABLATE_ONEBOX"],
        "dq producer only, one box a tile": ["-DABLATE_PRODUCER", "-DABLATE_ONEBOX"],
    }),
    "multitoken": ("paged_multitoken_attention", {
        "ABLATE_PRODUCTS": ("// ---- the tensor-core route ---",
                            "#ifdef ABLATE_PRODUCTS\ntemplate <typename T>\n__device__ "
                            "__forceinline__ void skip_mma(float*, const uint32_t*, "
                            "const uint32_t*) {}\n#define mma16816 skip_mma\n#endif\n"
                            "// ---- the tensor-core route ---"),
        "ABLATE_MERGE": ("  if (tid == 0) a.counters[u] = 0;\n",
                         "  if (tid == 0) a.counters[u] = 0;\n#ifdef ABLATE_MERGE\n  return;\n"
                         "#endif\n"),
    }, {
        "whole": [],
        "no products": ["-DABLATE_PRODUCTS"],
        "no merge": ["-DABLATE_MERGE"],
    }),
}
# (B, S, H, sparse_attention section, causal): GPT-2's, and BERT's default
SHAPES = [(2, 4096, 16, GPT2_SPARSE_SECTION, True), (1, 4096, 4, GPT2_SPARSE_SECTION, True),
          (16, 512, 16, {"mode": "fixed"}, False)]
MT_BASES = [0, 64, 256, 448]


def patched_source(name: str, patches: dict) -> str:
    src = (op_builder.CSRC_DIR / f"{name}.cu").read_text()
    for macro, (text, repl) in patches.items():
        if src.count(text) != 1:
            raise RuntimeError(f"{macro}: {text!r} found {src.count(text)} times")
        src = src.replace(text, repl)
    return src


def build_variants(which: str) -> dict:
    name, patches, variants = KERNELS[which]
    out_dir = op_builder.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / f"{name}_ablation.cu"
    src.write_text(patched_source(name, patches))
    procs = {}
    for variant, flags in variants.items():
        tag = variant.replace(" ", "_").replace(",", "").replace("/", "")
        lib = out_dir / f"lib{which}_{tag}.so"
        cmd = [op_builder.nvcc_path(), *op_builder.NVCC_FLAGS, *flags,
               "-I", str(op_builder.CSRC_DIR), "-o", str(lib), str(src)]
        procs[variant] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for variant, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {which} {variant} variant:\n{log}")
        handle = ctypes.CDLL(str(lib))
        for fn, (argtypes, restype) in op_builder.SIGNATURES[name].items():
            getattr(handle, fn).argtypes = argtypes
            getattr(handle, fn).restype = restype
        libs[variant] = handle
    return libs


def bsparse_cases():
    """(label, call) of the block-sparse kernels at the three shapes."""
    D = 64
    for B, S, H, section, c in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(0)
        qkv = torch.randn(B, S, 3 * H * D, generator=g, device="cuda").bfloat16()
        q, k, v = (t.unflatten(-1, (H, D)) for t in qkv.split(H * D, dim=-1))
        do = (torch.randn(B, S, H, D, generator=g, device="cuda") * 0.1).bfloat16()
        lists = bsa.index_lists(from_ds_config(section, H), S, "cuda")
        o, lse = bsa.block_sparse_attention_fwd(q, k, v, lists, c)
        delta = bsa.block_sparse_delta(o, do)
        tag = f"B{B} S{S} H{H} blk{lists.block}"
        yield {"bsparse_fwd": [(f"{tag} fwd",
                                lambda i: bsa.block_sparse_attention_fwd(q, k, v, lists, c))],
               "bsparse_bwd": [(f"{tag} dq",
                                lambda i: bsa.block_sparse_attention_dq(q, k, v, do, lse, delta,
                                                                        lists, c)),
                               (f"{tag} dkv",
                                lambda i: bsa.block_sparse_attention_dkv(q, k, v, do, lse, delta,
                                                                         lists, c))]}


def multitoken_cases():
    """(label, call) of the multi-token kernel at 3b's chunk shape, each
    chunk start, bf16 and int8 pools."""
    g = torch.Generator(device="cuda").manual_seed(23)
    q = torch.randn(1, 64, 16, 64, generator=g, device="cuda").bfloat16()
    bt = torch.randperm(511, generator=g, device="cuda")[:36].add(1).reshape(1, 36).int()
    k = torch.randn(512, 16, 16, 64, generator=g, device="cuda").bfloat16()
    v = torch.randn(512, 16, 16, 64, generator=g, device="cuda").bfloat16()
    kq = torch.randint(-127, 128, k.shape, generator=g, device="cuda").to(torch.int8)
    vq = torch.randint(-127, 128, k.shape, generator=g, device="cuda").to(torch.int8)
    sc = torch.rand(512, 16, 2, generator=g, device="cuda") * 0.02
    cases = []
    for b0 in MT_BASES:
        base = torch.tensor([b0], dtype=torch.int32, device="cuda")
        cases.append((f"multitoken bf16 base {b0}",
                      lambda i, base=base: pma.paged_multitoken_attention(q, k, v, bt, base)))
        cases.append((f"multitoken int8 base {b0}",
                      lambda i, base=base: pma.paged_multitoken_attention(q, kq, vq, bt, base,
                                                                          scales=sc)))
    yield {"multitoken": cases}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="bsparse_fwd,bsparse_bwd,multitoken",
                    help="comma-separated: " + ", ".join(KERNELS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ablation: no CUDA device; the times are the card's", file=sys.stderr)
        return 1
    kernels = [w for w in KERNELS if w in args.only.split(",")]
    libs = {w: build_variants(w) for w in kernels}
    times = {}
    groups = []
    if any(w.startswith("bsparse") for w in kernels):
        groups.append(bsparse_cases())
    if "multitoken" in kernels:
        groups.append(multitoken_cases())
    for gen in groups:
        for cases in gen:
            for _ in range(2):
                for which in kernels:
                    if which not in cases:
                        continue
                    name = KERNELS[which][0]
                    for variant, lib in libs[which].items():
                        op_builder._LIBS[name] = lib
                        for label, fn in cases[which]:
                            times.setdefault(f"{label} {variant}", []).append(time_ms(fn, 40)[0])
                    op_builder._LIBS.pop(name, None)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
