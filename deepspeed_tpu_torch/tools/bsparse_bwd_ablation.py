"""Where the block-sparse backward's time goes on the card: its TMA + wgmma
dq and dk/dv kernels timed whole and with parts left out.

Usage, on a machine with one CUDA card, from the repository root:

    python -m deepspeed_tpu_torch.tools.bsparse_bwd_ablation

Builds ``csrc/block_sparse_attention_bwd.cu`` once per variant into
``deepspeed_tpu_torch/_build/ablation/``: whole; without the exponentials
(each ``ex2`` call replaced by its argument); without each kernel's last
product (dK += dS^T Q in dk/dv, dQ += dS K in dq); and without both. The
variants compute wrong outputs and exist only to be timed. Each runs
through ``ops.block_sparse_attention.block_sparse_attention_dq`` / ``_dkv``
at ``chip_smoke.py`` phase 10's GPT-2 shape (B2 S4096 H16 D64 bf16, fixed
unidirectional block 64) and at B1 H4 (an eighth of its work: few items a
block, so the time per step shows), in turns over the variants, twice, by
``time_ms`` (CUDA events, the host's enqueueing hidden). Prints one JSON
line of ms per call.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.sparse_attention import from_ds_config
from deepspeed_tpu_torch.tools.profile_training import GPT2_SPARSE_SECTION
from deepspeed_tpu_torch.tools.time_attention_kernels import time_ms

NAME = "block_sparse_attention_bwd"
# (text in the source, its replacement): each guarded by a macro
PATCHES = {
    "ABLATE_EXP": ('#include "hopper.cuh"\n',
                   '#include "hopper.cuh"\n#ifdef ABLATE_EXP\n#define ex2(x) (x)\n#endif\n'),
    "ABLATE_LAST_DKV": ("      issue_rs<T, D, TN>(dka, da, q_addr);\n",
                        "#ifndef ABLATE_LAST\n      issue_rs<T, D, TN>(dka, da, q_addr);\n"
                        "#endif\n"),
    "ABLATE_LAST_DQ": ("      issue_rs<T, D, TN>(dqa, da, k_addr);\n",
                       "#ifndef ABLATE_LAST\n      issue_rs<T, D, TN>(dqa, da, k_addr);\n"
                       "#endif\n"),
}
VARIANTS = {
    "whole": [],
    "no exponentials": ["-DABLATE_EXP"],
    "no last product": ["-DABLATE_LAST"],
    "no exponentials, no last product": ["-DABLATE_EXP", "-DABLATE_LAST"],
}
SHAPES = [(2, 4096, 16), (1, 4096, 4)]


def patched_source() -> str:
    src = (op_builder.CSRC_DIR / f"{NAME}.cu").read_text()
    for name, (text, repl) in PATCHES.items():
        if src.count(text) != 1:
            raise RuntimeError(f"{name}: {text!r} found {src.count(text)} times")
        src = src.replace(text, repl)
    return src


def build_variants() -> dict:
    out_dir = op_builder.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / f"{NAME}_ablation.cu"
    src.write_text(patched_source())
    procs = {}
    for name, flags in VARIANTS.items():
        lib = out_dir / f"libbsbwd_{name.replace(' ', '_').replace(',', '')}.so"
        cmd = [op_builder.nvcc_path(), *op_builder.NVCC_FLAGS, *flags,
               "-I", str(op_builder.CSRC_DIR), "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} variant:\n{log}")
        handle = ctypes.CDLL(str(lib))
        for fn, (argtypes, restype) in op_builder.SIGNATURES[NAME].items():
            getattr(handle, fn).argtypes = argtypes
            getattr(handle, fn).restype = restype
        libs[name] = handle
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("bsparse_bwd_ablation: no CUDA device; the times are the card's", file=sys.stderr)
        return 1
    libs = build_variants()
    times = {}
    D = 64
    for B, S, H in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(0)
        qkv = torch.randn(B, S, 3 * H * D, generator=g, device="cuda").bfloat16()
        q, k, v = (t.unflatten(-1, (H, D)) for t in qkv.split(H * D, dim=-1))
        do = (torch.randn(B, S, H, D, generator=g, device="cuda") * 0.1).bfloat16()
        lists = bsa.index_lists(from_ds_config(GPT2_SPARSE_SECTION, H), S, "cuda")
        o, lse = bsa.block_sparse_attention_fwd(q, k, v, lists, True)
        delta = bsa.block_sparse_delta(o, do)
        for _ in range(2):
            for name, lib in libs.items():
                op_builder._LIBS[NAME] = lib
                for which, fn in (
                        ("dq", lambda i: bsa.block_sparse_attention_dq(q, k, v, do, lse, delta,
                                                                       lists, True)),
                        ("dkv", lambda i: bsa.block_sparse_attention_dkv(q, k, v, do, lse, delta,
                                                                         lists, True))):
                    times.setdefault(f"B{B} S{S} H{H} {which} {name}", []).append(
                        time_ms(fn, 40)[0])
        del q, k, v, do, o, lse, delta, qkv
    op_builder._LIBS.pop(NAME, None)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
