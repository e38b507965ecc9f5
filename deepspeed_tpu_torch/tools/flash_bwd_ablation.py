"""Where the flash-attention backward's time goes on the card: its kernels
timed whole and with parts left out.

Usage, on a machine with one CUDA card, from the repository root:

    python -m deepspeed_tpu_torch.tools.flash_bwd_ablation

Builds ``csrc/flash_attention_bwd.cu`` three times into
``deepspeed_tpu_torch/_build/ablation/``: whole; without the exponentials
(each ``ex2`` call of the kernels replaced by its argument); without each
kernel's last product (dK += dS^T Q in dk/dv, dQ += dS K in dq). The
variants compute wrong outputs and exist only to be timed. Each is run through
``ops.flash_attention.flash_attention_bwd`` at the training shape (B8 S1024
H16 D64 bf16 causal) and D128 B2 S1024 H8, in turns over the variants,
twice: the call by ``time_ms`` (CUDA events, the host's enqueueing hidden)
and each of its three kernels by ``torch.profiler`` (device time per
launch over 20 calls). Prints one JSON line of ms per call.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.tools.time_attention_kernels import time_ms

# (text in the source, its replacement): each guarded by a macro
PATCHES = {
    "ABLATE_EXP": ('#include "hopper.cuh"\n',
                   '#include "hopper.cuh"\n#ifdef ABLATE_EXP\n#define ex2(x) (x)\n#endif\n'),
    "ABLATE_LAST_DKV": ("      issue_rs<T, D, C::BQ>(dka, da, q_addr);\n",
                        "#ifndef ABLATE_LAST\n      issue_rs<T, D, C::BQ>(dka, da, q_addr);\n"
                        "#endif\n"),
    "ABLATE_LAST_DQ": ("      issue_rs<T, D, C::BK>(dqa, da, k_addr);\n",
                       "#ifndef ABLATE_LAST\n      issue_rs<T, D, C::BK>(dqa, da, k_addr);\n"
                       "#endif\n"),
}
VARIANTS = {
    "whole": [],
    "no exponentials": ["-DABLATE_EXP"],
    "no last product": ["-DABLATE_LAST"],
}
SHAPES = [(8, 1024, 16, 64), (2, 1024, 8, 128)]


def patched_source() -> str:
    src = (op_builder.CSRC_DIR / "flash_attention_bwd.cu").read_text()
    for name, (text, repl) in PATCHES.items():
        if src.count(text) != 1:
            raise RuntimeError(f"{name}: {text!r} found {src.count(text)} times")
        src = src.replace(text, repl)
    return src


def build_variants() -> dict:
    out_dir = op_builder.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "flash_attention_bwd_ablation.cu"
    src.write_text(patched_source())
    procs = {}
    for name, flags in VARIANTS.items():
        lib = out_dir / f"libbwd_{name.replace(' ', '_')}.so"
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
        for fn, (argtypes, restype) in op_builder.SIGNATURES["flash_attention_bwd"].items():
            getattr(handle, fn).argtypes = argtypes
            getattr(handle, fn).restype = restype
        libs[name] = handle
    return libs


def kernel_ms(fn, calls=20) -> dict:
    """Device ms per launch of each kernel ``fn`` launches (torch.profiler)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        name = re.search(r"flash_bwd_\w+", e.key)
        if e.count and t and name:
            out[name.group(0)] = t / e.count / 1e3
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_ablation: no CUDA device; the times are the card's", file=sys.stderr)
        return 1
    libs = build_variants()
    times, kernels = {}, {}
    for B, S, H, D in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn(B, S, H, D, generator=g, device="cuda").bfloat16()
                   for _ in range(3))
        do = (torch.randn(B, S, H, D, generator=g, device="cuda") * 0.1).bfloat16()
        o, lse = fa.flash_attention_fwd(q, k, v)
        for rep in range(2):
            for name, lib in libs.items():
                op_builder._LIBS["flash_attention_bwd"] = lib
                label = f"B{B} S{S} H{H} D{D} {name}"
                times.setdefault(label, []).append(time_ms(
                    lambda i: fa.flash_attention_bwd(q, k, v, o, lse, do), 30)[0])
                if rep == 0:
                    kernels[label] = kernel_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do))
        del q, k, v, do, o, lse
    op_builder._LIBS.pop("flash_attention_bwd", None)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "ms": times,
                      "kernel_ms": kernels}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
