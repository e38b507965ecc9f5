"""Where the flash-attention forward's time goes on the card: the kernel timed
whole and with its parts left out.

Usage, on a machine with one CUDA card, from the repository root:

    python -m deepspeed_tpu_torch.tools.flash_fwd_ablation

Builds ``csrc/flash_attention_fwd.cu`` four times into
``deepspeed_tpu_torch/_build/ablation/``: whole; without the softmax
(``softmax_tile`` returns at once, P is the raw scores); without the
products (``issue_s`` and ``issue_pv`` return at once, no wgmma runs);
without both (the TMA pipeline, barriers and stores alone). The variants
compute wrong outputs and exist only to be timed. Each is timed through
``ops.flash_attention.flash_attention_fwd`` with ``time_ms`` (CUDA events,
the host's enqueueing hidden) at the training shape (B8 S1024 H16 D64
bf16 causal), S128 B8 H16, S8192 B1 H4 and D128 B2 S1024 H8, in turns
over the variants, twice. Prints one JSON line of ms per call.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.tools.time_attention_kernels import time_ms

# (anchor in the source, text inserted after it): each guarded by a macro
PATCHES = {
    "ABLATE_SOFTMAX": ("int t, float scale2, const Params& p) {\n",
                       "#ifdef ABLATE_SOFTMAX\n  corr[0] = corr[1] = 1.f;\n  return;\n#endif\n"),
    "ABLATE_MMA_S": ("uint32_t q_addr, uint32_t k_addr) {\n",
                     "#ifdef ABLATE_MMA\n  return;\n#endif\n"),
    "ABLATE_MMA_PV": ("uint32_t v_addr) {\n", "#ifdef ABLATE_MMA\n  return;\n#endif\n"),
}
VARIANTS = {
    "whole": [],
    "no softmax": ["-DABLATE_SOFTMAX"],
    "no products": ["-DABLATE_MMA"],
    "neither": ["-DABLATE_SOFTMAX", "-DABLATE_MMA"],
}
SHAPES = [(8, 1024, 16, 64), (8, 128, 16, 64), (1, 8192, 4, 64), (2, 1024, 8, 128)]


def patched_source() -> str:
    src = (op_builder.CSRC_DIR / "flash_attention_fwd.cu").read_text()
    for name, (anchor, text) in PATCHES.items():
        if src.count(anchor) != 1:
            raise RuntimeError(f"{name}: anchor {anchor!r} found {src.count(anchor)} times")
        src = src.replace(anchor, anchor + text)
    return src


def build_variants() -> dict:
    out_dir = op_builder.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "flash_attention_fwd_ablation.cu"
    src.write_text(patched_source())
    procs = {}
    for name, flags in VARIANTS.items():
        lib = out_dir / f"lib{name.replace(' ', '_')}.so"
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
        for fn, (argtypes, restype) in op_builder.SIGNATURES["flash_attention_fwd"].items():
            getattr(handle, fn).argtypes = argtypes
            getattr(handle, fn).restype = restype
        libs[name] = handle
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_fwd_ablation: no CUDA device; the times are the card's", file=sys.stderr)
        return 1
    libs = build_variants()
    times = {}
    for B, S, H, D in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn(B, S, H, D, generator=g, device="cuda").bfloat16()
                   for _ in range(3))
        for rep in range(2):
            for name, lib in libs.items():
                op_builder._LIBS["flash_attention_fwd"] = lib
                ms = time_ms(lambda i: fa.flash_attention_fwd(q, k, v), 40)[0]
                times.setdefault(f"B{B} S{S} H{H} D{D} {name}", []).append(ms)
        del q, k, v
    op_builder._LIBS.pop("flash_attention_fwd", None)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
