"""The instructions ``ptxas`` emits for the threefry kernel
(``csrc/threefry.cu``), counted per element: what the kernel issues beside
the count its bound in ``chip_smoke.py`` takes from the function.

Usage, on a machine with the CUDA toolkit (``nvcc``, ``cuobjdump``), from
the repository root:

    python -m deepspeed_tpu_torch.tools.threefry_sass

Builds ``threefry.cu`` as the port builds it (``ops/op_builder.py``), reads
its SASS with ``cuobjdump -sass``, and for each kernel (each template
instance: dtype, the quotient by multiply or division, 32- or 64-bit
indices) finds the body of its largest loop (the instructions between a
backward branch and its target: the 16-byte vector loop). The elements a
pass of the body draws are its funnel-shift rotates over the 20 of one
threefry2x32. Prints, for each kernel, the body's instructions by opcode,
the instructions an element, and their split over the integer ALU
(``IADD3``, ``LOP3``, ``SHF``, ``ISETP``, ``LEA``, ``SEL``, ``PRMT``, ...)
and the FMA pipes (``IMAD``, ``FFMA``, ``FADD``, ``FMUL``, ...), then one
JSON line with the same numbers. Run it with an older tree first on
``PYTHONPATH`` (``python <that tree>/deepspeed_tpu_torch/tools/threefry_sass.py``)
to count that tree's kernels: before and after.

    python -m deepspeed_tpu_torch.tools.threefry_sass --fma-rotates 0,2,4,6

on a machine with one CUDA card builds variants of ``threefry.cu`` in which
k of the hash's 20 rotates (spread over the rounds) run on the FMA pipe as
``x * 2^r | umulhi(x, 2^r)`` (2^r from the launch's run-time 1, so ptxas
keeps the multiplies), counts each variant's bf16 dropout loop as above,
and times its dropout of [8, 1024, 1024] bf16 at rate 0.1 (CUDA events, the
variants alternating over three rounds, each result checked against the
plain version bit for bit) while ``nvidia-smi`` samples the SM clock and
power draw.
"""

from __future__ import annotations

import collections
import json
import os
import re
import subprocess
import sys

# SASS opcodes by the pipe that runs them (the rest: memory, control,
# conversions, special functions)
ALU = {"IADD3", "LOP3", "SHF", "ISETP", "LEA", "SEL", "PRMT", "IABS", "IMNMX", "FSEL",
       "FSETP", "FMNMX", "PLOP3", "P2R", "R2P", "FLO", "POPC", "BREV", "VIADD", "VIMNMX"}
FMA = {"IMAD", "IMUL", "FFMA", "FADD", "FMUL", "HFMA2", "HADD2", "HMUL2"}

LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)([.\w]*)\s*([^;]*);")
BRANCH = re.compile(r"0x([0-9a-f]+)")


def kernels(sass: str):
    """{function name: [(address, opcode, modifiers, operands)]}"""
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            out[name] = []
            continue
        m = LINE.search(line)
        if m and name is not None:
            out[name].append((int(m.group(1), 16), m.group(3), m.group(4), m.group(5)))
    return out


def loop_body(instrs):
    """The instructions of the largest backward branch's range (the
    grid-stride loop)."""
    best = []
    for addr, op, _, args in instrs:
        if op != "BRA":
            continue
        m = BRANCH.search(args)
        if m and int(m.group(1), 16) < addr:
            body = [i for i in instrs if int(m.group(1), 16) <= i[0] <= addr]
            if len(body) > len(best):
                best = body
    return best


def elements_a_pass(body) -> int:
    """The hashes a loop body computes: its rotates (funnel shifts, and the
    high halves of rotates on the FMA pipe: ``IMAD.HI`` or ``IMAD.WIDE``)
    over the 20 of one."""
    rotates = sum(1 for _, op, mods, _ in body
                  if (op == "SHF" and ".W" in mods)
                  or (op == "IMAD" and (".HI" in mods or ".WIDE" in mods)))
    return max(rotates // 20, 1)


def pipe_counts(instrs) -> dict:
    """The largest loop's instructions an element: all, ALU, FMA pipes, and
    its opcodes with their modifiers."""
    body = loop_body(instrs)
    ops = collections.Counter(op for _, op, _, _ in body)
    n = elements_a_pass(body)
    return dict(per_element=len(body) / n, elements_a_pass=n,
                alu_per_element=sum(c for op, c in ops.items() if op in ALU) / n,
                fma_per_element=sum(c for op, c in ops.items() if op in FMA) / n,
                opcodes=dict(collections.Counter(op + mods for _, op, mods, _ in body)))


ROUND = "TF_ROUND("
FMA_ROTATE = """
__device__ __forceinline__ uint32_t rotl_fma(uint32_t x, int r, uint32_t one) {
  const uint32_t m = one << r;
  return (x * m) | __umulhi(x, m);
}
#define TF_ROUND_FMA(r) x0 = madd(x1, x0, one); x1 = rotl_fma(x1, r, one) ^ x0;
"""


def fma_rotate_source(src: str, k: int) -> str:
    """``threefry.cu`` with k of its 20 rounds rotating on the FMA pipe."""
    start = src.index("  TF_ROUND(13) TF_ROUND(15)")
    end = src.index("#undef TF_ROUND")
    body = src[start:end]
    at = [m.start() for m in re.finditer(re.escape(ROUND), body)]
    if len(at) != 20:
        raise RuntimeError(f"threefry_sass: expected 20 rounds in threefry.cu, found {len(at)}")
    for i in sorted({int((j + 0.5) * 20 / k) for j in range(k)}, reverse=True):
        body = body[:at[i]] + "TF_ROUND_FMA(" + body[at[i] + len(ROUND):]
    anchor = src.index("// threefry2x32 (jax _src/prng.py")
    return src[:anchor] + FMA_ROTATE + src[anchor:start] + body + src[end:]


def fma_rotate_variants(counts) -> dict:
    """Build, count and time the ``--fma-rotates`` variants (module doc)."""
    import ctypes

    import torch

    from deepspeed_tpu_torch.ops import dropout, op_builder, prng
    from deepspeed_tpu_torch.tools.time_attention_kernels import time_ms

    nvcc = op_builder.nvcc_path()
    out_dir = op_builder.BUILD_DIR / "threefry_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (op_builder.CSRC_DIR / "threefry.cu").read_text()
    procs = {}
    for k in counts:
        cu = out_dir / f"fma{k}.cu"
        cu.write_text(fma_rotate_source(src, k) if k else src)
        procs[k] = subprocess.Popen([nvcc, *op_builder.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")),
                                     str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
    libs, result = {}, {}
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    for k, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"threefry_sass: variant fma{k} failed to build:\n{log}")
        so = str(out_dir / f"fma{k}.so")
        lib = ctypes.CDLL(so)
        lib.threefry_dropout_launch.argtypes, lib.threefry_dropout_launch.restype = (
            op_builder.SIGNATURES["threefry"]["threefry_dropout_launch"])
        libs[k] = lib
        sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True,
                              check=True).stdout
        (instrs,) = [v for n, v in kernels(sass).items()
                     if "dropout_kernel" in n and "nv_bfloat16Lb1Ej" in n]
        result[k] = dict(pipe_counts(instrs), ms=[])
    key = prng.fold_in(prng.PRNGKey(1), 16)
    x = torch.randn(8, 1024, 1024, generator=torch.Generator(device="cuda").manual_seed(16),
                    device="cuda").to(torch.bfloat16)
    want = dropout.dropout_ref(x, key, 0.1)
    p, c = prng.keep_scale(0.1, x.dtype)
    r, mul = prng.reciprocal_is_exact(0.1, x.dtype)
    dkey = prng.device_keys(key, "cuda")
    stream = torch.cuda.current_stream().cuda_stream
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "250"],
                           stdout=subprocess.PIPE, text=True)
    for rnd in range(3):
        for k in (counts if rnd % 2 == 0 else counts[::-1]):
            y = torch.empty_like(x)

            def call(_, lib=libs[k], y=y):
                lib.threefry_dropout_launch(x.data_ptr(), y.data_ptr(), x.numel(),
                                            dkey.data_ptr(), prng.keep_threshold(p), c, r,
                                            int(mul), 2, 2, stream)

            result[k]["ms"].append(time_ms(call, 200)[0])
            torch.cuda.synchronize()
            if not torch.equal(y, want):
                raise RuntimeError(f"threefry_sass: variant fma{k} differs from the plain version")
    smi.terminate()
    samples = [line.split(",") for line in smi.communicate()[0].split("\n") if "," in line]
    clocks = [float(a) for a, _ in samples]
    watts = [float(b) for _, b in samples]
    for k in counts:
        v = result[k]
        print(f"{k} rotates on the FMA pipe: {v['per_element']:.2f} instructions an element "
              f"over {v['elements_a_pass']} a pass (ALU {v['alu_per_element']:.2f}, FMA pipes "
              f"{v['fma_per_element']:.2f}); dropout [8, 1024, 1024] bf16 ms "
              + " ".join(f"{t:.5f}" for t in v["ms"]))
        print("  " + ", ".join(f"{op} {n}" for op, n in sorted(v["opcodes"].items(),
                                                               key=lambda kv: -kv[1])))
    print(f"SM clock {min(clocks, default=0):.0f}-{max(clocks, default=0):.0f} MHz, power "
          f"{min(watts, default=0):.1f}-{max(watts, default=0):.1f} W over the timings")
    return dict(variants={str(k): v for k, v in result.items()}, sm_clock_mhz=clocks,
                power_w=watts, device=torch.cuda.get_device_name(0))


def demangle(names, tool_dir):
    """{mangled: readable} through ``cu++filt`` when the toolkit has it."""
    tool = os.path.join(tool_dir, "cu++filt")
    if not names or not os.path.isfile(tool):
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True).stdout.splitlines()
    return dict(zip(names, out)) if len(out) == len(names) else {n: n for n in names}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fma-rotates", default=None,
                    help="comma-separated counts of rotates to move to the FMA pipe (needs a card)")
    args = ap.parse_args(argv)
    if args.fma_rotates is not None:
        print(json.dumps(fma_rotate_variants([int(k) for k in args.fma_rotates.split(",")])))
        return 0
    from deepspeed_tpu_torch.ops import op_builder

    op_builder.build(["threefry"])
    lib = op_builder.library_path("threefry")
    cuobjdump = os.path.join(os.path.dirname(op_builder.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    result = {}
    found = kernels(sass)
    readable = demangle(sorted(found), os.path.dirname(op_builder.nvcc_path()))
    for mangled, instrs in sorted(found.items()):
        name = readable[mangled].replace("(anonymous namespace)::", "")
        body = loop_body(instrs)
        ops = collections.Counter(op for _, op, _, _ in body)
        elements = elements_a_pass(body)
        alu = sum(n for op, n in ops.items() if op in ALU)
        fma = sum(n for op, n in ops.items() if op in FMA)
        per = len(body) / elements
        result[name] = dict(instructions=len(instrs), body=len(body), elements_a_pass=elements,
                            per_element=per, alu_per_element=alu / elements,
                            fma_per_element=fma / elements,
                            other_per_element=(len(body) - alu - fma) / elements,
                            opcodes=dict(ops.most_common()))
        print(f"{name}: {len(instrs)} instructions, loop body {len(body)} for {elements} "
              f"element(s) a pass: {per:.2f} an element (ALU {alu / elements:.2f}, FMA pipes "
              f"{fma / elements:.2f}, other {(len(body) - alu - fma) / elements:.2f})")
        print("  " + ", ".join(f"{op} {n}" for op, n in ops.most_common()))
    print(json.dumps({"library": lib.name, "kernels": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
