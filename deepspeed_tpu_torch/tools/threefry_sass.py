"""The instructions ``ptxas`` emits for the threefry kernel
(``csrc/threefry.cu``), counted per element: what the kernel issues beside
the count its bound in ``chip_smoke.py`` takes from the function.

Usage, on a machine with the CUDA toolkit (``nvcc``, ``cuobjdump``), from
the repository root:

    python -m deepspeed_tpu_torch.tools.threefry_sass

Builds ``threefry.cu`` as the port builds it (``ops/op_builder.py``), reads
its SASS with ``cuobjdump -sass``, and for each kernel finds the body of
its grid-stride loop (the instructions between a backward branch and its
target). The elements a pass of the body draws are its funnel-shift
rotates over the 20 of one threefry2x32. Prints, for each kernel, the
body's instructions by opcode, the instructions an element, and their split
over the integer ALU (``IADD3``, ``LOP3``, ``SHF``, ``ISETP``, ``LEA``,
``SEL``, ``PRMT``, ...) and the FMA pipes (``IMAD``, ``FFMA``, ``FADD``,
``FMUL``, ...), then one JSON line with the same numbers.
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


def main() -> int:
    from deepspeed_tpu_torch.ops import op_builder

    op_builder.build(["threefry"])
    lib = op_builder.library_path("threefry")
    cuobjdump = os.path.join(os.path.dirname(op_builder.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    result = {}
    for name, instrs in sorted(kernels(sass).items()):
        body = loop_body(instrs)
        ops = collections.Counter(op for _, op, _, _ in body)
        rotates = sum(1 for _, op, mods, _ in body if op == "SHF" and ".W" in mods)
        elements = max(rotates // 20, 1)
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
