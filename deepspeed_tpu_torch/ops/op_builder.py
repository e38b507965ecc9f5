"""Build the package's CUDA sources and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled at first use by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, in
``deepspeed_tpu_torch/_build/`` (git-ignored), and loaded with ``ctypes``.
The library's file name carries a digest of the sources and flags, so an
edited source is rebuilt and a stale library is never loaded. Sources of
several kernels build in parallel, one ``nvcc`` each. Only sources in this
repository are compiled; a failed build raises with the compiler's output.

Pointers and the stream cross the C boundary as ``ctypes.c_void_p``; every
C entry returns the CUDA error of its launch (0 on success) and the
caller raises when it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# ctypes signatures of each library's C entries: name -> {fn: (argtypes, restype)}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "paged_decode_attention": {
        "paged_decode_attention_launch": (
            [_P, _P, _P, _P, _P, _P,           # q, k_pool, v_pool, tables, pos, out
             _I, _I, _I, _I, _I, _I, _I,       # B, H, KV, P, page, n, D
             _F, _I, _I, _P],                  # sm_scale, q dtype, kv dtype, stream
            ctypes.c_int,
        ),
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build wall time, "log": nvcc's ptxas report}; only
# sources built by this process appear here
BUILD_LOG: Dict[str, dict] = {}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels of deepspeed_tpu_torch build at first use "
        "and need the CUDA toolkit"
    )


def sources() -> list:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"no CUDA source {src}")
    h = hashlib.sha256()
    for p in [src] + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every source in ``names`` (default: all) that has no library
    yet, one ``nvcc`` per source, all started together. → seconds each
    build took (0.0 for a library that was already there)."""
    names = list(sources() if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    out: Dict[str, float] = {}
    for name in names:
        lib = library_path(name)
        if lib.is_file():
            out[name] = 0.0
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, lib, time.perf_counter(),
        )
    failed = []
    for name, (proc, tmp, lib, t0) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)
        out[name] = secs
        BUILD_LOG[name] = {"seconds": secs, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed,
    with its C entries' signatures set."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build([name])
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, (argtypes, restype) in SIGNATURES.get(name, {}).items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    _LIBS[name] = lib
    return lib
