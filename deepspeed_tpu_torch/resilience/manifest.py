"""Integrity-checked checkpoint format: per-array checksums + atomic commit
(counterpart of ``deepspeed_tpu/resilience/manifest.py``, byte-compatible
with it: a tag written by either package validates and loads in the
other).

Layout on disk::

    <save_dir>/<tag>/manifest.json     format, step, fingerprint, client
                                       state, per-array {file, dtype, shape,
                                       bytes, crc32}
    <save_dir>/<tag>/00000.bin ...     raw array bytes, one file per leaf
    <save_dir>/latest                  text file naming the newest GOOD tag

Commit protocol (:func:`write_tag`):

1. write every array file into ``<tag>.tmp`` and fsync each;
2. write ``manifest.json`` (checksums computed from the bytes actually
   written) and fsync it;
3. fsync the tmp directory, then ``rename(<tag>.tmp, <tag>)``: the tag
   becomes visible atomically, fully checksummed or not at all;
4. atomically swap ``latest`` (temp file + fsync + rename).

A crash at any point leaves either the previous state intact (steps 1-3) or
a fully committed tag without the ``latest`` swap (after 3); both are
recovered by :func:`find_latest_valid`'s walk-back.

The arrays are raw C-order bytes under the manifest's dtype string (numpy's
``dtype.name``: ``float32``, ``int32``, ``uint32``, ..., and ``bfloat16``,
the name the JAX package's ml_dtypes arrays carry). An array to write is a
numpy array or a CPU torch tensor; :func:`load_arrays` hands back CPU torch
tensors, a ``bfloat16`` entry read as ``uint16`` words and viewed as
``torch.bfloat16``, so the bits round-trip without ml_dtypes.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

FORMAT = "dstpu-resilient-ckpt-v1"
MANIFEST = "manifest.json"
LATEST_FILE = "latest"


class CheckpointIntegrityError(RuntimeError):
    """A tag failed manifest validation (torn write / corruption)."""


def checksum(data) -> int:
    """crc32 (unsigned) of a bytes-like object: fast enough to run per
    array on every save."""
    return zlib.crc32(data) & 0xFFFFFFFF


def host_bytes(arr) -> Tuple[str, List[int], bytes]:
    """An array (numpy, or a CPU torch tensor) → ``(dtype name, shape, its
    C-order bytes)``; a bf16 tensor is named ``bfloat16`` and written as
    its 16-bit words."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach()
        if t.device.type != "cpu":
            raise ValueError("host_bytes: the array must be on the host (snapshot_to_host)")
        shape = list(t.shape)
        if t.dtype == torch.bfloat16:
            return "bfloat16", shape, t.contiguous().view(torch.int16).numpy().tobytes()
        a = t.contiguous().numpy()
        return a.dtype.name, shape, a.tobytes()
    # np.asarray, NOT ascontiguousarray: the latter promotes 0-d scalars to
    # [1]; tobytes() already emits C order
    a = np.asarray(arr)
    return a.dtype.name, list(a.shape), a.tobytes()


def from_bytes(data, dtype: str, shape) -> torch.Tensor:
    """Raw bytes under a manifest dtype string → a CPU torch tensor."""
    buf = bytearray(data)  # writable, so torch shares it without a warning
    if dtype == "bfloat16":
        words = np.frombuffer(buf, dtype=np.uint16)
        return torch.from_numpy(words).view(torch.bfloat16).reshape(tuple(shape))
    return torch.from_numpy(np.frombuffer(buf, dtype=np.dtype(dtype))).reshape(tuple(shape))


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # platforms without O_RDONLY dir opens: rename is still atomic
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_text(path: str, text: str) -> None:
    """temp file + fsync + rename: readers see the old or the new content,
    never a torn write (the ``latest`` swap primitive). The temp name is
    unique per process and thread, so a background writer and a forced
    blocking save racing on the same ``latest`` never clobber each other's
    temp file: the last rename wins."""
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w") as fh:
        fh.write(text)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(os.path.abspath(path)))


def write_tag(save_dir: str, tag: str, arrays: Dict[str, Any],
              client_state: Optional[Dict[str, Any]] = None, fingerprint: str = "",
              step: int = 0, save_latest: bool = True,
              crash_before_manifest: bool = False) -> str:
    """Write one checkpoint tag under the atomic commit protocol → the
    committed tag directory.

    ``crash_before_manifest`` is the deterministic fault-injection hook
    (``resilience.fault_injection.crash_saves``): raise after the array
    files are on disk but before the manifest and the rename, leaving the
    torn ``<tag>.tmp`` a mid-write process death would."""
    base = os.path.abspath(save_dir)
    os.makedirs(base, exist_ok=True)
    final = os.path.join(base, str(tag))
    tmp = final + ".tmp"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    entries: Dict[str, Dict[str, Any]] = {}
    for i, (name, arr) in enumerate(arrays.items()):
        dtype, shape, data = host_bytes(arr)
        fname = f"{i:05d}.bin"
        with open(os.path.join(tmp, fname), "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        entries[name] = {"file": fname, "dtype": dtype, "shape": shape,
                         "bytes": len(data), "crc32": checksum(data)}

    if crash_before_manifest:
        from .faults import FaultInjected

        raise FaultInjected(
            f"injected crash mid-checkpoint-write of tag {tag!r} "
            f"(arrays on disk, no manifest — torn {os.path.basename(tmp)})"
        )

    manifest = {
        "format": FORMAT,
        "tag": str(tag),
        "step": int(step),
        "fingerprint": fingerprint,
        "client_state": client_state or {},
        "arrays": entries,
    }
    with open(os.path.join(tmp, MANIFEST), "w") as fh:
        json.dump(manifest, fh, indent=1)
        fh.flush()
        os.fsync(fh.fileno())
    _fsync_dir(tmp)

    # the one visibility point: a fully written, checksummed directory
    # appears under the final name in one rename. Re-saving an existing tag
    # moves the stale directory aside first (a rename onto a non-empty
    # directory is not atomic)
    if os.path.isdir(final):
        stale = final + ".stale"
        if os.path.isdir(stale):
            shutil.rmtree(stale)
        os.rename(final, stale)
        os.rename(tmp, final)
        shutil.rmtree(stale, ignore_errors=True)
    else:
        os.rename(tmp, final)
    _fsync_dir(base)

    if save_latest:
        atomic_write_text(os.path.join(base, LATEST_FILE), str(tag))
    return final


def read_manifest(tag_dir: str) -> Dict[str, Any]:
    with open(os.path.join(tag_dir, MANIFEST)) as fh:
        return json.load(fh)


def validate_tag(tag_dir: str) -> Tuple[bool, str]:
    """Full integrity check of one committed tag: manifest present and
    parseable, every array file present, size and crc32 matching →
    ``(ok, reason)``, the reason naming the first failure."""
    mpath = os.path.join(tag_dir, MANIFEST)
    if not os.path.isfile(mpath):
        return False, "no manifest.json (torn write)"
    try:
        manifest = read_manifest(tag_dir)
    except (OSError, ValueError) as e:
        return False, f"unreadable manifest: {e}"
    if manifest.get("format") != FORMAT:
        return False, f"unknown format {manifest.get('format')!r}"
    for name, ent in manifest.get("arrays", {}).items():
        try:
            with open(os.path.join(tag_dir, ent["file"]), "rb") as fh:
                data = fh.read()
        except OSError:
            return False, f"missing array file {ent['file']} ({name})"
        if len(data) != int(ent["bytes"]):
            return False, (
                f"array {name}: {len(data)} bytes on disk, manifest says "
                f"{ent['bytes']} (truncated write)"
            )
        if checksum(data) != int(ent["crc32"]):
            return False, f"array {name}: crc32 mismatch (corruption)"
    return True, "ok"


def load_arrays(tag_dir: str, manifest: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """Every array of a VALIDATED tag as a CPU torch tensor of the
    manifest's dtype (``bfloat16`` through a ``uint16`` view), in the
    manifest's order."""
    manifest = manifest or read_manifest(tag_dir)
    out: Dict[str, torch.Tensor] = {}
    for name, ent in manifest["arrays"].items():
        with open(os.path.join(tag_dir, ent["file"]), "rb") as fh:
            data = fh.read()
        out[name] = from_bytes(data, ent["dtype"], ent["shape"])
    return out


def read_latest_tag(load_dir: str) -> Optional[str]:
    p = os.path.join(load_dir, LATEST_FILE)
    if os.path.isfile(p):
        with open(p) as fh:
            return fh.read().strip() or None
    return None


def list_tags(load_dir: str) -> List[str]:
    """Manifest-bearing tag directories, newest first (manifest step
    descending, mtime as the tiebreak)."""
    base = os.path.abspath(load_dir)
    cands = []
    try:
        entries = os.listdir(base)
    except OSError:
        return []
    for name in entries:
        d = os.path.join(base, name)
        if not os.path.isdir(d) or name.endswith((".tmp", ".stale")):
            continue
        if not os.path.isfile(os.path.join(d, MANIFEST)):
            continue
        try:
            step = int(read_manifest(d).get("step", -1))
        except (OSError, ValueError):
            step = -1
        cands.append((step, os.path.getmtime(d), name))
    cands.sort(reverse=True)
    return [name for _, _, name in cands]


def find_latest_valid(load_dir: str, tag: Optional[str] = None
                      ) -> Tuple[str, List[Dict[str, str]]]:
    """The newest tag that passes full validation, walking back across
    corrupt and torn tags → ``(tag, skipped)``, ``skipped`` recording every
    invalid tag passed over. An explicitly requested ``tag`` is validated
    strictly: asking for one tag and getting another would be a silent
    lie."""
    base = os.path.abspath(load_dir)
    if tag is not None:
        ok, why = validate_tag(os.path.join(base, str(tag)))
        if not ok:
            raise CheckpointIntegrityError(
                f"checkpoint tag {tag!r} in {load_dir} failed validation: {why}"
            )
        return str(tag), []
    skipped: List[Dict[str, str]] = []
    candidates: List[str] = []
    latest = read_latest_tag(base)
    if latest is not None:
        candidates.append(latest)
    for t in list_tags(base):
        if t not in candidates:
            candidates.append(t)
    for t in candidates:
        ok, why = validate_tag(os.path.join(base, t))
        if ok:
            return t, skipped
        skipped.append({"tag": t, "reason": why})
    raise CheckpointIntegrityError(
        f"no valid checkpoint tag in {load_dir} "
        f"(tried {[s['tag'] for s in skipped] or 'none'})"
    )
