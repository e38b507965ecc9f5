"""Offline consolidation: a training checkpoint → one fp32 state file
(counterpart of ``deepspeed_tpu/utils/zero_to_fp32.py``, the reference's
script that recovers a plain fp32 state dict from ZeRO shards without the
training cluster).

A tag of this package holds whole leaves whatever the ZeRO stage and dp
width that wrote it (the engine gathers the shards before writing), so
consolidating is reading the tag's ``params/...`` leaves on the CPU: from
the crc manifest (``resilience`` on; either package's) or from the
torch-native state file. The output is JAX's: one ``.npz`` keyed by the
leaves' ``/``-joined paths, floating leaves as fp32.

CLI::

    python -m deepspeed_tpu_torch.utils.zero_to_fp32 <ckpt_dir> <output.npz> [--tag TAG]
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional

import numpy as np
import torch

PARAMS = "params/"


def _tag_state(ckpt_dir: str, tag: Optional[str]) -> Dict[str, torch.Tensor]:
    """The tag's state leaves as CPU tensors (``latest`` when ``tag`` is
    None; a manifest tag is validated, walking back past corrupt ones)."""
    from ..resilience import manifest as mf
    from ..resilience.recovery import is_resilient_dir

    if is_resilient_dir(ckpt_dir, tag):
        tag_used, _ = mf.find_latest_valid(ckpt_dir, tag)
        return mf.load_arrays(os.path.join(os.path.abspath(ckpt_dir), tag_used))
    from ..checkpoint.engine import STATE_FILE, read_latest_tag

    tag = tag or read_latest_tag(ckpt_dir)
    if tag is None:
        raise FileNotFoundError(f"no 'latest' file in {ckpt_dir} and no tag given")
    return torch.load(os.path.join(os.path.abspath(ckpt_dir), str(tag), "state", STATE_FILE),
                      map_location="cpu", weights_only=True)


def get_fp32_state_dict_from_zero_checkpoint(ckpt_dir: str,
                                             tag: Optional[str] = None) -> Dict[str, np.ndarray]:
    """The checkpoint's parameters as ``{path: fp32 numpy array}`` (the
    reference's get_fp32_state_dict_from_zero_checkpoint)."""
    out = {}
    for name, t in _tag_state(ckpt_dir, tag).items():
        if not name.startswith(PARAMS):
            continue
        a = t.float().numpy() if t.is_floating_point() else t.numpy()
        out[name[len(PARAMS):]] = a
    return out


def convert_zero_checkpoint_to_fp32_state_dict(ckpt_dir: str, output_file: str,
                                               tag: Optional[str] = None) -> str:
    """Write the checkpoint's fp32 parameters to ``output_file`` (npz)."""
    flat = get_fp32_state_dict_from_zero_checkpoint(ckpt_dir, tag)
    os.makedirs(os.path.dirname(os.path.abspath(output_file)) or ".", exist_ok=True)
    np.savez(output_file, **flat)
    total = sum(v.size for v in flat.values())
    print(f"saved {len(flat)} tensors ({total:,} elements) to {output_file}")
    return output_file


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("ckpt_dir")
    ap.add_argument("output_file")
    ap.add_argument("--tag", default=None)
    args = ap.parse_args()
    convert_zero_checkpoint_to_fp32_state_dict(args.ckpt_dir, args.output_file, args.tag)


if __name__ == "__main__":
    main()
