"""Checkpoint save/load, the non-resilient path (counterpart of
``deepspeed_tpu/checkpoint/engine.py``).

The JAX package writes its state file with Orbax, a JAX library; this
package implements the same pluggable :class:`CheckpointEngine` with its
own torch-native engine (:class:`TorchCheckpointEngine`: one ``torch.save``
of the ``{path: tensor}`` state under ``<tag>/state/``) and keeps JAX's
layout around it:

    <save_dir>/<tag>/state/           the state (torch-native here)
    <save_dir>/<tag>/client_state.json
    <save_dir>/latest                 text file naming the newest tag,
                                      swapped atomically

So a tag of this path loads only in this package. The checkpoints that
cross between the packages are the resilient ones (``resilience`` section
on): the crc manifest of ``resilience/manifest.py``, which both packages
write and read byte for byte.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from ..resilience.manifest import atomic_write_text

LATEST_FILE = "latest"
STATE_FILE = "state.pt"


class CheckpointEngine:
    """Pluggable engine ABC (the reference's checkpoint_engine.py)."""

    def save(self, path: str, state: Dict[str, torch.Tensor]) -> None:
        raise NotImplementedError

    def load(self, path: str, like_state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def commit(self) -> None:
        pass


class TorchCheckpointEngine(CheckpointEngine):
    """``{path: tensor}`` → ``<path>/state.pt`` (host copies, written with
    ``torch.save``), and back as CPU tensors."""

    def save(self, path: str, state: Dict[str, torch.Tensor]) -> None:
        os.makedirs(path, exist_ok=True)
        host = {k: v.detach().cpu() for k, v in state.items()}
        tmp = os.path.join(path, STATE_FILE + ".tmp")
        torch.save(host, tmp)
        os.replace(tmp, os.path.join(path, STATE_FILE))

    def load(self, path: str, like_state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                          weights_only=True)


def save_train_state(save_dir: str, tag: str, state: Dict[str, torch.Tensor],
                     client_state: Optional[Dict] = None, save_latest: bool = True,
                     engine: Optional[CheckpointEngine] = None) -> str:
    """Write ``state`` under ``<save_dir>/<tag>/state``, the client state
    beside it, then swap ``latest`` → the tag directory."""
    engine = engine or TorchCheckpointEngine()
    base = os.path.join(os.path.abspath(save_dir), str(tag))
    os.makedirs(base, exist_ok=True)
    engine.save(os.path.join(base, "state"), state)
    engine.commit()
    with open(os.path.join(base, "client_state.json"), "w") as fh:
        json.dump(client_state or {}, fh)
    if save_latest:
        # atomic swap (temp + fsync + rename): a crash mid-update leaves the
        # previous 'latest', never a torn or empty one
        atomic_write_text(os.path.join(os.path.abspath(save_dir), LATEST_FILE), str(tag))
    return base


def read_latest_tag(load_dir: str) -> Optional[str]:
    p = os.path.join(load_dir, LATEST_FILE)
    if os.path.exists(p):
        with open(p) as fh:
            return fh.read().strip()
    return None


def load_train_state(load_dir: str, tag: Optional[str], like_state: Dict[str, torch.Tensor],
                     load_optimizer_states: bool = True,
                     engine: Optional[CheckpointEngine] = None
                     ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """Read ``<load_dir>/<tag>/state`` (``latest`` when ``tag`` is None)
    against ``like_state`` → ``(state, client_state)``: host tensors of
    the leaves to restore, each checked for its name, shape and dtype
    (``opt_state`` leaves left out under ``load_optimizer_states=False``)."""
    engine = engine or TorchCheckpointEngine()
    tag = tag or read_latest_tag(load_dir)
    if tag is None:
        raise FileNotFoundError(f"no 'latest' file in {load_dir} and no tag given")
    base = os.path.join(os.path.abspath(load_dir), str(tag))
    saved = engine.load(os.path.join(base, "state"), like_state)
    state: Dict[str, torch.Tensor] = {}
    for name, cur in like_state.items():
        if not load_optimizer_states and name.startswith("opt_state"):
            continue
        arr = saved.get(name)
        if arr is None:
            raise KeyError(f"checkpoint {tag!r} is missing state leaf {name!r} "
                           "(engine/checkpoint structure mismatch)")
        if tuple(arr.shape) != tuple(cur.shape) or arr.dtype != cur.dtype:
            raise ValueError(f"state leaf {name!r}: checkpoint {tuple(arr.shape)} "
                             f"{arr.dtype} != engine {tuple(cur.shape)} {cur.dtype}")
        state[name] = arr
    client_state: Dict = {}
    client_path = os.path.join(base, "client_state.json")
    if os.path.exists(client_path):
        with open(client_path) as fh:
            client_state = json.load(fh)
    return state, client_state
