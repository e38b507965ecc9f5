"""Recovery: manifest-validated restore with walk-back, and in-memory
rollback (counterpart of ``deepspeed_tpu/resilience/recovery.py``).

Two recovery axes, matching the two failure classes:

- **Across restarts** (:func:`load_resilient_state`): find the newest tag
  whose manifest validates (skipping corrupt and torn tags, see
  ``manifest.find_latest_valid``), match every leaf by its path name
  against the engine's state, with JAX's shape, dtype and missing-leaf
  errors, and hand back the client state (step counters, telemetry
  counters) and the extras (``__rng__``) so the resumed run is
  bit-identical to the saved one.
- **Within a run** (:class:`RollbackManager`): one host snapshot of the
  last known-good state. When the watchdog trips under the ``rollback``
  policy, the engine restores it and skips the poisoned batch.

The engine's state is a flat ``{path: tensor}`` map whose tensors a
captured training program reads by address: both axes hand back host
tensors, and the engine writes them into its own tensors in place.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch

from ..utils.logging import log_dist, logger
from . import manifest as mf


class RollbackLimitError(RuntimeError):
    """Too many rollbacks: the pathology is persistent, not a bad batch."""


def is_resilient_dir(load_dir: str, tag: Optional[str] = None) -> bool:
    """Does ``load_dir`` hold manifest-format checkpoints (vs the
    non-resilient ``<tag>/state`` format)?"""
    if tag is not None:
        return os.path.isfile(os.path.join(load_dir, str(tag), mf.MANIFEST))
    return bool(mf.list_tags(load_dir))


def load_resilient_state(load_dir: str, tag: Optional[str],
                         like_state: Dict[str, torch.Tensor],
                         load_optimizer_states: bool = True, registry=None
                         ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any], str,
                                    Dict[str, torch.Tensor]]:
    """Read the newest VALID tag against ``like_state`` (``{path:
    tensor}``) → ``(state, client_state, tag_used, extras)``: ``state``
    maps each leaf to restore to its host tensor (the ``opt_state`` leaves
    are left out under ``load_optimizer_states=False``: the engine keeps
    its own), ``extras`` the non-state arrays the save added (``__rng__``,
    ...). ``comm_error`` leaves may differ between save and resume (the
    engine keeps its zeros); any other missing leaf raises, as does a
    shape or dtype that differs: a partial or retyped restore is
    corruption, not flexibility."""
    tag_used, skipped = mf.find_latest_valid(load_dir, tag)
    if skipped:
        names = [s["tag"] for s in skipped]
        logger.warning(
            f"checkpoint walk-back: skipped invalid tag(s) {names} in "
            f"{load_dir}; recovering from {tag_used!r} "
            f"({'; '.join(s['reason'] for s in skipped)})"
        )
        if registry is not None:
            registry.counter("recovery_events_total", "recovery actions by kind",
                             labelnames=("kind",)).inc(len(skipped), kind="walk_back")
    tag_dir = os.path.join(os.path.abspath(load_dir), tag_used)
    manifest = mf.read_manifest(tag_dir)
    arrays = mf.load_arrays(tag_dir, manifest)

    state: Dict[str, torch.Tensor] = {}
    used = set()
    for name, cur in like_state.items():
        skip_opt = not load_optimizer_states and name.startswith("opt_state")
        arr = arrays.get(name)
        if arr is None or skip_opt:
            if skip_opt or name.startswith("comm_error"):
                if arr is None and not skip_opt:
                    logger.warning(f"checkpoint {tag_used!r} has no {name!r} (comm "
                                   "compression residuals restart from zero)")
                if arr is not None:
                    used.add(name)
                continue
            raise KeyError(
                f"checkpoint {tag_used!r} is missing state leaf {name!r} "
                "(engine/checkpoint structure mismatch)"
            )
        used.add(name)
        if tuple(arr.shape) != tuple(cur.shape):
            raise ValueError(
                f"state leaf {name!r}: checkpoint shape {tuple(arr.shape)} "
                f"!= engine shape {tuple(cur.shape)}"
            )
        if arr.dtype != cur.dtype:
            # a silent dtype swap corrupts training exactly as a shape
            # mismatch would
            raise ValueError(
                f"state leaf {name!r}: checkpoint dtype {arr.dtype} "
                f"!= engine dtype {cur.dtype}"
            )
        state[name] = arr
    extras = {n: a for n, a in arrays.items() if n not in used and n.startswith("__")}
    dropped = [n for n in arrays if n not in used and not n.startswith("__")]
    if dropped:
        logger.warning(
            f"checkpoint {tag_used!r} carries leaves this engine does not: "
            f"{dropped[:5]}{'...' if len(dropped) > 5 else ''}; dropping them"
        )
    log_dist(f"restored checkpoint tag {tag_used!r} from {load_dir}")
    return state, dict(manifest.get("client_state", {})), tag_used, extras


class RollbackManager:
    """Last-known-good host snapshot + bounded restore.

    ``snapshot`` keeps ONE host copy of the state, overwritten each call
    (into the same pinned buffers); ``restore`` hands it back and counts:
    past ``max_rollbacks`` it raises :class:`RollbackLimitError`, because
    a run that needs its Nth rollback is diverging, not hitting bad
    batches."""

    def __init__(self, max_rollbacks: int = 8, registry=None):
        self.max_rollbacks = int(max_rollbacks)
        self.rollbacks = 0
        self._snap: Optional[Tuple[Dict[str, torch.Tensor], int]] = None
        self._snap_step: Optional[int] = None
        if registry is not None:
            self._c_rolled = registry.counter(
                "rolled_back_steps_total", "train steps undone by watchdog rollback")
            self._c_events = registry.counter(
                "recovery_events_total", "recovery actions by kind", labelnames=("kind",))
        else:
            self._c_rolled = self._c_events = None

    def snapshot(self, state: Dict[str, torch.Tensor], global_steps: int) -> None:
        """Host-copy the state; returns once the copy landed (the engine
        has already waited for the step's outputs, so this is the
        device-to-host copy only)."""
        from .writer import snapshot_to_host

        host = snapshot_to_host(state, out=self._snap[0] if self._snap is not None else None)
        self._snap = (host, int(global_steps))
        self._snap_step = int(global_steps)

    @property
    def can_restore(self) -> bool:
        return self._snap is not None

    @property
    def snapshot_step(self) -> Optional[int]:
        return self._snap_step

    def restore(self) -> Tuple[Dict[str, torch.Tensor], int]:
        if self._snap is None:
            raise RuntimeError("no snapshot taken yet")
        self.rollbacks += 1
        if self.rollbacks > self.max_rollbacks:
            raise RollbackLimitError(
                f"rollback #{self.rollbacks} exceeds "
                f"resilience.max_rollbacks={self.max_rollbacks} — the "
                "anomaly is persistent, not a poisoned batch; stopping"
            )
        if self._c_rolled is not None:
            self._c_rolled.inc()
            self._c_events.inc(kind="rollback")
        return self._snap
