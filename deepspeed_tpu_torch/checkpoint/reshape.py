"""Megatron-style TP shard merge/split (state-dict factory analog);
counterpart of ``deepspeed_tpu/checkpoint/reshape.py``, the same numpy code.

Analog of reference ``runtime/state_dict_factory.py`` (SDLoaderFactory:20,
MegatronSDLoader:214) and ``checkpoint/reshape_meg_2d.py``: the reference
merges/splits ``mp_rank_XX`` torch checkpoint shards when the restore TP
degree differs from the save degree — concatenating column-parallel tensors
(QKV, fc1) on the output dim, row-parallel tensors (attn out proj, fc2) on
the input dim, vocab-parallel embeddings on the vocab dim.

These utilities perform the same merge on plain numpy state dicts (e.g. to
feed MegatronLayerPolicy from multi-rank Megatron checkpoints) and the
inverse split (to emit TP-sharded dicts for torch consumers). Our own
checkpoints never need this: they store whole (logical) leaves.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Sequence

import numpy as np

# classification by megatron naming (reference MegatronSDLoader.merge_state_dict)
COLUMN_PARALLEL_PATTERNS = (  # concat on torch dim 0 (output features)
    r"attention\.query_key_value\.weight$",
    r"attention\.query_key_value\.bias$",
    r"mlp\.dense_h_to_4h\.weight$",
    r"mlp\.dense_h_to_4h\.bias$",
)
ROW_PARALLEL_PATTERNS = (  # concat on torch dim 1 (input features)
    r"attention\.dense\.weight$",
    r"mlp\.dense_4h_to_h\.weight$",
)
VOCAB_PARALLEL_PATTERNS = (r"word_embeddings\.weight$",)


def _axis_for(key: str) -> int | None:
    for pat in COLUMN_PARALLEL_PATTERNS + VOCAB_PARALLEL_PATTERNS:
        if re.search(pat, key):
            return 0
    for pat in ROW_PARALLEL_PATTERNS:
        if re.search(pat, key):
            return 1
    return None  # replicated (layernorms, biases of row-parallel, positions)


def merge_tp_state_dicts(shards: Sequence[Dict[str, Any]]) -> Dict[str, np.ndarray]:
    """Merge TP-rank state dicts into the full model (MegatronSDLoader merge)."""
    assert shards, "no shards"
    out: Dict[str, np.ndarray] = {}
    for key in shards[0]:
        parts = [np.asarray(sd[key]) for sd in shards]
        axis = _axis_for(key)
        if axis is None or parts[0].ndim == 0:
            out[key] = parts[0]
        elif axis < parts[0].ndim:
            out[key] = np.concatenate(parts, axis=axis)
        else:  # 1-D tensor classified as row-parallel weight: replicated bias
            out[key] = parts[0]
    return out


def split_tp_state_dict(sd: Dict[str, Any], tp: int) -> List[Dict[str, np.ndarray]]:
    """Inverse: split a full state dict into ``tp`` Megatron-style shards."""
    shards: List[Dict[str, np.ndarray]] = [dict() for _ in range(tp)]
    for key, val in sd.items():
        arr = np.asarray(val)
        axis = _axis_for(key)
        if axis is None or arr.ndim == 0 or axis >= arr.ndim or arr.shape[axis] % tp:
            for s in shards:
                s[key] = arr
        else:
            for r, piece in enumerate(np.split(arr, tp, axis=axis)):
                shards[r][key] = piece
    return shards


def reshape_tp(shards: Sequence[Dict[str, Any]], new_tp: int) -> List[Dict[str, np.ndarray]]:
    """old-TP shards → new-TP shards (reshape_meg_2d_parallel analog for the
    TP axis; dp reshape is a no-op for model weights)."""
    return split_tp_state_dict(merge_tp_state_dicts(shards), new_tp)


# ---------------------------------------------------------------------------
# Pipeline (layer) dimension + full 2D tp×pp regrid.
#
# Analog of reference ``checkpoint/reshape_meg_2d.py:75``
# (reshape_meg_2d_parallel) and ``reshape_3d_utils.py:12`` (model_3d_desc).
# The reference builds a RANK map (which old ranks' files feed each new rank)
# and only supports shrinking either degree; since our shards are plain
# numpy dicts we regrid the DATA instead — merge to the full logical model,
# then split to any target grid, growing or shrinking both axes.
# ---------------------------------------------------------------------------

_LAYER_RE = re.compile(r"^(.*?)layers\.(\d+)\.(.+)$")

# non-layer tensors and the pipeline stage that owns them (Megatron layout:
# embeddings enter on the first stage, final norm/head leave on the last)
FIRST_STAGE_PATTERNS = (r"word_embeddings", r"position_embeddings", r"^embedding\.")
LAST_STAGE_PATTERNS = (r"final_layernorm", r"lm_head", r"output_layer")


def _stage_for_extra(key: str, pp: int) -> int:
    for pat in LAST_STAGE_PATTERNS:
        if re.search(pat, key):
            return pp - 1
    for pat in FIRST_STAGE_PATTERNS:
        if re.search(pat, key):
            return 0
    return 0  # unknown extras default to the first stage too


def _partition(n: int, parts: int) -> List[int]:
    """Per-part counts, remainder spread over the leading parts (the
    reference's partition_data contract, reshape_utils.py)."""
    base, rem = divmod(n, parts)
    return [base + (1 if i < rem else 0) for i in range(parts)]


def merge_pp_state_dicts(stage_dicts: Sequence[Dict[str, Any]]) -> Dict[str, np.ndarray]:
    """PP-stage state dicts (locally-numbered ``layers.N.``) → one dict with
    global layer numbering; stage-owned extras pass through."""
    out: Dict[str, np.ndarray] = {}
    offset = 0
    for sd in stage_dicts:
        local_max = -1
        for key, val in sd.items():
            m = _LAYER_RE.match(key)
            if m:
                n = int(m.group(2))
                local_max = max(local_max, n)
                out[f"{m.group(1)}layers.{n + offset}.{m.group(3)}"] = np.asarray(val)
            else:
                out[key] = np.asarray(val)
        offset += local_max + 1
    return out


def split_pp_state_dict(sd: Dict[str, Any], pp: int) -> List[Dict[str, np.ndarray]]:
    """Full dict → ``pp`` stage dicts with local layer numbering."""
    n_layers = 0
    for key in sd:
        m = _LAYER_RE.match(key)
        if m:
            n_layers = max(n_layers, int(m.group(2)) + 1)
    counts = _partition(n_layers, pp)
    starts = np.cumsum([0] + counts)
    stage_of = np.searchsorted(starts[1:], np.arange(n_layers), side="right")
    stages: List[Dict[str, np.ndarray]] = [dict() for _ in range(pp)]
    for key, val in sd.items():
        m = _LAYER_RE.match(key)
        if m:
            n = int(m.group(2))
            s = int(stage_of[n])
            local = n - int(starts[s])
            stages[s][f"{m.group(1)}layers.{local}.{m.group(3)}"] = np.asarray(val)
        else:
            stages[_stage_for_extra(key, pp)][key] = np.asarray(val)
    return stages


def reshape_2d(
    grid: Sequence[Sequence[Dict[str, Any]]], new_tp: int, new_pp: int
) -> List[List[Dict[str, np.ndarray]]]:
    """``grid[pp][tp]`` shards → ``[new_pp][new_tp]`` shards, regridding
    both dimensions through the full logical model (tp merge per stage →
    pp merge → pp split → tp split per stage). Unlike the reference map,
    degrees may grow or shrink."""
    full = merge_pp_state_dicts([merge_tp_state_dicts(row) for row in grid])
    return [split_tp_state_dict(s, new_tp) for s in split_pp_state_dict(full, new_pp)]
