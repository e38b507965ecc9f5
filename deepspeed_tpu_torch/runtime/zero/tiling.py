"""TiledLinear: a huge linear split into tiles, each its own leaf
(counterpart of ``deepspeed_tpu/runtime/zero/tiling.py``, the reference's
``runtime/zero/tiling.py`` TiledLinear:27). Each tile is a separate leaf of
the parameter tree, so ZeRO shards and gathers it on its own; the forward
contracts the tiles with partial sums."""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np
import torch

PyTree = Any


def split_dim(total: int, parts: int) -> List[int]:
    """Near-uniform split sizes (reference partition_uniform semantics)."""
    base, rem = divmod(total, parts)
    return [base + (1 if i < rem else 0) for i in range(parts)]


def init_tiled_linear(
    generator: torch.Generator,
    in_features: int,
    out_features: int,
    in_splits: int = 1,
    out_splits: int = 1,
    use_bias: bool = True,
    std: float = 0.02,
    dtype=torch.float32,
) -> PyTree:
    """Param tree ``{"tiles": [[w_rc ...] per row], "bias": [b_c ...]}``
    with ``w_rc [in_r, out_c]``, drawn on the generator's device."""
    in_sizes = split_dim(in_features, in_splits)
    out_sizes = split_dim(out_features, out_splits)
    dev = generator.device
    tiles = [[(torch.randn((in_sizes[r], out_sizes[c]), generator=generator, device=dev) * std)
              .to(dtype) for c in range(out_splits)] for r in range(in_splits)]
    params = {"tiles": tiles}
    if use_bias:
        params["bias"] = [torch.zeros((s,), dtype=dtype, device=dev) for s in out_sizes]
    return params


def tiled_linear(params: PyTree, x: torch.Tensor) -> torch.Tensor:
    """``y = x @ W + b`` over the tile grid: x split on its input dim, a
    partial sum per output tile, the tiles concatenated."""
    tiles = params["tiles"]
    in_splits = len(tiles)
    out_splits = len(tiles[0])
    in_sizes = [tiles[r][0].shape[0] for r in range(in_splits)]
    xs = torch.split(x, in_sizes, dim=-1) if in_splits > 1 else [x]
    outs = []
    for c in range(out_splits):
        acc = None
        for r in range(in_splits):
            part = xs[r] @ tiles[r][c]
            acc = part if acc is None else acc + part
        if "bias" in params:
            acc = acc + params["bias"][c]
        outs.append(acc)
    return torch.cat(outs, dim=-1)


class TiledLinear:
    """Class surface mirroring the reference; holds config, not state."""

    def __init__(self, in_features: int, out_features: int,
                 in_splits: int = 1, out_splits: int = 1, use_bias: bool = True):
        self.in_features = in_features
        self.out_features = out_features
        self.in_splits = in_splits
        self.out_splits = out_splits
        self.use_bias = use_bias

    def init(self, generator: torch.Generator, dtype=torch.float32) -> PyTree:
        return init_tiled_linear(generator, self.in_features, self.out_features,
                                 self.in_splits, self.out_splits, self.use_bias, dtype=dtype)

    def __call__(self, params: PyTree, x: torch.Tensor) -> torch.Tensor:
        return tiled_linear(params, x)

    @staticmethod
    def from_dense(w: torch.Tensor, b: Optional[torch.Tensor], in_splits: int,
                   out_splits: int) -> PyTree:
        """An existing dense ``[in, out]`` weight copied into tiles
        (reference copy_params_from)."""
        r_ofs = np.cumsum([0] + split_dim(w.shape[0], in_splits))
        c_ofs = np.cumsum([0] + split_dim(w.shape[1], out_splits))
        tiles = [[w[r_ofs[r]:r_ofs[r + 1], c_ofs[c]:c_ofs[c + 1]] for c in range(out_splits)]
                 for r in range(in_splits)]
        params: PyTree = {"tiles": tiles}
        if b is not None:
            params["bias"] = [b[c_ofs[c]:c_ofs[c + 1]] for c in range(out_splits)]
        return params
