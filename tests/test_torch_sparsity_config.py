"""The port's sparsity patterns against the JAX package's: every layout class
over modes, lengths, head counts and ``different_layout_per_head`` equal bit
for bit (``np.array_equal``), ``from_ds_config`` on dicts and on the typed
section (with the bigbird and variable defaults), the same constructor
errors, and ``layout_to_index_lists`` equal."""

import numpy as np
import pytest

from deepspeed_tpu.ops.pallas import block_sparse_attention as jbsa
from deepspeed_tpu.ops.sparse_attention import sparsity_config as jsc
from deepspeed_tpu.runtime.config import SparseAttentionConfig as JSection
from deepspeed_tpu_torch.ops import block_sparse_attention as tbsa
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as tsc
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig, SparseAttentionConfig

# class name, constructor kwargs (beyond num_heads)
CASES = [
    ("DenseSparsityConfig", dict(block=16)),
    ("FixedSparsityConfig", dict(block=16)),
    ("FixedSparsityConfig", dict(block=32, num_local_blocks=2, attention="unidirectional")),
    ("FixedSparsityConfig", dict(block=16, num_local_blocks=4, num_global_blocks=2,
                                 horizontal_global_attention=True)),
    ("FixedSparsityConfig", dict(block=16, different_layout_per_head=True, num_local_blocks=4,
                                 num_different_global_patterns=4)),
    ("FixedSparsityConfig", dict(block=64, num_local_blocks=4, attention="unidirectional",
                                 different_layout_per_head=True,
                                 num_different_global_patterns=2)),
    ("BSLongformerSparsityConfig", dict(block=16)),
    ("BSLongformerSparsityConfig", dict(block=16, num_sliding_window_blocks=5,
                                        global_block_indices=[0, 5],
                                        global_block_end_indices=[2, 7],
                                        attention="unidirectional")),
    ("BigBirdSparsityConfig", dict(block=16)),
    ("BigBirdSparsityConfig", dict(block=32, different_layout_per_head=True, num_random_blocks=3,
                                   num_global_blocks=2, seed=7)),
    ("BigBirdSparsityConfig", dict(block=16, attention="unidirectional", num_random_blocks=2)),
    ("VariableSparsityConfig", dict(block=16)),
    ("VariableSparsityConfig", dict(block=16, num_random_blocks=2, local_window_blocks=[1, 2, 3],
                                    global_block_indices=[0, 4], global_block_end_indices=[2, 6],
                                    horizontal_global_attention=True,
                                    different_layout_per_head=True, seed=3)),
    ("VariableSparsityConfig", dict(block=32, num_random_blocks=1, attention="unidirectional")),
]


@pytest.mark.parametrize("heads", [1, 4])
@pytest.mark.parametrize("seq_blocks", [1, 7, 16])
@pytest.mark.parametrize("name,kwargs", CASES, ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_layouts_equal_jax(name, kwargs, seq_blocks, heads):
    S = seq_blocks * kwargs["block"]
    lay_j = getattr(jsc, name)(num_heads=heads, **kwargs).make_layout(S)
    lay_t = getattr(tsc, name)(num_heads=heads, **kwargs).make_layout(S)
    assert lay_t.dtype == lay_j.dtype == np.bool_
    assert np.array_equal(lay_t, lay_j)


@pytest.mark.parametrize("name,kwargs", CASES[:9], ids=[c[0] for c in CASES[:9]])
def test_index_lists_equal_jax(name, kwargs):
    layout = getattr(tsc, name)(num_heads=4, **kwargs).make_layout(8 * kwargs["block"])
    for a, b in zip(tbsa.layout_to_index_lists(layout), jbsa.layout_to_index_lists(layout)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_helpers_equal_jax():
    layout = tsc.BigBirdSparsityConfig(num_heads=2, block=16).make_layout(128)
    assert np.array_equal(tsc.layout_to_dense_mask(layout, 16), jsc.layout_to_dense_mask(layout, 16))
    assert tsc.layout_density(layout) == jsc.layout_density(layout)


SECTIONS = [
    {},
    {"mode": "dense", "block": 32},
    {"mode": "fixed", "block": 16, "num_local_blocks": 2, "num_global_blocks": 1,
     "attention": "unidirectional"},
    {"mode": "FIXED", "different_layout_per_head": True, "num_different_global_patterns": 2},
    {"mode": "bigbird"},
    {"mode": "bigbird", "num_random_blocks": 0, "num_sliding_window_blocks": 5},
    {"mode": "bslongformer", "global_block_indices": [0, 3], "global_block_end_indices": [1, 5]},
    {"mode": "variable"},
    {"mode": "variable", "num_random_blocks": 2, "local_window_blocks": [2, 4],
     "horizontal_global_attention": True},
]


def _same(a, b):
    assert type(a).__name__ == type(b).__name__
    assert vars(a) == vars(b)
    assert np.array_equal(a.make_layout(8 * a.block), b.make_layout(8 * b.block))


@pytest.mark.parametrize("section", SECTIONS)
def test_from_ds_config_dict_and_typed_equal_jax(section):
    _same(tsc.from_ds_config(section, 4), jsc.from_ds_config(section, 4))
    typed_t = DeepSpeedConfig.from_dict({"train_batch_size": 1,
                                         "sparse_attention": section}).sparse_attention
    typed_j = JSection.from_dict(section)
    assert isinstance(typed_t, SparseAttentionConfig)
    _same(tsc.from_ds_config(typed_t, 4), jsc.from_ds_config(typed_j, 4))


def test_mode_specific_random_block_defaults():
    assert tsc.from_ds_config(SparseAttentionConfig(mode="bigbird"), 4).num_random_blocks == 1
    assert tsc.from_ds_config({"mode": "bigbird"}, 4).num_random_blocks == 1
    assert tsc.from_ds_config({"mode": "bigbird", "num_random_blocks": 0}, 4).num_random_blocks == 0
    assert tsc.from_ds_config(SparseAttentionConfig(mode="variable"), 4).num_random_blocks == 0


ERRORS = [
    ("FixedSparsityConfig", dict(attention="sideways")),
    ("FixedSparsityConfig", dict(attention="unidirectional", horizontal_global_attention=True)),
    ("FixedSparsityConfig", dict(num_different_global_patterns=2)),
    ("FixedSparsityConfig", dict(different_layout_per_head=True, num_local_blocks=4,
                                 num_global_blocks=2, num_different_global_patterns=3)),
]


@pytest.mark.parametrize("name,kwargs", ERRORS)
def test_constructor_errors_match_jax(name, kwargs):
    with pytest.raises(ValueError) as ej:
        getattr(jsc, name)(num_heads=4, **kwargs)
    with pytest.raises(ValueError) as et:
        getattr(tsc, name)(num_heads=4, **kwargs)
    assert str(et.value) == str(ej.value)


def test_layout_and_mode_errors_match_jax():
    for mod in (jsc, tsc):
        with pytest.raises(ValueError, match="not a multiple of block"):
            mod.FixedSparsityConfig(num_heads=2, block=16).make_layout(100)
        with pytest.raises(ValueError, match="unknown sparse_attention mode"):
            mod.from_ds_config({"mode": "nope"}, 4)
