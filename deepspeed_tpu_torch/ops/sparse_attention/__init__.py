"""Block-sparse self-attention: sparsity patterns, the dispatcher and the
model-integration helpers (counterpart of ``deepspeed_tpu/ops/sparse_attention``)."""

from .sparse_attention_utils import (
    extend_position_embedding,
    pad_to_block_size,
    sparse_bert_module,
    unpad_sequence_output,
    update_tokenizer_model_max_length,
)
from .sparse_self_attention import SparseSelfAttention, sparse_attention
from .sparsity_config import (
    BigBirdSparsityConfig,
    BSLongformerSparsityConfig,
    DenseSparsityConfig,
    FixedSparsityConfig,
    SparsityConfig,
    VariableSparsityConfig,
    from_ds_config,
    layout_density,
    layout_to_dense_mask,
)

__all__ = [
    "BigBirdSparsityConfig",
    "BSLongformerSparsityConfig",
    "DenseSparsityConfig",
    "FixedSparsityConfig",
    "SparseSelfAttention",
    "SparsityConfig",
    "VariableSparsityConfig",
    "extend_position_embedding",
    "from_ds_config",
    "layout_density",
    "layout_to_dense_mask",
    "pad_to_block_size",
    "sparse_attention",
    "sparse_bert_module",
    "unpad_sequence_output",
    "update_tokenizer_model_max_length",
]
