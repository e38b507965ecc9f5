"""GPT-2 with a ``sparse_attention`` section trains in the port as in the JAX
package: gpt2-tiny, fp32 on the CPU, the same numpy parameters and batches,
a 5-step ``train_batch`` trajectory (AdamW, WarmupLR, clipping, gas 2)
against ``DeepSpeedEngine`` on a one-device mesh; the section's wiring
through ``get_config``, the typed config section and the engine accessor.

Tolerance 1e-5 (relative for losses, absolute for parameters), as in the
dense trajectory test: the two packages sum in different orders. Adam's eps
is 1e-6 here (the dense test's is 1e-8): at S 128 some weights get an
accumulated gradient near 1e-8, 1e-7 of the largest, whose last bits differ
between the packages (-1.67e-8 against -1.62e-8 for one c_proj_w element),
and Adam's first step divides such a gradient by its own magnitude plus eps,
so eps 1e-8 turns that roundoff into a 1.4e-5 parameter difference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dtt
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.runtime.engine import DeepSpeedEngine as JEngine
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops import block_sparse_attention as tbsa
from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig, layout_density
from deepspeed_tpu_torch.runtime.config import NotPortedError, SparseAttentionConfig
from deepspeed_tpu_torch.utils.weights import params_from_numpy, params_to_numpy

TOL = 1e-5
SECTION = {"mode": "fixed", "block": 16, "num_local_blocks": 2, "num_global_blocks": 1,
           "attention": "unidirectional"}
CONFIG = {
    "train_micro_batch_size_per_gpu": 2,
    "gradient_accumulation_steps": 2,
    "gradient_clipping": 1.0,
    "steps_per_print": 1000,
    "optimizer": {"type": "AdamW",
                  "params": {"lr": 3e-3, "betas": [0.9, 0.95], "eps": 1e-6, "weight_decay": 0.1}},
    "scheduler": {"type": "WarmupLR",
                  "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 3e-3, "warmup_num_steps": 4}},
}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree, np.float32)}


def test_sparse_section_builds_the_sparse_model():
    cfg = tgpt2.get_config("gpt2-tiny", sparse_attention=SECTION)
    jcfg = jgpt2.get_config("gpt2-tiny", sparse_attention=SECTION)
    assert cfg.attn_impl == jcfg.attn_impl == "sparse"
    assert isinstance(cfg.sparsity, FixedSparsityConfig)
    assert np.array_equal(cfg.sparsity.make_layout(128), jcfg.sparsity.make_layout(128))
    assert layout_density(cfg.sparsity.make_layout(128)) < 1.0
    typed = dtt.DeepSpeedConfig.from_dict(dict(CONFIG, sparse_attention=SECTION)).sparse_attention
    assert isinstance(typed, SparseAttentionConfig) and typed.num_local_blocks == 2
    cfg2 = tgpt2.get_config("gpt2-tiny", sparse_attention=typed)
    assert vars(cfg2.sparsity) == vars(cfg.sparsity)
    # an explicit attn_impl wins over the section
    cfg3 = tgpt2.get_config("gpt2-tiny", attn_impl="jnp", sparse_attention=SECTION)
    assert cfg3.attn_impl == "jnp" and cfg3.sparsity is not None


def test_engine_exposes_the_section():
    eng, *_ = dtt.initialize(model=tgpt2.make_module(tgpt2.get_config("gpt2-tiny")),
                             config=dict(CONFIG, sparse_attention=SECTION), device="cpu")
    assert eng.sparse_attention_config().mode == "fixed"
    eng2, *_ = dtt.initialize(model=tgpt2.make_module(tgpt2.get_config("gpt2-tiny")),
                              config=dict(CONFIG), device="cpu")
    assert eng2.sparse_attention_config() is None


def test_unported_attention_impls_still_raise():
    """The sequence-parallel impls are ported (``parallel/sequence.py``):
    they configure the model, and an explicit ``attn_impl`` wins over a
    ``sparse_attention`` section as before. The moe section still
    raises."""
    for impl in ("ring", "ring_flash", "ulysses"):
        cfg = tgpt2.get_config("gpt2-tiny", attn_impl=impl, sparse_attention=SECTION)
        assert cfg.attn_impl == impl
    with pytest.raises(NotPortedError):
        dtt.DeepSpeedConfig.from_dict(dict(CONFIG, moe={"enabled": True}))


def test_sparse_train_batch_trajectory_matches_jax_engine(mesh_single):
    jcfg = jgpt2.get_config("gpt2-tiny", sparse_attention=SECTION)
    params = jax.tree.map(np.asarray, jgpt2.init_params(jcfg, jax.random.PRNGKey(0)))
    rs = np.random.RandomState(3)
    batches = [{"input_ids": rs.randint(0, 512, (4, 128)).astype(np.int32)} for _ in range(5)]
    jeng = JEngine(jgpt2.make_module(jcfg), dict(CONFIG), mesh=mesh_single,
                   params=jax.tree.map(jnp.asarray, params), seed=0)
    teng, _, _, _ = dtt.initialize(
        model=tgpt2.make_module(tgpt2.get_config("gpt2-tiny", sparse_attention=SECTION)),
        config=dict(CONFIG), model_parameters=params_from_numpy(params, "cpu"), device="cpu")
    dense_before = tbsa.DENSE_CALLS["sparse_attention_dense"]
    for i, b in enumerate(batches):
        mj, mt = jeng.train_batch(b), teng.train_batch(b)
        lj, lt = float(mj["loss"]), float(mt["loss"])
        assert abs(lt - lj) <= TOL * abs(lj), (i, lt, lj)
        assert abs(float(mt["grad_norm"]) - float(mj["grad_norm"])) <= TOL * float(mj["grad_norm"])
        assert mt["global_step"] == int(mj["global_step"]) == i + 1
    assert tbsa.DENSE_CALLS["sparse_attention_dense"] == dense_before
    pj = _flat(jax.tree.map(np.asarray, jeng.state.params))
    pt = _flat(params_to_numpy(teng.params))
    assert pj.keys() == pt.keys()
    for name in pj:
        np.testing.assert_allclose(pt[name], pj[name], atol=TOL, rtol=0, err_msg=name)


def test_sparse_differs_from_dense_and_bf16_loss_falls():
    """The layout matters (the sparse loss is not the dense one at S 128),
    and bf16 training on the sparse model makes progress."""
    params = params_to_numpy(tgpt2.init_params(
        tgpt2.get_config("gpt2-tiny"), torch.Generator().manual_seed(1)))
    batch = {"input_ids": np.random.RandomState(4).randint(0, 512, (4, 128)).astype(np.int32)}
    losses = {}
    for name, cfg in (("dense", tgpt2.get_config("gpt2-tiny")),
                      ("sparse", tgpt2.get_config("gpt2-tiny", sparse_attention=SECTION))):
        eng, *_ = dtt.initialize(model=tgpt2.make_module(cfg),
                                 config=dict(CONFIG, bf16={"enabled": True}),
                                 model_parameters=params_from_numpy(params, "cpu"), device="cpu")
        losses[name] = [float(eng.train_batch(batch)["loss"]) for _ in range(6)]
    assert losses["sparse"][0] != losses["dense"][0]
    assert all(np.isfinite(losses["sparse"])) and losses["sparse"][-1] < losses["sparse"][0] - 0.1
