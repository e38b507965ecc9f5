"""ZeRO cases of the port against the JAX package's on the CPU, beside
``test_torch_zero.py`` (whose helpers, bounds and config they share):
``DeepSpeedEngine`` on ``MeshSpec(dp=2)`` against the port on 2 gloo
ranks (one spawn) for bert-tiny with LAMB at stage 2, its MLM masks
counting differently on the two ranks' rows; gpt2-tiny with dropout 0.1
(each rank draws its slice of JAX's draw over the global batch); fp16 with
an inf in one rank's rows (both ranks skip; JAX's loss-scale trajectory)
and with an overflow in one element of one rank's shard only (both ranks
skip); bf16 at stage 3, which reduces in f32 as stage 0 does; and stage 3
at dp 4 (a spawn of 4 ranks)."""

import numpy as np
import pytest

from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu.models import gpt2 as jgpt2

from deepspeed_tpu_torch.utils.weights import tree_leaves

from tests import torch_dist
from tests.test_torch_zero import (
    CONFIG,
    DP4,
    FP16,
    LAMB,
    LOSS,
    _batches,
    _bert_batches,
    _bert_params,
    _check_master,
    _check_trajectory,
    _fp16_batches,
    _gpt2_params,
    _jax_run,
    _on_dp,
    _same_on_every_rank,
    _stage,
    check_gather_full,
    check_plan,
    check_shards,
)
from tests.torch_threads import one_torch_thread  # noqa: F401


# bf16 with one micro-batch a step and no clipping: the ranks' gradients
# meet in one f32 addition at every stage
# the two packages' bf16 forwards differ in bf16's last bits: 1.9e-5
# relative on gpt2-tiny's loss at step 0, where the weights are equal
BF16_LOSS = dict(rtol=1e-4, atol=0)
BF16 = dict(CONFIG, bf16={"enabled": True}, gradient_clipping=0.0,
            train_micro_batch_size_per_gpu=4, gradient_accumulation_steps=1)
# an overflow at the last element of this leaf, on the last rank, at step 1
POISON = (("blocks", "mlp", "c_fc_w"), 1)


@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    p, b = _gpt2_params(), _batches(3, 8, 3)
    cases = [("bert_lamb", "bert", LAMB, _bert_params(), _bert_batches(3, 4), {}),
             ("gpt2_dropout", "gpt2_dropout", _stage(CONFIG, 1), p, b, {}),
             ("gpt2_s1", "gpt2", _stage(CONFIG, 1), p, b, {}),
             ("gpt2_fp16", "gpt2", FP16, p, _fp16_batches(5), {})]
    cases += [(f"gpt2_fp16_poison_s{s}", "gpt2", _stage(FP16, s), p, b, {"poison": POISON})
              for s in (2, 3)]
    cases += [(f"gpt2_bf16_s{s}", "gpt2", _stage(BF16, s), p, b, {}) for s in (0, 3)]
    return torch_dist.start(2, "train", (_on_dp(cases),), tmp_path_factory.mktemp("cases2"))


@pytest.fixture(scope="module")
def dp4(tmp_path_factory):
    case = ("gpt2_s3", "gpt2", DP4, _gpt2_params(), _batches(3, 8, 3), {})
    return torch_dist.start(4, "train", (_on_dp([case]),), tmp_path_factory.mktemp("cases4"))


def test_bert_lamb_stage2_per_rank_mlm_counts(dp2, devices):
    """The MLM loss divides by the GLOBAL masked count (3 on one rank's
    rows, 9 on the other's), and LAMB's trust ratios take the whole
    tensors' norms (the shards' sums all-reduced between its stages)."""
    jeng, jm = _jax_run(jbert.make_module(jbert.get_config("bert-tiny", pretraining=True)),
                        LAMB, _bert_params(), _bert_batches(3, 4), 2, devices)
    _check_trajectory(dp2[0]["bert_lamb"], jm)
    _check_master(dp2[0]["bert_lamb"]["master"], jeng)
    _same_on_every_rank(dp2, "bert_lamb")


def test_gpt2_dropout_draws_jax_global_masks(dp2, devices):
    jeng, jm = _jax_run(jgpt2.make_module(jgpt2.get_config("gpt2-tiny", dropout=0.1)),
                        _stage(CONFIG, 1), _gpt2_params(), _batches(3, 8, 3), 2, devices)
    _check_trajectory(dp2[0]["gpt2_dropout"], jm)
    _check_master(dp2[0]["gpt2_dropout"]["master"], jeng)
    assert dp2[0]["gpt2_dropout"]["loss"] != dp2[0]["gpt2_s1"]["loss"]


def test_fp16_overflow_on_one_rank_skips_on_both(dp2, devices):
    """An inf in rank 1's rows: rank 1's loss and gradients go non-finite
    (and through stage 2's reduce-scatter every rank's shards), both ranks
    skip the step, and the scale follows JAX's."""
    jeng, jm = _jax_run(jgpt2.make_module(jgpt2.get_config("gpt2-tiny")), FP16, _gpt2_params(),
                        _fp16_batches(5), 2, devices)
    for r in dp2:
        res = r["gpt2_fp16"]
        assert res["loss_scale"] == jm["loss_scale"] == [256.0, 256.0, 128.0]
        assert res["skipped"] == [0, 1, 1] and jeng.skipped_steps == 1
        assert np.isnan(res["loss"][1]) and np.isnan(jm["loss"][1])
        np.testing.assert_allclose([res["loss"][0], res["loss"][2]],
                                   [jm["loss"][0], jm["loss"][2]], **LOSS)


@pytest.mark.parametrize("stage", [2, 3])
def test_fp16_overflow_in_one_shard_skips_on_both(stage, dp2):
    """An overflow in one element of a sharded gradient, in rank 1's shard
    only: rank 0's shards stay finite, and it skips all the same because
    the overflow flag is a MAX over dp; the ranks stay equal."""
    name = f"gpt2_fp16_poison_s{stage}"
    for r in dp2:
        res = r[name]
        assert res["poison_dim"] is not None
        assert res["skipped"] == [0, 1, 1] and res["loss_scale"] == [256.0, 256.0, 128.0]
        assert np.isfinite(res["loss"]).all()
    _same_on_every_rank(dp2, name)


def test_bf16_stage3_reduces_in_f32(dp2, devices):
    """bf16 at stage 3 reduce-scatters its gradients in grad_accum_dtype
    (f32), as stage 0 all-reduces them: with one micro-batch a step the two
    ranks' gradients meet in the same f32 addition, so stage 3 equals stage
    0 bit for bit (a bf16 reduce-scatter rounds the sums). Both hold JAX's
    bf16 run on a dp-2 mesh within BF16_LOSS."""
    s0, s3 = dp2[0]["gpt2_bf16_s0"], dp2[0]["gpt2_bf16_s3"]
    assert s3["loss"] == s0["loss"]
    for a, b in zip(tree_leaves(s3["master"]), tree_leaves(s0["master"])):
        np.testing.assert_array_equal(a, b)
    _same_on_every_rank(dp2, "gpt2_bf16_s3")
    jeng, jm = _jax_run(jgpt2.make_module(jgpt2.get_config("gpt2-tiny")), _stage(BF16, 3),
                        _gpt2_params(), _batches(3, 8, 3), 2, devices)
    np.testing.assert_allclose(s3["loss"], jm["loss"], **BF16_LOSS)


def test_stage3_dp4_matches_jax(dp4, devices):
    jeng, jm = _jax_run(jgpt2.make_module(jgpt2.get_config("gpt2-tiny")), DP4, _gpt2_params(),
                        _batches(3, 8, 3), 4, devices)
    _check_trajectory(dp4[0]["gpt2_s3"], jm)
    _check_master(dp4[0]["gpt2_s3"]["master"], jeng)
    _same_on_every_rank(dp4, "gpt2_s3")


def test_stage3_dp4_shards_and_plan(dp4, dp2):
    check_shards(dp4, "gpt2_s3", 3, 4)
    check_plan(dp4)
    check_plan(dp2)
    check_gather_full(dp4)
