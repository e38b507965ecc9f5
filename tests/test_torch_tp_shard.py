"""The port's tensor-parallel weight mapping against the JAX package's, on
the CPU: ``module_inject.tp_shard.permute_qkv_for_tp`` bit for bit at tp 1,
2 and 4 on ``[L, E, 3E]`` and ``[E, 3E]``; the serving spec table and the
spec tree a placement resolves from it (first match wins) against JAX's
``Placement.param_spec_tree``; each rank's ``local_slice`` of the permuted
gpt2-tiny tree against JAX's ``NamedSharding`` shard of the same leaf on a
tp mesh of the CPU devices; the per-rank model config and its error; a
rank's ``ProgramSet`` geometry (local heads, pool and scales bytes, the
handoff payload's dims, the pool's shard shape) against JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.module_inject import tp_shard as jtp
from deepspeed_tpu.serving import placement as jplacement
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.module_inject import (
    local_slice,
    permute_qkv_for_tp,
    tp_shard_serving_params,
)
from deepspeed_tpu_torch.serving import placement as tplacement
from deepspeed_tpu_torch.utils.weights import params_from_numpy

from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def tree():
    cfg = jgpt2.get_config("gpt2-tiny")
    return jax.tree.map(np.asarray, jgpt2.init_params(cfg, jax.random.PRNGKey(0)))


@pytest.mark.parametrize("lead", [(3, 24), (24,)], ids=["LE3E", "E3E"])
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_permute_matches_jax(tp, lead):
    rs = np.random.RandomState(tp)
    w = rs.standard_normal(lead + (72,)).astype(np.float32)
    b = rs.standard_normal(lead[:-1] + (72,)).astype(np.float32)
    jw, jb = jtp.permute_qkv_for_tp(jnp.asarray(w), jnp.asarray(b), tp)
    tw, tb = permute_qkv_for_tp(torch.from_numpy(w), torch.from_numpy(b), tp)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    with pytest.raises(ValueError, match="not divisible"):
        permute_qkv_for_tp(torch.zeros(4, 70), torch.zeros(70), 2)


def test_spec_table_and_tree_match_jax(tree):
    assert tplacement.GPT2_SERVING_RULES == jplacement.GPT2_SERVING_RULES
    jplc = jplacement.Placement("t", jax.devices()[:2], 2)
    want = jplc.param_spec_tree(tree)
    tplc = tplacement.Placement("t", [0, 1], 2)
    got = tplc.param_spec_tree(tree)
    flat_w = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    assert len(flat_w) == 16
    for kp, spec in flat_w:
        node = got
        for k in kp:
            node = node[k.key]
        assert node == tuple(spec), (kp, node, spec)
        path = "/".join(str(k.key) for k in kp)
        assert tplc.spec_for(path) == tuple(jplc.spec_for(path))


@pytest.mark.parametrize("tp", [2, 4])
def test_local_slices_match_jax_shards(tree, tp):
    """Rank r's slice of the permuted tree is JAX's shard of device r."""
    jplc = jplacement.Placement("t", jax.devices()[:tp], tp)
    jsharded = jplc.shard_params(jax.tree.map(jnp.asarray, tree))
    tplc = tplacement.Placement("t", list(range(tp)), tp)
    permuted = tp_shard_serving_params(params_from_numpy(tree, "cpu"), tp)
    specs = tplc.param_spec_tree(permuted)
    n = 0
    for kp, leaf in jax.tree_util.tree_flatten_with_path(jsharded)[0]:
        x, spec = permuted, specs
        for k in kp:
            x, spec = x[k.key], spec[k.key]
        shards = sorted(leaf.addressable_shards, key=lambda s: s.device.id)
        for r in range(tp):
            np.testing.assert_array_equal(local_slice(x, spec, r, tp).numpy(),
                                          np.asarray(shards[r].data), err_msg=str(kp))
            n += 1
    assert n == 16 * tp


def test_local_model_config_and_tp1_identity(tree):
    cfg = tgpt2.get_config("gpt2-tiny")
    jcfg = jgpt2.get_config("gpt2-tiny")
    for tp in (1, 2, 4):
        got = tplacement.Placement("t", list(range(tp)), tp).local_model_config(cfg)
        want = jplacement.Placement("t", jax.devices()[:tp], tp).local_model_config(jcfg)
        assert (got.n_embd, got.n_head, got.head_dim) == (want.n_embd, want.n_head,
                                                          want.head_dim)
    with pytest.raises(ValueError, match="not divisible by tp=3"):
        tplacement.Placement("t", [0, 1, 2], 3).local_model_config(cfg)
    with pytest.raises(ValueError, match="not divisible by tp=3"):
        jplacement.Placement("t", jax.devices()[:3], 3).local_model_config(jcfg)
    params = params_from_numpy(tree, "cpu")
    assert tp_shard_serving_params(params, 1) is params
    one = tplacement.Placement("t", [0], 1).shard_params(params)
    assert torch.equal(one["blocks"]["attn"]["c_attn_w"], params["blocks"]["attn"]["c_attn_w"])
    assert tplacement.Placement("t", [0, 1], 2).kv_heads(4, 1) == (2, 4)


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_program_set_geometry_matches_jax(tree, tp, dtype):
    """A rank's ProgramSet (here rank 0 of the placement) against JAX's:
    local KV heads, per-device pool and scales bytes, the handoff payload's
    per-device dims, and this rank's pool shape = JAX's shard shape."""
    jcfg, tcfg = jgpt2.get_config("gpt2-tiny"), tgpt2.get_config("gpt2-tiny")
    jdt = {"float32": jnp.float32, "int8": jnp.int8}[dtype]
    tdt = {"float32": torch.float32, "int8": torch.int8}[dtype]
    jps = jplacement.ProgramSet(jplacement.Placement("t", jax.devices()[:tp], tp), jcfg, 16, 4,
                                jdt, jax.tree.map(jnp.asarray, tree))
    tps = tplacement.ProgramSet(tplacement.Placement("t", list(range(tp)), tp), tcfg, 16, 4,
                                tdt, params_from_numpy(tree, "cpu"))
    assert tps.local_kv_heads() == jps.local_kv_heads()
    assert tps.local_pool_bytes() == jps.local_pool_bytes()
    assert tps.local_scales_bytes() == jps.local_scales_bytes()
    assert tps.packed_dims(3) == jps.packed_dims(3)
    assert tuple(tps.k_pool.shape) == tuple(jps.k_pool.sharding.shard_shape(jps.k_pool.shape))
    assert tps.quantized == jps.quantized
