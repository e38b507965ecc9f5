"""Weight-only int8 engines in the port against the JAX package's on the
CPU (gpt2-tiny, the same numpy weights): ``init_inference(dtype="int8")``
(1 group) and ``quantization_setting`` 4 give ``generate`` and served
greedy streams token-identical to the JAX engine's, with int8 KV pages on
and off. Both packages quantize the same fp32 weights to the same codes
(``test_torch_int8_weights.py``) and compute in bf16; the streams are held
token for token."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deepspeed_tpu_torch as dtt
from deepspeed_tpu.inference.engine import InferenceEngine as JaxInferenceEngine
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.utils.weights import params_from_numpy
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

VOCAB = 512
SERVING_CFG = {"max_slots": 4, "page_size": 4, "num_pages": 64, "max_prompt_len": 12,
               "max_new_tokens": 8}


@pytest.fixture(scope="module")
def tree():
    cfg = jgpt2.get_config("gpt2-tiny")
    return jax.tree.map(np.asarray, jgpt2.init_params(cfg, jax.random.PRNGKey(0)))


def _engines(tree, **kw):
    cfg = jgpt2.get_config("gpt2-tiny")
    conf = kw.pop("config", None)
    j = JaxInferenceEngine(jgpt2.make_module(cfg), params=jax.tree.map(jnp.asarray, tree),
                           config=None if conf is None else dict(conf), **kw)
    t = dtt.init_inference("gpt2-tiny", params=params_from_numpy(tree, "cpu"), device="cpu",
                           config=None if conf is None else dict(conf), **kw)
    assert j.quantized and t.quantized
    return j, t


SETTINGS = {
    "dtype int8": dict(dtype="int8"),
    "quantization_setting 4": dict(dtype="bf16", config={"quantization_setting": 4}),
}


@pytest.fixture(scope="module")
def engines(tree):
    """(JAX engine, port engine) per setting, built once (the JAX package
    quantizes eagerly)."""
    cache = {}

    def get(setting):
        if setting not in cache:
            cache[setting] = _engines(tree, **SETTINGS[setting])
        return cache[setting]
    return get


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_int8_generate_tokens_equal_jax(engines, setting):
    j, t = engines(setting)
    ids = np.random.RandomState(13).randint(0, VOCAB, (4, 9)).astype(np.int32)
    np.testing.assert_array_equal(t.generate(ids, max_new_tokens=8),
                                  np.asarray(j.generate(ids, max_new_tokens=8)))


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("setting", list(SETTINGS))
def test_int8_served_streams_equal_jax(engines, setting, kv):
    j, t = engines(setting)
    conf = dict(SERVING_CFG, kv_cache_dtype=kv)
    rs = np.random.RandomState(11)
    specs = [(rs.randint(0, VOCAB, (int(rs.randint(1, 13)),)).astype(np.int32),
              int(rs.randint(1, 9))) for _ in range(8)]
    jsrv, tsrv = j.serve(conf), t.serve(conf)
    jr = [jsrv.submit(p, max_new_tokens=n, seed=i) for i, (p, n) in enumerate(specs)]
    tr = [tsrv.submit(p, max_new_tokens=n, seed=i) for i, (p, n) in enumerate(specs)]
    jsrv.run()
    tsrv.run()
    tsrv.check_no_leaks()
    assert [r.tokens for r in tr] == [list(r.tokens) for r in jr]
    assert all(len(r.tokens) == n for r, (_, n) in zip(tr, specs))
