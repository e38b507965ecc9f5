"""Sampled streams in the port against the JAX package on the CPU
(gpt2-tiny, fp32, the same numpy weights): ``InferenceEngine.generate`` at
temperature 0.8, top-k 50, top-p 0.95 for B 1 and B 4, and a sampled
serving suite (mixed seeds, prompt lengths and ``max_new_tokens``; chunked
prefill on and off), each token for token. The draws are JAX's: the same
keys (``PRNGKey(seed)``, ``split(fold_in(., 1), N - 1)``), the same
threefry bits; only ``log`` may differ by an ulp, which a token could feel
only at a near-tie of that size."""

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
SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.95)
SERVING_CFG = {"max_slots": 4, "page_size": 4, "num_pages": 96, "max_prompt_len": 16,
               "max_new_tokens": 10, "kv_cache_dtype": "float32", **SAMPLING}


@pytest.fixture(scope="module")
def tree():
    cfg = jgpt2.get_config("gpt2-tiny")
    return jax.tree.map(np.asarray, jgpt2.init_params(cfg, jax.random.PRNGKey(1)))


@pytest.fixture(scope="module")
def engines(tree):
    cfg = jgpt2.get_config("gpt2-tiny")
    j = JaxInferenceEngine(jgpt2.make_module(cfg), params=jax.tree.map(jnp.asarray, tree),
                           dtype=jnp.float32)
    t = dtt.init_inference("gpt2-tiny", params=params_from_numpy(tree, "cpu"),
                           dtype="fp32", device="cpu")
    return j, t


@pytest.mark.parametrize("B,S", [(1, 6), (4, 11)])
def test_sampled_generate_equals_jax(engines, B, S):
    j, t = engines
    ids = np.random.RandomState(B * 10 + S).randint(0, VOCAB, (B, S)).astype(np.int32)
    for seed in (0, 17, 2 ** 31 - 1):
        want = np.asarray(j.generate(ids, max_new_tokens=12, seed=seed, **SAMPLING))
        got = t.generate(ids, max_new_tokens=12, seed=seed, **SAMPLING)
        np.testing.assert_array_equal(got, want, err_msg=f"seed {seed}")


def _suite(seed):
    rs = np.random.RandomState(seed)
    specs = []
    for i in range(10):
        plen = int(rs.randint(1, 17))
        specs.append((rs.randint(0, VOCAB, (plen,)).astype(np.int32), int(rs.randint(1, 11)),
                      int(rs.randint(0, 2 ** 31 - 1))))
    return specs


FEATURES = {
    "default": {},
    "chunked": {"prefill_chunk_tokens": 4},
}


@pytest.mark.parametrize("features", list(FEATURES))
def test_sampled_serving_suite_equals_jax(engines, features):
    j, t = engines
    conf = dict(SERVING_CFG, **FEATURES[features])
    specs = _suite(7)
    jsrv, tsrv = j.serve(conf), t.serve(conf)
    jr = [jsrv.submit(p, max_new_tokens=n, seed=s) for p, n, s in specs]
    tr = [tsrv.submit(p, max_new_tokens=n, seed=s) for p, n, s in specs]
    jsrv.run()
    tsrv.run()
    tsrv.check_no_leaks()
    assert [r.tokens for r in tr] == [list(r.tokens) for r in jr]
    assert all(len(r.tokens) == n for r, (_, n, _) in zip(tr, specs))
    if FEATURES[features]:
        assert tsrv.stats()["chunk_prefills"] > 0
