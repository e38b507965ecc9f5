"""The port's layer pieces against the JAX package's on the same inputs:
layer norm, the dense MLP, the top-k / top-p masks and greedy sampling.
Tolerance 1e-6 (fp32 on the CPU); argmax exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.ops import layer_norm as jln
from deepspeed_tpu.ops import sampling as jsamp
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops import layer_norm as tln
from deepspeed_tpu_torch.ops import sampling as tsamp
from deepspeed_tpu_torch.utils.weights import params_from_numpy

TOL = dict(atol=1e-6, rtol=1e-6)


def test_layer_norm():
    rs = np.random.RandomState(0)
    x = (rs.randn(3, 5, 64) * 3 + 1).astype(np.float32)
    scale = rs.randn(64).astype(np.float32)
    bias = rs.randn(64).astype(np.float32)
    ref = jln.layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 1e-5)
    got = tln.layer_norm(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_layer_norm_keeps_dtype_with_fp32_statistics():
    x = torch.randn(2, 64, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    y = tln.layer_norm(x, torch.ones(64), torch.zeros(64), 1e-5)
    assert y.dtype == torch.bfloat16


def test_dense_mlp():
    cfg = jgpt2.get_config("gpt2-tiny")
    params = jax.tree.map(np.asarray, jgpt2.init_params(cfg, jax.random.PRNGKey(3)))
    lp = {k: v[1] for k, v in params["blocks"]["mlp"].items()}
    h = np.random.RandomState(1).randn(2, 3, cfg.n_embd).astype(np.float32)
    ref, _aux = jgpt2._mlp(cfg, jax.tree.map(jnp.asarray, lp), jnp.asarray(h), False, None)
    got = tgpt2._mlp(tgpt2.get_config("gpt2-tiny"), params_from_numpy(lp, "cpu"),
                     torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def _both(fn_name, logits, *args):
    ref = getattr(jsamp, fn_name)(jnp.asarray(logits), *args)
    got = getattr(tsamp, fn_name)(torch.from_numpy(logits), *args)
    return np.asarray(ref), got.numpy()


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_top_k_mask_ties_go_to_the_lowest_index(k):
    logits = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, 0.5],
                       [2.0, 2.0, 2.0, 2.0, 2.0, 2.0]], np.float32)
    ref, got = _both("top_k_mask", logits, k)
    np.testing.assert_array_equal(got, ref)
    assert ((got > -1e29).sum(-1) == k).all()  # exactly k survive


def test_top_k_mask_random():
    logits = np.random.RandomState(2).randn(4, 50).astype(np.float32)
    ref, got = _both("top_k_mask", logits, 7)
    np.testing.assert_array_equal(got, ref)


def test_top_p_mask_exact_mass_does_not_leak_a_token():
    logits = np.log(np.array([[0.5, 0.3, 0.2]], np.float32))
    ref, got = _both("top_p_mask", logits, 0.8)
    np.testing.assert_allclose(got, ref, **TOL)
    assert (got > -1e29).sum() == 2


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_top_p_mask_random(p):
    logits = (np.random.RandomState(4).randn(3, 40) * 2).astype(np.float32)
    ref, got = _both("top_p_mask", logits, p)
    np.testing.assert_allclose(got, ref, **TOL)


def test_greedy_sample_is_argmax_first_index_on_ties():
    logits = np.random.RandomState(5).randn(6, 30).astype(np.float32)
    logits[0, [4, 9]] = 10.0  # a tie: the first index wins
    ref = jsamp.sample_logits(jnp.asarray(logits), jax.random.PRNGKey(0), 0.0)
    got = tsamp.sample_logits(torch.from_numpy(logits), None, 0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert int(got[0]) == 4


def test_sampled_draw_is_seeded_and_respects_the_masks():
    logits = torch.from_numpy(np.random.RandomState(6).randn(2, 30).astype(np.float32))
    draws = [
        tsamp.sample_logits(logits, torch.Generator().manual_seed(9), 0.8, 3, 1.0)
        for _ in range(2)
    ]
    assert torch.equal(draws[0], draws[1])
    top3 = torch.topk(logits, 3, dim=-1).indices
    for row in range(2):
        assert int(draws[0][row]) in top3[row].tolist()
