"""Parameter trees cross between the JAX package and the PyTorch port
unchanged: numpy → torch → numpy is exact, layout and all."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.utils.weights import params_from_numpy, params_to_numpy


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("pad", [1, 128])
def test_round_trip_is_exact(pad):
    cfg = jgpt2.get_config("gpt2-tiny", pad_vocab_multiple=pad)
    tree = jax.tree.map(np.asarray, jgpt2.init_params(cfg, jax.random.PRNGKey(0)))
    params = params_from_numpy(tree, "cpu")
    back = params_to_numpy(params)
    a, b = list(_leaves(tree)), list(_leaves(back))
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)
    assert params["wte"].shape == (cfg.padded_vocab_size, cfg.n_embd)


def test_bfloat16_leaves_cross_bit_exact():
    x = np.asarray(jnp.asarray(np.random.RandomState(0).randn(4, 8), jnp.bfloat16))
    t = params_from_numpy({"w": x}, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(params_to_numpy({"w": t})["w"], x.astype(np.float32))


@pytest.mark.parametrize("pad", [1, 128])
def test_init_params_matches_the_jax_layout(pad):
    """Same tree, same shapes, the projection std scaled by 1/sqrt(2L),
    zero padded vocab rows."""
    jcfg = jgpt2.get_config("gpt2-tiny", pad_vocab_multiple=pad)
    tcfg = tgpt2.get_config("gpt2-tiny", pad_vocab_multiple=pad)
    ref = jax.tree.map(np.asarray, jgpt2.init_params(jcfg, jax.random.PRNGKey(0)))
    got = params_to_numpy(tgpt2.init_params(tcfg, torch.Generator().manual_seed(0)))
    for (k, x), (k2, y) in zip(_leaves(ref), _leaves(got)):
        assert k == k2 and x.shape == y.shape and x.dtype == y.dtype, k
    assert not got["wte"][tcfg.vocab_size:].any()
    L = tcfg.n_layer
    big = tgpt2.init_params(
        tgpt2.get_config("gpt2-tiny", n_embd=256, n_head=4),
        torch.Generator().manual_seed(1),
    )
    std_attn = float(big["blocks"]["attn"]["c_attn_w"].std())
    std_proj = float(big["blocks"]["attn"]["c_proj_w"].std())
    assert abs(std_attn - 0.02) < 1e-3
    assert abs(std_proj - 0.02 / np.sqrt(2 * L)) < 1e-3
