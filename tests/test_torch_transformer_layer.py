"""The port's standalone encoder layer (``ops/transformer.py``) on the
CPU, held against ``deepspeed_tpu.ops.transformer``: the same numpy
parameters and inputs through both, pre- and post-LayerNorm, with and
without a padding mask, fp32 within 2e-5; in training with dropout the
masks are JAX's (the layer's key split three ways through the threefry
streams), within 2e-5 as well; gradients within 1e-4 of ``jax.grad``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import transformer as jtr
from deepspeed_tpu_torch.ops import prng
from deepspeed_tpu_torch.ops import transformer as ttr
from deepspeed_tpu_torch.utils.weights import params_from_numpy
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = 2e-5


def _setup(pre, seed=0, E=32, H=4, B=2, S=8):
    kw = dict(hidden_size=E, heads=H, intermediate_size=48, pre_layer_norm=pre,
              attn_dropout_ratio=0.1, hidden_dropout_ratio=0.2)
    jl = jtr.DeepSpeedTransformerLayer(jtr.DeepSpeedTransformerConfig(**kw))
    tl = ttr.DeepSpeedTransformerLayer(ttr.DeepSpeedTransformerConfig(**kw))
    tree = jax.tree.map(np.asarray, jl.init(jax.random.PRNGKey(seed)))
    rs = np.random.RandomState(seed)
    tree["ln1"]["scale"] = (1 + 0.1 * rs.standard_normal(E)).astype(np.float32)
    tree["ln2"]["bias"] = (0.1 * rs.standard_normal(E)).astype(np.float32)
    x = rs.standard_normal((B, S, E)).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[1, 5:] = 0
    return jl, tl, tree, x, mask


@pytest.mark.parametrize("pre", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_layer_matches_jax(pre, masked, train):
    jl, tl, tree, x, mask = _setup(pre)
    m = mask if masked else None
    key = prng.PRNGKey(3)
    ref = np.asarray(jl(jax.tree.map(jnp.asarray, tree), jnp.asarray(x),
                        None if m is None else jnp.asarray(m), train=train,
                        rng=jax.random.PRNGKey(3)))
    got = tl(params_from_numpy(tree, "cpu"), torch.tensor(x),
             None if m is None else torch.tensor(m), train=train, rng=key).numpy()
    assert np.abs(got - ref).max() < TOL, np.abs(got - ref).max()


def test_grads_match_jax():
    jl, tl, tree, x, mask = _setup(True, seed=1)

    def jloss(p, x):
        return jnp.sum(jl(p, x, jnp.asarray(mask), train=True, rng=jax.random.PRNGKey(7)) ** 2)

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    tp = params_from_numpy(tree, "cpu")
    for leaf in [v for d in tp.values() for v in d.values()]:
        leaf.requires_grad_(True)
    tx = torch.tensor(x, requires_grad=True)
    (tl(tp, tx, torch.tensor(mask), train=True, rng=prng.PRNGKey(7)) ** 2).sum().backward()
    assert np.abs(tx.grad.numpy() - np.asarray(jg_x)).max() < 1e-4
    for grp in tp:
        for name, leaf in tp[grp].items():
            d = np.abs(leaf.grad.numpy() - np.asarray(jg_p[grp][name])).max()
            assert d < 1e-4, (grp, name, d)


def test_init_shapes_and_config():
    tl = ttr.DeepSpeedTransformerLayer(ttr.DeepSpeedTransformerConfig(hidden_size=64, heads=4))
    p = tl.init(torch.Generator().manual_seed(0))
    assert tuple(p["attn"]["qkv_w"].shape) == (64, 192)
    assert tuple(p["mlp"]["fc_w"].shape) == (64, 256)
    y = tl(p, torch.zeros(1, 4, 64))
    assert tuple(y.shape) == (1, 4, 64)
    with pytest.raises(ValueError, match="multiple"):
        ttr.DeepSpeedTransformerConfig(hidden_size=30, heads=4)
