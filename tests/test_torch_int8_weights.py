"""Weight-only int8 in the port (``ops/quantizer.py``) against the JAX
package on the CPU: ``quantize`` / ``quantize_asym`` codes and scales bit
for bit at groups 1, 7, 64 and a non-divisor, with and without a key
(stochastic rounding draws JAX's uniforms); ``quantize_tree`` in JAX's
tree order; the dequantizers; ``tests/unit/test_inference.py``'s
``TestQuantizer`` cases run on the port; a JAX quantized tree carried
across by ``params_from_numpy``. The engines' streams on these codes are
held in ``test_torch_int8_inference.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.ops import quantizer as jq
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops import prng
from deepspeed_tpu_torch.ops import quantizer as tq
from deepspeed_tpu_torch.utils.weights import params_from_numpy, params_to_numpy
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

VOCAB = 512


@pytest.fixture(scope="module")
def tree():
    cfg = jgpt2.get_config("gpt2-tiny")
    return jax.tree.map(np.asarray, jgpt2.init_params(cfg, jax.random.PRNGKey(0)))


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _same_codes(t, j):
    assert type(t).__name__ == type(j).__name__ and t._fields == j._fields
    for a, b in zip(t, j):
        np.testing.assert_array_equal(_f32(a), _f32(b))
    assert t.q.dtype == torch.int8


@pytest.mark.parametrize("seed", [None, 5])
@pytest.mark.parametrize("groups", [1, 7, 64, 10])
def test_quantize_codes_and_scales_equal_jax(groups, seed):
    """Groups 7 and 10 are not divisors of I = 96: the largest divisor not
    above them is taken (6 and 8)."""
    w = np.random.RandomState(groups).randn(3, 96, 40).astype(np.float32)
    jk = None if seed is None else jax.random.PRNGKey(seed)
    tk = None if seed is None else prng.PRNGKey(seed)
    for fn in ("quantize", "quantize_asym"):
        # jitted: one compile, not one per eager op
        j = jax.jit(getattr(jq, fn), static_argnums=1)(jnp.asarray(w), groups, key=jk)
        t = getattr(tq, fn)(torch.from_numpy(w), groups, key=tk)
        _same_codes(t, j)
        deq = "dequantize" if fn == "quantize" else "dequantize_asym"
        np.testing.assert_array_equal(getattr(tq, deq)(t).numpy(), np.asarray(getattr(jq, deq)(j)))
        np.testing.assert_array_equal(tq.maybe_dequantize(t, torch.float32).numpy(),
                                      np.asarray(jq.maybe_dequantize(j, jnp.float32)))


@pytest.mark.parametrize("seed", [None, 3])
def test_quantize_tree_equals_jax_in_tree_order(tree, seed):
    """With a key, each quantized leaf takes the next split of the key in
    JAX's tree order (dict keys sorted), so every leaf's codes match."""
    jt = jax.jit(lambda p, k: jq.quantize_tree(p, groups=8, key=k))(
        jax.tree.map(jnp.asarray, tree), None if seed is None else jax.random.PRNGKey(seed))
    tt = tq.quantize_tree(params_from_numpy(tree, "cpu"), groups=8,
                          key=None if seed is None else prng.PRNGKey(seed))
    for name in ("attn", "mlp"):
        for leaf in jt["blocks"][name]:
            j, t = jt["blocks"][name][leaf], tt["blocks"][name][leaf]
            if isinstance(j, jq.QuantizedWeight):
                _same_codes(t, j)
            else:
                assert t.dtype == torch.bfloat16
                np.testing.assert_array_equal(_f32(t), _f32(j))
    assert tt["wte"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(tt["wte"]), _f32(jt["wte"]))


# ---- tests/unit/test_inference.py::TestQuantizer, on the port ----------------

def test_roundtrip_error_bounded():
    w = torch.from_numpy(np.random.RandomState(0).randn(128, 64).astype(np.float32))
    assert tq.quantization_error(w, groups=16) < 0.02


def test_group_shapes():
    w = torch.ones(4, 128, 64)
    qw = tq.quantize(w, groups=16)
    assert qw.q.dtype == torch.int8
    assert qw.q.shape == (4, 16, 8, 64) and qw.scale.shape == (4, 16, 1, 64)
    assert np.allclose(tq.dequantize(qw).numpy(), w.numpy(), atol=1e-2)


def test_quantize_tree_targets_stacked_weights(tree):
    qt = tq.quantize_tree(params_from_numpy(tree, "cpu"), groups=8)
    assert isinstance(qt["blocks"]["attn"]["c_attn_w"], tq.QuantizedWeight)
    assert qt["wte"].dtype == torch.bfloat16


def test_quantized_forward_close(tree):
    cfg = tgpt2.get_config("gpt2-tiny")
    params = params_from_numpy(tree, "cpu")
    ids = torch.from_numpy(np.random.RandomState(3).randint(0, VOCAB, (2, 8))).long()
    ref = tgpt2.forward(cfg, params, ids)
    out = tgpt2.forward(cfg, tq.quantize_tree(params, groups=8, dtype=torch.float32), ids)
    ref_p = torch.softmax(ref[:, -1], dim=-1)
    out_p = torch.softmax(out[:, -1], dim=-1)
    assert float((ref_p - out_p).abs().max()) < 0.05


# ---- a JAX quantized tree in the port -----------------------------------------

def test_params_from_numpy_carries_a_jax_quantized_tree(tree):
    """The JAX package's quantized tree, as numpy, becomes the port's named
    tuples with the same codes; the port's forward on it equals JAX's."""
    jtree = jq.quantize_tree(jax.tree.map(jnp.asarray, tree), groups=4, dtype=jnp.float32)
    as_np = jax.tree.map(np.asarray, jtree)
    t = params_from_numpy(as_np, "cpu")
    w = t["blocks"]["attn"]["c_attn_w"]
    assert isinstance(w, tq.QuantizedWeight) and w.q.dtype == torch.int8
    np.testing.assert_array_equal(w.q.numpy(), as_np["blocks"]["attn"]["c_attn_w"].q)
    # a dict of q / scale is a quantized leaf too
    d = params_from_numpy({"q": as_np["blocks"]["mlp"]["c_fc_w"].q,
                           "scale": as_np["blocks"]["mlp"]["c_fc_w"].scale}, "cpu")
    assert isinstance(d, tq.QuantizedWeight)
    back = params_to_numpy(t)
    assert isinstance(back["blocks"]["attn"]["c_attn_w"], tq.QuantizedWeight)
    ids = np.random.RandomState(4).randint(0, VOCAB, (2, 9)).astype(np.int32)
    want = np.asarray(jgpt2.forward(jgpt2.get_config("gpt2-tiny"), jtree, jnp.asarray(ids)))
    got = tgpt2.forward(tgpt2.get_config("gpt2-tiny"), t, torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
