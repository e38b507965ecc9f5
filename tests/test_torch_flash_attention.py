"""The flash kernels' plain versions (what CPU tensors run) against the JAX
package's Pallas flash attention in interpret mode and its ``jax.grad``,
on the same numpy inputs; and the autograd Function on CPU tensors against
autograd through the plain forward. Mirrors
``tests/unit/ops/test_flash_attention.py``'s cases.

Tolerances: 2e-5 absolute for fp32 outputs and lse, 5e-5 for fp32 grads
(the two packages sum in different orders); 2e-2 for bf16 (one bf16 ulp at
the outputs' magnitude)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import flash_attention as jfa
from deepspeed_tpu_torch.ops import attention as tatt
from deepspeed_tpu_torch.ops import flash_attention as tfa

FWD_TOL = 2e-5
BWD_TOL = 5e-5
BF16_TOL = 2e-2


def _inputs(B, S, H, KV, D, seed=0):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, S, H, D).astype(np.float32)
    k = rs.randn(B, S, KV, D).astype(np.float32)
    v = rs.randn(B, S, KV, D).astype(np.float32)
    do = (rs.randn(B, S, H, D) * 0.1).astype(np.float32)
    return q, k, v, do


def _t(x, dtype=torch.float32):
    return torch.from_numpy(x).to(dtype)


def _jax_lse(q, k, v, causal, window):
    """The JAX forward's lse ([B*H, S, 128] lane-broadcast) as [B, H, S]."""
    B, S, H, D = q.shape
    KV = k.shape[2]

    def to3(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(B * x.shape[2], S, D)

    _, lse = jfa._fwd(to3(q), to3(k), to3(v), 1.0 / np.sqrt(D), causal, True, H // KV,
                      None if window is None else jfa._win_arr(window))
    return np.asarray(lse)[..., 0].reshape(B, H, S)


CASES = [  # B, S, H, KV, D, causal, window
    (1, 128, 2, 2, 64, True, None),
    (2, 256, 2, 2, 64, True, None),
    (1, 128, 2, 2, 128, True, None),
    (1, 256, 2, 2, 64, False, None),
    (1, 256, 4, 2, 64, True, None),
    (1, 128, 4, 1, 64, True, None),
    (1, 256, 2, 2, 64, True, 100),
]


@pytest.mark.parametrize("B,S,H,KV,D,causal,window", CASES)
def test_forward_plain_version_matches_jax_kernel(B, S, H, KV, D, causal, window):
    q, k, v, _ = _inputs(B, S, H, KV, D)
    o_j = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                              interpret=True, window=window)
    o, lse = tfa.flash_attention_fwd_ref(_t(q), _t(k), _t(v), causal, None, window)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), _jax_lse(q, k, v, causal, window),
                               atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize("B,S,H,KV,D,causal,window", [
    (1, 128, 2, 2, 64, True, None),
    (1, 256, 2, 2, 64, False, None),
    (1, 128, 2, 2, 128, True, None),
    (1, 256, 4, 2, 64, True, None),
    (1, 128, 4, 1, 64, True, None),
    (1, 256, 2, 2, 64, True, 100),
])
def test_backward_plain_version_matches_jax_grad(B, S, H, KV, D, causal, window):
    q, k, v, do = _inputs(B, S, H, KV, D, seed=1)

    def loss(q_, k_, v_):
        o = jfa.flash_attention(q_, k_, v_, causal=causal, interpret=True, window=window)
        return jnp.sum(o * jnp.asarray(do))

    grads_j = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = _t(q), _t(k), _t(v)
    o, lse = tfa.flash_attention_fwd_ref(tq, tk, tv, causal, None, window)
    grads = tfa.flash_attention_bwd_ref(tq, tk, tv, o, lse, _t(do), causal, None, window)
    for got, ref in zip(grads, grads_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=BWD_TOL, rtol=BWD_TOL)


def test_bf16_plain_version_matches_jax_kernel():
    q, k, v, do = _inputs(1, 128, 2, 2, 64, seed=3)
    qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    o_j = jfa.flash_attention(qb, kb, vb, interpret=True)

    def loss(q_, k_, v_):
        o_ = jfa.flash_attention(q_, k_, v_, interpret=True).astype(jnp.float32)
        return jnp.sum(o_ * jnp.asarray(do))

    grads_j = jax.grad(loss, argnums=(0, 1, 2))(qb, kb, vb)
    tq, tk, tv = (_t(x, torch.bfloat16) for x in (q, k, v))
    o, lse = tfa.flash_attention_fwd_ref(tq, tk, tv)
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(o.float().numpy(), np.asarray(o_j, np.float32),
                               atol=BF16_TOL, rtol=BF16_TOL)
    grads = tfa.flash_attention_bwd_ref(tq, tk, tv, o, lse, _t(do, torch.bfloat16))
    for got, ref in zip(grads, grads_j):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                                   atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("causal,window,KV", [(True, None, 2), (False, None, 2),
                                              (True, 40, 1), (True, None, 4)])
def test_autograd_function_on_cpu_matches_autograd_of_plain_forward(causal, window, KV):
    """The Function (what the card runs through the kernels) on CPU tensors,
    ragged S included, against torch.autograd through the plain forward."""
    q, k, v, do = _inputs(2, 100, 4, KV, 16, seed=4)
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
    o = tfa.flash(*leaves, causal, None, window)
    got = torch.autograd.grad(o, leaves, _t(do))
    leaves2 = [_t(x).requires_grad_(True) for x in (q, k, v)]
    o2, _ = tfa.flash_attention_fwd_ref(*leaves2, causal, None, window)
    ref = torch.autograd.grad(o2, leaves2, _t(do))
    np.testing.assert_allclose(o.detach().numpy(), o2.detach().numpy(), atol=1e-6, rtol=1e-6)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("window", [None, 24])
def test_causal_attention_cpu_matches_jax_reference(window):
    """``causal_attention`` on CPU tensors is the jnp reference's math."""
    from deepspeed_tpu.ops import attention as jatt

    q, k, v, _ = _inputs(2, 70, 4, 2, 16, seed=5)
    ref = (jatt.causal_attention_jnp(*(jnp.asarray(x) for x in (q, k, v))) if window is None
           else jatt.causal_attention_windowed_jnp(*(jnp.asarray(x) for x in (q, k, v)), window))
    got = tatt.causal_attention(_t(q), _t(k), _t(v), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)
    fl = tfa.flash(_t(q), _t(k), _t(v), True, None, window)
    np.testing.assert_allclose(fl.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)


def test_the_entry_keeps_the_jax_checks():
    q = torch.zeros(1, 128, 4, 16)
    with pytest.raises(ValueError, match="multiple of 128"):
        tfa.flash_attention(q[:, :100], q[:, :100], q[:, :100])
    with pytest.raises(ValueError, match="kv heads"):
        tfa.flash_attention(q, q[:, :, :3], q[:, :, :3])
    with pytest.raises(ValueError, match="window requires causal"):
        tfa.flash_attention(q, q, q, causal=False, window=16)
    with pytest.raises(ValueError, match="unknown attention impl"):
        tatt.causal_attention(q, q, q, impl="ring")


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises: CPU tensors are refused, not
    routed to the plain version behind the caller's back."""
    q = torch.zeros(1, 128, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_fwd(q, q, q)
    lse = torch.zeros(1, 2, 128)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_bwd(q, q, q, q, lse, q)
