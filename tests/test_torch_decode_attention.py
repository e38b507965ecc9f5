"""The decode-attention plain versions (the CPU path) against the JAX
package's Pallas kernels in interpret mode and their jnp fallbacks:

- the contiguous decode attention on the cases of
  ``tests/unit/ops/test_decode_attention.py::test_matches_dense_reference``
  and ``TestGQADecode``, tolerance 2e-5 (fp32, the JAX tests' own);
- the int8 modes of the paged decode and multi-token attention on the
  inputs of ``TestQuantizedPagedAttention`` (pools quantized by the JAX
  codec), tolerance 2e-5.

The kernels run only on the card (``test_torch_cuda_kernels.py``); here
their wrappers must refuse CPU tensors and the launch counts stay 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.attention import cached_attention as j_cached
from deepspeed_tpu.ops.attention import paged_cached_attention as j_paged_cached
from deepspeed_tpu.ops.attention import paged_multitoken_cached_attention as j_mt_cached
from deepspeed_tpu.ops.pallas import decode_attention as jda
from deepspeed_tpu.ops.quantizer import quantize_kv_pages
from deepspeed_tpu_torch.ops import decode_attention as tda
from deepspeed_tpu_torch.ops import paged_decode_attention as pda
from deepspeed_tpu_torch.ops import paged_multitoken_attention as pma
from deepspeed_tpu_torch.ops.attention import (
    cached_attention,
    gather_pool_pages,
    paged_cached_attention,
    paged_multitoken_cached_attention,
)

TOL = dict(atol=2e-5, rtol=2e-5)
t = torch.from_numpy


# ---- contiguous decode attention -------------------------------------------

def _dense(B, S, H, KV, D, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, H, D).astype(np.float32), rs.randn(B, S, KV, D).astype(np.float32),
            rs.randn(B, S, KV, D).astype(np.float32))


def _jax_decode(q, k, v, pos):
    return np.asarray(jda.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           jnp.int32(pos), interpret=True))


@pytest.mark.parametrize("pos", [0, 7, 63])
@pytest.mark.parametrize("shape", [(2, 64, 2, 64), (1, 1024, 4, 128)])
def test_plain_decode_matches_the_pallas_kernel(shape, pos):
    B, S, H, D = shape
    q, k, v = _dense(B, S, H, H, D, 0)
    got = tda.decode_attention_ref(t(q), t(k), t(v), pos).numpy()
    np.testing.assert_allclose(got, _jax_decode(q, k, v, pos), **TOL)
    np.testing.assert_allclose(got, np.asarray(j_cached(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(pos), impl="jnp")), **TOL)


@pytest.mark.parametrize("rep", [2, 4])
@pytest.mark.parametrize("pos", [0, 31])
def test_plain_decode_gqa_matches_the_pallas_kernel(rep, pos):
    q, k, v = _dense(2, 64, 4, 4 // rep, 64, 1)
    got = cached_attention(t(q), t(k), t(v), pos).numpy()
    np.testing.assert_allclose(got, _jax_decode(q, k, v, pos), **TOL)


def test_plain_decode_never_reads_past_pos():
    """Rows past pos (the padded bucket's garbage, huge values here) do not
    reach the output; a pos past the cache means every row."""
    q, k, v = _dense(2, 32, 4, 4, 64, 2)
    ref = tda.decode_attention_ref(t(q), t(k), t(v), 9).numpy()
    k[:, 10:], v[:, 10:] = 1e4, -1e4
    got = tda.decode_attention_ref(t(q), t(k), t(v), 9).numpy()
    np.testing.assert_array_equal(got, ref)
    q, k, v = _dense(2, 32, 4, 4, 64, 2)
    np.testing.assert_array_equal(tda.decode_attention_ref(t(q), t(k), t(v), 100).numpy(),
                                  tda.decode_attention_ref(t(q), t(k), t(v), 31).numpy())


def test_plain_decode_takes_a_strided_layer_slice():
    """A layer's slice of the stacked [L, B, Smax, H, D] cache, no copy."""
    rs = np.random.RandomState(3)
    kc = t(rs.randn(3, 2, 16, 4, 64).astype(np.float32))
    vc = t(rs.randn(3, 2, 16, 4, 64).astype(np.float32))
    q = t(rs.randn(2, 4, 64).astype(np.float32))
    got = cached_attention(q, kc[1], vc[1], 11)
    np.testing.assert_array_equal(
        got.numpy(), tda.decode_attention_ref(q, kc[1].clone(), vc[1].clone(), 11).numpy())


def test_decode_shapes_refused():
    q = torch.zeros(1, 4, 64)
    with pytest.raises(ValueError, match="divide"):
        tda.decode_attention_ref(q, torch.zeros(1, 64, 3, 64), torch.zeros(1, 64, 3, 64), 0)
    with pytest.raises(ValueError, match="match"):
        tda.decode_attention_ref(q, torch.zeros(2, 64, 4, 64), torch.zeros(2, 64, 4, 64), 0)


def test_decode_wrapper_refuses_cpu_tensors_and_dispatch_launches_nothing():
    q, k, v = _dense(2, 64, 4, 4, 64, 4)
    with pytest.raises(ValueError, match="CUDA"):
        tda.decode_attention(t(q), t(k), t(v), 3)
    with pytest.raises(ValueError, match="unknown"):
        cached_attention(t(q), t(k), t(v), 3, impl="xla")
    cached_attention(t(q), t(k), t(v), 3, impl="jnp")  # the plain version by name: CPU only
    assert tda.LAUNCHES["decode_attention"] == 0


# ---- int8 modes of the paged kernels ---------------------------------------

def _int8_setup(B=2, H=2, KV=None, D=64, page=8, P=16, n=4, seed=0):
    """TestQuantizedPagedAttention's inputs: f32 pools quantized by the JAX
    codec, scales [P, KV, 2], distinct non-scratch pages per slot."""
    KV = KV or H
    rs = np.random.RandomState(seed)
    kf = rs.randn(P, KV, page, D).astype(np.float32)
    vf = rs.randn(P, KV, page, D).astype(np.float32)
    kq, ks = quantize_kv_pages(jnp.asarray(kf))
    vq, vs = quantize_kv_pages(jnp.asarray(vf))
    scales = np.array(jnp.stack([ks, vs], axis=-1))
    bt = rs.choice(np.arange(1, P), (B * n,), replace=False).reshape(B, n).astype(np.int32)
    q = rs.randn(B, H, D).astype(np.float32)
    return q, np.array(kq), np.array(vq), scales, bt


def test_int8_decode_plain_matches_the_pallas_int8_mode():
    q, kq, vq, sc, bt = _int8_setup()
    pos = np.asarray([13, 29], np.int32)
    got = paged_cached_attention(t(q), t(kq), t(vq), t(bt), t(pos), scales=t(sc)).numpy()
    j = [jnp.asarray(x) for x in (q, kq, vq, bt, pos)]
    np.testing.assert_allclose(got, np.asarray(jda.paged_decode_attention(
        *j, interpret=True, scales=jnp.asarray(sc))), **TOL)
    np.testing.assert_allclose(got, np.asarray(j_paged_cached(
        *j, impl="jnp", scales=jnp.asarray(sc))), **TOL)


def test_int8_multitoken_plain_matches_the_pallas_int8_mode():
    _, kq, vq, sc, bt = _int8_setup(seed=1)
    qm = np.random.RandomState(9).randn(2, 3, 2, 64).astype(np.float32)
    base = np.asarray([9, 21], np.int32)
    got = paged_multitoken_cached_attention(t(qm), t(kq), t(vq), t(bt), t(base),
                                            scales=t(sc)).numpy()
    j = [jnp.asarray(x) for x in (qm, kq, vq, bt, base)]
    np.testing.assert_allclose(got, np.asarray(jda.paged_multitoken_attention(
        *j, interpret=True, scales=jnp.asarray(sc))), **TOL)
    np.testing.assert_allclose(got, np.asarray(j_mt_cached(
        *j, impl="jnp", scales=jnp.asarray(sc))), **TOL)


def test_int8_gqa_scale_columns():
    """KV < H: each query head dequantizes through its group's scale column."""
    q, kq, vq, sc, bt = _int8_setup(B=2, H=4, KV=2, seed=3)
    pos = np.asarray([5, 30], np.int32)
    got = pda.paged_decode_attention_ref(t(q), t(kq), t(vq), t(bt), t(pos), scales=t(sc))
    j = [jnp.asarray(x) for x in (q, kq, vq, bt, pos)]
    np.testing.assert_allclose(got.numpy(), np.asarray(jda.paged_decode_attention(
        *j, interpret=True, scales=jnp.asarray(sc))), **TOL)


def test_int8_gather_dequantizes_and_fresh_pages_read_zero():
    _, kq, vq, sc, bt = _int8_setup(seed=4)
    sc[bt[0, 1]] = 0.0  # a never-written page: scale 0
    kd, vd = gather_pool_pages(t(kq), t(vq), t(bt), t(sc))
    assert kd.dtype == torch.float32 and tuple(kd.shape) == (2, 4, 2, 8, 64)
    assert not kd[0, 1].any() and not vd[0, 1].any()
    np.testing.assert_array_equal(
        kd[1, 2].numpy(), kq[bt[1, 2]].astype(np.float32) * sc[bt[1, 2], :, 0][:, None, None])


def test_int8_close_to_full_precision():
    """Attending the int8 pool is within the codec's rounding of attending
    the exact pool (TestQuantizedPagedAttention's end-to-end bound)."""
    rs = np.random.RandomState(2)
    kf = rs.randn(16, 2, 8, 64).astype(np.float32)
    vf = rs.randn(16, 2, 8, 64).astype(np.float32)
    kq, ks = quantize_kv_pages(jnp.asarray(kf))
    vq, vs = quantize_kv_pages(jnp.asarray(vf))
    sc = np.array(jnp.stack([ks, vs], axis=-1))
    bt = rs.choice(np.arange(1, 16), (8,), replace=False).reshape(2, 4).astype(np.int32)
    q, pos = rs.randn(2, 2, 64).astype(np.float32), t(np.asarray([20, 31], np.int32))
    exact = paged_cached_attention(t(q), t(kf), t(vf), t(bt), pos).numpy()
    deq = paged_cached_attention(t(q), t(np.array(kq)), t(np.array(vq)), t(bt), pos,
                                 scales=t(sc)).numpy()
    assert np.abs(deq - exact).max() <= 0.02 * np.abs(exact).max() + 1e-5


def test_scales_given_exactly_when_the_pool_is_int8():
    q, kq, vq, sc, bt = _int8_setup(seed=5)
    pos = t(np.asarray([3, 4], np.int32))
    with pytest.raises(ValueError, match="exactly when the pool is int8"):
        paged_cached_attention(t(q), t(kq), t(vq), t(bt), pos)
    with pytest.raises(ValueError, match="exactly when the pool is int8"):
        paged_cached_attention(t(q), t(kq).float(), t(vq).float(), t(bt), pos, scales=t(sc))
    with pytest.raises(ValueError, match="exactly when the pool is int8"):
        paged_multitoken_cached_attention(t(q)[:, None], t(kq), t(vq), t(bt), pos)
    with pytest.raises(ValueError, match="float32"):
        pda.paged_decode_attention_ref(t(q), t(kq), t(vq), t(bt), pos, scales=t(sc)[:, :1])


def test_int8_kernel_wrappers_refuse_cpu_tensors():
    q, kq, vq, sc, bt = _int8_setup(seed=6)
    pos = t(np.asarray([3, 4], np.int32))
    with pytest.raises(ValueError, match="CUDA"):
        pda.paged_decode_attention(t(q), t(kq), t(vq), t(bt), pos, scales=t(sc))
    with pytest.raises(ValueError, match="CUDA"):
        pma.paged_multitoken_attention(t(q)[:, None].contiguous(), t(kq), t(vq), t(bt), pos,
                                       scales=t(sc))
    with pytest.raises(ValueError, match="needs its scales"):
        pda.paged_decode_attention(t(q), t(kq), t(vq), t(bt), pos)
    assert not any(pda.LAUNCHES[k] for k in pda.KERNELS + pma.KERNELS)
