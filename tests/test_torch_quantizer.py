"""The port's int8 KV page codec against the JAX package's, bit for bit:
codes and scales of whole pages (zero blocks, exact halves, saturating
values), the single-token scale and coding against a frozen scale, the
pages against the general int8 block rule of ``comm/compressed.py``, and
the dequantize round trip."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.comm import compressed as jcomp
from deepspeed_tpu.ops import quantizer as jq
from deepspeed_tpu_torch.ops import quantizer as tq


def _pages(seed, shape=(6, 4, 16, 64)):
    rs = np.random.RandomState(seed)
    x = (rs.randn(*shape) * rs.rand(*shape[:-2], 1, 1) * 4).astype(np.float32)
    x[0, 1] = 0.0  # a zero block: scale 1, codes 0
    # exact halves of the code grid (round half to even) and the block max
    x[1, 0, 0, :6] = [0.5, 1.5, -2.5, 3.5, -0.5, 127.0]
    x[2, 3] *= 1e-30  # subnormal-scale block
    return x


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kv_pages_codes_and_scales_bit_identical(seed):
    x = _pages(seed)
    jc, js = jq.quantize_kv_pages(jnp.asarray(x))
    tc, ts = tq.quantize_kv_pages(torch.from_numpy(x))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == x.shape[:-2]
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert float(ts[0, 1]) == 1.0 and not tc[0, 1].any()
    np.testing.assert_array_equal(
        tq.dequantize_kv_pages(tc, ts).numpy(), np.asarray(jq.dequantize_kv_pages(jc, js)))


def test_bf16_pages_quantize_like_jax():
    """The serving path quantizes K/V in the compute dtype: bf16 input."""
    x = _pages(3)
    jc, js = jq.quantize_kv_pages(jnp.asarray(x, jnp.bfloat16))
    tc, ts = tq.quantize_kv_pages(torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_dequantize_error_within_half_a_scale():
    x = _pages(4)
    tc, ts = tq.quantize_kv_pages(torch.from_numpy(x))
    err = np.abs(tq.dequantize_kv_pages(tc, ts).numpy() - x)
    assert np.all(err <= ts.numpy()[..., None, None] / 2 * (1 + 1e-6))


@pytest.mark.parametrize("seed", [0, 5])
def test_token_scale_and_frozen_scale_coding_bit_identical(seed):
    rs = np.random.RandomState(seed)
    v = (rs.randn(9, 4, 64) * 3).astype(np.float32)
    v[2, 1] = 0.0
    np.testing.assert_array_equal(
        tq.kv_page_scale(torch.from_numpy(v)).numpy(),
        np.asarray(jq.kv_page_scale(jnp.asarray(v))))
    # a frozen scale below the token's amax saturates at +-127
    s = (np.abs(rs.randn(9, 4)) * 0.02).astype(np.float32)
    got = tq.quantize_kv_token(torch.from_numpy(v), torch.from_numpy(s))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jq.quantize_kv_token(jnp.asarray(v), jnp.asarray(s))))
    assert int(got.abs().max()) == 127


@pytest.mark.parametrize("shape", [(2, 4, 16, 64), (3, 2, 8, 128), (1, 16, 64, 256)])
def test_kv_pages_follow_the_int8_block_rule(shape):
    """Each (page, kv head) slab coded as one block of the JAX package's
    ``comm/compressed.quantize_blocks`` (int8)."""
    x = np.random.RandomState(shape[-1]).randn(*shape).astype(np.float32)
    block = shape[-2] * shape[-1]
    jc, js = jcomp.quantize_blocks(jnp.asarray(x.reshape(*shape[:-2], block)), "int8", block)
    tc, ts = tq.quantize_kv_pages(torch.from_numpy(x))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc).reshape(shape))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js)[..., 0])
    np.testing.assert_array_equal(
        tq.dequantize_kv_pages(tc, ts).numpy(),
        np.asarray(jcomp.dequantize_blocks(jc, js, block)).reshape(shape))
