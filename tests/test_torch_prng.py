"""The port's threefry streams (``ops/prng.py``) against ``jax.random`` on
the CPU (jax 0.9.0, threefry2x32, ``jax_threefry_partitionable`` on): keys,
``split``, ``fold_in``, bits, ``uniform`` and ``bernoulli`` bit for bit
(tolerance 0), ``gumbel`` within 2 ulp (``log`` may differ by an ulp
between XLA's CPU build and PyTorch), ``categorical`` and ``sample_logits``
token for token over 200 seeds at gpt2-tiny's vocabulary, and the plain
``uniform_rows`` against JAX's per-row uniforms."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from deepspeed_tpu.ops import sampling as jsamp
from deepspeed_tpu_torch.ops import prng
from deepspeed_tpu_torch.ops import sampling as tsamp
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

VOCAB = 512
TINY = float(np.finfo(np.float32).tiny)


def _j(key):
    return np.asarray(key)


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 - 1, 12345, -1])
def test_prng_key(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed), _j(jax.random.PRNGKey(seed)))


def test_prng_key_out_of_int32_range_raises():
    with pytest.raises(OverflowError):
        prng.PRNGKey(2 ** 31)


@pytest.mark.parametrize("num", [2, 3, 7, (2, 5), (4, 1, 3)])
def test_split(num):
    for seed in (0, 9):
        want = _j(jax.random.split(jax.random.PRNGKey(seed), num))
        got = prng.split(prng.PRNGKey(seed), num)
        assert got.dtype == np.uint32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_split_of_a_batch_of_keys_is_jax_vmap():
    keys = jax.random.split(jax.random.PRNGKey(4), 6)
    want = _j(jax.vmap(lambda k: jax.random.split(k, 3))(keys))
    np.testing.assert_array_equal(prng.split(_j(keys), 3), want)


def test_fold_in_chains():
    jk, tk = jax.random.PRNGKey(11), prng.PRNGKey(11)
    for data in (0, 1, 24, 0x5EED, 2 ** 32 - 1, 7, 7):
        jk, tk = jax.random.fold_in(jk, data), prng.fold_in(tk, data)
        np.testing.assert_array_equal(tk, _j(jk))
    jk = jax.random.split(jax.random.fold_in(jk, 3), 4)[2]
    tk = prng.split(prng.fold_in(tk, 3), 4)[2]
    np.testing.assert_array_equal(tk, _j(jk))


def test_tensor_keys_keep_their_kind():
    tk = torch.from_numpy(prng.PRNGKey(5).astype(np.int64))
    got = prng.fold_in(prng.split(tk, 3)[1], 9)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.int64
    want = _j(jax.random.fold_in(jax.random.split(jax.random.PRNGKey(5), 3)[1], 9))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("shape", [(1,), (7,), (13, 5), (3, 1, 9), (1001,)])
def test_random_bits(shape):
    key = jax.random.PRNGKey(3)
    want = _j(jax.random.bits(key, shape, jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(prng.random_bits(prng.PRNGKey(3), shape).numpy(), want)


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (TINY, 1.0), (-2.5, 3.7)])
def test_uniform(lo, hi):
    """[0, 1) and [tiny, 1) (the sampler's) exactly; a general range too:
    XLA's CPU build fuses ``* (max - min) + min`` into one rounding, and so
    do the plain version and the kernel."""
    for seed, shape in ((0, (5, 33)), (8, (4097,))):
        want = _j(jax.random.uniform(jax.random.PRNGKey(seed), shape, minval=lo, maxval=hi))
        got = prng.uniform(prng.PRNGKey(seed), shape, lo, hi).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", [0.9, 0.5, 0.1, 0.999])
def test_bernoulli(p):
    want = _j(jax.random.bernoulli(jax.random.PRNGKey(21), p, (64, 65)))
    np.testing.assert_array_equal(prng.bernoulli(prng.PRNGKey(21), p, (64, 65)).numpy(), want)


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), data=st.integers(0, 2 ** 32 - 1),
       n=st.sampled_from([1, 7, 64, 301]), p=st.floats(0.01, 0.99))
def test_streams_match_jax_over_seeds_and_data(seed, data, n, p):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    tk = prng.fold_in(prng.PRNGKey(seed), data)
    np.testing.assert_array_equal(tk, _j(jk))
    np.testing.assert_array_equal(prng.split(tk, 3), _j(jax.random.split(jk, 3)))
    np.testing.assert_array_equal(prng.random_bits(tk, (n,)).numpy(),
                                  _j(jax.random.bits(jk, (n,), jnp.uint32)).astype(np.int64))
    np.testing.assert_array_equal(prng.uniform(tk, (n,)).numpy(), _j(jax.random.uniform(jk, (n,))))
    np.testing.assert_array_equal(prng.bernoulli(tk, p, (n,)).numpy(),
                                  _j(jax.random.bernoulli(jk, p, (n,))))


def test_uniform_rows_is_jax_per_key():
    keys = jax.random.split(jax.random.PRNGKey(2), 5)
    want = _j(jax.vmap(lambda k: jax.random.uniform(k, (VOCAB,), minval=TINY, maxval=1.0))(keys))
    got = prng.uniform_rows_ref(_j(keys), VOCAB, TINY, 1.0)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(prng.uniform_rows(_j(keys), VOCAB, TINY, 1.0).numpy(), want)


def test_gumbel_within_two_ulp():
    """The uniforms are equal bit for bit; each ``log`` may differ by an ulp
    between XLA's CPU build and PyTorch. Near g = 0 the outer log's argument
    is near 1, where an ulp of it is an ulp of 1, not of g: so the ulp is
    taken at max(|g|, 1)."""
    for seed in range(4):
        want = _j(jax.random.gumbel(jax.random.PRNGKey(seed), (4, VOCAB)))
        got = prng.gumbel(prng.PRNGKey(seed), (4, VOCAB)).numpy()
        ulp = np.spacing(np.maximum(np.abs(want), np.float32(1.0)))
        assert (np.abs(got - want) <= 2 * ulp).all(), np.abs(got - want).max()


@pytest.mark.parametrize("temperature,top_k,top_p", [(0.8, 0, 1.0), (0.7, 50, 1.0),
                                                     (0.8, 40, 0.95)])
def test_sample_logits_tokens_equal_jax_over_200_seeds(temperature, top_k, top_p):
    """Both key forms: one key for the [3, V] batch (generate) and one key
    per row (the serving programs' vmap)."""
    rs = np.random.RandomState(int(temperature * 100) + top_k)
    logits = (rs.randn(200, 3, VOCAB) * 3).astype(np.float32)
    seeds = np.arange(200)
    keys = jax.vmap(jax.random.PRNGKey)(seeds)
    one = jax.vmap(lambda k, lg: jsamp.sample_logits(lg, k, temperature, top_k, top_p))
    rows = jax.vmap(jax.vmap(lambda k, lg: jsamp.sample_logits(lg[None], k, temperature, top_k,
                                                               top_p)[0]))
    row_keys = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
    want_one = _j(one(keys, jnp.asarray(logits)))
    want_rows = _j(rows(row_keys, jnp.asarray(logits)))
    row_keys = _j(row_keys)
    for s in seeds:
        lg = torch.from_numpy(logits[s])
        got = tsamp.sample_logits(lg, prng.PRNGKey(int(s)), temperature, top_k, top_p)
        np.testing.assert_array_equal(got.numpy(), want_one[s], err_msg=f"seed {s}")
        got = tsamp.sample_logits(lg, row_keys[s], temperature, top_k, top_p)
        np.testing.assert_array_equal(got.numpy(), want_rows[s], err_msg=f"seed {s} per row")


def test_categorical_equals_jax():
    logits = np.random.RandomState(1).randn(6, VOCAB).astype(np.float32)
    for seed in range(20):
        want = _j(jax.random.categorical(jax.random.PRNGKey(seed), logits))
        got = prng.categorical(prng.PRNGKey(seed), torch.from_numpy(logits)).numpy()
        np.testing.assert_array_equal(got, want)


def test_sampling_needs_a_key_only_when_it_samples():
    lg = torch.from_numpy(np.random.RandomState(2).randn(2, 30).astype(np.float32))
    assert torch.equal(tsamp.sample_logits(lg, None, 0.0), torch.argmax(lg, dim=-1))
    with pytest.raises(ValueError, match="key"):
        tsamp.sample_logits(lg, None, 0.8)
