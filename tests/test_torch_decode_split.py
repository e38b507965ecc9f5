"""The contiguous decode kernel's split-K arithmetic, on the CPU.

The kernel (``csrc/decode_attention.cu``) cuts the cache rows ``0..pos``
into chunks across blocks and merges the chunks' partial softmax states by
their log-sum-exp. Its plain form here:

- :func:`merge_partials` against the JAX package's LSE merge, ``_merge``
  of ``deepspeed_tpu/ops/pallas/ring_flash_attention.py``, folded over the
  chunks as the ring folds its steps (f32, tolerance 1e-5);
- :func:`decode_attention_split_ref` at 1-8 chunks against the unsplit
  plain version (f32 2e-6, bf16 one output ulp) and against the Pallas
  decode kernel in interpret mode, as ``tests/unit/ops/test_decode_attention.py``
  runs it (f32, 2e-5, the JAX tests' own tolerance), with pos at 0, at the
  chunk edges and at Smax - 1, MHA and GQA H16/KV4;
- the planner: every row in exactly one chunk, no empty chunk, whole
  passes, one chunk (and one 16-warp block a head) for a cache one pass
  covers, generate's and the long cache's launches.

The kernel itself runs only on the card (``test_torch_cuda_kernels.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import decode_attention as jda
from deepspeed_tpu.ops.pallas.ring_flash_attention import _merge as jax_merge
from deepspeed_tpu_torch.ops import decode_attention as tda

t = torch.from_numpy


def _cache(B, S, H, KV, D, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, H, D).astype(np.float32), rs.randn(B, S, KV, D).astype(np.float32),
            rs.randn(B, S, KV, D).astype(np.float32))


def _edges(n, splits):
    """pos at 0, on both sides of each chunk edge of ``splits`` chunks of
    n rows, and n - 1."""
    chunk = -(-n // splits)
    out = {0, n - 1}
    for e in range(1, splits):
        out.update({e * chunk - 1, e * chunk})
    return sorted(p for p in out if 0 <= p < n)


# ---- the merge ---------------------------------------------------------------

@pytest.mark.parametrize("splits", range(1, 9))
def test_merge_matches_the_jax_lse_merge(splits):
    rs = np.random.RandomState(splits)
    B, H, D = 2, 3, 16
    m = rs.randn(B, H, splits).astype(np.float32) * 3
    l = rs.uniform(0.5, 20.0, (B, H, splits)).astype(np.float32)
    acc = rs.randn(B, H, splits, D).astype(np.float32) * l[..., None]
    got = tda.merge_partials(t(m), t(l), t(acc)).numpy()
    # the ring's fold: each step's normalised output and its lse
    u = jnp.zeros((B, H, D), jnp.float32)
    mm = jnp.full((B, H), -1e30, jnp.float32)
    ll = jnp.zeros((B, H), jnp.float32)
    for i in range(splits):
        u, mm, ll = jax_merge(u, mm, ll, jnp.asarray(acc[..., i, :] / l[..., i, None]),
                              jnp.asarray(m[..., i] + np.log(l[..., i])))
    np.testing.assert_allclose(got, np.asarray(u / ll[..., None]), rtol=1e-5, atol=1e-5)


def test_merge_of_one_chunk_is_its_normalised_sum():
    rs = np.random.RandomState(0)
    acc = t(rs.randn(2, 4, 1, 8).astype(np.float32))
    l = t(rs.uniform(1, 5, (2, 4, 1)).astype(np.float32))
    got = tda.merge_partials(t(rs.randn(2, 4, 1).astype(np.float32)), l, acc)
    torch.testing.assert_close(got, acc[:, :, 0] / l, rtol=1e-6, atol=1e-6)


# ---- the split computation ---------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV", [(4, 4), (16, 4)])
@pytest.mark.parametrize("splits", range(1, 9))
def test_split_matches_the_plain_version(splits, H, KV, dtype):
    S = 64
    q, k, v = (t(x).to(dtype) for x in _cache(2, S, H, KV, 64, splits))
    for pos in _edges(S, splits):
        got = tda.decode_attention_split_ref(q, k, v, pos, splits)
        ref = tda.decode_attention_ref(q, k, v, pos)
        assert got.dtype == dtype and got.shape == ref.shape
        if dtype == torch.float32:
            torch.testing.assert_close(got, ref, rtol=2e-6, atol=2e-6)
        else:  # f32 sums in another order, then one rounding to 8 bits
            torch.testing.assert_close(got.float(), ref.float(), rtol=0, atol=8e-3)


@pytest.mark.parametrize("H,KV", [(4, 4), (16, 4)])
@pytest.mark.parametrize("splits", [1, 2, 3, 5, 8])
def test_split_matches_the_pallas_kernel(splits, H, KV):
    S = 64
    q, k, v = _cache(2, S, H, KV, 64, 10 + splits)
    for pos in _edges(S, splits):
        want = np.asarray(jda.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                               jnp.int32(pos), interpret=True))
        got = tda.decode_attention_split_ref(t(q), t(k), t(v), pos, splits).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_split_never_reads_past_pos():
    q, k, v = (t(x) for x in _cache(2, 64, 4, 4, 64, 3))
    ref = tda.decode_attention_split_ref(q, k, v, 40, 3)
    k[:, 41:], v[:, 41:] = 1e4, -1e4
    torch.testing.assert_close(tda.decode_attention_split_ref(q, k, v, 40, 3), ref,
                               rtol=0, atol=0)


# ---- the planner ---------------------------------------------------------------

@pytest.mark.parametrize("rows_pass", [16, 64, 256])
@pytest.mark.parametrize("B,KV,head_blocks", [(1, 1, 1), (8, 16, 1), (2, 4, 2), (64, 16, 1)])
def test_planner_covers_every_row_once(B, KV, head_blocks, rows_pass):
    for n in list(range(1, 300)) + [511, 512, 513, 4095, 4096, 8192, 100000]:
        splits, chunk = tda.plan_splits(B, KV, n, 132, head_blocks, rows_pass)
        bounds = [(s * chunk, min((s + 1) * chunk, n)) for s in range(splits)]
        assert all(lo < hi for lo, hi in bounds)                  # none empty
        assert bounds[0][0] == 0 and bounds[-1][1] == n           # rows 0..n-1
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))  # once each
        assert chunk % rows_pass == 0 and 1 <= splits <= tda.SPLIT_MAX
        if n <= rows_pass:
            assert splits == 1


def test_kernel_plan_at_generate_and_long_caches():
    # generate's decode step (B8 H16 D64 bf16, at most 256 rows): one
    # 16-warp block a head, no merge
    for n in (1, 129, 255, 256):
        assert tda.kernel_plan(8, 16, 16, 64, 2, n, 132) == (1, 16, 1, 256)
    # a 4096-row cache at B2: 4-warp blocks, 16 chunks of 256 rows
    assert tda.kernel_plan(2, 16, 16, 64, 2, 4096, 132) == (1, 4, 16, 256)
    # GQA H16/KV4: 4 heads a block, 4 warps
    G, W, splits, chunk = tda.kernel_plan(4, 16, 4, 64, 2, 256, 132)
    assert (G, W) == (4, 4) and splits * chunk >= 256
    # a single head group still fills the card with chunks, up to SPLIT_MAX
    assert tda.kernel_plan(1, 8, 1, 64, 2, 8192, 132)[2] == tda.SPLIT_MAX


@pytest.mark.parametrize("rep,G", [(1, 1), (2, 2), (3, 1), (4, 4), (6, 2), (8, 8), (16, 8)])
def test_heads_per_block_divides_the_group(rep, G):
    assert tda.heads_per_block(rep) == G and rep % G == 0


def test_rows_per_pass():
    assert tda.rows_per_pass(64, 2, 16) == 256   # 8 lanes a row, 4 rows a warp load
    assert tda.rows_per_pass(64, 4, 16) == 128   # fp32: 16 lanes a row
    assert tda.rows_per_pass(256, 4, 4) == 16    # 64 loads a row over 32 lanes
