"""The paged decode kernel's split-K plan and arithmetic, on the CPU.

The kernel (``csrc/paged_decode_attention.cu``) cuts each slot's block
table into chunks of whole pages across blocks and merges the live chunks'
partial softmax states by their log-sum-exp. Here:

- the planner (``kernel_plan``): every row of the table's ``n * page`` in
  exactly one chunk, chunk edges on page boundaries and whole passes, no
  chunk past the table, and no ``pos`` among its inputs (it lives on the
  device in serving);
- :func:`paged_decode_attention_split_ref`, the split computation in plain
  PyTorch, against the JAX package's Pallas ``paged_decode_attention`` in
  interpret mode, as ``tests/test_torch_paged_attention.py`` runs it: fp32
  pools (also holding bf16-rounded values, the bf16 pools' numbers), the
  int8 mode with scales (a fresh page at scale 0, garbage codes in the
  scratch page), MHA and GQA H16/KV4, pos on both sides of every chunk edge,
  tolerance 1e-5 (f32 sums in another order);
- bf16 pools and q against the unsplit plain version: 1e-2 (the output
  rounds to bf16, one ulp ~4e-3 of the largest value);
- poisoned scratch entries and rows past pos leave the output unchanged,
  bit for bit; a slot with no live row gives zeros, as the kernel does.

The kernel itself runs only on the card (``test_torch_cuda_kernels.py``)."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.decode_attention import paged_decode_attention as j_paged_kernel
from deepspeed_tpu_torch.ops import decode_attention as tda
from deepspeed_tpu_torch.ops import paged_decode_attention as pda

TOL = dict(atol=1e-5, rtol=1e-5)
t = torch.from_numpy


def _case(B, H, KV, D, page, P, n, seed, int8=False):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, H, D).astype(np.float32)
    if int8:
        kp = rs.randint(-127, 128, (P, KV, page, D)).astype(np.int8)
        vp = rs.randint(-127, 128, (P, KV, page, D)).astype(np.int8)
        sc = rs.uniform(0.002, 0.02, (P, KV, 2)).astype(np.float32)
    else:
        kp = rs.randn(P, KV, page, D).astype(np.float32)
        vp = rs.randn(P, KV, page, D).astype(np.float32)
        sc = None
    bt = rs.choice(np.arange(1, P), (B * n,), replace=False).reshape(B, n).astype(np.int32)
    return q, kp, vp, bt, sc


def _jax(q, kp, vp, bt, pos, sc=None):
    return np.asarray(j_paged_kernel(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(pos, jnp.int32), interpret=True,
        scales=None if sc is None else jnp.asarray(sc)))


def _split(q, kp, vp, bt, pos, chunk, sc=None):
    return pda.paged_decode_attention_split_ref(
        t(q), t(kp), t(vp), t(bt), t(np.asarray(pos, np.int32)), chunk,
        scales=None if sc is None else t(sc)).numpy()


def _edges(rows, chunk, B):
    """Per-slot positions: 0, both sides of every chunk edge, the table's
    last row and past it, dealt over B slots in rounds."""
    ps = {0, rows - 1, rows + 5}
    for e in range(chunk, rows, chunk):
        ps.update({e - 1, e})
    ps = sorted(ps)
    return [ps[i:i + B] + [0] * (B - len(ps[i:i + B])) for i in range(0, len(ps), B)]


# ---- the plan ----------------------------------------------------------------

PLAN_SHAPES = [  # B, H, KV, D, itemsize, page, n
    (8, 16, 16, 64, 2, 16, 12), (8, 16, 16, 64, 1, 16, 36), (8, 16, 16, 64, 2, 16, 36),
    (2, 16, 16, 64, 2, 16, 256), (1, 16, 16, 64, 1, 16, 512), (4, 16, 4, 64, 1, 16, 8),
    (4, 8, 8, 128, 2, 8, 64), (3, 4, 2, 256, 4, 64, 4), (2, 4, 4, 64, 4, 8, 64),
    (64, 16, 16, 64, 2, 16, 36), (1, 8, 1, 64, 2, 12, 100), (1, 32, 32, 128, 1, 64, 1),
]


@pytest.mark.parametrize("B,H,KV,D,itemsize,page,n", PLAN_SHAPES)
def test_plan_covers_the_table_in_whole_pages(B, H, KV, D, itemsize, page, n):
    G, W, splits, chunk = pda.kernel_plan(B, H, KV, D, itemsize, page, n, 132)
    rows = n * page
    bounds = [(s * chunk, min((s + 1) * chunk, rows)) for s in range(splits)]
    assert (H // KV) % G == 0 and W in (4, 16)
    assert all(lo < hi for lo, hi in bounds)                      # no empty chunk
    assert bounds[0][0] == 0 and bounds[-1][1] == rows            # the table, no further
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))  # each row once
    assert chunk % page == 0                                      # edges on page boundaries
    assert chunk % tda.rows_per_pass(D, itemsize, W) == 0 or splits == 1  # whole passes
    assert 1 <= splits <= tda.SPLIT_MAX
    if W == 16:
        assert splits == 1 and G <= 2 and rows <= tda.rows_per_pass(D, itemsize, 16)


def test_plan_is_decided_from_shapes_alone():
    """No ``pos`` among the planner's inputs: serving's pos lives on the
    device, and reading it would add a host sync per step."""
    assert "pos" not in inspect.signature(pda.kernel_plan).parameters


def test_plan_at_the_serving_shapes():
    # phase 2's decode shape (bf16, 12 pages of 16): one 16-warp block a head
    assert pda.kernel_plan(8, 16, 16, 64, 2, 16, 12, 132) == (1, 16, 1, 192)
    # 3c's verify shape (int8, 36 pages of 16): 5 chunks of 128 rows
    assert pda.kernel_plan(8, 16, 16, 64, 1, 16, 36, 132) == (1, 4, 5, 128)
    # GQA H16/KV4: 4 heads a block
    assert pda.kernel_plan(4, 16, 4, 64, 1, 16, 8, 132)[0] == 4


# ---- the split computation -------------------------------------------------------

@pytest.mark.parametrize("H,KV", [(4, 4), (16, 4)])
@pytest.mark.parametrize("chunk_pages", [1, 2, 3, 6])
def test_split_matches_the_pallas_kernel(chunk_pages, H, KV):
    page, n = 8, 6
    q, kp, vp, bt, _ = _case(4, H, KV, 64, page, 40, n, seed=chunk_pages + H)
    chunk = chunk_pages * page
    for pos in _edges(n * page, chunk, 4):
        np.testing.assert_allclose(_split(q, kp, vp, bt, pos, chunk),
                                   _jax(q, kp, vp, bt, pos), **TOL)


@pytest.mark.parametrize("H,KV", [(4, 4), (16, 4)])
def test_split_on_bf16_pool_values_matches_the_pallas_kernel(H, KV):
    """The bf16 pools' numbers: values rounded to bf16, computed in f32."""
    page, n = 16, 4
    q, kp, vp, bt, _ = _case(3, H, KV, 64, page, 24, n, seed=7)
    q, kp, vp = (t(x).to(torch.bfloat16).float().numpy() for x in (q, kp, vp))
    for pos in _edges(n * page, 2 * page, 3):
        np.testing.assert_allclose(_split(q, kp, vp, bt, pos, 2 * page),
                                   _jax(q, kp, vp, bt, pos), **TOL)


@pytest.mark.parametrize("H,KV", [(4, 4), (16, 4)])
@pytest.mark.parametrize("chunk_pages", [1, 2, 5])
def test_int8_split_matches_the_pallas_kernel(chunk_pages, H, KV):
    """Scales on the score and the probability; a fresh page (scale 0)
    inside slot 0's live range reads 0; garbage codes in the scratch page
    of the inactive slot 3."""
    page, n = 8, 5
    q, kp, vp, bt, sc = _case(4, H, KV, 64, page, 32, n, seed=20 + chunk_pages, int8=True)
    sc[bt[0, 1]] = 0.0
    bt[3] = 0
    chunk = chunk_pages * page
    for pos in _edges(n * page, chunk, 3):
        pos = pos + [n * page - 1]
        np.testing.assert_allclose(_split(q, kp, vp, bt, pos, chunk, sc),
                                   _jax(q, kp, vp, bt, pos, sc), **TOL)


@pytest.mark.parametrize("chunk_pages", [1, 3])
def test_bf16_split_matches_the_plain_version(chunk_pages):
    page, n = 16, 6
    q, kp, vp, bt, _ = _case(4, 16, 4, 64, page, 32, n, seed=30)
    q, kp, vp = (t(x).to(torch.bfloat16) for x in (q, kp, vp))
    for pos in _edges(n * page, chunk_pages * page, 4):
        pos_t = t(np.asarray(pos, np.int32))
        got = pda.paged_decode_attention_split_ref(q, kp, vp, t(bt), pos_t, chunk_pages * page)
        ref = pda.paged_decode_attention_ref(q, kp, vp, t(bt), pos_t)
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        torch.testing.assert_close(got.float(), ref.float(), rtol=0, atol=1e-2)


def test_split_ignores_poisoned_scratch_and_rows_past_pos():
    page, n = 8, 6
    q, kp, vp, bt, _ = _case(2, 4, 4, 64, page, 20, n, seed=40)
    pos = [19, 0]
    bt[1, 1:] = 0  # slot 1 holds one live row; the rest of its table is scratch
    want = _split(q, kp, vp, bt, pos, 2 * page)
    live = {int(bt[0, 0]), int(bt[0, 1]), int(bt[0, 2]), int(bt[1, 0])}
    kp2, vp2 = kp.copy(), vp.copy()
    for pg in range(20):
        if pg not in live:
            kp2[pg], vp2[pg] = 1e4, -1e4
    kp2[bt[0, 2], :, 4:], vp2[bt[0, 2], :, 4:] = 1e4, -1e4  # slot 0's rows 20..23
    np.testing.assert_array_equal(_split(q, kp2, vp2, bt, pos, 2 * page), want)


def test_split_of_a_slot_with_no_live_row_is_zero():
    q, kp, vp, bt, _ = _case(2, 4, 4, 64, 8, 20, 3, seed=41)
    got = _split(q, kp, vp, bt, [-1, 5], 8)
    assert (got[0] == 0).all() and np.abs(got[1]).max() > 0


def test_split_refuses_a_chunk_off_the_page_grid():
    q, kp, vp, bt, _ = _case(1, 4, 4, 64, 8, 8, 2, seed=42)
    with pytest.raises(ValueError, match="multiple of the page"):
        _split(q, kp, vp, bt, [3], 12)
