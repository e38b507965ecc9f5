"""The paged multi-token kernel's tensor-core route: its rule, its split-K
plan and its walk, on the CPU.

The kernel (``csrc/paged_multitoken_attention.cu``) takes 64-row units
(64 tokens of one query head, or for T < 64 the T tokens of several heads
of a GQA group stacked), cuts each slot's block table into chunks of whole
pages across blocks, and merges the live chunks' partial softmax states by
their log-sum-exp in chunk order. Here:

- the route (``tensor_core_route``): q bf16/fp16, a pool of q's dtype or
  int8, D 64/128, a page a multiple of 8; fp32 stays on the exact kernel;
- the planner (``kernel_plan``): every row of the table's ``n * page`` in
  exactly one chunk, chunk edges on page boundaries, no ``base`` among its
  inputs (it lives on the device in serving), units stacked within 64 rows,
  and at phase 3b/3c's chunk shape enough blocks to fill 132 SMs;
- :func:`paged_multitoken_attention_split_ref`, the kernel's walk in plain
  PyTorch (units, chunks, the merge through ``merge_partials``), against
  the JAX package's Pallas ``paged_multitoken_attention`` in interpret mode
  (as ``tests/test_torch_multitoken_attention.py`` runs it): f32 pools and
  the int8 mode with scales (a fresh page at scale 0), ragged bases on and
  off page edges, MHA and GQA H16/KV4, T = 1, 5, 37 and 64, chunks of one
  and three pages and the plan's own, tolerance 1e-5 (f32 sums in another
  order);
- bf16 q and pools against the plain version: 1e-2 (P and the output
  round to bf16, one ulp ~4e-3 of the largest value);
- a poisoned scratch page and rows past every query leave the output
  unchanged, bit for bit; T = 1 equals the single-token plain version.

The kernel itself runs only on the card (``test_torch_cuda_kernels.py``)."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.decode_attention import (
    paged_multitoken_attention as j_multitoken_kernel,
)
from deepspeed_tpu_torch.ops import paged_decode_attention as pda
from deepspeed_tpu_torch.ops import paged_multitoken_attention as pma

TOL = dict(atol=1e-5, rtol=1e-5)
t = torch.from_numpy


def _case(B, T, H, KV, D, page, P, n, seed, int8=False):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, T, H, D).astype(np.float32)
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


def _jax(q, kp, vp, bt, base, sc=None):
    return np.asarray(j_multitoken_kernel(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(base, jnp.int32), interpret=True,
        scales=None if sc is None else jnp.asarray(sc)))


def _plan(B, T, H, KV, page, n, chunk_pages=None):
    """The kernel's plan for the shape, its chunk replaced by ``chunk_pages``
    pages when given (to walk more chunks than a small table's plan has)."""
    heads, tokens, units, splits, chunk = pma.kernel_plan(B, T, H, KV, page, n, 132)
    if chunk_pages is not None:
        chunk = chunk_pages * page
        splits = -(-n * page // chunk)
    return heads, tokens, units, splits, chunk


def _split(q, kp, vp, bt, base, plan, sc=None):
    return pma.paged_multitoken_attention_split_ref(
        t(q), t(kp), t(vp), t(bt), t(np.asarray(base, np.int32)), plan,
        scales=None if sc is None else t(sc)).numpy()


# ---- the route and the plan ---------------------------------------------------

def test_route_rule_is_on_shapes_alone():
    bf = torch.zeros(1, 4, 2, 64, dtype=torch.bfloat16)
    pool = torch.zeros(4, 2, 16, 64, dtype=torch.bfloat16)
    assert pma.tensor_core_route(bf, pool)
    assert pma.tensor_core_route(bf.half(), pool.half())
    assert pma.tensor_core_route(bf, pool.to(torch.int8))
    assert pma.tensor_core_route(bf, torch.zeros(4, 2, 8, 64, dtype=torch.bfloat16))
    assert pma.tensor_core_route(torch.zeros(1, 4, 2, 128).half(),
                                 torch.zeros(4, 2, 48, 128).half())
    assert not pma.tensor_core_route(bf.float(), pool.float())      # fp32: the exact kernel
    assert not pma.tensor_core_route(bf, pool.half())               # another 16-bit pool
    assert not pma.tensor_core_route(torch.zeros(1, 4, 2, 256).half(),
                                     torch.zeros(4, 2, 16, 256).half())  # D 256
    assert not pma.tensor_core_route(bf, torch.zeros(4, 2, 12, 64, dtype=torch.bfloat16))


PLAN_SHAPES = [  # B, T, H, KV, page, n
    (1, 64, 16, 16, 16, 36), (1, 512, 16, 16, 16, 128), (8, 1, 16, 16, 16, 12),
    (4, 5, 16, 4, 16, 8), (2, 37, 8, 8, 8, 24), (3, 100, 8, 2, 32, 12), (2, 20, 4, 4, 48, 6),
    (1, 7, 32, 4, 16, 1), (64, 64, 16, 16, 16, 36), (2, 1, 16, 1, 64, 64),
]


@pytest.mark.parametrize("B,T,H,KV,page,n", PLAN_SHAPES)
def test_plan_covers_the_table_in_whole_pages(B, T, H, KV, page, n):
    heads, tokens, units, splits, chunk = pma.kernel_plan(B, T, H, KV, page, n, 132)
    rows = n * page
    bounds = [(s * chunk, min((s + 1) * chunk, rows)) for s in range(splits)]
    assert all(lo < hi for lo, hi in bounds)                      # no empty chunk
    assert bounds[0][0] == 0 and bounds[-1][1] == rows            # the table, no further
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))  # each row once
    assert chunk % page == 0 and (chunk % pma.KEY_TILE == 0 or splits == 1)
    assert 1 <= splits <= 64
    # units stack at most 64 rows: the heads of one GQA group, all T tokens
    assert heads * tokens <= pma.UNIT_ROWS and (H // KV) % heads == 0
    assert tokens == (pma.UNIT_ROWS if T >= pma.UNIT_ROWS else T)
    assert heads == 1 or tokens == T
    assert units == B * KV * (H // KV // heads) * -(-T // tokens)
    # every (token, head) of every slot in exactly one unit
    seen = [(b, tk, h) for u in range(units)
            for b, _, _, rows_ in [pma._unit_rows(u, (heads, tokens, units), T, H, KV)]
            for tk, h in rows_]
    assert sorted(seen) == [(b, tk, h) for b in range(B) for tk in range(T) for h in range(H)]


def test_plan_is_decided_from_shapes_alone():
    """No ``base`` among the planner's inputs: serving's base lives on the
    device, and reading it would add a host sync per call."""
    assert "base" not in inspect.signature(pma.kernel_plan).parameters


def test_plan_at_the_serving_shapes():
    # 3b's and 3c's chunk program: one slot, 64 tokens, H16, a 36-page
    # table of 16: 16 units of 64 tokens in 9 chunks of 64 rows, 144 blocks
    plan = pma.kernel_plan(1, 64, 16, 16, 16, 36, 132)
    assert plan == (1, 64, 16, 9, 64)
    assert plan[2] * plan[3] >= 132
    # a GQA group stacks: T=5 over H16/KV4 puts 4 heads of 5 tokens a unit,
    # one unit a (slot, kv head)
    assert pma.kernel_plan(4, 5, 16, 4, 16, 8, 132)[:3] == (4, 5, 16)
    # T=1 over MHA: one token a unit
    assert pma.kernel_plan(8, 1, 16, 16, 16, 12, 132)[:3] == (1, 1, 128)


# ---- the walk ---------------------------------------------------------------------

def _bases(T, rows, B, page):
    """Per-slot bases: 0, a page edge and one past it, mid-page, and the
    last query at (and past) the table's last row."""
    cands = [0, page, page + 3, rows - T, rows - T + 5, 2 * page - 1]
    return [max(0, cands[(i * 2 + T) % len(cands)]) for i in range(B)]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("H,KV", [(4, 4), (16, 4)])
@pytest.mark.parametrize("T", [1, 5, 37, 64])
def test_split_matches_the_pallas_kernel(T, H, KV, int8):
    B, D, page, n = 3, 64, 8, 12
    q, kp, vp, bt, sc = _case(B, T, H, KV, D, page, 48, n, seed=T + H, int8=int8)
    if int8:
        sc[bt[0, 1]] = 0.0  # a fresh page inside slot 0's live range: values 0
    base = _bases(T, n * page, B, page)
    want = _jax(q, kp, vp, bt, base, sc)
    for chunk_pages in (None, 1, 3):
        plan = _plan(B, T, H, KV, page, n, chunk_pages)
        np.testing.assert_allclose(_split(q, kp, vp, bt, base, plan, sc), want, **TOL)


@pytest.mark.parametrize("int8", [False, True])
def test_bf16_split_matches_the_plain_version(int8):
    B, T, H, KV, D, page, n = 2, 37, 16, 4, 64, 16, 8
    q, kp, vp, bt, sc = _case(B, T, H, KV, D, page, 24, n, seed=30, int8=int8)
    q = t(q).to(torch.bfloat16)
    kp, vp = (t(x) if int8 else t(x).to(torch.bfloat16) for x in (kp, vp))
    scales = t(sc) if int8 else None
    base = t(np.asarray([20, 90], np.int32))
    for chunk_pages in (None, 2):
        plan = _plan(B, T, H, KV, page, n, chunk_pages)
        got = pma.paged_multitoken_attention_split_ref(q, kp, vp, t(bt), base, plan,
                                                       scales=scales)
        ref = pma.paged_multitoken_attention_ref(q, kp, vp, t(bt), base, scales=scales)
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        torch.testing.assert_close(got.float(), ref.float(), rtol=0, atol=1e-2)


def test_split_ignores_poisoned_scratch_and_rows_past_every_query():
    B, T, H, KV, D, page, n = 2, 5, 4, 4, 64, 8, 6
    q, kp, vp, bt, _ = _case(B, T, H, KV, D, page, 20, n, seed=40)
    base = [14, 0]  # slot 0 reads rows 0..18, slot 1 rows 0..4
    bt[1, 1:] = 0   # slot 1's table past its live page is the scratch page
    plan = _plan(B, T, H, KV, page, n, 1)
    want = _split(q, kp, vp, bt, base, plan)
    live = {int(bt[0, 0]), int(bt[0, 1]), int(bt[0, 2]), int(bt[1, 0])}
    kp2, vp2 = kp.copy(), vp.copy()
    for pg in range(20):
        if pg not in live:
            kp2[pg], vp2[pg] = 1e4, -1e4
    kp2[bt[0, 2], :, 3:], vp2[bt[0, 2], :, 3:] = 1e4, -1e4  # slot 0's rows 19..23
    np.testing.assert_array_equal(_split(q, kp2, vp2, bt, base, plan), want)


def test_split_at_t1_is_the_single_token_plain_version():
    B, H, KV, D, page, n = 4, 16, 4, 64, 8, 10
    q, kp, vp, bt, _ = _case(B, 1, H, KV, D, page, 48, n, seed=41)
    base = np.asarray([0, 7, 8, 79], np.int32)
    got = _split(q, kp, vp, bt, base, _plan(B, 1, H, KV, page, n, 2))
    st = pda.paged_decode_attention_ref(t(np.ascontiguousarray(q[:, 0])), t(kp), t(vp), t(bt),
                                        t(base)).numpy()
    np.testing.assert_allclose(got[:, 0], st, **TOL)


def test_split_refuses_a_chunk_off_the_page_grid():
    q, kp, vp, bt, _ = _case(1, 4, 4, 4, 64, 8, 8, 2, seed=42)
    with pytest.raises(ValueError, match="multiple of the page"):
        _split(q, kp, vp, bt, [3], (1, 4, 4, 1, 12))
