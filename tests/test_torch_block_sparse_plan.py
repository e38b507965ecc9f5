"""The block-sparse kernels' schedule and walks on the TMA + wgmma route
(``csrc/block_sparse_attention_bwd.cu``: dq, dk/dv;
``csrc/block_sparse_attention_fwd.cu``: the forward, on dq's schedule), on
the CPU.

- The host plan (``ops.block_sparse_attention.bwd_plan``): every 64-row
  unit of every head in exactly one item, the two units of an item in one
  head, headers heaviest first with ties by unit; each unit's tiles (the
  entries carrying its bit) are the 64-row tiles that hold at least one
  pair the layout and the causal rule keep, so the kept pairs they hold sum
  to ``chip_smoke.bs_pairs``'s count; the entries ascend and each is walked
  by at least one unit of its item. At the GPT-2 layout (phase 11's
  section at S4096), BERT's Fixed bidirectional layout at the route's
  blocks (64 and 128), and a custom layout whose first query block lists
  only the block above the diagonal (an empty dq row under the causal rule).
- The plan cached in ``IndexLists`` (the same tensor on a second call).
- A plain PyTorch model of the kernels' walk (:func:`_walk`: the plan's
  items in order, each unit's tiles 64 rows
  at a time with the unit's bit and the causal rule as the mask, steps of
  two tiles at D64 as the kernels take them) against
  ``block_sparse_attention_{dq,dkv}_ref`` in fp32 (1e-5: sums in another
  order), and against the JAX package's ``_bwd`` in Pallas interpret mode
  at block 64, S 512, 2 heads (5e-4, the tolerance of
  ``tests/test_torch_block_sparse_attention.py``).
- A plain model of the forward's walk over dq's plan (:func:`_fwd_walk`:
  the paired units, each step's tiles masked by the unit's bit and the
  causal rule with p = 0 and no change of the running max, the online
  softmax, O and lse stored once) against
  ``block_sparse_attention_fwd_ref`` in fp32 (1e-5), and against the JAX
  package's ``_fwd`` in Pallas interpret mode at block 64, S 512, 2 heads,
  with the custom layout's empty first row (o = 0 and lse = +1e30, exactly).

The kernels themselves run only on the card (``test_torch_cuda_kernels.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from deepspeed_tpu.ops.pallas import block_sparse_attention as jbsa
from deepspeed_tpu_torch.ops import block_sparse_attention as tbsa
from deepspeed_tpu_torch.ops.sparse_attention import from_ds_config
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as tsc
from deepspeed_tpu_torch.tools.profile_training import GPT2_SPARSE_SECTION

TILE = 64
WALK_TOL, GRAD_TOL = 1e-5, 5e-4


def _custom(H, S, blk):
    """Causal-lower layout whose first query block lists only block 1."""
    nb = S // blk
    layout = np.tril(np.ones((H, nb, nb), bool))
    layout[:, 0, 0] = False
    layout[:, 0, 1] = True
    return layout


# label -> (layout, block, causal)
LAYOUTS = {
    "gpt2": lambda: (from_ds_config(GPT2_SPARSE_SECTION, 16).make_layout(4096), 64, True),
    "bert blk64": lambda: (from_ds_config({"mode": "fixed", "block": 64}, 16).make_layout(512),
                           64, False),
    "bert blk128": lambda: (from_ds_config({"mode": "fixed", "block": 128}, 4).make_layout(1024),
                            128, False),
    "custom blk64": lambda: (_custom(2, 512, 64), 64, True),
    "bslongformer blk128 causal": lambda: (
        tsc.BSLongformerSparsityConfig(num_heads=2, block=128,
                                       attention="unidirectional").make_layout(1024), 128, True),
}


def _items(plan, H, U):
    """The plan's items in order → [(u0, u1, entries int64 array)]."""
    n_pairs = H * ((U + 1) // 2)
    head = plan[: 4 * n_pairs].reshape(n_pairs, 4)
    body = plan[4 * n_pairs:]
    return [(int(a), int(b), body[off: off + n].astype(np.int64)) for a, b, off, n in head]


def _cells(layout, block, causal, which):
    """``[H, U, U]``: the pairs the layout and the causal rule keep in each
    (unit, tile) cell, rows of the kernel's units (queries for dq, keys for
    dk/dv) against rows of its tiles, counted element by element."""
    H = layout.shape[0]
    S = layout.shape[1] * block
    U = S // TILE
    out = np.zeros((H, U, U), np.int64)
    for h in range(H):
        keep = layout[h].repeat(block, 0).repeat(block, 1)  # [query, key]
        if causal:
            keep = keep & np.tril(np.ones((S, S), bool))
        if which == "dkv":
            keep = keep.T
        out[h] = keep.reshape(U, TILE, U, TILE).sum(axis=(1, 3))
    return out


@pytest.mark.parametrize("which", ["dq", "dkv"])
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_plan_covers_every_unit_once_heaviest_first(name, which):
    layout, block, causal = LAYOUTS[name]()
    H, nb, _ = layout.shape
    U = nb * block // TILE
    items = _items(tbsa.bwd_plan(layout, block, causal, which), H, U)
    units = [u for a, b, _ in items for u in (a, b) if u >= 0]
    assert sorted(units) == list(range(H * U))  # every unit exactly once
    for a, b, _ in items:
        assert b == -1 or a // U == b // U  # one head an item
    counts = [(len(e), a) for a, _, e in items]
    assert counts == sorted(counts, key=lambda c: (-c[0], c[1]))  # heaviest first, ties by unit
    assert sum(b == -1 for _, b, _ in items) == H * (U % 2)


@pytest.mark.parametrize("which", ["dq", "dkv"])
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_plan_tiles_hold_exactly_the_kept_pairs(name, which):
    layout, block, causal = LAYOUTS[name]()
    H, nb, _ = layout.shape
    S, U = nb * block, nb * block // TILE
    cell = _cells(layout, block, causal, which)
    items = _items(tbsa.bwd_plan(layout, block, causal, which), H, U)
    total = 0
    for a, b, entries in items:
        rows, bits = entries >> 2, entries & 3
        assert np.all(np.diff(rows) > 0) and np.all(rows % TILE == 0) and np.all(rows < S)
        assert np.all(bits > 0)  # every entry is walked by a unit of the item
        for c, u in enumerate((a, b)):
            if u < 0:
                assert not np.any(bits & 2)
                continue
            h, uu = divmod(u, U)
            mine = rows[(bits >> c) & 1 == 1] // TILE
            np.testing.assert_array_equal(mine, np.nonzero(cell[h, uu])[0])
            total += int(cell[h, uu, mine].sum())
    lists = tbsa.lists_from_layout(layout, block, "cpu")
    assert total == chip_smoke.bs_pairs(lists, causal)


def test_custom_layout_has_an_empty_dq_unit():
    layout, block, causal = LAYOUTS["custom blk64"]()
    H, U = layout.shape[0], layout.shape[1] * block // TILE
    items = _items(tbsa.bwd_plan(layout, block, causal, "dq"), H, U)
    walked = {u: int(np.sum((e >> c) & 1)) for a, b, e in items
              for c, u in enumerate((a, b)) if u >= 0}
    assert walked[0] == 0 and walked[U] == 0  # unit 0 of each head sees nothing
    assert all(n > 0 for u, n in walked.items() if u % U)


def test_plan_is_cached_in_the_index_lists():
    cfg = from_ds_config(GPT2_SPARSE_SECTION, 4)
    lists = tbsa.index_lists(cfg, 1024, "cpu")
    for which in ("dq", "dkv"):
        plan = lists.bwd_plan(which, True)
        assert plan.dtype == torch.int32 and plan.device == lists.kidx.device
        assert lists.bwd_plan(which, True) is plan  # built once, the same tensor after
        np.testing.assert_array_equal(plan.numpy(),
                                      tbsa.bwd_plan(lists.layout, 64, True, which))
    assert lists.bwd_plan("dq", False) is not lists.bwd_plan("dq", True)
    assert tbsa.index_lists(cfg, 1024, "cpu").bwd_plan("dq", True) is lists.bwd_plan("dq", True)


def test_plan_refuses_blocks_the_route_does_not_take():
    """Both sides' plans take blocks of 16 and 32 as grouped plans (dq's,
    which the forward walks too, the query side's) and 64 and 128 as paired
    64-row units; both refuse 8."""
    layout = np.ones((1, 8, 8), bool)
    for blk in (16, 32):
        for which in ("dq", "dkv"):
            plan = tbsa.bwd_plan(layout, blk, True, which)
            np.testing.assert_array_equal(plan,
                                          tbsa.dkv_group_plan(layout, blk, True, which)[0])
        np.testing.assert_array_equal(tbsa.bwd_plan(layout, blk, True, "dkv"),
                                      tbsa.dkv_group_plan(layout, blk, True)[0])
    for which in ("dq", "dkv"):
        with pytest.raises(ValueError, match="multiple of 64"):
            tbsa.bwd_plan(layout, 8, True, which)
    with pytest.raises(ValueError, match="block 64"):
        tbsa.dkv_group_plan(layout, 64, True)
    with pytest.raises(ValueError, match="'fwd'"):
        tbsa.dkv_group_plan(layout, 16, True, "fwd")


def test_wgmma_route_rule():
    """A rule on dtype and head dim alone, the same for the forward, dq and
    dk/dv at every block (16-128): bf16/fp16 at D 64 or 128 take wgmma;
    fp32 and other head dims never."""
    q = torch.zeros(1, 256, 2, 64, dtype=torch.bfloat16)
    assert tbsa.wgmma_route(q) and tbsa.wgmma_route(q.half())
    assert tbsa.wgmma_route(torch.zeros(1, 256, 2, 128, dtype=torch.float16))
    assert not tbsa.wgmma_route(q.float())
    assert not tbsa.wgmma_route(q[..., :32]) and not tbsa.wgmma_route(q.float()[..., :32])


# ---------------------------------------------------------------------------
# a plain model of the kernels' walk
# ---------------------------------------------------------------------------

def _walk(q, k, v, do, lse, delta, lists, causal, sm_scale, which, step_tiles):
    """The kernels' walk in plain PyTorch: the plan's items in order, each
    item's entries ``step_tiles`` at a time (two at D64, one at D128), each
    unit of the item taking the tiles its bit marks, masked by the causal
    rule inside them, its sums over the item's steps in the kernels' order
    and one store (dq and dk scaled once). → dq, or (dk, dv), in q's dtype."""
    B, S, H, D = q.shape
    U = S // TILE
    plan = lists.bwd_plan(which, causal).cpu().numpy()
    dt = q.dtype
    out = [torch.zeros(B, S, H, D) for _ in range(1 if which == "dq" else 2)]
    for a, b, entries in _items(plan, H, U):
        for bb in range(B):
            for c, u in enumerate((a, b)):
                if u < 0:
                    continue
                h, uu = divmod(u, U)
                r0 = uu * TILE
                mine = torch.arange(r0, r0 + TILE)
                accs = [torch.zeros(TILE, D) for _ in out]
                for j in range(0, len(entries), step_tiles):
                    for e in entries[j: j + step_tiles]:
                        if not (e >> c) & 1:
                            continue  # the kernels' select to 0
                        t = torch.arange(e >> 2, (e >> 2) + TILE)
                        if which == "dq":
                            rows, cols = mine, t
                        else:
                            rows, cols = t, mine
                        keep = torch.ones(TILE, TILE, dtype=torch.bool) if not causal else \
                            cols[None, :] <= rows[:, None]  # [query, key]
                        qr, kr = q[bb, rows, h].float(), k[bb, cols, h].float()
                        s = qr @ kr.T * sm_scale
                        p = torch.exp(s - lse[bb, h, rows, None]).masked_fill(~keep, 0.0)
                        dp = do[bb, rows, h].float() @ v[bb, cols, h].float().T
                        ds = (p * (dp - delta[bb, h, rows, None])).to(dt).float()
                        if which == "dq":
                            accs[0] += ds @ kr
                        else:
                            accs[0] += ds.T @ qr
                            accs[1] += p.to(dt).float().T @ do[bb, rows, h].float()
                out[0][bb, mine, h] = accs[0] * sm_scale
                if which == "dkv":
                    out[1][bb, mine, h] = accs[1]
    return out[0].to(dt) if which == "dq" else (out[0].to(dt), out[1].to(dt))


def _qkv(B, S, H, D, seed):
    rs = np.random.RandomState(seed)
    q, k, v, do = (rs.randn(B, S, H, D).astype(np.float32) for _ in range(4))
    return q, k, v, do * np.float32(0.1)


WALK_CASES = {  # label -> (layout maker, block, causal)
    "gpt2-like fixed blk64 causal": (
        lambda H, S: from_ds_config(dict(GPT2_SPARSE_SECTION), H).make_layout(S), 64, True),
    "fixed blk64 bidirectional": (
        lambda H, S: from_ds_config({"mode": "fixed", "block": 64, "num_local_blocks": 2}, H)
        .make_layout(S), 64, False),
    "bigbird per head blk64 causal": (
        lambda H, S: tsc.BigBirdSparsityConfig(num_heads=H, block=64,
                                               different_layout_per_head=True,
                                               num_random_blocks=2,
                                               attention="unidirectional").make_layout(S),
        64, True),
    "custom empty row blk64 causal": (lambda H, S: _custom(H, S, 64), 64, True),
    "bslongformer blk128 causal": (
        lambda H, S: tsc.BSLongformerSparsityConfig(num_heads=H, block=128,
                                                    attention="unidirectional").make_layout(S),
        128, True),
}


@pytest.mark.parametrize("step_tiles", [2, 1])
@pytest.mark.parametrize("label", list(WALK_CASES))
def test_walk_matches_plain_versions(label, step_tiles):
    make, block, causal = WALK_CASES[label]
    B, S, H, D = 2, 512, 2, 32
    lists = tbsa.lists_from_layout(make(H, S), block, "cpu")
    q, k, v, do = (torch.from_numpy(x) for x in _qkv(B, S, H, D, seed=block + causal))
    scale = 1.0 / np.sqrt(D)
    o, lse = tbsa.block_sparse_attention_fwd_ref(q, k, v, lists, causal)
    delta = tbsa.block_sparse_delta(o, do)
    dq = _walk(q, k, v, do, lse, delta, lists, causal, scale, "dq", step_tiles)
    dk, dv = _walk(q, k, v, do, lse, delta, lists, causal, scale, "dkv", step_tiles)
    dq_r = tbsa.block_sparse_attention_dq_ref(q, k, v, do, lse, delta, lists, causal)
    dk_r, dv_r = tbsa.block_sparse_attention_dkv_ref(q, k, v, do, lse, delta, lists, causal)
    for got, ref in ((dq, dq_r), (dk, dk_r), (dv, dv_r)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=WALK_TOL, rtol=0)


@pytest.mark.parametrize("label", ["gpt2-like fixed blk64 causal", "fixed blk64 bidirectional",
                                   "custom empty row blk64 causal"])
def test_walk_matches_pallas_interpret(label):
    make, block, causal = WALK_CASES[label]
    B, S, H, D = 1, 512, 2, 32
    layout = make(H, S)
    q, k, v, do = _qkv(B, S, H, D, seed=11)
    scale = 1.0 / np.sqrt(D)
    to4 = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)  # noqa: E731
    kidx, kcnt, qidx, qcnt = map(jnp.asarray, jbsa.layout_to_index_lists(layout))
    o_j, lse_j = jbsa._fwd(to4(q), to4(k), to4(v), kidx, kcnt, scale, causal, block, True)
    grads_j = jbsa._bwd(to4(q), to4(k), to4(v), o_j, lse_j, to4(do), kidx, kcnt, qidx, qcnt,
                        scale, causal, block, True)
    lists = tbsa.lists_from_layout(layout, block, "cpu")
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = tbsa.block_sparse_attention_fwd_ref(tq, tk, tv, lists, causal)
    delta = tbsa.block_sparse_delta(o, tdo)
    dq = _walk(tq, tk, tv, tdo, lse, delta, lists, causal, scale, "dq", 2)
    dk, dv = _walk(tq, tk, tv, tdo, lse, delta, lists, causal, scale, "dkv", 2)
    back = lambda x: np.asarray(x).transpose(0, 2, 1, 3)  # noqa: E731
    for got, ref in zip((dq, dk, dv), grads_j):
        np.testing.assert_allclose(got.numpy(), back(ref), atol=GRAD_TOL, rtol=0)


# ---------------------------------------------------------------------------
# a plain model of the forward's walk (on dq's plan)
# ---------------------------------------------------------------------------

def _fwd_walk(q, k, v, lists, causal, sm_scale, step_tiles):
    """The forward kernel's walk in plain PyTorch: dq's plan items in order,
    both units of an item taking each step's ``step_tiles`` tiles, a tile
    its unit does not walk and the pairs the causal rule drops masked (p = 0,
    the running max unchanged), the online softmax in f32 from m = -1e30, P
    rounded to q's dtype for P·V, O and lse stored once; a row that kept no
    score gets o = 0 and lse = +1e30. → (o in q's dtype, lse)."""
    B, S, H, D = q.shape
    U = S // TILE
    plan = lists.bwd_plan("dq", causal).cpu().numpy()
    dt = q.dtype
    o = torch.zeros(B, S, H, D)
    lse = torch.zeros(B, H, S)
    for a, b, entries in _items(plan, H, U):
        for bb in range(B):
            for c, u in enumerate((a, b)):
                if u < 0:
                    continue
                h, uu = divmod(u, U)
                rows = torch.arange(uu * TILE, uu * TILE + TILE)
                qr = q[bb, rows, h].float()
                m = torch.full((TILE,), -1e30)
                l = torch.zeros(TILE)
                acc = torch.zeros(TILE, D)
                for j in range(0, len(entries), step_tiles):
                    step = entries[j: j + step_tiles]
                    cols = torch.cat([torch.arange(e >> 2, (e >> 2) + TILE) for e in step])
                    mine = torch.cat([torch.full((TILE,), bool((e >> c) & 1)) for e in step])
                    keep = mine[None, :].expand(TILE, -1)
                    if causal:
                        keep = keep & (cols[None, :] <= rows[:, None])
                    s = (qr @ k[bb, cols, h].float().T * sm_scale).masked_fill(~keep,
                                                                                float("-inf"))
                    mn = torch.maximum(m, s.amax(-1))
                    corr = torch.exp(m - mn)
                    p = torch.exp(s - mn[:, None])
                    l = l * corr + p.sum(-1)
                    acc = acc * corr[:, None] + p.to(dt).float() @ v[bb, cols, h].float()
                    m = mn
                valid = m > -0.5e30
                lc = l.clamp_min(1e-30)
                o[bb, rows, h] = torch.where(valid[:, None], acc / lc[:, None], 0.0)
                lse[bb, h, rows] = torch.where(valid, m + torch.log(lc), 1e30)
    return o.to(dt), lse


@pytest.mark.parametrize("step_tiles", [2, 1])
@pytest.mark.parametrize("label", list(WALK_CASES))
def test_forward_walk_on_the_dq_plan_matches_the_plain_version(label, step_tiles):
    make, block, causal = WALK_CASES[label]
    B, S, H, D = 2, 512, 2, 32
    lists = tbsa.lists_from_layout(make(H, S), block, "cpu")
    q, k, v, _ = (torch.from_numpy(x) for x in _qkv(B, S, H, D, seed=block + 3 * causal))
    o, lse = _fwd_walk(q, k, v, lists, causal, 1.0 / np.sqrt(D), step_tiles)
    o_r, lse_r = tbsa.block_sparse_attention_fwd_ref(q, k, v, lists, causal)
    poison = lse_r == 1e30
    assert torch.equal(lse == 1e30, poison)
    np.testing.assert_allclose(o.numpy(), o_r.numpy(), atol=WALK_TOL, rtol=0)
    np.testing.assert_allclose(lse[~poison].numpy(), lse_r[~poison].numpy(), atol=WALK_TOL,
                               rtol=WALK_TOL)


@pytest.mark.parametrize("label", ["gpt2-like fixed blk64 causal", "fixed blk64 bidirectional",
                                   "custom empty row blk64 causal"])
def test_forward_walk_matches_pallas_interpret(label):
    make, block, causal = WALK_CASES[label]
    B, S, H, D = 1, 512, 2, 32
    layout = make(H, S)
    q, k, v, _ = _qkv(B, S, H, D, seed=12)
    scale = 1.0 / np.sqrt(D)
    to4 = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)  # noqa: E731
    kidx, kcnt, _, _ = map(jnp.asarray, jbsa.layout_to_index_lists(layout))
    o_j, lse_j = jbsa._fwd(to4(q), to4(k), to4(v), kidx, kcnt, scale, causal, block, True)
    lists = tbsa.lists_from_layout(layout, block, "cpu")
    o, lse = _fwd_walk(*(torch.from_numpy(x) for x in (q, k, v)), lists, causal, scale, 2)
    o_j = np.asarray(o_j).transpose(0, 2, 1, 3)
    lse_j = np.asarray(lse_j)[..., 0]  # the TPU's 128-lane broadcast
    np.testing.assert_allclose(o.numpy(), o_j, atol=GRAD_TOL, rtol=0)
    poison = lse_j >= 1e30
    np.testing.assert_array_equal(lse.numpy() == 1e30, poison)
    np.testing.assert_allclose(lse.numpy()[~poison], lse_j[~poison], atol=GRAD_TOL, rtol=0)
    if label.startswith("custom"):
        assert poison[:, :, :block].all() and not poison[:, :, block:].any()
        assert float(o[:, :block].abs().max()) == 0.0



# ---------------------------------------------------------------------------
# dk/dv at blocks of 16 and 32: the grouped plan and a plain model of its walk
# ---------------------------------------------------------------------------

GROUP_CASES = {  # label -> (layout maker (H, S), block, causal)
    "bert fixed-bi blk16": (
        lambda H, S: from_ds_config({"mode": "fixed", "block": 16}, H).make_layout(S), 16, False),
    "fixed-uni blk16 causal": (
        lambda H, S: tsc.FixedSparsityConfig(num_heads=H, block=16, num_local_blocks=4,
                                             attention="unidirectional").make_layout(S),
        16, True),
    "bigbird blk16": (
        lambda H, S: tsc.BigBirdSparsityConfig(num_heads=H, block=16,
                                               different_layout_per_head=True,
                                               num_random_blocks=2).make_layout(S), 16, False),
    "variable blk32": (
        lambda H, S: tsc.VariableSparsityConfig(num_heads=H, block=32, num_random_blocks=1,
                                                local_window_blocks=[2, 3],
                                                global_block_indices=[1]).make_layout(S),
        32, False),
    "custom fully masked row blk16 causal": (lambda H, S: _custom(H, S, 16), 16, True),
}


def _group_items(plan, n, block):
    """The grouped plan's items in order → [(head, unit 0 key blocks, unit 1
    key blocks, tile records [n, G])]."""
    G = TILE // block
    hs = 4 + 2 * G
    head = plan[: n * hs].reshape(n, hs).astype(np.int64)
    body = plan[n * hs:].astype(np.int64)
    return [(int(r[0]), r[4: 4 + G], r[4 + G:], body[r[1] * G: (r[1] + r[2]) * G].reshape(-1, G))
            for r in head]


def _rows(blocks, block, fill):
    """64 rows of a unit or a tile: each block's rows (a padding slot, -1,
    repeats ``fill``'s), and whether each row is real."""
    rows = np.concatenate([np.arange(b, b + 1) * block + np.arange(block) if b >= 0 else
                           fill * block + np.arange(block) for b in blocks])
    real = np.repeat(np.asarray(blocks) >= 0, block)
    return rows, real


@pytest.mark.parametrize("label", list(GROUP_CASES))
def test_group_plan_covers_every_kept_pair_once(label):
    """Every (query, key) pair the layout and the causal rule keep is
    computed by exactly one unit, and no other pair: a tile entry's mask bit
    for a key block is set only where that block lists the query block.
    Every key block is in exactly one unit, whose padding slots (-1) come
    last; the two units of an item are one head's; headers are heaviest
    first; each tile's blocks ascend, padding last, and each real entry is
    taken by some key block of the item."""
    make, block, causal = GROUP_CASES[label]
    H, S = 2, 512
    G = TILE // block
    layout = make(H, S)
    plan, n = tbsa.dkv_group_plan(layout, block, causal)
    keep = np.repeat(np.repeat(layout, block, 1), block, 2)  # [H, query, key]
    if causal:
        keep = keep & np.tril(np.ones((S, S), bool))[None]
    cover = np.zeros((H, S, S), np.int64)
    owner = np.zeros((H, S // block), np.int64)
    counts = []
    for h, u0, u1, recs in _group_items(plan, n, block):
        counts.append(len(recs))
        real = recs >= 0
        assert u0[0] >= 0 and np.all(real[:, 0]) and np.all(recs[real] & 255)
        assert np.all(real[:, :-1] | ~real[:, 1:])  # padding only at a tile's end
        for r, m in zip(recs >> 8, real):
            assert np.all(np.diff(r[m]) > 0)
        for c, unit in enumerate((u0, u1)):
            blocks = unit[unit >= 0]
            assert np.all(unit[: len(blocks)] >= 0) and len(blocks) <= G  # padding at the end
            if c == 1 and len(blocks) == 0:
                assert not np.any(recs[real] & (15 << 4))
                continue
            owner[h, blocks] += 1
            for j, kb in enumerate(blocks):
                for qb in recs[real & ((recs >> (4 * c + j)) & 1 == 1)] >> 8:
                    tri = np.tril(np.ones((block, block), np.int64), (qb - kb) * block)
                    cover[h, qb * block: qb * block + block,
                          kb * block: kb * block + block] += 1 if not causal else tri
    np.testing.assert_array_equal(owner, 1)
    np.testing.assert_array_equal(cover, keep.astype(np.int64))
    assert counts == sorted(counts, reverse=True)


def test_group_plan_at_berts_layout():
    """BERT's default section at S512 (fixed bidirectional, block 16, 4
    local blocks, 1 global): a head's 32 key blocks form 8 local units of 3
    blocks (each walking its window's 4 query blocks, one 64-row tile) and 2
    global units of 4 (walking all 32 query blocks, 8 tiles); the global
    units pair and share all 8 tiles, the local ones pair among themselves.
    98,304 scored pairs a head in 64-row units against the layout's
    90,112."""
    cfg = from_ds_config({"mode": "fixed", "block": 16}, 16)
    layout = cfg.make_layout(512)
    plan, n = tbsa.dkv_group_plan(layout, 16, False)
    items = _group_items(plan, n, 16)
    assert n == 16 * 5 and len(items) == n
    for h in range(16):
        mine = [it for it in items if it[0] == h]
        glob = [it for it in mine if len(it[3]) == 8]
        assert len(glob) == 1 and np.all(glob[0][3] & 255 == 0xFF)
        np.testing.assert_array_equal(np.sort(np.r_[glob[0][1], glob[0][2]]), np.arange(3, 32, 4))
        local = [it for it in mine if len(it[3]) == 2]
        assert len(local) == 4
        for _, u0, u1, recs in local:
            for c, unit in enumerate((u0, u1)):
                w = unit[0] // 4
                np.testing.assert_array_equal(unit, [4 * w, 4 * w + 1, 4 * w + 2, -1])
                (rec,) = recs[(recs[:, 0] >> (4 * c)) & 15 != 0]
                np.testing.assert_array_equal(rec >> 8, 4 * w + np.arange(4))
                assert np.all((rec >> (4 * c)) & 15 == 0b0111)
    scored = sum(64 * 64 * int(np.sum((r[:, 0] >> (4 * c)) & 15 != 0)) for _, u0, u1, r in items
                 for c, u in enumerate((u0, u1)) if u[0] >= 0)
    assert scored == 16 * 98304 and int(layout.sum()) * 16 * 16 == 16 * 90112


def test_group_plan_fills_units_where_lists_differ():
    """Bigbird's random blocks rarely share a list: short units merge while
    that costs no more tiles, so a head's 32 key blocks fill few 64-row
    units and walk about half the tiles of one unit a block."""
    layout = tsc.BigBirdSparsityConfig(num_heads=4, block=16, different_layout_per_head=True,
                                       num_random_blocks=2).make_layout(512)
    plan, n = tbsa.dkv_group_plan(layout, 16, False)
    items = _group_items(plan, n, 16)
    units = [u for _, u0, u1, _ in items for u in (u0, u1) if u[0] >= 0]
    tiles = sum(int(np.sum(((r[:, 0] >> (4 * c)) & 15) != 0)) for _, u0, u1, r in items
                for c, u in enumerate((u0, u1)) if u[0] >= 0)
    lone = sum(-(-int(layout[h, :, j].sum()) // 4) for h in range(4) for j in range(32))
    assert len(units) <= 4 * 12 and tiles <= 0.6 * lone


def test_group_plan_is_cached_in_the_index_lists():
    cfg = from_ds_config({"mode": "fixed", "block": 16}, 4)
    lists = tbsa.index_lists(cfg, 512, "cpu")
    plan = lists.bwd_plan("dkv", False)
    assert lists.bwd_plan("dkv", False) is plan and plan.dtype == torch.int32
    flat, n = tbsa.dkv_group_plan(lists.layout, 16, False)
    np.testing.assert_array_equal(plan.numpy(), flat)
    assert lists.plan_items("dkv", False) == n == 4 * 5
    gpt = tbsa.index_lists(from_ds_config(GPT2_SPARSE_SECTION, 4), 1024, "cpu")
    assert gpt.plan_items("dkv", True) == gpt.plan_items("dq", True) == 4 * 8


def _group_walk(q, k, v, do, lse, delta, lists, causal, sm_scale, step_tiles):
    """The grouped dk/dv kernel's walk in plain PyTorch: the plan's items in
    order; each unit's 64 key rows (a padding slot repeats the unit's first
    block), each step's ``step_tiles`` tiles of 64 query rows (a padding
    slot repeats the tile's first block), a tile its unit does not walk
    skipped (the kernel's select to 0), a (key block, query block) pair
    whose mask bit is clear, padding rows and the pairs the causal rule
    drops masked to p = 0, sums in the kernel's order, and one store of the
    unit's real rows. → (dk, dv, how often each key row was stored [B, S,
    H])."""
    B, S, H, D = q.shape
    blk = lists.block
    dt = q.dtype
    items = _group_items(lists.bwd_plan("dkv", causal).numpy(), lists.plan_items("dkv", causal),
                         blk)
    dk, dv = torch.zeros(B, S, H, D), torch.zeros(B, S, H, D)
    stored = torch.zeros(B, S, H, dtype=torch.int64)
    for h, u0, u1, recs in items:
        for bb in range(B):
            for c, unit in enumerate((u0, u1)):
                if unit[0] < 0:
                    continue
                kr, kreal = _rows(unit, blk, unit[0])
                kr, kreal = torch.from_numpy(kr), torch.from_numpy(kreal)
                kt, vt = k[bb, kr, h].float(), v[bb, kr, h].float()
                adk, adv = torch.zeros(TILE, D), torch.zeros(TILE, D)
                for j in range(0, len(recs), step_tiles):
                    for rec in recs[j: j + step_tiles]:
                        if not (rec[0] >> (4 * c)) & 15:
                            continue
                        qr, qreal = _rows([x >> 8 if x >= 0 else -1 for x in rec], blk,
                                          rec[0] >> 8)
                        qr, qreal = torch.from_numpy(qr), torch.from_numpy(qreal)
                        # [query slot, key slot] mask bits, then [query, key] rows
                        bit = np.array([[x >= 0 and (x >> (4 * c + ks)) & 1 for ks in
                                         range(len(unit))] for x in rec], bool)
                        bit = torch.from_numpy(bit.repeat(blk, 0).repeat(blk, 1))
                        keep = qreal[:, None] & kreal[None, :] & bit  # [query, key]
                        if causal:
                            keep = keep & (kr[None, :] <= qr[:, None])
                        qt, dot = q[bb, qr, h].float(), do[bb, qr, h].float()
                        p = torch.exp(qt @ kt.T * sm_scale - lse[bb, h, qr, None])
                        p = p.masked_fill(~keep, 0.0)
                        ds = (p * (dot @ vt.T - delta[bb, h, qr, None])).to(dt).float()
                        adv += p.to(dt).float().T @ dot
                        adk += ds.T @ qt
                dk[bb, kr[kreal], h] = adk[kreal] * sm_scale
                dv[bb, kr[kreal], h] = adv[kreal]
                stored[bb, kr[kreal], h] += 1
    return dk.to(dt), dv.to(dt), stored


@pytest.mark.parametrize("step_tiles", [2, 1])
@pytest.mark.parametrize("label", list(GROUP_CASES))
def test_group_walk_matches_plain_versions(label, step_tiles):
    make, block, causal = GROUP_CASES[label]
    B, S, H, D = 1, 256, 2, 16
    lists = tbsa.lists_from_layout(make(H, S), block, "cpu")
    q, k, v, do = (torch.from_numpy(x) for x in _qkv(B, S, H, D, seed=block + 5 * causal))
    scale = 1.0 / np.sqrt(D)
    o, lse = tbsa.block_sparse_attention_fwd_ref(q, k, v, lists, causal)
    delta = tbsa.block_sparse_delta(o, do)
    dk, dv, stored = _group_walk(q, k, v, do, lse, delta, lists, causal, scale, step_tiles)
    assert torch.equal(stored, torch.ones_like(stored))  # every key row once, no padding row
    dk_r, dv_r = tbsa.block_sparse_attention_dkv_ref(q, k, v, do, lse, delta, lists, causal)
    for got, ref in ((dk, dk_r), (dv, dv_r)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=WALK_TOL, rtol=0)


@pytest.mark.parametrize("label", ["bert fixed-bi blk16", "fixed-uni blk16 causal",
                                   "custom fully masked row blk16 causal"])
def test_group_walk_matches_pallas_interpret(label):
    make, block, causal = GROUP_CASES[label]
    B, S, H, D = 1, 256, 2, 16
    layout = make(H, S)
    q, k, v, do = _qkv(B, S, H, D, seed=13)
    scale = 1.0 / np.sqrt(D)
    to4 = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)  # noqa: E731
    kidx, kcnt, qidx, qcnt = map(jnp.asarray, jbsa.layout_to_index_lists(layout))
    o_j, lse_j = jbsa._fwd(to4(q), to4(k), to4(v), kidx, kcnt, scale, causal, block, True)
    grads_j = jbsa._bwd(to4(q), to4(k), to4(v), o_j, lse_j, to4(do), kidx, kcnt, qidx, qcnt,
                        scale, causal, block, True)
    lists = tbsa.lists_from_layout(layout, block, "cpu")
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = tbsa.block_sparse_attention_fwd_ref(tq, tk, tv, lists, causal)
    delta = tbsa.block_sparse_delta(o, tdo)
    dk, dv, _ = _group_walk(tq, tk, tv, tdo, lse, delta, lists, causal, scale, 2)
    back = lambda x: np.asarray(x).transpose(0, 2, 1, 3)  # noqa: E731
    for got, ref in zip((dk, dv), grads_j[1:]):
        np.testing.assert_allclose(got.numpy(), back(ref), atol=GRAD_TOL, rtol=0)


# ---------------------------------------------------------------------------
# the forward and dq at blocks of 16 and 32: the query side's grouped plan
# and plain models of the two kernels' walks on it
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label", list(GROUP_CASES))
def test_query_group_plan_covers_every_kept_pair_once(label):
    """The mirror of dk/dv's check on dq's grouped plan (the forward's too):
    every (query, key) pair the layout and the causal rule keep is computed
    by exactly one query unit, and no other pair (a tile entry's bit for a
    query block is set only where that block lists the key block); every
    query block is in exactly one unit, padding slots last; the two units
    of an item are one head's; headers heaviest first; each tile's key
    blocks ascend, padding last, each real entry taken by a query block of
    the item; under the causal rule no tile holds a key block past its
    unit's last query block."""
    make, block, causal = GROUP_CASES[label]
    H, S = 2, 512
    G = TILE // block
    layout = make(H, S)
    plan, n = tbsa.dkv_group_plan(layout, block, causal, "dq")
    keep = np.repeat(np.repeat(layout, block, 1), block, 2)  # [H, query, key]
    if causal:
        keep = keep & np.tril(np.ones((S, S), bool))[None]
    cover = np.zeros((H, S, S), np.int64)
    owner = np.zeros((H, S // block), np.int64)
    counts = []
    for h, u0, u1, recs in _group_items(plan, n, block):
        counts.append(len(recs))
        real = recs >= 0
        assert u0[0] >= 0 and np.all(real[:, 0]) and np.all(recs[real] & 255)
        assert np.all(real[:, :-1] | ~real[:, 1:])
        for r, m in zip(recs >> 8, real):
            assert np.all(np.diff(r[m]) > 0)
        for c, unit in enumerate((u0, u1)):
            blocks = unit[unit >= 0]
            assert np.all(unit[: len(blocks)] >= 0) and len(blocks) <= G
            if c == 1 and len(blocks) == 0:
                assert not np.any(recs[real] & (15 << 4))
                continue
            owner[h, blocks] += 1
            walked = recs[real & ((recs >> (4 * c)) & 15 != 0)] >> 8
            if causal:
                assert np.all(walked <= blocks.max())
            for j, qb in enumerate(blocks):
                for kb in recs[real & ((recs >> (4 * c + j)) & 1 == 1)] >> 8:
                    tri = np.tril(np.ones((block, block), np.int64), (qb - kb) * block)
                    cover[h, qb * block: qb * block + block,
                          kb * block: kb * block + block] += 1 if not causal else tri
    np.testing.assert_array_equal(owner, 1)
    np.testing.assert_array_equal(cover, keep.astype(np.int64))
    assert counts == sorted(counts, reverse=True)


def test_query_group_plan_at_berts_layout():
    """BERT's default section at S512: the 4 query blocks of a window list
    the same 11 key blocks (the window's 4 and the other 7 global ones), so
    a head's 32 query blocks form 8 full units with no padding row, paired
    into 4 items that stream 18 tiles of 64 keys; 98,304 scored pairs a head
    against the layout's 90,112, as for dk/dv."""
    layout = from_ds_config({"mode": "fixed", "block": 16}, 16).make_layout(512)
    plan, n = tbsa.dkv_group_plan(layout, 16, False, "dq")
    items = _group_items(plan, n, 16)
    assert n == 16 * 4 and len(items) == n
    for h in range(16):
        mine = [it for it in items if it[0] == h]
        assert sum(len(it[3]) for it in mine) == 18
        units = [u for _, u0, u1, _ in mine for u in (u0, u1)]
        assert all(np.all(u >= 0) for u in units)  # no padding slot
        np.testing.assert_array_equal(np.sort(np.concatenate(units)), np.arange(32))
        for u in units:
            np.testing.assert_array_equal(u, 4 * (u[0] // 4) + np.arange(4))
    scored = sum(64 * 64 * int(np.sum((r[:, 0] >> (4 * c)) & 15 != 0)) for _, u0, u1, r in items
                 for c, u in enumerate((u0, u1)) if u[0] >= 0)
    assert scored == 16 * 98304 and int(layout.sum()) * 16 * 16 == 16 * 90112


def test_query_group_plan_is_cached_once_for_the_forward_and_dq():
    """One "dq" plan per causal flag in ``IndexLists``, built at first use:
    the forward and dq both take ``bwd_plan("dq", causal)`` and its header
    count, the grouped plan's."""
    lists = tbsa.index_lists(from_ds_config({"mode": "fixed", "block": 16}, 4), 512, "cpu")
    plan = lists.bwd_plan("dq", False)
    assert lists.bwd_plan("dq", False) is plan and plan.dtype == torch.int32
    flat, n = tbsa.dkv_group_plan(lists.layout, 16, False, "dq")
    np.testing.assert_array_equal(plan.numpy(), flat)
    assert lists.plan_items("dq", False) == n == 4 * 4
    assert lists.plans[("dq", False)][0] is plan and ("fwd", False) not in lists.plans
    lists.bwd_plan("dkv", False)
    assert lists.bwd_plan("dq", False) is plan


def _query_group_walk(q, k, v, do, lse, delta, lists, causal, sm_scale, step_tiles):
    """The grouped forward and dq kernels' walks in plain PyTorch: dq's plan
    items in order; each unit's 64 query rows (a padding slot repeats the
    unit's first block), each step's ``step_tiles`` tiles of 64 key rows (a
    padding slot repeats the tile's first block), a (query block, key
    block) pair whose mask bit is clear, padding keys and the pairs the
    causal rule drops masked: -inf for the forward's online softmax from m
    = -1e30 (P rounded to q's dtype for P·V), p = 0 for dq (dS rounded,
    dQ scaled once); one store of the unit's real rows, a row that kept
    nothing o = 0 and lse = +1e30. → (o, lse, dq, how often each query row
    was stored [B, S, H])."""
    B, S, H, D = q.shape
    blk = lists.block
    dt = q.dtype
    items = _group_items(lists.bwd_plan("dq", causal).numpy(), lists.plan_items("dq", causal),
                         blk)
    o, dq = torch.zeros(B, S, H, D), torch.zeros(B, S, H, D)
    lse_o = torch.zeros(B, H, S)
    stored = torch.zeros(B, S, H, dtype=torch.int64)
    for h, u0, u1, recs in items:
        for bb in range(B):
            for c, unit in enumerate((u0, u1)):
                if unit[0] < 0:
                    continue
                qr, qreal = (torch.from_numpy(x) for x in _rows(unit, blk, unit[0]))
                qt, dot = q[bb, qr, h].float(), do[bb, qr, h].float()
                m = torch.full((TILE,), -1e30)
                l, acc, adq = torch.zeros(TILE), torch.zeros(TILE, D), torch.zeros(TILE, D)
                for j in range(0, len(recs), step_tiles):
                    step = recs[j: j + step_tiles]
                    kr, kreal, bit = [], [], []
                    for rec in step:
                        rows, real = _rows([x >> 8 if x >= 0 else -1 for x in rec], blk,
                                           rec[0] >> 8)
                        kr.append(rows)
                        kreal.append(real)
                        bit.append(np.array([[x >= 0 and (x >> (4 * c + qs)) & 1 for x in rec]
                                             for qs in range(len(unit))], bool))
                    kr, kreal = torch.from_numpy(np.concatenate(kr)), torch.from_numpy(
                        np.concatenate(kreal))
                    bit = torch.from_numpy(np.concatenate(bit, 1).repeat(blk, 0).repeat(blk, 1))
                    keep = qreal[:, None] & kreal[None, :] & bit  # [query, key]
                    if causal:
                        keep = keep & (kr[None, :] <= qr[:, None])
                    kt, vt = k[bb, kr, h].float(), v[bb, kr, h].float()
                    s = qt @ kt.T * sm_scale
                    sm = s.masked_fill(~keep, float("-inf"))
                    mn = torch.maximum(m, sm.amax(-1))
                    corr = torch.exp(m - mn)
                    pf = torch.exp(sm - mn[:, None])
                    l = l * corr + pf.sum(-1)
                    acc = acc * corr[:, None] + pf.to(dt).float() @ vt
                    m = mn
                    p = torch.exp(s - lse[bb, h, qr, None]).masked_fill(~keep, 0.0)
                    ds = (p * (dot @ vt.T - delta[bb, h, qr, None])).to(dt).float()
                    adq += ds @ kt
                valid = m > -0.5e30
                lc = l.clamp_min(1e-30)
                rows = qr[qreal]
                o[bb, rows, h] = torch.where(valid[:, None], acc / lc[:, None], 0.0)[qreal]
                lse_o[bb, h, rows] = torch.where(valid, m + torch.log(lc), 1e30)[qreal]
                dq[bb, rows, h] = adq[qreal] * sm_scale
                stored[bb, rows, h] += 1
    return o.to(dt), lse_o, dq.to(dt), stored


@pytest.mark.parametrize("step_tiles", [2, 1])
@pytest.mark.parametrize("label", list(GROUP_CASES))
def test_query_group_walk_matches_plain_versions(label, step_tiles):
    make, block, causal = GROUP_CASES[label]
    B, S, H, D = 1, 256, 2, 16
    lists = tbsa.lists_from_layout(make(H, S), block, "cpu")
    q, k, v, do = (torch.from_numpy(x) for x in _qkv(B, S, H, D, seed=block + 7 * causal))
    scale = 1.0 / np.sqrt(D)
    o_r, lse_r = tbsa.block_sparse_attention_fwd_ref(q, k, v, lists, causal)
    delta = tbsa.block_sparse_delta(o_r, do)
    o, lse, dq, stored = _query_group_walk(q, k, v, do, lse_r, delta, lists, causal, scale,
                                           step_tiles)
    assert torch.equal(stored, torch.ones_like(stored))  # every query row once, no padding row
    poison = lse_r == 1e30
    assert torch.equal(lse == 1e30, poison)
    np.testing.assert_allclose(o.numpy(), o_r.numpy(), atol=WALK_TOL, rtol=0)
    np.testing.assert_allclose(lse[~poison].numpy(), lse_r[~poison].numpy(), atol=WALK_TOL,
                               rtol=WALK_TOL)
    dq_r = tbsa.block_sparse_attention_dq_ref(q, k, v, do, lse_r, delta, lists, causal)
    np.testing.assert_allclose(dq.numpy(), dq_r.numpy(), atol=WALK_TOL, rtol=0)
    if label.startswith("custom"):
        assert poison[:, :, :block].all() and not poison[:, :, block:].any()
        assert float(o[:, :block].abs().max()) == 0.0 and float(dq[:, :block].abs().max()) == 0.0


@pytest.mark.parametrize("label", list(GROUP_CASES))
def test_query_group_walk_matches_pallas_interpret(label):
    make, block, causal = GROUP_CASES[label]
    B, S, H, D = 1, 256, 2, 16
    layout = make(H, S)
    q, k, v, do = _qkv(B, S, H, D, seed=14)
    scale = 1.0 / np.sqrt(D)
    to4 = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)  # noqa: E731
    kidx, kcnt, qidx, qcnt = map(jnp.asarray, jbsa.layout_to_index_lists(layout))
    o_j, lse_j = jbsa._fwd(to4(q), to4(k), to4(v), kidx, kcnt, scale, causal, block, True)
    dq_j = jbsa._bwd(to4(q), to4(k), to4(v), o_j, lse_j, to4(do), kidx, kcnt, qidx, qcnt,
                     scale, causal, block, True)[0]
    lists = tbsa.lists_from_layout(layout, block, "cpu")
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    lse_jt = torch.from_numpy(np.array(lse_j)[..., 0])  # the TPU's 128-lane broadcast
    back = lambda x: np.asarray(x).transpose(0, 2, 1, 3)  # noqa: E731
    delta = tbsa.block_sparse_delta(torch.from_numpy(np.array(back(o_j))), tdo)
    o, lse, dq, _ = _query_group_walk(tq, tk, tv, tdo, lse_jt, delta, lists, causal, scale, 2)
    np.testing.assert_allclose(o.numpy(), back(o_j), atol=GRAD_TOL, rtol=0)
    poison = lse_jt.numpy() >= 1e30
    np.testing.assert_array_equal(lse.numpy() == 1e30, poison)
    np.testing.assert_allclose(lse.numpy()[~poison], lse_jt.numpy()[~poison], atol=GRAD_TOL,
                               rtol=0)
    np.testing.assert_allclose(dq.numpy(), back(dq_j), atol=GRAD_TOL, rtol=0)
