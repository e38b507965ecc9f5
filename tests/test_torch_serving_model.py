"""The port's serving programs against the JAX package's, from the same
weights, pools and block tables (gpt2-tiny, fp32): the pools after each
program agree to 1e-5 and the sampled tokens are equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.serving import model as jmodel
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.serving import model as tmodel
from deepspeed_tpu_torch.utils.weights import params_from_numpy

TOL = dict(atol=1e-5, rtol=1e-5)
PAGE, P = 4, 24


@pytest.fixture(scope="module")
def models():
    jcfg = jgpt2.get_config("gpt2-tiny")
    tree = jax.tree.map(np.asarray, jgpt2.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tgpt2.get_config("gpt2-tiny"), tree


def _pools(cfg, seed):
    rs = np.random.RandomState(seed)
    shape = (cfg.n_layer, P, cfg.n_head, PAGE, cfg.head_dim)
    return rs.randn(*shape).astype(np.float32), rs.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("plen", [1, 5, 12])
def test_paged_prefill(models, plen):
    jcfg, tcfg, tree = models
    kp, vp = _pools(jcfg, plen)
    width = 12
    ids = np.zeros((1, width), np.int32)
    ids[0, :plen] = np.random.RandomState(plen).randint(0, jcfg.vocab_size, plen)
    page_ids = np.array([5, 2, 0], np.int32)  # scratch-padded tail
    jk, jv, jtok = jmodel.paged_prefill(
        jcfg, jax.tree.map(jnp.asarray, tree), jnp.asarray(ids), jnp.int32(plen),
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(page_ids), jax.random.PRNGKey(0),
    )
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    ttok = tmodel.paged_prefill(
        tcfg, params_from_numpy(tree, "cpu"), torch.from_numpy(ids).long(), plen,
        tk, tv, torch.from_numpy(page_ids),
    )
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


def test_paged_decode_steps(models):
    """Three consecutive decode steps over four slots, one of them inactive
    on the scratch page, crossing a page boundary on the way."""
    jcfg, tcfg, tree = models
    kp, vp = _pools(jcfg, 7)
    bt = np.array([[3, 4, 5, 6, 7],
                   [0, 0, 0, 0, 0],          # inactive slot: all scratch
                   [8, 9, 10, 11, 12],
                   [13, 14, 15, 16, 17]], np.int32)
    seq_lens = np.array([3, 0, 9, 15], np.int32)
    tokens = np.array([11, 0, 200, 77], np.int32)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = params_from_numpy(tree, "cpu")
    jk, jv = jnp.asarray(kp), jnp.asarray(vp)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    jtok, ttok = tokens, tokens
    for step in range(3):
        sl = seq_lens + np.array([1, 0, 1, 1], np.int32) * step
        jk, jv, jnext = jmodel.paged_decode_step(
            jcfg, jparams, jnp.asarray(jtok), jnp.asarray(sl), jk, jv,
            jnp.asarray(bt), jnp.zeros((4, 2), jnp.uint32),
        )
        tnext = tmodel.paged_decode_step(
            tcfg, tparams, torch.from_numpy(np.asarray(ttok)), torch.from_numpy(sl),
            tk, tv, torch.from_numpy(bt),
        )
        np.testing.assert_array_equal(tnext.numpy(), np.asarray(jnext), err_msg=f"step {step}")
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
        jtok = np.asarray(jnext).astype(np.int32)
        ttok = tnext.numpy().astype(np.int32)


def test_decode_writes_before_it_attends(models):
    """Update-then-attend: the token's own K/V is in the pool when the
    attention reads it, so a slot at position 0 attends exactly itself —
    whatever garbage its page held before."""
    _, tcfg, tree = models
    params = params_from_numpy(tree, "cpu")
    outs = []
    for seed in (1, 2):
        kp, vp = _pools(tcfg, seed)
        tk, tv = torch.from_numpy(kp), torch.from_numpy(vp)
        bt = torch.tensor([[4, 5, 6, 7, 8]], dtype=torch.int32)
        outs.append(tmodel.paged_decode_step(
            tcfg, params, torch.tensor([42]), torch.tensor([0], dtype=torch.int32),
            tk, tv, bt, return_logits=True,
        )[1])
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the multi-token programs: chunked prefill and speculative verify
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("start,plen,C", [(0, 3, 4), (4, 10, 8), (8, 12, 8)])
def test_paged_chunk_prefill(models, start, plen, C):
    """One chunk attending a cached prefix through the slot's row; the last
    case's chunk runs past the row (its second page id is scratch)."""
    jcfg, tcfg, tree = models
    kp, vp = _pools(jcfg, 11 + start)
    row = np.array([[7, 3, 12]], np.int32)
    ids = np.zeros((1, C), np.int32)
    seg = np.random.RandomState(start).randint(0, jcfg.vocab_size, plen)[start: start + C]
    ids[0, : len(seg)] = seg
    page_ids = np.zeros((C // PAGE,), np.int32)
    avail = row[0, start // PAGE: start // PAGE + C // PAGE]
    page_ids[: len(avail)] = avail
    jk, jv, jtok = jmodel.paged_chunk_prefill(
        jcfg, jax.tree.map(jnp.asarray, tree), jnp.asarray(ids), jnp.int32(start),
        jnp.int32(plen), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(page_ids),
        jnp.asarray(row), jax.random.PRNGKey(0),
    )
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    ttok = tmodel.paged_chunk_prefill(
        tcfg, params_from_numpy(tree, "cpu"), torch.from_numpy(ids), start, plen,
        tk, tv, torch.from_numpy(page_ids), torch.from_numpy(row),
    )
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


def test_paged_verify_step(models):
    """T = 4 tokens over four slots: one inactive on scratch, one whose
    drafts run past its block-table row (those writes go to scratch)."""
    jcfg, tcfg, tree = models
    kp, vp = _pools(jcfg, 5)
    bt = np.array([[3, 4, 5, 6, 7],
                   [0, 0, 0, 0, 0],
                   [8, 9, 10, 11, 12],
                   [13, 14, 15, 16, 17]], np.int32)
    seq_lens = np.array([3, 0, 9, 18], np.int32)
    tokens = np.random.RandomState(3).randint(0, jcfg.vocab_size, (4, 4)).astype(np.int32)
    tokens[1] = 0
    jk, jv, jgreedy = jmodel.paged_verify_step(
        jcfg, jax.tree.map(jnp.asarray, tree), jnp.asarray(tokens), jnp.asarray(seq_lens),
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
    )
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tgreedy = tmodel.paged_verify_step(
        tcfg, params_from_numpy(tree, "cpu"), torch.from_numpy(tokens),
        torch.from_numpy(seq_lens), tk, tv, torch.from_numpy(bt),
    )
    np.testing.assert_array_equal(tgreedy.numpy(), np.asarray(jgreedy))
    # page 0 takes several writes to one place, in an order neither
    # framework fixes; every other page must agree
    np.testing.assert_allclose(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:], **TOL)
    np.testing.assert_allclose(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:], **TOL)


def test_verify_write_targets_send_past_the_row_to_scratch():
    bt = torch.tensor([[5, 6, 7], [8, 9, 10]], dtype=torch.int32)
    pidx, poff = tmodel._verify_write_targets(
        torch.tensor([6, 10], dtype=torch.int32), bt, PAGE, 4
    )
    # slot 0: positions 6..9 -> pages 1, 1, 2, 2; slot 1: 10, 11 in page 2,
    # 12 and 13 past the 3-page row -> scratch page 0
    assert pidx.tolist() == [[6, 6, 7, 7], [10, 10, 0, 0]]
    assert poff.tolist() == [[2, 3, 0, 1], [2, 3, 0, 1]]


def test_verify_equals_sequential_decode(models):
    """Inside the port: fed the sequential decode stream as its drafts, the
    verify step's greedy tokens are that stream, and its logits are the
    decode steps' logits."""
    _, tcfg, tree = models
    params = params_from_numpy(tree, "cpu")
    kp, vp = _pools(tcfg, 9)
    bt = torch.tensor([[3, 4, 5, 6, 7], [8, 9, 10, 11, 12]], dtype=torch.int32)
    seq0 = np.array([5, 11], np.int32)
    tok0 = np.array([17, 300], np.int32)
    dk, dv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    stream, logits_seq = [tok0], []
    for step in range(3):
        nxt, lg = tmodel.paged_decode_step(
            tcfg, params, torch.from_numpy(stream[-1]), torch.from_numpy(seq0 + step),
            dk, dv, bt, return_logits=True,
        )
        stream.append(nxt.numpy().astype(np.int32))
        logits_seq.append(lg)
    vk, vv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tokens = torch.from_numpy(np.stack(stream[:3], axis=1))  # last + 2 drafts
    greedy, logits = tmodel.paged_verify_step(
        tcfg, params, tokens, torch.from_numpy(seq0), vk, vv, bt, return_logits=True,
    )
    np.testing.assert_array_equal(greedy.numpy(), np.stack(stream[1:], axis=1))
    for t in range(3):
        torch.testing.assert_close(logits[:, t], logits_seq[t], **TOL)
