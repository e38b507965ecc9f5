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
