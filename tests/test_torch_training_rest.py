"""The rest of single-device training in the port against the JAX package
on gpt2-tiny, fp32 on the CPU, from the same numpy parameters and batches:
the sequence-chunked cross-entropy (``ce_chunk``), the remat policies
"attn" and "dots", and the reference-loop shim ``forward`` / ``backward`` /
``step`` against a ``train_batch`` loop.

Tolerances: 1e-5 against JAX and between the port's chunked and full loss
(relative for losses, absolute for gradients, whose magnitudes are <= ~1:
the sums run in other orders); the remat policies' gradients equal the
port's no-remat gradients to 1e-7 on the CPU (their attention backward is
the flash kernel's plain version instead of autograd through the plain
forward: the same function in another order); the shim loop equals the
train_batch loop exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dtt
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models import lm_loss as tlm
from deepspeed_tpu_torch.ops import flash_attention as tfa
from deepspeed_tpu_torch.ops import prng
from deepspeed_tpu_torch.utils.weights import params_from_numpy, params_to_numpy, tree_leaves

TOL = 1e-5
SECTION = {"mode": "fixed", "block": 16, "num_local_blocks": 2, "num_global_blocks": 1,
           "attention": "unidirectional"}


def _params(seed=0):
    cfg = jgpt2.get_config("gpt2-tiny")
    return jax.tree.map(np.asarray, jgpt2.init_params(cfg, jax.random.PRNGKey(seed)))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree, np.float32)}


def _batch(rows, S, seed, ignore=True):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, 512, (rows, S)).astype(np.int32)
    batch = {"input_ids": ids}
    if ignore:
        labels = ids.copy()
        labels[0, :5] = -100
        batch["labels"] = labels
    return batch


def _jax_loss_and_grads(cfg, params, batch):
    def loss(p):
        return jgpt2.lm_loss(cfg, p, jax.tree.map(jnp.asarray, batch), None, True)[0]

    value, grads = jax.value_and_grad(loss)(jax.tree.map(jnp.asarray, params))
    return float(value), _flat(jax.tree.map(np.asarray, grads))


def _port_loss_and_grads(cfg, params, batch):
    tp = params_from_numpy(params, "cpu")
    leaves = tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    loss, aux = tgpt2.lm_loss(cfg, tp, tb, None, True)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss), [g.numpy() for g in grads], aux


@pytest.mark.parametrize("ce_chunk", [1, 7, 16, 64])
def test_ce_chunk_loss_and_grads_match_unchunked_and_jax(ce_chunk):
    """S 48: 48 chunks of 1 (the JAX package's scan path, past 32 chunks),
    7 chunks of 7 (a ragged last chunk), 3 of 16, and one chunk past S; a
    padded vocabulary, so the pad columns' mask runs per chunk too."""
    params = _params(1)
    params["wte"] = np.concatenate([params["wte"], np.zeros((128, 64), np.float32)])
    batch = _batch(3, 48, seed=2)
    full = tgpt2.get_config("gpt2-tiny", pad_vocab_multiple=640)
    chunked = tgpt2.get_config("gpt2-tiny", pad_vocab_multiple=640, ce_chunk=ce_chunk)
    lf, gf, _ = _port_loss_and_grads(full, params, batch)
    lc, gc, aux = _port_loss_and_grads(chunked, params, batch)
    lj, gj = _jax_loss_and_grads(jgpt2.get_config("gpt2-tiny", pad_vocab_multiple=640,
                                                  ce_chunk=ce_chunk), params, batch)
    assert abs(lc - lf) <= TOL * abs(lf) and abs(lc - lj) <= TOL * abs(lj)
    assert float(aux["ntokens"]) == float((batch["labels"][:, 1:] != -100).sum())
    for (name, ref), got, unchunked in zip(gj.items(), gc, gf):
        np.testing.assert_allclose(got, unchunked, atol=TOL, rtol=TOL, err_msg=name)
        np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL, err_msg=name)


def test_chunked_token_loss_equals_token_loss_with_an_attention_mask():
    rs = np.random.RandomState(3)
    h = torch.from_numpy(rs.randn(2, 20, 8).astype(np.float32))
    w = torch.from_numpy(rs.randn(8, 30).astype(np.float32))
    ids = torch.from_numpy(rs.randint(0, 30, (2, 20)))
    am = torch.ones(2, 20, dtype=torch.long)
    am[1, 13:] = 0
    batch = {"input_ids": ids, "attention_mask": am}
    ref, n_ref = tlm.token_loss(h @ w, batch)
    got, n_got = tlm.chunked_token_loss(lambda x: x @ w, h, batch, 6)
    assert float(n_got) == float(n_ref) == 19 + 12
    assert abs(float(got) - float(ref)) <= 1e-6 * abs(float(ref))


@pytest.mark.parametrize("policy", ["attn", "dots"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_remat_policy_grads_match_no_remat_and_jax(policy, sparse):
    params = _params(6)
    batch = _batch(2, 64, seed=8)
    extra = {"sparse_attention": SECTION} if sparse else {}
    base = tgpt2.get_config("gpt2-tiny", **extra)
    cfg = tgpt2.get_config("gpt2-tiny", remat=True, remat_policy=policy, **extra)
    l0, g0, _ = _port_loss_and_grads(base, params, batch)
    l1, g1, _ = _port_loss_and_grads(cfg, params, batch)
    lj, gj = _jax_loss_and_grads(jgpt2.get_config("gpt2-tiny", remat=True, remat_policy=policy,
                                                  **extra), params, batch)
    assert abs(l1 - l0) <= 1e-6 * abs(l0) and abs(l1 - lj) <= TOL * abs(lj)
    for (name, ref), got, plain in zip(gj.items(), g1, g0):
        np.testing.assert_allclose(got, plain, atol=1e-7, rtol=0, err_msg=name)
        np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL, err_msg=name)


@pytest.mark.parametrize("policy", ["attn", "dots"])
def test_remat_policy_trains_like_full_remat(policy):
    """Three train_batch steps under each policy follow full remat's losses
    and parameters (the policies change what backward recomputes, not what
    it computes). Adam's eps is 1e-6, as in the sparse trajectory test: a
    gradient near 1e-8 whose last bits differ between the two attention
    backwards would otherwise decide an element's first step."""
    conf = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 1,
            "gradient_clipping": 1.0,
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 3e-3, "eps": 1e-6, "weight_decay": 0.1}}}
    params = _params(2)
    batch = _batch(2, 32, seed=4, ignore=False)
    out = []
    for p in ("full", policy):
        eng, *_ = dtt.initialize(
            model=tgpt2.make_module(tgpt2.get_config("gpt2-tiny", remat=True, remat_policy=p)),
            config=conf, model_parameters=params_from_numpy(params, "cpu"), device="cpu")
        losses = [float(eng.train_batch(batch)["loss"]) for _ in range(3)]
        out.append((losses, _flat(params_to_numpy(eng.params))))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-6)
    for name, ref in out[0][1].items():
        np.testing.assert_allclose(out[1][1][name], ref, atol=TOL, rtol=0, err_msg=name)


def test_remat_policies_run_the_attention_forward_once():
    """The selective policies call the attention forward once a block and
    never in backward; on the CPU that is the flash kernel's plain version,
    so count its calls."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = tfa.flash_attention_fwd_ref, tfa.flash_attention_bwd_ref

    def counting_fwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def counting_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)

    params = _params(7)
    batch = _batch(2, 32, seed=9)
    mp = pytest.MonkeyPatch()
    mp.setattr(tfa, "flash_attention_fwd_ref", counting_fwd)
    mp.setattr(tfa, "flash_attention_bwd_ref", counting_bwd)
    try:
        for policy in ("attn", "dots"):
            calls.update(fwd=0, bwd=0)
            _port_loss_and_grads(tgpt2.get_config("gpt2-tiny", remat=True, remat_policy=policy),
                                 params, batch)
            assert calls == {"fwd": 2, "bwd": 2}, (policy, calls)
    finally:
        mp.undo()


CONFIG = {
    "train_micro_batch_size_per_gpu": 2,
    "gradient_accumulation_steps": 2,
    "gradient_clipping": 1.0,
    "steps_per_print": 1000,
    "optimizer": {"type": "AdamW",
                  "params": {"lr": 3e-3, "betas": [0.9, 0.95], "eps": 1e-8, "weight_decay": 0.1}},
    "scheduler": {"type": "WarmupLR",
                  "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 3e-3, "warmup_num_steps": 4}},
}


def _engine(params):
    eng, *_ = dtt.initialize(model=tgpt2.make_module(tgpt2.get_config("gpt2-tiny")),
                             config=dict(CONFIG), model_parameters=params_from_numpy(params, "cpu"),
                             device="cpu")
    return eng


def test_forward_backward_step_loop_equals_train_batch_loop():
    params = _params(3)
    batches = [_batch(4, 32, seed=20 + i, ignore=False) for i in range(4)]
    a, b = _engine(params), _engine(params)
    for batch in batches:
        ma = a.train_batch(batch)
        # an explicit key leaves the training key alone (without one,
        # eval_batch splits it, as the JAX engine does)
        expect = b.eval_batch(batch, rng=prng.PRNGKey(0))
        key = b._rng.copy()
        loss = b(batch)  # __call__ is forward
        assert float(loss) == float(expect)
        np.testing.assert_array_equal(b._rng, key)  # the training stream untouched
        b.backward(loss)
        mb = b.step()
        assert float(mb["loss"]) == float(ma["loss"]) and mb["global_step"] == ma["global_step"]
    pa, pb = _flat(params_to_numpy(a.params)), _flat(params_to_numpy(b.params))
    for name in pa:
        np.testing.assert_array_equal(pb[name], pa[name], err_msg=name)
    assert b.get_global_step() == a.get_global_step() == 4


def test_shim_checks_the_call_order():
    eng = _engine(_params(4))
    batch = _batch(4, 32, seed=5, ignore=False)
    with pytest.raises(RuntimeError, match="forward"):
        eng.backward()
    with pytest.raises(RuntimeError, match="forward"):
        eng.step()
    eng.forward(batch)
    with pytest.raises(RuntimeError, match="backward"):
        eng.step()  # forward without backward
    eng.backward()
    assert eng.step()["global_step"] == 1
    with pytest.raises(RuntimeError, match="forward"):
        eng.step()  # the stashed batch was consumed
