"""The port's BERT against the JAX package's on bert-tiny, fp32 on the CPU,
from the same numpy parameters and inputs: ``forward`` (hidden states and
pooled output) and ``pretraining_loss`` with its gradients, for dense
attention, block-sparse attention and with an ``attention_mask``; a 5-step
sparse pre-training trajectory (MLM + NSP, Adam, gas 2) against
``DeepSpeedEngine`` on a one-device mesh; the ``sparse_attention_utils``
helpers and the encoder attention dispatcher.

Tolerances: 1e-5 (relative for losses, absolute for activations, gradients
and parameters, whose magnitudes are <= ~1): the packages sum in different
orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dtt
from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu.ops import attention as jattn
from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu.runtime.engine import DeepSpeedEngine as JEngine
from deepspeed_tpu_torch.models import bert as tbert
from deepspeed_tpu_torch.ops import attention as tattn
from deepspeed_tpu_torch.ops import block_sparse_attention as tbsa
from deepspeed_tpu_torch.ops import sparse_attention as tsa
from deepspeed_tpu_torch.utils.weights import params_from_numpy, params_to_numpy, tree_leaves

TOL = 1e-5
MODES = ["dense", "sparse", "dense-masked", "sparse-masked"]


def _cfgs(mode, **kw):
    sparse = mode.startswith("sparse")
    extra = dict(attn_impl="sparse") if sparse else {}
    jc = jbert.get_config("bert-tiny", pretraining=True, **extra, **kw)
    tc = tbert.get_config("bert-tiny", pretraining=True, **extra, **kw)
    return jc, tc


def _params(seed=0):
    jc = jbert.get_config("bert-tiny", pretraining=True)
    return jax.tree.map(np.asarray, jbert.init_params(jc, jax.random.PRNGKey(seed)))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree, np.float32)}


def _batch(rows, S, seed, masked):
    rs = np.random.RandomState(seed)
    ids = rs.randint(4, 512, (rows, S)).astype(np.int32)
    labels = np.full((rows, S), -100, np.int32)
    pick = rs.rand(rows, S) < 0.15
    labels[pick] = ids[pick]
    ids[pick] = 3  # the [MASK] token
    batch = {"input_ids": ids, "labels": labels,
             "token_type_ids": (np.arange(S)[None] >= S // 2).repeat(rows, 0).astype(np.int32),
             "next_sentence_label": rs.randint(0, 2, (rows,)).astype(np.int32)}
    if masked:
        am = np.ones((rows, S), np.int32)
        am[0, S - 20:] = 0
        batch["attention_mask"] = am
    return batch


def test_params_have_the_jax_layout():
    tp = params_to_numpy(tbert.init_params(tbert.get_config("bert-tiny", pretraining=True),
                                           torch.Generator().manual_seed(0)))
    jp = _params()
    assert {k: v.shape for k, v in _flat(tp).items()} == {k: v.shape for k, v in _flat(jp).items()}
    assert "mlm" not in tbert.init_params(tbert.get_config("bert-tiny"),
                                          torch.Generator().manual_seed(0))


@pytest.mark.parametrize("mode", MODES)
def test_forward_matches_jax(mode):
    jc, tc = _cfgs(mode)
    params = _params(1)
    b = _batch(2, 64, seed=2, masked=mode.endswith("masked"))
    h_j, pooled_j = jbert.forward(jc, jax.tree.map(jnp.asarray, params), jnp.asarray(b["input_ids"]),
                                  None if "attention_mask" not in b else jnp.asarray(b["attention_mask"]),
                                  jnp.asarray(b["token_type_ids"]))
    tb = {k: torch.from_numpy(v).long() for k, v in b.items()}
    h_t, pooled_t = tbert.forward(tc, params_from_numpy(params, "cpu"), tb["input_ids"],
                                  tb.get("attention_mask"), tb["token_type_ids"])
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=TOL, rtol=0)
    np.testing.assert_allclose(pooled_t.numpy(), np.asarray(pooled_j), atol=TOL, rtol=0)


@pytest.mark.parametrize("mode", MODES)
def test_pretraining_loss_and_grads_match_jax(mode):
    jc, tc = _cfgs(mode)
    params = _params(3)
    b = _batch(3, 64, seed=4, masked=mode.endswith("masked"))

    def jloss(p):
        return jbert.pretraining_loss(jc, p, jax.tree.map(jnp.asarray, b))[0]

    loss_j, grads_j = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, params))
    tp = params_from_numpy(params, "cpu")
    leaves = tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    dense_before = tbsa.DENSE_CALLS["sparse_attention_dense"]
    loss_t, metrics = tbert.pretraining_loss(tc, tp, {k: torch.from_numpy(v).long()
                                                      for k, v in b.items()})
    # a masked sparse batch takes the dense path in every layer, an unmasked
    # one never does
    want = tc.n_layer if mode == "sparse-masked" else 0
    assert tbsa.DENSE_CALLS["sparse_attention_dense"] == dense_before + want
    assert set(metrics) == {"mlm_loss", "nsp_loss"}
    grads_t = torch.autograd.grad(loss_t, leaves)
    assert abs(loss_t.item() - float(loss_j)) <= TOL * abs(float(loss_j))
    for (name, ref), got in zip(_flat(jax.tree.map(np.asarray, grads_j)).items(), grads_t):
        np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=0, err_msg=name)


def test_loss_without_nsp_label():
    jc, tc = _cfgs("sparse")
    params = _params(4)
    b = _batch(2, 32, seed=5, masked=False)
    b.pop("next_sentence_label")
    loss_j, m_j = jbert.pretraining_loss(jc, jax.tree.map(jnp.asarray, params),
                                         jax.tree.map(jnp.asarray, b))
    loss_t, m_t = tbert.pretraining_loss(tc, params_from_numpy(params, "cpu"),
                                         {k: torch.from_numpy(v).long() for k, v in b.items()})
    assert set(m_t) == set(m_j) == {"mlm_loss"}
    assert abs(loss_t.item() - float(loss_j)) <= TOL * abs(float(loss_j))


CONFIG = {
    "train_micro_batch_size_per_gpu": 2,
    "gradient_accumulation_steps": 2,
    "gradient_clipping": 1.0,
    "steps_per_print": 1000,
    # eps 1e-6 as in the sparse GPT-2 trajectory: near-zero gradients'
    # last bits must not decide the comparison through Adam's normalisation
    "optimizer": {"type": "Adam", "params": {"lr": 1e-3, "eps": 1e-6}},
}


def test_sparse_pretraining_trajectory_matches_jax_engine(mesh_single):
    jc, tc = _cfgs("sparse")
    params = _params(5)
    batches = [_batch(4, 64, seed=10 + i, masked=False) for i in range(5)]
    jeng = JEngine(jbert.make_module(jc), dict(CONFIG), mesh=mesh_single,
                   params=jax.tree.map(jnp.asarray, params), seed=0)
    teng, *_ = dtt.initialize(model=tbert.make_module(tc), config=dict(CONFIG),
                              model_parameters=params_from_numpy(params, "cpu"), device="cpu")
    losses = []
    for i, b in enumerate(batches):
        mj, mt = jeng.train_batch(b), teng.train_batch(b)
        lj, lt = float(mj["loss"]), float(mt["loss"])
        assert abs(lt - lj) <= TOL * abs(lj), (i, lt, lj)
        assert mt["global_step"] == int(mj["global_step"]) == i + 1
        losses.append(lt)
    pj = _flat(jax.tree.map(np.asarray, jeng.state.params))
    pt = _flat(params_to_numpy(teng.params))
    assert pj.keys() == pt.keys()
    for name in pj:
        np.testing.assert_allclose(pt[name], pj[name], atol=TOL, rtol=0, err_msg=name)


def test_sparse_pretraining_loss_falls_on_one_batch():
    _, tc = _cfgs("sparse")
    eng, *_ = dtt.initialize(model=tbert.make_module(tc), config=dict(CONFIG, bf16={"enabled": True}),
                             model_parameters=params_from_numpy(_params(6), "cpu"), device="cpu")
    b = _batch(4, 64, seed=7, masked=False)
    losses = [float(eng.train_batch(b)["loss"]) for _ in range(8)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_config_refusals(mesh_single):
    """``dropout`` is accepted and applies nothing, as in the JAX package
    (its ``pretraining_loss`` never hands ``forward`` a key): a bert-tiny
    trajectory at dropout 0.1 equals JAX's, and both equal the run without
    dropout. An unknown ``attn_impl`` still raises."""
    with pytest.raises(ValueError, match="attn_impl"):
        tbert.get_config("bert-tiny", attn_impl="ring")
    assert tbert.make_module(tbert.get_config("bert-tiny")).loss_fn is None
    jc, tc = _cfgs("dense", dropout=0.1)
    _, tc0 = _cfgs("dense")
    params = _params(6)
    batches = [_batch(4, 32, seed=20 + i, masked=False) for i in range(3)]
    jeng = JEngine(jbert.make_module(jc), dict(CONFIG), mesh=mesh_single,
                   params=jax.tree.map(jnp.asarray, params), seed=0)
    teng, teng0 = (dtt.initialize(model=tbert.make_module(c), config=dict(CONFIG),
                                  model_parameters=params_from_numpy(params, "cpu"),
                                  device="cpu")[0] for c in (tc, tc0))
    assert tc.dropout == 0.1
    for i, b in enumerate(batches):
        lj = float(jeng.train_batch(b)["loss"])
        lt, lt0 = float(teng.train_batch(b)["loss"]), float(teng0.train_batch(b)["loss"])
        assert abs(lt - lj) <= TOL * abs(lj), (i, lt, lj)
        assert lt == lt0
    pj = _flat(jax.tree.map(np.asarray, jeng.state.params))
    pt = _flat(params_to_numpy(teng.params))
    for name in pj:
        np.testing.assert_allclose(pt[name], pj[name], atol=TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("masked", [False, True])
def test_bidirectional_attention_matches_jax(masked):
    rs = np.random.RandomState(8)
    q, k, v = (rs.randn(2, 48, 4, 16).astype(np.float32) for _ in range(3))
    mask = np.ones((2, 48), np.int32)
    mask[1, 30:] = 0
    m = mask if masked else None
    out_j = jattn.bidirectional_attention(q, k, v, mask=m)
    out_t = tattn.bidirectional_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                          mask=None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=TOL, rtol=0)
    with pytest.raises(ValueError, match="impl"):
        tattn.bidirectional_attention(torch.zeros(1, 4, 1, 16), torch.zeros(1, 4, 1, 16),
                                      torch.zeros(1, 4, 1, 16), impl="ring")


# ---- sparse_attention_utils --------------------------------------------------

def test_pad_and_unpad_match_jax():
    rs = np.random.RandomState(0)
    ids = rs.randint(1, 100, (2, 100)).astype(np.int32)
    am = np.ones((2, 100), np.int32)
    tt = np.zeros((2, 100), np.int32)
    pos = np.broadcast_to(np.arange(100), (2, 100)).astype(np.int32)
    out_j = jsa.pad_to_block_size(64, jnp.asarray(ids), jnp.asarray(am), jnp.asarray(tt),
                                  jnp.asarray(pos), pad_token_id=0)
    out_t = tsa.pad_to_block_size(64, *(torch.from_numpy(x) for x in (ids, am, tt, pos)),
                                  pad_token_id=0)
    assert out_t[0] == out_j[0] == 28
    for a, b in zip(out_t[1:], out_j[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    x = torch.from_numpy(rs.randn(2, 128, 8).astype(np.float32))
    assert tuple(tsa.unpad_sequence_output(28, x).shape) == (2, 100, 8)
    pl, i2, *_ = tsa.pad_to_block_size(64, out_t[1], out_t[2])
    assert pl == 0 and i2 is out_t[1]
    assert tsa.pad_to_block_size(16, torch.from_numpy(ids))[2] is None  # no mask given


def test_ragged_sparse_bert_forward_ignores_pad_content():
    cfg = tbert.get_config("bert-tiny", attn_impl="sparse",
                           sparsity_config=tsa.FixedSparsityConfig(num_heads=4, block=16))
    params = tbert.init_params(cfg, torch.Generator().manual_seed(0))
    ids = torch.randint(1, cfg.vocab_size, (2, 50), generator=torch.Generator().manual_seed(1))
    pad_len, pids, pam, _, _ = tsa.pad_to_block_size(16, ids, torch.ones(2, 50, dtype=torch.long))
    assert pids.shape[1] == 64
    module = tbert.make_module(cfg)
    a = module.apply_fn(params, {"input_ids": pids, "attention_mask": pam})
    pids2 = pids.clone()
    pids2[:, 50:] = 7
    b = module.apply_fn(params, {"input_ids": pids2, "attention_mask": pam})
    torch.testing.assert_close(tsa.unpad_sequence_output(pad_len, a),
                               tsa.unpad_sequence_output(pad_len, b), atol=1e-5, rtol=0)


def test_extend_position_embedding_matches_jax():
    params = _params(0)
    ext_j = jsa.extend_position_embedding(params, 300)
    ext_t = tsa.extend_position_embedding(params_from_numpy(params, "cpu"), 300)
    np.testing.assert_array_equal(ext_t["wpe"].numpy(), np.asarray(ext_j["wpe"]))
    assert ext_t["wte"] is not None and ext_t["wpe"].shape[0] == 300


def test_sparse_bert_module_and_tokenizer_helpers():
    sc = tsa.FixedSparsityConfig(num_heads=4, block=16)
    cfg, module = tsa.sparse_bert_module("bert-tiny", sparsity_config=sc)
    assert cfg.attn_impl == "sparse" and cfg.sparsity_config is sc
    cfg2, _ = tsa.sparse_bert_module(tbert.get_config("bert-tiny"), sparsity_config=sc)
    assert cfg2 == cfg
    params = module.init(torch.Generator().manual_seed(0))
    out = module.apply_fn(params, {"input_ids": torch.randint(1, 512, (2, 64))})
    assert tuple(out.shape) == (2, 64, cfg.n_embd)

    class Tok:
        model_max_length = 512
        init_kwargs = {}

    t = tsa.update_tokenizer_model_max_length(Tok(), 4096)
    assert t.model_max_length == 4096 and t.init_kwargs["model_max_length"] == 4096
