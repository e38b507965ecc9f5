"""The port's GPT-2 training path against the JAX package's on gpt2-tiny,
fp32 on the CPU, from the same numpy parameters and batches: the LM loss
and its per-leaf gradients, a 5-step ``train_batch`` trajectory (AdamW,
WarmupLR, clipping, gas 2) against ``DeepSpeedEngine`` on a one-device
mesh, and the fp16 overflow skip with its loss-scale trajectory. Then the
port on its own terms: gas equivalence, a falling bf16 loss, remat grads.

Tolerances: 1e-5 (relative for losses, absolute for parameters and
gradients, whose magnitudes are <= ~1): the two packages sum in different
orders, nothing more."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dtt
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.runtime.engine import DeepSpeedEngine as JEngine
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.utils.weights import params_from_numpy, params_to_numpy, tree_leaves

TOL = 1e-5


def _params(seed=0):
    cfg = jgpt2.get_config("gpt2-tiny")
    return jax.tree.map(np.asarray, jgpt2.init_params(cfg, jax.random.PRNGKey(seed)))


def _batches(n, rows, S=32, seed=0, vocab=512):
    rs = np.random.RandomState(seed)
    return [{"input_ids": rs.randint(0, vocab, (rows, S)).astype(np.int32)} for _ in range(n)]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree, np.float32)}


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


def test_lm_loss_and_grads_match_jax():
    cfg_j = jgpt2.get_config("gpt2-tiny")
    cfg_t = tgpt2.get_config("gpt2-tiny")
    params = _params(1)
    batch = _batches(1, 3, S=48, seed=2)[0]
    labels = batch["input_ids"].copy()
    labels[0, :5] = -100  # the ignore index
    batch["labels"] = labels

    def jloss(p):
        return jgpt2.lm_loss(cfg_j, p, jax.tree.map(jnp.asarray, batch), None, True)[0]

    loss_j, grads_j = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, params))
    tp = params_from_numpy(params, "cpu")
    leaves = tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    loss_t, aux = tgpt2.lm_loss(cfg_t, tp, tb, None, True)
    grads_t = torch.autograd.grad(loss_t, leaves)
    assert abs(loss_t.item() - float(loss_j)) <= TOL * abs(float(loss_j))
    assert float(aux["ntokens"]) == float((labels[:, 1:] != -100).sum())
    gj = _flat(jax.tree.map(np.asarray, grads_j))
    for (name, ref), got in zip(gj.items(), grads_t):
        np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=TOL, err_msg=name)


def test_train_batch_trajectory_matches_jax_engine(mesh_single):
    params = _params(0)
    batches = _batches(5, 4, seed=3)
    cfg = jgpt2.get_config("gpt2-tiny")
    jeng = JEngine(jgpt2.make_module(cfg), dict(CONFIG), mesh=mesh_single,
                   params=jax.tree.map(jnp.asarray, params), seed=0)
    teng, _, _, _ = dtt.initialize(model=tgpt2.make_module(tgpt2.get_config("gpt2-tiny")),
                                   config=dict(CONFIG), model_parameters=params_from_numpy(params, "cpu"),
                                   device="cpu")
    for i, b in enumerate(batches):
        mj = jeng.train_batch(b)
        mt = teng.train_batch(b)
        lj, lt = float(mj["loss"]), float(mt["loss"])
        assert abs(lt - lj) <= TOL * abs(lj), (i, lt, lj)
        assert abs(float(mt["grad_norm"]) - float(mj["grad_norm"])) <= TOL * float(mj["grad_norm"])
        assert abs(mt["lr"] - float(mj["lr"])) <= 1e-6 * float(mj["lr"]) + 1e-12
        assert mt["global_step"] == int(mj["global_step"]) == i + 1
    pj = _flat(jax.tree.map(np.asarray, jeng.state.params))
    pt = _flat(params_to_numpy(teng.params))
    assert pj.keys() == pt.keys()
    for name in pj:
        np.testing.assert_allclose(pt[name], pj[name], atol=TOL, rtol=0, err_msg=name)
    assert teng.get_global_step() == 5 and teng.skipped_steps == 0


def test_gas_equivalence():
    """gas 2 x micro 2 and gas 1 x micro 4 see the same 4 rows of equal
    length: the same loss (1e-6) and the same update (1e-5: Adam's first
    step divides each gradient by its own magnitude, so the summation
    order's last bits show in the elements whose gradient is near 0)."""
    params = _params(2)
    batch = _batches(1, 4, seed=4)[0]
    out = []
    for micro, gas in ((2, 2), (4, 1)):
        conf = dict(CONFIG, train_micro_batch_size_per_gpu=micro, gradient_accumulation_steps=gas)
        eng, _, _, _ = dtt.initialize(model=tgpt2.make_module(tgpt2.get_config("gpt2-tiny")),
                                      config=conf, model_parameters=params_from_numpy(params, "cpu"),
                                      device="cpu")
        m = eng.train_batch(batch)
        out.append((float(m["loss"]), _flat(params_to_numpy(eng.params))))
    assert abs(out[0][0] - out[1][0]) <= 1e-6 * out[1][0]
    for name, ref in out[1][1].items():
        np.testing.assert_allclose(out[0][1][name], ref, atol=TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("hysteresis", [1, 2])
def test_fp16_overflow_skip_and_scale_trajectory_match_jax(mesh_single, hysteresis):
    """A poisoned weight makes every step overflow: no update, skipped_steps
    counts, and the dynamic scale follows the reference's hysteresis, step
    for step, in both packages."""
    params = _params(3)
    params["wte"] = params["wte"].copy()
    params["wte"][5, 0] = np.inf
    conf = dict(CONFIG, fp16={"enabled": True, "initial_scale_power": 8,
                              "hysteresis": hysteresis, "min_loss_scale": 32})
    cfg = jgpt2.get_config("gpt2-tiny")
    jeng = JEngine(jgpt2.make_module(cfg), dict(conf), mesh=mesh_single,
                   params=jax.tree.map(jnp.asarray, params), seed=0)
    teng, _, _, _ = dtt.initialize(model=tgpt2.make_module(tgpt2.get_config("gpt2-tiny")),
                                   config=dict(conf), model_parameters=params_from_numpy(params, "cpu"),
                                   device="cpu")
    before = _flat(params_to_numpy(teng.params))
    scales_j, scales_t = [], []
    for b in _batches(5, 4, seed=5):
        mj, mt = jeng.train_batch(b), teng.train_batch(b)
        assert bool(mj["overflow"]) and mt["overflow"]
        scales_j.append(float(mj["loss_scale"]))
        scales_t.append(mt["loss_scale"])
    scales_j.append(jeng.loss_scale)
    scales_t.append(teng.loss_scale)
    assert scales_t == scales_j
    assert teng.skipped_steps == jeng.skipped_steps == 5
    assert teng.get_global_step() == jeng.get_global_step() == 0
    after = _flat(params_to_numpy(teng.params))
    for name in before:
        np.testing.assert_array_equal(after[name], before[name], err_msg=name)
    assert all(float(x.abs().max()) == 0.0 for x in tree_leaves(teng.opt_state.mu))
    expect = [256.0] * hysteresis + [128.0, 64.0, 32.0, 32.0, 32.0, 32.0][: 6 - hysteresis]
    assert scales_t == expect


def test_fp16_clean_steps_train():
    eng, _, _, _ = dtt.initialize(
        model=tgpt2.make_module(tgpt2.get_config("gpt2-tiny")),
        config=dict(CONFIG, fp16={"enabled": True, "initial_scale_power": 8}),
        model_parameters=params_from_numpy(_params(4), "cpu"), device="cpu")
    batch = _batches(1, 4, seed=6)[0]
    losses = [float(eng.train_batch(batch)["loss"]) for _ in range(4)]
    assert eng.skipped_steps == 0 and losses[-1] < losses[0]


def test_bf16_loss_falls():
    eng, _, _, _ = dtt.initialize(
        model=tgpt2.make_module(tgpt2.get_config("gpt2-tiny")),
        config=dict(CONFIG, bf16={"enabled": True}),
        model_parameters=params_from_numpy(_params(5), "cpu"), device="cpu")
    assert eng.compute_dtype == torch.bfloat16
    batch = _batches(1, 4, seed=7)[0]
    losses = [float(eng.train_batch(batch)["loss"]) for _ in range(6)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0] - 0.1
    assert all(p.dtype == torch.float32 for p in tree_leaves(eng.params))


def test_remat_grads_equal_no_remat_grads():
    params = _params(6)
    batch = {"input_ids": torch.from_numpy(_batches(1, 2, seed=8)[0]["input_ids"]).long()}
    grads = []
    for remat in (False, True):
        cfg = tgpt2.get_config("gpt2-tiny", remat=remat)
        tp = params_from_numpy(params, "cpu")
        leaves = tree_leaves(tp)
        for leaf in leaves:
            leaf.requires_grad_(True)
        loss, _ = tgpt2.lm_loss(cfg, tp, batch, None, True)
        grads.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-7, rtol=0)


def test_train_batch_reads_the_training_data_when_given_no_batch():
    rs = np.random.RandomState(9)
    data = [{"input_ids": rs.randint(0, 512, (32,)).astype(np.int32)} for _ in range(8)]
    eng, _, loader, sched = dtt.initialize(
        model=tgpt2.make_module(tgpt2.get_config("gpt2-tiny")), config=dict(CONFIG),
        training_data=data, device="cpu")
    assert len(loader) == 2 and sched(0) == pytest.approx(3e-3 * np.log(0.25 * (np.e - 1) + 1))
    for _ in range(3):  # past one epoch: the loader repeats
        m = eng.train_batch()
    assert m["global_step"] == 3 and np.isfinite(float(m["loss"]))
    ev = eng.eval_batch(next(iter(loader)))
    assert ev.shape == () and np.isfinite(float(ev))


def test_padded_vocab_trains_like_the_unpadded_one():
    """pad_vocab_multiple widens the embedding table with zero rows that the
    loss masks: the same losses, and the pad rows stay exactly zero."""
    params = _params(7)
    batch = _batches(1, 4, seed=10)[0]
    padded = dict(params, wte=np.concatenate([params["wte"], np.zeros((128, 64), np.float32)]))
    losses = []
    for tree, pad in ((params, 1), (padded, 640)):
        cfg = tgpt2.get_config("gpt2-tiny", pad_vocab_multiple=pad)
        assert cfg.padded_vocab_size == tree["wte"].shape[0]
        eng, _, _, _ = dtt.initialize(model=tgpt2.make_module(cfg), config=dict(CONFIG),
                                      model_parameters=params_from_numpy(tree, "cpu"), device="cpu")
        losses.append([float(eng.train_batch(batch)["loss"]) for _ in range(3)])
    np.testing.assert_allclose(losses[1], losses[0], rtol=TOL)
    assert float(eng.params["wte"][512:].abs().max()) == 0.0
