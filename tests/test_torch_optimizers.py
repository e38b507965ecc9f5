"""The port's optimizer registry (``deepspeed_tpu_torch.runtime.optimizers``)
against the JAX package's ``build_optimizer`` on the CPU, from the same
numpy inputs: every registry type over 3 updates of a mixed-rank tree
(constant and scheduled learning rates), the 5-step gpt2-tiny
``train_batch`` trajectories for Lamb, Adagrad and SGD against
``DeepSpeedEngine`` on a one-device mesh, a bert-tiny Lamb trajectory, and
the 1-bit names, which raise.

Tolerances: 1e-6 relative for a transform's 3 updates (the same f32
operations; the bias corrections' pow may round an ulp apart); 1e-5 for
the trajectories, as ``tests/test_torch_training.py`` (the packages sum
the gradients in different orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import deepspeed_tpu_torch as dtt
from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.runtime import optimizers as jopt
from deepspeed_tpu.runtime.engine import DeepSpeedEngine as JEngine
from deepspeed_tpu_torch.models import bert as tbert
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops import fused_adam as tfa
from deepspeed_tpu_torch.runtime import optimizers as topt
from deepspeed_tpu_torch.runtime.config import NotPortedError
from deepspeed_tpu_torch.utils.weights import params_from_numpy, params_to_numpy, tree_leaves

TOL = 1e-5

TYPES = [
    ("Adam", {"lr": 1e-2, "betas": [0.9, 0.95], "weight_decay": 0.1}),
    ("Adam", {"lr": 1e-2, "betas": [0.9, 0.95], "weight_decay": 0.1, "adam_w_mode": False}),
    ("Adam", {"lr": 1e-2}),
    ("AdamW", {"lr": 1e-2, "weight_decay": 0.05, "adam_w_mode": False}),
    ("FusedAdam", {"lr": 1e-2, "eps": 1e-6, "weight_decay": 0.01}),
    ("DeepSpeedCPUAdam", {"lr": 1e-2, "betas": [0.8, 0.99]}),
    ("Lamb", {"lr": 1e-2, "weight_decay": 0.01}),
    ("Lamb", {"lr": 1e-2}),
    ("FusedLamb", {"lr": 1e-2, "betas": [0.9, 0.99], "eps": 1e-6, "weight_decay": 0.1}),
    ("Adagrad", {"lr": 1e-1}),
    ("DeepSpeedCPUAdagrad", {"lr": 1e-1, "eps": 1e-6}),
    ("SGD", {"lr": 1e-1}),
    ("SGD", {"lr": 1e-1, "momentum": 0.9}),
    ("SGD", {"lr": 1e-1, "momentum": 0.9, "nesterov": True}),
]


def _tree(seed):
    rs = np.random.RandomState(seed)
    return {"w": rs.randn(6, 10).astype(np.float32), "b": rs.randn(10).astype(np.float32),
            "blocks": {"s": rs.randn(2, 3, 5).astype(np.float32),
                       "z": np.zeros((4, 4), np.float32)}}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree, np.float32)}


def _schedule(count):
    return 1e-2 * min(1.0, (count + 1) / 3)


@pytest.mark.parametrize("scheduled", [False, True])
@pytest.mark.parametrize("opt_type,params", TYPES, ids=lambda x: x if isinstance(x, str) else
                         "-".join(f"{k}{v}" for k, v in x.items() if k != "lr"))
def test_registry_type_matches_the_jax_transform(opt_type, params, scheduled):
    tree = _tree(0)
    lr = _schedule if scheduled else None
    tx = jopt.build_optimizer(opt_type, params, learning_rate=lr)
    opt = topt.build_optimizer(opt_type, params, learning_rate=lr)
    jp = jax.tree.map(jnp.asarray, tree)
    st = tx.init(jp)
    tp = params_from_numpy(tree, "cpu")
    ts = opt.init(tp)
    rs = np.random.RandomState(1)
    for _ in range(3):
        grads = jax.tree.map(lambda x: rs.randn(*x.shape).astype(np.float32), tree)
        u, st = tx.update(jax.tree.map(jnp.asarray, grads), st, jp)
        jp = optax.apply_updates(jp, u)
        opt.step(tp, tree_leaves(params_from_numpy(grads, "cpu")), ts)
    assert ts.count == 3
    want, got = _flat(jax.tree.map(np.asarray, jp)), _flat(params_to_numpy(tp))
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6, atol=1e-7, err_msg=name)


def test_registry_types_and_their_defaults():
    lamb = topt.build_optimizer("Lamb", {"lr": 1e-3})
    assert isinstance(lamb, topt.Lamb) and lamb.eps == 1e-8 and lamb.weight_decay == 0.0
    assert isinstance(topt.build_optimizer("FusedLamb", {}), topt.Lamb)
    ada = topt.build_optimizer("DeepSpeedCPUAdagrad", {"lr": 1e-3})
    assert isinstance(ada, topt.Adagrad) and ada.eps == 1e-10
    assert float(ada.init({"x": torch.zeros(2)}).sum_of_squares["x"][0]) == pytest.approx(0.1)
    sgd = topt.build_optimizer("SGD", {"lr": 1e-3})
    assert isinstance(sgd, topt.SGD) and sgd.momentum == 0.0 and not sgd.nesterov
    assert topt.build_optimizer("Adam", {"weight_decay": 0.1}).mode == "decoupled"
    assert topt.build_optimizer("Adam", {"weight_decay": 0.1, "adam_w_mode": False}).mode == "l2"
    assert topt.build_optimizer("AdamW", {"weight_decay": 0.1, "adam_w_mode": False}).mode \
        == "decoupled"
    assert topt.build_optimizer(None, {}).mode == "none"
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.build_optimizer("Adafactor", {})


@pytest.mark.parametrize("opt_type", ["OneBitAdam", "ZeroOneAdam", "OneBitLamb"])
def test_one_bit_names_raise(opt_type):
    """The JAX engine sends these to runtime/fp16/onebit/ (compressed
    momentum), not to Adam or Lamb: the port refuses them, for the
    registry and through initialize(...)."""
    with pytest.raises(NotPortedError, match="1-bit"):
        topt.build_optimizer(opt_type, {"lr": 1e-3})
    with pytest.raises(NotPortedError, match="queue 1 item 13"):
        dtt.initialize(model=tgpt2.make_module(tgpt2.get_config("gpt2-tiny")),
                       config={"train_batch_size": 2,
                               "optimizer": {"type": opt_type, "params": {"lr": 1e-3}}},
                       device="cpu")


def _gpt2_params(seed=0):
    cfg = jgpt2.get_config("gpt2-tiny")
    return jax.tree.map(np.asarray, jgpt2.init_params(cfg, jax.random.PRNGKey(seed)))


def _gpt2_batches(n, rows, S=32, seed=0):
    rs = np.random.RandomState(seed)
    return [{"input_ids": rs.randint(0, 512, (rows, S)).astype(np.int32)} for _ in range(n)]


def _config(opt):
    return {
        "train_micro_batch_size_per_gpu": 2,
        "gradient_accumulation_steps": 2,
        "gradient_clipping": 1.0,
        "steps_per_print": 1000,
        "optimizer": opt,
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 3e-3,
                                 "warmup_num_steps": 4}},
    }


def _trajectory(mesh, jmodule, tmodule, params, conf, batches):
    jeng = JEngine(jmodule, dict(conf), mesh=mesh, params=jax.tree.map(jnp.asarray, params),
                   seed=0)
    teng, *_ = dtt.initialize(model=tmodule, config=dict(conf),
                              model_parameters=params_from_numpy(params, "cpu"), device="cpu")
    for i, b in enumerate(batches):
        mj, mt = jeng.train_batch(b), teng.train_batch(b)
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
    return teng


@pytest.mark.parametrize("opt", [
    {"type": "Lamb", "params": {"lr": 3e-3, "betas": [0.9, 0.999], "eps": 1e-6,
                                "weight_decay": 0.01}},
    {"type": "Adagrad", "params": {"lr": 3e-3}},
    {"type": "SGD", "params": {"lr": 3e-3, "momentum": 0.9, "nesterov": True}},
], ids=lambda o: o["type"])
def test_gpt2_trajectory_matches_jax_engine(mesh_single, opt):
    cfg_j, cfg_t = jgpt2.get_config("gpt2-tiny"), tgpt2.get_config("gpt2-tiny")
    before = dict(tfa.LAUNCHES)
    teng = _trajectory(mesh_single, jgpt2.make_module(cfg_j), tgpt2.make_module(cfg_t),
                       _gpt2_params(0), _config(opt), _gpt2_batches(5, 4, seed=3))
    assert type(teng.optimizer).__name__ == opt["type"] and teng.opt_state.count == 5
    assert tfa.LAUNCHES == before  # CPU tensors: the plain versions


def test_bert_lamb_trajectory_matches_jax_engine(mesh_single):
    jc = jbert.get_config("bert-tiny", pretraining=True)
    tc = tbert.get_config("bert-tiny", pretraining=True)
    params = jax.tree.map(np.asarray, jbert.init_params(jc, jax.random.PRNGKey(5)))
    rs = np.random.RandomState(11)
    batches = []
    for _ in range(5):
        ids = rs.randint(4, 512, (4, 64)).astype(np.int32)
        labels = np.full((4, 64), -100, np.int32)
        pick = rs.rand(4, 64) < 0.15
        labels[pick] = ids[pick]
        ids[pick] = 3
        batches.append({"input_ids": ids, "labels": labels,
                        "token_type_ids": (np.arange(64)[None] >= 32).repeat(4, 0)
                        .astype(np.int32),
                        "next_sentence_label": rs.randint(0, 2, (4,)).astype(np.int32)})
    opt = {"type": "Lamb", "params": {"lr": 1e-3, "betas": [0.9, 0.999], "eps": 1e-6,
                                      "weight_decay": 0.01}}
    _trajectory(mesh_single, jbert.make_module(jc), tbert.make_module(tc), params,
                _config(opt), batches)
