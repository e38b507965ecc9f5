"""gpt2-tiny ``train_batch`` trajectories at ``dropout=0.1`` in the port
against ``DeepSpeedEngine`` on a one-device mesh, on the CPU: gas 2, gas 1,
remat "full", and fp16 with overflows, so that ``skipped_steps`` enters the
step's key.

Tolerances as in ``test_torch_training.py`` (1e-5, relative for losses,
absolute for parameters), with Adam's eps at 1e-6 as in the sparse
trajectories: at 1e-8 Adam's first step divides each gradient by its own
magnitude, and a near-zero gradient's last bits then move a parameter by
about lr. fp16 computes each op at half precision where XLA's CPU build
keeps f32 inside its fusions, so the fp16 run holds the losses (taken
before and after the skipped steps, all from the same masks) and the skip
and scale trajectory, not the parameters."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deepspeed_tpu_torch as dtt
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.runtime.engine import DeepSpeedEngine as JEngine
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.utils.weights import params_from_numpy, params_to_numpy
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5
RATE = 0.1
CONFIG = {
    "train_micro_batch_size_per_gpu": 2,
    "gradient_accumulation_steps": 2,
    "gradient_clipping": 1.0,
    "steps_per_print": 1000,
    "optimizer": {"type": "AdamW",
                  "params": {"lr": 3e-3, "betas": [0.9, 0.95], "eps": 1e-6, "weight_decay": 0.1}},
    "scheduler": {"type": "WarmupLR",
                  "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 3e-3, "warmup_num_steps": 4}},
}


def _params(seed=0):
    cfg = jgpt2.get_config("gpt2-tiny")
    return jax.tree.map(np.asarray, jgpt2.init_params(cfg, jax.random.PRNGKey(seed)))


def _batches(n, rows, S=32, seed=0):
    rs = np.random.RandomState(seed)
    return [{"input_ids": rs.randint(0, 512, (rows, S)).astype(np.int32)} for _ in range(n)]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree, np.float32)}


CASES = {
    "gas2": ({}, {}),
    "gas1": ({"gradient_accumulation_steps": 1, "train_micro_batch_size_per_gpu": 4}, {}),
    "remat full": ({}, {"remat": True}),
}


def _engines(conf, over, mesh_single, seed=0):
    params = _params(seed)
    jcfg = jgpt2.get_config("gpt2-tiny", dropout=RATE, **over)
    tcfg = tgpt2.get_config("gpt2-tiny", dropout=RATE, **over)
    jeng = JEngine(jgpt2.make_module(jcfg), copy.deepcopy(conf), mesh=mesh_single,
                   params=jax.tree.map(jnp.asarray, params), seed=0)
    teng, *_ = dtt.initialize(model=tgpt2.make_module(tcfg), config=copy.deepcopy(conf),
                              model_parameters=params_from_numpy(params, "cpu"), device="cpu")
    return jeng, teng


@pytest.mark.parametrize("case", list(CASES))
def test_dropout_trajectory_matches_jax_engine(mesh_single, case):
    conf_over, model_over = CASES[case]
    jeng, teng = _engines(dict(CONFIG, **conf_over), model_over, mesh_single)
    for i, b in enumerate(_batches(5, 4, seed=3)):
        mj, mt = jeng.train_batch(b), teng.train_batch(b)
        lj, lt = float(mj["loss"]), float(mt["loss"])
        assert abs(lt - lj) <= TOL * abs(lj), (i, lt, lj)
        assert mt["global_step"] == int(mj["global_step"]) == i + 1
    pj = _flat(jax.tree.map(np.asarray, jeng.state.params))
    pt = _flat(params_to_numpy(teng.params))
    assert pj.keys() == pt.keys()
    for name in pj:
        np.testing.assert_allclose(pt[name], pj[name], atol=TOL, rtol=0, err_msg=name)


def test_fp16_overflow_enters_the_step_key(mesh_single):
    """Scale 2**20 with hysteresis 1: the first three steps overflow in
    both packages and skip, then two steps apply. Step 4's masks come from
    fold_in(rng, 0 + 3): global_step has not moved, skipped_steps has."""
    conf = dict(CONFIG, fp16={"enabled": True, "initial_scale_power": 20, "hysteresis": 1})
    jeng, teng = _engines(conf, {}, mesh_single)
    flags = []
    for i, b in enumerate(_batches(5, 4, seed=3)):
        mj, mt = jeng.train_batch(b), teng.train_batch(b)
        lj, lt = float(mj["loss"]), float(mt["loss"])
        assert abs(lt - lj) <= TOL * abs(lj), (i, lt, lj)
        assert bool(mj["overflow"]) == mt["overflow"]
        assert float(mj["loss_scale"]) == mt["loss_scale"]
        flags.append(mt["overflow"])
    assert flags == [True, True, True, False, False]
    assert teng.skipped_steps == jeng.skipped_steps == 3
    assert teng.get_global_step() == int(jeng.get_global_step()) == 2
