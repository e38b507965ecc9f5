"""The training path's host-side pieces against the JAX package's: the five
LR schedules at steps 0..50 (relative 1e-6: JAX computes them in f32, the
port in f64), the data loader's order, the loss-scale transitions, Adam
against optax on random trees (1e-6), and the config's batch triple; plus
what is not ported raising ``NotPortedError``, and the entry point
defaulting to the card."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import deepspeed_tpu_torch as dtt
from deepspeed_tpu.runtime import dataloader as jdl
from deepspeed_tpu.runtime import lr_schedules as jlr
from deepspeed_tpu.runtime import optimizers as jopt
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
from deepspeed_tpu.runtime.fp16 import loss_scaler as jls
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.runtime import dataloader as tdl
from deepspeed_tpu_torch.runtime import lr_schedules as tlr
from deepspeed_tpu_torch.runtime import optimizers as topt
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig, NotPortedError
from deepspeed_tpu_torch.runtime.fp16 import loss_scaler as tls

SCHEDULES = [
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-3, "lr_range_test_step_size": 7,
                     "lr_range_test_step_rate": 2.0, "lr_range_test_staircase": False}),
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-3, "lr_range_test_step_size": 7,
                     "lr_range_test_staircase": True}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-2, "cycle_first_step_size": 10,
                  "cycle_second_step_size": 15, "decay_lr_rate": 0.5, "decay_step_size": 4}),
    ("WarmupLR", {"warmup_min_lr": 1e-5, "warmup_max_lr": 3e-3, "warmup_num_steps": 20}),
    ("WarmupLR", {"warmup_max_lr": 3e-3, "warmup_num_steps": 20, "warmup_type": "linear"}),
    ("WarmupDecayLR", {"total_num_steps": 40, "warmup_max_lr": 3e-3, "warmup_num_steps": 10}),
    ("CosineAnnealing", {"total_num_steps": 45, "warmup_num_steps": 5, "warmup_max_lr": 2e-3,
                         "cosine_min_ratio": 0.1}),
]


@pytest.mark.parametrize("name,params", SCHEDULES)
def test_lr_schedule_matches_jax(name, params):
    js = jlr.get_lr_schedule(name, params)
    ts = tlr.get_lr_schedule(name, params)
    for step in range(51):
        ref = float(js(jnp.int32(step)))
        assert ts(step) == pytest.approx(ref, rel=1e-6, abs=1e-12), (name, step)


def test_no_scheduler_is_the_optimizer_lr():
    assert tlr.get_lr_schedule(None, None, fallback_lr=5e-4)(17) == 5e-4
    with pytest.raises(ValueError, match="unknown scheduler"):
        tlr.get_lr_schedule("Nope", {})


def test_dataloader_order_matches_jax():
    rs = np.random.RandomState(0)
    data = [{"x": rs.randn(3).astype(np.float32), "y": np.int32(i)} for i in range(23)]
    jl = jdl.DeepSpeedDataLoader(data, batch_size=4, seed=5)
    tl = tdl.DeepSpeedDataLoader(data, batch_size=4, seed=5)
    assert len(tl) == len(jl) == 5
    for _epoch in range(2):  # each pass advances the epoch, and the order
        for bj, bt in zip(list(jl), list(tl)):
            np.testing.assert_array_equal(bt["y"], bj["y"])
            np.testing.assert_array_equal(bt["x"], bj["x"])
    rep = tdl.RepeatingLoader(tdl.DeepSpeedDataLoader(data, batch_size=10, shuffle=False))
    firsts = [next(rep)["y"][0] for _ in range(3)]
    assert firsts == [0, 10, 0]


@pytest.mark.parametrize("hysteresis,window", [(1, 3), (2, 3), (3, 2)])
def test_loss_scale_transitions_match_jax(hysteresis, window):
    pattern = [True, False, True, True, False, False, False, True, True, True, False, False,
               False, False, False]
    js = jls.create(dynamic=True, initial_scale_power=6, hysteresis=hysteresis)
    ts = tls.create(dynamic=True, initial_scale_power=6, hysteresis=hysteresis)
    for ov in pattern:
        js = jls.update(js, jnp.bool_(ov), dynamic=True, scale_window=window, min_scale=4.0)
        ts = tls.update(ts, ov, dynamic=True, scale_window=window, min_scale=4.0)
        assert ts.cur_scale == float(js.cur_scale)
        assert ts.cur_hysteresis == int(js.cur_hysteresis)
        assert ts.last_overflow_iter == int(js.last_overflow_iter)
        assert ts.iteration == int(js.iteration)


def test_has_inf_or_nan():
    good = [torch.ones(3), torch.zeros(2, 2)]
    assert not bool(tls.has_inf_or_nan(good))
    assert bool(tls.has_inf_or_nan(good + [torch.tensor([1.0, float("nan")])]))
    assert bool(tls.has_inf_or_nan({"a": torch.tensor([float("inf")])}))


@pytest.mark.parametrize("opt,params", [
    ("AdamW", {"betas": [0.9, 0.95], "eps": 1e-8, "weight_decay": 0.1}),
    ("Adam", {"betas": [0.8, 0.99], "eps": 1e-6, "weight_decay": 0.05, "adam_w_mode": False}),
    ("FusedAdam", {}),
])
def test_adam_matches_optax(opt, params):
    rs = np.random.RandomState(1)
    tree = {"w": rs.randn(5, 4).astype(np.float32), "b": rs.randn(4).astype(np.float32),
            "n": {"m": rs.randn(3, 2, 2).astype(np.float32)}}
    sched = tlr.get_lr_schedule("WarmupLR", {"warmup_max_lr": 1e-2, "warmup_num_steps": 3})
    jsched = jlr.get_lr_schedule("WarmupLR", {"warmup_max_lr": 1e-2, "warmup_num_steps": 3})
    tx = jopt.build_optimizer(opt, params, learning_rate=jsched)
    ours = topt.build_optimizer(opt, params, learning_rate=sched)
    jp = {k: jnp.asarray(v) if not isinstance(v, dict) else {kk: jnp.asarray(vv) for kk, vv in v.items()}
          for k, v in tree.items()}
    js = tx.init(jp)
    tp = {"w": torch.from_numpy(tree["w"].copy()), "b": torch.from_numpy(tree["b"].copy()),
          "n": {"m": torch.from_numpy(tree["n"]["m"].copy())}}
    ts = ours.init(tp)
    for step in range(4):
        g = {"w": rs.randn(5, 4).astype(np.float32), "b": rs.randn(4).astype(np.float32),
             "n": {"m": rs.randn(3, 2, 2).astype(np.float32) * 1e-3}}
        jg = {"w": jnp.asarray(g["w"]), "b": jnp.asarray(g["b"]), "n": {"m": jnp.asarray(g["n"]["m"])}}
        upd, js = tx.update(jg, js, jp)
        jp = optax.apply_updates(jp, upd)
        ours.step(tp, [torch.from_numpy(g["b"]), torch.from_numpy(g["n"]["m"]),
                       torch.from_numpy(g["w"])], ts)
        np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(tp["b"].numpy(), np.asarray(jp["b"]), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(tp["n"]["m"].numpy(), np.asarray(jp["n"]["m"]),
                                   atol=1e-6, rtol=1e-6)
    assert ts.count == 4


@pytest.mark.parametrize("triple", [
    {"train_batch_size": 12, "train_micro_batch_size_per_gpu": 3},
    {"train_batch_size": 12, "gradient_accumulation_steps": 2},
    {"train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 3},
    {"train_batch_size": 8},
])
def test_batch_triple_matches_jax(triple):
    jc = JConfig.load(dict(triple), dp_world_size=1)
    tc = DeepSpeedConfig.load(dict(triple))
    assert (tc.train_batch_size, tc.train_micro_batch_size_per_gpu,
            tc.gradient_accumulation_steps) == (jc.train_batch_size,
                                                jc.train_micro_batch_size_per_gpu,
                                                jc.gradient_accumulation_steps)


@pytest.mark.parametrize("section", [
    {"zero_optimization": {"stage": 2, "offload_param": {"device": "cpu"}}},
    {"zero_optimization": {"stage": 0, "offload_optimizer": {"device": "cpu"}}},
    {"tensorboard": {"enabled": True}},
    {"activation_checkpointing": {"partition_activations": True}},
    {"mesh": {"dp": 1, "tp": 2}},
])
def test_unported_config_sections_raise(section):
    with pytest.raises(NotPortedError):
        DeepSpeedConfig.load({"train_batch_size": 4, **section})


def test_config_sections_at_their_off_values_are_accepted():
    cfg = DeepSpeedConfig.load({
        "train_batch_size": 4, "wall_clock_breakdown": False, "tensorboard": {"enabled": False},
        "zero_optimization": {"stage": 0, "reduce_bucket_size": 5e8}, "mesh": {"dp": 1},
        "bf16": {"enabled": True}, "data_types": {"grad_accum_dtype": "fp32"},
    })
    assert cfg.compute_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="both"):
        DeepSpeedConfig.load({"train_batch_size": 4, "bf16": {"enabled": True},
                              "fp16": {"enabled": True}})
    with pytest.raises(ValueError, match="unknown config keys"):
        DeepSpeedConfig.load({"train_batch_size": 4, "fp16": {"enabled": True, "scale": 2}})


@pytest.mark.parametrize("override", [{"attn_impl": "ulysses"},
                                      {"moe_experts": 4}, {"attn_impl": "ring_flash"},
                                      {"attn_impl": "ring"}])
def test_unported_model_options_raise(override):
    with pytest.raises(NotPortedError):
        tgpt2.get_config("gpt2-tiny", **override)


def test_dropout_option_is_accepted():
    """Dropout is ported (JAX's masks, tests/test_torch_dropout.py): the
    option that raised before now configures the model and trains."""
    cfg = tgpt2.get_config("gpt2-tiny", dropout=0.1)
    assert cfg.dropout == 0.1
    eng, *_ = dtt.initialize(model=tgpt2.make_module(cfg), config={"train_batch_size": 2},
                             device="cpu")
    ids = np.random.RandomState(0).randint(0, 512, (2, 16)).astype(np.int32)
    assert np.isfinite(float(eng.train_batch({"input_ids": ids})["loss"]))


@pytest.mark.parametrize("opt", ["OneBitAdam", "ZeroOneAdam", "OneBitLamb"])
def test_unported_optimizers_raise(opt):
    """The 1-bit optimizers (the JAX engine's runtime/fp16/onebit/, which
    compress momentum) are not ported; every other registry type is."""
    with pytest.raises(NotPortedError, match="queue 1 item 13"):
        topt.build_optimizer(opt, {"lr": 1e-3})


def test_initialize_defaults_to_the_card():
    model = tgpt2.make_module(tgpt2.get_config("gpt2-tiny"))
    conf = {"train_batch_size": 2}
    if torch.cuda.is_available():
        eng, *_ = dtt.initialize(model=model, config=conf)
        assert eng.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            dtt.initialize(model=model, config=conf)
    eng, opt, loader, sched = dtt.initialize(model=model, config=conf, device="cpu")
    assert eng.device.type == "cpu" and loader is None and sched(3) == 1e-3
    assert eng.zero_optimization_stage() == 0 and eng.train_batch_size == 2
    with pytest.raises(NotPortedError):
        dtt.initialize(model=model, config=conf, device="cpu", optimizer=object())
