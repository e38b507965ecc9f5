"""Training tensor parallelism of the port (GPT-2 over a dp x tp mesh, the
``activation_checkpointing`` section) against the JAX package on the CPU.
The oracles are ``tests/unit/test_gpt2.py::test_gpt2_train_parity_tp_zero``
and ``tests/unit/test_activation_checkpointing.py::
test_partition_activations_parity``.

Every gloo case runs in one world-4 job started with the module
(``tests/torch_dist.py`` ``sequence_tp``); the JAX references are computed
while the ranks run (dp 2 x tp 2 is rank r = dp r // 2, tp r % 2, the
device order of JAX's mesh).

- dp 2 x tp 2 at ZeRO stages 0 and 3 against single-device training
  (JAX's ``DeepSpeedEngine`` on one device, the same weights and batches):
  the losses of 3 steps to rtol 2e-4, as JAX's oracle holds its own
  dp 4 x tp 2; dropout 0.1 against JAX's engine on the same mesh;
- the gradients with ``partition_activations`` and ``cpu_checkpointing``
  (the model's fields, or the engine's section alone, which turns them
  on) equal those without, and the tp gradients (slices gathered whole) equal
  the single-device port's on the same rows (1e-5 absolute, 1e-4
  relative, JAX's parity bound);
- a dp 2 x tp 2 tag (the crc manifest) loads at world 1 and equals the
  gathered state leaf by leaf, its parameters within 1e-5 of JAX's
  single-device trajectory;
- BERT at tp or sp, and LAMB at tp, still raise, naming their items."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dtt
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.parallel.topology import MeshSpec as JMeshSpec
from deepspeed_tpu.runtime.engine import DeepSpeedEngine as JEngine
from deepspeed_tpu_torch.models import bert as tbert
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.runtime.config import NotPortedError
from deepspeed_tpu_torch.utils.weights import params_from_numpy

from tests import torch_dist
from tests.torch_threads import one_torch_thread  # noqa: F401

DP2TP2 = {"dp": 2, "tp": 2}
STEPS = 3


def _conf(dp, stage=0, **extra):
    """JAX's oracle config: the same global batch (16) at every dp."""
    return {"train_micro_batch_size_per_gpu": 8 // dp, "gradient_accumulation_steps": 2,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "zero_optimization": {"stage": stage}, "steps_per_print": 1000, **extra}


@functools.lru_cache(maxsize=None)
def _params_cached():
    cfg = jgpt2.get_config("gpt2-tiny")
    return jax.tree.map(np.asarray, jgpt2.init_params(cfg, jax.random.PRNGKey(3)))


def _params():
    return _params_cached()


def _batches(n=STEPS, rows=16, seed=5):
    rs = np.random.RandomState(seed)
    return [{"input_ids": rs.randint(0, 512, (rows, 32)).astype(np.int32)} for _ in range(n)]


GRAD_BATCH = _batches(1, rows=8, seed=9)[0]
GRAD_CONF = dict(_conf(2), gradient_accumulation_steps=1)
GRAD_CASES = [
    ("g_base", {"remat": True}),
    ("g_part", {"remat": True, "partition_activations": True}),
    ("g_cpu", {"remat": True, "cpu_checkpointing": True}),
    ("g_part_cpu", {"remat": True, "partition_activations": True, "cpu_checkpointing": True}),
    # the model's fields off: the engine's section alone turns both on
    ("g_section", {"remat": True}),
]
SECTION = {"activation_checkpointing": {"partition_activations": True,
                                        "cpu_checkpointing": True}}
RESILIENT = {"resilience": {"enabled": True, "async_checkpoint": False}}


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    p, b = _params(), _batches()
    cases = [
        ("s0", {}, dict(_conf(2, 0, **RESILIENT), mesh=DP2TP2), p, b, {"save": str(tmp / "ck")}),
        ("s3", {}, dict(_conf(2, 3), mesh=DP2TP2), p, b, {}),
        ("dropout", {"dropout": 0.1}, dict(_conf(2), mesh=DP2TP2), p, b[:2], {}),
    ]
    ac = {"activation_checkpointing": {"partition_activations": True,
                                       "number_checkpoints": 2, "profile": True}}
    for name, ov in GRAD_CASES:
        extra = ac if "part" in name else SECTION if name == "g_section" else {}
        conf = dict(GRAD_CONF, mesh=DP2TP2, **extra)
        cases.append((name, ov, conf, p, [], {"grads": GRAD_BATCH}))
    job = torch_dist.start(4, "sequence_tp", ([], cases), tmp)
    job.ckpt = tmp / "ck"
    return job


@functools.lru_cache(maxsize=None)
def _jax_single():
    """JAX's engine on one device: the losses of the 3 steps and its final
    parameters."""
    mesh = JMeshSpec(dp=1, devices=jax.devices()[:1]).build_mesh()
    eng = JEngine(jgpt2.make_module(jgpt2.get_config("gpt2-tiny")), _conf(1), mesh=mesh,
                  params=jax.tree.map(jnp.asarray, _params()), seed=0)
    losses = [float(eng.train_batch(b)["loss"]) for b in _batches()]
    return losses, jax.tree.map(np.asarray, eng.state.params)


@pytest.mark.parametrize("stage", [0, 3])
def test_dp2_tp2_matches_single_device(job, stage):
    """dp 2 x tp 2 at ZeRO stage 0 and 3 trains as one device does (JAX's
    oracle's bound, rtol 2e-4 over 3 steps), on every rank."""
    want, _ = _jax_single()
    for res in job:
        r = res[f"s{stage}"]
        assert r["mesh"] == DP2TP2
        np.testing.assert_allclose(r["loss"], want, rtol=2e-4)


def test_dropout_matches_jax_engine_on_the_mesh(job, devices):
    """Dropout 0.1 at dp 2 x tp 2 draws JAX's masks: the dropouts act on
    tensors each tp rank holds whole, each rank drawing its dp rows of the
    global draw. Losses against ``DeepSpeedEngine`` on the same mesh."""
    mesh = JMeshSpec(**DP2TP2, devices=devices[:4]).build_mesh()
    cfg = jgpt2.get_config("gpt2-tiny", dropout=0.1)
    eng = JEngine(jgpt2.make_module(cfg), dict(_conf(2), mesh=DP2TP2), mesh=mesh,
                  params=jax.tree.map(jnp.asarray, _params()), seed=0)
    want = [float(eng.train_batch(b)["loss"]) for b in _batches()[:2]]
    for res in job:
        np.testing.assert_allclose(res["dropout"]["loss"], want, rtol=2e-4)


def _single_grads(overrides):
    """The port's single-device gradients of rank 0's rows (dp 0: rows
    ``[0, 4)``) under the global micro-batch's token count, as the job's
    rank 0 takes them."""
    cfg = tgpt2.get_config("gpt2-tiny", **overrides)
    params = params_from_numpy(_params(), "cpu")
    leaves = {}

    def req(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                req(v, prefix + (k,))
            else:
                v.requires_grad_(True)
                leaves["/".join(prefix + (k,))] = v

    req(params)
    ids = torch.from_numpy(GRAD_BATCH["input_ids"][:4].astype(np.int64))
    norm = torch.tensor([float((GRAD_BATCH["input_ids"][:, 1:] != -100).sum())])
    loss, _ = tgpt2.lm_loss(cfg, params, {"input_ids": ids, "__norm__": norm}, None, True)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return {k: g.numpy() for k, g in zip(leaves, grads)}


def test_partitioned_and_cpu_checkpointing_keep_the_gradients(job):
    """``partition_activations`` (the saved block input as this rank's
    1/tp slice, all-gathered in backward) and ``cpu_checkpointing`` (in
    host memory) change no gradient; the tp gradients equal the
    single-device port's on the same rows."""
    want = _single_grads({"remat": True})
    base = job[0]["g_base"]["grads"]
    assert set(base) == set(want)
    for k in want:
        np.testing.assert_allclose(base[k], want[k], atol=1e-5, rtol=1e-4, err_msg=k)
    for name, _ in GRAD_CASES[1:]:
        got = job[0][name]["grads"]
        for k in base:
            np.testing.assert_allclose(got[k], base[k], atol=1e-7, rtol=1e-6,
                                       err_msg=f"{name} {k}")


def test_the_section_alone_turns_checkpointing_on(job):
    """The ``activation_checkpointing`` section on its own (the model's
    fields off) keeps each block's saved input as this rank's 1/tp slice
    in host memory, as the model's fields do: every layer's boundary is
    partitioned over tp 2 and offloaded. Without either, no block input is
    kept so."""
    L = tgpt2.get_config("gpt2-tiny").n_layer
    for res in job:
        assert res["g_base"]["boundary"] == []
        assert res["g_part_cpu"]["boundary"] == [[2, True]] * L
        assert res["g_section"]["boundary"] == [[2, True]] * L


def test_section_offloads_at_world_1(monkeypatch):
    """At world 1 the section's ``cpu_checkpointing`` alone sends every
    block's saved input to host memory through the engine, and the losses
    equal those without it."""
    seen = []
    boundary = tgpt2.boundary_checkpoint

    def recording(fn, params, h, partition=None, offload=False, slot=None):
        seen.append((partition, offload))
        return boundary(fn, params, h, partition=partition, offload=offload, slot=slot)

    monkeypatch.setattr(tgpt2, "boundary_checkpoint", recording)
    cfg = tgpt2.get_config("gpt2-tiny", remat=True)
    losses = {}
    for name, extra in (("off", {}), ("section", {"activation_checkpointing": {
            "cpu_checkpointing": True}})):
        seen.clear()
        eng, *_ = dtt.initialize(model=tgpt2.make_module(cfg), config=dict(_conf(1), **extra),
                                 model_parameters=params_from_numpy(_params(), "cpu"),
                                 device="cpu")
        losses[name] = [float(eng.train_batch(b)["loss"]) for b in _batches(1)]
        # each of the step's 2 micro-batches runs every layer once
        assert seen == ([] if name == "off" else [(None, True)] * cfg.n_layer * 2)
    np.testing.assert_allclose(losses["section"], losses["off"], rtol=1e-6)


@pytest.mark.parametrize("which", ["bert", "gpt2_without_remat"])
def test_section_needs_a_model_that_takes_it(which):
    """The section's options act on recomputed blocks: a model without the
    hook (BERT) and GPT-2 without ``remat`` refuse them rather than ignore
    them; at their off values both train as before."""
    if which == "bert":
        model = tbert.make_module(tbert.get_config("bert-tiny", pretraining=True))
    else:
        model = tgpt2.make_module(tgpt2.get_config("gpt2-tiny"))
    for option in ("partition_activations", "cpu_checkpointing"):
        conf = {"train_batch_size": 4, "activation_checkpointing": {option: True}}
        with pytest.raises(ValueError, match="recompute"):
            dtt.initialize(model=model, config=conf, device="cpu")
    dtt.initialize(model=model, config={"train_batch_size": 4, "activation_checkpointing": {
        "partition_activations": False, "profile": True}}, device="cpu")


def test_tp_tag_loads_at_world_1(job):
    """The dp 2 x tp 2 run's tag (whole leaves: every tp slice gathered,
    the fused QKV regrouped back) loads into a world-1 engine equal to the
    gathered state leaf by leaf; its parameters are within 1e-5 of JAX's
    single-device trajectory, so the gather put every slice in place."""
    state = job[0]["s0"]["state"]
    eng, *_ = dtt.initialize(model=tgpt2.make_module(tgpt2.get_config("gpt2-tiny")),
                             config=_conf(1, 0, **RESILIENT), device="cpu", seed=7)
    eng.load_checkpoint(str(job.ckpt), tag="t")
    got = {k: v.detach().numpy() for k, v in eng.state_leaves().items()}
    assert set(got) == set(state)
    for k in state:
        np.testing.assert_array_equal(got[k], state[k], err_msg=k)
    _, jparams = _jax_single()
    flat = {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    for k, v in flat.items():
        np.testing.assert_allclose(got[f"params/{k}"], v, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("mesh,item", [({"tp": 2}, "11b"), ({"sp": 2}, "12c")])
def test_bert_refuses_tp_and_sp(mesh, item):
    """BERT has no tensor- or sequence-parallel plan in the port: the
    engine refuses its mesh naming the ROADMAP item."""
    model = tbert.make_module(tbert.get_config("bert-tiny", pretraining=True))
    with pytest.raises(NotPortedError, match=rf"item {item}\)"):
        dtt.initialize(model=model, config={"train_batch_size": 4, "mesh": mesh}, device="cpu")


def test_lamb_refuses_tp():
    model = tgpt2.make_module(tgpt2.get_config("gpt2-tiny"))
    conf = {"train_batch_size": 4, "mesh": {"tp": 2}, "optimizer": {"type": "Lamb"}}
    with pytest.raises(NotPortedError, match=r"item 11b\)"):
        dtt.initialize(model=model, config=conf, device="cpu")
