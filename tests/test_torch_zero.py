"""ZeRO stages 0-3 of the port against the JAX package's on the CPU.

- The policy: every leaf's param / grad / optimizer-state spec of gpt2-tiny
  and bert-tiny at dp 2, 4 and 8 and each stage equal to JAX's on a mesh of
  the CPU devices, and the engine's shard layout equal to those specs.
- Trajectories: ``DeepSpeedEngine`` on ``MeshSpec(dp=2)`` against the
  port's engine on 2 gloo ranks (one spawn, ``tests/torch_dist.py``), from
  the same numpy weights and batches: gpt2-tiny with AdamW, WarmupLR and
  clipping at stages 0-3 (``test_torch_zero_cases.py`` holds LAMB, dropout,
  fp16 and dp 4). Each rank holds 1/dp of the optimizer state (and at
  stage 3 of the params) of the leaves over the thresholds, and issues the
  collectives of its stage's plan.
- TiledLinear, OnDevice and the checkpoint regridding against JAX's.

Tolerances: losses within JAX's own ZeRO bound (``tests/unit/test_zero.py``:
rtol 2e-5, atol 2e-6); the final fp32 master within 1e-5 absolute, the
bound of the port's single-device trajectory tests: the two packages sum
in different orders, and at that bound's scale (measured: ~20 of 141,056
gpt2-tiny elements past rtol 2e-5 / atol 2e-6 after 3 AdamW steps, at dp 1
as at dp 2) Adam turns the order into the master's last bits. Within the
port, stage 1 equals stage 0 bit for bit (the same all-reduce, the same
elementwise update on shards); stages 2-3 sum each micro-batch's
reduce-scatter into the sharded accumulation, a different order, and are
held to stage 0 as to JAX."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.parallel.topology import MeshSpec as JMeshSpec
from deepspeed_tpu.runtime.engine import DeepSpeedEngine as JEngine
from deepspeed_tpu.runtime.zero import partitioning as jpart
from deepspeed_tpu.runtime.zero import tiling as jtiling
from deepspeed_tpu.utils.init_on_device import OnDevice as JOnDevice
from deepspeed_tpu_torch.models import bert as tbert
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.runtime.zero import partitioning as tpart
from deepspeed_tpu_torch.runtime.zero import tiling as ttiling
from deepspeed_tpu_torch.utils.init_on_device import OnDevice
from deepspeed_tpu_torch.utils.weights import tree_leaves

from tests import torch_dist
from tests.torch_threads import one_torch_thread  # noqa: F401

LOSS = dict(rtol=2e-5, atol=2e-6)
MASTER_ATOL = 1e-5

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
# stage 3's parameter threshold (stage3_param_persistence_threshold): 1000
# elements shard gpt2-tiny's matrices and keep its biases and norms whole
ZERO = {"stage3_param_persistence_threshold": 1000}


def _gpt2_params():
    cfg = jgpt2.get_config("gpt2-tiny")
    return jax.tree.map(np.asarray, jgpt2.init_params(cfg, jax.random.PRNGKey(0)))


def _bert_params():
    cfg = jbert.get_config("bert-tiny", pretraining=True)
    return jax.tree.map(np.asarray, jbert.init_params(cfg, jax.random.PRNGKey(1)))


def _batches(n, rows, seed):
    rs = np.random.RandomState(seed)
    return [{"input_ids": rs.randint(0, 512, (rows, 32)).astype(np.int32)} for _ in range(n)]


def _bert_batches(n, seed):
    """MLM batches whose rows 0-1 of each 4-row micro-batch (rank 0's at dp
    2) mask 3 positions and rows 2-3 (rank 1's) mask 9."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rs.randint(0, 512, (8, 32)).astype(np.int32)
        labels = np.full_like(ids, -100)
        for r in range(8):
            pos = rs.choice(32, 3 if r % 4 < 2 else 9, replace=False)
            labels[r, pos] = ids[r, pos]
        out.append({"input_ids": ids, "labels": labels,
                    "next_sentence_label": rs.randint(0, 2, (8,)).astype(np.int32)})
    return out


def _fp16_batches(seed):
    """Three batches; the second has an inf in its attention mask in rank
    1's rows of micro-batch 1: only rank 1's loss and gradients go non-finite."""
    out = []
    for i, b in enumerate(_batches(3, 8, seed)):
        b["attention_mask"] = np.ones((8, 32), np.float32)
        if i == 1:
            b["attention_mask"][7, 5] = np.inf
        out.append(b)
    return out


def _stage(conf, stage):
    return dict(conf, zero_optimization=dict(ZERO, stage=stage))


LAMB = dict(_stage(CONFIG, 2), optimizer={"type": "Lamb",
                                          "params": {"lr": 2e-3, "weight_decay": 0.01}})
FP16 = dict(_stage(CONFIG, 2), fp16={"enabled": True, "initial_scale_power": 8, "hysteresis": 1})
DP4 = dict(_stage(CONFIG, 3), train_micro_batch_size_per_gpu=1)


def _on_dp(cases):
    return [(n, m, dict(c, mesh={"dp": -1}), p, b, o) for n, m, c, p, b, o in cases]


@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    p, b = _gpt2_params(), _batches(3, 8, 3)
    cases = [(f"gpt2_s{s}", "gpt2", _stage(CONFIG, s), p, b, {}) for s in range(4)]
    return torch_dist.start(2, "train", (_on_dp(cases),), tmp_path_factory.mktemp("zero2"))


def _jax_run(module, conf, params, batches, dp, devices):
    mesh = JMeshSpec(dp=dp, devices=devices[:dp]).build_mesh()
    eng = JEngine(module, dict(conf), mesh=mesh, params=jax.tree.map(jnp.asarray, params), seed=0)
    ms = [eng.train_batch(b) for b in batches]
    return eng, {k: [float(m[k]) for m in ms] for k in ("loss", "grad_norm", "loss_scale")}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree, np.float32)}


def _check_trajectory(res, jm):
    """The losses and the global grad norms (before clipping) within the
    loss bound: the norms sum squares over shards and ranks, which a
    scale-invariant optimizer (Adam, LAMB) would not show in the master."""
    np.testing.assert_allclose(res["loss"], jm["loss"], **LOSS)
    np.testing.assert_allclose(res["grad_norm"], jm["grad_norm"], **LOSS)


def _check_master(got, jeng):
    want = _flat(jax.tree.map(np.asarray, jeng.state.params))
    got = _flat(got)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=MASTER_ATOL,
                                   err_msg=name)


def _same_on_every_rank(ranks, name):
    for r in ranks[1:]:
        assert r[name]["loss"] == ranks[0][name]["loss"]
        assert r[name]["grad_norm"] == ranks[0][name]["grad_norm"]
        for a, b in zip(tree_leaves(r[name]["master"]), tree_leaves(ranks[0][name]["master"])):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the policy
# ---------------------------------------------------------------------------

class _Mesh:
    def __init__(self, n):
        self.shape = {"dp": n}


def _spec_leaves(tree):
    """A tree of specs (tuples) → its specs in sorted-key order."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _spec_leaves(tree[k])]
    return [tree]


@pytest.mark.parametrize("dp", [2, 4, 8])
@pytest.mark.parametrize("model", ["gpt2-tiny", "bert-tiny"])
def test_specs_and_layout_match_jax(model, dp, devices):
    """Each stage's param / grad / opt spec of every leaf equals JAX's (with
    the model's logical axes, on a dp mesh of the CPU devices), and the
    engine's shard dims are those specs' dp dims."""
    if model == "gpt2-tiny":
        jmod = jgpt2.make_module(jgpt2.get_config(model))
        params = _gpt2_params()
    else:
        jmod = jbert.make_module(jbert.get_config(model, pretraining=True))
        params = _bert_params()
    mesh = JMeshSpec(dp=dp, devices=devices[:dp]).build_mesh()
    shapes = [tuple(a.shape) for a in jax.tree.leaves(params)]
    for stage in range(4):
        thr = max(2, ZERO["stage3_param_persistence_threshold"]) if stage >= 3 else 2**14
        jp = jpart.ZeroShardingPolicy(mesh, stage=stage, min_size_to_shard=thr)
        tp = tpart.ZeroShardingPolicy(_Mesh(dp), stage=stage, min_size_to_shard=thr)
        layout = tpart.ZeroLayout(shapes, stage, dp, param_min_size=thr)
        for fn, dims in (("param", layout.param), ("grad", layout.grad), ("opt", layout.opt)):
            jspecs = jax.tree.leaves(getattr(jp, {"param": "param_shardings", "grad":
                                                  "grad_shardings", "opt":
                                                  "opt_shardings_for_params"}[fn])(
                jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), params),
                jmod.logical_axes))
            tspecs = _spec_leaves(getattr(tp, {"param": "param_shardings", "grad":
                                              "grad_shardings", "opt":
                                              "opt_shardings_for_params"}[fn])(params))
            assert len(jspecs) == len(tspecs) == len(dims)
            for js, ts, d, shape in zip(jspecs, tspecs, dims, shapes):
                assert tuple(js.spec) == ts, (stage, fn, shape, js.spec, ts)
                if fn != "opt":  # opt may follow a sharded master (ZeroLayout)
                    assert tpart.zero_dim(ts) == d, (stage, fn, shape, ts, d)
                elif tpart.zero_dim(ts) is not None:
                    assert d == tpart.zero_dim(ts)
        assert tp.grad_reduce_op() == jp.grad_reduce_op()


def test_policy_unit_cases():
    """tests/unit/test_zero.py's spec cases on the port's functions."""
    m = _Mesh(8)
    assert tpart.add_zero_axis((), (1024, 64), m, min_size_to_shard=0) == ("dp",)
    assert tpart.add_zero_axis((), (4,), m, min_size_to_shard=2**14) == ()
    assert tpart.add_zero_axis((), (3, 5), m, min_size_to_shard=0) == ()
    m2 = type("M", (), {"shape": {"dp": 4, "tp": 2}})()
    assert tpart.add_zero_axis(("tp", None), (256, 512), m2, min_size_to_shard=0) == ("tp", "dp")
    assert tpart.logical_to_spec(("embed", "mlp"), mesh=m2) == (None, "tp")
    assert tpart.logical_to_spec(("qkv", "mlp"), mesh=m2) == ("tp",)
    for stage, want in {0: (False, False, False), 1: (False, False, True),
                        2: (False, True, True), 3: (True, True, True)}.items():
        pol = tpart.ZeroShardingPolicy(m, stage=stage, min_size_to_shard=0)
        got = tuple("dp" in s for s in (pol.param_spec((None, None), (256, 256)),
                                        pol.grad_spec((None, None), (256, 256)),
                                        pol.opt_spec((None, None), (256, 256))))
        assert got == want, stage


def test_shard_and_gather_helpers():
    t = torch.arange(24.).reshape(4, 6)
    s = tpart.shard_of(t, (None, "dp"), 1, 2)
    assert torch.equal(s, t[:, 3:]) and s.is_contiguous() and s.data_ptr() != t.data_ptr()
    tree = tpart.init_partitioned(lambda: {"a": t, "b": torch.ones(3)},
                                  {"a": ("dp",), "b": ()}, rank=1, world=2)
    assert torch.equal(tree["a"], t[2:]) and torch.equal(tree["b"], torch.ones(3))


# ---------------------------------------------------------------------------
# trajectories against the JAX engine on a dp mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_gpt2_adamw_stage_matches_jax_dp2(stage, dp2, devices):
    name = f"gpt2_s{stage}"
    jeng, jm = _jax_run(jgpt2.make_module(jgpt2.get_config("gpt2-tiny")), _stage(CONFIG, stage),
                        _gpt2_params(), _batches(3, 8, 3), 2, devices)
    _check_trajectory(dp2[0][name], jm)
    _check_master(dp2[0][name]["master"], jeng)
    _same_on_every_rank(dp2, name)
    # the port's own stage against its stage 0: ZeRO moves only the sums
    base = dp2[0]["gpt2_s0"]
    np.testing.assert_allclose(dp2[0][name]["loss"], base["loss"], **LOSS)
    for a, b in zip(tree_leaves(dp2[0][name]["master"]), tree_leaves(base["master"])):
        if stage <= 1:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=MASTER_ATOL)


def check_shards(ranks, name, stage, n):
    """Every rank holds 1/n of each leaf's optimizer state from stage 1,
    and of its master at stage 3, for leaves over the thresholds (2**7 and
    stage 3's 1000); the others whole."""
    full = {f"params/{k}": v.shape for k, v in _flat(_gpt2_params()).items()}
    for r in ranks:
        shards = r[name]["shards"]
        for key, shape in shards.items():
            pkey = key if key.startswith("params/") else "params/" + key.split("/", 3)[-1] \
                if key.startswith("opt_state/0/") else None
            if pkey not in full:
                continue
            size = int(np.prod(full[pkey]))
            is_param = key.startswith("params/")
            over = size >= (1000 if is_param else 2**7)
            sharded = (stage >= 3 or not is_param) and stage >= 1 and over
            assert int(np.prod(shape)) == (size // n if sharded else size), (key, shape)
        mem = r[name]["memory"]
        assert mem["zero_stage"] == stage and mem["dp_world_size"] == n


def check_gather_full(ranks):
    for r in ranks:
        assert all(res["gather_full_equal"] for res in r.values())


def check_plan(ranks):
    """The comms logger's calls of one step, by kind, equal the engine's
    plan for its stage."""
    for r in ranks:
        for name, res in r.items():
            plan = {k: v for k, v in res["plan"].items() if v}
            assert res["step_comms"] == plan, (name, res["step_comms"], plan)


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_shards_hold_one_dp_th(stage, dp2):
    check_shards(dp2, f"gpt2_s{stage}", stage, 2)


def test_step_collectives_equal_the_plan(dp2):
    """The comms logger's calls of one step, by kind, equal the engine's
    plan for its stage (gas 2; GPT-2's tied embedding gathered and
    reduce-scattered once a micro-batch)."""
    check_plan(dp2)
    check_gather_full(dp2)
    assert dp2[0]["gpt2_s0"]["plan"] == {"all_reduce": 17, "reduce_scatter": 0, "all_gather": 0}
    assert dp2[0]["gpt2_s3"]["plan"]["all_gather"] > dp2[0]["gpt2_s2"]["plan"]["all_gather"]


# ---------------------------------------------------------------------------
# small modules against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("splits", [(1, 1), (2, 3), (3, 2)])
def test_tiled_linear_matches_jax(splits):
    rs = np.random.RandomState(0)
    w, b = rs.standard_normal((10, 7)).astype(np.float32), rs.standard_normal(7).astype(
        np.float32)
    x = rs.standard_normal((4, 10)).astype(np.float32)
    jp = jtiling.TiledLinear.from_dense(jnp.asarray(w), jnp.asarray(b), *splits)
    tp = ttiling.TiledLinear.from_dense(torch.from_numpy(w), torch.from_numpy(b), *splits)
    yj = np.asarray(jtiling.tiled_linear(jp, jnp.asarray(x)))
    yt = ttiling.tiled_linear(tp, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(yt, yj, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(yt, x @ w + b, rtol=1e-5, atol=1e-5)
    assert ttiling.split_dim(10, 3) == jtiling.split_dim(10, 3) == [4, 3, 3]
    tl = ttiling.TiledLinear(10, 7, *splits)
    shapes = [tuple(t.shape) for t in tree_leaves(tl.init(torch.Generator().manual_seed(0)))]
    jshapes = [tuple(t.shape) for t in jax.tree.leaves(
        jtiling.TiledLinear(10, 7, *splits).init(jax.random.PRNGKey(0)))]
    assert sorted(shapes) == sorted(jshapes)


@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_on_device_meta_matches_jax_eval_shape(dtype):
    jd, td = (None, None) if dtype is None else (jnp.bfloat16, torch.bfloat16)
    for jmod, tmod in ((jgpt2.make_module(jgpt2.get_config("gpt2-tiny")),
                        tgpt2.make_module(tgpt2.get_config("gpt2-tiny"))),
                       (jbert.make_module(jbert.get_config("bert-tiny", pretraining=True)),
                        tbert.make_module(tbert.get_config("bert-tiny", pretraining=True)))):
        ja = JOnDevice(dtype=jd, device="meta").init(jmod.init, jax.random.PRNGKey(0))
        ta = OnDevice(dtype=td, device="meta").init(tmod.init, torch.Generator().manual_seed(0))
        jf, tf = jax.tree.leaves(ja), tree_leaves(ta)
        assert len(jf) == len(tf)
        for j, t in zip(jf, tf):
            assert t.device.type == "meta" and tuple(t.shape) == tuple(j.shape)
            assert str(t.dtype).replace("torch.", "") == str(j.dtype)
    placed = OnDevice(device="cpu").init(lambda: {"w": torch.ones(2, dtype=torch.float64)})
    assert placed["w"].device.type == "cpu"
    with pytest.raises(ValueError):
        OnDevice(device="nowhere").init(lambda: {})


def test_reshape_matches_jax():
    from deepspeed_tpu.checkpoint import reshape as jr
    from deepspeed_tpu_torch.checkpoint import reshape as tr

    rs = np.random.RandomState(0)
    sd = {}
    for layer in range(4):
        p = f"language_model.transformer.layers.{layer}."
        sd[p + "attention.query_key_value.weight"] = rs.standard_normal((12, 4))
        sd[p + "attention.dense.weight"] = rs.standard_normal((4, 4))
        sd[p + "mlp.dense_h_to_4h.bias"] = rs.standard_normal(8)
        sd[p + "input_layernorm.weight"] = rs.standard_normal(4)
    sd["language_model.embedding.word_embeddings.weight"] = rs.standard_normal((16, 4))
    sd["language_model.transformer.final_layernorm.weight"] = rs.standard_normal(4)

    def same(a, b):
        if isinstance(a, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
            return
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])

    same(tr.split_tp_state_dict(sd, 2), jr.split_tp_state_dict(sd, 2))
    same(tr.reshape_tp(jr.split_tp_state_dict(sd, 2), 4), jr.reshape_tp(
        jr.split_tp_state_dict(sd, 2), 4))
    same(tr.split_pp_state_dict(sd, 3), jr.split_pp_state_dict(sd, 3))
    grid = [jr.split_tp_state_dict(s, 2) for s in jr.split_pp_state_dict(sd, 2)]
    same(tr.reshape_2d(grid, 1, 4), jr.reshape_2d(grid, 1, 4))
    same(tr.merge_pp_state_dicts(jr.split_pp_state_dict(sd, 2)), sd)


# ---------------------------------------------------------------------------
# the config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_zero_stages_and_dp_mesh_are_accepted(stage):
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

    d = {"train_batch_size": 16, "gradient_accumulation_steps": 2, "mesh": {"dp": -1},
         "zero_optimization": {"stage": stage, "overlap_comm": True,
                               "stage3_param_persistence_threshold": 64,
                               "stage3_gather_16bit_weights_on_model_save": True}}
    for dp in (1, 2, 4):
        t, j = DeepSpeedConfig.load(dict(d), dp_world_size=dp), JConfig.load(dict(d),
                                                                               dp_world_size=dp)
        assert (t.train_batch_size, t.train_micro_batch_size_per_gpu,
                t.gradient_accumulation_steps) == (j.train_batch_size,
                                                   j.train_micro_batch_size_per_gpu,
                                                   j.gradient_accumulation_steps)
        assert t.zero_optimization.stage == j.zero_optimization.stage == stage
        assert t.zero_optimization.stage3_param_persistence_threshold == 64


# each case names its ROADMAP item exactly ("item 11b", not a prefix of
# it); the ids are the cases' first names, kept when the items were split
@pytest.mark.parametrize("section,item", [
    pytest.param({"zero_optimization": {"stage": 2, "offload_optimizer": {"device": "cpu"}}},
                 "13", id="section0-13"),
    pytest.param({"zero_optimization": {"stage": 3, "offload_param": {"device": "nvme"}}},
                 "13", id="section1-13"),
    pytest.param({"comm_compression": {"enabled": True}}, "12/13", id="section2-12/13"),
    pytest.param({"mesh": {"dp": -1, "tp": 2}}, "11b", id="section3-11"),
    pytest.param({"mesh": {"dp": -1, "pp": 2}}, "12b", id="section4-12"),
    pytest.param({"mesh": {"dp": -1, "ep": 2}}, "12d", id="section5-12"),
    pytest.param({"mesh": {"dp": -1, "sp": 2}}, "12c", id="section6-12"),
])
def test_remaining_gaps_still_raise(section, item):
    """What the port still refuses names its item. ``mesh.tp`` and
    ``mesh.sp`` are accepted since GPT-2 trains over them; they remain
    refused for a model without a tensor- or sequence-parallel plan
    (BERT), which the engine refuses naming 11b and 12c."""
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig, NotPortedError

    config = {"train_batch_size": 4, **section}
    if item in ("11b", "12c"):
        DeepSpeedConfig.load(dict(config))
        import deepspeed_tpu_torch as dtt

        with pytest.raises(NotPortedError, match=rf"item {re.escape(item)}\)"):
            dtt.initialize(model=tbert.make_module(tbert.get_config("bert-tiny",
                                                                   pretraining=True)),
                           config=config, device="cpu")
        return
    with pytest.raises(NotPortedError, match=rf"item {re.escape(item)}\)"):
        DeepSpeedConfig.load(config)


@pytest.mark.parametrize("section,item", [
    ("activation_checkpointing", "11b"), ("aio", "13"), ("flops_profiler", "14"),
    ("elasticity", "14"), ("curriculum_learning", "14"), ("progressive_layer_drop", "14"),
    ("eigenvalue", "14"), ("debug", "14"), ("analysis", "15"),
])
def test_refused_sections_name_their_item(section, item):
    """Every top-level JAX section the port does not read yet is refused
    naming the ROADMAP queue 1 item that ports it; an off section passes.
    Item 11b's section, ``activation_checkpointing``, is read since it
    landed: its fields load as JAX's and an engine of a recomputing GPT-2
    takes it; a mesh axis
    still refused (pp) names its item."""
    from deepspeed_tpu_torch.parallel.topology import ProcessGroups, ProcessTopology
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig, NotPortedError

    if item == "11b":
        doc = {"partition_activations": True, "cpu_checkpointing": False,
               "contiguous_memory_optimization": True, "number_checkpoints": 4,
               "synchronize_checkpoint_boundary": True, "profile": True}
        cfg = DeepSpeedConfig.load({"train_batch_size": 4, section: doc})
        assert vars(getattr(cfg, section)) == doc
        import deepspeed_tpu_torch as dtt

        eng, *_ = dtt.initialize(
            model=tgpt2.make_module(tgpt2.get_config("gpt2-tiny", remat=True)),
            config={"train_batch_size": 4, section: doc}, device="cpu")
        assert vars(eng.config.activation_checkpointing) == doc
        with pytest.raises(NotPortedError, match=r"item 12b\)"):
            ProcessGroups(ProcessTopology(["pp", "dp"], [2, 1]))
        return
    with pytest.raises(NotPortedError, match=rf"item {item}\)"):
        DeepSpeedConfig.load({"train_batch_size": 4, section: {"enabled": True}})
    DeepSpeedConfig.load({"train_batch_size": 4, section: {"enabled": False}})


@pytest.mark.parametrize("world", [2, 4])
def test_shard_dropout_is_jax_global_draw_slice(world):
    """A rank's dropout under its shard key (``prng.shard_key``) is its
    rows' slice of JAX's ``_dropout`` over the global batch, bit for bit
    (forward and the same draw on dy), in the plain version the CPU runs."""
    from deepspeed_tpu_torch.ops import dropout as tdo
    from deepspeed_tpu_torch.ops import prng

    rs = np.random.RandomState(world)
    x = rs.standard_normal((2 * world, 9, 16)).astype(np.float32)
    key = prng.fold_in(prng.PRNGKey(3), 5)
    want = np.asarray(jgpt2._dropout(jnp.asarray(x), 0.1, jnp.asarray(key), True))
    for r in range(world):
        part = torch.from_numpy(x[2 * r:2 * r + 2]).requires_grad_(True)
        for k in (prng.shard_key(key, r), prng.device_keys(prng.shard_key(key, r))):
            y = tdo.dropout(part, k, 0.1)
            np.testing.assert_array_equal(y.detach().numpy(), want[2 * r:2 * r + 2])
            (gx,) = torch.autograd.grad(y, part, torch.ones_like(part))
            np.testing.assert_array_equal(gx.numpy() != 0, want[2 * r:2 * r + 2] != 0)
