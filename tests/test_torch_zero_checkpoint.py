"""ZeRO checkpoints across dp widths, stages and both packages, on the CPU.

A tag holds whole leaves whatever wrote it (the port gathers its shards and
rank 0 writes; JAX's resilient writer writes whole arrays), so:

- the port's dp-2 stage-3 resilient tag loads into JAX's single-device
  engine and into the port alone (no process group), and JAX's dp-2
  stage-3 tag loads into the port at dp 2: the next step's loss agrees
  with the unbroken run's within 1e-5 (relative);
- the port's torch-native tag of a dp-2 stage-2 run loads into a dp-2
  stage-1 engine, the next loss within 1e-5 (the same package: in fact
  equal);
- ``zero_to_fp32`` on either of the port's tags equals the gathered master;
- ``save_16bit_model``'s npz has JAX's layout (keys, bf16 words beside
  their ``__bf16__`` tags) and JAX's values to one bf16 rounding of
  masters that agree within 1e-5.

The ranks run in one spawn of 2 (``tests/torch_dist.py``)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deepspeed_tpu_torch as dtt
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.parallel.topology import MeshSpec as JMeshSpec
from deepspeed_tpu.runtime.engine import DeepSpeedEngine as JEngine
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.utils import zero_to_fp32

from tests import torch_dist
from tests.test_torch_zero import CONFIG, _batches, _flat, _gpt2_params, _on_dp, _stage
from tests.torch_threads import one_torch_thread  # noqa: F401

NEXT = 1e-5
RES = {"resilience": {"enabled": True, "async_checkpoint": False}}
S3 = dict(_stage(CONFIG, 3), **RES)


def _next_batch():
    return _batches(1, 8, 9)[0]


@pytest.fixture(scope="module")
def run(tmp_path_factory, devices):
    """JAX's dp-2 stage-3 run and its tag, then the port's ranks (started:
    the tests compute their references while the ranks train)."""
    root = tmp_path_factory.mktemp("zckpt")
    params, batches, nxt = _gpt2_params(), _batches(3, 8, 3), _next_batch()
    mesh = JMeshSpec(dp=2, devices=devices[:2]).build_mesh()
    jeng = JEngine(jgpt2.make_module(jgpt2.get_config("gpt2-tiny")), dict(S3), mesh=mesh,
                   params=jax.tree.map(jnp.asarray, params), seed=0)
    for b in batches:
        jeng.train_batch(b)
    jeng.save_checkpoint(str(root / "jax"), tag="t")
    jeng.save_16bit_model(str(root / "jax16"))
    j_next = float(jeng.train_batch(nxt)["loss"])
    s2 = _stage(CONFIG, 2)
    cases = [
        ("save", "gpt2", S3, params, batches,
         {"save": str(root / "port"), "save_16bit": True, "next_batch": nxt}),
        ("load_jax", "gpt2", S3, params, [], {"load": str(root / "jax"), "next_batch": nxt}),
        ("save_native", "gpt2", s2, params, batches,
         {"save": str(root / "native"), "next_batch": nxt}),
        ("load_native_s1", "gpt2", s2, params, [],
         {"load": str(root / "native"), "next_batch": nxt,
          "load_conf": dict(_stage(CONFIG, 1), mesh={"dp": -1})}),
    ]
    ranks = torch_dist.start(2, "train", (_on_dp(cases),), root / "ranks")
    return {"root": root, "jax_next": j_next, "ranks": ranks, "params": params}


def test_jax_dp2_stage3_tag_loads_into_the_port_at_dp2(run):
    for r in run["ranks"]:
        got = r["load_jax"]["after_load"]
        assert abs(got - run["jax_next"]) <= NEXT * abs(run["jax_next"]), (got, run["jax_next"])


def test_port_dp2_stage3_tag_loads_into_jax_single_device(run, devices):
    mesh = JMeshSpec(dp=1, devices=devices[:1]).build_mesh()
    conf = dict(S3, zero_optimization={"stage": 0}, train_micro_batch_size_per_gpu=4)
    jeng = JEngine(jgpt2.make_module(jgpt2.get_config("gpt2-tiny")), conf, mesh=mesh,
                   params=jax.tree.map(jnp.asarray, run["params"]), seed=5)
    run["ranks"].results()  # the ranks write the tag: wait for them to end
    jeng.load_checkpoint(str(run["root"] / "port"), tag="t")
    got = float(jeng.train_batch(_next_batch())["loss"])
    want = run["ranks"][0]["save"]["next_loss"]
    assert abs(got - want) <= NEXT * abs(want), (got, want)


def test_port_dp2_stage3_tag_loads_into_the_port_alone(run):
    conf = dict(S3, zero_optimization={"stage": 0}, train_micro_batch_size_per_gpu=4)
    eng, *_ = dtt.initialize(model=tgpt2.make_module(tgpt2.get_config("gpt2-tiny")),
                             config=conf, device="cpu", seed=7)
    assert not eng.distributed
    run["ranks"].results()  # the ranks write the tag: wait for them to end
    eng.load_checkpoint(str(run["root"] / "port"), tag="t")
    master = _flat(run["ranks"][0]["save"]["master"])
    for name, t in _flat({k: v.numpy() for k, v in _flat_torch(eng.params).items()}).items():
        np.testing.assert_array_equal(t, master[name], err_msg=name)
    got = float(eng.train_batch(_next_batch())["loss"])
    want = run["ranks"][0]["save"]["next_loss"]
    assert abs(got - want) <= NEXT * abs(want), (got, want)


def _flat_torch(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_torch(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree.detach()}


def test_native_tag_crosses_stages(run):
    for r in run["ranks"]:
        want = r["save_native"]["next_loss"]
        got = r["load_native_s1"]["after_load"]
        assert abs(got - want) <= NEXT * abs(want), (got, want)
        for a, b in zip(_flat(r["load_native_s1"]["loaded_master"]).values(),
                        _flat(r["save_native"]["master"]).values()):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("tag_dir,case", [("port", "save"), ("native", "save_native")])
def test_zero_to_fp32_equals_the_gathered_master(run, tag_dir, case, tmp_path):
    want = _flat(run["ranks"][0][case]["master"])
    got = zero_to_fp32.get_fp32_state_dict_from_zero_checkpoint(str(run["root"] / tag_dir))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    out = zero_to_fp32.convert_zero_checkpoint_to_fp32_state_dict(
        str(run["root"] / tag_dir), str(tmp_path / "fp32.npz"), tag="t")
    with np.load(out) as z:
        assert sorted(z.files) == sorted(want)


def test_save_16bit_model_has_jax_layout(run):
    run["ranks"].results()
    with np.load(os.path.join(run["root"], "port", "pytorch_model.npz")) as t, \
            np.load(os.path.join(run["root"], "jax16", "pytorch_model.npz")) as j:
        assert sorted(t.files) == sorted(j.files)
        for k in j.files:
            assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape, k
            if k.startswith("__bf16__"):
                assert bool(t[k]) and bool(j[k])
                continue
            tv = (t[k].astype(np.uint32) << 16).view(np.float32)
            jv = (j[k].astype(np.uint32) << 16).view(np.float32)
            np.testing.assert_allclose(tv, jv, rtol=2.0 ** -7, atol=1e-5, err_msg=k)
