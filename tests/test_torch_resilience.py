"""The port's resilience plane on the CPU, held against the JAX package's
(``tests/unit/test_resilience.py`` is the oracle): the crc manifest round
trip bit for bit (bf16 included) with corrupt, truncated and torn tags;
the fault injector's schedules and sha256 chaos draws; the async writer;
tags crossing between ``DeepSpeedEngine`` and the port both ways bit for
bit; the state leaves under ``tree_flatten_with_path``'s names; resume,
walk-back, rollback and preemption; serving drain and retries.

gpt2-tiny on a one-device mesh, fp32, from the same numpy weights and
batches. Tolerances: a tag's arrays and a resumed run's losses within one
package are compared bit for bit; across the packages the continued
trajectories are held to 1e-5 (relative for losses, absolute for
parameters), the training parity tests' tolerance (the two packages sum in
different orders)."""

import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dtt
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.resilience import faults as jfaults
from deepspeed_tpu.resilience import manifest as jmf
from deepspeed_tpu.runtime.config import FaultInjectionConfig as JFaultConfig
from deepspeed_tpu.runtime.engine import DeepSpeedEngine as JEngine
from deepspeed_tpu.utils.pytree import path_str
from deepspeed_tpu_torch.elasticity.preemption import PreemptionGuard
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.resilience import (
    AsyncCheckpointWriter,
    CheckpointIntegrityError,
    FaultInjected,
    FaultInjector,
    RollbackLimitError,
    find_latest_valid,
    validate_tag,
    write_tag,
)
from deepspeed_tpu_torch.resilience import manifest as mf
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfigError, FaultInjectionConfig
from deepspeed_tpu_torch.serving import RequestStatus, ServingEngine
from deepspeed_tpu_torch.utils.weights import params_from_numpy
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5

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


@pytest.fixture(scope="module")
def tree():
    cfg = jgpt2.get_config("gpt2-tiny")
    return jax.tree.map(np.asarray, jgpt2.init_params(cfg, jax.random.PRNGKey(0)))


def _batches(n, rows=4, S=32, seed=3):
    rs = np.random.RandomState(seed)
    return [{"input_ids": rs.randint(0, 512, (rows, S)).astype(np.int32)} for _ in range(n)]


def _conf(resilience=None, watchdog=None, tmp_path=None, **extra):
    c = dict(CONFIG, **extra)
    if resilience is not None:
        c["resilience"] = {"enabled": True, **resilience}
    if watchdog is not None:
        c["telemetry"] = {"enabled": True, "trace_path": str(tmp_path / "telemetry"),
                          "watchdog": {"enabled": True, "warmup_steps": 100,
                                       "capture_dir": str(tmp_path / "anomalies"), **watchdog}}
    return c


def _teng(tree, conf, dropout=0.0):
    cfg = tgpt2.get_config("gpt2-tiny", dropout=dropout) if dropout else tgpt2.get_config("gpt2-tiny")
    eng, _, _, _ = dtt.initialize(model=tgpt2.make_module(cfg), config=dict(conf),
                                  model_parameters=params_from_numpy(tree, "cpu"), device="cpu")
    return eng


def _jeng(tree, conf, mesh, seed=0):
    cfg = jgpt2.get_config("gpt2-tiny")
    return JEngine(jgpt2.make_module(cfg), dict(conf), mesh=mesh,
                   params=jax.tree.map(jnp.asarray, tree), seed=seed)


def _host_state(eng):
    return {k: v.detach().clone() for k, v in eng.state_leaves().items()}


def _assert_state_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _corrupt_file(path, offset=0):
    with open(path, "r+b") as fh:
        fh.seek(offset)
        data = fh.read(4)
        fh.seek(offset)
        fh.write(bytes(b ^ 0xFF for b in data))


# ---------------------------------------------------------------------------
# the manifest format
# ---------------------------------------------------------------------------

def test_manifest_roundtrip_bit_identical_incl_bf16_both_packages(tmp_path):
    """The port writes numpy and torch arrays (bf16 as its words), reads
    them back bit for bit with their dtypes and 0-d shapes; JAX's
    ``load_arrays`` reads the port's tag, and the port reads JAX's."""
    b16 = torch.arange(8, dtype=torch.float32).mul(1.0 / 3).to(torch.bfloat16)
    arrays = {"a/w": np.arange(12, dtype=np.float32).reshape(3, 4), "a/b16": b16,
              "scalar": np.int32(7), "key": np.array([0, 42], np.uint32),
              "t32": torch.linspace(-1, 1, 6).reshape(2, 3)}
    d = write_tag(str(tmp_path / "p"), "t1", arrays, client_state={"k": 1}, step=5)
    assert validate_tag(d) == (True, "ok") and jmf.validate_tag(d) == (True, "ok")
    back = mf.load_arrays(d)
    assert list(back) == list(arrays)
    for name, arr in arrays.items():
        want = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.asarray(arr))
        assert back[name].dtype == want.dtype and back[name].shape == want.shape, name
        assert torch.equal(back[name], want), name
    assert back["scalar"].shape == ()
    jback = jmf.load_arrays(d)
    assert jback["a/b16"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(jback["a/b16"].view(np.uint16),
                                  b16.view(torch.int16).numpy().view(np.uint16))
    np.testing.assert_array_equal(jback["key"], arrays["key"])
    m = mf.read_manifest(d)
    assert m["client_state"] == {"k": 1} and m["step"] == 5 and m["format"] == jmf.FORMAT
    # the other way: JAX's ml_dtypes bf16 into the port, word for word
    jarrays = {"b": np.asarray(jnp.arange(5, dtype=jnp.bfloat16) / 7),
               "s": np.float32(2.5)}
    dj = jmf.write_tag(str(tmp_path / "j"), "t", jarrays)
    got = mf.load_arrays(dj)
    assert got["b"].dtype == torch.bfloat16 and got["s"].shape == ()
    np.testing.assert_array_equal(got["b"].view(torch.int16).numpy().view(np.uint16),
                                  np.asarray(jarrays["b"]).view(np.uint16))


def test_latest_is_atomic_and_points_at_tag(tmp_path):
    write_tag(str(tmp_path), "t1", {"a": np.zeros(2, np.float32)})
    write_tag(str(tmp_path), "t2", {"a": np.ones(2, np.float32)})
    assert mf.read_latest_tag(str(tmp_path)) == "t2" == jmf.read_latest_tag(str(tmp_path))
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]


def test_corrupt_truncated_and_torn_tags(tmp_path):
    """A flipped word fails the crc and the walk-back skips the tag; a cut
    file is a truncated write; a crash before the manifest leaves only
    ``<tag>.tmp``, which is never a candidate; an explicitly asked bad tag
    raises, as does a directory with none good (JAX's reasons)."""
    base = str(tmp_path / "c")
    write_tag(base, "t1", {"a": np.zeros(64, np.float32)}, step=1)
    d2 = write_tag(base, "t2", {"a": np.ones(64, np.float32)}, step=2)
    _corrupt_file(os.path.join(d2, "00000.bin"), offset=16)
    ok, why = validate_tag(d2)
    assert not ok and "crc32" in why and jmf.validate_tag(d2) == (ok, why)
    tag, skipped = find_latest_valid(base)
    assert tag == "t1" and [s["tag"] for s in skipped] == ["t2"]
    assert jmf.find_latest_valid(base) == (tag, skipped)

    d = write_tag(str(tmp_path / "tr"), "t1", {"a": np.zeros(64, np.float32)})
    with open(os.path.join(d, "00000.bin"), "r+b") as fh:
        fh.truncate(100)
    ok, why = validate_tag(d)
    assert not ok and "truncated" in why

    torn = str(tmp_path / "torn")
    write_tag(torn, "good", {"a": np.zeros(4, np.float32)}, step=1)
    with pytest.raises(FaultInjected):
        write_tag(torn, "torn", {"a": np.ones(4, np.float32)}, step=2,
                  crash_before_manifest=True)
    assert os.path.isdir(os.path.join(torn, "torn.tmp"))
    assert not os.path.isdir(os.path.join(torn, "torn"))
    assert find_latest_valid(torn) == ("good", [])

    os.remove(os.path.join(d, mf.MANIFEST))
    with pytest.raises(CheckpointIntegrityError, match="t1"):
        find_latest_valid(str(tmp_path / "tr"), tag="t1")
    with pytest.raises(CheckpointIntegrityError, match="no valid"):
        find_latest_valid(str(tmp_path / "empty"))


# ---------------------------------------------------------------------------
# the fault injector and the async writer
# ---------------------------------------------------------------------------

def test_fault_injector_schedules_equal_jax():
    kw = dict(enabled=True, nan_loss_steps=[2, 5], crash_saves=[1], sigterm_steps=[3],
              stall_requests=[1, 4])
    t, j = FaultInjector(FaultInjectionConfig(**kw)), jfaults.FaultInjector(JFaultConfig(**kw))
    for site in jfaults.SITES:
        assert [t.fire(site, i) for i in range(1, 8)] == [j.fire(site, i) for i in range(1, 8)]
    assert t.counts() == j.counts() == {"nan_loss": 2, "sigterm": 1, "checkpoint_crash": 1,
                                        "serving_stall": 2}
    with pytest.raises(ValueError, match="unknown fault site"):
        t.fire("disk_full", 1)
    with pytest.raises(DeepSpeedConfigError):
        FaultInjectionConfig(probability=1.5)


@pytest.mark.parametrize("seed,p", [(7, 0.3), (0, 0.05), (123456, 0.9)])
def test_chaos_draws_fire_on_jax_pairs(seed, p):
    """The sha256 chaos draw fires on the same (site, index) pairs as
    JAX's for the seed, and differs for another seed."""
    t = FaultInjector(FaultInjectionConfig(enabled=True, seed=seed, probability=p))
    j = jfaults.FaultInjector(JFaultConfig(enabled=True, seed=seed, probability=p))
    for site in jfaults.SITES:
        pattern = [t.fire(site, i) for i in range(200)]
        assert pattern == [j.fire(site, i) for i in range(200)], site
        assert any(pattern) and not all(pattern)
    other = FaultInjector(FaultInjectionConfig(enabled=True, seed=seed + 1, probability=p))
    assert [other.fire("nan_loss", i) for i in range(200)] != \
        [t.fire("nan_loss", i) for i in range(200)]


def test_deliver_sigterm_needs_a_handler():
    inj = FaultInjector(FaultInjectionConfig(enabled=True))
    prev = signal.signal(signal.SIGTERM, signal.SIG_DFL)
    try:
        assert inj.deliver_sigterm() is False  # no handler: nothing delivered
        with PreemptionGuard() as g:
            assert inj.deliver_sigterm() is True and g.should_stop()
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_async_writer_commit_crash_and_blocking(tmp_path):
    w = AsyncCheckpointWriter(str(tmp_path / "a"))
    w.save("t1", {"a": np.arange(4, dtype=np.float32)}, step=1)
    assert w.wait(timeout=10) and validate_tag(str(tmp_path / "a" / "t1"))[0]
    assert w.last_error is None and w.saves_committed == 1 and w.close(timeout=5)

    inj = FaultInjector(FaultInjectionConfig(enabled=True, crash_saves=[2]))
    w = AsyncCheckpointWriter(str(tmp_path / "b"), injector=inj)
    w.save("t1", {"a": np.zeros(8, np.float32)}, step=1)
    w.save("t2", {"a": torch.ones(8)}, step=2)
    assert w.wait(timeout=10)  # the failed job drains too
    assert isinstance(w.last_error, FaultInjected)
    assert mf.read_latest_tag(str(tmp_path / "b")) == "t1"
    assert find_latest_valid(str(tmp_path / "b"))[0] == "t1"
    assert os.path.isdir(str(tmp_path / "b" / "t2.tmp"))
    w.close()

    inj = FaultInjector(FaultInjectionConfig(enabled=True, crash_saves=[1]))
    w = AsyncCheckpointWriter(str(tmp_path / "c"), injector=inj)
    with pytest.raises(FaultInjected):
        w.save("t1", {"a": np.zeros(2, np.float32)}, blocking=True)
    assert isinstance(w.last_error, FaultInjected)


# ---------------------------------------------------------------------------
# the engine: leaf names, tags across the packages, resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opt,extra", [
    ("AdamW", {"weight_decay": 0.1}), ("Adam", {"weight_decay": 0.1, "adam_w_mode": False}),
    ("Adam", {}), ("Lamb", {"weight_decay": 0.01}), ("Adagrad", {}),
    ("SGD", {"momentum": 0.9}), ("SGD", {}),
])
def test_state_leaf_names_equal_tree_flatten_with_path(tree, mesh_single, opt, extra):
    conf = {"train_micro_batch_size_per_gpu": 2, "fp16": {"enabled": opt == "AdamW"},
            "optimizer": {"type": opt, "params": {"lr": 1e-3, **extra}}}
    je = _jeng(tree, conf, mesh_single)
    flat, _ = jax.tree_util.tree_flatten_with_path(je.state)
    want = [(path_str(p), tuple(x.shape), str(x.dtype)) for p, x in flat]
    got = [(k, tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in _teng(tree, conf).state_leaves().items()]
    assert got == want


def _check_equal_to_jax_state(je, te):
    flat, _ = jax.tree_util.tree_flatten_with_path(je.state)
    leaves = te.state_leaves()
    for p, x in flat:
        name = path_str(p)
        np.testing.assert_array_equal(leaves[name].numpy(), np.asarray(x), err_msg=name)


def test_jax_tag_loads_into_port_bit_for_bit(tree, mesh_single, tmp_path):
    """A tag written by DeepSpeedEngine loads into the port bit for bit,
    into the very tensors the port's programs read, with the engine key and
    the step counts; both continue on the same trajectory (1e-5)."""
    conf = _conf({"async_checkpoint": False})
    batches = _batches(4)
    je = _jeng(tree, conf, mesh_single)
    for b in batches[:2]:
        je.train_batch(b)
    je.save_checkpoint(str(tmp_path), tag="j2")
    te = _teng(tree, conf)
    ptrs = {k: v.data_ptr() for k, v in te.state_leaves().items()}
    te.load_checkpoint(str(tmp_path))
    assert {k: v.data_ptr() for k, v in te.state_leaves().items()} == ptrs
    _check_equal_to_jax_state(je, te)
    assert te.global_steps == je.global_steps == 2 and te.get_global_step() == 2
    np.testing.assert_array_equal(te._rng, np.asarray(je._rng))
    for b in batches[2:]:
        lj, lt = float(je.train_batch(b)["loss"]), float(te.train_batch(b)["loss"])
        assert abs(lt - lj) <= TOL * abs(lj)
    flat, _ = jax.tree_util.tree_flatten_with_path(je.state.params)
    leaves = te.state_leaves()
    for p, x in flat:
        name = "params/" + path_str(p)
        np.testing.assert_allclose(leaves[name].numpy(), np.asarray(x), atol=TOL, rtol=0)


def test_port_tag_loads_into_jax_bit_for_bit(tree, mesh_single, tmp_path):
    """A tag written by the port (async) validates with JAX's
    ``validate_tag`` and loads into DeepSpeedEngine bit for bit; both
    continue on the same trajectory (1e-5)."""
    conf = _conf({})
    batches = _batches(4)
    te = _teng(tree, conf)
    for b in batches[:2]:
        te.train_batch(b)
    te.save_checkpoint(str(tmp_path))
    assert te.flush_checkpoints(timeout=30)
    d = os.path.join(str(tmp_path), "global_step2")
    assert jmf.validate_tag(d) == (True, "ok")
    m = jmf.read_manifest(d)
    assert "__rng__" in m["arrays"] and m["client_state"]["global_steps"] == 2
    assert m["fingerprint"] == te._config_fingerprint()
    je = _jeng(tree, conf, mesh_single, seed=9)
    je.load_checkpoint(str(tmp_path))
    _check_equal_to_jax_state(je, te)
    assert je.global_steps == 2
    for b in batches[2:]:
        lj, lt = float(je.train_batch(b)["loss"]), float(te.train_batch(b)["loss"])
        assert abs(lt - lj) <= TOL * abs(lj)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_resume_is_bit_identical_and_trains_the_loaded_tensors(tree, tmp_path, dropout):
    """Save at step 2 (async), load into a fresh engine: the loaded values
    sit in the tensors the programs read (a rebind would leave them on the
    old ones), and steps 3-4 equal the uninterrupted run bit for bit
    (dropout 0.1 included: the restored step count folds the keys) and an
    engine built fresh from the loaded values."""
    conf = _conf({})
    batches = _batches(4, seed=5)
    e1 = _teng(tree, conf, dropout)
    for b in batches[:2]:
        e1.train_batch(b)
    e1.save_checkpoint(str(tmp_path), tag="s2")
    assert e1.flush_checkpoints(timeout=30)
    saved = _host_state(e1)
    e2 = _teng(tree, dict(conf, scheduler=CONFIG["scheduler"]), dropout)
    e2.train_batch(batches[3])  # build (and run) its program before the load
    held = {k: v for k, v in e2.state_leaves().items()}
    e2.load_checkpoint(str(tmp_path), tag="s2")
    for k, v in e2.state_leaves().items():
        assert v is held[k], k
    _assert_state_equal(_host_state(e2), saved)
    # a fresh engine built from the loaded values
    fresh = _teng(tree, conf, dropout)
    fresh.load_checkpoint(str(tmp_path), tag="s2")
    l1 = [float(e1.train_batch(b)["loss"]) for b in batches[2:]]
    l2 = [float(e2.train_batch(b)["loss"]) for b in batches[2:]]
    l3 = [float(fresh.train_batch(b)["loss"]) for b in batches[2:]]
    assert l1 == l2 == l3
    _assert_state_equal(_host_state(e1), _host_state(e2))


def test_crash_walk_back_and_partial_loads(tree, tmp_path):
    """``crash_saves`` leaves the previous tag loadable; a corrupted newest
    tag walks back; ``load_optimizer_states=False`` keeps the engine's own
    optimizer state; a missing leaf and a retyped leaf raise."""
    d = str(tmp_path / "ck")
    batches = _batches(2)
    e = _teng(tree, _conf({"fault_injection": {"enabled": True, "crash_saves": [2]}}))
    e.train_batch(batches[0])
    after1 = _host_state(e)
    e.save_checkpoint(d, tag="s1")
    e.train_batch(batches[1])
    e.save_checkpoint(d, tag="s2")
    assert e.flush_checkpoints(timeout=30)
    writer = next(iter(e._ckpt_writers.values()))
    assert isinstance(writer.last_error, FaultInjected)
    assert os.path.isdir(os.path.join(d, "s2.tmp")) and not os.path.isdir(os.path.join(d, "s2"))
    e2 = _teng(tree, _conf({}))
    e2.load_checkpoint(d)
    assert e2.get_global_step() == 1
    _assert_state_equal(_host_state(e2), after1)

    d2 = str(tmp_path / "wb")
    e3 = _teng(tree, _conf({"async_checkpoint": False}))
    e3.train_batch(batches[0])
    e3.save_checkpoint(d2, tag="t1")
    e3.train_batch(batches[1])
    e3.save_checkpoint(d2, tag="t2")
    _corrupt_file(os.path.join(d2, "t2", "00000.bin"))
    e4 = _teng(tree, _conf({}))
    e4.load_checkpoint(d2)
    assert e4.get_global_step() == 1 and e4.global_steps == 1

    e5 = _teng(tree, _conf({}))
    fresh_opt = {k: v.clone() for k, v in e5.state_leaves().items() if k.startswith("opt_state")}
    e5.load_checkpoint(d2, tag="t1", load_optimizer_states=False)
    for k, v in e5.state_leaves().items():
        if k.startswith("opt_state"):
            assert torch.equal(v, fresh_opt[k]), k
        elif k.startswith("params"):
            assert torch.equal(v, after1[k]), k

    arrays = mf.load_arrays(os.path.join(d2, "t1"))
    del arrays["params/wte"]
    write_tag(str(tmp_path / "miss"), "m", arrays)
    with pytest.raises(KeyError, match="params/wte"):
        _teng(tree, _conf({})).load_checkpoint(str(tmp_path / "miss"))
    arrays["params/wte"] = np.zeros((512, 64), np.float64)
    write_tag(str(tmp_path / "dt"), "m", arrays)
    with pytest.raises(ValueError, match="dtype"):
        _teng(tree, _conf({})).load_checkpoint(str(tmp_path / "dt"))


def test_non_resilient_checkpoint_roundtrip(tree, tmp_path):
    """Without the section the state goes to the torch-native file under
    JAX's layout (``<tag>/state``, ``client_state.json``, atomic
    ``latest``), and loads back in place."""
    from deepspeed_tpu_torch.checkpoint import read_latest_tag

    d = str(tmp_path)
    batches = _batches(3)
    e = _teng(tree, CONFIG)
    e.train_batch(batches[0])
    e.save_checkpoint(d, tag="a", client_state={"epoch": 3})
    e.save_checkpoint(d, tag="b")
    assert read_latest_tag(d) == "b" and not [f for f in os.listdir(d) if ".tmp" in f]
    assert os.path.isdir(os.path.join(d, "a", "state"))
    e2 = _teng(tree, CONFIG)
    held = e2.state_leaves()
    _, client = e2.load_checkpoint(d, tag="a")
    assert client["epoch"] == 3 and client["global_steps"] == 1
    assert all(v is held[k] for k, v in e2.state_leaves().items())
    _assert_state_equal(_host_state(e2), _host_state(e))
    assert float(e.train_batch(batches[1])["loss"]) == float(e2.train_batch(batches[1])["loss"])


# ---------------------------------------------------------------------------
# rollback
# ---------------------------------------------------------------------------

def test_nan_rollback_equals_clean_run_minus_poisoned_batch(tree, mesh_single, tmp_path):
    """``nan_loss`` at the 2nd call under the watchdog's rollback: the run
    equals the clean run without the poisoned batch bit for bit (and the
    JAX engine's rollback run within 1e-5), the restore lands in the
    program's tensors, and the counters read one rollback."""
    batches = _batches(4, seed=11)
    res = {"snapshot_every": 1, "fault_injection": {"enabled": True, "nan_loss_steps": [2]}}
    conf = _conf(res, {"policy": "rollback"}, tmp_path)
    e1 = _teng(tree, conf)
    held = e1.state_leaves()
    out = [e1.train_batch(b) for b in batches]
    assert out[1].get("rolled_back") is True and np.isnan(out[1]["loss"])
    assert all(v is held[k] for k, v in e1.state_leaves().items())
    e2 = _teng(tree, _conf({"snapshot_every": 1}, {"policy": "rollback"}, tmp_path / "c"))
    clean = [e2.train_batch(b) for b in (batches[0], batches[2], batches[3])]
    assert [float(out[i]["loss"]) for i in (0, 2, 3)] == [float(m["loss"]) for m in clean]
    _assert_state_equal(_host_state(e1), _host_state(e2))
    assert e1.get_global_step() == 3 and e1.global_steps == 3
    assert e1.telemetry.registry.get("rolled_back_steps_total").value() == 1.0

    je = _jeng(tree, _conf(res, {"policy": "rollback"}, tmp_path / "j"), mesh_single)
    jout = [je.train_batch(b) for b in batches]
    assert jout[1].get("rolled_back") is True
    for i in (0, 2, 3):
        lj = float(np.asarray(jout[i]["loss"]))
        assert abs(float(out[i]["loss"]) - lj) <= TOL * abs(lj)


def test_rollback_off_cadence_limit_and_requirements(tree, tmp_path):
    batches = _batches(3)
    e = _teng(tree, _conf({"fault_injection": {"enabled": True, "nan_loss_steps": [2]}},
                          {"policy": "rollback", "check_every": 2}, tmp_path))
    e.train_batch(batches[0])
    m = e.train_batch(batches[1])  # the 2nd call: off the check cadence
    assert m.get("rolled_back") is True and e.get_global_step() == 1

    e = _teng(tree, _conf({"max_rollbacks": 1, "fault_injection": {
        "enabled": True, "nan_loss_steps": [2, 3]}}, {"policy": "rollback"}, tmp_path / "l"))
    e.train_batch(batches[0])
    e.train_batch(batches[1])  # rollback 1/1
    with pytest.raises(RollbackLimitError):
        e.train_batch(batches[2])

    with pytest.raises(ValueError, match="rollback"):
        _teng(tree, dict(CONFIG, telemetry={
            "enabled": True, "trace_path": str(tmp_path / "t"),
            "watchdog": {"enabled": True, "policy": "rollback"}}))


# ---------------------------------------------------------------------------
# preemption
# ---------------------------------------------------------------------------

def test_guard_restores_handlers_and_double_sigterm_escalates():
    before = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard() as g:
        assert signal.getsignal(signal.SIGTERM) != before and not g.should_stop()
    assert signal.getsignal(signal.SIGTERM) == before
    exits = []
    with PreemptionGuard() as g:
        g._exit = exits.append
        signal.raise_signal(signal.SIGTERM)
        assert g.should_stop() and exits == []
        signal.raise_signal(signal.SIGTERM)  # outside the final save: no escalation
        assert exits == []
        g._in_final_save = True
        signal.raise_signal(signal.SIGTERM)
    assert exits == [128 + int(signal.SIGTERM)]


def test_sigterm_injection_checkpoints_and_resumes(tree, tmp_path):
    d = str(tmp_path / "ck")
    batches = _batches(4)
    e = _teng(tree, _conf({"fault_injection": {"enabled": True, "sigterm_steps": [2]}}))
    with PreemptionGuard(e, d) as guard:
        stopped_at = None
        for i, b in enumerate(batches):
            e.train_batch(b)
            if guard.should_stop():
                guard.checkpoint_and_log()
                stopped_at = i
                break
        assert stopped_at == 1 and e.preempted
    e2 = _teng(tree, _conf({}))
    e2.load_checkpoint(d)
    assert e2.get_global_step() == 2
    _assert_state_equal(_host_state(e), _host_state(e2))
    assert [float(e.train_batch(b)["loss"]) for b in batches[2:]] == \
        [float(e2.train_batch(b)["loss"]) for b in batches[2:]]


def test_failed_or_overrun_async_write_forces_blocking_snapshot(tree, tmp_path, monkeypatch):
    d = str(tmp_path / "ck")
    e = _teng(tree, _conf({"fault_injection": {"enabled": True, "crash_saves": [1]}}))
    e.train_batch(_batches(1)[0])
    with PreemptionGuard(e, d) as guard:
        guard.request_stop()
        path = guard.checkpoint_and_log()  # the async save (ordinal 1) dies
    assert path.endswith("-final") and validate_tag(path)[0]
    assert find_latest_valid(d)[0].endswith("-final")

    d = str(tmp_path / "ov")
    e = _teng(tree, _conf({}))
    e.train_batch(_batches(1)[0])
    monkeypatch.setattr(e, "flush_checkpoints", lambda timeout=None: False)
    with PreemptionGuard(e, d, grace_window_s=0.01) as guard:
        guard.request_stop()
        path = guard.checkpoint_and_log()
    assert path.endswith("preempt-final") and validate_tag(path)[0]
    assert find_latest_valid(d)[0] == "preempt-final"


def test_async_write_landing_after_the_blocking_final_keeps_latest(tree, tmp_path,
                                                                     monkeypatch):
    """The overrun branch with the race forced: the async write of
    ``global_step1`` (job 1) waits on an event until the guard's blocking
    ``preempt-final`` (job 2) has committed, then lands. ``latest`` stays on
    job 2's tag, and job 1's tag is committed and valid beside it."""
    import threading

    d = str(tmp_path / "race")
    e = _teng(tree, _conf({}))
    e.train_batch(_batches(1)[0])
    writer = e._checkpoint_writer(d)
    gate = threading.Event()
    write = writer._write

    def gated(*job):
        if threading.current_thread() is not threading.main_thread():
            assert gate.wait(30.0)
        return write(*job)

    monkeypatch.setattr(writer, "_write", gated)
    monkeypatch.setattr(e, "flush_checkpoints", lambda timeout=None: False)
    with PreemptionGuard(e, d, grace_window_s=0.01) as guard:
        guard.request_stop()
        path = guard.checkpoint_and_log()
    assert path.endswith("preempt-final")
    assert not os.path.isdir(os.path.join(d, "global_step1"))  # job 1 still queued
    gate.set()
    assert writer.wait(30.0)
    assert validate_tag(os.path.join(d, "global_step1"))[0]
    assert open(os.path.join(d, mf.LATEST_FILE)).read() == "preempt-final"
    assert find_latest_valid(d)[0] == "preempt-final"


def test_latest_swap_is_monotone_in_job_order(tmp_path):
    """The writer alone: a job saved earlier and committed later leaves
    ``latest`` alone; a later job whose write dies never swaps it, and the
    walk-back then finds the older good tag."""
    d = str(tmp_path / "mono")
    w = AsyncCheckpointWriter(d)
    arrays = {"x": np.arange(4, dtype=np.float32)}
    w._write("a", arrays, {}, 1, True, 2)
    w._write("b", arrays, {}, 0, True, 1)  # job 1 lands after job 2
    assert open(os.path.join(d, mf.LATEST_FILE)).read() == "a"
    assert validate_tag(os.path.join(d, "b"))[0]
    d2 = str(tmp_path / "dies")
    inj = FaultInjector(FaultInjectionConfig(enabled=True, crash_saves=[2]))
    w2 = AsyncCheckpointWriter(d2, injector=inj)
    w2.save("old", arrays)                       # job 1 (async) commits
    with pytest.raises(FaultInjected):
        w2.save("new", arrays, blocking=True)    # job 2 dies before its manifest
    assert w2.wait(30.0)
    assert find_latest_valid(d2)[0] == "old"


# ---------------------------------------------------------------------------
# serving: drain and retries under injected faults
# ---------------------------------------------------------------------------

SERVING_CFG = {"max_slots": 4, "page_size": 4, "num_pages": 64, "max_prompt_len": 12,
               "max_new_tokens": 8, "kv_cache_dtype": "float32"}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def engines(tree):
    from deepspeed_tpu.inference.engine import InferenceEngine

    cfg = jgpt2.get_config("gpt2-tiny", attn_impl="jnp")
    jeng = InferenceEngine(jgpt2.make_module(cfg), params=jax.tree.map(jnp.asarray, tree),
                           dtype=jnp.float32)
    teng = dtt.init_inference(dtt.get_config("gpt2-tiny"), params=params_from_numpy(tree, "cpu"),
                              dtype=torch.float32, device="cpu")
    return jeng, teng


def _prompt(rs, n=6):
    return rs.randint(0, 512, (n,)).astype(np.int32)


def _drive(srv, r, clk):
    for _ in range(64):
        if r.done:
            break
        srv.step()
        clk.t += 0.06  # march time through the backoff window


def test_stall_retries_with_backoff_as_jax(engines):
    """An injected stall at the 1st admission with ``retry_max`` 2: the
    request is evicted mid-decode, re-queued behind its backoff, and
    finishes with the clean stream, as the JAX engine's does."""
    from deepspeed_tpu.serving import ServingEngine as JServingEngine

    jeng, teng = engines
    p = _prompt(np.random.RandomState(3))
    ref = ServingEngine(teng, SERVING_CFG, clock=FakeClock())
    want = ref.submit(p, max_new_tokens=6, seed=9)
    ref.run()
    out = {}
    for name, cls, eng, cfg_cls in (("torch", ServingEngine, teng, FaultInjectionConfig),
                                    ("jax", JServingEngine, jeng, JFaultConfig)):
        inj_cls = FaultInjector if name == "torch" else jfaults.FaultInjector
        clk = FakeClock()
        srv = cls(eng, {**SERVING_CFG, "retry_max": 2, "retry_backoff_s": 0.1}, clock=clk,
                  fault_injector=inj_cls(cfg_cls(enabled=True, stall_requests=[1])))
        r = srv.submit(p, max_new_tokens=6, seed=9)
        _drive(srv, r, clk)
        out[name] = (r.status, r.retries, list(r.tokens), srv.stats()["retried"])
        srv.check_no_leaks()
    assert out["torch"] == out["jax"] == (RequestStatus.FINISHED, 1, list(want.tokens), 1)


def test_retry_budget_spent_or_disabled_fails(engines):
    _, teng = engines
    rs = np.random.RandomState(4)
    clk = FakeClock()
    srv = ServingEngine(teng, {**SERVING_CFG, "retry_max": 1, "retry_backoff_s": 0.1},
                        clock=clk, fault_injector=FaultInjector(FaultInjectionConfig(
                            enabled=True, stall_requests=[1, 2])))
    r = srv.submit(_prompt(rs), max_new_tokens=6)
    _drive(srv, r, clk)
    assert r.status == RequestStatus.FAILED and r.retries == 1 and "budget" in r.detail
    srv.check_no_leaks()
    srv = ServingEngine(teng, SERVING_CFG, clock=FakeClock(), fault_injector=FaultInjector(
        FaultInjectionConfig(enabled=True, stall_requests=[1])))
    r = srv.submit(_prompt(rs), max_new_tokens=6)
    assert r in srv.run() and r.status == RequestStatus.FAILED and r.retries == 0
    srv.check_no_leaks()


def test_sigterm_under_load_drains_without_wedged_slots(engines):
    _, teng = engines
    srv = ServingEngine(teng, SERVING_CFG, clock=FakeClock())
    rs = np.random.RandomState(2)
    reqs = [srv.submit(_prompt(rs), max_new_tokens=6) for _ in range(5)]
    with PreemptionGuard() as guard:
        steps = 0
        while srv.queue or any(s.request is not None for s in srv.slots):
            srv.step()
            steps += 1
            if steps == 2:
                signal.raise_signal(signal.SIGTERM)
            if guard.should_stop():
                srv.drain(deadline_s=30.0)
                break
    assert all(r.done for r in reqs) and all(s.request is None for s in srv.slots)
    assert {r.status for r in reqs} <= {RequestStatus.FINISHED, RequestStatus.PREEMPTED}
    srv.check_no_leaks()
