"""The training step's compiled-program contract on the CPU: what the step
reads lives on the device, and the step reads nothing on the host.

- the five LR schedules' tensor forms (an int32 count → an f32 scalar)
  against JAX's schedules evaluated under ``jax.jit`` on an int32 count, as
  optax calls them inside the step: 1e-6 relative (``log`` and ``cos`` may
  round the last bit apart; the linear forms agree exactly);
- ``loss_scaler.update`` on device flags against JAX's transition, exactly;
- the fused Adam and LAMB plain versions on the device block, with a
  skipped step between updates, against optax (1e-6 / 3e-5 relative as
  ``tests/test_torch_fused_adam.py``), and the skipped step bit for bit;
- GPT-2's dropout key table against the JAX model's own derivation, bit
  for bit, and the masks drawn from its device rows equal to the host
  keys' bit for bit;
- the engine: one training program per batch signature
  (``jit_step_cache_size``), an eval program of its own, metrics as 0-d
  tensors, no host read in a step (``tests/test_torch_captured_programs.py``'s
  guard around the programs' step functions) for every optimizer family,
  fp16 loss scaling, dropout, remat and the block-sparse path, host reads
  only at the print cadence, an overflow step that leaves the state bit for
  bit; ``InferenceEngine.forward`` one program an input shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import deepspeed_tpu_torch as dtt
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.runtime import lr_schedules as jlr
from deepspeed_tpu.runtime.fp16 import loss_scaler as jls
from deepspeed_tpu_torch.models import bert as tbert
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops import dropout as tdo
from deepspeed_tpu_torch.ops import fused_adam as tfa
from deepspeed_tpu_torch.ops import prng
from deepspeed_tpu_torch.runtime import lr_schedules as tlr
from deepspeed_tpu_torch.runtime.fp16 import loss_scaler as tls
from deepspeed_tpu_torch.utils.weights import params_from_numpy, params_to_numpy, tree_leaves

from .test_torch_captured_programs import _CountHostReads, no_host_traffic

SCHEDULES = {
    "LRRangeTest": {"lr_range_test_min_lr": 1e-4, "lr_range_test_step_size": 7,
                    "lr_range_test_step_rate": 0.5, "lr_range_test_staircase": True},
    "OneCycle": {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-2, "cycle_first_step_size": 5,
                 "cycle_second_step_size": 7, "decay_lr_rate": 0.3, "decay_step_size": 3},
    "WarmupLR": {"warmup_min_lr": 1e-5, "warmup_max_lr": 3e-3, "warmup_num_steps": 9},
    "WarmupDecayLR": {"total_num_steps": 25, "warmup_min_lr": 0.0, "warmup_max_lr": 1e-3,
                      "warmup_num_steps": 6, "warmup_type": "linear"},
    "CosineAnnealing": {"total_num_steps": 30, "warmup_num_steps": 4, "warmup_max_lr": 2e-3,
                        "cosine_min_ratio": 0.1},
    None: {},
}


@pytest.mark.parametrize("name", list(SCHEDULES), ids=str)
def test_lr_tensor_forms_match_jax_in_the_step(name):
    ours = tlr.get_lr_schedule(name, SCHEDULES[name], fallback_lr=4e-4)
    theirs = jax.jit(jlr.get_lr_schedule(name, SCHEDULES[name], fallback_lr=4e-4))
    form = tlr.tensor_form(ours)
    for count in range(33):
        got = form(torch.tensor(count, dtype=torch.int32))
        want = np.float32(theirs(jnp.int32(count)))
        assert got.dtype == torch.float32 and got.dim() == 0
        assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want)) + 1e-12, (count, got,
                                                                                   want)
        assert float(got) == pytest.approx(ours(count), rel=1e-6, abs=1e-12)


def test_tensor_form_of_numbers_and_plain_callables():
    c = torch.tensor(3, dtype=torch.int32)
    assert float(tlr.tensor_form(2e-3)(c)) == np.float32(2e-3)
    form = tlr.tensor_form(lambda count: 1e-2 * (count + 1) / 4)  # tensor ops on the count
    assert float(form(c)) == pytest.approx(1e-2, rel=1e-6) and form(c).dtype == torch.float32


@pytest.mark.parametrize("dynamic,hysteresis,window", [(True, 2, 3), (True, 1, 2), (False, 2, 3)])
def test_loss_scaler_update_on_device_flags_matches_jax(dynamic, hysteresis, window):
    flags = [True, True, False, True, False, False, False, True, True, True, False, False]
    js = jls.create(dynamic=dynamic, initial_scale_power=5, hysteresis=hysteresis,
                    static_loss_scale=128.0)
    ts = tls.create(dynamic=dynamic, initial_scale_power=5, hysteresis=hysteresis,
                    static_loss_scale=128.0)
    assert ts.cur_scale.dtype == torch.float32 and ts.iteration.dtype == torch.int32
    for ov in flags:
        js = jls.update(js, jnp.bool_(ov), dynamic=dynamic, scale_window=window, min_scale=2.0)
        new = tls.update(ts, torch.tensor(ov), dynamic=dynamic, scale_window=window,
                         min_scale=2.0)
        tls.assign(ts, new)  # in place, as the captured step does
        for f in ("cur_scale", "cur_hysteresis", "last_overflow_iter", "iteration"):
            assert float(getattr(ts, f)) == float(getattr(js, f)), (f, ov)


def _tree(seed):
    rs = np.random.RandomState(seed)
    return {"a": rs.randn(6, 5).astype(np.float32), "b": rs.randn(5).astype(np.float32),
            "c": rs.randn(2, 3, 4).astype(np.float32)}


@pytest.mark.parametrize("kind", ["adam-decoupled", "adam-l2", "adam-none", "lamb"])
def test_fused_plain_versions_on_the_device_block_skip_a_step(kind):
    """Four calls, the second skipped: p, m and v unchanged by it bit for
    bit, and the three applied updates (the count not advanced by the skip)
    equal to optax's three."""
    params = _tree(1)
    names = sorted(params)
    jp = jax.tree.map(jnp.asarray, params)
    mask = lambda tree: jax.tree.map(lambda x: x.ndim >= 2, tree)  # noqa: E731
    if kind == "lamb":
        tx = optax.lamb(1e-2, b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.05)
        wds, fn, extra = [0.05] * 3, tfa.multi_tensor_lamb_, {}
    else:
        mode = kind.split("-")[1]
        tx = {"decoupled": optax.adamw(1e-2, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                                       mask=mask),
              "l2": optax.chain(optax.add_decayed_weights(0.1, mask=mask),
                                optax.adam(1e-2, b1=0.9, b2=0.95, eps=1e-8)),
              "none": optax.adam(1e-2, b1=0.9, b2=0.95, eps=1e-8)}[mode]
        wds = [0.1 if params[k].ndim >= 2 else 0.0 for k in names]
        fn, extra = tfa.multi_tensor_adam_, {"mode": mode}
    betas, eps = ((0.9, 0.999), 1e-6) if kind == "lamb" else ((0.9, 0.95), 1e-8)
    st = tx.init(jp)
    tp = [torch.from_numpy(params[k].copy()) for k in names]
    mus, nus = [torch.zeros_like(x) for x in tp], [torch.zeros_like(x) for x in tp]
    count = torch.zeros((), dtype=torch.int32)
    lr = torch.tensor(1e-2, dtype=torch.float32)
    rs = np.random.RandomState(5)
    for call in range(4):
        grads = {k: rs.randn(*v.shape).astype(np.float32) for k, v in params.items()}
        skip = torch.tensor(call == 1)
        before = [t.clone() for t in tp + mus + nus]
        fn(tp, [torch.from_numpy(grads[k]) for k in names], mus, nus, count + 1, lr, betas, eps,
           wds, skip=skip, **extra)
        if call == 1:
            assert all(torch.equal(a, b) for a, b in zip(before, tp + mus + nus))
            continue
        count += 1
        u, st = tx.update(jax.tree.map(jnp.asarray, grads), st, jp)
        jp = optax.apply_updates(jp, u)
    tol = dict(rtol=3e-5, atol=3e-6) if kind == "lamb" else dict(rtol=1e-6, atol=1e-7)
    for k, got in zip(names, tp):
        np.testing.assert_allclose(got.numpy(), np.asarray(jp[k]), err_msg=k, **tol)


def test_device_block_holds_lr_bias_corrections_and_skip():
    """``{lr, 1 - b1^t, 1 - b2^t, skip}`` in f32; a Python count and lr give
    the device scalars' block (the corrections against optax:
    ``tests/test_torch_fused_adam.py::test_bias_corrections_are_optax_f32``)."""
    blk = tfa.device_block(torch.tensor(3, dtype=torch.int32), torch.tensor(0.5),
                           torch.tensor(True), (0.9, 0.999), "cpu")
    assert blk.dtype == torch.float32 and blk.shape == (4,)
    assert blk[0] == 0.5 and blk[3] == 1.0 and float(blk[1]) == pytest.approx(1 - 0.9 ** 3)
    assert torch.equal(blk, tfa.device_block(3, 0.5, torch.tensor(True), (0.9, 0.999), "cpu"))
    assert tfa.device_block(3, 0.5, None, (0.9, 0.999), "cpu")[3] == 0.0


def test_dropout_key_table_is_jax_derivation_and_draws_its_masks():
    cfg = tgpt2.get_config("gpt2-tiny", dropout=0.1)
    L = cfg.n_layer
    rng = prng.fold_in(prng.fold_in(prng.PRNGKey(3), 7), 1)
    table = tgpt2.dropout_key_table(cfg, rng)
    jrng = jnp.asarray(rng)
    # models/gpt2.py:435-438, and _block's split of each layer's key (:329)
    want = [jax.random.fold_in(jrng, L)] + [
        k for layer in jax.random.split(jax.random.fold_in(jrng, 0), L)
        for k in jax.random.split(layer, 3)]
    np.testing.assert_array_equal(table, np.stack([np.asarray(k) for k in want]))
    dev = prng.device_keys(table, "cpu")
    x = torch.randn(3, 5, 7)
    for row in range(table.shape[0]):
        np.testing.assert_array_equal(tdo.dropout(x, dev[row], 0.1).numpy(),
                                      tdo.dropout(x, table[row], 0.1).numpy())
    # the trunk under the device table equals the trunk under the host key
    params = params_from_numpy(jax.tree.map(np.asarray, jgpt2.init_params(
        jgpt2.get_config("gpt2-tiny"), jax.random.PRNGKey(0))), "cpu")
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 16)))
    a, _ = tgpt2.hidden_with_aux(cfg, params, ids, True, rng)
    b, _ = tgpt2.hidden_with_aux(cfg, params, ids, True, dev)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="key table"):
        tgpt2.hidden_with_aux(cfg, params, ids, True, dev[:3])


def _gpt2(dropout=0.0, **kw):
    cfg = tgpt2.get_config("gpt2-tiny", dropout=dropout, **kw)
    tree = jax.tree.map(np.array, jgpt2.init_params(jgpt2.get_config("gpt2-tiny"),
                                                    jax.random.PRNGKey(0)))
    return tgpt2.make_module(cfg), tree


def _config(opt="AdamW", **kw):
    params = {"lr": 1e-2, "weight_decay": 0.01} if opt in ("AdamW", "Lamb") else {"lr": 1e-2}
    if opt == "SGD":
        params["momentum"] = 0.9
    return dict({"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
                 "gradient_clipping": 1.0, "steps_per_print": 1000,
                 "optimizer": {"type": opt, "params": params},
                 "scheduler": {"type": "WarmupLR", "params": {"warmup_max_lr": 1e-2,
                                                              "warmup_num_steps": 3}}}, **kw)


def _ids(rows=4, S=32, seed=0, vocab=512):
    return {"input_ids": np.random.RandomState(seed).randint(0, vocab, (rows, S)).astype(np.int32)}


def _guard(program):
    fn = program.fn

    def guarded():
        with no_host_traffic():
            return fn()
    program.fn = guarded


CASES = {
    "adamw dropout": (lambda: _gpt2(0.1), _config("AdamW")),
    "lamb fp16": (lambda: _gpt2(), _config("Lamb", fp16={"enabled": True,
                                                          "initial_scale_power": 12})),
    "adagrad bf16 remat attn": (lambda: _gpt2(remat=True, remat_policy="attn"),
                                _config("Adagrad", bf16={"enabled": True})),
    "sgd remat full dropout": (lambda: _gpt2(0.1, remat=True), _config("SGD")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_reads_nothing_on_the_host(case):
    make, conf = CASES[case]
    module, tree = make()
    eng, *_ = dtt.initialize(model=module, config=conf, device="cpu",
                             model_parameters=params_from_numpy(tree, "cpu"))
    batch = _ids()
    want = [eng.train_batch(batch)]  # builds the program
    (prog,) = eng._programs.values()
    _guard(prog)
    for _ in range(2):
        m = eng.train_batch(batch)
        assert all(isinstance(v, torch.Tensor) and v.dim() == 0 for v in m.values())
    assert prog.calls == 3 and eng.jit_step_cache_size == 1
    assert eng.get_global_step() + eng.skipped_steps == 3
    # the eval program and the forward / backward / step shim
    loss = eng(batch)
    eng.backward(loss)
    eng.step()
    (ev,) = [p for sig, p in eng._programs.items() if sig[0] == "eval"]
    _guard(ev)
    assert torch.isfinite(eng.eval_batch(batch)) and eng.jit_step_cache_size == 1
    del want


def test_block_sparse_bert_step_reads_nothing_on_the_host():
    cfg = tbert.get_config("bert-tiny", pretraining=True, attn_impl="sparse")
    eng, *_ = dtt.initialize(model=tbert.make_module(cfg), config=_config("Adam"), device="cpu",
                             seed=0)
    rs = np.random.RandomState(1)
    ids = rs.randint(5, cfg.vocab_size, (4, 64)).astype(np.int32)
    labels = np.where(rs.rand(4, 64) < 0.15, ids, -100).astype(np.int32)
    batch = {"input_ids": ids, "labels": labels,
             "next_sentence_label": rs.randint(0, 2, 4).astype(np.int32)}
    first = float(eng.train_batch(batch)["loss"])
    (prog,) = eng._programs.values()
    _guard(prog)
    losses = [float(eng.train_batch(batch)["loss"]) for _ in range(3)]
    assert np.isfinite(losses).all() and losses[-1] < first


def test_one_program_per_batch_signature_and_host_reads_at_the_print_cadence():
    module, tree = _gpt2()
    eng, *_ = dtt.initialize(model=module, config=_config(), device="cpu",
                             model_parameters=params_from_numpy(tree, "cpu"))
    for S in (32, 16, 32, 16):
        eng.train_batch(_ids(S=S))
    assert eng.jit_step_cache_size == 2
    assert [p.calls for sig, p in eng._programs.items() if sig[0] == "train"] == [2, 2]
    eng.train_batch({"input_ids": _ids(S=16)["input_ids"], "labels": _ids(S=16)["input_ids"]})
    assert eng.jit_step_cache_size == 3
    counter = _CountHostReads()
    with counter:
        for _ in range(3):
            eng.train_batch(_ids(S=32))
    assert counter.n == 0  # steps_per_print 1000, no telemetry: nothing read
    eng.steps_per_print = 1
    with counter:
        eng.train_batch(_ids(S=32))
    assert counter.n > 0


def test_overflow_step_leaves_the_state_bit_for_bit():
    """fp16 with a poisoned weight: every step overflows; parameters,
    moments and the optimizer count stay bit for bit, the scale halves on
    each overflow (hysteresis 1) and skipped_steps counts them."""
    module, tree = _gpt2()
    tree["wpe"][0, 0] = np.inf
    eng, *_ = dtt.initialize(model=module, device="cpu",
                             model_parameters=params_from_numpy(tree, "cpu"),
                             config=_config("AdamW", fp16={"enabled": True, "hysteresis": 1,
                                                           "initial_scale_power": 8}))
    eng.train_batch(_ids())  # builds the program
    state = [t.clone() for t in tree_leaves(eng.params) + tree_leaves(eng.opt_state.mu)
             + tree_leaves(eng.opt_state.nu)] + [eng.opt_state.count.clone()]
    for i in range(3):
        m = eng.train_batch(_ids())
        assert bool(m["overflow"]) and float(m["loss_scale"]) == 2.0 ** (7 - i)
    now = tree_leaves(eng.params) + tree_leaves(eng.opt_state.mu) + \
        tree_leaves(eng.opt_state.nu) + [eng.opt_state.count]
    assert all(torch.equal(a, b) for a, b in zip(state, now))
    assert eng.skipped_steps == 4 and eng.get_global_step() == 0 and eng.loss_scale == 16.0


def test_inference_forward_is_one_program_an_input_shape():
    _, tree = _gpt2()
    eng = dtt.init_inference("gpt2-tiny", params=params_from_numpy(tree, "cpu"),
                             dtype=torch.float32, device="cpu")
    ids = _ids(2, 24)["input_ids"]
    a = eng({"input_ids": ids})
    b = eng({"input_ids": torch.from_numpy(ids)})
    c = eng({"input_ids": ids[:, :8]})
    assert len(eng._forward_programs) == 2 and a is not b
    want = tgpt2.forward(eng.model_config, eng.params, torch.from_numpy(ids).long())
    assert torch.equal(a, want) and torch.equal(b, want)
    assert torch.equal(c, tgpt2.forward(eng.model_config, eng.params,
                                        torch.from_numpy(ids[:, :8]).long()))
    _guard(eng._forward_programs[(2, 24)])
    assert torch.equal(eng({"input_ids": ids}), want)
    assert params_to_numpy(eng.params).keys() == tree.keys()


def test_traced_launches_counts_only_after_the_marker():
    """``utils.profiling.traced_launches(since=...)``: a trace whose first
    records were lost still counts a whole replay after the marker kernel."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from deepspeed_tpu_torch.utils.profiling import (MARKER, TRAINING_KERNEL_EVENTS,
                                                     device_time, traced_launches)

    def ev(t, name, dev=DeviceType.CUDA):
        return SimpleNamespace(time_range=SimpleNamespace(start=t, end=t + 0.5), name=name,
                               device_type=dev)

    replay = ["void (anonymous namespace)::dropout_kernel<bf16>", "flash_fwd_wgmma<...>",
              "void (anonymous namespace)::dropout_kernel<bf16>", "flash_bwd_dq_wgmma"]
    events = ([ev(t, n) for t, n in enumerate(replay[2:])]  # a replay missing its start
              + [ev(10, "at::cuda::(anonymous namespace)::spin_kernel(long)"),
                 ev(11, "cudaGraphLaunch", DeviceType.CPU)]
              + [ev(20 + t, n) for t, n in enumerate(replay)])
    prof = SimpleNamespace(events=lambda: events)
    counted = {"threefry_dropout": 2, "flash_attention_fwd": 1, "flash_attention_bwd": 1}
    got = {k: (s, c) for k, s, c in traced_launches(prof, counted, TRAINING_KERNEL_EVENTS,
                                                    since=MARKER) if c}
    assert got == {"::dropout_kernel<": (2, 2), "flash_fwd_": (1, 1), "flash_bwd_dq_": (1, 1)}
    whole = {k: s for k, s, _ in traced_launches(prof, counted, TRAINING_KERNEL_EVENTS)}
    assert whole["::dropout_kernel<"] == 3  # without the marker the first replay counts too
    by_name, busy_us = device_time(prof, since=MARKER)
    assert sum(by_name.values()) == busy_us == 4 * 0.5 and MARKER not in "".join(by_name)
