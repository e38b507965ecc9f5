"""The compiled-program contract of the JAX package, ported, on the CPU
(gpt2-tiny, fp32, the same numpy weights in both packages):

- ``InferenceEngine.generate``'s LRU cache of programs driven by
  ``tests/unit/test_inference.py::TestGenerateCacheLRU``'s call sequence,
  on the port's engine and on the JAX engine: the same live keys in the
  same order, the same evictions, the same tokens;
- prompts of several true lengths in one bucket share one entry (the true
  length is a device input, as JAX traces it) and give JAX's tokens;
- ``ServingEngine.executables`` / ``expected_executables`` equal to the
  JAX engine's for the default section, speculation, chunking and the
  prefix cache (``tests/unit/test_serving.py:129``, ``:202``, ``:594``), the
  streams token-identical to JAX's;
- ``decode_attention_ref`` and ``decode_attention_split_ref`` with a
  tensor ``pos`` against the Pallas decode kernel in interpret mode, for
  every ``pos`` of the cache and 1-8 chunks;
- a guard that every program's step function (generate's prefill and
  step; serving's prefill, decode, verify and chunk; greedy and sampled;
  int8 KV pages and int8 weights) neither reads a device value on the host
  nor makes a tensor from host data, which a captured CUDA graph could not
  replay: a ``TorchDispatchMode`` that fails on ``aten::_local_scalar_dense``,
  ``nonzero``, ``masked_select``, a boolean index, ``lift_fresh`` (a tensor
  from host data) and a copy across devices, with ``Tensor.cpu``,
  ``numpy``, ``tolist`` and ``__array__`` refused while it is on; the
  same with the whole telemetry plane attached (step trace, watchdog,
  request trace, KV heat, metrics journal, SLO classes), whose hooks add
  no read of tensor data to a scheduler step (the same count of host
  reads, the token reads, with the plane on and off);
- the launch registry every wrapper counts in, and the tensors a capture
  holds for its graph (the device scalars, the split scratch).

The programs capture only on the card (``tests/test_torch_cuda_kernels.py``
holds captured against eager there); here they run their step functions.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

import deepspeed_tpu_torch as dtt
from deepspeed_tpu.inference.engine import InferenceEngine as JaxInferenceEngine
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.ops.pallas import decode_attention as jda
from deepspeed_tpu_torch.ops import decode_attention as tda
from deepspeed_tpu_torch.ops import prng
from deepspeed_tpu_torch.utils import graphs
from deepspeed_tpu_torch.utils.weights import params_from_numpy
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

VOCAB = 512
SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.95)
SERVING = {"max_slots": 2, "page_size": 4, "num_pages": 48, "max_prompt_len": 12,
           "max_new_tokens": 6, "kv_cache_dtype": "float32"}


@pytest.fixture(scope="module")
def tree():
    cfg = jgpt2.get_config("gpt2-tiny")
    return jax.tree.map(np.asarray, jgpt2.init_params(cfg, jax.random.PRNGKey(0)))


def _jax_engine(tree, config=None):
    cfg = jgpt2.get_config("gpt2-tiny")
    return JaxInferenceEngine(jgpt2.make_module(cfg), params=jax.tree.map(jnp.asarray, tree),
                              dtype=jnp.float32, config=config)


def _engine(tree, config=None, dtype=torch.float32):
    return dtt.init_inference("gpt2-tiny", params=params_from_numpy(tree, "cpu"), dtype=dtype,
                              device="cpu", config=config)


def _ids(seed, shape):
    return np.random.RandomState(seed).randint(0, VOCAB, shape).astype(np.int32)


# ---- generate: the LRU cache of programs ------------------------------------

def test_generate_cache_lru_matches_jax(tree):
    """TestGenerateCacheLRU's sequence (cap 2: max_new 1, 2, hit 1, 3
    evicts 2, then 2 again evicts 1) on both engines, step by step."""
    cfg = {"generate_cache_size": 2}
    port, ref = _engine(tree, cfg), _jax_engine(tree, cfg)
    ids = _ids(0, (1, 4))
    for m, evictions, live in ((1, 0, [1]), (2, 0, [1, 2]), (1, 0, [2, 1]), (3, 1, [1, 3]),
                               (2, 2, [3, 2])):
        got, want = port.generate(ids, max_new_tokens=m), ref.generate(ids, max_new_tokens=m)
        np.testing.assert_array_equal(got, np.asarray(want))
        assert list(port._generate_cache) == list(ref._generate_cache)
        assert [k[1] for k in port._generate_cache] == live
        assert port.generate_cache_evictions == ref.generate_cache_evictions == evictions
    assert got.shape == (1, 6)


def test_evicted_entry_releases_its_programs(tree):
    port = _engine(tree, {"generate_cache_size": 1})
    port.generate(_ids(1, (2, 5)), max_new_tokens=3)
    (entry,) = port._generate_cache.values()
    prefill, step = entry.programs
    assert (prefill.calls, step.calls) == (1, 2) and entry.state.cache.k.shape[2] == 8 + 3
    port.generate(_ids(1, (2, 5)), max_new_tokens=2)
    assert port.generate_cache_evictions == 1
    assert entry.state is None and prefill.fn is None and step.fn is None


@pytest.mark.parametrize("sampled", [False, True])
def test_bucketed_lengths_share_one_entry(tree, sampled):
    """Prompts of 5, 6 and 7 tokens pad to the 8 bucket: one entry, whose
    prefill program takes the true length as an input, and JAX's tokens."""
    port, ref = _engine(tree), _jax_engine(tree)
    ids = _ids(2, (2, 7))
    kw = dict(SAMPLING, seed=4) if sampled else {}
    for n in (5, 7, 6):
        got = port.generate(ids[:, :n], max_new_tokens=6, **kw)
        np.testing.assert_array_equal(got, np.asarray(ref.generate(ids[:, :n], max_new_tokens=6,
                                                                   **kw)))
    assert list(port._generate_cache) == list(ref._generate_cache)
    (key,) = port._generate_cache
    assert key == ((2, 8), 6, SAMPLING["temperature"] if sampled else 0.0,
                   SAMPLING["top_k"] if sampled else 0, SAMPLING["top_p"] if sampled else 1.0)
    prefill, step = port._generate_cache[key].programs
    assert (prefill.calls, step.calls) == (3, 15)


# ---- serving: the fixed program set ------------------------------------------

SECTIONS = {
    "default": {},
    "speculation": {"speculative": {"enabled": True, "k": 3}},
    "chunking": {"prefill_chunk_tokens": 4},
    "prefix cache": {"prefix_cache": {"enabled": True}},
}


@pytest.mark.parametrize("name", list(SECTIONS))
def test_serving_program_set_matches_jax(tree, name):
    section = dict(SERVING, **SECTIONS[name])
    rs = np.random.RandomState(5)
    system = rs.randint(0, VOCAB, 8)
    prompts = [np.concatenate([system, rs.randint(0, VOCAB, n)]) if i % 2 else
               rs.randint(0, VOCAB, 2 + n) for i, n in enumerate((1, 4, 3, 2))]
    streams = []
    for srv in (_engine(tree).serve(section), _jax_engine(tree).serve(section)):
        reqs = [srv.submit(p, max_new_tokens=5, seed=i) for i, p in enumerate(prompts)]
        srv.run()
        srv.check_no_leaks()
        streams.append(([list(r.tokens) for r in reqs], len(srv.executables),
                        srv.expected_executables))
    (got, n, expected), want = streams
    assert got == want[0]
    assert n == expected == want[1] == want[2]
    assert n == (2 if name in ("default", "speculation") else 3)


def test_serving_programs_are_named_and_fixed(tree):
    srv = _engine(tree).serve(dict(SERVING, speculative={"enabled": True, "k": 3},
                                   prefix_cache={"enabled": True}, prefill_chunk_tokens=4,
                                   kv_cache_dtype="int8"))
    names = [p.name for p in srv.executables]
    assert names == ["serving_prefill_int8", "serving_verify_int8",
                     "serving_chunk_prefill_int8"]
    progs = list(srv.executables)
    long = _ids(6, (10,))
    for i, p in enumerate((long[:3], long, np.concatenate([long[:8], long[:2]]))):
        srv.submit(p, max_new_tokens=4, seed=i)
    srv.run()
    assert srv.executables == progs and all(p.calls > 0 for p in progs)
    # the slot table is the verify program's staging (tokens kept apart)
    staged = srv.executables[1].inputs.staging()
    assert np.shares_memory(srv.table.seq_lens, staged["seq_lens"])
    assert np.shares_memory(srv.table.block_tables, staged["block_tables"])
    assert not np.shares_memory(srv.table.tokens, staged["tokens"])


# ---- the decode kernel's plain versions with a device pos --------------------

@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2)])
def test_decode_refs_with_tensor_pos_match_pallas(H, KV):
    S, D = 32, 64
    rs = np.random.RandomState(H + KV)
    q, k, v = (rs.randn(*s).astype(np.float32) for s in ((2, H, D), (2, S, KV, D), (2, S, KV, D)))
    pallas = jax.jit(lambda q, k, v, p: jda.decode_attention(q, k, v, p, interpret=True))
    t = torch.from_numpy
    for pos in range(S):
        want = np.asarray(pallas(q, k, v, jnp.int32(pos)))
        p = torch.tensor([pos], dtype=torch.int32)
        np.testing.assert_allclose(tda.decode_attention_ref(t(q), t(k), t(v), p).numpy(), want,
                                   rtol=2e-5, atol=2e-5)
        for splits in range(1, 9):
            got = tda.decode_attention_split_ref(t(q), t(k), t(v), p, splits).numpy()
            np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


# ---- no host traffic inside a program's step ----------------------------------

aten = torch.ops.aten
_SYNC_OPS = {"_local_scalar_dense", "nonzero", "masked_select", "lift_fresh",
             "lift_fresh_copy"}
_INDEX_OPS = {"index", "index_put", "index_put_", "_index_put_impl_"}
_HOST_READS = ("cpu", "numpy", "tolist", "__array__")


class HostTrafficError(AssertionError):
    pass


class NoHostTraffic(TorchDispatchMode):
    """Fails on what a captured graph cannot replay: a device value read
    on the host, an op whose output shape depends on the data, a tensor
    made from host data, a copy across devices."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name in _SYNC_OPS:
            raise HostTrafficError(f"{func} in a program step")
        flat, _ = tree_flatten((args, kwargs))
        if name in _INDEX_OPS and any(isinstance(a, torch.Tensor) and a.dtype == torch.bool
                                      for a in flat):
            raise HostTrafficError(f"{func} with a boolean index in a program step")
        if name in ("_to_copy", "copy_"):
            devs = {a.device for a in flat if isinstance(a, torch.Tensor)}
            if "device" in kwargs and kwargs["device"] is not None:
                devs.add(torch.device(kwargs["device"]))
            if len(devs) > 1:
                raise HostTrafficError(f"{func} across devices {devs} in a program step")
        return func(*args, **kwargs)


@contextlib.contextmanager
def no_host_traffic():
    saved = {m: getattr(torch.Tensor, m) for m in _HOST_READS}

    def refuse(m):
        def f(*a, **k):
            raise HostTrafficError(f"Tensor.{m} in a program step")
        return f

    for m in _HOST_READS:
        setattr(torch.Tensor, m, refuse(m))
    try:
        with NoHostTraffic():
            yield
    finally:
        for m, f in saved.items():
            setattr(torch.Tensor, m, f)


def _guard(programs):
    """Every call of these programs' step functions runs under the guard."""
    for p in programs:
        fn = p.fn

        def guarded(fn=fn):
            with no_host_traffic():
                return fn()
        p.fn = guarded


def test_the_guard_catches_host_traffic():
    x = torch.arange(4.0)
    for bad in (lambda: x.sum().item(), lambda: int(x[0]), lambda: x[x > 1],
                lambda: torch.tensor([1, 2]) + 1, lambda: torch.from_numpy(np.ones(2)) + 1,
                lambda: x.nonzero(), lambda: x.numpy(), lambda: x.tolist()):
        with pytest.raises(HostTrafficError), no_host_traffic():
            bad()
    with no_host_traffic():  # device work with Python scalars is fine
        torch.where(x > 1, x * 2.0, 0.0).index_select(0, torch.arange(2)).argmax()


@pytest.mark.parametrize("case", ["greedy", "sampled", "int8 weights sampled"])
def test_generate_steps_have_no_host_traffic(tree, case):
    eng = _engine(tree, dtype="int8" if "int8" in case else torch.float32)
    kw = dict(SAMPLING, seed=1) if "sampled" in case else {}
    ids = _ids(3, (2, 6))
    want = eng.generate(ids, max_new_tokens=4, **kw)  # builds the entry
    (entry,) = eng._generate_cache.values()
    _guard(entry.programs)
    prng.device_scalar.cache_clear()
    np.testing.assert_array_equal(eng.generate(ids, max_new_tokens=4, **kw), want)
    assert [p.calls for p in entry.programs] == [2, 6]


def _plane(root):
    """The whole telemetry plane: step trace, Prometheus file, watchdog,
    request trace, KV heat, metrics journal."""
    return {"telemetry": {
        "enabled": True, "trace_path": str(root), "prometheus_path": str(root / "m.prom"),
        "watchdog": {"enabled": True, "capture_dir": str(root / "cap")},
        "request_trace": {"enabled": True}, "kv_heat": {"enabled": True},
        "timeseries": {"enabled": True, "interval_s": 0.001}}}


@pytest.mark.parametrize("case", ["greedy", "sampled"])
def test_generate_steps_have_no_host_traffic_with_the_plane(tree, case, tmp_path):
    eng = _engine(tree, config=_plane(tmp_path))
    kw = dict(SAMPLING, seed=1) if case == "sampled" else {}
    ids = _ids(3, (2, 6))
    want = eng.generate(ids, max_new_tokens=4, **kw)
    (entry,) = eng._generate_cache.values()
    _guard(entry.programs)
    prng.device_scalar.cache_clear()
    np.testing.assert_array_equal(eng.generate(ids, max_new_tokens=4, **kw), want)
    eng.telemetry.flush()
    assert eng.telemetry.registry.get("generate_cache_size").value() == 1


SERVING_CASES = {
    "greedy": ({}, torch.float32),
    "sampled": (SAMPLING, torch.float32),
    "features int8 pages": ({"speculative": {"enabled": True, "k": 3},
                             "prefix_cache": {"enabled": True}, "prefill_chunk_tokens": 4,
                             "kv_cache_dtype": "int8"}, torch.float32),
    "int8 weights sampled chunked": (dict(SAMPLING, prefill_chunk_tokens=4,
                                          prefix_cache={"enabled": True}), "int8"),
}


@pytest.mark.parametrize("case", list(SERVING_CASES) + ["features int8 pages, telemetry plane"])
def test_serving_steps_have_no_host_traffic(tree, case, tmp_path):
    plane = case.endswith("telemetry plane")
    section, dtype = SERVING_CASES[case.split(", telemetry")[0]]
    section = dict(section, slo={"classes": {"a": {"ttft_target_s": 1.0}}}) if plane else section
    srv = _engine(tree, config=_plane(tmp_path) if plane else None,
                  dtype=dtype).serve(dict(SERVING, **section))
    _guard(srv.executables)
    prng.device_scalar.cache_clear()
    rs = np.random.RandomState(8)
    system = rs.randint(0, VOCAB, 8)
    for i, n in enumerate((2, 3, 9, 4)):
        p = rs.randint(0, VOCAB, n) if i < 2 else np.concatenate([system, rs.randint(0, VOCAB, 3)])
        srv.submit(p, max_new_tokens=5, seed=i)
    done = srv.run()
    assert len(done) == 4 and all(len(r.tokens) == 5 for r in done)
    assert all(p.calls > 0 for p in srv.executables)
    if plane:
        st = srv.stats()
        assert st["request_trace"]["records"] == 4 and st["timeseries"]["snapshots"] > 0
        assert "kv_heat" in st and st["slo"]["classes"]["a"]["evaluated"] == 4


class _CountHostReads(TorchDispatchMode):
    """Counts, over whole scheduler steps, the reads of tensor data on the
    host: ``_local_scalar_dense`` (``item``/``int``) and ``Tensor.cpu`` /
    ``numpy`` / ``tolist`` calls."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ == "_local_scalar_dense":
            self.n += 1
        return func(*args, **(kwargs or {}))


def _count_host_reads(srv):
    counter = _CountHostReads()
    saved = {m: getattr(torch.Tensor, m) for m in ("cpu", "numpy", "tolist")}

    def counted(m):
        def f(self, *a, **k):
            counter.n += 1
            return saved[m](self, *a, **k)
        return f

    for m in saved:
        setattr(torch.Tensor, m, counted(m))
    try:
        with counter:
            while srv.queue or any(s.request is not None for s in srv.slots):
                srv.step()
    finally:
        for m, f in saved.items():
            setattr(torch.Tensor, m, f)
    return counter.n


@pytest.mark.parametrize("section", [{}, {"speculative": {"enabled": True, "k": 3},
                                          "prefix_cache": {"enabled": True},
                                          "prefill_chunk_tokens": 4}],
                         ids=["default", "features"])
def test_the_plane_adds_no_host_read_to_a_step(tree, section, tmp_path):
    """The only reads of tensor data in a step are the token reads: the
    same count with the whole plane on as with it off, and the same
    streams."""
    counts, streams = {}, {}
    for on in (False, True):
        srv = _engine(tree, config=_plane(tmp_path / str(on)) if on else None).serve(
            dict(SERVING, **section))
        rs = np.random.RandomState(8)
        reqs = [srv.submit(rs.randint(0, VOCAB, n), max_new_tokens=5, seed=i)
                for i, n in enumerate((2, 3, 9, 4, 7))]
        counts[on] = _count_host_reads(srv)
        streams[on] = [list(r.tokens) for r in reqs]
    assert counts[True] == counts[False] > 0
    assert streams[True] == streams[False]


def test_captured_program_on_the_cpu_runs_its_step():
    inputs = graphs.StaticInputs({"a": (3,), "b": (2, 5), "c": (1,)}, "cpu")
    assert all(v.data_ptr() % 16 == 0 for v in inputs.dev.values())
    out = torch.zeros(3, dtype=torch.int32)
    prog = graphs.CapturedProgram("p", lambda: out.add_(inputs.dev["a"]), "cpu", inputs)
    assert not prog.captures
    for i in range(3):
        inputs.staging()["a"][:] = i
        prog()
    assert out.tolist() == [3, 3, 3] and prog.calls == 3 and prog.graph is None
    prog.free()
    assert prog.fn is None and prog.inputs is None


def test_every_kernel_module_registers_its_launches():
    """One registry holds every wrapper's count (a program adds its
    capture's increase of the whole registry on each replay); each kernel
    module names its entries in KERNELS, and the CPU launches none."""
    from deepspeed_tpu_torch.ops import (block_sparse_attention, flash_attention, fused_adam,
                                         launches, paged_decode_attention,
                                         paged_multitoken_attention, ring_flash_attention)

    mods = (tda, paged_decode_attention, paged_multitoken_attention, prng, flash_attention,
            block_sparse_attention, fused_adam, ring_flash_attention)
    names = [k for m in mods for k in m.KERNELS]
    assert len(set(names)) == len(names) == 15 and set(names) == set(launches.LAUNCHES)
    assert all(m.LAUNCHES is launches.LAUNCHES for m in mods)
    saved = dict(launches.LAUNCHES)
    try:
        launches.LAUNCHES[tda.KERNELS[0]] += 2
        assert launches.counts(tda.KERNELS) == {"decode_attention": saved["decode_attention"] + 2}
        launches.reset(tda.KERNELS)
        assert launches.LAUNCHES["decode_attention"] == 0
        launches.reset()
        assert not any(launches.LAUNCHES.values())
    finally:
        launches.LAUNCHES.update(saved)


def test_a_capture_holds_what_the_caches_hand_out(monkeypatch):
    """A graph reads its buffers by address: while a program captures,
    the device scalars and the decode kernels' split scratch pass through
    graphs.hold into its list, so a cache that drops or replaces them
    frees nothing the graph reads; outside a capture nothing is held."""
    dev = torch.device("cpu")
    scalar = prng.device_scalar(0.8, dev)
    assert graphs._HELD is None and graphs.hold(scalar) is scalar
    held = []
    monkeypatch.setattr(graphs, "_HELD", held)
    assert prng.device_scalar(0.8, dev) is scalar
    tda.split_scratch(dev, None, 1, 2, 2, 4, 1)
    prng.device_scalar.cache_clear()
    again = prng.device_scalar(0.8, dev)
    assert again is not scalar and float(again) == float(scalar)
    assert held[0] is scalar and held[-1] is again and len(held) == 4
    assert held[1] is tda._PARTIALS[dev, None] and held[2] is tda._COUNTERS[dev, None]
