"""Disaggregated serving: the port's ``serving.placement.disaggregate`` on
gloo ranks of the CPU against the JAX package.

One module-scoped fixture starts a world of 2 gloo ranks and one of 4
(``tests/torch_dist.py`` ``serve``); the JAX references are computed on the
conftest's CPU devices while they run. On gpt2-tiny at fp32 with JAX's
``BASE``, ``ALL_FEATURES`` and ``_mixed_requests``
(``tests/unit/test_serving_tp.py``):

- prefill and decode on separate placements, at tp 1 (ranks 0 | 1), tp 2
  (0-1 | 2-3), and decode_tp 1 with prefill_tp 2 (0 | 1-2, the handoff
  re-sharding the heads), emit the JAX package's single-device greedy
  streams on every rank, with int8 pages too;
- ``kv_handoffs`` and ``kv_handoff_bytes`` equal JAX's ``stats()``, the
  program names JAX's ``executable_names()`` and ``expected_executables``
  JAX's 5; ``stats()["placement"]`` has JAX's keys;
- a drain in mid-load leaves both allocators clean; the ``kv_handoff``
  span of the request trace carries pages, bytes and latency;
- at tp 2 the host tier on the prefill placement re-emits the streams after
  every prefix page was demoted, and the heat ledgers of both placements
  reconcile.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepspeed_tpu.inference.engine import InferenceEngine as JaxInferenceEngine
from deepspeed_tpu.models import gpt2 as jgpt2

from tests import torch_dist
from tests.torch_threads import one_torch_thread  # noqa: F401

BASE = {"max_slots": 4, "page_size": 4, "num_pages": 64, "max_prompt_len": 12,
        "max_new_tokens": 8}
ALL_FEATURES = {"speculative": {"enabled": True, "k": 3}, "prefix_cache": {"enabled": True},
                "prefill_chunk_tokens": 8}
ALL = dict(BASE, **ALL_FEATURES)
INT8_ALL = dict(ALL, kv_cache_dtype="int8")
TIERED = {"tiering": {"enabled": True, "host_budget_pages": 64}}
DIS = {"disaggregate": True}
# case -> (world, ranks, config, JAX's reference streams)
CASES = {
    "tp1": (2, 2, dict(ALL, placement=DIS), "all"),
    "tp1_int8": (2, 2, dict(INT8_ALL, placement=DIS), "int8"),
    "tp2": (4, 4, dict(ALL, placement=dict(DIS, tp=2)), "all"),
    "reshard": (4, 3, dict(ALL, placement=dict(DIS, decode_tp=1, prefill_tp=2)), "all"),
    "tier_tp2": (4, 4, dict(INT8_ALL, placement=dict(DIS, tp=2), **TIERED), "int8"),
}


def _mixed_requests(vocab, n=16, seed=7):
    rs = np.random.RandomState(seed)
    plens = [2, 5, 8, 12, 7, 3, 11, 4] * 2
    return [(rs.randint(0, vocab, (plens[i],)).astype(np.int32),
             6 if i % 7 else (1, 3, 8)[i // 7]) for i in range(n)]


def _streams(srv, reqs):
    subs = [srv.submit(p, max_new_tokens=n, seed=i) for i, (p, n) in enumerate(reqs)]
    srv.run()
    return [list(r.tokens) for r in subs]


@pytest.fixture(scope="module")
def tree():
    cfg = jgpt2.get_config("gpt2-tiny")
    return jax.tree.map(np.asarray, jgpt2.init_params(cfg, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def reqs():
    return _mixed_requests(jgpt2.get_config("gpt2-tiny").vocab_size)


@pytest.fixture(scope="module")
def ranks(tree, reqs, tmp_path_factory):
    opts = {"tp1": {"trace": True}, "tier_tp2": {"demote": True, "heat": True}}
    jobs = {}
    for world in (2, 4):
        cases = [(name, n, conf, reqs, opts.get(name, {}))
                 for name, (w, n, conf, _) in CASES.items() if w == world]
        if world == 2:
            cases.append(("drain", 2, dict(ALL, placement=DIS), [], {"drain_mid_load": True}))
        d = tmp_path_factory.mktemp(f"dis_world{world}")
        jobs[world] = torch_dist.start(world, "serve", (tree, cases, str(d)), d, timeout=120)
    return jobs


@pytest.fixture(scope="module")
def jax_ref(tree, reqs, ranks):
    """JAX's single-device streams, and each disaggregated case's program
    names, handoff counts and placement stats (computed while the ranks
    run)."""
    cfg = jgpt2.get_config("gpt2-tiny")
    eng = JaxInferenceEngine(jgpt2.make_module(cfg), params=jax.tree.map(jnp.asarray, tree),
                             dtype=jnp.float32)
    out = {"all": _streams(eng.serve(ALL), reqs), "int8": _streams(eng.serve(INT8_ALL), reqs)}
    for name in ("tp1", "tp2", "reshard"):
        srv = eng.serve(CASES[name][2])
        assert _streams(srv, reqs) == out["all"]
        st = srv.stats()
        out[name] = {"names": [n for n, _ in srv.executable_names()],
                     "expected": srv.expected_executables,
                     "kv_handoffs": st["kv_handoffs"], "kv_handoff_bytes": st["kv_handoff_bytes"],
                     "placement": st["placement"]}
    return out


def _case(ranks, name):
    world, n = CASES[name][0], CASES[name][1]
    return [ranks[world][r][name] for r in range(n)]


@pytest.mark.parametrize("name", list(CASES))
def test_disaggregated_streams_equal_jax_single_device(ranks, jax_ref, name):
    want = jax_ref[CASES[name][3]]
    for r, got in enumerate(_case(ranks, name)):
        assert got["streams"] == want, f"rank {r}"


@pytest.mark.parametrize("name", ["tp1", "tp2", "reshard"])
def test_handoffs_and_programs_equal_jax(ranks, jax_ref, name):
    want = jax_ref[name]
    for got in _case(ranks, name):
        st = got["stats"]
        assert st["kv_handoffs"] == want["kv_handoffs"] > 0
        assert st["kv_handoff_bytes"] == want["kv_handoff_bytes"]
        assert st["kv_handoff_latency_mean_s"] > 0
        assert got["names"] == want["names"]
        assert got["expected"] == want["expected"] == len(got["names"]) == 5


def test_program_names_at_tp2(ranks):
    """JAX ``test_disaggregated_verify_clean_and_handoff_programs``'s names."""
    for got in _case(ranks, "tp2"):
        assert got["names"] == ["serving_prefill_tp2", "serving_verify_tp2",
                                "serving_chunk_prefill_tp2", "serving_kv_gather_tp2",
                                "serving_kv_scatter_tp2"]


@pytest.mark.parametrize("name", ["tp1", "tp2", "reshard"])
def test_stats_placement(ranks, jax_ref, name):
    want = jax_ref[name]["placement"]
    for r, got in enumerate(_case(ranks, name)):
        got = got["stats"]["placement"]
        assert got["disaggregated"] is True and got["tp"] == want["tp"]
        assert got["placements"].keys() == want["placements"].keys() == {"prefill", "decode"}
        for plc, w in want["placements"].items():
            g = got["placements"][plc]
            assert g.keys() == w.keys()
            assert len(g["devices"]) == len(w["devices"])
            for k in ("tp", "num_pages", "per_device_pool_bytes", "per_device_scales_bytes"):
                assert g[k] == w[k], (plc, k)


def test_rank_holds_its_placement_only(ranks):
    """At decode_tp 1, prefill_tp 2: rank 0 holds the decode pool's 4 heads,
    ranks 1 and 2 two prefill heads each, and no rank the other's."""
    pools = [got["pools"] for got in _case(ranks, "reshard")]
    assert pools[0]["decode"][0][2] == 4 and pools[0]["decode"][2]
    assert pools[0]["prefill"][0][2] == 0 and not pools[0]["prefill"][2]
    for r in (1, 2):
        assert pools[r]["prefill"][0][2] == 2 and pools[r]["prefill"][2]
        assert pools[r]["decode"][0][2] == 0 and not pools[r]["decode"][2]


def test_mid_load_drain_leaks_nothing(ranks):
    """JAX ``test_disaggregated_drain_zero_leaks_mid_load``: each rank's
    engine drained with requests mid-prefill, mid-handoff and mid-decode
    passes ``check_no_leaks`` over both allocators."""
    for r in range(2):
        assert ranks[2][r]["drain"]["drain"] > 0


def test_kv_handoff_span(ranks):
    for got in _case(ranks, "tp1"):
        spans = got["handoff_spans"]
        assert len(spans) == got["stats"]["kv_handoffs"]
        assert all(s["pages"] >= 1 and s["bytes"] > 0 and s["latency_s"] >= 0 for s in spans)
        assert sum(s["bytes"] for s in spans) == got["stats"]["kv_handoff_bytes"]


def test_host_tier_and_heat_across_placements(ranks, jax_ref):
    got = _case(ranks, "tier_tp2")
    for g in got:
        assert g["streams2"] == jax_ref["int8"]
        assert g["spills"] > 0 and g["tier"]["restores"] > 0 and g["tier"]["crc_failures"] == 0
        assert g["heat"] == {"decode": None, "prefill": None}
    # the tier's bookkeeping is the same on every rank, pool or none
    assert all(g["tier"] == got[0]["tier"] for g in got)


def test_refused_without_enough_ranks(ranks):
    del ranks  # the ranks' fixture first: the engine refuses in this process
    import deepspeed_tpu_torch as dtt

    eng = dtt.init_inference("gpt2-tiny", dtype="float32", device="cpu")
    with pytest.raises(ValueError, match=re.escape("needs 2 devices") + ".*no process group"):
        eng.serve(dict(BASE, placement=DIS))
