"""Tensor-parallel serving: the port's ``serving.placement.tp`` on gloo
ranks of the CPU against the JAX package.

One module-scoped fixture starts a world of 2 gloo ranks and one of 4
(``tests/torch_dist.py`` ``serve``); the JAX references are computed on the
conftest's CPU devices while they run. On gpt2-tiny at fp32 with JAX's
``BASE``, ``ALL_FEATURES`` and ``_mixed_requests``
(``tests/unit/test_serving_tp.py``):

- tp 2 and tp 4 with speculation, the prefix cache, chunked prefill and
  int8 KV pages emit the JAX package's single-device greedy streams, on
  every rank (the oracle is JAX's tp-1 streams, which JAX's own suite holds
  equal to its tp-2 streams);
- each rank's pool and parameter slices have the shapes of JAX's shards;
  the program names and ``serving_tp_collective_bytes`` per program equal
  JAX's ``executable_names()`` and gauge; ``stats()["placement"]`` has
  JAX's keys and per-rank bytes;
- sampled streams are equal across ranks; int8 weights and too few ranks
  are refused with JAX's errors, and a heat tracer on one rank only (it
  steers the host tier) is refused too;
- with no placement, each rank of the job serves alone (JAX's
  single-device streams, no collective); a request tracer, a journal and
  ``stats()`` on rank 0 alone leave the tp-2 streams as they were;
- at tp 2 the host tier re-emits the streams after every prefix page is
  demoted and restored (JAX ``test_mixed_suite_tp2``), and the heat
  ledgers, keyed by placement name, reconcile (JAX
  ``test_tp2_bit_identical_heat_on``).
"""

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
INT8_ALL = dict(BASE, kv_cache_dtype="int8", **ALL_FEATURES)
TIERED = {"tiering": {"enabled": True, "host_budget_pages": 64}}
SAMPLED = dict(BASE, temperature=0.8, top_k=50, top_p=0.95, prefix_cache={"enabled": True},
               prefill_chunk_tokens=8)


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
    tp2 = dict(INT8_ALL, placement={"tp": 2})
    cases2 = [
        ("tp2", 2, tp2, reqs, {"heat": True}),
        ("tier", 2, dict(tp2, **TIERED), reqs, {"demote": True}),
        ("tier_crc", 2, dict(tp2, **TIERED), reqs, {"demote": True, "corrupt_rank": 1}),
        ("sampled", 2, dict(SAMPLED, placement={"tp": 2}), reqs, {}),
        ("few_ranks", 2, dict(BASE, placement={"tp": 4}), [], {"refuse": "ranks"}),
        ("int8_weights", 2, dict(BASE, placement={"tp": 2}), [], {"refuse": "int8_weights"}),
        ("heat_rank0", 2, dict(BASE, placement={"tp": 2}), [], {"refuse": "heat_rank0"}),
        # no placement: each rank of the job serves alone
        ("default", 1, INT8_ALL, reqs, {}),
        ("solo", 2, tp2, reqs, {"solo": True}),
    ]
    cases4 = [("tp4", 4, dict(INT8_ALL, placement={"tp": 4}), reqs, {})]
    d2, d4 = tmp_path_factory.mktemp("tp_world2"), tmp_path_factory.mktemp("tp_world4")
    return {2: torch_dist.start(2, "serve", (tree, cases2, str(d2)), d2, timeout=120),
            4: torch_dist.start(4, "serve", (tree, cases4, str(d4)), d4, timeout=120)}


@pytest.fixture(scope="module")
def jax_ref(tree, reqs, ranks):
    """JAX's single-device streams and its tp-2 / tp-4 engines' program
    names, gauges, shard shapes and placement stats (computed while the
    ranks run)."""
    cfg = jgpt2.get_config("gpt2-tiny")
    eng = JaxInferenceEngine(jgpt2.make_module(cfg), params=jax.tree.map(jnp.asarray, tree),
                             dtype=jnp.float32)
    out = {"streams": _streams(eng.serve(INT8_ALL), reqs)}
    for tp in (2, 4):
        srv = eng.serve(dict(INT8_ALL, placement={"tp": tp}))
        srv._ensure_compiled()
        names = [n for n, _ in srv.executable_names()]
        params = {"/".join(str(k.key) for k in kp): tuple(x.sharding.shard_shape(x.shape))
                  for kp, x in jax.tree_util.tree_flatten_with_path(srv.decode_set.params)[0]}
        out[tp] = {
            "names": names,
            "gauge": {n: srv._g_tp_coll.value(program=n) for n in names},
            "pool": tuple(srv.k_pool.sharding.shard_shape(srv.k_pool.shape)),
            "scales": tuple(srv.kv_scales.sharding.shard_shape(srv.kv_scales.shape)),
            "params": params,
            "placement": srv.stats()["placement"],
        }
    return out


@pytest.mark.parametrize("world,case", [(2, "tp2"), (4, "tp4")])
def test_tp_streams_equal_jax_single_device(ranks, jax_ref, world, case):
    for r in range(world):
        assert ranks[world][r][case]["streams"] == jax_ref["streams"], f"rank {r}"


@pytest.mark.parametrize("world,case", [(2, "tp2"), (4, "tp4")])
def test_local_pool_and_param_shapes(ranks, jax_ref, world, case):
    want = jax_ref[world]
    for r in range(world):
        got = ranks[world][r][case]
        pool, scales, member = got["pools"]["shared"]
        assert member and pool == want["pool"] and scales == want["scales"]
        assert got["params"]["shared"] == want["params"]


@pytest.mark.parametrize("world,case", [(2, "tp2"), (4, "tp4")])
def test_program_names_and_gauges_equal_jax(ranks, jax_ref, world, case):
    want = jax_ref[world]
    for r in range(world):
        got = ranks[world][r][case]
        assert got["names"] == want["names"]
        assert got["expected"] == len(want["names"])
        assert got["gauge"] == want["gauge"]
        # a gloo group's collectives cannot be captured: eager on purpose
        assert got["captures"] == [False] * len(want["names"])


@pytest.mark.parametrize("world,case", [(2, "tp2"), (4, "tp4")])
def test_stats_placement(ranks, jax_ref, world, case):
    want = jax_ref[world]["placement"]
    for r in range(world):
        got = ranks[world][r][case]["stats"]["placement"]
        assert got["tp"] == want["tp"] and got["disaggregated"] is want["disaggregated"]
        assert got["placements"].keys() == want["placements"].keys() == {"shared"}
        g, w = got["placements"]["shared"], want["placements"]["shared"]
        assert g.keys() == w.keys()
        assert g["devices"] == ["cpu"] * world
        for k in ("tp", "num_pages", "per_device_pool_bytes", "per_device_scales_bytes"):
            assert g[k] == w[k], k
        assert ranks[world][r][case]["stats"]["kv_pool_bytes"] == world * g[
            "per_device_pool_bytes"]


def test_sampled_streams_equal_across_ranks(ranks):
    a, b = ranks[2][0]["sampled"]["streams"], ranks[2][1]["sampled"]["streams"]
    assert a == b and sum(len(s) for s in a) > 0


@pytest.mark.parametrize("case,error,match", [
    ("few_ranks", "ValueError", "needs 4 devices.*only 2 visible"),
    ("int8_weights", "ValueError", "unquantized"),
    ("heat_rank0", "ValueError", r"heat tracer differs across the serving ranks \(\[True, False\]\)"),
])
def test_refusals(ranks, case, error, match):
    import re

    for r in range(2):
        kind, msg = ranks[2][r][case]["error"]
        assert kind == error and re.search(match, msg), msg


def test_host_tier_at_tp2(ranks, jax_ref):
    """JAX ``test_mixed_suite_tp2``: the streams with the tier on, and again
    after every prefix page was demoted, equal the single-device streams;
    restores happen, and no crc fails."""
    for r in range(2):
        got = ranks[2][r]["tier"]
        assert got["streams"] == jax_ref["streams"] == got["streams2"]
        assert got["spills"] > 0 and got["tier"]["restores"] > 0
        assert got["tier"]["crc_failures"] == 0
    assert ranks[2][0]["tier"]["tier"] == ranks[2][1]["tier"]["tier"]


def test_heat_ledgers_reconcile_at_tp2(ranks):
    for r in range(2):
        assert ranks[2][r]["tp2"]["heat"] == {"shared": None}


def test_default_engine_serves_alone_on_every_rank(ranks, jax_ref):
    """No placement in a job whose process group is up (each rank serving
    its own replica): every rank holds the whole pool and tree, runs the
    single-device programs with no collective, and emits JAX's
    single-device streams."""
    for r in range(2):
        got = ranks[2][r]["default"]
        assert got["streams"] == jax_ref["streams"], f"rank {r}"
        pool, _scales, member = got["pools"]["shared"]
        assert member and pool[2] == 4
        assert got["names"] == ["serving_prefill_int8", "serving_verify_int8",
                                "serving_chunk_prefill_int8"]
        assert set(got["gauge"].values()) == {0.0}
        assert got["stats"]["placement"]["placements"]["shared"]["devices"] == ["cpu"]


def test_telemetry_on_one_rank(ranks, jax_ref):
    """A request tracer, a metrics journal and a stats() after every step
    on rank 0 alone, at tp 2: they only record, so both ranks still emit
    JAX's streams (no collective drifted), and rank 0 wrote its records."""
    got = [ranks[2][r]["solo"] for r in range(2)]
    for r, g in enumerate(got):
        assert g["streams"] == jax_ref["streams"], f"rank {r}"
    assert got[0]["trace_records"] == len(jax_ref["streams"]) and got[0]["journal_records"] > 0
    assert "trace_records" not in got[1] and "journal_records" not in got[1]


def test_host_tier_crc_miss_on_one_rank(ranks, jax_ref):
    """A host page corrupted in rank 1's heads only: its restore misses
    there and succeeds on rank 0, and the ranks agree on a miss, so both
    recompute the prefix, emit JAX's streams and drain leak-free."""
    got = [ranks[2][r]["tier_crc"] for r in range(2)]
    for r, g in enumerate(got):
        assert g["streams"] == g["streams2"] == jax_ref["streams"], f"rank {r}"
    assert got[0]["tier"]["crc_failures"] == 0 and got[1]["tier"]["crc_failures"] == 1
    assert got[0]["tier"]["restores"] == got[1]["tier"]["restores"] + 1 > 1
