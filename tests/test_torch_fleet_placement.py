"""The fleet over placements: the port's ``FleetRouter`` of two tp-2
replicas on gloo ranks of the CPU, against the JAX package's
``FleetRouter`` on the conftest's 8 virtual CPU devices.

No JAX unit test runs a fleet over placements, so the oracle is JAX's
router itself (``serving.fleet`` with ``spread_devices``: replica i on
devices ``[2 i, 2 i + 2)``) and JAX's single engine, which JAX's suite
holds its fleet to (``TestMigrationBitIdentity``). On gpt2-tiny at fp32,
one module-scoped fixture starts a world of 4 ranks and one of 2
(``tests/torch_dist.py`` ``fleet``), and the JAX references are computed
while they run. Eight requests land on replica r0 by affinity; after 3
rounds r0 is preempted and its live sessions migrate to r1:

- at world 4 each replica serves from its own window (ranks ``[0, 2)``
  and ``[2, 4)``), each rank holding half of one replica's KV heads; the
  migration gathers every head from r0's window and re-shards it over
  r1's. Greedy streams on every rank are token-identical to JAX's fleet
  and to JAX's single engine, with f32 pages and with int8 pages under
  speculation and the prefix cache; the routing, the migration counts and
  bytes equal JAX's; no replica leaks a page;
- at world 2 there are too few ranks for two windows, so both replicas
  share ranks ``[0, 2)``, as JAX shares device 0's window;
- a ``comm.send_recv`` recorded by its sender only is timed by
  ``measure`` as a ring on every rank."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepspeed_tpu.inference.engine import InferenceEngine as JaxInferenceEngine
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.serving import FleetRouter as JaxFleetRouter

from tests import torch_dist
from tests.torch_threads import one_torch_thread  # noqa: F401

BASE = {"max_slots": 4, "page_size": 4, "num_pages": 64, "max_prompt_len": 12,
        "max_new_tokens": 8}
FLEET_TP2 = {"fleet": {"enabled": True, "replicas": 2}, "placement": {"tp": 2}}
INT8_FEATURES = {"kv_cache_dtype": "int8", "speculative": {"enabled": True, "k": 3},
                 "prefix_cache": {"enabled": True}}
STEPS = 3
CASES = {"f32": dict(BASE, **FLEET_TP2), "int8": dict(BASE, **FLEET_TP2, **INT8_FEATURES)}


def _requests(vocab=512, seed=7):
    rs = np.random.RandomState(seed)
    plens = [2, 5, 8, 12, 7, 3, 11, 4]
    return [(rs.randint(0, vocab, (n,)).astype(np.int32), 6) for n in plens]


@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(np.asarray, jgpt2.init_params(jgpt2.get_config("gpt2-tiny"),
                                                      jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def ranks(tree, tmp_path_factory):
    reqs = _requests()
    c4 = [(name, cfg, reqs, STEPS) for name, cfg in CASES.items()]
    c2 = [("f32", CASES["f32"], reqs, STEPS)]
    d4, d2 = tmp_path_factory.mktemp("fleet_world4"), tmp_path_factory.mktemp("fleet_world2")
    return {4: torch_dist.start(4, "fleet", (tree, c4, str(d4)), d4, timeout=240),
            2: torch_dist.start(2, "fleet", (tree, c2, str(d2)), d2, timeout=240)}


class _Clock:
    t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def jax_ref(tree, ranks):
    """JAX's fleet of two tp-2 replicas on devices [0, 2) and [2, 4), run as
    the ranks run it, and JAX's single engine, per case."""
    cfg = jgpt2.get_config("gpt2-tiny", attn_impl="jnp")
    eng = JaxInferenceEngine(jgpt2.make_module(cfg), params=jax.tree.map(jnp.asarray, tree),
                             dtype=jnp.float32)
    reqs = _requests()
    out = {}
    for name, conf in CASES.items():
        single = {k: v for k, v in conf.items() if k not in ("fleet", "placement")}
        srv = eng.serve(single)
        subs = [srv.submit(p, max_new_tokens=n, seed=i) for i, (p, n) in enumerate(reqs)]
        srv.run()
        ref = [list(r.tokens) for r in subs]
        clk = _Clock()
        fl = JaxFleetRouter(eng, conf, clock=clk)
        windows = [[d.id for d in r.srv.decode_placement.devices] for r in fl.replicas]
        subs = [fl.submit(p, max_new_tokens=n, seed=i) for i, (p, n) in enumerate(reqs)]
        for _ in range(STEPS):
            fl.step()
            clk.t += 0.01
        fl.preempt("r0")
        fl.run()
        st = fl.stats()["fleet"]
        out[name] = {"single": ref, "streams": [list(r.tokens) for r in subs],
                     "replicas": [r.replica for r in subs], "windows": windows,
                     "fleet": {k: st[k] for k in ("alive", "migrations_ok",
                                                  "migrations_crc_failed",
                                                  "migrations_no_capacity", "migration_bytes",
                                                  "requeues")}}
        fl.drain()
        fl.close()
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_world4_streams_equal_jax_fleet_and_single_engine(ranks, jax_ref, case):
    ref = jax_ref[case]
    assert ref["streams"] == ref["single"]
    for r, res in enumerate(ranks[4]):
        got = res[case]
        assert got["streams"] == ref["streams"], (r, case)
        # routed to r0 by affinity; what was live or queued at the
        # preemption finished on r1
        assert got["replicas"] == ref["replicas"] and "r1" in got["replicas"]
        assert all(str(s).lower().endswith("finished") for s in got["status"]), got["status"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_world4_windows_migrations_and_heads(ranks, jax_ref, case):
    ref = jax_ref[case]
    assert ref["windows"] == [[0, 1], [2, 3]]
    for r, res in enumerate(ranks[4]):
        got = res[case]
        assert got["windows"] == ref["windows"]
        assert got["live_at_preempt"] >= 1
        assert got["fleet"] == ref["fleet"], (r, got["fleet"], ref["fleet"])
        assert got["fleet"]["migrations_ok"] >= 1 and got["fleet"]["alive"] == 1
        # this rank holds 2 of gpt2-tiny's 4 KV heads of its own replica's
        # pool, none of the other's
        mine = r // 2
        assert [h[2] for h in got["heads"]] == [2 if i == mine else 0 for i in range(2)]


def test_world2_replicas_share_rank0_window(ranks, jax_ref):
    ref = jax_ref["f32"]
    for res in ranks[2]:
        got = res["f32"]
        assert got["windows"] == [[0, 1], [0, 1]]
        assert got["streams"] == ref["single"]
        assert got["fleet"]["migrations_ok"] == ref["fleet"]["migrations_ok"]
        assert [h[2] for h in got["heads"]] == [2, 2]


@pytest.mark.parametrize("world", [2, 4])
def test_send_recv_measured(ranks, world):
    """A send_recv row recorded by its sender only: ``measure`` agrees the
    rows over the group first, so every rank runs the ring (no rank waits
    on a peer that skipped it) and the sender's row gets its time."""
    for r, res in enumerate(ranks[world]):
        got = res["send_recv"]
        assert got["got"] == (7.0 if r == 1 else 0.0)
        if r == 0:
            assert got["row"][0] == "cpu" and got["row"][1] > 0
        else:
            assert got["row"] is None
