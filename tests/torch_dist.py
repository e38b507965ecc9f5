"""Data-parallel ranks for the port's CPU tests: ``run(world, body, args,
tmpdir)`` starts ``world`` processes (forks of a forkserver that imported
torch and the port once), each joining a gloo group through a file store
under ``tmpdir`` (so no two pytest workers race for a port), with torch on
one thread, and returns ``body(rank, world, *args)`` of each rank, in rank
order; ``start`` returns at once with a :class:`Job` that waits at the
first use of its results.

This module imports torch, numpy and the port only: a rank never imports
JAX or the JAX package. The bodies the tests run live here too."""

from __future__ import annotations

import os
import pickle
import sys
from pathlib import Path

import numpy as np
import torch

class Job:
    """Ranks started by :func:`start`; the first use of the results (an
    index, ``len``, iteration) waits for them, so a test can compute its
    reference meanwhile."""

    def __init__(self, world: int, body: str, args: tuple, tmpdir, timeout: float):
        self.world, self.timeout = world, timeout
        self.tmpdir = Path(tmpdir)
        self.tmpdir.mkdir(parents=True, exist_ok=True)
        job = self.tmpdir / "job.pkl"
        job.write_bytes(pickle.dumps((body, args)))
        ctx = _context()
        self.procs = [ctx.Process(target=_rank_main, args=(str(job), rank, world))
                      for rank in range(world)]
        for p in self.procs:
            p.start()
        self._out = None

    def results(self) -> list:
        if self._out is None:
            try:
                for p in self.procs:
                    p.join(self.timeout)
            finally:
                for p in self.procs:
                    if p.is_alive():
                        p.kill()
                        p.join()
            for rank, p in enumerate(self.procs):
                if p.exitcode != 0:
                    log = (self.tmpdir / f"log{rank}.txt").read_text()[-6000:]
                    raise RuntimeError(f"rank {rank} of {self.world} failed ({p.exitcode}):\n{log}")
            self._out = [pickle.loads((self.tmpdir / f"out{r}.pkl").read_bytes())
                         for r in range(self.world)]
        return self._out

    def __getitem__(self, i):
        return self.results()[i]

    def __len__(self):
        return self.world

    def __iter__(self):
        return iter(self.results())


def _context():
    """A forkserver that has imported torch and the port once: each rank is
    a fork of it, with no import of its own and none of the test process's
    threads."""
    import multiprocessing as mp

    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(["tests.torch_dist", "deepspeed_tpu_torch"])
    return ctx


def start(world: int, body: str, args: tuple, tmpdir, timeout: float = 300.0) -> Job:
    """``body`` (a function name of this module) started on ``world`` gloo
    ranks, each ``body(rank, world, *args)``; the :class:`Job` holds their
    results in rank order."""
    return Job(world, body, args, tmpdir, timeout)


def run(world: int, body: str, args: tuple, tmpdir, timeout: float = 300.0) -> list:
    """:func:`start`, then wait for the results."""
    return start(world, body, args, tmpdir, timeout).results()


def _rank_main(job: str, rank: int, world: int) -> None:
    """One rank: its output to ``log<rank>.txt`` beside the job, one torch
    thread, the gloo group through the job's file store, the body, its
    result to ``out<rank>.pkl``."""
    import traceback

    base = Path(job).parent
    log = open(base / f"log{rank}.txt", "w")
    os.dup2(log.fileno(), 1)
    os.dup2(log.fileno(), 2)
    torch.set_num_threads(1)
    from deepspeed_tpu_torch import comm

    try:
        body, args = pickle.loads(Path(job).read_bytes())
        comm.init_distributed(dist_backend="gloo", init_method=f"file://{base / 'store'}",
                              rank=rank, world_size=world, verbose=False)
        try:
            out = globals()[body](rank, world, *args)
        finally:
            comm.destroy_process_group()
        (base / f"out{rank}.pkl").write_bytes(pickle.dumps(out))
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


# ---------------------------------------------------------------------------
# bodies
# ---------------------------------------------------------------------------

def collectives(rank: int, world: int, seed: int) -> dict:
    """Every collective on rank-dependent inputs from one numpy seed, and
    the comms logger's records of the calls."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel import MeshSpec

    mesh = MeshSpec(dp=-1).build_mesh()
    comm.comms_logger.configure(enabled=True)
    comm.comms_logger.reset()
    rs = np.random.RandomState(seed)
    xs = rs.standard_normal((world, 2 * world, 3 * world)).astype(np.float32)
    x = torch.from_numpy(xs[rank])
    g = mesh.group("dp")
    out = {
        "all_reduce_sum": comm.all_reduce(x.clone(), g).numpy(),
        "all_reduce_mean": comm.all_reduce(x.clone(), g, op="mean").numpy(),
        "all_reduce_max": comm.all_reduce(x.clone(), g, op="max").numpy(),
        "all_reduce_min": comm.all_reduce(x.clone(), g, op="min").numpy(),
        "all_gather_0": comm.all_gather(x, g, gather_dim=0).numpy(),
        "all_gather_1": comm.all_gather(x, g, gather_dim=1).numpy(),
        "all_gather_stack": comm.all_gather(x, g, gather_dim=0, tiled=False).numpy(),
        "reduce_scatter_0": comm.reduce_scatter(x, g, scatter_dim=0).numpy(),
        "reduce_scatter_1": comm.reduce_scatter(x, g, scatter_dim=1).numpy(),
        "all_to_all": comm.all_to_all(x, g, split_dim=0, concat_dim=1).numpy(),
        "broadcast": comm.broadcast(x.clone(), g, root=world - 1).numpy(),
        "ppermute": comm.ppermute(x, g, [(i, (i + 1) % world) for i in range(world)
                                         if i != 1]).numpy(),
        "ring_shift": comm.ring_shift(x, g, shift=-1).numpy(),
        "axis_index": comm.axis_index(g),
        "axis_size": comm.axis_size(g),
        "world_sum": comm.all_reduce(x.clone()).numpy(),
        "mesh": (mesh.shape, mesh.axis_rank("dp")),
    }
    comm.barrier(g)
    out["log"] = {k: dict(v) for k, v in comm.comms_logger.comms_dict.items()}
    comm.comms_logger.configure(enabled=False)
    comm.comms_logger.reset()
    return out


def _gpt2(dropout=0.0):
    from deepspeed_tpu_torch.models import gpt2

    return gpt2.make_module(gpt2.get_config("gpt2-tiny", dropout=dropout))


def _bert():
    from deepspeed_tpu_torch.models import bert

    return bert.make_module(bert.get_config("bert-tiny", pretraining=True))


def _gather_full_equal(eng) -> bool:
    """``runtime.zero.gather_full`` over the engine's stage-3 specs gives
    the master ``full_params`` gives."""
    from deepspeed_tpu_torch.runtime.engine import _flatten, _unflatten
    from deepspeed_tpu_torch.runtime.zero import gather_full
    from deepspeed_tpu_torch.utils.weights import tree_leaves

    specs = _unflatten([(p, () if d is None else (None,) * d + ("dp",))
                        for (p, _), d in zip(_flatten(eng.params), eng.layout.param)])
    got = gather_full(eng.params, specs, eng._dp_group)
    return all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                  tree_leaves(eng.full_params())))


def _poison(eng, leaf: tuple) -> dict:
    """This rank's loss gains a term of value 0 whose gradient overflows at
    the last element of the leaf at path ``leaf`` while ``state["on"]``:
    an fp16 overflow in that one element, which lies in the last rank's
    shard of the leaf along any dim. Returns ``state``."""
    state = {"on": False}
    fn = eng.module.loss_fn

    def loss_fn(params, batch, rng, train):
        loss, metrics = fn(params, batch, rng, train)
        if state["on"]:
            x = params
            for k in leaf:
                x = x[k]
            x = x.reshape(-1)[-1].float()
            loss = loss + (x - x.detach()) * 1e38
        return loss, metrics

    eng.module.loss_fn = loss_fn
    return state


def train(rank: int, world: int, cases: list) -> dict:
    """Each case ``(name, model, config, params, batches, opts)`` trained at
    this rank: its losses, grad norms, loss scales, the final master
    (gathered), the optimizer state's shard shapes, the comms logger's
    per-step counts and, where ``opts`` asks, checkpoints, or a gradient
    that overflows on the last rank only (``poison``: a leaf's path and the
    step, :func:`_poison`)."""
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.utils.weights import params_from_numpy, params_to_numpy, tree_map

    def host(tree):  # copies: a whole leaf is the engine's own tensor
        return tree_map(np.array, params_to_numpy(tree))

    models = {"gpt2": _gpt2, "gpt2_dropout": lambda: _gpt2(0.1), "bert": _bert}
    out = {}
    for name, model, conf, params, batches, opts in cases:
        eng, *_ = dtt.initialize(model=models[model](), config=dict(conf),
                                 model_parameters=params_from_numpy(params, "cpu"),
                                 device="cpu")
        comm.comms_logger.configure(enabled=True)
        res = {"loss": [], "grad_norm": [], "loss_scale": [], "skipped": []}
        poison = opts.get("poison")
        if poison:
            res["poison_dim"] = eng.layout.grad[eng._leaf_paths.index(poison[0])]
        state = _poison(eng, poison[0]) if poison and rank == world - 1 else {}
        for i, b in enumerate(batches):
            state["on"] = bool(poison) and i == poison[1]
            comm.comms_logger.reset()
            m = eng.train_batch(b)
            if i == 0:
                res["step_comms"] = comm.comms_logger.counts()
            for k in ("loss", "grad_norm", "loss_scale"):
                res[k].append(float(m[k]))
            res["skipped"].append(eng.skipped_steps)
        comm.comms_logger.configure(enabled=False)
        comm.comms_logger.reset()
        res["plan"] = eng.collective_plan()
        res["master"] = host(eng.full_params())
        res["gather_full_equal"] = _gather_full_equal(eng)
        res["shards"] = {k: tuple(v.shape) for k, v in eng.state_leaves().items()}
        res["memory"] = eng.memory_breakdown()
        if opts.get("save"):
            eng.save_checkpoint(opts["save"], tag="t")
            if opts.get("save_16bit"):
                eng.save_16bit_model(opts["save"])
        if opts.get("next_batch") is not None and not opts.get("load"):
            res["next_loss"] = float(eng.train_batch(opts["next_batch"])["loss"])
        if opts.get("load"):
            eng2, *_ = dtt.initialize(model=models[model](), config=dict(opts.get(
                "load_conf", conf)), device="cpu", seed=123)
            eng2.load_checkpoint(opts["load"], tag=opts.get("tag", "t"))
            res["loaded_master"] = host(eng2.full_params())
            res["after_load"] = float(eng2.train_batch(opts["next_batch"])["loss"])
        out[name] = res
    return out


def _flat_shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_shapes(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tuple(tree.shape)}


def _serve_case(eng, rank, conf, reqs, opts, tmpdir):
    """One serving case at this rank (see :func:`serve`)."""
    import json

    from deepspeed_tpu_torch.telemetry.kv_heat import KVHeatTracer
    from deepspeed_tpu_torch.telemetry.request_trace import RequestTracer

    res = {}
    if opts.get("refuse"):
        target = eng
        kw = {}
        if opts["refuse"] == "int8_weights":
            import deepspeed_tpu_torch as dtt

            target = dtt.init_inference(dtt.get_config("gpt2-tiny"), dtype=torch.float32,
                                        device="cpu", quantize_bits=8)
        if opts["refuse"] == "heat_rank0" and rank == 0:
            kw["heat_tracer"] = KVHeatTracer(str(Path(tmpdir) / "refused_heat.jsonl"))
        try:
            target.serve(conf, **kw)
        except Exception as e:  # noqa: BLE001  (the refusal is the result)
            res["error"] = (type(e).__name__, str(e))
        return res
    base = Path(tmpdir) / f"{opts.get('tag', 'case')}_r{rank}"
    base.mkdir(parents=True, exist_ok=True)
    # "solo": a request tracer, a metrics journal and stats() calls on rank 0
    # alone (they only record: the other ranks' collectives do not change)
    solo = opts.get("solo") and rank == 0
    tracer = (RequestTracer(str(base / "trace.jsonl")) if opts.get("trace") or solo
              else None)
    heat = KVHeatTracer(str(base / "heat.jsonl")) if opts.get("heat") else None
    journal = None
    if solo:
        from deepspeed_tpu_torch.telemetry.timeseries import MetricsJournal

        journal = MetricsJournal(str(base / "journal.jsonl"), interval_s=0.0)
    srv = eng.serve(conf, tracer=tracer, heat_tracer=heat, journal=journal)
    res["names"] = [p.name for p in srv.executables]
    res["expected"] = srv.expected_executables
    res["captures"] = [p.captures for p in srv.executables]
    res["gauge"] = {p.name: srv._g_tp_coll.value(program=p.name) for p in srv.executables}
    res["pools"] = {ps.placement.name: (tuple(ps.k_pool.shape), None if ps.scales is None
                                        else tuple(ps.scales.shape), ps.placement.member)
                    for ps in (srv.decode_set, srv.prefill_set)}
    res["params"] = {ps.placement.name: _flat_shapes(ps.params) if ps.params is not None
                     else None for ps in (srv.decode_set, srv.prefill_set)}
    if opts.get("drain_mid_load"):
        rs = np.random.RandomState(11)
        for i in range(12):
            srv.submit(rs.randint(0, 512, (6 + (i % 5),)).astype(np.int32),
                       max_new_tokens=8, seed=i)
        srv.step()
        srv.step()
        res["drain"] = srv.drain(deadline_s=0.0)["preempted"]
        srv.release_prefix_cache()
        srv.check_no_leaks()
        return res

    def streams(seed0=0):
        subs = [srv.submit(p, max_new_tokens=n, seed=seed0 + i) for i, (p, n) in enumerate(reqs)]
        if solo:
            while srv.queue or any(s.request is not None for s in srv.slots):
                srv.step()
                srv.stats()
        else:
            srv.run()
        return [list(r.tokens) for r in subs]

    res["streams"] = streams()
    if opts.get("demote"):
        srv.prefix_cache.evict(keep=0)
        srv.tiering.flush()
        res["spills"] = srv.tiering.spills
        if opts.get("corrupt_rank") == rank:
            # one flipped code in this rank's heads of the first host-held
            # chain root: its restore misses here and lands on the others
            store = srv.tiering.store
            key = next(k for p, _ in reqs for k in srv.prefix_cache.chain_keys(p)[:1]
                       if k in store)
            store.k_codes[store._entries[key].slot, 0, 0, 0, 0] += 1
        res["streams2"] = streams()
        res["tier"] = {k: srv.tiering.stats()[k] for k in ("restores", "crc_failures",
                                                            "restore_misses")}
    st = srv.stats()
    res["stats"] = {k: st[k] for k in ("placement", "kv_handoffs", "kv_handoff_bytes",
                                       "kv_handoff_latency_mean_s", "kv_pool_bytes",
                                       "kv_scales_bytes", "spec_steps", "chunk_prefills",
                                       "prefills", "completed") if k in st}
    if heat is not None:
        res["heat"] = {name: led.reconcile(
            srv.decode_set.allocator if name != "prefill" else srv.prefill_set.allocator,
            srv.prefix_cache if name != "decode" else None)
            for name, led in heat.ledgers.items()}
    srv.drain()
    srv.release_prefix_cache()
    srv.check_no_leaks()
    if heat is not None:
        heat.close()
    if tracer is not None:
        tracer.flush()
        recs = [json.loads(x) for x in open(tracer.file_path)]
        res["trace_records"] = len(recs)
        res["handoff_spans"] = [e for r in recs for e in r.get("events", [])
                                if e.get("e") == "kv_handoff"]
    if journal is not None:
        journal.close()
        res["journal_records"] = journal.records_emitted
    return res


def serve(rank: int, world: int, tree: dict, cases: list, tmpdir: str) -> dict:
    """Each case ``(name, n, config, requests, opts)`` served through
    ``init_inference(gpt2-tiny, tree, fp32, cpu).serve(config)`` on every
    rank (the placements take ranks ``[0, n)``; a rank past them mirrors
    the host side): the program names, captures and
    collective gauges, the placements' pool and parameter shapes, the
    greedy streams of ``requests`` ((prompt, max_new_tokens), seed = index),
    the stats' placement and handoff keys, and, where ``opts`` asks, a
    second round after demoting every prefix page to the host tier
    (``demote``; ``corrupt_rank``: a host page corrupted on that rank
    only), the heat ledgers' reconciliation (``heat``), the
    ``kv_handoff`` spans of the request trace (``trace``), a mid-load drain
    (``drain_mid_load``), the request tracer, a metrics journal and a
    ``stats()`` after every step on rank 0 alone (``solo``) or the error a
    refused config raises (``refuse``; ``heat_rank0``: a heat tracer on
    rank 0 alone). Each served engine drains leak-free."""
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.utils.weights import params_from_numpy

    eng = dtt.init_inference(dtt.get_config("gpt2-tiny"), params=params_from_numpy(tree, "cpu"),
                             dtype=torch.float32, device="cpu")
    out = {}
    for name, _n, conf, reqs, opts in cases:
        out[name] = _serve_case(eng, rank, conf, reqs, dict(opts, tag=name), tmpdir)
    return out


def fleet(rank: int, world: int, tree: dict, cases: list, tmpdir: str) -> dict:
    """Each case ``(name, config, requests, steps)`` through a
    ``FleetRouter`` over ``init_inference(gpt2-tiny, tree, fp32, cpu)`` on
    every rank, under a stepped clock: submit every request, ``steps``
    rounds, then replica r0 preempted (its live sessions migrate), then
    rounds to the end → the streams, each request's replica, the fleet's
    counters, each replica's rank window and this rank's pool heads, and
    the leak audit. Then one ``send_recv`` from rank 0 to rank 1, which
    only rank 0's comms logger records, and ``measure`` on every rank."""
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.serving import FleetRouter
    from deepspeed_tpu_torch.utils.weights import params_from_numpy

    eng = dtt.init_inference(dtt.get_config("gpt2-tiny"), params=params_from_numpy(tree, "cpu"),
                             dtype=torch.float32, device="cpu")
    clock = {"t": 0.0}
    out = {}
    for name, conf, reqs, steps in cases:
        fl = FleetRouter(eng, conf, clock=lambda: clock["t"])
        subs = [fl.submit(p, max_new_tokens=n, seed=i) for i, (p, n) in enumerate(reqs)]
        for _ in range(steps):
            fl.step()
            clock["t"] += 0.01
        live = sum(1 for s in fl.replica("r0").srv.slots
                   if s.request is not None and not s.prefilling and s.request.tokens)
        fl.preempt("r0")
        for _ in range(400):
            if fl._idle() and not fl._pending_preemption():
                break
            fl.step()
            clock["t"] += 0.01
        st = fl.stats()["fleet"]
        res = {"streams": [list(r.tokens) for r in subs], "replicas": [r.replica for r in subs],
               "status": [r.status for r in subs], "live_at_preempt": live,
               "fleet": {k: st[k] for k in ("alive", "migrations_ok", "migrations_crc_failed",
                                            "migrations_no_capacity", "migration_bytes",
                                            "requeues")},
               "windows": [r.srv.decode_placement.ranks for r in fl.replicas],
               "heads": [tuple(r.srv.k_pool.shape) for r in fl.replicas]}
        fl.drain()
        fl.check_no_leaks()
        fl.close()
        out[name] = res
    comm.comms_logger.configure(enabled=True)
    comm.comms_logger.reset()
    x = torch.full((256,), 7.0)
    y = torch.zeros_like(x)
    comm.send_recv([(x, 1)] if rank == 0 else [], [(y, 0)] if rank == 1 else [])
    comm.comms_logger.measure(iters=2)
    rec = comm.comms_logger.comms_dict.get(("send_recv", "world"))
    out["send_recv"] = {"got": float(y[0]), "row": None if rec is None else (
        rec["device"], rec["time_ms"])}
    comm.comms_logger.configure(enabled=False)
    comm.comms_logger.reset()
    return out


def sequence_tp(rank: int, world: int, attn_cases: list, train_cases: list) -> dict:
    """Sequence- and tensor-parallel cases on this rank (the bodies of
    ``tests/test_torch_sequence_parallel.py`` and
    ``tests/test_torch_train_tp.py``, one job for both).

    ``attn_cases``: ``(name, mesh, impl, causal, q, k, v)`` with whole
    ``[B, S, H, D]`` numpy inputs → this rank's output of
    ``sequence_parallel_attention`` on its shards (``shard_sequence``) and
    the gradients of ``sum(o ** 2)`` summed over the ranks' shards, placed
    back at their rows and columns (zeros elsewhere): a rank-summed
    array is the whole gradient; under ``"attn:<name>"``.

    ``train_cases``: ``(name, gpt2 overrides, config, params, batches,
    opts)`` trained through ``initialize`` at this rank → the losses, the
    grad norms, the mesh; with ``opts["grads"]`` (a batch) first the
    gradients of the training loss on it (the engine's loss under its mesh,
    its tp slices gathered whole, on rank 0) and, under ``"boundary"``,
    each ``boundary_checkpoint`` that loss made as ``[tp slices, offload]``;
    with ``opts["eval"]`` the
    eval loss after training; with ``opts["save"]`` the tag written there
    and ``full_state_leaves`` (numpy, rank 0) to hold a world-1 load
    against."""
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.parallel import MeshSpec
    from deepspeed_tpu_torch.parallel.sequence import sequence_parallel_attention, shard_sequence
    from deepspeed_tpu_torch.utils.weights import params_from_numpy

    calls = []
    boundary = gpt2.boundary_checkpoint

    def recording(fn, params, h, partition=None, offload=False, slot=None):
        calls.append([partition[2] if partition is not None else 1, bool(offload)])
        return boundary(fn, params, h, partition=partition, offload=offload, slot=slot)

    gpt2.boundary_checkpoint = recording
    out = {}
    for name, mesh_shape, impl, causal, *qkv in attn_cases:
        mesh = MeshSpec(**mesh_shape).build_mesh()
        loc = [torch.from_numpy(np.asarray(shard_sequence(x, mesh))).requires_grad_(True)
               for x in qkv]
        o = sequence_parallel_attention(*loc, mesh, impl=impl, causal=causal)
        (o.float() ** 2).sum().backward()
        grads = []
        for x, t in zip(qkv, loc):
            g = np.zeros(np.asarray(x).shape, np.float32)
            B, S = t.shape[:2]
            b0 = mesh.axis_rank("dp") * B if mesh.size("dp") > 1 else 0
            s0 = mesh.axis_rank("sp") * S
            g[b0:b0 + B, s0:s0 + S] = t.grad.numpy()
            grads.append(g)
        out[f"attn:{name}"] = {"o": o.detach().numpy(), "grads": grads,
                     "coords": (mesh.axis_rank("dp"), mesh.axis_rank("sp"))}
    for name, overrides, conf, params, batches, opts in train_cases:
        cfg = gpt2.get_config("gpt2-tiny", **overrides)
        eng, *_ = dtt.initialize(model=gpt2.make_module(cfg), config=dict(conf),
                                 model_parameters=params_from_numpy(params, "cpu"),
                                 device="cpu")
        res = {"loss": [], "grad_norm": [], "mesh": dict(eng.mesh.shape)}
        if opts.get("grads") is not None:
            calls.clear()
            res["grads"] = _engine_grads(eng, opts["grads"], rank)
            res["boundary"] = list(calls)
        for b in batches:
            m = eng.train_batch(b)
            res["loss"].append(float(m["loss"]))
            res["grad_norm"].append(float(m["grad_norm"]))
        if opts.get("eval") is not None:
            res["eval"] = float(eng.eval_batch(opts["eval"]))
        if opts.get("save"):
            eng.save_checkpoint(opts["save"], tag="t")
            full = eng.full_state_leaves()
            if rank == 0:
                res["state"] = {k: v.detach().numpy().copy() for k, v in full.items()}
        out[name] = res
    gpt2.boundary_checkpoint = boundary
    return out


def _engine_grads(eng, batch, rank: int):
    """The gradient of ``eng``'s training loss (fp32, one micro-batch, no
    key) at its parameters, each tp slice gathered whole → numpy by leaf
    path on rank 0, None elsewhere."""
    from deepspeed_tpu_torch.parallel.topology import active_mesh
    from deepspeed_tpu_torch.runtime.engine import _unflatten
    from deepspeed_tpu_torch.utils.weights import tree_leaves

    leaves = [p.detach().clone().requires_grad_(True) for p in tree_leaves(eng.params)]
    micro = {k: torch.from_numpy(a[0]) for k, a in
             ((p[0], a) for p, a in eng._host_batch(batch))}
    micro["__norm__"] = torch.from_numpy(eng._host_batch(batch, norms=True)[1][0])
    with active_mesh(eng.mesh):
        loss, _ = eng.module.loss_fn(_unflatten(list(zip(eng._leaf_paths, leaves))), micro,
                                     None, True)
        grads = torch.autograd.grad(loss, leaves)
    whole = [eng._tp_whole(g, plan) for g, plan in zip(grads, eng._tp_plan)]
    if rank != 0:
        return None
    return {"/".join(p): g.numpy() for p, g in zip(eng._leaf_paths, whole)}
