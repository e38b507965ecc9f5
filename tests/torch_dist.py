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
