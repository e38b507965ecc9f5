"""The port's ``comm/`` and ``parallel/`` against the JAX package's, on the
CPU: the topology's rank arithmetic case for case with
``tests/unit/test_topology.py``; every collective on 2 and on 4 gloo ranks
(one spawn each, ``tests/torch_dist.py``) against numpy, with the comms
logger's op names, byte counts and group sizes against JAX's
``CommsLogger`` for the same calls under ``shard_map`` on a dp mesh of the
CPU devices; ``init_distributed``'s discovery and its refusals.

The collectives move float32 values and sum in a fixed order: sums are
held to 1e-6 relative, everything else bit for bit."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.comm.comm as jcomm
from deepspeed_tpu.comm import xla as jxla
from deepspeed_tpu.parallel import topology as jtopo
from deepspeed_tpu.utils.compat import shard_map
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.parallel import topology as ttopo
from deepspeed_tpu_torch.runtime.config import NotPortedError
from jax.sharding import PartitionSpec as P

from tests import torch_dist
from tests.torch_threads import one_torch_thread  # noqa: F401

SEED = 11


# ---------------------------------------------------------------------------
# topology (no ranks)
# ---------------------------------------------------------------------------

def _topologies(mod):
    return [
        mod.ProcessTopology(axes=["row", "col"], dims=[2, 2]),
        mod.PipeModelDataParallelTopology(num_pp=2, num_mp=2, num_dp=2),
        mod.PipeModelDataParallelTopology(num_pp=2, num_mp=2, num_dp=1),
        mod.PipeDataParallelTopology(num_pp=3, num_dp=2),
        mod.ProcessTopology(axes=["pp", "dp", "ep", "tp"], dims=[2, 3, 1, 2]),
    ]


@pytest.mark.parametrize("i", range(5))
def test_topology_matches_jax(i):
    j, t = _topologies(jtopo)[i], _topologies(ttopo)[i]
    assert t.axes == j.axes and t.dims == j.dims and t.world_size() == j.world_size()
    assert t.mapping == j.mapping
    for r in range(j.world_size()):
        assert tuple(t.get_coord(r)) == tuple(j.get_coord(r))
        assert t.get_rank(**t.get_coord(r)._asdict()) == r
        assert t.get_rank_repr(r) == j.get_rank_repr(r)
    for ax in j.axes:
        assert t.get_axis_comm_lists(ax) == j.get_axis_comm_lists(ax)
        for v in range(j.get_dim(ax)):
            assert t.get_axis_list(ax, v) == j.get_axis_list(ax, v)
            assert t.filter_match(**{ax: v}) == j.filter_match(**{ax: v})
    assert t.get_axis_comm_lists("nope") == j.get_axis_comm_lists("nope") == []


def test_topology_unit_cases():
    """tests/unit/test_topology.py's grid cases, on the port's classes."""
    topo = ttopo.ProcessTopology(axes=["row", "col"], dims=[2, 2])
    assert [topo.get_rank(row=a, col=b) for a in (0, 1) for b in (0, 1)] == [0, 1, 2, 3]
    assert topo.get_coord(2) == topo.ProcessCoord(row=1, col=0)
    topo = ttopo.PipeModelDataParallelTopology(num_pp=2, num_mp=2, num_dp=2)
    assert topo.get_axis_list("pp", 1) == [4, 5, 6, 7]
    assert [0, 1] in topo.get_axis_comm_lists("tp") and topo.filter_match(pp=1, dp=0) == [4, 5]
    assert ttopo.PipeModelDataParallelTopology(2, 2, 1).get_rank_repr(0) == "tp_00"


@pytest.mark.parametrize("spec,n", [({"dp": -1, "tp": 2}, 8), ({"dp": 2, "tp": 2, "pp": 2}, 8),
                                    ({"dp": -1}, 4), ({"dp": 1}, 1), ({"dp": -1, "sp": 2}, 8)])
def test_mesh_spec_resolve_matches_jax(spec, n, devices):
    j = jtopo.MeshSpec(**spec, devices=devices[:n]).resolve()
    t = ttopo.MeshSpec(**spec, devices=list(range(n))).resolve()
    assert (t.axes, t.dims) == (j.axes, j.dims)
    with pytest.raises(AssertionError):
        ttopo.MeshSpec(dp=3, tp=2, devices=list(range(8))).resolve()


def test_process_groups_refuse_other_axes_and_dp_alone():
    """The dp, sp and tp axes are ported: pp and ep > 1 name their items,
    sp and tp > 1 need as many ranks as they cover; dp without a process
    group is one rank and no groups."""
    for axis, item in (("pp", "12b"), ("ep", "12d")):
        with pytest.raises(NotPortedError, match=f"item {item}"):
            ttopo.ProcessTopology(axes=["dp", axis], dims=[1, 2]).get_mesh()
    for axis in ("tp", "sp"):
        with pytest.raises(ValueError, match="covers 2 ranks"):
            ttopo.ProcessTopology(axes=["dp", axis], dims=[1, 2]).get_mesh()
    mesh = ttopo.MeshSpec(dp=-1).build_mesh()
    assert not mesh.distributed and mesh.shape == {"dp": 1} and mesh.axis_rank("dp") == 0
    assert ttopo.mesh_axis_size(mesh, "dp") == 1 and ttopo.dp_axis_names(mesh) == ("dp",)
    with pytest.raises(ValueError, match="covers 2 ranks"):
        ttopo.ProcessTopology(["dp"], [2]).get_mesh()


# ---------------------------------------------------------------------------
# collectives on 2 and 4 gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ranks(request, tmp_path_factory):
    world = request.param
    return world, torch_dist.start(world, "collectives", (SEED,),
                                 tmp_path_factory.mktemp(f"comm{world}"))


def _inputs(world):
    rs = np.random.RandomState(SEED)
    return rs.standard_normal((world, 2 * world, 3 * world)).astype(np.float32)


def _expected(world):
    xs = _inputs(world)
    n = world
    out = []
    for r in range(world):
        ring = {(i, (i + 1) % n) for i in range(n) if i != 1}
        src = [s for s, d in ring if d == r]
        out.append({
            "all_reduce_sum": xs.sum(0),
            "all_reduce_mean": xs.sum(0) / n,
            "all_reduce_max": xs.max(0),
            "all_reduce_min": xs.min(0),
            "all_gather_0": np.concatenate(list(xs), 0),
            "all_gather_1": np.concatenate(list(xs), 1),
            "all_gather_stack": xs,
            "reduce_scatter_0": np.split(xs.sum(0), n, 0)[r],
            "reduce_scatter_1": np.split(xs.sum(0), n, 1)[r],
            "all_to_all": np.concatenate([np.split(xs[j], n, 0)[r] for j in range(n)], 1),
            "broadcast": xs[n - 1],
            "ppermute": xs[src[0]] if src else np.zeros_like(xs[r]),
            "ring_shift": xs[(r + 1) % n],
            "axis_index": r,
            "axis_size": n,
            "world_sum": xs.sum(0),
            "mesh": ({"dp": n}, r),
        })
    return out


_SUMS = ("all_reduce_sum", "all_reduce_mean", "reduce_scatter_0", "reduce_scatter_1",
         "world_sum")


def test_collectives_match_numpy(ranks):
    world, got = ranks
    for r, (g, e) in enumerate(zip(got, _expected(world))):
        for k, want in e.items():
            if k in _SUMS:
                np.testing.assert_allclose(g[k], want, rtol=1e-6, atol=1e-6,
                                           err_msg=f"rank {r} {k}")
            elif isinstance(want, np.ndarray):
                np.testing.assert_array_equal(g[k], want, err_msg=f"rank {r} {k}")
            else:
                assert g[k] == want, (r, k)


def _jax_log(world, devices):
    """JAX's comms logger after the same calls, traced under shard_map over
    a dp mesh of ``world`` CPU devices on the same per-rank shapes."""
    mesh = jtopo.MeshSpec(dp=world, devices=devices[:world]).build_mesh()
    x = jnp.asarray(_inputs(world).reshape(-1, 3 * world))

    def body(v):
        outs = [jxla.all_reduce(v, "dp"), jxla.all_reduce(v, "dp", op="mean"),
                jxla.all_reduce(v, "dp", op="max"), jxla.all_reduce(v, "dp", op="min"),
                jxla.all_gather(v, "dp", gather_dim=0), jxla.all_gather(v, "dp", gather_dim=1),
                jxla.all_gather(v, "dp", gather_dim=0, tiled=False),
                jxla.reduce_scatter(v, "dp", scatter_dim=0),
                jxla.reduce_scatter(v, "dp", scatter_dim=1),
                jxla.all_to_all(v, "dp", split_dim=0, concat_dim=1),
                jxla.broadcast(v, "dp", root=world - 1),
                jxla.ppermute(v, "dp", [(i, (i + 1) % world) for i in range(world) if i != 1]),
                jxla.ring_shift(v, "dp", shift=-1, axis_size=world)]
        return sum(o.sum() for o in outs)

    jcomm.comms_logger.reset()
    jcomm.comms_logger.configure(enabled=True)
    try:
        jax.jit(shard_map(body, mesh=mesh, in_specs=(P("dp"),), out_specs=P(),
                          check_vma=False))(x)
        return {k: dict(v) for k, v in jcomm.comms_logger.comms_dict.items()}
    finally:
        jcomm.comms_logger.reset()
        jcomm.comms_logger.configure(enabled=False)


def test_comms_logger_records_match_jax(ranks, devices):
    """The same op names, counts, bytes and group sizes as JAX's logger
    (the port's records of the default group's sum aside, under "world")."""
    world, got = ranks
    want = _jax_log(world, devices)
    for r, g in enumerate(got):
        log = dict(g["log"])
        assert log.pop(("all_reduce", "world"))["count"] == 1
        assert log.keys() == want.keys(), (r, sorted(log), sorted(want))
        for key, rec in want.items():
            for f in ("count", "bytes", "wire_bytes", "world"):
                assert log[key][f] == rec[f], (r, key, f, log[key][f], rec[f])


def test_logger_summary_and_measure_columns():
    """``log_summary`` keeps JAX's columns; ``measure`` fills the latency of
    the rows it can run (one rank here)."""
    comm.init_distributed(dist_backend="gloo", verbose=False)
    try:
        comm.comms_logger.configure(enabled=True)
        comm.comms_logger.reset()
        comm.all_reduce(torch.ones(1024))
        comm.all_gather(torch.ones(8, 4), gather_dim=1)
        rec = comm.comms_logger.comms_dict[("all_reduce", "world")]
        assert rec == {"count": 1, "bytes": 4096, "wire_bytes": 4096, "time_ms": None,
                       "world": 1, "device": "cpu"}
        est = comm.log_summary()
        assert "~" in est and est.splitlines()[1].split() == [
            "op", "axis", "count", "world", "msg", "size", "wire", "size", "ratio", "avg",
            "lat(ms)", "algbw(GB/s)", "busbw(GB/s)"]
        comm.comms_logger.measure()
        assert all(r["time_ms"] > 0 for r in comm.comms_logger.comms_dict.values())
        assert "~" not in comm.log_summary().split("\n", 2)[2]
        assert comm.comms_logger._bus_factor("all_reduce", 4) == jcomm.CommsLogger._bus_factor(
            "all_reduce", 4) == 1.5
    finally:
        comm.comms_logger.configure(enabled=False)
        comm.comms_logger.reset()
        comm.destroy_process_group()
    assert not comm.is_initialized() and not torch.distributed.is_initialized()


def test_measure_runs_on_the_recorded_device(monkeypatch):
    """``measure`` times each row on the device its recorded tensors lay
    on (a CUDA tensor handed to gloo is timed as a CUDA tensor, with the
    host staging the program paid), ``device=`` overrides it, and a
    ``send_recv`` row is kept apart: at one rank it has no peer and stays
    unmeasured (the ring at two ranks is timed in
    ``tests/test_torch_fleet_placement.py``)."""
    from deepspeed_tpu_torch.comm import torch as ctorch

    comm.init_distributed(dist_backend="gloo", verbose=False)
    seen = []

    def spy(x, group=None, op="sum"):
        seen.append(x.device.type)
        return x

    try:
        comm.comms_logger.configure(enabled=True)
        comm.comms_logger.reset()
        comm.all_reduce(torch.ones(256))
        comm.send_recv([], [])
        comm.comms_logger.append("send_recv", "world", 1024, world=1, device="cpu")
        assert comm.comms_logger.comms_dict[("all_reduce", "world")]["device"] == "cpu"
        # a row recorded from tensors on another device is timed there
        comm.comms_logger.comms_dict[("all_reduce", "world")]["device"] = "meta"
        monkeypatch.setattr(ctorch, "all_reduce", spy)
        comm.comms_logger.measure(iters=2)
        assert seen == ["meta"] * 3
        seen.clear()
        comm.comms_logger.measure(iters=2, device="cpu")
        assert seen == ["cpu"] * 3
        assert comm.comms_logger.comms_dict[("all_reduce", "world")]["time_ms"] > 0
        assert comm.comms_logger.comms_dict[("send_recv", "world")]["time_ms"] is None
    finally:
        comm.comms_logger.configure(enabled=False)
        comm.comms_logger.reset()
        comm.destroy_process_group()


# ---------------------------------------------------------------------------
# process-level init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("env,world,rank", [
    ({}, 1, 0),
    ({"RANK": "0", "WORLD_SIZE": "1"}, 1, 0),
    ({"OMPI_COMM_WORLD_RANK": "0", "OMPI_COMM_WORLD_SIZE": "1"}, 1, 0),
])
def test_init_distributed_discovery(env, world, rank, monkeypatch, tmp_path):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "OMPI_COMM_WORLD_RANK",
              "OMPI_COMM_WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    comm.init_distributed(dist_backend="gloo", verbose=False,
                          init_method=None if not env else f"file://{tmp_path}/store")
    try:
        assert comm.is_initialized()
        assert comm.get_world_size() == world and comm.get_rank() == rank
        assert torch.distributed.get_backend() == "gloo"
        assert comm.get_local_rank() == 0
    finally:
        comm.destroy_process_group()
    assert comm.get_world_size() == 1 and not comm.is_initialized()


def test_nccl_needs_the_card_and_never_falls_back():
    """No silent fallback from NCCL to gloo, nor from the card to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is what the CPU shows")
    with pytest.raises(RuntimeError, match="CUDA"):
        comm.init_distributed(verbose=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        comm.TorchBackend("nccl").init_process_group()
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError):
        comm.TorchBackend("mpi")


def test_engine_needs_its_process_group():
    """An engine asked for dp > 1 without a process group raises: it does
    not quietly train at dp 1; gloo ranks cannot drive the card."""
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models import gpt2

    model = gpt2.make_module(gpt2.get_config("gpt2-tiny"))
    with pytest.raises(RuntimeError, match="init_distributed"):
        dtt.initialize(model=model, config={"train_batch_size": 4, "mesh": {"dp": 2},
                                            "zero_optimization": {"stage": 2}}, device="cpu")
    assert os.environ.get("WORLD_SIZE", "1") == "1"
