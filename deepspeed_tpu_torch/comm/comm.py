"""``deepspeed_tpu_torch.comm`` façade: the collectives, process-level init
and the comms logger (counterpart of ``deepspeed_tpu/comm/comm.py``).

The collectives (``torch.py``) take a process group where JAX's take a
mesh-axis name, and each records its input's bytes in :data:`comms_logger`
when it runs: eagerly, or while a training step is captured (a replay
records nothing, as a compiled JAX program's trace-time records are taken
once). ``init_distributed`` discovers the world as JAX's does: arguments,
then ``MASTER_ADDR``/``MASTER_PORT``, then ``RANK``/``WORLD_SIZE``, then
OpenMPI's ``OMPI_COMM_WORLD_*``; with none of these set it makes a
single-process world-1 group. JAX's ``record_from_compiled`` parses XLA's
compiled HLO, which has no counterpart here (the port issues every
collective through the wrappers, so their records are the whole mix).
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..utils.logging import log_dist
from .backend import Backend
from .torch import (  # noqa: F401  (re-exported primitives)
    TorchBackend,
    all_gather,
    all_reduce,
    all_to_all,
    axis_index,
    axis_size,
    barrier,
    broadcast,
    group_name,
    name_group,
    ppermute,
    reduce_scatter,
    ring_shift,
    send_recv,
    subgroup,
)

cdb: Optional[Backend] = None  # "communication data backend", the reference's name


class CommsLogger:
    """Per-call collective accounting (reference utils/comms_logging.py:56):
    ``(op, axis)`` → count, logical bytes, wire bytes, measured latency and
    the group's size."""

    def __init__(self, enabled: bool = False, verbose: bool = False, prof_all: bool = True,
                 debug: bool = False):
        self.enabled = enabled
        self.verbose = verbose
        self.prof_all = prof_all
        self.debug = debug
        self.comms_dict = {}

    def configure(self, enabled=None, verbose=None, prof_all=None, debug=None):
        if enabled is not None:
            self.enabled = enabled
        if verbose is not None:
            self.verbose = verbose
        if prof_all is not None:
            self.prof_all = prof_all
        if debug is not None:
            self.debug = debug

    def append(self, op_name: str, axis, nbytes: int, wire_bytes: Optional[int] = None,
               world: Optional[int] = None, device: Optional[str] = None):
        """Record one collective: ``nbytes`` is the logical payload,
        ``wire_bytes`` the on-wire volume (``nbytes`` unless a compressed
        layer shrank it), ``world`` the group's size, ``device`` the type of
        the device its tensor lay on (``"cuda"`` or ``"cpu"``), which
        :meth:`measure` times on."""
        if not self.enabled:
            return
        key = (op_name, str(axis))
        rec = self.comms_dict.setdefault(
            key, {"count": 0, "bytes": 0, "wire_bytes": 0, "time_ms": None, "world": None,
                  "device": None}
        )
        rec["count"] += 1
        rec["bytes"] += nbytes
        rec["wire_bytes"] += wire_bytes if wire_bytes is not None else nbytes
        if rec["world"] is None and world is not None:
            rec["world"] = int(world)
        if rec["device"] is None and device is not None:
            rec["device"] = str(device)
        if self.verbose:
            log_dist(f"comm op: {op_name} | axis: {axis} | bytes: {nbytes}")

    # busbw correction factors per ring algorithm (reference
    # utils/comms_logging.py get_bw: allreduce moves 2(n-1)/n of the payload,
    # all_gather / reduce_scatter / all_to_all move (n-1)/n)
    @staticmethod
    def _bus_factor(op: str, n: int) -> float:
        if n <= 1:
            return 1.0
        if op == "all_reduce":
            return 2.0 * (n - 1) / n
        if op in ("all_gather", "reduce_scatter", "all_to_all"):
            return (n - 1) / n
        return 1.0

    def measure(self, groups: Optional[Dict[str, object]] = None, iters: int = 5,
                device=None) -> None:
        """Fill the measured latency of every recorded ``(op, axis)`` by
        running that collective ``iters`` times at the recorded per-call
        size on the axis's group (``groups``: axis name → process group;
        ``"world"`` is the default group) and timing it. It runs on the
        device the recorded tensors lay on (``device`` overrides), so a
        CUDA tensor handed to gloo is timed with gloo's host staging, as
        the program ran it: CUDA events on an NCCL group, the wall clock
        around a synchronised run otherwise. ``send_recv`` is timed as a
        ring (each rank sends to the next and receives from the one
        before); a group of one rank has no peer and leaves it unmeasured.
        Collective over each group: its ranks first agree on the rows any
        of them recorded (a ``send_recv`` is recorded by its sender only)
        and each row's largest per-call size, then every rank runs every
        row. The measurement records nothing."""
        from . import torch as _t

        groups = dict(groups or {})
        groups.setdefault("world", None)
        default = "cuda" if dist.get_backend() == "nccl" else "cpu"

        def _a2a(x, g):
            return _t.all_to_all(x, g, split_dim=0, concat_dim=0)

        def _ring(x, g):
            ranks = dist.get_process_group_ranks(g) if g is not None else list(
                range(dist.get_world_size()))
            i = ranks.index(dist.get_rank())
            _t.send_recv([(x, ranks[(i + 1) % len(ranks)])],
                         [(torch.empty_like(x), ranks[i - 1])], g)

        fns = {
            "all_reduce": lambda x, g: _t.all_reduce(x, g),
            "all_gather": lambda x, g: _t.all_gather(x, g),
            "reduce_scatter": lambda x, g: _t.reduce_scatter(x, g),
            "all_to_all": _a2a,
            "broadcast": lambda x, g: _t.broadcast(x, g),
            "ppermute": lambda x, g: _t.ring_shift(x, g),
            "send_recv": _ring,
        }
        prev_enabled, self.enabled = self.enabled, False
        try:
            for axis in sorted(groups):
                g = groups[axis]
                n = dist.get_world_size(g)
                mine = {op: max(4, (rec.get("wire_bytes") or rec["bytes"])
                                // max(1, rec["count"]))
                        for (op, ax), rec in self.comms_dict.items() if ax == axis and op in fns}
                every = [None] * n
                dist.all_gather_object(every, mine, group=g)
                rows: Dict[str, int] = {}
                for d in every:
                    for op, per_call in d.items():
                        rows[op] = max(rows.get(op, 0), per_call)
                for op in sorted(rows):
                    if op == "send_recv" and n < 2:
                        continue
                    rec = self.comms_dict.get((op, axis))
                    dev = torch.device(device if device is not None else
                                       ((rec or {}).get("device") or default))
                    nelem = -(-max(1, rows[op] // 4) // n) * n  # divisible by the group
                    x = torch.zeros((nelem,), dtype=torch.float32, device=dev)
                    fn = fns[op]
                    fn(x, g)  # warm-up (the communicator's first use)
                    if dev.type == "cuda" and dist.get_backend(g) == "nccl":
                        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                            enable_timing=True)
                        t0.record()
                        for _ in range(iters):
                            fn(x, g)
                        t1.record()
                        t1.synchronize()
                        ms = t0.elapsed_time(t1) / iters
                    else:
                        if dev.type == "cuda":
                            torch.cuda.synchronize(dev)
                        t = time.perf_counter()
                        for _ in range(iters):
                            fn(x, g)
                        if dev.type == "cuda":
                            torch.cuda.synchronize(dev)
                        ms = (time.perf_counter() - t) / iters * 1e3
                    if rec is not None:
                        rec["time_ms"] = ms
                        rec["world"] = n
        finally:
            self.enabled = prev_enabled

    # a nominal bus bandwidth (GB/s) to ESTIMATE the latency of rows that
    # were recorded but never measured ("~"-prefixed columns): the H100
    # SXM's NVLink 4 rate in one direction, its published figure;
    # DS_COMM_ASSUMED_BUSBW_GBPS overrides it
    ASSUMED_BUSBW_GBPS = 450.0

    @classmethod
    def _assumed_busbw_gbps(cls) -> float:
        env = os.environ.get("DS_COMM_ASSUMED_BUSBW_GBPS")
        return float(env) if env else cls.ASSUMED_BUSBW_GBPS

    def log_summary(self) -> str:
        """The reference's per-op table (op, axis, count, world, message
        size, wire size, ratio, average latency, algbw, busbw), JAX's
        columns: measured rows (after :meth:`measure`) exact, the others
        "~"-prefixed estimates from the nominal bus bandwidth. Returns the
        rendered text (also logged)."""
        lines = ["Communication summary (per traced step):"]
        header = (
            f"  {'op':<16s}{'axis':<10s}{'count':>6s}{'world':>7s}{'msg size':>12s}"
            f"{'wire size':>12s}{'ratio':>7s}"
            f"{'avg lat(ms)':>13s}{'algbw(GB/s)':>13s}{'busbw(GB/s)':>13s}"
        )
        lines.append(header)
        for (op, axis), rec in sorted(self.comms_dict.items()):
            per_call = rec["bytes"] / max(1, rec["count"])
            wire_total = rec.get("wire_bytes") or rec["bytes"]
            wire_call = wire_total / max(1, rec["count"])
            ratio = rec["bytes"] / wire_total if wire_total else 1.0
            lat = rec.get("time_ms")
            world = rec.get("world")
            factor = self._bus_factor(op, world or 1)
            if lat:
                algbw = wire_call / (lat / 1e3) / 1e9
                busbw = algbw * factor
                lat_s, alg_s, bus_s = f"{lat:.3f}", f"{algbw:.2f}", f"{busbw:.2f}"
            elif wire_call > 0:
                bw = self._assumed_busbw_gbps() * 1e9
                est_lat_s = max(wire_call * factor / bw, 1e-9)
                algbw = wire_call / est_lat_s / 1e9
                lat_s = f"~{est_lat_s * 1e3:.3f}"
                alg_s = f"~{algbw:.2f}"
                bus_s = f"~{algbw * factor:.2f}"
            else:
                lat_s = alg_s = bus_s = "-"
            lines.append(
                f"  {op:<16s}{axis:<10s}{rec['count']:>6d}"
                f"{world if world else '-':>7}{per_call / 1e6:>10.2f}MB"
                f"{wire_call / 1e6:>10.2f}MB{ratio:>6.2f}x"
                f"{lat_s:>13s}{alg_s:>13s}{bus_s:>13s}"
            )
        text = "\n".join(lines)
        log_dist(text)
        return text

    def counts(self) -> Dict[str, int]:
        """Calls recorded by op, summed over the axes."""
        out: Dict[str, int] = {}
        for (op, _), rec in self.comms_dict.items():
            out[op] = out.get(op, 0) + rec["count"]
        return out

    def reset(self):
        self.comms_dict = {}


comms_logger = CommsLogger()


def configure(config=None, enabled=None, verbose=None, prof_all=None, debug=None):
    """Analog of reference comm.py:82: the config's ``comms_logger``
    section, then the keyword overrides."""
    if config is not None and getattr(config, "comms_logger", None) is not None:
        c = config.comms_logger
        comms_logger.configure(c.enabled, c.verbose, c.prof_all, c.debug)
    comms_logger.configure(enabled, verbose, prof_all, debug)


def record(op_name: str, axis, tensor, world: Optional[int] = None) -> None:
    """Account one collective over ``axis`` (a name; ``world`` its group's
    size) on ``tensor``."""
    try:
        nbytes = int(tensor.numel()) * tensor.element_size()
    except AttributeError:
        nbytes = 0
    device = getattr(getattr(tensor, "device", None), "type", None)
    comms_logger.append(op_name, axis, nbytes, world=world, device=device)


def log_summary():
    return comms_logger.log_summary()


# ---------------------------------------------------------------------------
# process-level init
# ---------------------------------------------------------------------------

def is_initialized() -> bool:
    return cdb is not None and cdb.is_initialized()


def _env_int(*names: str) -> Optional[int]:
    for n in names:
        if n in os.environ:
            return int(os.environ[n])
    return None


def init_distributed(
    dist_backend: Optional[str] = None,
    auto_mpi_discovery: bool = True,
    distributed_port: int = 29500,
    verbose: bool = True,
    timeout=None,
    init_method: Optional[str] = None,
    dist_init_required: Optional[bool] = None,
    config=None,
    rank: int = -1,
    world_size: int = -1,
) -> None:
    """Initialize the process group (reference comm/comm.py:577).
    ``dist_backend``: ``"nccl"`` (the default, which needs the card) or
    ``"gloo"`` (the CPU). Discovery: the arguments, then
    ``MASTER_ADDR``/``MASTER_PORT`` (``distributed_port`` when the port is
    unset), then ``RANK``/``WORLD_SIZE``, then OpenMPI's
    ``OMPI_COMM_WORLD_RANK``/``SIZE`` (with ``auto_mpi_discovery``); with
    none of them a single-process world-1 group. ``init_method`` may be a
    ``tcp://`` address or a ``file://`` store."""
    global cdb
    if is_initialized():
        return
    configure(config=config)
    backend = TorchBackend(dist_backend or "nccl")
    if init_method is None and "MASTER_ADDR" in os.environ:
        port = os.environ.get("MASTER_PORT", str(distributed_port))
        init_method = f"tcp://{os.environ['MASTER_ADDR']}:{port}"
    mpi = ("OMPI_COMM_WORLD_SIZE",) if auto_mpi_discovery else ()
    if world_size < 0:
        world_size = _env_int("WORLD_SIZE", *mpi) or 1
    if rank < 0:
        found = _env_int("RANK", *(("OMPI_COMM_WORLD_RANK",) if auto_mpi_discovery else ()))
        rank = 0 if found is None else found
    if backend.name == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: the nccl backend needs a CUDA device and "
                               "none is available; pass dist_backend='gloo' for CPU ranks")
        torch.cuda.set_device(get_local_rank() % torch.cuda.device_count())
    if dist.is_initialized():
        # a group made by the caller (torchrun + init_process_group)
        backend.world_size, backend.world_rank = dist.get_world_size(), dist.get_rank()
        backend.initialized = True
    else:
        backend.init_process_group(init_method=init_method, world_size=world_size, rank=rank,
                                   timeout=timeout)
    cdb = backend
    if verbose:
        log_dist(f"Initialized distributed: backend={backend.name} "
                 f"world_size={backend.world_size} rank={backend.world_rank}")


def get_world_size(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def get_rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def get_local_rank() -> int:
    v = _env_int("LOCAL_RANK", "OMPI_COMM_WORLD_LOCAL_RANK")
    return 0 if v is None else v


def destroy_process_group():
    global cdb
    if cdb is not None:
        cdb.destroy_process_group()
        cdb = None
