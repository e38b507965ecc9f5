"""DeepSpeedEngine — the training engine (counterpart of
``deepspeed_tpu/runtime/engine.py`` ``DeepSpeedEngine`` on a dp mesh, ZeRO
stages 0-3).

The JAX engine compiles the whole step into one XLA program
(``_make_train_step``, engine.py:1106-1345, jitted at :577) and the eval
step into another (:583). Here each is a :class:`~..utils.graphs.CapturedProgram`:
on the card a CUDA graph captured from the step function and replayed
(the first call runs it eagerly on the capture stream), on the CPU the
same function run directly. There is one program per batch signature
(leaf names, shapes and dtypes), as JAX's jit cache holds one executable
per trace; ``jit_step_cache_size`` counts the training programs. The step,
in the JAX step's order:

1. the fp32 master is cast once per step to the compute dtype;
2. over ``gas`` micro-batches, ``torch.autograd`` takes the compute-dtype
   gradients of the scaled loss (the flash kernels' Function is its
   attention), divided by ``gradient_predivide_factor`` under
   ``prescale_gradients``, cast to ``grad_accum_dtype`` and accumulated;
3. the sum is unscaled by ``1 / (scale * gas)`` in f32 (and the predivide
   multiplied back);
4. fp16 only: an overflow (a non-finite leaf) zeroes the gradients;
5. the global norm is taken and the gradients clipped by
   ``clip / (gnorm + 1e-6)``;
6. the optimizer (optax's math; the Adam and Lamb families through the
   fused kernel on the card) updates the master in place, with the
   overflow flag as its skip flag: a skipped step leaves params, moments
   and the optimizer count bit for bit; the loss scaler updates either
   way, and the device counts of applied and skipped steps advance.

Everything a step reads that changes from step to step lives on the
device: the loss-scale state (four scalars, ``fp16/loss_scaler.py``), the
optimizer's count, the learning rate (the schedule's tensor form of the
count), the overflow flag, and the step's dropout keys. The step reads
nothing on the host. ``train_batch`` returns JAX's metrics as 0-d device
tensors; the host reads them at the ``steps_per_print`` cadence, on a
telemetry-sampled step and, with the watchdog on, for its flags.

The random keys follow the JAX engine's schedule, derived on the host: the
engine key is ``PRNGKey(seed + 1)``; a step's key is ``fold_in(rng,
global_step + skipped_steps)``, which is the count of training steps run,
known on the host without a read; micro-batch i's is ``fold_in(step_key,
i)``, and the model's ``key_table`` expands it to every key its loss draws
(GPT-2: the embedding's and each layer's dropout keys). The step's tables
go up with the batch, in one copy, and each dropout reads its slot on the
device. ``eval_batch`` without a key splits the engine key, and ``forward``
evaluates under ``fold_in(rng, 0x5EED)``, leaving the training stream
untouched.

Sequence and tensor parallelism (the ``mesh`` section's ``sp`` and ``tp``
axes, JAX's GSPMD placements made explicit). The engine's mesh is the
model's while a step runs (``parallel.topology.active_mesh``). Under sp
each rank takes its columns of every leaf's sequence dim (dim 1), after the
model's ``seq_labels`` shifted the labels on the whole host batch (the
``"__labels__"`` leaf); parameters are replicated over sp, so their
gradients and the loss sum over sp before ZeRO's dp reduction, and each
dropout draws the rank's rows and columns of JAX's global draw (a ``[6]``
key: ``prng.shard_key`` with a row stride). Under tp each rank holds its
slices of the leaves the model's ``logical_axes`` put on tp
(``runtime.zero.partitioning.logical_to_spec``; the fused QKV regrouped so
a slice is its heads' ``[Q | K | V]``), and ZeRO partitions those slices
over dp; the model runs Megatron's column/row-parallel pair. The norm sums
the tp slices' squares over tp (a replicated leaf counted once), the fp16
overflow is a MAX over tp too, and a checkpoint gathers the slices into
whole leaves, so a tag is mesh-independent. On the card over NCCL the step
is captured with its collectives; over gloo (ranks sharing one card) it
runs eagerly, since a CUDA graph cannot hold gloo's calls.

Data parallelism and ZeRO (JAX engine.py:102-143, ``runtime/zero/``): with
a process group (``comm.init_distributed``) the ``mesh`` section's ``dp``
axis is its ranks (``parallel/topology.py`` ``ProcessGroups``), one
process a rank, and without one the engine trains alone and communicates
nothing. Every rank takes the global host batch, as JAX's single
controller does, and keeps its rows ``[r micro, (r + 1) micro)`` of each
micro-batch; the loss divides by the global micro-batch's token count
(``ModuleSpec.loss_norm``, taken on the host), so the ranks' losses and
gradients sum to JAX's; each dropout draws the rank's slice of JAX's draw
over the global batch (the key table's shard index). ``ZeroLayout`` says
which leaves a rank stores as shards (JAX's policy, dim for dim): stage 1
the optimizer state (each rank updates its shard of the master, then
all-gathers it), stage 2 also the gradient accumulation (a reduce-scatter
at each micro-batch), stage 3 also the fp32 master, gathered in the
compute dtype at each micro-batch's use (``GatherAtUse``, whose backward
reduce-scatters in the gradient-accumulation dtype, as stages 0-2
reduce). Whole gradients are all-reduced; the norm sums squares over
shards (a whole leaf counted once), the fp16 overflow is a MAX over the
ranks, LAMB sums its shards' norms between its two launches. All of
it runs inside the step's one program: on the card the NCCL collectives
are captured with it (the engine runs one eager collective first, so the
communicator exists before any capture).

The telemetry plane (``telemetry`` section) records a sampled step as the
JAX engine's ``_telemetry_step`` does: prepare/dispatch/sync spans, the
step's scalars, ``samples_per_sec`` from the throughput timer, ``hbm``,
``jit_step_cache_size``; the watchdog judges the step's loss and gradient
norm and its in-step ``anomaly_flags`` (bit 0 the loss, bit 1 the norm),
which the step computes when the watchdog is on and which is popped before
the metrics reach the caller. ``device=None`` means the CUDA card, which
must exist; pass ``device="cpu"`` for the CPU.

Checkpoints (JAX engine.py:2472-2760): :meth:`save_checkpoint` /
:meth:`load_checkpoint`. With the ``resilience`` section on, a tag is the
crc manifest of ``resilience/manifest.py`` (the JAX package's format, byte
for byte), its leaves named as the JAX engine's ``TrainState`` flattens
(:meth:`state_leaves`: ``params/...``, ``opt_state/...`` as optax's chain
names them, ``loss_scale/...``, ``global_step``, ``skipped_steps``), plus
``__rng__``; the client state carries ``global_steps`` and the resilience
counters. So a tag written by either package loads in the other. The
write runs on a background thread (``resilience.async_checkpoint``); the
step path pays the snapshot to pinned host memory. Without the section the
state goes to ``checkpoint/engine.py``'s torch-native file. Either way a
load, and the watchdog's ``rollback`` (the last clean step's host
snapshot, restored when a step trips it), write INTO the tensors the
captured programs read: a program replayed after a load trains the loaded
values. A restored ``global_step + skipped_steps`` is the step count the
dropout keys fold, so the resumed run draws the keys it would have drawn.
The fault injector's ``nan_loss`` and ``sigterm`` sites fire after a
step, as in the JAX engine.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .. import comm as dscomm
from .. import telemetry as _telemetry
from ..inference.engine import resolve_device
from ..parallel.topology import MeshSpec, active_mesh
from ..ops import prng
from ..utils import graphs
from ..utils.logging import log_dist, warning_once
from ..utils.timer import TRAIN_BATCH_TIMER, SynchronizedWallClockTimer, ThroughputTimer
from ..utils.weights import tree_leaves, tree_map
from .config import DeepSpeedConfig, NotPortedError
from .fp16 import loss_scaler as ls
from .lr_schedules import get_lr_schedule, tensor_form
from .module import ModuleSpec
from .optimizers import Lamb, build_optimizer, optax_state_paths
from .zero.partitioning import GatherAtUse, ZeroLayout, logical_to_spec

PyTree = Any

_ACC_DTYPES = {None: torch.float32, "fp32": torch.float32, "fp16": torch.float16,
               "bf16": torch.bfloat16}


def global_norm(leaves) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares."""
    return torch.sqrt(torch.stack([x.float().square().sum() for x in leaves]).sum())


def _cast(params: PyTree, dtype: torch.dtype) -> PyTree:
    return tree_map(lambda p: p.to(dtype) if p.is_floating_point() else p, params)


def _flatten(tree: PyTree, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], prefix + (k,))
        return out
    return [(prefix, tree)]


def _unflatten(items: List[Tuple[Tuple, Any]]) -> PyTree:
    if len(items) == 1 and items[0][0] == ():
        return items[0][1]
    out: Dict = {}
    for path, v in items:
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out


class DeepSpeedEngine:
    def __init__(self, model: ModuleSpec, config, params: Optional[PyTree] = None,
                 lr_schedule: Optional[Callable] = None, seed: int = 0, training_data=None,
                 collate_fn=None, device=None):
        self.device = resolve_device(device)
        config = DeepSpeedConfig.load(config, dp_world_size=None)
        ac = config.activation_checkpointing
        if ac.partition_activations or ac.cpu_checkpointing:
            if model.checkpointing is None:
                raise ValueError(
                    "activation_checkpointing: partition_activations and cpu_checkpointing "
                    "act on a model's recomputed blocks, and this model has none that take "
                    "them (ModuleSpec.checkpointing; GPT-2's blocks do)")
            model = model.checkpointing(ac.partition_activations, ac.cpu_checkpointing)
        self.module = model
        # --- topology (JAX engine.py:102-114): the mesh's process groups.
        # With no process group the engine trains alone and communicates
        # nothing; with one (comm.init_distributed) it runs the stage's
        # collectives over dp, at any world size, one rank included
        m = config.mesh
        if m.tp > 1 and model.logical_axes is None:
            raise NotPortedError(
                f"mesh.tp={m.tp}: the model has no logical_axes, so it has no tensor-parallel "
                "plan in deepspeed_tpu_torch (GPT-2's is ported; BERT's and the decoder's "
                "training over tp wait: ROADMAP queue 1 item 11b)")
        if m.sp > 1 and model.seq_labels is None:
            raise NotPortedError(
                f"mesh.sp={m.sp}: the model has no seq_labels, so its sequence-parallel "
                "training is not ported to deepspeed_tpu_torch (GPT-2's is; BERT's and the "
                "decoder's wait: ROADMAP queue 1 item 12c)")
        opt_type = (config.optimizer.type if config.optimizer else "Adam").lower()
        if m.tp > 1 and opt_type in ("lamb", "fusedlamb"):
            raise NotPortedError(
                "optimizer Lamb at mesh.tp > 1: its trust ratios need each leaf's norm over "
                "tp and dp slices at once, which the port's LAMB does not reduce yet "
                "(ROADMAP queue 1 item 11b)")
        fixed = max(1, m.sp) * max(1, m.tp)
        want = m.dp * fixed if m.dp > 0 else (fixed if fixed > 1 else None)
        world = torch.distributed.get_world_size() if torch.distributed.is_initialized() else 1
        if want is not None and (want != world if m.dp > 0 else world % want):
            raise RuntimeError(
                f"mesh dp={m.dp} sp={m.sp} tp={m.tp} needs a process group of "
                + (f"{want}" if m.dp > 0 else f"a multiple of {want}")
                + " ranks and this process has "
                + (f"one of {world}" if torch.distributed.is_initialized() else
                   "none: call deepspeed_tpu_torch.comm.init_distributed first")
                + " (the engine never trains at a narrower mesh than asked)")
        self.mesh = MeshSpec(dp=m.dp, tp=m.tp, pp=m.pp, ep=m.ep, sp=m.sp).build_mesh()
        self.distributed = self.mesh.distributed
        self.dp_world_size = self.mesh.size("dp")
        self.dp_rank = self.mesh.axis_rank("dp")
        # no dp axis in the mesh when dp is 1 beside sp or tp (a size-1 axis
        # is dropped, as JAX's MeshSpec drops it)
        self._dp_group = (self.mesh.group("dp") if self.distributed
                          and "dp" in self.mesh.axis_names else None)
        self.sp_world_size, self.sp_rank = self.mesh.size("sp"), self.mesh.axis_rank("sp")
        self.tp_world_size, self.tp_rank = self.mesh.size("tp"), self.mesh.axis_rank("tp")
        self._sp_group = self.mesh.group_or_none("sp")
        self._tp_group = self.mesh.group_or_none("tp")
        self._rank0 = self.mesh.rank == 0
        # a dp group of one rank beside sp or tp ranks reduces nothing: its
        # collectives are skipped (a dp-only mesh keeps them at any width)
        self._dp_trivial = self.dp_world_size == 1 and (m.sp > 1 or m.tp > 1)
        self._world = world
        self._captures = True
        if self.distributed:
            backend = torch.distributed.get_backend()
            if backend == "nccl" and self.device.type != "cuda":
                raise RuntimeError(
                    f"the process group's backend is nccl and the engine's device is "
                    f"{self.device}: nccl trains on the card, gloo on the CPU (or on a card "
                    "that several ranks share)")
            # a CUDA graph cannot hold gloo's calls: ranks that share a card
            # over gloo run their programs eagerly
            self._captures = backend == "nccl"
        config.finalize(self.dp_world_size)
        self.config = config
        if config.comms_logger.enabled:
            dscomm.configure(config=config)

        # --- precision
        self.fp16_enabled = config.fp16.enabled
        self.bf16_enabled = config.bf16.enabled
        self.compute_dtype = config.compute_dtype
        self.dynamic_loss_scale = config.fp16.enabled and config.fp16.dynamic_loss_scale
        self.grad_accum_dtype = _ACC_DTYPES[config.data_types.grad_accum_dtype]
        zcfg = config.zero_optimization
        self.zero_stage = int(zcfg.stage)

        # --- lr schedule + optimizer (JAX engine.py:145-182)
        opt_cfg, sched_cfg = config.optimizer, config.scheduler
        base_lr = opt_cfg.params.get("lr", 1e-3) if opt_cfg else 1e-3
        if lr_schedule is None:
            lr_schedule = get_lr_schedule(sched_cfg.type if sched_cfg else None,
                                          sched_cfg.params if sched_cfg else None,
                                          fallback_lr=base_lr)
        self.lr_schedule = lr_schedule
        self._lr_at = tensor_form(lr_schedule)
        self.optimizer = build_optimizer(opt_cfg.type if opt_cfg else "Adam",
                                         opt_cfg.params if opt_cfg else {"lr": base_lr},
                                         learning_rate=lr_schedule)

        # --- state on the device: the fp32 master (an owned copy), optimizer
        # state, loss scale, and the counts of applied and skipped updates
        if params is None:
            params = model.init(torch.Generator(device=self.device).manual_seed(int(seed)))
        full = tree_map(
            lambda p: p.detach().to(device=self.device,
                                    dtype=torch.float32 if p.is_floating_point() else p.dtype,
                                    copy=True),
            params,
        )
        # --- ZeRO (JAX engine.py:136-143, zero/partitioning.py): which
        # leaves this rank holds as shards. Every rank builds the same tree
        # (the same seed or the caller's params) and keeps its shards: the
        # master's at stage 3, the optimizer state's from stage 1
        # tensor parallelism first: each leaf the model's logical axes put
        # on tp is cut to this rank's slice (JAX: the tp entry of its spec)
        items = _flatten(full)
        self._leaf_paths = [p for p, _ in items]
        self._tp_plan = self._tp_specs(model, items)
        items = [(p, self._tp_slice(v, plan)) for (p, v), plan in zip(items, self._tp_plan)]
        self.layout = ZeroLayout(
            [tuple(v.shape) for _, v in items],
            self.zero_stage if self.distributed and not self._dp_trivial else 0,
            self.dp_world_size,
            param_min_size=max(2, int(zcfg.stage3_param_persistence_threshold))
            if self.zero_stage >= 3 else 2**14)
        self.params = _unflatten([(p, self._shard(v, d)) for (p, v), d
                                  in zip(items, self.layout.param)])
        del full, items
        self.opt_state = self.optimizer.init(self._update_tree(tree_leaves(self.params)))
        # the shard dim of every state tensor a shard is kept of, by identity
        self._shard_dims = {id(t): d for t, d in zip(tree_leaves(self.params),
                                                      self.layout.param) if d is not None}
        # the tp slice of every state tensor cut over tp, by identity
        self._tp_dims = {id(t): plan for t, plan in zip(tree_leaves(self.params),
                                                         self._tp_plan) if plan is not None}
        for f in vars(self.opt_state).values():
            if isinstance(f, dict):
                self._shard_dims.update({id(t): d for t, d in zip(tree_leaves(f),
                                                                   self.layout.opt)
                                         if d is not None})
                self._tp_dims.update({id(t): plan for t, plan in zip(tree_leaves(f),
                                                                      self._tp_plan)
                                      if plan is not None})
        if self.distributed:
            # the communicators exist before any capture: one eager
            # collective on each group
            for g in (self._dp_group, self._sp_group, self._tp_group):
                if g is not None:
                    dscomm.all_reduce(torch.zeros(1, device=self.device), g)
        self.loss_scale_state = ls.from_config(config.fp16, device=self.device)
        self._global_step = torch.zeros((), dtype=torch.int32, device=self.device)
        self._skipped = torch.zeros((), dtype=torch.int32, device=self.device)
        self._steps_run = 0         # training steps run (= global_step + skipped_steps)
        self._t_prepared = 0.0
        self.global_steps = 0       # train_batch calls
        # the training stream (JAX engine.py:262-265): a host key
        self._rng = prng.PRNGKey(int(seed) + 1)
        # the compiled programs: ("train" | "eval", batch signature) -> program
        self._programs: Dict[tuple, graphs.CapturedProgram] = {}
        # the reference-loop shim's state (forward / backward / step)
        self._pending_batch = None
        self._backward_called = False

        self.micro_batch_size = config.train_micro_batch_size_per_gpu
        self.gradient_accumulation_steps_value = config.gradient_accumulation_steps
        self.train_batch_size_value = config.train_batch_size
        self.steps_per_print = config.steps_per_print

        # --- observability (JAX engine.py:280-305): timers, the telemetry
        # plane and its watchdog (None when off: one None check a step)
        self.timers = SynchronizedWallClockTimer()
        self.tput_timer = ThroughputTimer(batch_size=self.train_batch_size_value,
                                          steps_per_output=config.steps_per_print)
        self.wall_clock_breakdown = config.wall_clock_breakdown
        self.telemetry = _telemetry.from_config(config.telemetry)
        self._watchdog = self.telemetry.watchdog if self.telemetry is not None else None
        # --- the resilience plane (JAX engine.py:306-345): the fault
        # injector, the rollback snapshots, the async checkpoint writers.
        # All None/empty when off: the step path pays two None checks
        rcfg = config.resilience
        self.fault_injector = None
        self._rollback = None
        self._ckpt_writers: Dict[str, Any] = {}
        self._snap_bufs: Dict[str, torch.Tensor] = {}  # pinned staging of the last save
        self._train_batch_count = 0  # the nan_loss / sigterm injection index
        self._preemption_guard = None
        self.last_snapshot_s = None  # the last resilient save's step-path seconds
        if rcfg.enabled:
            from ..resilience import faults as _faults

            self.fault_injector = _faults.from_config(rcfg.fault_injection)
        if self._watchdog is not None and self._watchdog.policy == "rollback":
            if not (rcfg.enabled and rcfg.snapshot_every > 0):
                raise ValueError(
                    "telemetry.watchdog.policy='rollback' requires "
                    "resilience.enabled with resilience.snapshot_every > 0 "
                    "(the rollback restores the resilience plane's in-memory "
                    "snapshot)"
                )
            from ..resilience.recovery import RollbackManager

            # only when the policy can consume it: a snapshot copies the
            # whole state to the host every snapshot_every steps
            self._rollback = RollbackManager(
                max_rollbacks=rcfg.max_rollbacks,
                registry=self.telemetry.registry if self.telemetry is not None else None,
            )

        self.training_dataloader = None
        self._data_iterator = None
        if training_data is not None:
            self.training_dataloader = self.deepspeed_io(training_data, collate_fn=collate_fn)
        precision = "fp16" if self.fp16_enabled else ("bf16" if self.bf16_enabled else "fp32")
        log_dist(
            f"DeepSpeedEngine initialized: device={self.device} mesh={self.mesh.shape} "
            f"zero_stage={self.zero_stage} precision={precision} "
            f"batch=({self.train_batch_size_value}={self.micro_batch_size}x"
            f"{self.gradient_accumulation_steps_value}x{self.dp_world_size})"
        )

    # ------------------------------------------------------------------
    # tensor-parallel slices and ZeRO shards
    # ------------------------------------------------------------------
    def _tp_specs(self, model: ModuleSpec, items) -> List[Optional[Tuple[int, bool]]]:
        """Per leaf ``(dim, qkv)``, the dim its spec puts on tp and whether it
        is a fused QKV projection (regrouped before the cut), or None."""
        if self.tp_world_size <= 1:
            return [None] * len(items)
        axes = dict(_flatten(model.logical_axes))
        plan = []
        for path, v in items:
            names = tuple(axes[path])
            spec = logical_to_spec(names, mesh=self.mesh)
            if "tp" not in spec:
                plan.append(None)
                continue
            d = spec.index("tp")
            if v.shape[d] % self.tp_world_size:
                raise ValueError(f"tp={self.tp_world_size} does not divide dim {d} of "
                                 f"{'/'.join(path)} {tuple(v.shape)}")
            qkv = names[d] == "qkv"
            if qkv and d != v.dim() - 1:
                raise ValueError(f"a fused QKV axis must be the last dim of {'/'.join(path)}")
            plan.append((d, qkv))
        return plan

    def _tp_slice(self, t: torch.Tensor, plan) -> torch.Tensor:
        """This rank's tp slice of a whole leaf (owned, contiguous), or the
        leaf itself."""
        if plan is None:
            return t
        from ..module_inject.tp_shard import regroup_qkv

        d, qkv = plan
        if qkv:
            t = regroup_qkv(t, self.tp_world_size)
        c = t.shape[d] // self.tp_world_size
        return t.narrow(d, self.tp_rank * c, c).clone(memory_format=torch.contiguous_format)

    def _tp_whole(self, t: torch.Tensor, plan) -> torch.Tensor:
        """The whole leaf from this rank's tp slice (a collective over tp)."""
        if plan is None:
            return t
        from ..module_inject.tp_shard import regroup_qkv

        d, qkv = plan
        t = dscomm.all_gather(t.contiguous(), self._tp_group, gather_dim=d)
        return regroup_qkv(t, self.tp_world_size, inverse=True) if qkv else t

    def _shard(self, t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """This rank's chunk of ``t`` along ``dim`` (owned, contiguous), or
        ``t`` itself when ``dim`` is None."""
        if dim is None:
            return t
        c = t.shape[dim] // self.dp_world_size
        return t.narrow(dim, self.dp_rank * c, c).clone(memory_format=torch.contiguous_format)

    def _update_tree(self, master: List[torch.Tensor]) -> PyTree:
        """The tree the optimizer updates: each leaf on its ``opt`` layout
        (this rank's shard of a whole master leaf is a copy)."""
        return _unflatten([(p, m if (d is None or pd is not None) else self._shard(m, d))
                           for p, m, d, pd in zip(self._leaf_paths, master, self.layout.opt,
                                                  self.layout.param)])

    def _gather(self, t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        return t if dim is None else dscomm.all_gather(t, self._dp_group, gather_dim=dim)

    def full_params(self) -> PyTree:
        """The fp32 master as whole tensors on every rank (stage 3 gathers
        its shards, tp its slices: a collective every rank calls)."""
        return _unflatten([(p, self._tp_whole(self._gather(t, d), plan)) for p, t, d, plan in
                           zip(self._leaf_paths, tree_leaves(self.params), self.layout.param,
                               self._tp_plan)])

    def collective_plan(self) -> Dict[str, int]:
        """The collectives one training step issues, by kind (none without
        a process group)."""
        none = {"all_reduce": 0, "reduce_scatter": 0, "all_gather": 0}
        if not self.distributed:
            return none
        plan = none if self._dp_trivial else self.layout.plan(
            self.gradient_accumulation_steps_value, self.fp16_enabled,
            isinstance(self.optimizer, Lamb))
        if self._sp_group is not None:
            # every gradient and the loss summed over sp
            plan["all_reduce"] += len(self._leaf_paths) + 1
        if self._tp_group is not None:
            # the norm's sum of squares (and fp16's overflow flag) over tp;
            # the model's own tp collectives are not the engine's
            plan["all_reduce"] += 1 + int(self.fp16_enabled)
        return plan

    # ------------------------------------------------------------------
    # data plumbing
    # ------------------------------------------------------------------
    def _host_batch(self, batch: PyTree, norms: bool = False):
        """A host batch ``[train_batch_size, ...]`` → its leaves as numpy
        ``[gas, micro, ...]`` (integer leaves as int64, the index dtype):
        this rank's rows ``[r micro, (r + 1) micro)`` of each ``[micro *
        dp]`` micro-batch, as JAX's ``reshape(gas, -1, ...)`` shards the
        micro dim over dp (JAX engine.py:1572-1620). With ``norms`` (and a
        process group) also the loss's global denominators of each
        micro-batch (``ModuleSpec.loss_norm``), f32 ``[gas, k]``, or None."""
        gas = self.gradient_accumulation_steps_value
        mb, r = self.micro_batch_size, self.dp_rank
        glob = []
        for path, x in _flatten(batch):
            a = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            if a.shape[0] != self.train_batch_size_value:
                raise ValueError(
                    f"batch dim {a.shape[0]} != train_batch_size {self.train_batch_size_value}"
                )
            if not np.issubdtype(a.dtype, np.floating):
                a = a.astype(np.int64)
            glob.append((path, a.reshape(gas, -1, *a.shape[1:])))
        n = self.sp_world_size
        if n > 1:
            # the next-token labels, shifted on the whole sequence before the
            # cut (GSPMD's shift across shards), as one more leaf
            labels = np.stack([np.asarray(self.module.seq_labels(
                _unflatten([(p, a[i]) for p, a in glob])), np.int64) for i in range(gas)])
            glob = [(("__labels__",), labels)] + glob
        out = []
        for path, a in glob:
            if self.dp_world_size > 1:
                a = a[:, r * mb:(r + 1) * mb]
            if n > 1 and a.ndim >= 3:
                if a.shape[2] % n == 0:
                    c = a.shape[2] // n
                    a = a[:, :, self.sp_rank * c:(self.sp_rank + 1) * c]
                else:
                    warning_once(f"batch leaf {'/'.join(map(str, path))} dim {a.shape[2]} is "
                                 f"not divisible by sp ({n}); replicating it over sp")
            out.append((path, a))
        if not norms:
            return out
        glob = [(p, a) for p, a in glob if p != ("__labels__",)]
        return out, self._loss_norms(glob) if self.distributed else None

    def _loss_norms(self, glob) -> np.ndarray:
        """The global micro-batches' loss denominators, ``[gas, k]`` f32: the
        model's ``loss_norm``, or ``[dp]`` (the per-rank loss divided by the
        rank count) without one."""
        fn = self.module.loss_norm
        rows = []
        for i in range(self.gradient_accumulation_steps_value):
            micro = _unflatten([(p, a[i]) for p, a in glob])
            rows.append(np.asarray(fn(micro), np.float32) if fn is not None
                        else np.asarray([self.dp_world_size], np.float32))
        return np.stack(rows)

    def shard_batch(self, batch: PyTree) -> PyTree:
        """Host batch ``[train_batch_size, ...]`` → device tensors ``[gas,
        micro, ...]`` (integer leaves as int64, the index dtype)."""
        return _unflatten([(p, torch.from_numpy(a).to(self.device))
                           for p, a in self._host_batch(batch)])

    def deepspeed_io(self, dataset, collate_fn=None):
        """The training loader (reference ``deepspeed_io``)."""
        from .dataloader import DeepSpeedDataLoader

        return DeepSpeedDataLoader(dataset, batch_size=self.train_batch_size_value,
                                   collate_fn=collate_fn)

    # ------------------------------------------------------------------
    # the programs
    # ------------------------------------------------------------------
    def _key_rows(self, key: np.ndarray) -> np.ndarray:
        """A micro-batch key → the rows its loss reads (the model's key
        table, or the key itself), uint32 ``[T, 2]``; with a process group
        ``[T, 4]``, each row with this rank's shard index
        (``prng.shard_key``): the rank draws its slice of each global
        draw, as JAX's dropout over the global batch does."""
        kt = self.module.key_table
        rows = np.asarray(kt(key) if kt is not None else key[None], np.uint32)
        if self.sp_world_size > 1:
            # row b of this rank's micro-batch is global row dp_rank * micro
            # + b, of which it holds column block sp_rank of sp
            n, mb = self.sp_world_size, self.micro_batch_size
            rows = np.stack([prng.shard_key(k, self.dp_rank * mb * n + self.sp_rank, stride=n)
                             for k in rows])
        elif self.distributed:
            rows = np.stack([prng.shard_key(k, self.dp_rank) for k in rows])
        return rows

    def _program(self, kind: str, leaves, n_keys: int, norms) -> graphs.CapturedProgram:
        sig = (kind, n_keys, tuple((p, a.shape, a.dtype.str) for p, a in leaves),
               None if norms is None else norms.shape)
        prog = self._programs.get(sig)
        if prog is None:
            T, W = self._key_rows(self._rng).shape
            shapes = {str(i): (a.shape, torch.from_numpy(a[:0]).dtype)
                      for i, (_, a) in enumerate(leaves)}
            shapes["keys"] = (n_keys, T, W)
            if norms is not None:
                shapes["norm"] = (norms.shape, torch.float32)
            inputs = graphs.StaticInputs(shapes, self.device)
            batch = _unflatten([(p, inputs.dev[str(i)]) for i, (p, _) in enumerate(leaves)])
            if norms is not None:
                batch["__norm__"] = inputs.dev["norm"]
            keys = inputs.dev["keys"] if self.module.key_table is not None \
                else inputs.dev["keys"][:, 0, :2]
            fn = (self._train_fn if kind == "train" else self._eval_fn)(batch, keys)
            prog = graphs.CapturedProgram(f"{kind}_step", fn, self.device, inputs,
                                          copy_outputs=True, capture=self._captures)
            self._programs[sig] = prog
        return prog

    @property
    def jit_step_cache_size(self) -> int:
        """The training programs built (JAX: the jitted step's cache size)."""
        return sum(1 for sig in self._programs if sig[0] == "train")

    def _train_fn(self, batch: PyTree, keys: torch.Tensor) -> Callable[[], Dict]:
        """The step function over the program's static inputs: ``batch``'s
        leaves ``[gas, micro, ...]`` and ``keys [gas, T, 2 or 4]`` (or
        ``[gas, 2]``) on the device → the metrics as device tensors. With a
        process group, the ZeRO stage's collectives over dp run inside it
        (module docstring)."""
        cfg = self.config
        gas = self.gradient_accumulation_steps_value
        fp16 = self.fp16_enabled
        predivide, factor = cfg.prescale_gradients, cfg.gradient_predivide_factor
        clip = cfg.gradient_clipping
        # the watchdog's in-step bitmask (JAX engine.py:132-134)
        flags = self._watchdog is not None and bool(cfg.telemetry.watchdog.nan_check)
        lss = self.loss_scale_state
        dist_on, grp = self.distributed and not self._dp_trivial, self._dp_group
        sp_grp, tp_grp = self._sp_group, self._tp_group
        data_world = self.dp_world_size * self.sp_world_size
        lay = self.layout
        sharded_grads = any(d is not None for d in lay.grad)
        # each gradient's share of the norm's sum of squares: a leaf whole
        # over dp (tp) is counted on dp (tp) rank 0 only, when the sum is
        # taken over dp (tp)
        weights = []
        for d, plan in zip(lay.grad, self._tp_plan):
            w = 1.0
            if sharded_grads and d is None and self.dp_rank != 0:
                w = 0.0
            if tp_grp is not None and plan is None and self.tp_rank != 0:
                w = 0.0
            weights.append(w)
        mesh = self.mesh

        def step():
            with active_mesh(mesh):
                return _step()

        def _step():
            scale = lss.cur_scale if fp16 else 1.0
            master = tree_leaves(self.params)
            # 1. one cast of the master per step; its leaves are what
            # autograd differentiates. A stage-3 shard stays in
            # grad_accum_dtype: GatherAtUse casts it at each use, and
            # reduce-scatters its gradient in that dtype
            leaves = [p.detach().to(self.compute_dtype if d is None
                                    else self.grad_accum_dtype).requires_grad_(True)
                      if p.is_floating_point() else p for p, d in zip(master, lay.param)]
            # 2. accumulate the micro-batches' grads in grad_accum_dtype, each
            # under its key rows (JAX engine.py:1212, :1236, :1252); stage 3
            # gathers its sharded leaves at each micro-batch's use, and their
            # backward reduce-scatters; stage 2 reduce-scatters the others
            acc = None
            loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
            for i in range(gas):
                micro = tree_map(lambda x: x[i], batch)
                used = [GatherAtUse.apply(t, grp, d, self.compute_dtype) if d is not None
                        else t for t, d in zip(leaves, lay.param)]
                cparams = _unflatten(list(zip(self._leaf_paths, used)))
                loss, _ = self.module.loss_fn(cparams, micro, keys[i], True)
                if self.distributed and self.module.loss_norm is None:
                    loss = loss / data_world
                grads = torch.autograd.grad(loss.float() * scale, leaves, allow_unused=True,
                                            materialize_grads=True)
                del cparams, used
                if predivide:
                    grads = [g / factor for g in grads]
                grads = [g.to(self.grad_accum_dtype) for g in grads]
                grads = [dscomm.reduce_scatter(g, grp, scatter_dim=d)
                         if d is not None and pd is None else g
                         for g, d, pd in zip(grads, lay.grad, lay.param)]
                if acc is None:
                    acc = grads
                else:
                    for a, g in zip(acc, grads):
                        a.add_(g)
                loss_sum = loss_sum + loss.detach().float()
            del leaves
            if sp_grp is not None:
                # parameters are replicated over sp: every gradient (whole or
                # a dp shard) and the loss sum over sp first
                for a in acc:
                    dscomm.all_reduce(a, sp_grp)
                dscomm.all_reduce(loss_sum, sp_grp)
            if dist_on:
                # the whole gradients are summed over the ranks; so is the
                # loss, each rank's share of the global mean
                for a, d in zip(acc, lay.grad):
                    if d is None:
                        dscomm.all_reduce(a, grp)
                dscomm.all_reduce(loss_sum, grp)
            # 3. unscale and average over gas in f32
            inv = 1.0 / (scale * gas) if fp16 else 1.0 / gas
            grads = [g.float() * inv for g in acc]
            if predivide and factor != 1.0:
                grads = [g * factor for g in grads]
            # 4. overflow (fp16 only), a device flag: zero the gradients. A
            # shard's overflow is every rank's (a MAX over dp)
            overflow = (ls.has_inf_or_nan(grads) if fp16
                        else torch.zeros((), dtype=torch.bool, device=self.device))
            if fp16 and (sharded_grads or tp_grp is not None):
                flag = overflow.to(torch.int32)
                if sharded_grads:
                    flag = dscomm.all_reduce(flag, grp, op="max")
                if tp_grp is not None:
                    flag = dscomm.all_reduce(flag, tp_grp, op="max")
                overflow = flag > 0
            if fp16:
                grads = [torch.where(overflow, 0.0, g) for g in grads]
            # 5. global norm and clipping: over shards and tp slices, one sum
            # of squares over dp and tp (a whole gradient counted once)
            if sharded_grads or tp_grp is not None:
                sq = torch.stack([g.float().square().sum() * w
                                  for g, w in zip(grads, weights)]).sum()
                if sharded_grads:
                    sq = dscomm.all_reduce(sq, grp)
                if tp_grp is not None:
                    sq = dscomm.all_reduce(sq, tp_grp)
                gnorm = torch.sqrt(sq)
            else:
                gnorm = global_norm(grads)
            if clip > 0.0:
                coef = torch.clamp(clip / (gnorm + 1e-6), max=1.0)
                grads = [g * coef for g in grads]
            # 6. the update, skipped on overflow; the scale and the counts
            lr = self._lr_at(self._global_step)
            self._update(master, grads, overflow if fp16 else None)
            scale_now = lss.cur_scale.clone()
            ls.assign(lss, ls.update(lss, overflow, dynamic=self.dynamic_loss_scale,
                                     scale_window=cfg.fp16.loss_scale_window,
                                     min_scale=cfg.fp16.min_loss_scale))
            applied = (~overflow).to(torch.int32)
            self._global_step.add_(applied)
            self._skipped.add_(1 - applied)
            loss = loss_sum / gas
            out = {"f32": torch.stack([loss, gnorm, scale_now, lr.float()]),
                   "overflow": overflow, "global_step": self._global_step.clone()}
            if flags:
                # the watchdog's bitmask, in the step (JAX engine.py:1338-1346)
                out["anomaly_flags"] = ((~torch.isfinite(loss)).to(torch.int32)
                                        + 2 * (~torch.isfinite(gnorm)).to(torch.int32))
            return out

        return step

    def _update(self, master: List[torch.Tensor], grads: List[torch.Tensor], skip) -> None:
        """The optimizer's update of the master from ``grads`` (each on its
        ``grad`` layout). From stage 1 each rank updates its shard of every
        sharded leaf (the gradient's chunk at stage 1, where the gradients
        are whole), then all-gathers the updated master where it keeps it
        whole (stages 1-2; stage 3's sharded master is updated in place).
        LAMB sums its sharded leaves' norms over dp between its launches."""
        lay = self.layout
        if not any(d is not None for d in lay.opt):
            self.optimizer.step(self.params, grads, self.opt_state, skip=skip)
            return
        upd = tree_leaves(self._update_tree(master))
        gs = [self._shard(g, d) if d is not None and gd is None else g
              for g, d, gd in zip(grads, lay.opt, lay.grad)]
        kw = {}
        if isinstance(self.optimizer, Lamb):
            from ..ops.fused_adam import NormReduce

            grp = self._dp_group
            kw["norm_reduce"] = NormReduce(lambda t: dscomm.all_reduce(t, grp),
                                           [d is not None for d in lay.opt])
        self.optimizer.step(upd, gs, self.opt_state, skip=skip, **kw)
        with torch.no_grad():
            for m, u, d, pd in zip(master, upd, lay.opt, lay.param):
                if d is not None and pd is None:
                    m.copy_(dscomm.all_gather(u, self._dp_group, gather_dim=d))

    def _eval_fn(self, batch: PyTree, keys: torch.Tensor) -> Callable[[], torch.Tensor]:
        """The eval step over the program's inputs: the mean eval-mode loss
        of the ``gas`` micro-batches, each under ``keys[0]`` (over dp: each
        rank's share, summed)."""
        n = self.gradient_accumulation_steps_value

        @torch.no_grad()
        def step():
            with active_mesh(self.mesh):
                cparams = _cast(self.params, self.compute_dtype)
                if self.zero_stage >= 3:
                    cparams = _unflatten([(p, self._gather(t, d)) for p, t, d in zip(
                        self._leaf_paths, tree_leaves(cparams), self.layout.param)])
                total = torch.zeros((), dtype=torch.float32, device=self.device)
                for i in range(n):
                    micro = tree_map(lambda x: x[i], batch)
                    loss, _ = self.module.loss_fn(cparams, micro, keys[0], False)
                    if self.distributed and self.module.loss_norm is None:
                        loss = loss / (self.dp_world_size * self.sp_world_size)
                    total = total + loss.float()
                if self._sp_group is not None:
                    dscomm.all_reduce(total, self._sp_group)
                if self.distributed and not self._dp_trivial:
                    dscomm.all_reduce(total, self._dp_group)
                return total / n

        return step

    def _stage(self, kind: str, batch: PyTree, keys: List[np.ndarray]):
        """The program for ``batch``'s signature, its staging arrays filled
        with the batch, the loss's global denominators (with a process
        group) and the key rows of ``keys`` (one key a row)."""
        leaves, norms = self._host_batch(batch, norms=True)
        prog = self._program(kind, leaves, len(keys), norms)
        staging = prog.inputs.staging()
        for i, (_, a) in enumerate(leaves):
            np.copyto(staging[str(i)], a, casting="unsafe")
        if norms is not None:
            staging["norm"][...] = norms
        rows = np.stack([self._key_rows(k) for k in keys])
        staging["keys"][...] = rows.reshape(staging["keys"].shape).view(np.int32)
        return prog

    def _train_step(self, batch: PyTree, stamp: bool = False) -> Dict[str, Any]:
        """One training step on a host batch → the metrics (device tensors):
        the keys of step ``global_step + skipped_steps`` derived on the host,
        the program of the batch's signature staged with the batch and the
        keys, then run (one upload, one replay on the card). With ``stamp``,
        ``self._t_prepared`` is the time the staging ended."""
        step_rng = prng.fold_in(self._rng, self._steps_run)
        keys = [prng.fold_in(step_rng, i) for i in range(self.gradient_accumulation_steps_value)]
        prog = self._stage("train", batch, keys)
        if stamp:
            self._t_prepared = time.perf_counter()
        out = prog()
        self._steps_run += 1
        f = out["f32"]
        metrics = {"loss": f[0], "grad_norm": f[1], "loss_scale": f[2],
                   "overflow": out["overflow"], "lr": f[3], "global_step": out["global_step"]}
        if "anomaly_flags" in out:
            metrics["anomaly_flags"] = out["anomaly_flags"]
        return metrics

    # ------------------------------------------------------------------
    # public training surface
    # ------------------------------------------------------------------
    def train_batch(self, batch: Optional[PyTree] = None,
                    data_iter: Optional[Iterator] = None) -> Dict[str, Any]:
        """One full training step (``gas`` micro-batches and the update) on a
        host batch with leading dim ``train_batch_size``, or on the next
        batch of ``data_iter`` / the training loader. → ``{loss, grad_norm,
        loss_scale, overflow, lr, global_step}``, 0-d device tensors (as JAX
        returns device arrays: reading one synchronises)."""
        if batch is None:
            if data_iter is None:
                if self._data_iterator is None:
                    from .dataloader import RepeatingLoader

                    if self.training_dataloader is None:
                        raise ValueError("train_batch() without a batch requires training_data")
                    self._data_iterator = iter(RepeatingLoader(self.training_dataloader))
                data_iter = self._data_iterator
            batch = next(data_iter)
        tel = self.telemetry
        sampled = tel is not None and tel.should_sample(self.global_steps + 1)
        wd = self._watchdog
        if wd is not None and wd.capture_pending:
            # a prior step tripped: this one runs under a bounded profiler
            # capture (stopped after the sync below)
            wd.start_capture(self.global_steps + 1)
        t_start = time.perf_counter() if (sampled or wd is not None) else 0.0
        if self.wall_clock_breakdown:
            self.timers(TRAIN_BATCH_TIMER).start()
        self.tput_timer.start()
        metrics = self._train_step(batch, stamp=sampled)
        self.global_steps += 1
        t_prepared = self._t_prepared
        t_dispatched = time.perf_counter() if sampled else 0.0
        if self.wall_clock_breakdown:
            self.timers(TRAIN_BATCH_TIMER).stop(sync_tree=metrics)
        # wait for the step's outputs before stopping the throughput clock:
        # the card runs asynchronously, so stopping at dispatch would count
        # the host's time only
        self.tput_timer.stop(sync_tree=metrics)
        # the train_batch ordinal: the fault-injection index. NOT
        # global_steps, which a rollback rewinds (a scheduled fault would
        # re-fire on every step after the rollback)
        self._train_batch_count += 1
        inj = self.fault_injector
        if inj is not None and inj.fire("nan_loss", self._train_batch_count):
            # poison this step's loss on the host, so the watchdog's
            # non-finite detector (and the policy behind it) runs for real;
            # the program is untouched
            metrics["loss"] = float("nan")
            metrics["fault_injected"] = "nan_loss"
            if wd is not None:
                # through the in-step flags too: an off-cadence step skips
                # the scalar judgement, and a fault it can miss tests nothing
                metrics["anomaly_flags"] = 1  # the loss's non-finite bit
        tripped = self._watchdog_step(wd, metrics, t_start) if wd is not None else []
        if self._rollback is not None:
            if tripped and wd.policy == "rollback":
                self._apply_rollback(metrics)
            elif not tripped and self.global_steps % self.config.resilience.snapshot_every == 0:
                # judged clean: refresh the last-known-good host snapshot
                # (the outputs are already waited for)
                self._rollback.snapshot(self.state_leaves(), self.global_steps)
        if sampled:
            self._telemetry_step(tel, metrics, t_start, t_prepared, t_dispatched)
        if inj is not None and inj.fire("sigterm", self._train_batch_count):
            inj.deliver_sigterm()
        if self.global_steps % self.steps_per_print == 0:
            host = {k: float(v) for k, v in metrics.items()
                    if k not in ("overflow", "fault_injected", "rolled_back")}
            log_dist(
                f"step={int(host['global_step'])} loss={host['loss']:.4f} "
                f"lr={host['lr']:.3e} gnorm={host['grad_norm']:.3f} "
                f"scale={host['loss_scale']:.0f}"
            )
            if self.wall_clock_breakdown:
                self.timers.log([TRAIN_BATCH_TIMER])
            if self.config.memory_breakdown:
                mb = self.memory_breakdown()
                log_dist("memory: in_use={:.2f} GB peak={:.2f} GB limit={:.2f} GB".format(
                    mb["bytes_in_use"] / 2**30, mb["peak_bytes_in_use"] / 2**30,
                    mb["bytes_limit"] / 2**30))
        return metrics

    # ------------------------------------------------------------------
    # telemetry (JAX engine.py:1802-1898)
    # ------------------------------------------------------------------
    def _telemetry_step(self, tel, metrics, t_start, t_prepared, t_dispatched) -> None:
        """One sampled step's record: reading the scalars synchronises (the
        cost of sampling, which ``telemetry.sample_every`` amortizes)."""
        scalars = {k: float(v) for k, v in metrics.items() if not isinstance(v, str)}
        t_synced = time.perf_counter()
        spans = [
            ("prepare", (t_prepared - t_start) * 1e3),
            ("dispatch", (t_dispatched - t_prepared) * 1e3),
            ("sync", (t_synced - t_dispatched) * 1e3),
        ]
        self.timers.export_telemetry(tel.registry)
        self.tput_timer.export_telemetry(tel.registry)
        tel.registry.gauge("jit_step_cache_size",
                           "entries in the train step's jit cache").set(self.jit_step_cache_size)
        tel.record_step(
            "train",
            step=self.global_steps,
            duration_s=t_synced - t_start,
            scalars=scalars,
            spans=spans,
            hbm=_telemetry.device_hbm_stats(self.device),
            comm_bytes={},  # the step's collectives are comm.comms_logger's to count
            extra={"samples_per_sec": round(self.tput_timer.avg_samples_per_sec(), 3)},
        )

    def _watchdog_step(self, wd, metrics, t_start: float) -> list:
        """Close any active anomaly capture, then judge this step: the
        in-step flags every step (popped from the metrics), the loss and
        gradient norm on the ``check_every`` cadence. The outputs are
        already waited for (the throughput timer), so the reads are host
        copies. Raises AnomalyError under policy="kill"."""
        wd.stop_capture()
        flags_t = metrics.pop("anomaly_flags", None)
        flags = int(flags_t) if flags_t is not None else None
        if self.global_steps % wd.check_every != 0:
            # off-cadence: the spike judgement waits, a non-finite does not
            if flags:
                return wd.observe_step(self.global_steps, {}, flags=flags)
            return []
        scalars: Dict[str, float] = {"step_time_s": time.perf_counter() - t_start}
        for k in ("loss", "grad_norm"):
            if k in metrics:
                scalars[k] = float(metrics[k])
        return wd.observe_step(self.global_steps, scalars, flags=flags)

    def memory_breakdown(self) -> Dict[str, int]:
        """The card's memory (JAX engine.py:674, the reference's
        memory_allocated/cached printout) from the allocator's counters;
        logged each ``steps_per_print`` when ``memory_breakdown`` is on.
        Under ZeRO or a process group also this rank's bytes of the fp32
        master (``param_bytes``) and of the optimizer state
        (``optimizer_state_bytes``): its shards."""
        out = _telemetry.device_hbm_stats(self.device)
        if self.zero_stage > 0 or self.distributed:
            master = tree_leaves(self.params)
            ids = {id(t) for t in master}
            opt = [t for t in self.state_leaves().values()
                   if t.dim() > 0 and id(t) not in ids]
            out.update(param_bytes=sum(t.numel() * t.element_size() for t in master),
                       optimizer_state_bytes=sum(t.numel() * t.element_size() for t in opt),
                       zero_stage=self.zero_stage, dp_world_size=self.dp_world_size)
        return out

    # ------------------------------------------------------------------
    # the state, by the JAX TrainState's path names
    # ------------------------------------------------------------------
    def state_leaves(self) -> Dict[str, torch.Tensor]:
        """The training state as ``{path: tensor}`` in the order and under
        the names of ``jax.tree_util.tree_flatten_with_path`` over the JAX
        engine's ``TrainState`` (``utils/pytree.py`` ``path_str``):
        ``params/<leaf>``, ``opt_state/<optax chain path>``,
        ``loss_scale/{cur_scale, cur_hysteresis, last_overflow_iter,
        iteration}``, ``global_step``, ``skipped_steps``. The tensors are the
        engine's own, the ones its programs read (an optimizer count the
        chain holds twice appears under both names)."""
        out: Dict[str, torch.Tensor] = {}
        for path, leaf in _flatten(self.params):
            out["/".join(("params",) + tuple(str(k) for k in path))] = leaf
        for path, leaf in optax_state_paths(self.optimizer, self.opt_state):
            out[f"opt_state/{path}"] = leaf
        lss = self.loss_scale_state
        for f in ("cur_scale", "cur_hysteresis", "last_overflow_iter", "iteration"):
            out[f"loss_scale/{f}"] = getattr(lss, f)
        out["global_step"] = self._global_step
        out["skipped_steps"] = self._skipped
        return out

    def full_state_leaves(self) -> Dict[str, torch.Tensor]:
        """:meth:`state_leaves` with every ZeRO shard and tp slice
        all-gathered into its whole leaf (a collective every rank calls):
        what a checkpoint holds, the same at any mesh."""
        return {k: self._tp_whole(self._gather(t, self._shard_dims.get(id(t))),
                                  self._tp_dims.get(id(t)))
                for k, t in self.state_leaves().items()}

    def _full_like(self) -> Dict[str, torch.Tensor]:
        """The whole state leaves' shapes and dtypes, as meta tensors."""
        out = {}
        for k, t in self.state_leaves().items():
            shape = list(t.shape)
            d = self._shard_dims.get(id(t))
            if d is not None:
                shape[d] *= self.dp_world_size
            plan = self._tp_dims.get(id(t))
            if plan is not None:
                shape[plan[0]] *= self.tp_world_size
            out[k] = torch.empty(shape, dtype=t.dtype, device="meta")
        return out

    def _write_state(self, host: Dict[str, torch.Tensor], whole: bool = True) -> None:
        """Copy host tensors into the engine's state tensors IN PLACE (a
        captured program reads them by address; rebinding would leave it
        on the old ones), then derive the step count the keys fold from the
        restored counters. ``whole``: the tensors are whole leaves (a
        checkpoint's), of which each rank takes its shards; else this
        rank's own (a rollback snapshot). A leaf held under two names must
        get the same value from both."""
        leaves = self.state_leaves()
        seen: Dict[int, Tuple[str, torch.Tensor]] = {}
        with torch.no_grad():
            for name, src in host.items():
                dst = leaves[name]
                if whole:
                    src = self._shard(self._tp_slice(src, self._tp_dims.get(id(dst))),
                                      self._shard_dims.get(id(dst)))
                prev = seen.get(id(dst))
                if prev is not None:
                    if not torch.equal(prev[1], src):
                        raise ValueError(f"state leaves {prev[0]!r} and {name!r} are one "
                                         "counter here and differ in the checkpoint")
                    continue
                seen[id(dst)] = (name, src)
                dst.copy_(src)
        g = host.get("global_step", self._global_step)
        k = host.get("skipped_steps", self._skipped)
        self._steps_run = int(g) + int(k)

    def _apply_rollback(self, metrics) -> bool:
        """The watchdog's ``rollback`` policy (JAX engine.py:1901): restore
        the last clean host snapshot into the state tensors and discard
        this step's (poisoned) update. Raises ``RollbackLimitError`` past
        ``resilience.max_rollbacks``; False when no snapshot exists yet."""
        rb = self._rollback
        if rb is None or not rb.can_restore:
            warning_once("watchdog rollback requested before the first clean-step "
                         "snapshot — continuing without rollback")
            return False
        host_state, steps = rb.restore()
        self._write_state(host_state, whole=False)
        self.global_steps = steps
        metrics["rolled_back"] = True
        if self.telemetry is not None:
            self.telemetry.record_event("rollback", 0.0,
                                        {"restored_step": steps, "rollbacks": rb.rollbacks})
        log_dist(f"watchdog rollback: restored in-memory snapshot of step {steps} "
                 f"(rollback {rb.rollbacks}/{rb.max_rollbacks}); poisoned batch skipped")
        return True

    @property
    def preempted(self) -> bool:
        """True once a PreemptionGuard attached to this engine has seen a
        termination signal: poll at step boundaries to checkpoint and exit
        inside the grace window."""
        guard = self._preemption_guard
        return bool(guard is not None and guard.should_stop())

    # ------------------------------------------------------------------
    # checkpoints (JAX engine.py:2455-2760)
    # ------------------------------------------------------------------
    def _config_fingerprint(self) -> str:
        """Hex digest of the resolved config, stamped into every manifest
        so a resume under another config is visible (a warning; the
        arrays still restore when their shapes agree)."""
        import dataclasses
        import hashlib
        import json

        doc = {k: v for k, v in dataclasses.asdict(self.config).items()
               if not k.startswith("_")}
        blob = json.dumps(doc, sort_keys=True, default=str).encode()
        return hashlib.sha256(blob + str(self.device.type).encode()).hexdigest()

    def _checkpoint_writer(self, save_dir: str):
        """One AsyncCheckpointWriter per save directory, made at first use."""
        from ..resilience.writer import AsyncCheckpointWriter

        key = os.path.abspath(save_dir)
        w = self._ckpt_writers.get(key)
        if w is None:
            w = AsyncCheckpointWriter(
                key, fingerprint=self._config_fingerprint(),
                registry=self.telemetry.registry if self.telemetry is not None else None,
                injector=self.fault_injector, telemetry=self.telemetry)
            self._ckpt_writers[key] = w
        return w

    def flush_checkpoints(self, timeout: Optional[float] = None) -> bool:
        """Drain every pending async checkpoint write (the PreemptionGuard's
        grace-window hook) → True when everything landed in time (a write
        that died lands too: its writer's ``last_error`` says so).
        ``timeout`` is ONE deadline across all writers."""
        deadline = None if timeout is None else time.monotonic() + timeout
        ok = True
        for w in self._ckpt_writers.values():
            left = None if deadline is None else max(0.0, deadline - time.monotonic())
            ok = w.wait(timeout=left) and ok
        return ok

    def _resilience_counter_values(self) -> Dict[str, float]:
        """The resilience counters, carried in the manifest's client state
        so a restart resumes the counts."""
        if self.telemetry is None:
            return {}
        out = {}
        for name in ("rolled_back_steps_total", "checkpoint_writes_total"):
            m = self.telemetry.registry.get(name)
            if m is not None:
                out[name] = float(m.value())
        return out

    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None,
                        client_state: Optional[Dict] = None, save_latest: bool = True,
                        blocking: Optional[bool] = None) -> str:
        """Save the training state under ``<save_dir>/<tag>`` (default
        ``global_step<N>``) → the tag directory. Resilient (the section on):
        snapshot to pinned host memory, then the manifest write on the
        directory's background writer unless ``blocking`` (default: not
        ``resilience.async_checkpoint``). Otherwise the torch-native state
        file, written before this returns. Under ZeRO the leaves are
        gathered whole (every rank calls this) and rank 0 writes them, as
        JAX's writer writes whole arrays, so a tag loads at any dp width
        and stage; with more than one rank the write is blocking and the
        ranks leave together, the tag on disk. With
        ``stage3_gather_16bit_weights_on_model_save`` at stage 3 the tag
        also gets :meth:`save_16bit_model`'s export."""
        t0 = time.perf_counter()
        tag = tag or f"global_step{self.get_global_step()}"
        # checkpoint.tag_validation compares the tag across processes: every
        # rank saves under the tag its caller gave, which is the same one
        if self.config.resilience.enabled:
            path = self._save_checkpoint_resilient(save_dir, tag, client_state, save_latest,
                                                   blocking, t0)
        else:
            from ..checkpoint.engine import save_train_state

            state = self.full_state_leaves()
            client = {**(client_state or {}), "global_steps": self.global_steps}
            path = os.path.join(os.path.abspath(save_dir), str(tag))
            if self._rank0:
                path = save_train_state(save_dir, tag, state, client_state=client,
                                        save_latest=save_latest)
            log_dist(f"saved checkpoint: {path}")
            if self.telemetry is not None:
                self.telemetry.record_event("checkpoint_save", time.perf_counter() - t0,
                                            {"step": self.global_steps, "tag": tag,
                                             "path": str(path)})
        zcfg = self.config.zero_optimization
        if zcfg.stage3_gather_16bit_weights_on_model_save and self.zero_stage >= 3:
            self.flush_checkpoints()
            self.save_16bit_model(str(path))
        if self._world > 1:
            dscomm.barrier()
        return path

    def save_16bit_model(self, save_dir: str, output_file: str = "pytorch_model.npz") -> str:
        """The whole parameters in the 16-bit compute dtype (bf16 when the
        run is fp32) as ONE flat ``.npz`` (JAX engine.py:2676-2700, the
        reference's ``save_16bit_model``): the stage-3 shards gathered,
        keys the leaves' ``/``-joined paths, and bf16, which npz lacks,
        stored as its uint16 words beside a ``__bf16__<key>`` tag. Every
        rank calls it; rank 0 writes. → the file's path."""
        dtype = self.compute_dtype if (self.bf16_enabled or self.fp16_enabled) \
            else torch.bfloat16
        path = os.path.join(save_dir, output_file)
        out = {}
        for p, leaf in _flatten(self.full_params()):
            key = "/".join(str(k) for k in p)
            t = leaf.detach().to(dtype).cpu()
            if t.dtype == torch.bfloat16:
                out[key] = t.view(torch.int16).numpy().view(np.uint16)
                out[f"__bf16__{key}"] = np.asarray(True)
            else:
                out[key] = t.numpy()
        if self._rank0:
            os.makedirs(save_dir, exist_ok=True)
            np.savez(path, **out)
            log_dist(f"saved 16-bit model: {path}")
        return path

    def _save_checkpoint_resilient(self, save_dir, tag, client_state, save_latest, blocking,
                                   t0) -> str:
        from ..resilience.writer import snapshot_to_host

        rcfg = self.config.resilience
        state = self.full_state_leaves()
        if not self._rank0:
            return os.path.join(os.path.abspath(save_dir), str(tag))
        writer = self._checkpoint_writer(save_dir)
        # the snapshot is the step path's whole cost: pinned host copies,
        # reused across saves once the writer is done with the last one
        idle = all(w.in_flight == 0 for w in self._ckpt_writers.values())
        reuse = self._snap_bufs if idle else None
        arrays = snapshot_to_host(state, out=reuse,
                                  extra={"__rng__": np.asarray(self._rng, np.uint32)})
        del state
        self._snap_bufs = {k: v for k, v in arrays.items() if isinstance(v, torch.Tensor)
                           and v.is_pinned()}
        self.last_snapshot_s = time.perf_counter() - t0
        client = {**(client_state or {}), "global_steps": self.global_steps,
                  "resilience_counters": self._resilience_counter_values()}
        block = (not rcfg.async_checkpoint) if blocking is None else bool(blocking)
        block = block or self._world > 1
        path = writer.save(tag, arrays, client_state=client, step=self.global_steps,
                           save_latest=save_latest, blocking=block)
        log_dist(f"{'committed' if block else 'enqueued async'} resilient checkpoint: {path}")
        if self.telemetry is not None:
            self.telemetry.record_event("checkpoint_save", time.perf_counter() - t0,
                                        {"step": self.global_steps, "tag": tag,
                                         "path": str(path), "async": not block})
        return path

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None,
                        load_optimizer_states: bool = True,
                        load_lr_scheduler_states: bool = True) -> Tuple[str, Dict]:
        """Restore ``<load_dir>/<tag>`` (``latest`` when None) into the
        engine's state tensors, in place → ``(load_dir, client_state)``.
        Manifest-format tags (either package's) restore with validation
        and the walk-back past corrupt or torn tags, whatever this engine's
        ``resilience`` setting; ``load_optimizer_states=False`` keeps this
        engine's optimizer state. A tag holds whole leaves: each rank takes
        its shards, so a tag saved at any dp width and stage loads at any
        other. The learning rate is the schedule at the restored count, so
        ``load_lr_scheduler_states`` changes nothing."""
        from ..resilience.recovery import is_resilient_dir

        if is_resilient_dir(load_dir, tag):
            return self._load_checkpoint_resilient(load_dir, tag, load_optimizer_states)
        from ..checkpoint.engine import load_train_state

        t0 = time.perf_counter()
        state, client_state = load_train_state(load_dir, tag, self._full_like(),
                                               load_optimizer_states=load_optimizer_states)
        self._write_state(state)
        self.global_steps = int(client_state.get("global_steps", self.get_global_step()))
        log_dist(f"loaded checkpoint from {load_dir} (tag={tag or 'latest'})")
        if self.telemetry is not None:
            self.telemetry.record_event("checkpoint_load", time.perf_counter() - t0,
                                        {"step": self.global_steps, "tag": tag or "latest",
                                         "path": load_dir})
        return load_dir, client_state

    def _load_checkpoint_resilient(self, load_dir, tag, load_optimizer_states):
        from ..resilience.manifest import read_manifest
        from ..resilience.recovery import load_resilient_state

        t0 = time.perf_counter()
        registry = self.telemetry.registry if self.telemetry is not None else None
        state, client_state, tag_used, extras = load_resilient_state(
            load_dir, tag, self._full_like(), load_optimizer_states=load_optimizer_states,
            registry=registry)
        self._write_state(state)
        rng = extras.get("__rng__")
        if rng is not None:
            self._rng = np.asarray(rng.numpy(), np.uint32)
        self.global_steps = int(client_state.get("global_steps", self.get_global_step()))
        if registry is not None:
            # resume the counters a previous run accumulated
            for name, v in (client_state.get("resilience_counters") or {}).items():
                m = registry.get(name)
                cur = float(m.value()) if m is not None else None
                if cur is not None and v > cur:
                    m.inc(v - cur)
        saved_fp = read_manifest(os.path.join(os.path.abspath(load_dir), tag_used)).get(
            "fingerprint", "")
        if saved_fp and saved_fp != self._config_fingerprint():
            warning_once(f"checkpoint tag {tag_used!r} was saved under a different config "
                         "fingerprint — resuming anyway (shapes matched)")
        log_dist(f"loaded resilient checkpoint from {load_dir} (tag={tag_used})")
        if self.telemetry is not None:
            self.telemetry.record_event("checkpoint_load", time.perf_counter() - t0,
                                        {"step": self.global_steps, "tag": tag_used,
                                         "path": load_dir})
        return load_dir, client_state

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    def eval_batch(self, batch: PyTree, rng=None) -> torch.Tensor:
        """Mean eval-mode loss over the batch's ``gas`` micro-batches, a 0-d
        device tensor from the eval program. ``rng``: the key handed to the
        model; without one, a fresh key is split off the engine's (JAX
        engine.py:2337-2346)."""
        if rng is None:
            self._rng, rng = prng.split(self._rng)
        key = np.asarray(prng.key_words(rng), np.uint32)
        return self._stage("eval", batch, [key])()

    # ------------------------------------------------------------------
    # the reference-loop shim (JAX engine.py:2269-2317)
    # ------------------------------------------------------------------
    def forward(self, batch: PyTree) -> torch.Tensor:
        """Reference-style ``loss = engine(batch)``: stashes the batch for
        :meth:`step` and returns its EVAL-mode loss (no dropout), computed
        under the derived key ``fold_in(rng, 0x5EED)`` (JAX engine.py:2298),
        so the training stream is untouched and a
        forward / backward / step loop updates the parameters exactly as a
        ``train_batch`` loop. The update itself runs in :meth:`step`: one
        extra forward a step against :meth:`train_batch`."""
        warning_once(
            "engine.forward/backward/step emulates the reference loop with one extra "
            "forward per step; engine.train_batch(batch) is the single-call form"
        )
        self._pending_batch = batch
        return self.eval_batch(batch, rng=prng.fold_in(self._rng, 0x5EED))

    __call__ = forward

    def backward(self, loss=None) -> None:
        """Reference ``engine.backward(loss)``: the gradients are taken in
        :meth:`step`; this checks the call order only."""
        if self._pending_batch is None:
            raise RuntimeError("backward() requires a preceding engine.forward(batch)")
        self._backward_called = True

    def step(self) -> Dict[str, Any]:
        """Reference ``engine.step()``: :meth:`train_batch` on the batch
        stashed by :meth:`forward`."""
        if self._pending_batch is None or not self._backward_called:
            raise RuntimeError("step() requires engine.forward(batch) then engine.backward()")
        batch, self._pending_batch = self._pending_batch, None
        self._backward_called = False
        return self.train_batch(batch)

    # ------------------------------------------------------------------
    # properties (reference engine property surface; each reads the device)
    # ------------------------------------------------------------------
    @property
    def train_batch_size(self) -> int:
        return self.train_batch_size_value

    @property
    def gradient_accumulation_steps(self) -> int:
        return self.gradient_accumulation_steps_value

    @property
    def loss_scale(self) -> float:
        return float(self.loss_scale_state.cur_scale)

    @property
    def global_step(self) -> int:
        """Applied updates."""
        return int(self._global_step)

    @property
    def skipped_steps(self) -> int:
        return int(self._skipped)

    def get_global_step(self) -> int:
        return self.global_step

    def zero_optimization_stage(self) -> int:
        return self.zero_stage

    def sparse_attention_config(self):
        """The ``sparse_attention`` config section (None when absent), for a
        client model to feed ``ops.sparse_attention.from_ds_config`` or
        ``gpt2.get_config(..., sparse_attention=...)``."""
        return self.config.sparse_attention
