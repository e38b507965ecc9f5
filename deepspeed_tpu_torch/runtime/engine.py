"""DeepSpeedEngine — the single-device training engine (counterpart of
``deepspeed_tpu/runtime/engine.py`` ``DeepSpeedEngine`` on a one-device
mesh with ZeRO stage 0).

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

from .. import telemetry as _telemetry
from ..inference.engine import resolve_device
from ..ops import prng
from ..utils import graphs
from ..utils.logging import log_dist, warning_once
from ..utils.timer import TRAIN_BATCH_TIMER, SynchronizedWallClockTimer, ThroughputTimer
from ..utils.weights import tree_leaves, tree_map
from .config import DeepSpeedConfig
from .fp16 import loss_scaler as ls
from .lr_schedules import get_lr_schedule, tensor_form
from .module import ModuleSpec
from .optimizers import build_optimizer, optax_state_paths

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
        self.module = model
        self.device = resolve_device(device)
        config = DeepSpeedConfig.load(config)
        self.config = config

        # --- precision
        self.fp16_enabled = config.fp16.enabled
        self.bf16_enabled = config.bf16.enabled
        self.compute_dtype = config.compute_dtype
        self.dynamic_loss_scale = config.fp16.enabled and config.fp16.dynamic_loss_scale
        self.grad_accum_dtype = _ACC_DTYPES[config.data_types.grad_accum_dtype]
        self.zero_stage = 0

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
        self.params = tree_map(
            lambda p: p.detach().to(device=self.device,
                                    dtype=torch.float32 if p.is_floating_point() else p.dtype,
                                    copy=True),
            params,
        )
        self.opt_state = self.optimizer.init(self.params)
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
            f"DeepSpeedEngine initialized: device={self.device} zero_stage=0 "
            f"precision={precision} batch=({self.train_batch_size_value}="
            f"{self.micro_batch_size}x{self.gradient_accumulation_steps_value}x1)"
        )

    # ------------------------------------------------------------------
    # data plumbing
    # ------------------------------------------------------------------
    def _host_batch(self, batch: PyTree) -> List[Tuple[Tuple, np.ndarray]]:
        """A host batch ``[train_batch_size, ...]`` → its leaves as numpy
        ``[gas, micro, ...]`` (integer leaves as int64, the index dtype)."""
        gas = self.gradient_accumulation_steps_value
        out = []
        for path, x in _flatten(batch):
            a = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            if a.shape[0] != self.train_batch_size_value:
                raise ValueError(
                    f"batch dim {a.shape[0]} != train_batch_size {self.train_batch_size_value}"
                )
            if not np.issubdtype(a.dtype, np.floating):
                a = a.astype(np.int64)
            out.append((path, a.reshape(gas, -1, *a.shape[1:])))
        return out

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
        table, or the key itself), uint32 ``[T, 2]``."""
        kt = self.module.key_table
        return np.asarray(kt(key) if kt is not None else key[None], np.uint32)

    def _program(self, kind: str, leaves, n_keys: int) -> graphs.CapturedProgram:
        sig = (kind, n_keys, tuple((p, a.shape, a.dtype.str) for p, a in leaves))
        prog = self._programs.get(sig)
        if prog is None:
            T = len(self._key_rows(self._rng))
            shapes = {str(i): (a.shape, torch.from_numpy(a[:0]).dtype)
                      for i, (_, a) in enumerate(leaves)}
            shapes["keys"] = (n_keys, T, 2)
            inputs = graphs.StaticInputs(shapes, self.device)
            batch = _unflatten([(p, inputs.dev[str(i)]) for i, (p, _) in enumerate(leaves)])
            keys = inputs.dev["keys"] if self.module.key_table is not None \
                else inputs.dev["keys"][:, 0]
            fn = (self._train_fn if kind == "train" else self._eval_fn)(batch, keys)
            prog = graphs.CapturedProgram(f"{kind}_step", fn, self.device, inputs,
                                          copy_outputs=True)
            self._programs[sig] = prog
        return prog

    @property
    def jit_step_cache_size(self) -> int:
        """The training programs built (JAX: the jitted step's cache size)."""
        return sum(1 for sig in self._programs if sig[0] == "train")

    def _train_fn(self, batch: PyTree, keys: torch.Tensor) -> Callable[[], Dict]:
        """The step function over the program's static inputs: ``batch``'s
        leaves ``[gas, micro, ...]`` and ``keys [gas, T, 2]`` (or ``[gas,
        2]``) on the device → the metrics as device tensors."""
        cfg = self.config
        gas = self.gradient_accumulation_steps_value
        fp16 = self.fp16_enabled
        predivide, factor = cfg.prescale_gradients, cfg.gradient_predivide_factor
        clip = cfg.gradient_clipping
        # the watchdog's in-step bitmask (JAX engine.py:132-134)
        flags = self._watchdog is not None and bool(cfg.telemetry.watchdog.nan_check)
        lss = self.loss_scale_state

        def step():
            scale = lss.cur_scale if fp16 else 1.0
            # 1. one cast of the master per step; its leaves are what autograd
            # differentiates (d loss / d master is the upcast of these grads)
            cparams = tree_map(lambda p: p.detach().to(self.compute_dtype).requires_grad_(True)
                               if p.is_floating_point() else p, self.params)
            leaves = tree_leaves(cparams)
            # 2. accumulate the micro-batches' grads in grad_accum_dtype, each
            # under its key rows (JAX engine.py:1212, :1236, :1252)
            acc = None
            loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
            for i in range(gas):
                micro = tree_map(lambda x: x[i], batch)
                loss, _ = self.module.loss_fn(cparams, micro, keys[i], True)
                grads = torch.autograd.grad(loss.float() * scale, leaves, allow_unused=True,
                                            materialize_grads=True)
                if predivide:
                    grads = [g / factor for g in grads]
                grads = [g.to(self.grad_accum_dtype) for g in grads]
                if acc is None:
                    acc = grads
                else:
                    for a, g in zip(acc, grads):
                        a.add_(g)
                loss_sum = loss_sum + loss.detach().float()
            del cparams, leaves
            # 3. unscale and average over gas in f32
            inv = 1.0 / (scale * gas) if fp16 else 1.0 / gas
            grads = [g.float() * inv for g in acc]
            if predivide and factor != 1.0:
                grads = [g * factor for g in grads]
            # 4. overflow (fp16 only), a device flag: zero the gradients
            overflow = (ls.has_inf_or_nan(grads) if fp16
                        else torch.zeros((), dtype=torch.bool, device=self.device))
            if fp16:
                grads = [torch.where(overflow, 0.0, g) for g in grads]
            # 5. global norm and clipping
            gnorm = global_norm(grads)
            if clip > 0.0:
                coef = torch.clamp(clip / (gnorm + 1e-6), max=1.0)
                grads = [g * coef for g in grads]
            # 6. the update, skipped on overflow; the scale and the counts
            lr = self._lr_at(self._global_step)
            self.optimizer.step(self.params, grads, self.opt_state,
                                skip=overflow if fp16 else None)
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

    def _eval_fn(self, batch: PyTree, keys: torch.Tensor) -> Callable[[], torch.Tensor]:
        """The eval step over the program's inputs: the mean eval-mode loss
        of the ``gas`` micro-batches, each under ``keys[0]``."""
        n = self.gradient_accumulation_steps_value

        @torch.no_grad()
        def step():
            cparams = _cast(self.params, self.compute_dtype)
            total = torch.zeros((), dtype=torch.float32, device=self.device)
            for i in range(n):
                micro = tree_map(lambda x: x[i], batch)
                loss, _ = self.module.loss_fn(cparams, micro, keys[0], False)
                total = total + loss.float()
            return total / n

        return step

    def _stage(self, kind: str, batch: PyTree, keys: List[np.ndarray]):
        """The program for ``batch``'s signature, its staging arrays filled
        with the batch and the key rows of ``keys`` (one key a row)."""
        leaves = self._host_batch(batch)
        prog = self._program(kind, leaves, len(keys))
        staging = prog.inputs.staging()
        for i, (_, a) in enumerate(leaves):
            np.copyto(staging[str(i)], a, casting="unsafe")
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
            hbm=self.memory_breakdown(),
            comm_bytes={},  # one device: no collective (a one-device mesh's record)
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
        logged each ``steps_per_print`` when ``memory_breakdown`` is on."""
        return _telemetry.device_hbm_stats(self.device)

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

    def _write_state(self, host: Dict[str, torch.Tensor]) -> None:
        """Copy host tensors into the engine's state tensors IN PLACE (a
        captured program reads them by address; rebinding would leave it
        on the old ones), then derive the step count the keys fold from the
        restored counters. A leaf held under two names must get the same
        value from both."""
        leaves = self.state_leaves()
        seen: Dict[int, Tuple[str, torch.Tensor]] = {}
        with torch.no_grad():
            for name, src in host.items():
                dst = leaves[name]
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
        self._write_state(host_state)
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
        file, written before this returns."""
        t0 = time.perf_counter()
        tag = tag or f"global_step{self.get_global_step()}"
        # checkpoint.tag_validation compares the tag across processes: one
        # process has nothing to compare (the JAX engine's process_count() == 1)
        if self.config.resilience.enabled:
            return self._save_checkpoint_resilient(save_dir, tag, client_state, save_latest,
                                                   blocking, t0)
        from ..checkpoint.engine import save_train_state

        path = save_train_state(
            save_dir, tag, self.state_leaves(),
            client_state={**(client_state or {}), "global_steps": self.global_steps},
            save_latest=save_latest)
        log_dist(f"saved checkpoint: {path}")
        if self.telemetry is not None:
            self.telemetry.record_event("checkpoint_save", time.perf_counter() - t0,
                                        {"step": self.global_steps, "tag": tag,
                                         "path": str(path)})
        return path

    def _save_checkpoint_resilient(self, save_dir, tag, client_state, save_latest, blocking,
                                   t0) -> str:
        from ..resilience.writer import snapshot_to_host

        rcfg = self.config.resilience
        writer = self._checkpoint_writer(save_dir)
        # the snapshot is the step path's whole cost: pinned host copies,
        # reused across saves once the writer is done with the last one
        idle = all(w.in_flight == 0 for w in self._ckpt_writers.values())
        reuse = self._snap_bufs if idle else None
        arrays = snapshot_to_host(self.state_leaves(), out=reuse,
                                  extra={"__rng__": np.asarray(self._rng, np.uint32)})
        self._snap_bufs = {k: v for k, v in arrays.items() if isinstance(v, torch.Tensor)
                           and v.is_pinned()}
        self.last_snapshot_s = time.perf_counter() - t0
        client = {**(client_state or {}), "global_steps": self.global_steps,
                  "resilience_counters": self._resilience_counter_values()}
        block = (not rcfg.async_checkpoint) if blocking is None else bool(blocking)
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
        engine's optimizer state. The learning rate is the schedule at the
        restored count, so ``load_lr_scheduler_states`` changes nothing."""
        from ..resilience.recovery import is_resilient_dir

        if is_resilient_dir(load_dir, tag):
            return self._load_checkpoint_resilient(load_dir, tag, load_optimizer_states)
        from ..checkpoint.engine import load_train_state

        t0 = time.perf_counter()
        state, client_state = load_train_state(load_dir, tag, self.state_leaves(),
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
            load_dir, tag, self.state_leaves(), load_optimizer_states=load_optimizer_states,
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
