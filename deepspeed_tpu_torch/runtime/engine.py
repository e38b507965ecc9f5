"""DeepSpeedEngine — the single-device training engine (counterpart of
``deepspeed_tpu/runtime/engine.py`` ``DeepSpeedEngine`` on a one-device
mesh with ZeRO stage 0).

The JAX engine compiles the whole step into one XLA program; here it runs
eagerly, in the same order (``_make_train_step``, engine.py:1106-1345):

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
   fused kernel on the card) updates the master in place, unless the step
   overflowed: then params and optimizer state stay, ``skipped_steps``
   counts it, and the loss scaler updates either way.

The random keys follow the JAX engine's schedule, on the host: the engine
key is ``PRNGKey(seed + 1)``; a step's key is ``fold_in(rng, global_step +
skipped_steps)`` (skipped fp16 steps keep keys unique), micro-batch i's
``fold_in(step_key, i)``; ``eval_batch`` without a key splits the engine
key, and ``forward`` evaluates under ``fold_in(rng, 0x5EED)``, leaving the
training stream untouched.

The fp16 overflow flag is the only value the step reads back on the host;
bf16 and fp32 steps do not synchronise. ``device=None`` means the CUDA
card, which must exist; pass ``device="cpu"`` for the CPU.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from ..inference.engine import resolve_device
from ..ops import prng
from ..utils.logging import log_dist, warning_once
from ..utils.weights import tree_leaves, tree_map
from .config import DeepSpeedConfig
from .fp16 import loss_scaler as ls
from .lr_schedules import get_lr_schedule
from .module import ModuleSpec
from .optimizers import build_optimizer

PyTree = Any

_ACC_DTYPES = {None: torch.float32, "fp32": torch.float32, "fp16": torch.float16,
               "bf16": torch.bfloat16}


def global_norm(leaves) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares."""
    return torch.sqrt(torch.stack([x.float().square().sum() for x in leaves]).sum())


def _cast(params: PyTree, dtype: torch.dtype) -> PyTree:
    return tree_map(lambda p: p.to(dtype) if p.is_floating_point() else p, params)


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
        self.optimizer = build_optimizer(opt_cfg.type if opt_cfg else "Adam",
                                         opt_cfg.params if opt_cfg else {"lr": base_lr},
                                         learning_rate=lr_schedule)

        # --- state: the fp32 master (an owned copy), optimizer state, loss scale
        if params is None:
            params = model.init(torch.Generator(device=self.device).manual_seed(int(seed)))
        self.params = tree_map(
            lambda p: p.detach().to(device=self.device,
                                    dtype=torch.float32 if p.is_floating_point() else p.dtype,
                                    copy=True),
            params,
        )
        self.opt_state = self.optimizer.init(self.params)
        self.loss_scale_state = ls.from_config(config.fp16)
        self.global_step = 0        # applied updates
        self._skipped_steps = 0     # overflow-skipped updates
        self.global_steps = 0       # train_batch calls
        # the training stream (JAX engine.py:262-265): a host key
        self._rng = prng.PRNGKey(int(seed) + 1)
        # the reference-loop shim's state (forward / backward / step)
        self._pending_batch = None
        self._backward_called = False

        self.micro_batch_size = config.train_micro_batch_size_per_gpu
        self.gradient_accumulation_steps_value = config.gradient_accumulation_steps
        self.train_batch_size_value = config.train_batch_size
        self.steps_per_print = config.steps_per_print

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
    def shard_batch(self, batch: PyTree) -> PyTree:
        """Host batch ``[train_batch_size, ...]`` → device tensors ``[gas,
        micro, ...]`` (integer leaves as int64, the index dtype)."""
        gas = self.gradient_accumulation_steps_value

        def put(x):
            t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
            if t.shape[0] != self.train_batch_size_value:
                raise ValueError(
                    f"batch dim {t.shape[0]} != train_batch_size {self.train_batch_size_value}"
                )
            if not t.is_floating_point():
                t = t.long()
            return t.reshape(gas, -1, *t.shape[1:]).to(self.device, non_blocking=True)

        return tree_map(put, batch)

    def deepspeed_io(self, dataset, collate_fn=None):
        """The training loader (reference ``deepspeed_io``)."""
        from .dataloader import DeepSpeedDataLoader

        return DeepSpeedDataLoader(dataset, batch_size=self.train_batch_size_value,
                                   collate_fn=collate_fn)

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    def _train_step(self, batch: PyTree) -> Dict[str, Any]:
        cfg = self.config
        gas = self.gradient_accumulation_steps_value
        fp16 = self.fp16_enabled
        scale = self.loss_scale_state.cur_scale if fp16 else 1.0
        predivide, factor = cfg.prescale_gradients, cfg.gradient_predivide_factor

        # 1. one cast of the master per step; its leaves are what autograd
        # differentiates (d loss / d master is the upcast of these grads)
        cparams = tree_map(lambda p: p.detach().to(self.compute_dtype).requires_grad_(True)
                           if p.is_floating_point() else p, self.params)
        leaves = tree_leaves(cparams)
        # 2. accumulate the micro-batches' grads in grad_accum_dtype; the keys
        # as the JAX step folds them (engine.py:1212, :1236, :1252)
        step_rng = prng.fold_in(self._rng, self.global_step + self._skipped_steps)
        acc = None
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for i in range(gas):
            micro = tree_map(lambda x: x[i], batch)
            loss, _ = self.module.loss_fn(cparams, micro, prng.fold_in(step_rng, i), True)
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
        inv = float(np.float32(1.0) / np.float32(scale * gas))
        grads = [g.float() * inv for g in acc]
        if predivide and factor != 1.0:
            grads = [g * factor for g in grads]
        # 4. overflow (fp16 only: the step's one host read)
        overflow = bool(ls.has_inf_or_nan(grads)) if fp16 else False
        if overflow:
            grads = [torch.zeros_like(g) for g in grads]
        # 5. global norm and clipping
        gnorm = global_norm(grads)
        if cfg.gradient_clipping > 0.0:
            coef = torch.clamp(cfg.gradient_clipping / (gnorm + 1e-6), max=1.0)
            grads = [g * coef for g in grads]
        # 6. the update, skipped on overflow
        lr = float(self.lr_schedule(self.global_step))
        if not overflow:
            self.optimizer.step(self.params, grads, self.opt_state)
        self.loss_scale_state = ls.update(
            self.loss_scale_state, overflow, dynamic=self.dynamic_loss_scale,
            scale_window=cfg.fp16.loss_scale_window, min_scale=cfg.fp16.min_loss_scale,
        )
        self.global_step += 0 if overflow else 1
        self._skipped_steps += 1 if overflow else 0
        return {
            "loss": loss_sum / gas,
            "grad_norm": gnorm,
            "loss_scale": scale,
            "overflow": overflow,
            "lr": lr,
            "global_step": self.global_step,
        }

    # ------------------------------------------------------------------
    # public training surface
    # ------------------------------------------------------------------
    def train_batch(self, batch: Optional[PyTree] = None,
                    data_iter: Optional[Iterator] = None) -> Dict[str, Any]:
        """One full training step (``gas`` micro-batches and the update) on a
        host batch with leading dim ``train_batch_size``, or on the next
        batch of ``data_iter`` / the training loader. → ``{loss, grad_norm,
        loss_scale, overflow, lr, global_step}`` (loss and grad_norm are
        device scalars: reading them synchronises)."""
        if batch is None:
            if data_iter is None:
                if self._data_iterator is None:
                    from .dataloader import RepeatingLoader

                    if self.training_dataloader is None:
                        raise ValueError("train_batch() without a batch requires training_data")
                    self._data_iterator = iter(RepeatingLoader(self.training_dataloader))
                data_iter = self._data_iterator
            batch = next(data_iter)
        metrics = self._train_step(self.shard_batch(batch))
        self.global_steps += 1
        if self.global_steps % self.steps_per_print == 0:
            log_dist(
                f"step={metrics['global_step']} loss={float(metrics['loss']):.4f} "
                f"lr={metrics['lr']:.3e} gnorm={float(metrics['grad_norm']):.3f} "
                f"scale={metrics['loss_scale']:.0f}"
            )
        return metrics

    @torch.no_grad()
    def eval_batch(self, batch: PyTree, rng=None) -> torch.Tensor:
        """Mean eval-mode loss over the batch's ``gas`` micro-batches.
        ``rng``: the key handed to the model; without one, a fresh key is
        split off the engine's (JAX engine.py:2337-2346)."""
        device_batch = self.shard_batch(batch)
        cparams = _cast(self.params, self.compute_dtype)
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        n = self.gradient_accumulation_steps_value
        if rng is None:
            self._rng, rng = prng.split(self._rng)
        for i in range(n):
            micro = tree_map(lambda x: x[i], device_batch)
            loss, _ = self.module.loss_fn(cparams, micro, rng, False)
            total = total + loss.float()
        return total / n

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
    # properties (reference engine property surface)
    # ------------------------------------------------------------------
    @property
    def train_batch_size(self) -> int:
        return self.train_batch_size_value

    @property
    def gradient_accumulation_steps(self) -> int:
        return self.gradient_accumulation_steps_value

    @property
    def loss_scale(self) -> float:
        return self.loss_scale_state.cur_scale

    @property
    def skipped_steps(self) -> int:
        return self._skipped_steps

    def get_global_step(self) -> int:
        return self.global_step

    def zero_optimization_stage(self) -> int:
        return self.zero_stage

    def sparse_attention_config(self):
        """The ``sparse_attention`` config section (None when absent), for a
        client model to feed ``ops.sparse_attention.from_ds_config`` or
        ``gpt2.get_config(..., sparse_attention=...)``."""
        return self.config.sparse_attention
