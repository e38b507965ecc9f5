"""Inference engine: a model's parameters on a device, in a dtype
(counterpart of ``deepspeed_tpu/inference/engine.py``).

The model comes from one of the JAX engine's sources
(``deepspeed_tpu/inference/engine.py:205-255``):

- a ``GPT2Config`` (or a preset name) with ``params`` or the seeded
  initialiser; a ``DecoderConfig`` (``models/decoder.py``) with
  ``params``, which has no initialiser; a ``BertConfig`` with ``params``
  or the seeded initialiser;
- ``model=<HF torch module>`` (or the module as the first argument):
  converted once through its injection policy (``module_inject``; the
  kinds gpt2, decoder and bert), ``injection_policy`` to pick one;
- ``checkpoint=<dir>`` (or the config's ``checkpoint``): an HF checkpoint
  directory streamed layer by layer (``module_inject/load_checkpoint.py``).
  ``checkpoint`` beside ``model``/``params`` is refused, as in JAX.

The engine casts the floating leaves to ``dtype`` (bf16 by default, as the
JAX package does) and places them on ``device``. Then: :meth:`generate`
(offline generation over a contiguous KV cache for GPT-2, prompts padded
to length buckets, and for the decoder; BERT takes the JAX engine's
full-prefix recompute), :meth:`forward` / ``engine(batch)`` (the model's
output for a batch: one compiled program per input signature, as the JAX
engine jits ``apply_fn``, ``inference/engine.py:308``; a captured graph on
the card), and :meth:`serve` (a continuous-batching
:class:`ServingEngine`, GPT-2 only, as JAX's is).

``generate`` keeps the JAX engine's compiled-generate contract
(``deepspeed_tpu/inference/engine.py:176-184``, ``:426-460``): one entry a
key ``((B, bucket or S), max_new_tokens, temperature, top_k, top_p)`` in
the LRU ``_generate_cache``, capped by ``generate_cache_size`` (default
16), ``generate_cache_evictions`` counting what the cap pushed out. An
entry (:class:`GenerateProgram`) holds the KV cache, the static buffers
and two programs of ``utils/graphs.py``, the prefill and the decode step,
captured CUDA graphs on the card; a prompt bucketed to the key's width
reuses its entry at any true length, which is a device input, as JAX
traces it. An evicted entry frees its cache and its graphs' pools.
``device=None`` means the CUDA card: without one the engine raises instead
of running on the CPU; pass ``device="cpu"`` to ask for the CPU.

Weight-only int8 follows the JAX engine (``inference/engine.py:134-149``,
``:262-271``): ``dtype="int8"`` means 8-bit weights with bf16 compute;
``quantization_setting`` (groups, or ``(mlp_extra_grouping, groups)``,
whose last element counts) or ``quantize_bits=8`` turns it on at the given
dtype; the groups default to 1. The fp32 tree goes through
``ops.quantizer.quantize_tree``: the stacked block weights become int8
codes with per-group scales in the compute dtype, every other float leaf
is cast to it, and the models dequantize at each use. ``generate`` and
``serve`` run on that tree, with or without int8 KV pages. Sampling draws
with JAX's keys: ``generate(seed=s)`` uses ``PRNGKey(s)``.

Telemetry follows the JAX engine (``inference/engine.py:114``,
``:191-203``, ``:316``, ``:361-390``, ``:455-470``): a ``telemetry``
section in ``config`` builds the plane (``deepspeed_tpu_torch.telemetry``)
as ``self.telemetry``; ``forward`` counts ``inference_forward_total``, each
``generate`` call emits one ``inference_step`` record with its
``compiled_cache_hit`` flag (timed on ``time.perf_counter`` around a call
that already ends in its one device read), the LRU counts
``generate_cache_evictions_total`` and sets ``generate_cache_size``, and
``serve`` hands the plane (or the ``tracer``/``heat_tracer``/``journal``
given) to the serving engine.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ..models import bert, decoder, gpt2
from ..models.bert import BertConfig
from ..models.decoder import DecoderConfig
from ..models.gpt2 import GPT2Config
from ..ops import prng
from ..ops.quantizer import quantize_tree
from ..ops.sampling import sample_logits
from ..runtime.config import DeepSpeedConfigError, NotPortedError, TelemetryConfig
from ..telemetry import device_hbm_stats
from ..telemetry import from_config as telemetry_from_config
from ..utils.graphs import CapturedProgram, StaticInputs
from ..utils.logging import log_dist
from ..utils.weights import params_from_numpy, tree_map

PyTree = Any

_DTYPE_NAMES = {
    "fp16": torch.float16, "half": torch.float16, "float16": torch.float16,
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "fp32": torch.float32, "float": torch.float32, "float32": torch.float32,
}


def _is_int8(d) -> bool:
    return d is torch.int8 or str(d).lower().replace("torch.", "") == "int8"


def _parse_dtype(d) -> torch.dtype:
    if isinstance(d, torch.dtype):
        if d not in _DTYPE_NAMES.values():
            raise ValueError(f"unsupported inference dtype {d}")
        return d
    key = str(d).lower().replace("torch.", "")
    if key not in _DTYPE_NAMES:
        raise ValueError(f"unknown inference dtype {d!r}")
    return _DTYPE_NAMES[key]


# model kind → its functions (models/)
_MODULES = {"gpt2": gpt2, "decoder": decoder, "bert": bert}
_KINDS = ((GPT2Config, "gpt2"), (DecoderConfig, "decoder"), (BertConfig, "bert"))


def _is_torch_module(model) -> bool:
    """An HF (or any torch) model to inject, as the JAX engine tells one."""
    return type(model).__module__.startswith("transformers") or isinstance(model, torch.nn.Module)


def _on_device(params: PyTree, device) -> PyTree:
    """A given tree (tensors, or the JAX package's numpy arrays) on
    ``device``."""
    return tree_map(lambda p: p.to(device) if torch.is_tensor(p)
                    else params_from_numpy(p, device), params)


def resolve_device(device=None) -> torch.device:
    """``None`` → the CUDA card, which must exist; anything else as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "deepspeed_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev


class InferenceEngine:
    def __init__(
        self,
        model_config: Union[GPT2Config, DecoderConfig, BertConfig, str, Any] = "gpt2",
        params: Optional[PyTree] = None,
        dtype=None,
        device=None,
        seed: int = 0,
        config: Optional[Dict] = None,
        quantize_bits: Optional[int] = None,
        quantize_groups: Optional[int] = None,
        model: Any = None,
        injection_policy: Optional[type] = None,
        checkpoint: Optional[str] = None,
    ):
        c = dict(config or {})
        cfg_dtype = c.pop("dtype", None)
        cfg_ckpt = c.pop("checkpoint", None)
        # the JAX call style's switch: an HF module is always injected here
        c.pop("replace_with_kernel_inject", None)
        q = c.pop("quantization_setting", None)
        self._serving_config = c.pop("serving", None)
        cfg_max = c.pop("max_out_tokens", c.pop("max_tokens", None))
        self.max_tokens = int(cfg_max if cfg_max is not None else 1024)
        # None: power-of-two prompt buckets; a list pins the sizes; [] or
        # False turns bucketing off
        self._prompt_buckets = c.pop("prompt_bucket_sizes", None)
        # the compiled-generate cache, LRU-bounded as the JAX engine's: an
        # entry holds a KV cache and two captured graphs
        cache_size = c.pop("generate_cache_size", None)
        self._generate_cache: "OrderedDict[tuple, GenerateProgram]" = OrderedDict()
        self._generate_cache_cap = max(1, int(cache_size if cache_size is not None else 16))
        self.generate_cache_evictions = 0
        # the compiled forward: one program per input shape
        self._forward_programs: Dict[tuple, CapturedProgram] = {}
        # the telemetry plane (the same TelemetryConfig schema as the JAX
        # package's): registry, step records, the serving planes
        cfg_tel = c.pop("telemetry", None)
        self.telemetry = None
        self._infer_steps = 0
        if cfg_tel is not None:
            tcfg = (TelemetryConfig.from_dict(cfg_tel) if isinstance(cfg_tel, dict)
                    else cfg_tel)
            self.telemetry = telemetry_from_config(tcfg)
        if c:
            raise NotPortedError(
                f"init_inference: config keys {sorted(c)} are not ported to "
                "deepspeed_tpu_torch yet"
            )
        if model is None and _is_torch_module(model_config):
            model, model_config = model_config, None
        checkpoint = checkpoint if checkpoint is not None else cfg_ckpt
        if checkpoint is not None and (model is not None or params is not None):
            raise ValueError(
                "pass either checkpoint= or model=/params= to init_inference, not both "
                "(one source would silently shadow the other's weights)")
        dtype = dtype if dtype is not None else (
            cfg_dtype if cfg_dtype is not None else torch.bfloat16)
        # quantization_setting: groups, or (mlp_extra_grouping, groups); none
        # means 1 group (JAX inference/engine.py:134-149)
        cfg_groups = None if q is None else int(q[-1] if isinstance(q, (tuple, list)) else q)
        self.quantize_groups = int(quantize_groups if quantize_groups is not None
                                   else (cfg_groups if cfg_groups is not None else 1))
        bits = int(quantize_bits if quantize_bits is not None else (8 if q is not None else 0))
        if _is_int8(dtype):
            # dtype=int8 means 8-bit weights, bf16 compute
            bits, dtype = 8, torch.bfloat16
        if bits not in (0, 8):
            raise NotPortedError(f"quantize_bits={bits}: weight quantization is 8-bit only "
                                 "(as in the JAX package)")
        self.quantized = bits == 8
        self.dtype = _parse_dtype(dtype)
        self.device = resolve_device(device)
        if checkpoint is not None:
            from ..module_inject.load_checkpoint import load_checkpoint_streamed

            self.kind, model_config, params = load_checkpoint_streamed(checkpoint,
                                                                       dtype=self.dtype)
        elif model is not None:
            if not _is_torch_module(model):
                raise DeepSpeedConfigError(
                    f"init_inference(model=...) takes an HF torch module; got "
                    f"{type(model).__name__}")
            from ..module_inject.replace_module import replace_transformer_layer

            # fp32 on the host: the cast or the quantization below happens
            # once, on the device, as for every other source
            self.kind, model_config, params = replace_transformer_layer(
                model, policy=injection_policy, dtype=torch.float32)
        else:
            if isinstance(model_config, str):
                model_config = gpt2.get_config(model_config)
            self.kind = next((k for cls, k in _KINDS if isinstance(model_config, cls)), None)
            if self.kind is None:
                raise DeepSpeedConfigError(
                    "InferenceEngine serves GPT2Config, DecoderConfig and BertConfig models "
                    f"(or an HF module, or a checkpoint directory); got "
                    f"{type(model_config).__name__}")
        self.model_config = model_config
        self.model_module = _MODULES[self.kind]
        if params is None:
            if self.kind == "decoder":
                raise ValueError(
                    "a DecoderConfig has no initializer (the decoder family is built from "
                    "converted checkpoints); pass params=, model=<HF module> or "
                    "checkpoint=<dir>")
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
            params = self.model_module.init_params(model_config, gen, self.device,
                                                   torch.float32)
        params = _on_device(params, self.device)
        if self.quantized:
            # from the given (fp32) weights, once, on the device
            params = quantize_tree(params, groups=self.quantize_groups, dtype=self.dtype)
        else:
            params = tree_map(
                lambda p: p.to(self.dtype) if p.is_floating_point() else p, params)
        self.params = params
        log_dist(
            f"InferenceEngine: {self.kind} device={self.device} "
            f"dtype={str(self.dtype).replace('torch.', '')} quantized={self.quantized}"
            + (f" (groups {self.quantize_groups})" if self.quantized else "")
        )

    def _apply(self, inputs: Dict[str, torch.Tensor]):
        """The model's inference forward (the JAX module's ``apply_fn``):
        GPT-2's and the decoder's logits ``[B, S, V]``, BERT's last hidden
        state ``[B, S, E]``."""
        ids = inputs["input_ids"]
        if self.kind == "bert":
            return bert.forward(self.model_config, self.params, ids,
                                inputs.get("attention_mask"), inputs.get("token_type_ids"))[0]
        return self.model_module.forward(self.model_config, self.params, ids)

    def forward(self, batch):
        """The output of ``batch`` (``input_ids [B, S]``, and BERT's
        optional ``attention_mask`` / ``token_type_ids``; host tensors or
        arrays): the program of its signature in ``_forward_programs``
        (built at first use; on the card a captured graph over the
        kernels, replayed), its inputs uploaded in one copy; the output is
        the caller's (a device copy of the program's)."""
        names = ("input_ids",) + (("attention_mask", "token_type_ids") if self.kind == "bert"
                                  else ())
        host = {}
        for name in names:
            x = batch.get(name) if hasattr(batch, "get") else None
            if x is not None:
                host[name] = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                              else np.asarray(x))
        sig = tuple((name, x.shape) for name, x in host.items())
        # keyed by the ids' shape (BERT's with a mask or token types: by
        # every input's)
        key = sig[0][1] if len(sig) == 1 else sig
        prog = self._forward_programs.get(key)
        if prog is None:
            inputs = StaticInputs({name: (shape, torch.int64) for name, shape in sig},
                                  self.device)
            dev = dict(inputs.dev)

            @torch.no_grad()
            def step():
                return self._apply(dev)

            prog = CapturedProgram("forward", step, self.device, inputs, copy_outputs=True)
            self._forward_programs[key] = prog
        if self.telemetry is not None:
            # a count only: nothing reads the device
            self.telemetry.registry.counter(
                "inference_forward_total", "compiled forward calls").inc()
        staging = prog.inputs.staging()
        for name, x in host.items():
            np.copyto(staging[name], x, casting="unsafe")
        return prog()

    __call__ = forward

    def _prompt_bucket(self, S: int, max_new_tokens: int) -> Optional[int]:
        """The padded prompt length for ``generate``, or None when bucketing
        is off (``prompt_bucket_sizes: []`` or ``False``). Default: the next
        power of two; a list pins the sizes (the next power of two past the
        largest). Capped so that bucket + max_new_tokens fits n_positions,
        and never below the true length."""
        b = self._prompt_buckets
        if b is False or (isinstance(b, (list, tuple)) and len(b) == 0):
            return None
        cap = int(self.model_config.n_positions) - int(max_new_tokens)
        if isinstance(b, (list, tuple)):
            fits = sorted(int(x) for x in b if int(x) >= S)
            bucket = fits[0] if fits else 1 << max(0, S - 1).bit_length()
        else:
            bucket = 1 << max(0, S - 1).bit_length()
        return max(S, min(bucket, cap))

    def generate(self, input_ids, max_new_tokens: int = 20, temperature: float = 0.0,
                 seed: int = 0, top_k: int = 0, top_p: float = 1.0) -> np.ndarray:
        """Autoregressive generation over a contiguous KV cache (GPT-2 and
        the decoder): the prompt (GPT-2's padded to its bucket unless
        bucketing is off; the decoder's as it is, as in JAX) prefills once,
        then ``max_new_tokens - 1`` single-token decode steps, each running
        the decode kernel once per layer on the card where the model's
        routes take it; both are programs of this key's cache entry
        (captured graphs on the card, replayed). Greedy unless
        ``temperature > 0``; then the draws are the JAX engine's under
        ``PRNGKey(seed)`` (the threefry kernel on the card). BERT has no
        cache: the JAX engine's full-prefix recompute. → prompt + new
        tokens, ``[B, S + max_new_tokens]`` numpy, read from the device
        once at the end."""
        ids_np = np.asarray(input_ids)
        t_gen0 = time.perf_counter() if self.telemetry is not None else 0.0
        B, S = ids_np.shape
        if S + int(max_new_tokens) > int(self.model_config.n_positions):
            raise ValueError(
                f"prompt ({S}) + max_new_tokens ({max_new_tokens}) exceeds n_positions "
                f"{self.model_config.n_positions}")
        if self.kind == "bert":
            result = self._generate_recompute(ids_np, int(max_new_tokens), float(temperature),
                                              int(seed), int(top_k), float(top_p))
            if self.telemetry is not None:
                self._telemetry_generate(time.perf_counter() - t_gen0, B, S,
                                         int(max_new_tokens), None)
            return result
        bucket = self._prompt_bucket(S, max_new_tokens) if self.kind == "gpt2" else None
        shape_key = (B, bucket) if bucket is not None else (B, S)
        key = (shape_key, int(max_new_tokens), float(temperature), int(top_k), float(top_p))
        prog = self._generate_cache.get(key)
        was_cached = prog is not None
        if was_cached:
            self._generate_cache.move_to_end(key)  # LRU freshness
        else:
            prog = GenerateProgram(self, B, shape_key[1], int(max_new_tokens),
                                   float(temperature), int(top_k), float(top_p))
            self._generate_cache[key] = prog
            while len(self._generate_cache) > self._generate_cache_cap:
                _, old = self._generate_cache.popitem(last=False)  # the LRU entry
                old.free()
                self.generate_cache_evictions += 1
                if self.telemetry is not None:
                    self.telemetry.registry.counter(
                        "generate_cache_evictions_total",
                        "compiled-generate executables evicted by the LRU cap",
                    ).inc()
            if self.telemetry is not None:
                self.telemetry.registry.gauge(
                    "generate_cache_size", "live compiled-generate executables"
                ).set(len(self._generate_cache))
        new = prog(ids_np, seed)
        result = np.concatenate([ids_np, new.astype(ids_np.dtype)], axis=1)
        if self.telemetry is not None:
            self._telemetry_generate(time.perf_counter() - t_gen0, B, S,
                                     int(max_new_tokens), was_cached)
        return result

    @torch.no_grad()
    def _generate_recompute(self, ids_np: np.ndarray, max_new_tokens: int, temperature: float,
                            seed: int, top_k: int, top_p: float) -> np.ndarray:
        """The JAX engine's fallback for a model without a cache: the whole
        prefix forward for every token, the last row sampled (each step's
        key split off the running one)."""
        rng = prng.PRNGKey(seed)
        ids = torch.as_tensor(ids_np, dtype=torch.int64, device=self.device)
        for _ in range(max_new_tokens):
            last = self._apply({"input_ids": ids})[:, -1, :].float()
            rng, k = prng.split(rng)
            nxt = sample_logits(last, k if temperature > 0.0 else None, temperature, top_k,
                                top_p)
            ids = torch.cat([ids, nxt[:, None].to(ids.dtype)], dim=1)
        return ids.cpu().numpy().astype(ids_np.dtype)

    def _telemetry_generate(self, duration_s: float, batch: int, prompt_len: int,
                            new_tokens: int, cached: Optional[bool]) -> None:
        """One ``inference_step`` record and registry fold a ``generate``
        call (the call already ended in its device read, so this adds no
        synchronisation; the memory numbers are the allocator's counters)."""
        self._infer_steps += 1
        tel = self.telemetry
        if not tel.should_sample(self._infer_steps):
            return
        tok_s = batch * new_tokens / duration_s if duration_s > 0 else 0.0
        tel.record_step(
            "inference",
            step=self._infer_steps,
            duration_s=duration_s,
            scalars={
                "batch": batch,
                "prompt_tokens": prompt_len,
                "new_tokens": new_tokens,
                "tokens_per_sec": round(tok_s, 3),
            },
            spans=[("generate", duration_s * 1e3)],
            hbm=device_hbm_stats(self.device),
            extra={} if cached is None else {"compiled_cache_hit": bool(cached)},
        )

    def serve(self, serving_config=None, clock=None, track_margins: bool = False,
              tracer=None, heat_tracer=None, journal=None):
        """Continuous-batching server over this engine (a
        :class:`~deepspeed_tpu_torch.serving.ServingEngine`).
        ``serving_config`` (dict or :class:`ServingConfig`) overrides the
        ``serving`` section given to ``init_inference``; ``tracer``,
        ``heat_tracer`` and ``journal`` override the telemetry plane's. A
        ``placement`` over more than one rank (``tp > 1``, ``disaggregate``)
        serves on the ranks of the default process group: call ``serve`` and
        every method of the engine it returns on every rank, in the same
        order (``serving/placement.py``)."""
        from ..serving.scheduler import ServingEngine

        cfg = serving_config if serving_config is not None else self._serving_config
        return ServingEngine(
            self, cfg, clock=clock if clock is not None else time.monotonic,
            track_margins=track_margins, tracer=tracer, heat_tracer=heat_tracer,
            journal=journal,
        )


class GenerateProgram:
    """One entry of ``InferenceEngine._generate_cache``: for a batch ``B``,
    a prompt width (the bucket, or the prompt length when bucketing is
    off), ``max_new_tokens`` and the sampling settings, the KV cache
    ``[L, B, width + max_new_tokens, KV, D]`` of the model's kind, the static inputs
    (``gpt2.generate_input_shapes``) and two programs: the prefill and one
    decode step, replayed ``max_new_tokens - 1`` times a call. Tokens go to
    a static ``[B, max_new_tokens]`` buffer the host reads once."""

    def __init__(self, engine: InferenceEngine, batch: int, width: int, max_new_tokens: int,
                 temperature: float, top_k: int, top_p: float):
        cfg, dev, mod = engine.model_config, engine.device, engine.model_module
        self.width = int(width)
        self.max_new_tokens = int(max_new_tokens)
        self.sampled = temperature > 0.0
        self.inputs = StaticInputs(gpt2.generate_input_shapes(batch, width, max_new_tokens),
                                   dev)
        self.state = mod.init_generate_state(cfg, batch, self.width + self.max_new_tokens,
                                             self.max_new_tokens, engine.dtype, dev)
        sample = dict(temperature=temperature, top_k=top_k, top_p=top_p)
        params, state, inputs = engine.params, self.state, self.inputs.dev

        def prefill():
            with torch.no_grad():
                mod.generate_prefill(cfg, params, state, inputs, **sample)

        def step():
            with torch.no_grad():
                mod.generate_step(cfg, params, state, inputs, **sample)

        self.prefill = CapturedProgram("generate_prefill", prefill, dev, self.inputs)
        self.step = CapturedProgram("generate_step", step, dev)

    @property
    def programs(self):
        return (self.prefill, self.step)

    def __call__(self, ids: np.ndarray, seed: int) -> np.ndarray:
        """Prompts ``ids [B, S]`` (S <= width; the rest is padding) → the
        new tokens ``[B, max_new_tokens]`` as numpy."""
        S = ids.shape[1]
        st = self.inputs.staging()
        st["ids"][:] = 0
        st["ids"][:, :S] = ids
        st["plen"][0] = S
        if self.sampled:
            rng = prng.PRNGKey(seed)
            st["key"][:] = rng.view(np.int32)
            if self.max_new_tokens > 1:
                keys = prng.split(prng.fold_in(rng, 1), self.max_new_tokens - 1)
                st["keys"][:] = keys.view(np.int32)
        self.prefill()
        for _ in range(self.max_new_tokens - 1):
            self.step()
        return self.state.out.cpu().numpy()

    def free(self) -> None:
        """Release the graphs, their pools, the cache and the buffers."""
        for p in self.programs:
            p.free()
        self.state = self.inputs = None
