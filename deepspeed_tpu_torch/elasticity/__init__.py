"""Elasticity (counterpart of ``deepspeed_tpu/elasticity/``): the
preemption guard. The elastic agent and the batch-size elasticity of the
JAX package wait for ROADMAP queue 1 item 14."""

from .preemption import PreemptionGuard

__all__ = ["PreemptionGuard"]
