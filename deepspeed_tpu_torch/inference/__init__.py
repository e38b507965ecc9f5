"""Inference engine of the port."""

from .engine import InferenceEngine

__all__ = ["InferenceEngine"]
