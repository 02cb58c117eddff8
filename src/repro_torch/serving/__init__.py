"""Serving: the unified request API and the synchronized-batch engine."""
from .api import EngineBase, GenerationConfig, Request, Result
from .engine import ServingEngine

__all__ = ["EngineBase", "GenerationConfig", "Request", "Result",
           "ServingEngine"]
