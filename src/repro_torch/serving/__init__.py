"""Serving: the unified request API, the synchronized-batch engine, the
continuous-batching engine and the paged-KV engine."""
from .api import EngineBase, GenerationConfig, Request, Result
from .engine import (ContinuousBatchingEngine, ServingEngine,
                     exact_moe_policy, merge_policy_override)
from .paged import PageAllocator, PagedEngine

__all__ = ["EngineBase", "GenerationConfig", "Request", "Result",
           "ServingEngine", "ContinuousBatchingEngine", "PagedEngine",
           "PageAllocator", "exact_moe_policy", "merge_policy_override"]
