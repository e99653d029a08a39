"""Request-level serving: continuous batching over the port's paged (or
dense) cache and tick programs, on one card."""
from .engine import EngineConfig, ServingEngine
from .sampling import SamplingParams, sample_token
from .scheduler import EngineStats, FifoScheduler, Request, RequestState

__all__ = ["EngineConfig", "EngineStats", "FifoScheduler", "Request",
           "RequestState", "SamplingParams", "ServingEngine",
           "sample_token"]
