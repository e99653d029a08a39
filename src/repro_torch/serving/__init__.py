"""Request-level serving: continuous batching over the port's paged (or
dense) cache and tick programs, on one card."""
from ..runtime.faults import FaultInjector, FaultPlan, FaultSpec
from ..runtime.offload import KVStore, SpilledEntry
from .engine import EngineConfig, EngineSnapshot, ServingEngine
from .sampling import SamplingParams, sample_token
from .scheduler import EngineStats, FifoScheduler, Request, RequestState

__all__ = ["EngineConfig", "EngineSnapshot", "EngineStats",
           "FaultInjector", "FaultPlan", "FaultSpec", "FifoScheduler",
           "KVStore", "Request", "RequestState", "SamplingParams",
           "ServingEngine", "SpilledEntry", "sample_token"]
