"""Request-level serving: continuous batching over the port's paged (or
dense) cache and tick programs, on one card, and the streaming loop that
overlaps the host's work with the card's."""
from ..runtime.faults import FaultInjector, FaultPlan, FaultSpec
from ..runtime.offload import KVStore, SpilledEntry
from .engine import EngineConfig, EngineSnapshot, ServingEngine
from .sampling import SamplingParams, sample_token
from .scheduler import EngineStats, FifoScheduler, Request, RequestState
from .streaming import (ResultTokens, StreamingEngine, TokenStream,
                        serve_stream)

__all__ = ["EngineConfig", "EngineSnapshot", "EngineStats",
           "FaultInjector", "FaultPlan", "FaultSpec", "FifoScheduler",
           "KVStore", "Request", "RequestState", "ResultTokens",
           "SamplingParams", "ServingEngine", "SpilledEntry",
           "StreamingEngine", "TokenStream", "sample_token", "serve_stream"]
