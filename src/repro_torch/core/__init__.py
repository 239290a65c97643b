from repro_torch.core.batching import BucketSpec, FlexibleBatcher, pad_sequences
from repro_torch.core.engine import (GenerationResult, InferenceEngine,
                                     PagedInferenceEngine, SpeculativeEngine,
                                     page_kv_bytes)
from repro_torch.core.ensemble import Ensemble, EnsembleMember
from repro_torch.core.faults import (ZERO_FAULT_STATS, FaultInjector,
                                     FaultSpec, InjectedFault)
from repro_torch.core.kv_pager import (BlockAllocator, KVPager, PagerOOM,
                                       PrefixCache, pages_for_budget)
from repro_torch.core.memory import MemoryLedger, tree_bytes
from repro_torch.core.registry import ModelRegistry
from repro_torch.core.sampling import (SamplingError, SamplingParams,
                                       TokenSampler, base_key, sample_tokens,
                                       samplers_for)
from repro_torch.core.scheduler import (ContinuousBatchingScheduler, Request,
                                        SchedulerBusy, SchedulerService)

__all__ = ["BucketSpec", "FlexibleBatcher", "pad_sequences",
           "GenerationResult", "InferenceEngine", "PagedInferenceEngine",
           "SpeculativeEngine",
           "page_kv_bytes", "ZERO_FAULT_STATS", "FaultInjector", "FaultSpec",
           "InjectedFault", "BlockAllocator", "KVPager", "PagerOOM",
           "PrefixCache", "pages_for_budget", "Ensemble", "EnsembleMember",
           "MemoryLedger", "tree_bytes", "ModelRegistry",
           "ContinuousBatchingScheduler", "Request", "SchedulerBusy",
           "SchedulerService", "SamplingError", "SamplingParams",
           "TokenSampler", "base_key", "sample_tokens", "samplers_for"]
