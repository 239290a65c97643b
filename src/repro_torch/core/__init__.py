from repro_torch.core.batching import BucketSpec, FlexibleBatcher, pad_sequences
from repro_torch.core.engine import GenerationResult, InferenceEngine
from repro_torch.core.ensemble import Ensemble, EnsembleMember
from repro_torch.core.memory import MemoryLedger, tree_bytes
from repro_torch.core.registry import ModelRegistry
from repro_torch.core.sampling import (SamplingError, SamplingParams,
                                       TokenSampler, base_key, sample_tokens,
                                       samplers_for)

__all__ = ["BucketSpec", "FlexibleBatcher", "pad_sequences",
           "GenerationResult", "InferenceEngine", "Ensemble",
           "EnsembleMember", "MemoryLedger", "tree_bytes", "ModelRegistry",
           "SamplingError", "SamplingParams", "TokenSampler", "base_key",
           "sample_tokens", "samplers_for"]
