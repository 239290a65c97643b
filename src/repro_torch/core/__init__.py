from repro_torch.core.batching import BucketSpec, FlexibleBatcher, pad_sequences
from repro_torch.core.ensemble import Ensemble, EnsembleMember
from repro_torch.core.memory import MemoryLedger, tree_bytes
from repro_torch.core.registry import ModelRegistry

__all__ = ["BucketSpec", "FlexibleBatcher", "pad_sequences", "Ensemble",
           "EnsembleMember", "MemoryLedger", "tree_bytes", "ModelRegistry"]
