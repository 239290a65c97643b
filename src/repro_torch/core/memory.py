"""Shared-device memory accounting (paper §2.2).

The paper's point: deployed models are usually much smaller than
accelerator memory, so loading multiple models into ONE device's memory
amortizes the hardware.  The MemoryLedger proves an ensemble + cache
configuration fits the card BEFORE any allocation.  Its budget is the
card's own memory (``torch.cuda.get_device_properties``), never a
constant; on a host without a CUDA device it must be passed explicitly.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

DEFAULT_HEADROOM = 0.10                # reserve 10% for allocator slack


def tree_bytes(tree) -> int:
    """Total bytes of a (nested dict/list of) tensors or numpy arrays."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return int(np.asarray(tree).nbytes)


def device_memory_bytes(device=None) -> int:
    """Total memory of a CUDA device (default: the current one)."""
    if not torch.cuda.is_available():
        raise ValueError("no CUDA device is visible: pass hbm_per_chip "
                         "explicitly")
    dev = torch.device(device) if device is not None else torch.device(
        "cuda", torch.cuda.current_device())
    return torch.cuda.get_device_properties(dev).total_memory


@dataclass
class MemoryEntry:
    name: str
    kind: str          # "params" | "cache" | "activations" | "kv_pages"
    total_bytes: int
    shard_factor: int  # how many devices the entry is divided across

    @property
    def bytes_per_chip(self) -> int:
        return -(-self.total_bytes // self.shard_factor)


@dataclass
class MemoryLedger:
    """Device-memory accounting for one serving/training program.
    ``hbm_per_chip`` defaults to the current CUDA device's total memory."""

    n_chips: int
    hbm_per_chip: Optional[int] = None
    headroom: float = DEFAULT_HEADROOM
    entries: List[MemoryEntry] = field(default_factory=list)

    def __post_init__(self):
        if self.hbm_per_chip is None:
            self.hbm_per_chip = device_memory_bytes()

    def add_params(self, name: str, params, *,
                   shard_factor: Optional[int] = None) -> MemoryEntry:
        e = MemoryEntry(name, "params", tree_bytes(params),
                        shard_factor or self.n_chips)
        self.entries.append(e)
        return e

    def add_cache(self, name: str, state, *,
                  shard_factor: Optional[int] = None) -> MemoryEntry:
        e = MemoryEntry(name, "cache", tree_bytes(state),
                        shard_factor or self.n_chips)
        self.entries.append(e)
        return e

    def add_activations(self, name: str, nbytes: int, *,
                        shard_factor: Optional[int] = None) -> MemoryEntry:
        e = MemoryEntry(name, "activations", nbytes,
                        shard_factor or self.n_chips)
        self.entries.append(e)
        return e

    def add_kv_pages(self, name: str, page_bytes: int, num_pages: int, *,
                     shard_factor: Optional[int] = None) -> MemoryEntry:
        """Paged KV pool: the ledger accounts PAGES, not per-slot
        worst-case caches — the pool size is the capacity knob, decoupled
        from slot count (slots only cost their int32 page-table rows)."""
        e = MemoryEntry(name, "kv_pages", page_bytes * num_pages,
                        shard_factor or self.n_chips)
        self.entries.append(e)
        return e

    def remaining_per_chip(self) -> int:
        """Unclaimed budget — what a paged KV pool gets sized against."""
        return max(0, self.budget_per_chip - self.bytes_per_chip)

    @property
    def bytes_per_chip(self) -> int:
        return sum(e.bytes_per_chip for e in self.entries)

    @property
    def budget_per_chip(self) -> int:
        return int(self.hbm_per_chip * (1 - self.headroom))

    def fits(self) -> bool:
        return self.bytes_per_chip <= self.budget_per_chip

    def utilization(self) -> float:
        return self.bytes_per_chip / self.hbm_per_chip

    def report(self) -> str:
        lines = [f"MemoryLedger: {self.n_chips} devices x "
                 f"{self.hbm_per_chip / 2**30:.0f} GiB "
                 f"(budget {self.budget_per_chip / 2**30:.1f} GiB/device)"]
        for e in self.entries:
            lines.append(
                f"  {e.kind:12s} {e.name:32s} "
                f"{e.total_bytes / 2**30:9.2f} GiB total  "
                f"{e.bytes_per_chip / 2**20:9.1f} MiB/device "
                f"(/{e.shard_factor})")
        lines.append(
            f"  TOTAL {self.bytes_per_chip / 2**30:.2f} GiB/device  "
            f"({100 * self.utilization():.1f}% of device memory)  "
            f"{'FITS' if self.fits() else 'DOES NOT FIT'}")
        return "\n".join(lines)
