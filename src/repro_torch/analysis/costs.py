"""One step's work as the port runs it: its flops, the bytes its ops move
and its peak live bytes.

The port's counterpart of ``repro/analysis/hlo_costs.py``.  The JAX
package reads a step's loop-aware costs out of XLA's optimized HLO; the
port emits no HLO, so ``Counter`` watches the step as it runs, one aten op
at a time (a ``TorchDispatchMode``), on any device: meta tensors (the
dry-run, ``launch/dryrun.py``), the CPU or the card.  It counts:

  * flops -- the products of every matmul-like op, by
    ``torch.utils.flop_counter``'s formulas (2 m n k for a product, as
    ``analyze_hlo`` counts dots); elementwise work is not counted;
  * bytes -- every op's operands and results, once each (in eager PyTorch
    every op reads and writes device memory: the counterpart of
    ``analyze_hlo``'s top-level operand + result model); views and the
    ops that only allocate move nothing;
  * peak live bytes -- a storage's bytes, rounded up to the CUDA caching
    allocator's ALLOC_ROUND, are added when an op creates it and taken
    off when it is freed (a finalizer on the storage); views and in-place
    results add nothing.

A kernel wrapper reports each call through ``record(name, flops,
nbytes)``, a no-op while no counter is active: the products' flops and
the bytes of the one launch the call stands for (on the card it launches
it, on meta it plans it, on the CPU it runs the plain version instead).
The counter counts these as ``calls``, not launches: the wrappers' own
``launches`` counters, bumped where a kernel is launched, are the only
count of launches.  Used as a context manager (``with
costs.record(...):``) it also keeps the aten ops of its body out of the
flops and bytes -- the plain version's on the CPU, the scratch
bookkeeping on the card and on meta -- so that one call counts once, as
the kernel's own cost, on every device; their allocations still count
towards the peak.  One counter is active at a time in a process (the
kernel wrappers of any thread report to it)."""

from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Dict, NamedTuple, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

# the CUDA caching allocator hands out blocks in multiples of 512 bytes
ALLOC_ROUND = 512

aten = torch.ops.aten
# ops that only allocate: they move no bytes
_ALLOCATING = {aten.empty.memory_format, aten.empty_like.default,
               aten.empty_strided.default, aten.new_empty.default,
               aten.new_empty_strided.default}


class Cost(NamedTuple):
    """One launch's work: ``flops`` (for K1-K3 the products' flops; for
    K4 and K5 every fp32 operation, each exp one) and ``nbytes`` (each
    input read once, each output written once); for K4 and K5 also the
    split of the operations between ``products`` (every product of the
    function, 2 flops a multiply-add: what tensor cores could take) and
    ``other`` (the rest, on CUDA cores).  A counter records the
    products' flops: ``counted``."""
    flops: float
    nbytes: int
    products: Optional[float] = None
    other: Optional[float] = None

    @property
    def counted(self) -> float:
        """The flops a ``Counter`` records: the products' only, as it
        counts aten ops."""
        return self.flops if self.products is None else self.products


def _round(n: int) -> int:
    return -(-n // ALLOC_ROUND) * ALLOC_ROUND


def _tensors(tree):
    """The tensors of a pytree of arguments or results."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)) and all(
            isinstance(t, torch.Tensor) or not isinstance(t, (list, tuple,
                                                              dict))
            for t in tree):
        return [t for t in tree if isinstance(t, torch.Tensor)]
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Counter(TorchDispatchMode):
    """``with Counter() as c: step(...)`` -- then ``c.flops``, ``c.bytes``,
    ``c.peak`` (the most bytes that storages created under it held at
    once) and ``c.kernels`` (by kernel name: the wrapper's ``calls`` and
    their flops and bytes)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.kernels: Dict[str, Dict[str, float]] = {}
        self._quiet = 0
        self._storages: Dict[int, int] = {}
        self._lock = threading.Lock()

    # the active counter, for ``record``
    _active: Optional["Counter"] = None

    def __enter__(self):
        if Counter._active is not None:
            raise RuntimeError("a costs.Counter is already active")
        Counter._active = self
        return super().__enter__()

    def __exit__(self, *exc):
        Counter._active = None
        return super().__exit__(*exc)

    def _free(self, key: int) -> None:
        with self._lock:
            self.live -= self._storages.pop(key, 0)

    def _track(self, inputs, outputs) -> None:
        seen = {t.untyped_storage()._cdata for t in inputs}
        for t in outputs:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen:
                continue
            seen.add(key)
            with self._lock:
                if key in self._storages:
                    continue
                n = _round(st.nbytes())
                self._storages[key] = n
                self.live += n
                self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        inputs = _tensors(args) + (_tensors(kwargs) if kwargs else [])
        outputs = _tensors(out)
        self._track(inputs, outputs)
        if self._quiet or func.is_view or func in _ALLOCATING:
            return out
        formula = flop_registry.get(func._overloadpacket)
        flops = (float(formula(*args, **kwargs, out_val=out))
                 if formula is not None else 0.0)
        # an in-place or out= result is its input's storage: written once
        nbytes = (sum(_bytes(t) for t in inputs)
                  + sum(_bytes(t) for t in outputs))
        with self._lock:
            self.flops += flops
            self.bytes += nbytes
        return out

    def _record(self, name: str, flops: float, nbytes: int) -> None:
        with self._lock:
            self.flops += flops
            self.bytes += nbytes
            row = self.kernels.setdefault(
                name, {"calls": 0, "flops": 0.0, "bytes": 0})
            row["calls"] += 1
            row["flops"] += flops
            row["bytes"] += nbytes

    @contextlib.contextmanager
    def _quietly(self):
        with self._lock:
            self._quiet += 1
        try:
            yield
        finally:
            with self._lock:
                self._quiet -= 1


def record(name: str, flops: float, nbytes: int):
    """Report one call of kernel ``name``'s wrapper to the active counter
    (a no-op without one).  Returns a context manager that keeps the aten ops of
    its body out of the counted flops and bytes."""
    c = Counter._active
    if c is None:
        return contextlib.nullcontext()
    c._record(name, flops, nbytes)
    return c._quietly()


def storages(tree) -> Dict[int, int]:
    """The distinct storages under the tensors of ``tree`` (any pytree):
    an id for each, and its bytes rounded up to ALLOC_ROUND, as the card
    holds them."""
    return {t.untyped_storage()._cdata: _round(t.untyped_storage().nbytes())
            for t in _tensors(tree)}


def storage_bytes(tree) -> int:
    return sum(storages(tree).values())


def recording(name: str, cost):
    """``record(name, c.counted, c.nbytes)`` of ``c = cost()`` where a
    counter is active; ``cost`` (a callable returning a ``Cost``) is
    called only then, so a call with no counter pays nothing for its
    arithmetic."""
    if Counter._active is None:
        return contextlib.nullcontext()
    c = cost()
    return record(name, c.counted, c.nbytes)
