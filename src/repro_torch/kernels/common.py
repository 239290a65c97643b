"""Shared kernel utilities: device checks, the nvcc build-and-load helper,
and integer helpers.

The port's counterpart of ``repro.kernels.common.default_interpret``: where
the JAX package chose between a compiled and an interpreted Pallas kernel,
a wrapper here chooses by the tensor it was given.  A CPU tensor takes the
kernel's plain PyTorch version; a CUDA tensor launches the kernel, and
anything the kernel cannot take raises.  A meta tensor (the dry-run's
planning pass) is checked and given its outputs and scratch as the CUDA
path allocates them, and nothing is launched.  There is no flag that
forces either side.

Kernels are CUDA C++ sources under ``<package>/csrc/`` with a plain C
interface.  They are compiled with ``nvcc`` at first use into
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``)
and loaded with ``ctypes``.  Nothing is built or imported at module import
time, so the CPU-only test suite imports every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Union

import torch

ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = ROOT / "build" / "kernels"
# headers that kernels of several packages include (``tf32x3.cuh``); nvcc
# gets this directory with -I, so a source includes them by name from
# wherever it lies (a variant's copy under build/ too)
SHARED_CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_locks_guard = threading.Lock()
_build_locks: Dict[str, threading.Lock] = {}    # one per library: builds of
build_log: Dict[str, Dict[str, object]] = {}    # different kernels overlap


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  With no GPU and no explicit device this raises; it never
    falls back to the CPU quietly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def is_meta(*tensors: torch.Tensor) -> bool:
    """True when every tensor is a meta tensor (shapes and dtypes, no
    storage: the dry-run's pass), False when none is; mixed placement
    raises.  A wrapper asks this before ``is_cuda``, which refuses meta:
    on meta it validates and allocates as on the card, and launches
    nothing."""
    meta = {t.device.type == "meta" for t in tensors}
    if len(meta) != 1:
        raise ValueError("meta tensors mixed with tensors on a device")
    return meta.pop()


def is_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on one CUDA device, False when every
    tensor lies on the CPU; mixed placement raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev}")


def nvcc_path() -> str:
    cand = [os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"]
    for home in cand:
        p = Path(home) / "bin" / "nvcc" if home else None
        if p is not None and p.is_file():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH)")
    return found


def library_path(name: str, sources: Sequence[Path],
                 headers: Sequence[Path] = ()) -> Path:
    """The file that a build of ``sources`` lands in: named after ``name``
    and a hash of the flags, the sources and ``headers`` (the headers the
    sources include, hashed but not passed to nvcc), so that an edit to any
    of them builds anew.  Needs no nvcc."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (*sources, *headers):
        h.update(Path(path).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def load_library(name: str, sources: Sequence[Path],
                 headers: Sequence[Path] = ()) -> ctypes.CDLL:
    """Compile ``sources`` with nvcc for sm_90a into a shared library named
    after ``name`` and a hash of the sources, the headers they include and
    the flags (``library_path``), and load it.

    The library is cached in this process and on disk; a build by a
    concurrent process lands under a temporary name and is renamed into
    place, so readers never see a half-written file.  ``build_log[name]``
    records the seconds spent and the assembler's register/spill report,
    which is kept beside the library (``.ptxas``) so that a later process
    that loads the built library reads the same report.  Different
    libraries may be built from several threads at once."""
    with _locks_guard:
        lock = _build_locks.setdefault(name, threading.Lock())
    with lock:
        if name in _libs:
            return _libs[name]
        out = library_path(name, sources, headers)
        t0 = time.perf_counter()
        saved = out.with_suffix(".ptxas")
        report = saved.read_text() if saved.exists() else ""
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(SHARED_CSRC), "-o",
                   str(tmp), *map(str, sources)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {name} ({proc.returncode}):\n"
                    f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
            report = proc.stderr
            tmp_report = saved.with_suffix(f".{os.getpid()}.tmp-ptxas")
            tmp_report.write_text(report)
            os.replace(tmp_report, saved)
            os.replace(tmp, out)
        build_log[name] = {"seconds": time.perf_counter() - t0,
                           "library": str(out), "ptxas": report}
        lib = ctypes.CDLL(str(out))
        _libs[name] = lib
        return lib


def float_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` as float32 with a contiguous last dimension: a view where it
    already is one (the kernels read the other dimensions through
    strides)."""
    t = t.float()
    return t if t.stride(-1) == 1 else t.contiguous()


def rows_aligned(t: torch.Tensor) -> bool:
    """Whether every row of a tensor with a contiguous last dimension
    starts on a 16-byte boundary (its base and its other strides in whole
    16-byte groups), as a 16-byte ``cp.async`` or a TMA box needs."""
    per = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st % per == 0 for st in t.stride()[:-1]))


def rows_aligned16(t: torch.Tensor) -> bool:
    """``rows_aligned`` for a float32 tensor (False for any other dtype)."""
    return t.dtype == torch.float32 and rows_aligned(t)


def refuse_grad(what: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise where autograd would need a gradient through a kernel that
    has no backward kernel yet (on CUDA tensors; CPU tensors take the plain
    version, which autograd differentiates).  Without this, autograd would
    stop at the kernel's output and leave the inputs without a gradient,
    silently."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} has no backward kernel yet: autograd cannot take a "
            f"gradient through it on the card (call it under "
            f"torch.no_grad(), or on CPU tensors)")


def check_cuda_status(status: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def data_ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())
