"""Checkpoints in the JAX package's format, without JAX or msgpack.

The port of ``repro/training/checkpoint.py``.  A checkpoint is one msgpack
map (zstd-compressed when written by a host that has ``zstandard``):

    {"meta": {..., "step": n},
     "leaves": {"/path/to/leaf": {"dtype": str, "shape": [..],
                                  "data": bin}}}

exactly what ``msgpack.packb(payload, use_bin_type=True)`` emits there, so
either package reads what the other writes.  This module carries its own
reader and writer for the msgpack subset that payload uses (map, str,
bin, int, float, bool, nil, array), so the card's machine needs neither
``msgpack`` nor ``ml_dtypes``:

* the writer streams each leaf's bytes straight from its tensor to the
  file (one leaf on the host at a time, never the whole model as one
  bytes object), and refuses a leaf over msgpack's 2**32 - 1 byte ``bin``
  limit before it writes anything — the JAX packer refuses it too, so no
  file is ever written that the JAX loader cannot read;
* the reader maps an uncompressed file and hands out leaves as CPU
  tensors viewing the mapping (``np.frombuffer``; bfloat16 is read as
  uint16 and viewed as ``torch.bfloat16``); a zstd frame is read only
  where ``zstandard`` imports, as the JAX loader does;
* ``param_hash`` is byte-for-byte the JAX package's digest of the same
  weights: sorted keys, numpy dtype names (``"bfloat16"``, ``"float32"``,
  ``"int32"``), ``str(tuple(shape))`` and the raw bytes.

Params are the port's flat dicts keyed by the JAX tree paths
(``repro_torch.params``).
"""

from __future__ import annotations

import hashlib
import json
import mmap
import os
import re
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

try:                                    # optional dependency
    import zstandard
except ImportError:                     # pragma: no cover - env dependent
    zstandard = None

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
# msgpack's bin 32 length field
MAX_BIN_BYTES = 2**32 - 1

# torch dtype <-> the numpy dtype name the JAX package writes; bfloat16 is
# moved as its raw 16-bit words
_DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float16: "float16",
                torch.float32: "float32", torch.float64: "float64",
                torch.int8: "int8", torch.uint8: "uint8",
                torch.int16: "int16", torch.int32: "int32",
                torch.int64: "int64", torch.bool: "bool"}
_TORCH_DTYPES = {v: k for k, v in _DTYPE_NAMES.items()}


class CheckpointError(ValueError):
    """A checkpoint that cannot be written or read in this format."""


# --------------------------------------------------------------------------
# leaves as bytes
# --------------------------------------------------------------------------


def dtype_name(t: torch.Tensor) -> str:
    try:
        return _DTYPE_NAMES[t.dtype]
    except KeyError:
        raise CheckpointError(f"unsupported dtype {t.dtype}") from None


def host_array(t) -> np.ndarray:
    """A contiguous host array holding ``t``'s bytes (bfloat16 as its raw
    16-bit words); numpy arrays pass through."""
    if isinstance(t, np.ndarray):
        return np.ascontiguousarray(t)
    t = t.detach()
    if t.device.type != "cpu":
        t = t.cpu()
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _raw(arr: np.ndarray) -> memoryview:
    """The array's bytes as a flat byte view (any dtype, no copy)."""
    return memoryview(arr.reshape(-1).view(np.uint8))


def _leaf_dtype_name(v) -> str:
    if isinstance(v, np.ndarray):
        return str(v.dtype)
    return dtype_name(v)


def param_hash(params: Dict[str, Any]) -> str:
    """Content hash of flat params (order-independent provenance id): the
    JAX package's ``param_hash`` of the same weights, byte for byte.
    Leaves are tensors on any device (copied to the host one at a time)
    or numpy arrays."""
    h = hashlib.sha256()
    for key in sorted(params):
        v = params[key]
        h.update(key.encode())
        h.update(_leaf_dtype_name(v).encode())
        h.update(str(tuple(int(d) for d in v.shape)).encode())
        h.update(_raw(host_array(v)))
    return h.hexdigest()


# --------------------------------------------------------------------------
# msgpack subset: writer
# --------------------------------------------------------------------------


def _pack_str(s: str) -> bytes:
    b = s.encode("utf-8")
    n = len(b)
    if n < 32:
        return bytes([0xA0 | n]) + b
    if n < 2**8:
        return b"\xd9" + struct.pack(">B", n) + b
    if n < 2**16:
        return b"\xda" + struct.pack(">H", n) + b
    return b"\xdb" + struct.pack(">I", n) + b


def _bin_header(n: int) -> bytes:
    if n < 2**8:
        return b"\xc4" + struct.pack(">B", n)
    if n < 2**16:
        return b"\xc5" + struct.pack(">H", n)
    if n <= MAX_BIN_BYTES:
        return b"\xc6" + struct.pack(">I", n)
    raise CheckpointError(
        f"a {n}-byte leaf exceeds msgpack's bin 32 limit of "
        f"{MAX_BIN_BYTES} bytes: the JAX checkpoint format cannot hold it")


def _map_header(n: int) -> bytes:
    if n < 16:
        return bytes([0x80 | n])
    if n < 2**16:
        return b"\xde" + struct.pack(">H", n)
    return b"\xdf" + struct.pack(">I", n)


def _array_header(n: int) -> bytes:
    if n < 16:
        return bytes([0x90 | n])
    if n < 2**16:
        return b"\xdc" + struct.pack(">H", n)
    return b"\xdd" + struct.pack(">I", n)


def _pack_int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for tag, fmt, lim in ((0xCC, ">B", 2**8), (0xCD, ">H", 2**16),
                              (0xCE, ">I", 2**32), (0xCF, ">Q", 2**64)):
            if v < lim:
                return bytes([tag]) + struct.pack(fmt, v)
    else:
        for tag, fmt, lim in ((0xD0, ">b", 2**7), (0xD1, ">h", 2**15),
                              (0xD2, ">i", 2**31), (0xD3, ">q", 2**63)):
            if v >= -lim:
                return bytes([tag]) + struct.pack(fmt, v)
    raise CheckpointError(f"integer {v} does not fit msgpack's 64 bits")


def packb(obj: Any) -> bytes:
    """msgpack bytes of a JSON-like value, as ``msgpack.packb(obj,
    use_bin_type=True)`` writes them (dicts in insertion order, floats as
    float 64, tuples as arrays)."""
    if obj is None:
        return b"\xc0"
    if obj is True:
        return b"\xc3"
    if obj is False:
        return b"\xc2"
    if isinstance(obj, int):
        return _pack_int(obj)
    if isinstance(obj, float):
        return b"\xcb" + struct.pack(">d", obj)
    if isinstance(obj, str):
        return _pack_str(obj)
    if isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        return _bin_header(len(b)) + b
    if isinstance(obj, dict):
        return _map_header(len(obj)) + b"".join(
            packb(k) + packb(v) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return _array_header(len(obj)) + b"".join(packb(v) for v in obj)
    raise CheckpointError(f"cannot pack {type(obj).__name__}")


# --------------------------------------------------------------------------
# msgpack subset: reader
# --------------------------------------------------------------------------


class _Bin:
    """A ``bin`` value: its offset and length in the reader's buffer (the
    bytes are never copied)."""

    __slots__ = ("offset", "size")

    def __init__(self, offset: int, size: int):
        self.offset, self.size = offset, size


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise CheckpointError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self._take(n))[0]

    def _str(self, n: int) -> str:
        return bytes(self._take(n)).decode("utf-8")

    def _bin(self, n: int) -> _Bin:
        out = _Bin(self.pos, n)
        self._take(n)
        return out

    def read(self) -> Any:
        b = self._take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ("bin", ">B", 1), 0xC5: ("bin", ">H", 2),
                 0xC6: ("bin", ">I", 4), 0xD9: ("str", ">B", 1),
                 0xDA: ("str", ">H", 2), 0xDB: ("str", ">I", 4),
                 0xDC: ("array", ">H", 2), 0xDD: ("array", ">I", 4),
                 0xDE: ("map", ">H", 2), 0xDF: ("map", ">I", 4)}
        if b in sized:
            kind, fmt, width = sized[b]
            n = self._unpack(fmt, width)
            if kind == "bin":
                return self._bin(n)
            if kind == "str":
                return self._str(n)
            if kind == "array":
                return [self.read() for _ in range(n)]
            return self._map(n)
        scalars = {0xCA: (">f", 4), 0xCB: (">d", 8), 0xCC: (">B", 1),
                   0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
                   0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4),
                   0xD3: (">q", 8)}
        if b in scalars:
            return self._unpack(*scalars[b])
        raise CheckpointError(f"unsupported msgpack type byte 0x{b:02x}")

    def _map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def unpackb(buf) -> Any:
    """Decode msgpack bytes; ``bin`` values come back as bytes."""
    r = _Reader(buf)
    out = r.read()
    return _bins_to_bytes(out, r.buf)


def _bins_to_bytes(obj, buf):
    if isinstance(obj, _Bin):
        return bytes(buf[obj.offset:obj.offset + obj.size])
    if isinstance(obj, dict):
        return {k: _bins_to_bytes(v, buf) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_bins_to_bytes(v, buf) for v in obj]
    return obj


# --------------------------------------------------------------------------
# save / load
# --------------------------------------------------------------------------


def save(path: str, params: Dict[str, Any], *, step: int = 0,
         meta: Optional[Dict[str, Any]] = None) -> str:
    """Write flat params as an uncompressed checkpoint; returns the path."""
    save_and_hash(path, params, step=step, meta=meta)
    return path


def save_and_hash(path: str, params: Dict[str, Any], *, step: int = 0,
                  meta: Optional[Dict[str, Any]] = None) -> str:
    """Write flat params as an uncompressed checkpoint, streaming one leaf
    at a time in sorted key order (the JAX writer's order for a dict
    tree), and return their ``param_hash``, taken from the same host
    copies.  Every leaf's size is checked before the file is opened, so a
    refused checkpoint leaves nothing behind."""
    keys = sorted(params)
    names = {k: _leaf_dtype_name(params[k]) for k in keys}
    for k in keys:
        v = params[k]
        nbytes = int(np.prod(v.shape, dtype=np.int64)) * (
            v.itemsize if isinstance(v, np.ndarray) else v.element_size())
        try:
            _bin_header(nbytes)
        except CheckpointError as e:
            raise CheckpointError(f"leaf {k!r}: {e}") from None
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    h = hashlib.sha256()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_map_header(2) + packb("meta")
                + packb(dict(meta or {}, step=step)) + packb("leaves")
                + _map_header(len(keys)))
        for k in keys:
            v = params[k]
            shape = [int(d) for d in v.shape]
            arr = _raw(host_array(v))
            f.write(packb(k) + _map_header(3)
                    + packb("dtype") + packb(names[k])
                    + packb("shape") + packb(shape)
                    + packb("data") + _bin_header(arr.nbytes))
            f.write(arr)
            h.update(k.encode())
            h.update(names[k].encode())
            h.update(str(tuple(shape)).encode())
            h.update(arr)
            del arr
    os.replace(tmp, path)
    return h.hexdigest()


def _leaf_tensor(buf, leaf: Dict[str, Any], key: str) -> torch.Tensor:
    name, shape, data = leaf["dtype"], tuple(leaf["shape"]), leaf["data"]
    if name not in _TORCH_DTYPES:
        raise CheckpointError(f"leaf {key!r}: unsupported dtype {name!r}")
    dt = _TORCH_DTYPES[name]
    host = np.int16 if dt == torch.bfloat16 else np.dtype(name)
    count = int(np.prod(shape, dtype=np.int64))
    if count * np.dtype(host).itemsize != data.size:
        raise CheckpointError(
            f"leaf {key!r}: {data.size} bytes for shape {shape} of {name}")
    arr = np.frombuffer(buf, dtype=host, count=count, offset=data.offset)
    t = torch.from_numpy(arr.reshape(shape))
    return t.view(torch.bfloat16) if dt == torch.bfloat16 else t


def _read_buffer(path: str):
    """The file's msgpack bytes: a copy-on-write mapping of a plain file
    (writable views, no copy read up front), or a zstd frame decompressed
    into memory where ``zstandard`` is installed."""
    with open(path, "rb") as f:
        if f.read(4) == _ZSTD_MAGIC:
            if zstandard is None:
                raise CheckpointError(
                    f"{path} is zstd-compressed but the 'zstandard' "
                    "package is not installed; install it or re-save "
                    "uncompressed")
            f.seek(0)
            return bytearray(zstandard.ZstdDecompressor().decompress(
                f.read()))
        f.seek(0)
        return mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)


def load(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """-> (flat params as CPU tensors viewing the file's bytes, meta)."""
    buf = _read_buffer(path)
    r = _Reader(buf)
    payload = r.read()
    if not (isinstance(payload, dict) and isinstance(
            payload.get("leaves"), dict)):
        raise CheckpointError(f"{path} is not a checkpoint")
    leaves = {k: _leaf_tensor(buf, v, k)
              for k, v in payload["leaves"].items()}
    meta = _bins_to_bytes(payload.get("meta", {}), r.buf)
    return leaves, meta


def restore(path: str, like: Dict[str, torch.Tensor], device=None
            ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """Restore into ``like``'s keys, shapes and dtypes (tensors on any
    device, ``meta`` included) on ``device`` (default: the CPU views)."""
    leaves, meta = load(path)
    out = {}
    for key, ref in like.items():
        if key not in leaves:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = leaves[key]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{tuple(arr.shape)} vs {tuple(ref.shape)}")
        out[key] = arr.to(device=device, dtype=ref.dtype)
    return out, meta


def write_manifest(path: str, manifest: Dict[str, Any]) -> str:
    """Atomically write a provenance manifest (JSON) next to a checkpoint.

    Write-then-rename so a reader never observes a torn manifest — admin
    threads read manifests while loads are in progress.
    """
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    os.replace(tmp, path)
    return path


def read_manifest(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def latest(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    best, best_step = None, -1
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)\.ckpt", name)
        if m and int(m.group(1)) > best_step:
            best, best_step = os.path.join(ckpt_dir, name), int(m.group(1))
    return best
