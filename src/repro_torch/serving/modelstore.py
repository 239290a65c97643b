"""Versioned on-disk model store with provenance manifests: the port of
``repro/serving/modelstore.py``, over the port's checkpoint module (the
same layout and files, so either package reads a store the other wrote).

FlexServe's raison d'être (paper §1) is keeping model provenance and model
evolution under the operator's control in strict environments.  The store
is the durable half of that: every published version of a model lives in
its own directory with the checkpoint AND a manifest recording exactly
what it is and where it came from —

    <root>/<model_name>/
        v0001/
            step_0.ckpt       # msgpack checkpoint (training.checkpoint)
            manifest.json     # {name, version, config, param_hash, source,
                              #  created_at, ...}
        v0002/
            ...

Versions are immutable once published; ``publish`` allocates the next
number atomically via exclusive directory creation, and manifests are
written write-then-rename so concurrent readers never see a torn file.
``load`` re-hashes the restored leaves against the manifest so a corrupt
or swapped checkpoint is rejected before it can reach an endpoint.
"""

from __future__ import annotations

import os
import re
import shutil
import time
from datetime import datetime, timezone
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch

from repro_torch.training import checkpoint

_VDIR = re.compile(r"v(\d{4,})")
CKPT_FILE = "step_0.ckpt"
MANIFEST_FILE = "manifest.json"


class StoreError(RuntimeError):
    pass


# The host-to-device upload's staging: two pinned buffers of this many bytes
# that the host fills in turns while the copy engine drains the other.
STAGING_BYTES = 64 << 20


def upload(host: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    """Copy host tensors to ``device``.  On a CUDA device the copies run on
    a side stream of their own, from two pinned staging buffers filled in
    turns, and the call returns once the last one has landed: the serving
    forwards on the default stream never queue behind a leaf's copy (a
    pageable ``.to(device)`` of an mmapped leaf on the default stream holds
    every kernel enqueued after it until the whole leaf is across)."""
    device = torch.device(device)
    if device.type != "cuda":
        return {k: v.to(device) for k, v in host.items()}
    stream = torch.cuda.Stream(device)
    # the outputs are allocated on the current stream; the side stream
    # writes them only after what that stream has queued so far
    stream.wait_stream(torch.cuda.current_stream(device))
    staging = [torch.empty(STAGING_BYTES, dtype=torch.uint8,
                           pin_memory=True) for _ in range(2)]
    done: List[Optional[torch.cuda.Event]] = [None, None]
    out, n = {}, 0
    for key, v in host.items():
        dst = torch.empty(v.shape, dtype=v.dtype, device=device)
        src = v.contiguous().reshape(-1).view(torch.uint8)
        flat = dst.reshape(-1).view(torch.uint8)
        for off in range(0, src.numel(), STAGING_BYTES):
            m = min(STAGING_BYTES, src.numel() - off)
            buf = staging[n % 2]
            if done[n % 2] is not None:
                done[n % 2].synchronize()   # its last copy has drained
            buf[:m].copy_(src[off:off + m])
            with torch.cuda.stream(stream):
                flat[off:off + m].copy_(buf[:m], non_blocking=True)
                done[n % 2] = torch.cuda.Event()
                done[n % 2].record(stream)
            n += 1
        out[key] = dst
    stream.synchronize()
    return out


class ModelStore:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        # the last load's parts (ms): checkpoint read, hash verify, upload
        self.last_load_ms: Dict[str, float] = {}

    # --- layout ---------------------------------------------------------------

    def model_dir(self, name: str) -> str:
        if not re.fullmatch(r"[A-Za-z0-9._#-]+", name):
            raise StoreError(f"invalid model name {name!r}")
        return os.path.join(self.root, name)

    def version_dir(self, name: str, version: int) -> str:
        return os.path.join(self.model_dir(name), f"v{version:04d}")

    def names(self) -> List[str]:
        if not os.path.isdir(self.root):
            return []
        return sorted(d for d in os.listdir(self.root)
                      if os.path.isdir(os.path.join(self.root, d)))

    def versions(self, name: str) -> List[int]:
        mdir = self.model_dir(name)
        if not os.path.isdir(mdir):
            return []
        out = []
        for d in os.listdir(mdir):
            m = _VDIR.fullmatch(d)
            # only versions whose manifest landed count as published
            if m and os.path.exists(os.path.join(mdir, d, MANIFEST_FILE)):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_version(self, name: str) -> Optional[int]:
        versions = self.versions(name)
        return versions[-1] if versions else None

    # --- publish / read -------------------------------------------------------

    def publish(self, name: str, params, *, config: str, source: str = "",
                meta: Optional[Dict[str, Any]] = None) -> int:
        """Write ``params`` as the next version of ``name``; returns it.

        The version directory is claimed with an exclusive mkdir, so two
        concurrent publishers can never collide on a number; the manifest
        is written LAST, making it the commit record — a crashed publish
        leaves an unlisted directory, not a half-readable version.
        """
        os.makedirs(self.model_dir(name), exist_ok=True)
        version = (self.latest_version(name) or 0) + 1
        for _ in range(100):
            vdir = self.version_dir(name, version)
            try:
                os.mkdir(vdir)
                break
            except FileExistsError:
                version += 1
        else:
            raise StoreError(f"cannot allocate a version for {name!r}")
        # the hash is taken from the host copies the file is written from
        digest = checkpoint.save_and_hash(os.path.join(vdir, CKPT_FILE),
                                          params)
        manifest = {
            "name": name,
            "version": version,
            "config": config,
            "param_hash": digest,
            "source": source,
            "created_at": datetime.now(timezone.utc).isoformat(),
            "created_at_unix": time.time(),
            **(meta or {}),
        }
        checkpoint.write_manifest(os.path.join(vdir, MANIFEST_FILE),
                                  manifest)
        return version

    def manifest(self, name: str, version: int) -> Dict[str, Any]:
        path = os.path.join(self.version_dir(name, version), MANIFEST_FILE)
        if not os.path.exists(path):
            raise StoreError(
                f"no published version {version} of {name!r}; "
                f"available: {self.versions(name)}")
        return checkpoint.read_manifest(path)

    def manifests(self, name: str) -> List[Dict[str, Any]]:
        return [self.manifest(name, v) for v in self.versions(name)]

    def load(self, name: str, version: int, like, *, device=None,
             verify: bool = True) -> Tuple[Any, Dict[str, Any]]:
        """Restore a version's flat params into ``like``'s keys, shapes and
        dtypes (meta tensors will do) on ``device``.

        With ``verify`` (default), the restored leaves are re-hashed and
        checked against the manifest's ``param_hash`` — provenance is only
        as good as the bytes actually served.  The hash is taken on the
        host bytes the device copy is made from, so it costs no copy back,
        and the upload (``upload``) returns only once every leaf is on the
        device: nothing is served from a version before both.
        """
        manifest = self.manifest(name, version)
        path = os.path.join(self.version_dir(name, version), CKPT_FILE)
        t0 = time.perf_counter()
        host, _meta = checkpoint.restore(path, like)
        t1 = time.perf_counter()
        if verify:
            got = checkpoint.param_hash(host)
            if got != manifest["param_hash"]:
                raise StoreError(
                    f"{name} v{version}: param hash mismatch "
                    f"(manifest {manifest['param_hash'][:12]}…, "
                    f"checkpoint {got[:12]}…) — refusing to serve")
        t2 = time.perf_counter()
        out = host if device is None else upload(host, device)
        self.last_load_ms = {"read": 1e3 * (t1 - t0),
                             "verify": 1e3 * (t2 - t1),
                             "upload": 1e3 * (time.perf_counter() - t2)}
        return out, manifest

    # --- retention ------------------------------------------------------------

    def gc(self, name: str, keep_last_n: int, *,
           protected: Iterable[int] = ()) -> Dict[str, Any]:
        """Delete published versions beyond the newest ``keep_last_n``.

        ``protected`` versions (the lifecycle manager passes everything a
        serving alias references) are NEVER deleted regardless of age —
        retention must not be able to pull a version out from under live
        traffic or a rollback.  Versions are immutable, so deletion is the
        only mutation the store ever performs; a version number is never
        reused afterwards (publish allocates past the highest survivor).
        """
        if keep_last_n < 1:
            raise StoreError(f"keep_last_n must be >= 1, got {keep_last_n}")
        versions = self.versions(name)
        if not versions:
            raise StoreError(f"store has no published versions of {name!r}")
        protected = set(protected)
        keep = set(versions[-keep_last_n:]) | protected
        deleted = []
        for v in versions:
            if v in keep:
                continue
            shutil.rmtree(self.version_dir(name, v))
            deleted.append(v)
        return {"name": name, "deleted": deleted,
                "kept": [v for v in versions if v in keep],
                "protected": sorted(protected & set(versions))}
