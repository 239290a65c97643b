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

from repro_torch.training import checkpoint

_VDIR = re.compile(r"v(\d{4,})")
CKPT_FILE = "step_0.ckpt"
MANIFEST_FILE = "manifest.json"


class StoreError(RuntimeError):
    pass


class ModelStore:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

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
        host bytes the device copy is made from, so it costs no copy back.
        """
        manifest = self.manifest(name, version)
        path = os.path.join(self.version_dir(name, version), CKPT_FILE)
        host, _meta = checkpoint.restore(path, like)
        if verify:
            got = checkpoint.param_hash(host)
            if got != manifest["param_hash"]:
                raise StoreError(
                    f"{name} v{version}: param hash mismatch "
                    f"(manifest {manifest['param_hash'][:12]}…, "
                    f"checkpoint {got[:12]}…) — refusing to serve")
        if device is None:
            return host, manifest
        return {k: v.to(device) for k, v in host.items()}, manifest

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
