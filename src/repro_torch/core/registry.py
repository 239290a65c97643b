"""Model registry: names -> versioned (config, Model, params) entries.

One registry instance backs one endpoint process; the REST server exposes
its contents at /v1/models and routes inference to members by name.

Entries are VERSIONED: the same model name may hold several loaded
versions at once (the window during a hot swap, or a canary riding next
to stable).  ``get(name)`` resolves to the newest version unless an
explicit one is requested.  All reads snapshot under the registry lock —
the lifecycle manager mutates entries from admin threads while HTTP
handler threads read them.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from repro_torch.models.build import Model


@dataclass
class RegisteredModel:
    name: str
    model: Model
    params: Any
    meta: Dict[str, Any]
    version: int = 1


class ModelRegistry:
    def __init__(self):
        # name -> {version -> RegisteredModel}; guarded by _lock
        self._models: Dict[str, Dict[int, RegisteredModel]] = {}
        self._lock = threading.Lock()

    def register(self, name: str, model: Model, params, *,
                 version: int = 1, **meta) -> RegisteredModel:
        with self._lock:
            versions = self._models.setdefault(name, {})
            if version in versions:
                raise ValueError(
                    f"model {name!r} v{version} already registered")
            rm = RegisteredModel(name, model, params, meta, version)
            versions[version] = rm
            return rm

    def unregister(self, name: str, version: Optional[int] = None) -> None:
        """Remove one version (or every version when ``version`` is None).

        Raises KeyError for unknown names/versions — a lifecycle bug
        (double-unload, typo'd admin call) must surface, not vanish.
        """
        with self._lock:
            if name not in self._models:
                raise KeyError(f"model {name!r} not registered")
            if version is None:
                del self._models[name]
                return
            if version not in self._models[name]:
                raise KeyError(f"model {name!r} has no version {version}; "
                               f"loaded: {sorted(self._models[name])}")
            del self._models[name][version]
            if not self._models[name]:
                del self._models[name]

    def get(self, name: str,
            version: Optional[int] = None) -> RegisteredModel:
        with self._lock:
            try:
                versions = self._models[name]
            except KeyError:
                raise KeyError(f"model {name!r} not deployed; available: "
                               f"{sorted(self._models)}") from None
            if version is None:
                return versions[max(versions)]
            try:
                return versions[version]
            except KeyError:
                raise KeyError(f"model {name!r} has no version {version}; "
                               f"loaded: {sorted(versions)}") from None

    def versions(self, name: str) -> List[int]:
        with self._lock:
            return sorted(self._models.get(name, ()))

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._models)

    def __len__(self) -> int:
        with self._lock:
            return len(self._models)

    def describe(self) -> List[Dict[str, Any]]:
        with self._lock:   # snapshot: entries may be swapped concurrently
            entries = [rm for versions in self._models.values()
                       for rm in versions.values()]
        out = []
        for rm in sorted(entries, key=lambda r: (r.name, r.version)):
            cfg = rm.model.config
            out.append({
                "name": rm.name,
                "version": rm.version,
                "arch": cfg.name,
                "family": cfg.family,
                "params": cfg.param_count(),
                "source": cfg.source,
                # meta may hold callables (e.g. the member apply fn);
                # describe() feeds JSON responses, so keep scalars only
                **{k: v for k, v in rm.meta.items()
                   if isinstance(v, (str, int, float, bool))},
            })
        return out
