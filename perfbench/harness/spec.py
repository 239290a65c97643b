"""Finding a cell's parts by name: ``BENCHMARK.json`` at the root of the
checkout names the cell, its configuration and its traffic mix; each of
those, and each metric, is a file of its own under ``perfbench/``."""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

PERFBENCH = Path(__file__).resolve().parents[1]
ROOT = PERFBENCH.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


class SpecError(ValueError):
    """A cell, configuration, traffic mix or metric that is missing or
    malformed."""


def valid_name(name: str) -> bool:
    return isinstance(name, str) and NAME.fullmatch(name) is not None


def valid_unit(unit: str) -> bool:
    return isinstance(unit, str) and UNIT.fullmatch(unit) is not None


def load_json(path: Path) -> Any:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        raise SpecError(f"{path} is missing") from None


def load_module(path: Path) -> ModuleType:
    """Import the file at ``path`` as a module of its own (file names may
    hold dots, so they are not imported by package path)."""
    if not path.is_file():
        raise SpecError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + re.sub(r"\W", "_", str(path.relative_to(PERFBENCH))),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]] = field(default_factory=list)
    per_layer: List[Dict[str, Any]] = field(default_factory=list)

    def metrics(self, trace: bool) -> List[Dict[str, Any]]:
        """The metric entries this cell reports: its per-layer ones in a
        traced run, its end-to-end ones otherwise."""
        return self.per_layer if trace else self.end_to_end


def reports(entry: Dict[str, Any], cell: str) -> bool:
    """Whether a metric entry is reported in ``cell``: every cell where
    it lists none."""
    return "workloads" not in entry or cell in entry["workloads"]


def load_config(name: str, base: Path = PERFBENCH) -> Dict[str, Any]:
    if not valid_name(name):
        raise SpecError(f"bad configuration name {name!r}")
    cfg = load_json(base / "configs" / f"{name}.json")
    if cfg.get("name") != name:
        raise SpecError(f"configs/{name}.json names {cfg.get('name')!r}")
    return cfg


def load_traffic(name: str, base: Path = PERFBENCH) -> Dict[str, Any]:
    if not valid_name(name):
        raise SpecError(f"bad traffic name {name!r}")
    return load_json(base / "traffic" / f"{name}.json")


def load_cell(workload: str, root: Path = ROOT,
              base: Optional[Path] = None) -> Cell:
    """The cell named ``workload`` in ``root/BENCHMARK.json``, with its
    configuration and traffic files read from ``base`` (default
    ``root/perfbench``)."""
    base = base or root / "perfbench"
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench.get("workloads", [])}
    if workload not in cells:
        raise SpecError(f"no workload {workload!r} in BENCHMARK.json "
                        f"(has {sorted(cells)})")
    w = cells[workload]
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=load_config(w["config"], base),
        traffic=load_traffic(w["traffic"], base),
        end_to_end=[m for m in bench.get("end_to_end", [])
                    if reports(m, workload)],
        per_layer=[m for m in bench.get("per_layer", [])
                   if reports(m, workload)])


def metric_module(name: str, base: Path = PERFBENCH) -> ModuleType:
    """The reader of the metric ``name``: ``metrics/<name>.py``."""
    if not valid_name(name):
        raise SpecError(f"bad metric name {name!r}")
    return load_module(base / "metrics" / f"{name}.py")


def part_module(kind: str, name: str, base: Path = PERFBENCH) -> ModuleType:
    """A cell's part found by name: ``apps/<name>.py``,
    ``requests/<name>.py`` or ``reference/<name>.py``."""
    if kind not in ("apps", "requests", "reference") or not valid_name(name):
        raise SpecError(f"bad part {kind}/{name}")
    return load_module(base / kind / f"{name}.py")
