"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names its configuration, its traffic and its
chips; ``configs/<config>.json``, ``traffic/<traffic>.json`` and
``workloads/<cell>.json`` (set-up steps and the limits of the check) hold
the rest, ``metrics/<metric>.py`` reads each metric, and the
configuration's model and the traffic's generator are found as
``reference/<model>.py`` and ``generators/<generator>.py``. Adding a
cell, a configuration, a model family, a traffic mix or a metric adds
files and entries; no file of the harness changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KINDS = ("end_to_end", "per_layer")


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: Dict
    traffic: Dict
    setup: Dict

    @property
    def global_batch(self) -> int:
        return int(self.config["train"]["batch_size"]) * self.chips


def load_manifest(path: Path = MANIFEST) -> Dict:
    with open(path) as f:
        return json.load(f)


def _json(base: Path, kind: str, name: str) -> Dict:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    with open(base / kind / f"{name}.json") as f:
        return json.load(f)


def load_cell(name: str, manifest: Optional[Dict] = None,
              base: Path = HERE) -> Cell:
    """The cell ``name`` of ``manifest`` (default ``BENCHMARK.json``), its
    files read from under ``base``."""
    manifest = load_manifest() if manifest is None else manifest
    entry = next((w for w in manifest["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        known = [w["name"] for w in manifest["workloads"]]
        raise ValueError(f"unknown workload {name!r}; known: {known}")
    cell = Cell(name, int(entry["chips"]), entry["config"], entry["traffic"],
                _json(base, "configs", entry["config"]),
                _json(base, "traffic", entry["traffic"]),
                _json(base, "workloads", name))
    if int(cell.traffic["global_batch"]) != cell.global_batch:
        raise ValueError(
            f"{name}: traffic {cell.traffic_name!r} sends global batches of "
            f"{cell.traffic['global_batch']} rows, the configuration's "
            f"{cell.config['train']['batch_size']} a worker on "
            f"{cell.chips} chip(s) take {cell.global_batch}")
    return cell


def metrics_for(manifest: Dict, cell: str, kind: str) -> List[Dict]:
    """The ``kind`` metrics a cell reports: those without ``workloads``
    and those that list it."""
    return [m for m in manifest[kind]
            if "workloads" not in m or cell in m["workloads"]]


def module(kind: str, name: str, base: Path = HERE) -> ModuleType:
    """``<base>/<kind>/<name>.py``, loaded as ``gkbench.<kind>.<name>``: a
    metric's reader (``metrics``), a model's reference (``reference``) or
    a traffic generator (``generators``), found by its name alone."""
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = base / kind / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no {kind} module {name!r}: add "
                         f"gkbench/{kind}/{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"gkbench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    loaded = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(loaded)
    return loaded


def reader(name: str, base: Path = HERE) -> ModuleType:
    """``metrics/<name>.py`` under ``base``, whose ``read(ctx)`` gives the
    metric or None when it finds nothing to read."""
    return module("metrics", name, base)
