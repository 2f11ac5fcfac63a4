"""``BENCHMARK.json`` and the files the harness finds by name in it.

A cell names a configuration and a traffic mix; each is a JSON file of its
own (``configs/<config>.json``, ``traffic/<cell>.json``), the traffic names
its route (``routes/<route>.py``), and every per-layer metric is a reader in
``metrics/<metric>.py``. Adding a configuration, a traffic mix, a route or a
metric adds files; no file here lists them.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def valid_name(name: str) -> bool:
    """A name starts with a letter, a digit or ``_`` and has at most 64 of
    ASCII letters, digits, ``_``, ``.`` and ``-``."""
    return bool(NAME_RE.match(name))


def load_benchmark(path: Path = BENCHMARK) -> dict:
    with open(path) as f:
        return json.load(f)


def _named(entries: List[dict], name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of ``BENCHMARK.json``: its entry, its configuration and
    its traffic, and the metrics it reports."""

    def __init__(self, name: str, bench: Optional[dict] = None):
        bench = load_benchmark() if bench is None else bench
        self.name = name
        self.entry = _named(bench["workloads"], name, "workload")
        cfg_entry = _named(bench["configs"], self.entry["config"], "config")
        self.config = load_config(cfg_entry["file"])
        self.traffic = load_traffic(self.entry["traffic"])
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in bench["end_to_end"] if applies(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if applies(m, name)]


def applies(metric: dict, cell: str) -> bool:
    """A metric with a ``workloads`` list is reported in those cells alone."""
    return "workloads" not in metric or cell in metric["workloads"]


def load_config(file: str) -> dict:
    """A configuration file, by its path relative to the checkout."""
    return _json(ROOT / file)


def load_traffic(name: str) -> dict:
    return _json(HERE / "traffic" / f"{name}.json")


def load_route(name: str) -> ModuleType:
    if not valid_name(name):
        raise ValueError(f"bad route name {name!r}")
    return importlib.import_module(f"perfbench.routes.{name}")


def load_metric(name: str) -> ModuleType:
    """The reader of a per-layer metric: ``metrics/<name>.py`` (the name may
    hold dots, so it is loaded by path, not imported by name)."""
    if not valid_name(name):
        raise ValueError(f"bad metric name {name!r}")
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_files() -> Dict[str, Path]:
    """Every reader under ``metrics/``, by metric name."""
    return {p.name[:-3]: p for p in sorted((HERE / "metrics").glob("*.py"))
            if not p.name.startswith("_")}
