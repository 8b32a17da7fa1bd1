"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads[i]``) names a configuration and a traffic mix.  The
harness reads:

* the configuration's file, ``configs[j].file``;
* the traffic mix, ``gpubench/workloads/<cell>.json``: its ``entry`` names
  the module ``gpubench/entries/<entry>.py`` that drives the program;
* the FLOP and byte arithmetic, ``gpubench/flops/<module>.py``, one module
  per configuration and per kernel;
* each per-layer metric's reader, ``gpubench/metrics/<name>.py``, where a
  name ``a.b.c`` is looked up as ``a.b.c.py``, then ``a.b.py``, then
  ``a.py``: a metric split by a suffix per cell (``idle_share.b4`` and a
  later cell's ``idle_share.b1``) shares one reader.

A new cell, configuration or metric is new files and new entries in
``BENCHMARK.json``; no file of the harness changes.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import sys
from dataclasses import dataclass
from types import ModuleType
from typing import Optional

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG_DIR)


@dataclass
class Cell:
    """One cell with everything the harness reads for it."""

    name: str
    chips: int
    config: dict       # the configuration file's contents
    config_entry: dict  # its entry in BENCHMARK.json
    traffic: dict      # the traffic mix's contents
    end_to_end: list   # the metric entries this cell reports
    per_layer: list


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def module_name(name: str) -> str:
    """A file name's stem as a Python module name (``-`` and ``.`` to
    ``_``)."""
    return name.replace("-", "_").replace(".", "_")


def load_module(path: str) -> ModuleType:
    """The Python file at ``path``, loaded once per process under a name
    made from its path inside the harness."""
    path = os.path.abspath(path)
    stem = module_name(os.path.basename(path)[:-3])
    digest = hashlib.sha1(path.encode()).hexdigest()[:12]
    name = f"gpubench._found.{stem}_{digest}"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _for_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Manifest:
    """``BENCHMARK.json`` at ``root``, and the harness's files under
    ``root/gpubench`` (``bench_dir``)."""

    def __init__(self, root: str = ROOT, bench_dir: Optional[str] = None):
        self.root = root
        self.bench_dir = bench_dir or os.path.join(root, "gpubench")
        self.data = load_json(os.path.join(root, "BENCHMARK.json"))

    def cell(self, name: str) -> Cell:
        cells = {w["name"]: w for w in self.data["workloads"]}
        if name not in cells:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json "
                           f"(cells: {sorted(cells)})")
        w = cells[name]
        configs = {c["name"]: c for c in self.data["configs"]}
        entry = configs[w["config"]]
        config = load_json(os.path.join(self.root, entry["file"]))
        traffic = load_json(self.path("workloads", f"{name}.json"))
        if traffic.get("config") != w["config"]:
            raise ValueError(f"traffic of {name} is for configuration "
                             f"{traffic.get('config')!r}, the cell names "
                             f"{w['config']!r}")
        return Cell(name=name, chips=int(w["chips"]), config=config,
                    config_entry=entry, traffic=traffic,
                    end_to_end=[m for m in self.data["end_to_end"]
                                if _for_cell(m, name)],
                    per_layer=[m for m in self.data["per_layer"]
                               if _for_cell(m, name)])

    def path(self, *parts: str) -> str:
        return os.path.join(self.bench_dir, *parts)

    def entry(self, cell: Cell) -> ModuleType:
        return load_module(self.path("entries", f"{cell.traffic['entry']}.py"))

    def flops(self, name: str) -> ModuleType:
        return load_module(self.path("flops", f"{module_name(name)}.py"))

    def reader(self, metric: str) -> ModuleType:
        parts = metric.split(".")
        while parts:
            path = self.path("metrics", ".".join(parts) + ".py")
            if os.path.exists(path):
                return load_module(path)
            parts.pop()
        raise FileNotFoundError(f"no reader for metric {metric!r} under "
                                f"{self.path('metrics')}")
