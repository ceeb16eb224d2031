"""Finding the benchmark's pieces by name.

* a cell: ``cells/<cell>.json`` (its configuration, traffic, chips, end-to-end
  and per-layer metrics, limits of the output check and ``why``);
* a configuration: ``configs/<config>.json``, whose ``scene`` names the
  builder ``scenes/<scene>.py``;
* a traffic mix: ``traffic/<traffic>.json``, whose ``entry`` names the
  module ``entries/<entry>.py`` that drives the program;
* a per-layer metric: ``metrics/<metric>.py``, a reader that declares
  ``NAME``, ``UNIT``, ``BETTER``, ``SOURCE``, ``LAYER`` and ``MOVES`` and
  returns its value from a traced window's records (or None when it finds
  nothing to read). The cells that report it name it.

A later cell, configuration, traffic mix or metric is a new file; nothing
here lists them.
"""
from __future__ import annotations

import glob
import importlib
import importlib.util
import json
import os
import re

ROOT = os.path.dirname(os.path.abspath(__file__))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _json(kind: str, name: str) -> dict:
    if not NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    path = os.path.join(ROOT, kind, f"{name}.json")
    if not os.path.isfile(path):
        raise KeyError(f"no {kind[:-1] if kind.endswith('s') else kind} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def cell(name: str) -> dict:
    return dict(_json("cells", name), name=name)


def config(name: str) -> dict:
    return dict(_json("configs", name), name=name)


def traffic(name: str) -> dict:
    return dict(_json("traffic", name), name=name)


def _module(kind: str, name: str):
    if not NAME.match(name) or "." in name:
        raise ValueError(f"not a module name: {name!r}")
    return importlib.import_module(f"kzbench.{kind}.{name}")


def scene(name: str):
    return _module("scenes", name)


def entry(name: str):
    return _module("entries", name)


def names(kind: str) -> list:
    """The names of every ``<kind>/<name>.json`` (cells, configs, traffic)."""
    return sorted(os.path.basename(p)[:-5] for p in glob.glob(os.path.join(ROOT, kind, "*.json")))


def metric(name: str):
    """The per-layer metric reader ``metrics/<name>.py``."""
    if not NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    path = os.path.join(ROOT, "metrics", f"{name}.py")
    if not os.path.isfile(path):
        raise KeyError(f"no metric named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"kzbench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if mod.NAME != name:
        raise ValueError(f"{path} declares NAME {mod.NAME!r}")
    return mod


def metric_names() -> list:
    """The names of every ``metrics/<name>.py``."""
    return sorted(os.path.basename(p)[:-3]
                  for p in glob.glob(os.path.join(ROOT, "metrics", "*.py")))


def metrics_of(cell_name: str) -> list:
    """The per-layer metrics a cell reports: those its file names."""
    return [metric(name) for name in cell(cell_name)["per_layer"]]
