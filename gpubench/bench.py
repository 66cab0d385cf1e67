"""Finding a cell's pieces by name.

``BENCHMARK.json`` (at the root) names each cell's configuration and
traffic mix and lists the metrics. A configuration is the JSON file that
its entry's ``file`` names; a traffic mix is ``gpubench/traffic/<name>.json``.
The code a cell runs is found by the names those files give:

- ``gpubench/metrics/<metric>.py``: ``read(record)``, one reader a metric;
- ``gpubench/gen/<generator>.py``: the configuration's ``generator``;
- ``gpubench/systems/<index>.py``: the configuration's ``index``, the
  container under test (:mod:`gpubench.system` says what it defines);
- ``gpubench/references/<index>.py``: the plain reference of that kind, where
  it has its own; otherwise ``gpubench/reference.py``, the dense top-k;
- ``gpubench/loops/<loop>.py``: the mix's ``loop`` (its ``Loop`` class).

Each is looked for under the root first and then beside this file, so a
cell, configuration, mix, metric, index kind or loop is added as new files
alone.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # BENCHMARK.json entries that this cell reports
    per_layer: list
    root: Path = ROOT  # where its BENCHMARK.json and files were found


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _find(root: Path, rel: str) -> Path:
    for base in (root, ROOT):
        if (base / rel).is_file():
            return base / rel
    raise FileNotFoundError(f"gpubench: {rel} not found under {root} or {ROOT}")


def load_cell(name: str, root: Path = ROOT) -> Cell:
    root = Path(root)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"gpubench: no workload {name!r} in {root / 'BENCHMARK.json'}")
    w = cells[name]
    entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads(_find(root, entry["file"]).read_text())
    traffic = json.loads(_find(root, f"gpubench/traffic/{w['traffic']}.json").read_text())
    for what, got, want in (("config", config["name"], w["config"]),
                            ("traffic", traffic["name"], w["traffic"]),
                            ("traffic's config", traffic["config"], w["config"])):
        if got != want:
            raise ValueError(f"gpubench: {name}: {what} is {got!r}, BENCHMARK.json says {want!r}")
    return Cell(name, w["chips"], config, traffic,
                [m for m in spec["end_to_end"] if _applies(m, name)],
                [m for m in spec["per_layer"] if _applies(m, name)], root)


_LOADED: dict = {}


def module(folder: str, name: str, root: Path = ROOT):
    """The module ``gpubench/<folder>/<name>.py``, loaded once a file."""
    path = _find(Path(root), f"gpubench/{folder}/{name}.py")
    if path not in _LOADED:
        spec = importlib.util.spec_from_file_location(
            f"gpubench_{folder}_{name}".replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def reader(metric: str, root: Path = ROOT):
    """The ``read`` function of ``gpubench/metrics/<metric>.py``."""
    return module("metrics", metric, root).read


def generator(name: str, root: Path = ROOT):
    """The generator module ``gpubench/gen/<name>.py``."""
    return module("gen", name, root)


def system(index: str, root: Path = ROOT):
    """The index kind ``gpubench/systems/<index>.py``."""
    return module("systems", index, root)


def reference(index: str, root: Path = ROOT):
    """The plain reference of an index kind: ``gpubench/references/<index>.py``
    where there is one, else :mod:`gpubench.reference`."""
    try:
        return module("references", index, root)
    except FileNotFoundError:
        return importlib.import_module("gpubench.reference")


def loop(name: str, root: Path = ROOT):
    """The ``Loop`` class of ``gpubench/loops/<name>.py``."""
    return module("loops", name, root).Loop
