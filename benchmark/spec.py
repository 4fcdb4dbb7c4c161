"""What a cell is made of, found by name.

``BENCHMARK.json`` at the root names every cell (``workloads``), its
configuration and its traffic mix, and every metric.  Each of those has a
file of its own under this folder:

* ``configs/<config>.json``: the deployment (``file`` in BENCHMARK.json);
* ``traffic/<traffic>.json``: the traffic mix, parameters only, read by
  the general job generator of its ``kind`` (``kinds/<kind>.py``);
* ``metrics/<metric>.py``: the reader of one per-layer metric, a function
  ``read(ctx)`` that returns a number or None.

So a later cell, configuration, mix or metric is new files plus new
entries; no file here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list
    base: pathlib.Path  # the folder of traffic/, metrics/, kinds/


def _load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _covers(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: pathlib.Path = HERE.parent) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, with its
    configuration and traffic mix read from their files (the mix from
    ``root/benchmark/traffic``) and the metrics it reports."""
    root = pathlib.Path(root)
    bench = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}; "
                       f"known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(root / configs[w["config"]]["file"])
    traffic = _load_json(root / HERE.name / "traffic"
                         / f"{w['traffic']}.json")
    return Cell(
        name=name, config=config, traffic=traffic, chips=int(w["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if _covers(m, name)],
        per_layer=[m for m in bench["per_layer"] if _covers(m, name)],
        base=root / HERE.name,
    )


def _load_module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, base: pathlib.Path = HERE):
    """``read(ctx)`` of ``metrics/<name>.py``."""
    path = pathlib.Path(base) / "metrics" / f"{name}.py"
    return _load_module(path, f"benchmark_metric_{name}").read


def job_kind(kind: str, base: pathlib.Path = HERE):
    """The job generator ``kinds/<kind>.py`` (its ``Jobs`` class)."""
    path = pathlib.Path(base) / "kinds" / f"{kind}.py"
    return _load_module(path, f"benchmark_kind_{kind}").Jobs
