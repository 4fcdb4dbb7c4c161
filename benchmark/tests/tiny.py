"""A checkout of the benchmark with tiny cells beside the real ones, for
CPU rehearsals: the real configurations and mixes, cut to a size the CPU
runs in seconds, added as new files and entries."""
from __future__ import annotations

import json
import pathlib
import shutil

REPO = pathlib.Path(__file__).resolve().parents[2]
MIXES = ("points_1m", "mesh_new_1m", "mesh_refresh_1m")


def make_root(tmp: pathlib.Path) -> pathlib.Path:
    """``tmp`` as a checkout holding ``BENCHMARK.json`` and a copy of
    ``benchmark/``, plus the cells ``tiny.<mix>`` for each mix."""
    shutil.copytree(REPO / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads(
        (REPO / "benchmark/configs/gll4_shell_e4096.json").read_text())
    cfg["name"] = "tiny"
    cfg["mesh"].update(n_lat=4, n_lon=4, n_rad=5)
    (tmp / "benchmark/configs/tiny.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "tiny", "source": "a test",
                             "file": "benchmark/configs/tiny.json",
                             "reduced": [], "why": "CPU rehearsal"})
    for mix in MIXES:
        t = json.loads((REPO / f"benchmark/traffic/{mix}.json").read_text())
        if t["kind"] == "points":
            t["targets_per_job"] = 2000
        else:
            t["target_mesh"].update(n_lat=3, n_lon=3, n_rad=3)
        t["check_rows_per_job"] = 16
        t["trace_seconds"] = 0.2
        (tmp / f"benchmark/traffic/tiny_{mix}.json").write_text(
            json.dumps(t))
        cell = f"tiny.{mix}"
        bench["workloads"].append({"name": cell, "config": "tiny",
                                   "traffic": f"tiny_{mix}", "chips": 1,
                                   "why": "CPU rehearsal"})
        for m in bench["per_layer"]:
            if f"gll4_e4096.{mix}" in m.get("workloads", []):
                m["workloads"].append(cell)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
