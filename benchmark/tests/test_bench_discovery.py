"""A later cell, configuration, traffic mix or per-layer metric is new
files plus new entries in BENCHMARK.json: the harness finds each by name
and no existing file of the benchmark changes."""
import hashlib
import json

import pytest

from benchmark import run, spec
from benchmark.tests import tiny


def _digests(folder):
    return {p.relative_to(folder): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_and_entries_are_found_with_nothing_edited(tmp_path):
    root = tiny.make_root(tmp_path)
    before = _digests(root / "benchmark")
    # a new configuration, a new mix and a new metric, each a new file
    cfg = json.loads((root / "benchmark/configs/tiny.json").read_text())
    cfg["mesh"].update(n_lat=5, n_rad=4)
    (root / "benchmark/configs/later_cfg.json").write_text(json.dumps(cfg))
    mix = json.loads(
        (root / "benchmark/traffic/tiny_points_1m.json").read_text())
    mix["targets_per_job"] = 1500
    (root / "benchmark/traffic/later_mix.json").write_text(json.dumps(mix))
    seen = tmp_path / "seen.txt"
    (root / "benchmark/metrics/later.jobs_read.py").write_text(
        "def read(ctx):\n"
        f"    open({str(seen)!r}, 'a').write(str(ctx['jobs']))\n"
        "    return float(ctx['jobs'])\n")
    # ... and new entries
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "later_cfg", "source": "a test",
                             "file": "benchmark/configs/later_cfg.json",
                             "reduced": [], "why": "a later configuration"})
    bench["workloads"].append({"name": "later.cell", "config": "later_cfg",
                               "traffic": "later_mix", "chips": 1,
                               "why": "a later cell"})
    bench["per_layer"].append({"name": "later.jobs_read", "unit": "jobs",
                               "better": "higher", "source": "host_clock",
                               "layer": "a later layer",
                               "moves": "mpts_per_s",
                               "workloads": ["later.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell("later.cell", root)
    assert cell.config["mesh"]["n_lat"] == 5
    assert cell.traffic["targets_per_job"] == 1500
    assert "later.jobs_read" in [m["name"] for m in cell.per_layer]
    assert "later.jobs_read" not in [
        m["name"] for m in spec.load_cell("tiny.points_1m", root).per_layer]
    result = run.run_cell(cell, 77, 0.2, True, "cpu")
    assert result["correct"], result["checks"]
    assert int(seen.read_text()) >= 1  # the new reader was called
    after = _digests(root / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before


def test_an_unknown_cell_names_the_known_ones(tmp_path):
    root = tiny.make_root(tmp_path)
    with pytest.raises(KeyError, match="gll4_e4096.points_1m"):
        spec.load_cell("no.such.cell", root)
