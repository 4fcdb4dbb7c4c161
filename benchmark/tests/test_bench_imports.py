"""The harness runs without JAX and without the JAX package, compared by
whole top-level module names, and refuses to run without a card."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import run
from benchmark.tests import tiny

SCRIPT = """
import json, pathlib, sys, tempfile
sys.path.insert(0, {repo!r})
from benchmark import control, run, spec
from benchmark.tests import tiny
root = tiny.make_root(pathlib.Path(tempfile.mkdtemp()))
for mix in tiny.MIXES:
    cell = spec.load_cell("tiny." + mix, root)
    for m in cell.per_layer:
        spec.metric_reader(m["name"], cell.base)
    r = run.run_cell(cell, 5, 0.1, True, "cpu")
    assert r["correct"], r
print(json.dumps({{"forbidden": run.forbidden_modules(),
                  "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def test_a_whole_rehearsal_loads_neither_jax_nor_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(repo=str(tiny.REPO))],
        capture_output=True, text=True, timeout=600, cwd=tiny.REPO,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert seen["forbidden"] == []
    assert "multimesh_tpu_torch" in seen["top"]
    assert "multimesh_tpu" not in seen["top"] and "jax" not in seen["top"]


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "multimesh_tpu_torch_x", sys)
    assert "multimesh_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "multimesh_tpu.ops", sys)
    assert "multimesh_tpu" in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert "jaxlib" in run.forbidden_modules()


@pytest.mark.parametrize("alone", [False, True])
def test_without_a_card_the_command_prints_no_result(tmp_path, alone):
    """From the checkout, and from a folder holding only BENCHMARK.json and
    benchmark/ (no program): a nonzero exit and nothing on stdout."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cwd = tiny.REPO
    if alone:
        shutil.copytree(tiny.REPO / "benchmark", tmp_path / "benchmark",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(tiny.REPO / "BENCHMARK.json", tmp_path)
        cwd = tmp_path
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "gll4_e4096.points_1m", "--seed", str(2**31 + 3), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=cwd)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
