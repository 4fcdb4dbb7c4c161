"""The control of the correctness check: the plain reference in the
program's place, computed in bfloat16 (the precision below the
configuration's float32), reads above the limit that the program's own
values stay under.  On the CPU at a tiny size; on the card (``cuda``
marker) at the cell's own sizes, which ``control.py`` reads on a dozen
seeds for PERF.md."""
import pytest
import torch

from benchmark import control, spec
from benchmark.tests import tiny


@pytest.fixture
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return request.param


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("device", ["cpu"], indirect=True)
@pytest.mark.parametrize("mix", tiny.MIXES)
def test_control_fails_where_the_program_passes_tiny(root, device, mix):
    cell = spec.load_cell(f"tiny.{mix}", root)
    limit = cell.config["check"]["max_rel_err"]
    for _, program, ctrl in control.readings(cell, [11, 12, 13], 0.2,
                                             device):
        assert program["max_rel_err"] < limit < ctrl["max_rel_err"]
        assert program["checked"] == ctrl["checked"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("device", ["cuda"], indirect=True)
@pytest.mark.parametrize("workload", ["gll4_e4096.points_1m",
                                      "gll4_e4096.mesh_new_1m",
                                      "gll4_e4096.mesh_refresh_1m",
                                      "gll4_e499200.points_1m"])
def test_control_fails_where_the_program_passes_on_the_card(device,
                                                            workload):
    cell = spec.load_cell(workload, tiny.REPO)
    limit = cell.config["check"]["max_rel_err"]
    for _, program, ctrl in control.readings(cell, [21, 22, 23], 2.0,
                                             device):
        assert program["max_rel_err"] < limit < ctrl["max_rel_err"]
