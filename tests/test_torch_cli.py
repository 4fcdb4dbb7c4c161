"""``multimesh_tpu_torch.cli`` (click) against the JAX package's CLI: the
same three commands and options, ``--device`` in place of
``--platform``, and each command's output file against the JAX CLI's on
a copy of the same inputs.

The port's commands run with ``--device cpu`` (the plain twins, f32
refs), the JAX ones on its CPU engine (f64 refs), so written values are
held to 2e-6 relative, as ``test_torch_pipelines.py`` holds the engine
entries; against the port's own engine entry called directly they are
equal bit for bit.
"""
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
h5py = pytest.importorskip("h5py")

from click.testing import CliRunner  # noqa: E402

from multimesh_tpu import testing as jmt  # noqa: E402
from multimesh_tpu.cli import cli as jcli  # noqa: E402
from multimesh_tpu.io.exodus import write_exodus  # noqa: E402
from multimesh_tpu_torch import engine as tengine  # noqa: E402
from multimesh_tpu_torch.cli import cli as tcli  # noqa: E402
from multimesh_tpu_torch.io import exodus as teio  # noqa: E402
from multimesh_tpu_torch.io import salvus as tsio  # noqa: E402

RTOL = 2e-6  # f32 refs against f64 refs
TTI = ["VPV", "VPH", "VSV", "VSH", "RHO", "ETA", "QKAPPA", "QMU"]


@pytest.fixture
def exodus_pair(tmp_path):
    """The JAX CLI test's pair: a 4^3 hex box with the TTI parameters
    (smooth, each scaled) and a 3^3 box inside it with zeros."""
    a = jmt.box_mesh(shape=(4, 4, 4), order=1)
    b = jmt.box_mesh(shape=(3, 3, 3), order=1, extent=[(0.05, 0.95)] * 3)
    pa, pb = tmp_path / "a.e", tmp_path / "b.e"
    base = jmt.smooth_field(a.vertices, "smooth")
    write_exodus(pa, a.vertices, a.connectivity,
                 {p: base * (1 + 0.05 * i) for i, p in enumerate(TTI)})
    write_exodus(pb, b.vertices, b.connectivity,
                 {p: np.zeros(len(b.vertices)) for p in TTI})
    return pa, pb


def _copy(path, tag):
    return shutil.copyfile(path, path.with_name(f"{tag}_{path.name}"))


def _run(cli, args, env=None):
    r = CliRunner().invoke(cli, args, catch_exceptions=False, env=env)
    assert r.exit_code == 0, r.output
    assert "Finished in time" in r.output
    return r


def test_help_lists_the_three_commands_and_the_device_option():
    r = CliRunner().invoke(tcli, ["--help"])
    assert r.exit_code == 0
    for cmd in ("interpolate-mesh-a-to-b", "interpolate-mesh-to-gll",
                "interpolate-gll-to-mesh"):
        assert cmd in r.output
    assert "--device" in r.output and "cuda" in r.output
    for cmd, j in zip(tcli.commands.values(), jcli.commands.values()):
        assert cmd.name == j.name
        assert [p.name for p in cmd.params] == [p.name for p in j.params]
        assert [p.default for p in cmd.params] == [p.default
                                                   for p in j.params]


def test_module_runs_as_a_script():
    out = subprocess.run([sys.executable, "-m", "multimesh_tpu_torch.cli",
                          "--help"], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "interpolate-mesh-a-to-b" in out.stdout


@pytest.mark.parametrize("params", ["TTI", "VPV, VSV,"])
def test_mesh_a_to_b_matches_jax_cli(exodus_pair, params):
    pa, pb = exodus_pair
    t_b, j_b, e_b = _copy(pb, "t"), _copy(pb, "j"), _copy(pb, "e")
    _run(tcli, ["--device", "cpu", "interpolate-mesh-a-to-b", "--mesh_a",
                str(pa), "--mesh_b", str(t_b), "--params", params])
    _run(jcli, ["interpolate-mesh-a-to-b", "--mesh_a", str(pa), "--mesh_b",
                str(j_b), "--params", params])
    names = TTI if params == "TTI" else ["VPV", "VSV"]
    tengine.exodus_2_exodus(str(pa), str(e_b), parameters=names,
                            device="cpu")
    t, j, e = teio.Exodus(t_b), teio.Exodus(j_b), teio.Exodus(e_b)
    for name in names:
        got = t.get_nodal_field(name)
        np.testing.assert_allclose(got, j.get_nodal_field(name), rtol=RTOL)
        np.testing.assert_array_equal(got, e.get_nodal_field(name))
        assert np.abs(got).min() > 0


def test_device_comes_from_the_environment(exodus_pair, monkeypatch):
    """``$MMT_DEVICE`` sets the device when the option is not given."""
    pa, pb = exodus_pair
    seen = []
    monkeypatch.setattr(tengine, "exodus_2_exodus",
                        lambda **kw: seen.append(kw["device"]))
    _run(tcli, ["interpolate-mesh-a-to-b", "--mesh_a", str(pa), "--mesh_b",
                str(pb)], env={"MMT_DEVICE": "cpu"})
    _run(tcli, ["interpolate-mesh-a-to-b", "--mesh_a", str(pa), "--mesh_b",
                str(pb)], env={"MMT_DEVICE": None})
    assert seen == ["cpu", "cuda"]
    r = CliRunner().invoke(tcli, ["--device", "tpu", "interpolate-mesh-a-to-b",
                                  "--mesh_a", str(pa), "--mesh_b", str(pb)])
    assert r.exit_code != 0 and "tpu" in r.output and seen == ["cpu", "cuda"]


def test_mesh_to_gll_and_back_match_jax_cli(exodus_pair, tmp_path):
    pa, _ = exodus_pair
    gll_mesh = jmt.box_mesh(shape=(2, 2, 2), order=4,
                            extent=[(0.1, 0.9)] * 3)
    pg = tmp_path / "g.h5"
    jmt.write_salvus_fixture(pg, gll_mesh, parameters=("VPV", "VSV"))
    t_g, j_g = _copy(pg, "t"), _copy(pg, "j")
    _run(tcli, ["--device", "cpu", "interpolate-mesh-to-gll", "--mesh",
                str(pa), "--gll_model", str(t_g), "--params", "VPV,VSV"])
    _run(jcli, ["interpolate-mesh-to-gll", "--mesh", str(pa), "--gll_model",
                str(j_g), "--params", "VPV,VSV"])
    for name in ("VPV", "VSV"):
        got = tsio.SalvusMesh(t_g, fast_mode=False).element_nodal_fields[name]
        want = tsio.SalvusMesh(j_g, fast_mode=False).element_nodal_fields[name]
        np.testing.assert_allclose(got, want, rtol=RTOL)

    # back onto the nodes of an Exodus mesh inside the GLL model
    c = jmt.box_mesh(shape=(3, 3, 3), order=1, extent=[(0.15, 0.85)] * 3)
    pc = tmp_path / "c.e"
    write_exodus(pc, c.vertices, c.connectivity,
                 {p: np.zeros(len(c.vertices)) for p in ("VPV", "VSV")})
    t_c, j_c = _copy(pc, "t"), _copy(pc, "j")
    _run(tcli, ["--device", "cpu", "interpolate-gll-to-mesh", "--mesh",
                str(t_c), "--gll_model", str(t_g)])
    _run(jcli, ["interpolate-gll-to-mesh", "--mesh", str(j_c), "--gll_model",
                str(j_g)])
    for name in ("VPV", "VSV"):
        got = teio.Exodus(t_c).get_nodal_field(name)
        np.testing.assert_allclose(
            got, teio.Exodus(j_c).get_nodal_field(name), rtol=RTOL)
        assert np.abs(got).min() > 0
