"""``Precision.F64`` and ``locate``'s progress reporter, against the JAX
package on the CPU (``test_torch_locate.py``'s shell fixture: E = 80,
one sixth of the targets outside the shell).  A file of its own so that
test workers, which take files whole, run it beside that one.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from multimesh_tpu.config import LocateConfig  # noqa: E402
from multimesh_tpu.config import Precision as JPrecision  # noqa: E402
from multimesh_tpu.search import locate as jlocate  # noqa: E402
from multimesh_tpu_torch import progress as tprogress  # noqa: E402
from multimesh_tpu_torch.config import (  # noqa: E402
    LocateConfig as TLocateConfig,
)
from multimesh_tpu_torch.config import Precision as TPrecision  # noqa: E402
from multimesh_tpu_torch.search import locate as tloc  # noqa: E402
from tests.test_torch_locate import N, _values, shell  # noqa: E402,F401


@pytest.mark.parametrize("fallback", ["sentinel", "snap"])
def test_f64_precision_matches_jax_f64(shell, fallback):
    """``Precision.F64`` against the JAX package's F64 on its CPU engine
    (every Newton step in f64): found agrees on >= 99.9% of rows; where
    the elements agree on accepted rows, refs to 1e-10 and the applied
    field to 1e-10 relative; refs and weights are f64."""
    mesh, pts, field = shell
    want = jlocate(pts, mesh.points, 4,
                   LocateConfig(precision=JPrecision.F64), fallback=fallback,
                   engine="xla", strategy="ladder")
    got = tloc.locate(pts, mesh.points, 4,
                      TLocateConfig(precision=TPrecision.F64),
                      fallback=fallback, device="cpu")
    assert got.refs.dtype == torch.float64
    assert got.weights.dtype == torch.float64 and got.refs_lo is None
    w_el, w_found = np.asarray(want.elements), np.asarray(want.found)
    assert (got.found.numpy() == w_found).mean() >= 0.999
    same = got.accepted.numpy() & (got.elements.numpy() == w_el)
    assert same.mean() > 0.8
    np.testing.assert_allclose(got.refs.numpy()[same],
                               np.asarray(want.refs)[same], rtol=0,
                               atol=1e-10)
    vals = _values(got.elements.numpy(), got.weights.numpy(), field)
    j_vals = _values(w_el, np.asarray(want.weights), field)
    np.testing.assert_allclose(vals[same], j_vals[same], rtol=1e-10)


def test_f64_precision_is_f64_polish_on_both_strategies(shell):
    """``Precision.F64`` gives bit for bit what ``f64_polish`` gives on
    the ladder, and on the scan (where ``f64_polish`` alone is skipped
    with a warning) the scan's result with the same f64 polish of its
    accepted rows."""
    mesh, pts, _ = shell
    f64 = TLocateConfig(precision=TPrecision.F64)
    got = tloc.locate(pts, mesh.points, 4, f64, fallback="snap",
                      device="cpu")
    pol = tloc.locate(pts, mesh.points, 4, TLocateConfig(f64_polish=True),
                      fallback="snap", device="cpu")
    for a, b in ((got.elements, pol.elements), (got.refs, pol.refs),
                 (got.weights, pol.weights), (got.found, pol.found)):
        assert torch.equal(a, b)
    sub = pts[N // 6:N // 6 + 512]
    scan = tloc.locate(sub, mesh.points, 4, f64, strategy="scan",
                       device="cpu")
    plain = tloc.locate(sub, mesh.points, 4, strategy="scan", device="cpu")
    assert scan.refs.dtype == torch.float64 and scan.accepted.all()
    assert torch.equal(scan.elements, plain.elements)
    prep = tloc._mesh_prep(mesh.points, 4, "cpu", want64=True)
    want = tloc._f64_polish(torch.as_tensor(sub), plain.elements, plain.refs,
                            plain.accepted, prep, 4, f64, 262_144)
    assert torch.equal(scan.refs, want)
    assert float((scan.refs - plain.refs.double()).abs().max()) > 0


def test_progress_reports_the_chunks_and_the_retry(shell, monkeypatch,
                                                    capsys):
    """With reporting on, the chunk loop reports as "locate" and the scan
    retry as "locate retry", the JAX package's labels; off (the default
    in a batch run), nothing is written and the result is the same."""
    mesh, pts, _ = shell
    monkeypatch.setenv("MMT_PROGRESS", "0")
    quiet = tloc.locate(pts, mesh.points, 4, fallback="snap", chunk=512,
                        device="cpu")
    assert capsys.readouterr().err == ""
    monkeypatch.setenv("MMT_PROGRESS", "1")
    # a bar for any number of chunks (the default wants 4 or more)
    monkeypatch.setattr(tloc, "_progress",
                        functools.partial(tprogress.progress, min_steps=1))
    got = tloc.locate(pts, mesh.points, 4, fallback="snap", chunk=512,
                      device="cpu")
    err = capsys.readouterr().err
    assert got.n_retry > 0
    assert "locate: done  4.1k pts" in err
    assert f"locate retry: done  {got.n_retry} pts" in err
    assert torch.equal(got.elements, quiet.elements)
    assert torch.equal(got.refs, quiet.refs)
    tloc.locate(pts[:600], mesh.points, 4, strategy="scan", chunk=128,
                device="cpu")
    assert "locate: done  600 pts" in capsys.readouterr().err


def test_progress_waits_for_the_device_value_on_its_stride():
    """The reporter reads one element of the value it is given about
    every 5% of the steps and at the last; the disabled one reads none."""
    class Value:
        reads = 0

        def numel(self):
            return 1

        def reshape(self, *shape):
            return self

        def __getitem__(self, key):
            return self

        def tolist(self):
            Value.reads += 1
            return [0]

    bar = tprogress.Progress(100, "x", n_steps=100, min_interval=1e9)
    for _ in range(100):
        bar.step(1, device_value=Value())
    assert Value.reads == 20  # every 5th step, the last among them
    Value.reads = 0
    tprogress._NULL.step(1, device_value=Value())
    assert Value.reads == 0
