"""The port's Exodus -> GLL path (``engine.exodus_2_gll_arrays``) against
the plain reference of upstream's semantics (``plain/exodus_gll.py``) on
the CPU: random warped hex boxes and a small order-1 shell, random nodal
fields, targets inside the hexes, past a boundary face in the accepted
band (1.0 to 1.025), past it in the best-so-far band (1.025 to 1.5), and
beyond 1.5, where both raise.

Tolerance.  ``RTOL`` = 2e-6 relative on every written value: the port
solves the trilinear inverse with f32 Newton refs (a ref error of a few
f32 ulps of the hex's unit frame, ~1e-7 of the field's swing across a
hex) and writes f32 (half an ulp, 6e-8); the reference solves in f64 and
rounds its values to f32 the same way.  An interpolation in bfloat16
misses by ~1e-3 (one case shows it fails this tolerance).  Elements
agree on at least 99.9% of the targets: a target on a shared face is
accepted by either hex, and both then give the same value.
"""
import json
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from multimesh_tpu_torch import engine as tengine  # noqa: E402
from multimesh_tpu_torch import testing as tmt  # noqa: E402
from plain import exodus_gll as pe  # noqa: E402

RTOL = 2e-6
AGREE = 0.999
PARAMS = ["VP", "VS", "RHO"]
SOURCES = ["box0", "box1", "box2", "shell"]
# canonical corner c at reference coordinates (2i - 1, 2j - 1, 2k - 1)
CORNER_REF = np.array([[2 * i - 1, 2 * j - 1, 2 * k - 1] for i in (0, 1)
                       for j in (0, 1) for k in (0, 1)], np.float64)


def _source(name):
    """(corner nodes [E, 8, 3], nodal fields [3, E, 8], outer) of a source:
    ``outer`` marks the hexes whose i = 1 face (reference axis 0 at +1)
    lies on the mesh's boundary.  Nodal values are drawn per vertex in
    [1, 2], so a vertex shared by hexes carries the same bits in each."""
    if name == "shell":
        m = tmt.shell_mesh(n_lat=4, n_lon=5, n_rad=3, order=1)
        vertices, conn = m.vertices, m.connectivity
        outer = np.arange(m.nelem) >= m.nelem - 4 * 5
        seed = 99
    else:
        seed = int(name[3:])
        shape = (4, 3, 3)
        m = tmt.box_mesh(shape=shape, order=1,
                         extent=[(0.0, 4.0), (0.0, 3.0), (0.0, 3.0)])
        vertices, conn = m.vertices.copy(), m.connectivity
        rng = np.random.default_rng(seed)
        hi = np.array([4.0, 3.0, 3.0])
        inner = np.all((vertices > 1e-9) & (vertices < hi - 1e-9), axis=1)
        vertices[inner] += rng.uniform(-0.2, 0.2, (int(inner.sum()), 3))
        outer = vertices[conn][:, 4:, 0].min(axis=1) > 4.0 - 1e-9
    rng = np.random.default_rng(seed + 1000)
    nodal = rng.uniform(1.0, 2.0, (len(PARAMS), len(vertices)))
    return vertices[conn], nodal[:, conn], outer


def _map(corners, xi):
    """Points [N, 3] at reference coordinates ``xi`` [N, 3] of ``corners``
    [N, 8, 3]: the trilinear map written out."""
    w = np.prod((1.0 + xi[:, None, :] * CORNER_REF) / 2.0, axis=-1)
    return np.einsum("nc,ncd->nd", w, corners)


def _targets(corners, outer, band, n=1500, seed=0):
    """``n`` targets [n, 1, 3] f32 and the hex each was made in: inside
    random hexes, or past the boundary face of outer hexes at a reference
    coordinate in ``band`` (the others kept in [-0.5, 0.5], so that hex
    stays the best candidate)."""
    rng = np.random.default_rng(seed)
    if band is None:
        elem = rng.integers(0, len(corners), n)
        xi = rng.uniform(-1.0, 1.0, (n, 3))
    else:
        elem = rng.choice(np.flatnonzero(outer), n)
        xi = rng.uniform(-0.5, 0.5, (n, 3))
        xi[:, 0] = rng.uniform(*band, n)
    pts = _map(corners[elem], xi)
    return pts.astype(np.float32).reshape(n, 1, 3), elem


def _port(corners, fields, coords):
    """The port's sink [npoints, 3, n_gll] f32, and its elements."""
    sink = np.full((coords.shape[0], len(PARAMS), coords.shape[1]), np.nan,
                   np.float32)
    tengine.exodus_2_gll_arrays(corners, fields, PARAMS, coords,
                                lambda names: sink, device="cpu")
    op = tengine._exodus_operator(corners, coords.reshape(-1, 3), 20, "cpu")
    return sink, op.elements.long().numpy()


def _plain(corners, fields, coords):
    ref = pe.exodus_2_gll(corners, fields, coords).numpy()
    elem, _, _ = pe.locate(corners, coords.reshape(-1, 3))
    return ref, elem.numpy()


@pytest.mark.parametrize("band", [None, (1.0, 1.025), (1.03, 1.45)],
                         ids=["inside", "accepted_band", "best_so_far"])
@pytest.mark.parametrize("name", SOURCES)
def test_the_path_writes_the_plain_references_values(name, band):
    corners, fields, outer = _source(name)
    coords, made_in = _targets(corners, outer, band)
    sink, port_elem = _port(corners, fields, coords)
    ref, plain_elem = _plain(corners, fields, coords)
    np.testing.assert_allclose(sink, ref, rtol=RTOL, atol=0)
    assert (port_elem == plain_elem).mean() >= AGREE
    if band is not None:  # past the boundary only the hex made in fits
        np.testing.assert_array_equal(plain_elem, made_in)
        np.testing.assert_array_equal(port_elem, made_in)


@pytest.mark.parametrize("name", SOURCES)
def test_a_target_beyond_the_fallback_raises_in_both(name):
    corners, fields, outer = _source(name)
    coords, _ = _targets(corners, outer, (1.6, 2.0), n=3)
    inside, _ = _targets(corners, outer, None, n=50)
    coords = np.concatenate([inside, coords])
    sink = np.zeros((coords.shape[0], 3, 1), np.float32)
    with pytest.raises(RuntimeError, match="3 points could not be"):
        tengine.exodus_2_gll_arrays(corners, fields, PARAMS, coords,
                                    lambda names: sink, device="cpu")
    assert not sink.any()  # nothing written
    with pytest.raises(RuntimeError, match="3 points could not be"):
        pe.exodus_2_gll(corners, fields, coords)


def test_a_bfloat16_interpolation_fails_the_tolerance():
    corners, fields, outer = _source("box0")
    coords, _ = _targets(corners, outer, None)
    sink, _ = _port(corners, fields, coords)
    elem, w, found = pe.locate(corners, coords.reshape(-1, 3))
    assert found.all()
    f = torch.as_tensor(fields)[:, elem, :].to(torch.bfloat16)
    low = (f * w.to(torch.bfloat16)[None]).sum(dim=-1).T.float()
    low = low.reshape(coords.shape[0], 1, len(PARAMS)).transpose(1, 2)
    rel = np.abs(low.numpy() - sink) / np.abs(sink)
    assert rel.max() > 10 * RTOL
    np.testing.assert_allclose(pe.exodus_2_gll(corners, fields, coords),
                               sink, rtol=RTOL, atol=0)


def test_the_weights_are_the_trilinear_map():
    corners, _, _ = _source("box1")
    rng = np.random.default_rng(5)
    xi = rng.uniform(-1.3, 1.3, (200, 3))
    w = pe.trilinear_weights(torch.as_tensor(xi)).numpy()
    np.testing.assert_allclose(w.sum(axis=1), 1.0, rtol=1e-14)
    elem = rng.integers(0, len(corners), 200)
    np.testing.assert_allclose(np.einsum("nc,ncd->nd", w, corners[elem]),
                               _map(corners[elem], xi), rtol=1e-13)
    back, conv = pe.inverse_map(torch.as_tensor(corners[elem]),
                                torch.as_tensor(_map(corners[elem], xi)))
    assert conv.all()
    np.testing.assert_allclose(back.numpy(), xi, atol=1e-10)


def test_the_reference_imports_neither_jax_nor_either_package():
    code = ("import json, sys; import plain.exodus_gll; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=str(pe.__file__).rsplit("/plain/", 1)[0])
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "plain" in top and "torch" in top
    assert not top & {"jax", "jaxlib", "multimesh_tpu", "multimesh_tpu_torch"}
