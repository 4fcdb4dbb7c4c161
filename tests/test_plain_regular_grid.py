"""The port's regular-grid export (``engine.extract_regular_grid``) held on
the CPU to the plain reference of upstream's semantics,
``plain/regular_grid.py``, which shares no code with either package: a
14^3 lat/lon/depth grid overhanging a 4 x 4 x 4 order-4 shell on seeded
random nodal values; inside rows within float32 accuracy, rows beyond
the accept tolerance's reach exactly 0 in both; the dataset's shape and
coordinates; the reference at the source's own GLL nodes; and the
benchmark's copy of it."""
import ast
import pathlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from multimesh_tpu_torch import engine as tengine  # noqa: E402
from multimesh_tpu_torch import testing as tmt  # noqa: E402
from plain import regular_grid as ref  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
PARAMS = ["VP", "VS"]
EXTENTS = dict(lat_extent=(15.0, 68.0, 14), lon_extent=(10.0, 88.0, 14),
               depth_extent=(-1.0e5, 3.0e6, 14))
# The source box (r, colatitude, longitude) of tmt.shell_mesh's defaults,
# four elements along each axis
BOX = [(3.48e6, 6.371e6), (0.5, 1.2), (0.3, 1.4)]
# The port locates in float32 Newton refs and applies float32
# coefficients; the reference works in float64.  On values of 1-2, random
# per node, the port lies within 1.4e-6 of it (relative); the reference's
# own interpolation in bfloat16 lies 2.9e-2 away.  The tolerance sits
# between them, with a factor of over 70 on either side.
RTOL = 1e-4
# an element's width inside every face, and past a face: accept 1.05
# reaches 2.5% of a width past a face, so a point beyond 5% is outside
INSIDE_MARGIN, OUTSIDE_BAND = 0.01, 0.05


def _values(mesh, seed):
    """[P, E, n] random values in [1, 2], one per distinct node: shared
    nodes carry one value, so the field is continuous."""
    E, n, _ = mesh.points.shape
    _, inv = np.unique(mesh.points.reshape(-1, 3), axis=0,
                       return_inverse=True)
    inv = inv.ravel()
    rng = np.random.default_rng(seed)
    return rng.uniform(1.0, 2.0, (len(PARAMS), inv.max() + 1))[
        :, inv].reshape(len(PARAMS), E, n)


def _sides(lat, lon, depth):
    """(inside, outside) [depth, lat, lon] masks: at least INSIDE_MARGIN
    of an element's width inside every face of the source box, or more
    than OUTSIDE_BAND of a width past one of its faces."""
    dd, la, lo = np.meshgrid(depth, lat, lon, indexing="ij")
    inside, outside = True, False
    for x, (a, b) in zip((ref.R_EARTH - dd, np.deg2rad(90.0 - la),
                          np.deg2rad(lo)), BOX):
        w = (b - a) / 4
        inside = inside & (x >= a + INSIDE_MARGIN * w) & (
            x <= b - INSIDE_MARGIN * w)
        outside = outside | (x < a - OUTSIDE_BAND * w) | (
            x > b + OUTSIDE_BAND * w)
    return inside, outside


@pytest.fixture(scope="module")
def case():
    """The source, its values, the port's dataset and the reference's
    (lat, lon, depth, data [P, depth, lat, lon])."""
    src = tmt.shell_mesh(n_lat=4, n_lon=4, n_rad=4, order=4)
    values = _values(src, seed=25)
    mesh = types.SimpleNamespace(
        points=src.points,
        element_nodal_fields={p: values[i] for i, p in enumerate(PARAMS)})
    ds = tengine.extract_regular_grid(mesh, PARAMS, device="cpu", **EXTENTS)
    want = ref.extract_regular_grid(src.points, values, EXTENTS["lat_extent"],
                                    EXTENTS["lon_extent"],
                                    EXTENTS["depth_extent"])
    return types.SimpleNamespace(src=src, values=values, ds=ds, want=want)


def test_dataset_shape_and_coordinates_equal_the_reference(case):
    lat, lon, depth, data = case.want
    np.testing.assert_array_equal(case.ds.lat, lat)
    np.testing.assert_array_equal(case.ds.lon, lon)
    np.testing.assert_array_equal(case.ds.depth, depth)
    assert data.shape == (len(PARAMS), 14, 14, 14)
    assert all(case.ds[p].shape == (14, 14, 14) for p in PARAMS)


def test_port_matches_the_plain_reference_inside_and_reads_zero_outside(
        case):
    lat, lon, depth, data = case.want
    inside, outside = _sides(lat, lon, depth)
    # the grid overhangs: both kinds of rows are there
    assert inside.sum() >= 300 and outside.sum() >= 1000
    got = np.stack([case.ds[p] for p in PARAMS])
    want = data.numpy()
    assert (want[:, inside] != 0).all()
    assert (np.abs(got[:, inside] - want[:, inside])
            / np.abs(want[:, inside])).max() < RTOL
    assert (got[:, outside] == 0).all() and (want[:, outside] == 0).all()
    # the reference's own interpolation in bfloat16 fails the tolerance
    element, xi = ref.locate(case.src.points,
                             ref.grid_points(lat, lon, depth))
    bf16 = ref.interpolate(case.values, element, xi,
                           dtype=torch.bfloat16).numpy().T.reshape(want.shape)
    assert (np.abs(bf16[:, inside] - want[:, inside])
            / np.abs(want[:, inside])).max() > 10 * RTOL


def test_reference_at_the_source_nodes_gives_the_nodal_values():
    """Every GLL node of the source reads its nodal value to 1e-10 (the
    f64 Newton lands on the node; shared nodes carry one value), and a
    point past the outer surface reads 0.0."""
    src = tmt.shell_mesh(n_lat=3, n_lon=3, n_rad=3, order=4)
    values = _values(src, seed=7)
    element, xi = ref.locate(src.points, src.points)
    got = ref.interpolate(values, element, xi).numpy()
    np.testing.assert_allclose(got, values.reshape(len(PARAMS), -1).T,
                               rtol=0, atol=1e-10)
    far = src.points[-5:, -1] * 1.1  # nodes on the outer surface, raised
    element, xi = ref.locate(src.points, far)
    assert (element == -1).all() and (xi == 0).all()
    assert (ref.interpolate(values, element, xi) == 0).all()


def test_the_benchmark_copy_is_byte_equal_and_imports_no_package():
    plain = (REPO / "plain/regular_grid.py").read_bytes()
    assert (REPO / "benchmark/reference_grid.py").read_bytes() == plain
    imported = set()
    for node in ast.walk(ast.parse(plain)):
        if isinstance(node, ast.Import):
            imported |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, "a relative import"
            imported.add(node.module.split(".")[0])
    assert imported == {"__future__", "contextlib", "functools", "math",
                        "numpy", "torch"}
