"""``multimesh_tpu_torch.geodesic`` and ``utils.greatcircle_points`` (pure
Python / host numpy, copies of the JAX package's) against the JAX
package's on the same seeded endpoints, bit for bit, and the cases the
copy must keep: Vincenty's failure near the antipode and the spherical
slerp that ``greatcircle_points`` takes there.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from multimesh_tpu import geodesic as jgeod  # noqa: E402
from multimesh_tpu import utils as jutils  # noqa: E402
from multimesh_tpu_torch import geodesic as tgeod  # noqa: E402
from multimesh_tpu_torch import utils as tutils  # noqa: E402


def _pairs(seed, n=40):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-85, 85, n), rng.uniform(-179, 179, n),
                     rng.uniform(-85, 85, n), rng.uniform(-179, 179, n)], -1)


def test_constants_equal():
    for name in ("WGS84_A", "WGS84_F", "WGS84_B", "_MAX_ITER", "_TOL"):
        assert getattr(tgeod, name) == getattr(jgeod, name)


def test_inverse_bit_equal_to_jax():
    for lat1, lon1, lat2, lon2 in _pairs(1):
        got = tgeod.inverse(lat1, lon1, lat2, lon2)
        want = jgeod.inverse(lat1, lon1, lat2, lon2)
        assert (got.s12, got.azi1, got.azi2) == (want.s12, want.azi1,
                                                want.azi2)
        assert got["lat2"] == want["lat2"] == lat2  # dict-style access


def test_inverse_coincident_points():
    r = tgeod.inverse(12.5, 40.0, 12.5, 40.0)
    assert r.s12 == 0.0 and r.azi1 == 0.0


def test_direct_bit_equal_to_jax():
    rng = np.random.default_rng(2)
    for lat1, lon1, *_ in _pairs(2):
        azi, s = rng.uniform(-180, 180), rng.uniform(1e3, 1.5e7)
        got = tgeod.direct(lat1, lon1, azi, s)
        want = jgeod.direct(lat1, lon1, azi, s)
        assert (got.lat2, got.lon2, got.azi2) == (want.lat2, want.lon2,
                                                  want.azi2)
        assert -180.0 <= got.lon2 < 180.0


@pytest.mark.parametrize("npts", [3, 17, 101])
def test_waypoints_bit_equal_to_jax(npts):
    for lat1, lon1, lat2, lon2 in _pairs(3, n=6):
        got = tgeod.waypoints(lat1, lon1, lat2, lon2, npts)
        want = jgeod.waypoints(lat1, lon1, lat2, lon2, npts)
        assert got.shape == (npts, 2)
        np.testing.assert_array_equal(got, want)


def test_near_antipode_raises_geodesic_error():
    """Vincenty's lambda iteration diverges within ~0.5 deg of the
    antipode: both packages raise their GeodesicError."""
    with pytest.raises(tgeod.GeodesicError):
        tgeod.inverse(0.0, 0.0, 0.5, 179.7)
    with pytest.raises(jgeod.GeodesicError):
        jgeod.inverse(0.0, 0.0, 0.5, 179.7)


def test_greatcircle_points_geodesic_branch():
    for lat1, lon1, lat2, lon2 in _pairs(4, n=5):
        got = tutils.greatcircle_points(lat1, lon1, lat2, lon2, npts=51)
        np.testing.assert_array_equal(
            got, jutils.greatcircle_points(lat1, lon1, lat2, lon2, npts=51))
        np.testing.assert_array_equal(
            got, tgeod.waypoints(lat1, lon1, lat2, lon2, 51))


def test_greatcircle_points_slerp_branch():
    """Nearly antipodal endpoints take the spherical slerp: equal to the
    JAX package's, starting at point 1, every sample on the unit sphere's
    great circle through both points (the end point excluded); fewer
    than 3 points raise."""
    args = (0.0, 0.0, 0.5, 179.7)
    got = tutils.greatcircle_points(*args, npts=41)
    np.testing.assert_array_equal(got, jutils.greatcircle_points(*args,
                                                                 npts=41))
    np.testing.assert_allclose(got[0], [0.0, 0.0], atol=1e-12)

    def unit(lat, lon):
        la, lo = np.deg2rad(lat), np.deg2rad(lon)
        return np.stack([np.cos(la) * np.cos(lo), np.cos(la) * np.sin(lo),
                         np.sin(la)], -1)

    normal = np.cross(unit(*args[:2]), unit(*args[2:]))
    assert np.abs(unit(got[:, 0], got[:, 1]) @ normal).max() < 1e-9
    with pytest.raises(ValueError):
        tutils.greatcircle_points(*args, npts=2)
