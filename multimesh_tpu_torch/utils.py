"""Geometry and misc utilities (host side).

A copy of the JAX package's ``utils.py`` (host numpy; ``h5py`` and
``scipy`` only inside the functions that touch files).  Covers the
reference's utils surface (reference multi_mesh/utils.py): coordinate
transforms, rotation matrices, mesh rotation, parameter presets,
great-circle sampling and regular-grid dataset containers.  The dataset
container is a small self-contained class with optional xarray
conversion.
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import List, Union

import numpy as np

from .config import R_EARTH_M, PARAM_PRESETS


# -- parameter presets ----------------------------------------------------
def pick_parameters(parameters) -> List[str]:
    """Resolve "TTI"/"ISO" presets to parameter lists
    (reference utils.py:171-188)."""
    if isinstance(parameters, str) and parameters in PARAM_PRESETS:
        return list(PARAM_PRESETS[parameters])
    return list(parameters) if not isinstance(parameters, str) else [parameters]


# -- angle helpers --------------------------------------------------------
def lat2colat(lat):
    return 90.0 - np.asarray(lat)


def colat2lat(colat):
    return 90.0 - np.asarray(colat)


# -- spherical <-> cartesian ---------------------------------------------
def sph2cart(col, lon, rad):
    """Colatitude/longitude [radians] + radius -> x, y, z."""
    col, lon, rad = np.asarray(col), np.asarray(lon), np.asarray(rad)
    if (col < 0).any() or (col > np.pi).any():
        raise ValueError("Colatitude must be in range [0, pi].")
    sin_c = np.sin(col)
    return rad * sin_c * np.cos(lon), rad * sin_c * np.sin(lon), rad * np.cos(col)


def cart2sph(x, y, z):
    """x, y, z -> colatitude, longitude [radians], radius (origin-safe)."""
    x, y, z = np.asarray(x), np.asarray(y), np.asarray(z)
    r = np.sqrt(x * x + y * y + z * z)
    with np.errstate(invalid="ignore"):
        c = np.nan_to_num(np.divide(z, r))
    return np.arccos(c), np.arctan2(y, x), r


def latlondepth_to_xyz(latlondepth: np.ndarray) -> np.ndarray:
    """[N, 3] (lat deg, lon deg, depth m) -> [N, 3] cartesian meters
    (geocentric sphere of radius R_EARTH, reference utils.py:526-542)."""
    latlondepth = np.asarray(latlondepth, dtype=np.float64)
    r = R_EARTH_M - latlondepth[:, 2]
    colat = np.deg2rad(lat2colat(latlondepth[:, 0]))
    lon = np.deg2rad(latlondepth[:, 1])
    x, y, z = sph2cart(colat, lon, r)
    return np.stack([x, y, z], axis=-1)


# -- rotations ------------------------------------------------------------
def get_rot_matrix(angle: float, x: float, y: float, z: float) -> np.ndarray:
    """Right-hand-rule rotation matrix about axis (x, y, z) by ``angle``
    radians (Rodrigues form)."""
    axis = np.asarray([x, y, z], dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    kx, ky, kz = axis
    K = np.array([[0, -kz, ky], [kz, 0, -kx], [-ky, kx, 0]])
    return (
        np.eye(3) * np.cos(angle)
        + np.sin(angle) * K
        + (1 - np.cos(angle)) * np.outer(axis, axis)
    )


def rotate(x, y, z, matrix):
    return matrix @ np.array([np.asarray(x), np.asarray(y), np.asarray(z)])


def rotate_mesh(mesh, event_loc, backwards: bool = False):
    """Rotate an Exodus mesh's coordinates so ``event_loc`` ([lat, lon] in
    radians, as the reference treats it, utils.py:68-71) lands under the
    north pole; ``backwards`` applies the inverse rotation.

    ``mesh`` is a path to an Exodus file (rewritten in place)."""
    from .io.exodus import Exodus
    from scipy.io import netcdf_file

    lat, lon = event_loc
    event_vec = np.array(
        [np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon), np.sin(lat)]
    )
    event_vec /= np.linalg.norm(event_vec)
    north = np.array([0.0, 0.0, 1.0])
    axis = np.cross(event_vec, north)
    axis /= np.linalg.norm(axis)
    angle = np.arccos(np.clip(np.dot(event_vec, north), -1, 1))
    rot = get_rot_matrix(angle, *axis)
    if backwards:
        rot = rot.T

    e = Exodus(mesh, mode="a")
    rotated = (rot @ e.points.T).T
    with netcdf_file(str(mesh), "a", mmap=False) as f:
        for i, ax in enumerate("xyz"[: e.ndim]):
            f.variables[f"coord{ax}"][:] = rotated[:, i]
        f.flush()
    return rot


def load_exodus(file, find_centroids: bool = True):
    """Open an Exodus mesh, optionally with element centroids ready for
    candidate search (reference utils.py:191-203, whose KDTree there is
    replaced by the device search -- the centroids array plugs directly
    into ops.TransferOperator.build(centroids=...))."""
    from .io.exodus import Exodus

    exo = Exodus(file)
    if find_centroids:
        return exo, exo.get_element_centroid()
    return exo


# -- great-circle sampling ------------------------------------------------
def greatcircle_points(
    point_1_lat: float,
    point_1_lng: float,
    point_2_lat: float,
    point_2_lng: float,
    npts: int = 101,
) -> np.ndarray:
    """[npts, 2] (lat, lon) degrees along the great circle from point 1
    toward point 2.

    Matches the reference's sampling convention (i * s12 / npts for
    i in 0..npts-1, i.e. the end point itself is excluded; reference
    utils.py:545-574).  The reference uses the WGS84 geodesic via
    geographiclib; here the same ellipsoidal path is computed natively
    (multimesh_tpu_torch.geodesic, Vincenty inverse + direct, ~0.5 mm
    accuracy).  Only for nearly antipodal endpoints -- where Vincenty's
    iteration diverges -- does sampling fall back to an exact spherical
    great circle (within ~0.2% of the ellipsoidal path).
    """
    if npts < 3:
        raise ValueError("need at least 3 points")
    from . import geodesic as geod

    try:
        return geod.waypoints(
            point_1_lat, point_1_lng, point_2_lat, point_2_lng, npts
        )
    except geod.GeodesicError:
        pass  # nearly antipodal: spherical slerp below

    def unit(lat, lon):
        la, lo = np.deg2rad(lat), np.deg2rad(lon)
        return np.array(
            [np.cos(la) * np.cos(lo), np.cos(la) * np.sin(lo), np.sin(la)]
        )

    a, b = unit(point_1_lat, point_1_lng), unit(point_2_lat, point_2_lng)
    omega = np.arccos(np.clip(np.dot(a, b), -1, 1))
    if omega == 0:
        return np.tile([point_1_lat, point_1_lng], (npts, 1))
    t = np.arange(npts) / float(npts)  # end point excluded, as in reference
    sin_o = np.sin(omega)
    vecs = (
        (np.sin((1 - t) * omega) / sin_o)[:, None] * a[None, :]
        + (np.sin(t * omega) / sin_o)[:, None] * b[None, :]
    )
    lats = np.rad2deg(np.arcsin(np.clip(vecs[:, 2], -1, 1)))
    lons = np.rad2deg(np.arctan2(vecs[:, 1], vecs[:, 0]))
    return np.stack([lats, lons], axis=-1)


# -- regular-grid dataset container --------------------------------------
@dataclasses.dataclass
class RegularGridData:
    """A lat/lon/depth regular grid with named data variables.

    Self-contained stand-in for the xarray.Dataset the reference builds
    (reference utils.py:619-646): carries coordinate vectors, data arrays
    of shape [depth, lat, lon], units metadata, NetCDF serialization, and
    optional conversion to a real xarray.Dataset when that package exists.
    """

    lat: np.ndarray
    lon: np.ndarray
    depth: np.ndarray
    data: dict
    attrs: dict = dataclasses.field(
        default_factory=lambda: {"radius_in_meters": R_EARTH_M}
    )

    def __getitem__(self, name):
        return self.data[name]

    @property
    def coords(self):
        return {"depth": self.depth, "latitude": self.lat,
                "longitude": self.lon}

    def to_netcdf(self, path: Union[str, pathlib.Path],
                  format: str = "NETCDF4"):
        """Serialize to NetCDF.

        ``format="NETCDF4"`` (default, matching what the reference's
        ``xarray.Dataset.to_netcdf`` produces, reference api.py:639-642)
        writes an HDF5-based netCDF4 file via h5py using dimension
        scales -- readable by netCDF4-python, h5netcdf and xarray.
        ``format="NETCDF3_64BIT"`` writes a classic v2 file via scipy
        (no HDF5), readable by xarray's scipy engine.
        """
        if format == "NETCDF4":
            self._to_netcdf4(path)
        elif format in ("NETCDF3_64BIT", "NETCDF3_CLASSIC"):
            self._to_netcdf3(path, version=2 if format.endswith("64BIT")
                             else 1)
        else:
            raise ValueError(f"unknown NetCDF format {format!r}")

    _COORD_UNITS = (("depth", "m"), ("latitude", "deg"),
                    ("longitude", "deg"))

    def _coord_items(self):
        return (("depth", self.depth), ("latitude", self.lat),
                ("longitude", self.lon))

    def _to_netcdf4(self, path):
        import h5py

        with h5py.File(str(path), "w") as f:
            units = dict(self._COORD_UNITS)
            scales = {}
            for name, arr in self._coord_items():
                v = f.create_dataset(name,
                                     data=np.asarray(arr, np.float64))
                # netCDF4 dimension-with-coordinate-variable convention:
                # the coordinate dataset IS the HDF5 dimension scale
                v.make_scale(name)
                v.attrs["units"] = units[name]
                scales[name] = v
            for name, arr in self.data.items():
                v = f.create_dataset(name,
                                     data=np.asarray(arr, np.float64))
                for ax, dim in enumerate(("depth", "latitude",
                                          "longitude")):
                    v.dims[ax].attach_scale(scales[dim])
            f.attrs["radius_in_meters"] = float(
                self.attrs.get("radius_in_meters", R_EARTH_M)
            )

    def _to_netcdf3(self, path, version: int = 2):
        from scipy.io import netcdf_file

        with netcdf_file(str(path), "w", version=version) as f:
            units = dict(self._COORD_UNITS)
            for name, arr in self._coord_items():
                f.createDimension(name, len(arr))
                v = f.createVariable(name, "d", (name,))
                v[:] = np.asarray(arr, np.float64)
                v.units = units[name].encode()
            for name, arr in self.data.items():
                v = f.createVariable(
                    name, "d", ("depth", "latitude", "longitude")
                )
                v[:] = np.asarray(arr, np.float64)
            f.radius_in_meters = float(self.attrs.get("radius_in_meters",
                                                      R_EARTH_M))
            f.flush()

    @classmethod
    def from_netcdf(cls, path: Union[str, pathlib.Path]) -> "RegularGridData":
        """Read either NetCDF flavor back (sniffs the HDF5 magic)."""
        with open(str(path), "rb") as fh:
            magic = fh.read(8)
        if magic == b"\x89HDF\r\n\x1a\n":
            import h5py

            with h5py.File(str(path), "r") as f:
                lat = np.asarray(f["latitude"][:])
                lon = np.asarray(f["longitude"][:])
                depth = np.asarray(f["depth"][:])
                data = {
                    k: np.asarray(v[:])
                    for k, v in f.items()
                    if k not in ("latitude", "longitude", "depth")
                }
                attrs = {"radius_in_meters": float(
                    f.attrs.get("radius_in_meters", R_EARTH_M))}
            return cls(lat=lat, lon=lon, depth=depth, data=data,
                       attrs=attrs)
        from scipy.io import netcdf_file

        with netcdf_file(str(path), "r", mmap=False) as f:
            lat = np.asarray(f.variables["latitude"][:])
            lon = np.asarray(f.variables["longitude"][:])
            depth = np.asarray(f.variables["depth"][:])
            data = {
                k: np.asarray(v[:])
                for k, v in f.variables.items()
                if k not in ("latitude", "longitude", "depth")
            }
            attrs = {"radius_in_meters": float(
                getattr(f, "radius_in_meters", R_EARTH_M))}
        return cls(lat=lat, lon=lon, depth=depth, data=data, attrs=attrs)

    def to_xarray(self):  # pragma: no cover - needs xarray
        import xarray as xr

        ds = xr.Dataset(
            {
                k: (["depth", "latitude", "longitude"], v)
                for k, v in self.data.items()
            },
            coords=self.coords,
            attrs=self.attrs,
        )
        ds.depth.attrs["units"] = "m"
        ds.latitude.attrs["units"] = "deg"
        ds.longitude.attrs["units"] = "deg"
        return ds


@dataclasses.dataclass
class MeshDataset:
    """Element-nodal mesh data with coordinates, optionally layer-masked.

    Light-weight counterpart of the reference's mesh -> xarray.Dataset
    export (reference utils.py:220-352): ``data`` maps parameter ->
    [n_masked_elem, n_gll]; coordinates are either cartesian per-node
    x/y/z arrays of the same shape or spherical radius/colatitude/
    longitude; ``gll_order`` attribute matches the reference's.
    """

    data: dict
    coords: dict
    gll_order: int
    coord_type: str

    def __getitem__(self, name):
        return self.data[name]

    def to_xarray(self):  # pragma: no cover - needs xarray
        import xarray as xr

        dims = ["element", "point"]
        coords = {k: (dims, v) for k, v in self.coords.items()}
        ds = xr.Dataset(
            {k: (dims, v) for k, v in self.data.items()}, coords=coords
        )
        ds.attrs["gll_order"] = self.gll_order
        return ds


def create_dataset(
    file,
    layers="all",
    parameters=("all",),
    coords: str = "cartesian",
) -> MeshDataset:
    """Extract a (possibly layer-masked) dataset from a Salvus mesh file
    (reference utils.py:220-256).

    :param layers: layer ids or one of all/crust/mantle/core/nocore
    :param parameters: parameter names, or ("all",) for every nodal field
        except radius/z_node_1D
    :param coords: "cartesian" (per-node x/y/z) or "spherical"
        (radius from z_node_1D, colatitude, longitude)
    """
    from .io.salvus import SalvusMesh
    from .ops.layers import mesh_layer_masks

    mesh = file if hasattr(file, "element_nodal_fields") else SalvusMesh(
        file, fast_mode=False
    )
    masks, layer_ids = mesh_layer_masks(mesh, layers)
    mask = np.zeros(mesh.nelem, dtype=bool)
    for m in masks.values():
        mask |= m

    # lazy accessor: a fast_mode SalvusMesh has an empty raw dict until
    # first access -- reading it directly would yield an empty dataset
    fields = mesh.get_element_nodal_fields() if hasattr(
        mesh, "get_element_nodal_fields"
    ) else mesh.element_nodal_fields
    params = list(parameters)
    if params and params[0] == "all":
        params = [
            p
            for p in fields
            if p not in ("radius", "z_node_1D")
        ]
    data = {p: fields[p][mask] for p in params}
    nodes = mesh.points[mask]
    if coords == "cartesian":
        coord_map = {
            "x": nodes[..., 0], "y": nodes[..., 1], "z": nodes[..., 2],
        }
    elif coords == "spherical":
        r = fields["z_node_1D"][mask] * R_EARTH_M
        colat = np.arctan2(
            np.sqrt(nodes[..., 0] ** 2 + nodes[..., 1] ** 2), nodes[..., 2]
        )
        lon = np.arctan2(nodes[..., 1], nodes[..., 0])
        coord_map = {"radius": r, "colatitude": colat, "longitude": lon}
    else:
        raise ValueError(f"Coordinate type: {coords} is not supported")
    # the mesh knows its own order (dimension-aware); recomputing it
    # here with a hardcoded cube root would be wrong for 2D meshes
    gll_order = int(getattr(
        mesh, "shape_order",
        round(mesh.n_gll_points ** (1.0 / 3.0)) - 1,
    ))
    return MeshDataset(data=data, coords=coord_map, gll_order=gll_order,
                       coord_type=coords)


def create_dataset_grid(lat, lon, depth) -> RegularGridData:
    """Empty regular-grid dataset (reference create_xarray_dataset,
    utils.py:619-646)."""
    return RegularGridData(
        lat=np.asarray(lat, np.float64),
        lon=np.asarray(lon, np.float64),
        depth=np.asarray(depth, np.float64),
        data={},
    )
