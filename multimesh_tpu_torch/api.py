"""Public API facade.

Same function names, signatures, and defaults as the JAX package's facade
(and the reference's, reference multi_mesh/api.py), plus ``device``,
including the wall-clock timing print after each call (reference
api.py:50-57 pattern) and lazy imports of the engine, so ``h5py`` only
loads when an HDF5 entry point is called.  Every entry runs on ``device``
(None means ``cuda``).  All thirteen entries are here; the three plotting
ones need matplotlib only when they draw (``viz.plotter``).
"""
from __future__ import annotations

import functools
import pathlib
import time
from typing import List, Tuple, Union

import numpy as np

PathLike = Union[str, pathlib.Path]


def _timed(func):
    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        start = time.time()
        result = func(*args, **kwargs)
        runtime = time.time() - start
        if runtime >= 60:
            print(f"Finished in time: {runtime / 60:.3f} minutes")
        else:
            print(f"Finished in time: {runtime:.3f} seconds")
        return result

    return wrapper


@_timed
def query_model(
    coordinates,
    model,
    nelem_to_search: int = 20,
    parameters="TTI",
    model_path: str = "MODEL/data",
    coordinates_path: str = "MODEL/coordinates",
    device=None,
):
    """Query a GLL model at lat/lon/depth coordinates; returns [N, n_params]
    on the device (reference api.py:13-58).  ``parameters`` is accepted for
    parity; the model's own parameter set is returned, as in the
    reference."""
    from .engine import query_model as _impl

    del parameters
    return _impl(
        coordinates=np.asarray(coordinates),
        model=model,
        nelem_to_search=nelem_to_search,
        model_path=model_path,
        coordinates_path=coordinates_path,
        device=device,
    )


@_timed
def exodus_2_gll(
    mesh: PathLike,
    gll_model: PathLike,
    gll_order: int = 4,
    dimensions: int = 3,
    nelem_to_search: int = 20,
    parameters="TTI",
    model_path: str = "MODEL/data",
    coordinates_path: str = "MODEL/coordinates",
    device=None,
):
    """Interpolate nodal parameters from an Exodus mesh onto a GLL model
    (reference api.py:61-104)."""
    from .engine import exodus_2_gll as _impl

    return _impl(
        mesh, gll_model, gll_order, dimensions, nelem_to_search,
        parameters, model_path, coordinates_path, device=device,
    )


@_timed
def gll_2_gll(
    from_gll: PathLike,
    to_gll: PathLike,
    nelem_to_search: int = 20,
    parameters="TTI",
    from_model_path: str = "MODEL/data",
    to_model_path: str = "MODEL/data",
    from_coordinates_path: str = "MODEL/coordinates",
    to_coordinates_path: str = "MODEL/coordinates",
    gradient: bool = False,
    stored_array: PathLike | None = None,
    device=None,
):
    """GLL -> GLL whole-mesh transfer, file to file (reference
    api.py:106-155), on ``device`` (None means ``cuda``)."""
    from .engine import gll_2_gll as _impl

    return _impl(
        from_gll=from_gll,
        to_gll=to_gll,
        nelem_to_search=nelem_to_search,
        parameters=parameters,
        from_model_path=from_model_path,
        to_model_path=to_model_path,
        from_coordinates_path=from_coordinates_path,
        to_coordinates_path=to_coordinates_path,
        gradient=gradient,
        stored_array=stored_array,
        device=device,
    )


@_timed
def gll_2_gll_layered(
    from_gll: PathLike,
    to_gll: PathLike,
    layers: Union[str, List[int]],
    nelem_to_search: int = 20,
    parameters: Union[str, List[str]] = "ISO",
    stored_array: PathLike | None = None,
    make_spherical: bool = False,
    device=None,
):
    """Layer-restricted GLL -> GLL transfer (reference api.py:158-215)."""
    from .engine import gll_2_gll_layered as _impl

    return _impl(
        from_gll=from_gll,
        to_gll=to_gll,
        layers=layers,
        parameters=parameters,
        nelem_to_search=nelem_to_search,
        stored_array=stored_array,
        make_spherical=make_spherical,
        device=device,
    )


@_timed
def gll_2_gll_layered_multi(
    from_gll: PathLike,
    to_gll: PathLike,
    layers: Union[List[int], str] = "nocore",
    nelem_to_search: int = 20,
    parameters: Union[List[str], str] = "all",
    threads: int | None = None,
    stored_array: PathLike | None = None,
    make_spherical: bool = False,
    device=None,
):
    """Parallel-over-layers parity entry (reference api.py:218-274); the
    device pipeline already batches every layer, ``threads`` is ignored."""
    from .engine import gll_2_gll_layered_multi as _impl

    return _impl(
        from_gll=from_gll,
        to_gll=to_gll,
        layers=layers,
        parameters=parameters,
        nelem_to_search=nelem_to_search,
        threads=threads,
        stored_array=stored_array,
        make_spherical=make_spherical,
        device=device,
    )


@_timed
def gll_2_gll_layered_multi_two(
    from_gll: PathLike,
    to_gll: PathLike,
    layers: Union[List[int], str],
    nelem_to_search: int = 30,
    parameters: Union[List[str], str] = "all",
    stored_array: PathLike | None = None,
    make_spherical: bool = False,
    tolerance: float = 1.05,
    device=None,
):
    """Layered transfer with snap-to-nearest engine
    (reference api.py:645-699)."""
    from .engine import gll_2_gll_layered_multi_two as _impl

    return _impl(
        from_gll=from_gll,
        to_gll=to_gll,
        layers=layers,
        nelem_to_search=nelem_to_search,
        parameters=parameters,
        stored_array=stored_array,
        make_spherical=make_spherical,
        tolerance=tolerance,
        device=device,
    )


@_timed
def gll_2_exodus(
    gll_model: PathLike,
    exodus_model: PathLike,
    gll_order: int = 4,
    dimensions: int = 3,
    nelem_to_search: int = 20,
    parameters="TTI",
    model_path: str = "MODEL/data",
    coordinates_path: str = "MODEL/coordinates",
    gradient: bool = False,
    device=None,
):
    """GLL -> Exodus nodal transfer (reference api.py:277-317)."""
    from .engine import gll_2_exodus as _impl

    return _impl(
        gll_model, exodus_model, gll_order, dimensions, nelem_to_search,
        parameters, model_path, coordinates_path, gradient, device=device,
    )


@_timed
def interpolate_to_points(
    mesh,
    points,
    params_to_interp: List[str],
    make_spherical: bool = False,
    geocentric: bool = False,
    device=None,
):
    """Mesh -> point-cloud values, [N, n_params] on the device; points
    either xyz or (with ``geocentric``) lat/lon/depth (reference
    api.py:320-350)."""
    from .engine import interpolate_to_points as _impl
    from .utils import latlondepth_to_xyz

    points = np.asarray(points)
    if geocentric:
        points = latlondepth_to_xyz(points)
    return _impl(
        mesh=mesh,
        points=points,
        params_to_interp=params_to_interp,
        make_spherical=make_spherical,
        device=device,
    )


@_timed
def interpolate_to_mesh(
    old_mesh, new_mesh, params_to_interp=["VSV", "VSH", "VPV", "VPH"],
    device=None,
):
    """Sphere-mapped mesh-to-mesh nodal interpolation
    (reference api.py:353-393)."""
    from .engine import interpolate_to_mesh as _impl

    return _impl(old_mesh, new_mesh, params_to_interp, device=device)


def plot_depth_slice(
    mesh,
    depth_in_km: float,
    num: int,
    lat_extent: Tuple[float, float] = (-90.0, 90.0),
    lon_extent: Tuple[float, float] = (-180.0, 180.0),
    plot_diff_percentage: bool = False,
    cmap="chroma",
    parameter_to_plot: str = "VSV",
    figsize: Tuple[int, int] = (15, 8),
    projection: Union[str, object] = "Mollweide",
    coastlines: bool = True,
    borders: bool = False,
    stock_img: bool = False,
    savefig: bool = False,
    figname: str = "earth.png",
    reverse: bool = False,
    zero_center: bool = True,
    title: str | None = None,
    limits: Tuple[float, float] | None = None,
    device=None,
):
    """Plot a depth slice of a mesh (reference api.py:399-487; the
    reference hardcodes Mollweide with the projection kwarg commented out
    at api.py:409 -- exposed here as a working pass-through)."""
    from .viz.plotter import plot_depth_slice as _impl

    return _impl(
        mesh=mesh,
        depth_in_km=depth_in_km,
        num=num,
        lat_extent=lat_extent,
        lon_extent=lon_extent,
        plot_diff_percentage=plot_diff_percentage,
        cmap=cmap,
        parameter_to_plot=parameter_to_plot,
        figsize=figsize,
        projection=projection,
        coastlines=coastlines,
        borders=borders,
        stock_img=stock_img,
        savefig=savefig,
        figname=figname,
        reverse=reverse,
        zero_center=zero_center,
        title=title,
        limits=limits,
        device=device,
    )


def plot_cross_section(
    mesh,
    point_1_lat: float = -20,
    point_1_lng: float = 30,
    point_2_lat: float = 20,
    point_2_lng: float = 60,
    max_depth_in_km: float = 2800,
    min_depth_in_km: float = 0.0,
    nrads: int = 201,
    npoints: int = 301,
    filename: str = "cross_section.pdf",
    cmap="fusion",
    reverse: bool = True,
    clim: Tuple[float, float] = (-5, 5),
    param_to_interp: str = "VSV",
    discontinuities_to_plot: list = [410, 660, 1000],
    device=None,
):
    """Plot a great-circle cross section (reference api.py:490-545)."""
    from .viz.plotter import plot_cross_section as _impl

    return _impl(
        mesh=mesh,
        point_1_lat=point_1_lat,
        point_1_lng=point_1_lng,
        point_2_lat=point_2_lat,
        point_2_lng=point_2_lng,
        max_depth_in_km=max_depth_in_km,
        min_depth_in_km=min_depth_in_km,
        nrads=nrads,
        npoints=npoints,
        filename=filename,
        cmap=cmap,
        reverse=reverse,
        clim=clim,
        param_to_interp=param_to_interp,
        discontinuities_to_plot=discontinuities_to_plot,
        device=device,
    )


def find_good_projection(
    name: str = "default",
    central_longitude: float = 0.0,
    central_latitude: float = 0.0,
    satellite_height: float = 10000000.0,
    lat_extent=(-90.0, 90.0),
    lon_extent=(-180.0, 180.0),
    device=None,
):
    """Pick an appropriate map projection (reference api.py:548-597).
    ``device`` is taken for the facade's uniform signature; nothing here
    runs on a device."""
    from .viz.plotter import create_projection

    return create_projection(
        name=name,
        central_longitude=central_longitude,
        central_latitude=central_latitude,
        satellite_height=satellite_height,
        lat_extent=lat_extent,
        lon_extent=lon_extent,
    )


@_timed
def extract_regular_grid(
    mesh,
    parameters: List[str],
    lat_extent: Tuple[float, float, int],
    lon_extent: Tuple[float, float, int],
    depth_extent: Tuple[float, float, int],
    save_to_netcdf: bool = False,
    netcdf_path: PathLike | None = None,
    device=None,
):
    """Extract a regular lat/lon/depth grid dataset from a mesh
    (reference api.py:600-642)."""
    from .engine import extract_regular_grid as _impl

    ds = _impl(
        mesh=mesh,
        parameters=parameters,
        lat_extent=lat_extent,
        lon_extent=lon_extent,
        depth_extent=depth_extent,
        device=device,
    )
    if save_to_netcdf:
        if netcdf_path is None:
            raise ValueError("netcdf_path is required with save_to_netcdf")
        ds.to_netcdf(netcdf_path)
        return None
    # reference return-type parity: the reference returns an
    # xarray.Dataset (reference interpolator.py:1638-1646) -- users with
    # xarray installed get exactly that; without it the structurally
    # equivalent RegularGridData (same coords/data/attrs surface) is
    # returned instead of failing on import
    try:
        import xarray  # noqa: F401
    except ImportError:
        return ds
    return ds.to_xarray()
