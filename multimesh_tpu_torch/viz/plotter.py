"""Depth-slice and cross-section plotting (host side).

A copy of the JAX package's ``viz/plotter.py``, with two differences:
matplotlib is imported by the functions that draw (so the module imports
without it), and the sampling and interpolation of each plot are
functions of their own that need no matplotlib (``_create_depthslice``
and ``_depth_slice_values``, ``_cross_section_points`` and
``_cross_section_values``).  The interpolation runs on ``device`` (None
means ``cuda``) and its values come back to the host once.

Covers the reference plotter (reference multi_mesh/components/plotter.py):
lat/lon depth slices through `interpolate_to_points(geocentric=True)`,
great-circle cross sections with per-radius percent-deviation
normalization and discontinuity arcs, and extent-based projection choice.
cartopy / lasif / obspy are optional here: without cartopy the maps render
on plain lat/lon axes, the elliptic->geocentric latitude correction is
computed analytically (WGS84), and angular separation comes from the
spherical law of cosines.
"""
from __future__ import annotations

from typing import Tuple, Union

import numpy as np

from ..config import R_EARTH_M
from ..utils import greatcircle_points, lat2colat, sph2cart
from .colormaps import get_colormap


def _pyplot():
    """matplotlib.pyplot on the Agg backend unless one was chosen."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _have_cartopy() -> bool:
    try:  # pragma: no cover - not in CI image
        import cartopy  # noqa: F401

        return True
    except ImportError:
        return False


# WGS84 flattening
_F = 1.0 / 298.257223563


def elliptic_to_geocentric_latitude(lat_deg: float) -> float:
    """Geodetic -> geocentric latitude on WGS84:
    tan(phi_c) = (1 - f)^2 tan(phi) (replaces the lasif helper the
    reference imports, reference plotter.py:372-375)."""
    e2 = 2 * _F - _F * _F
    return np.rad2deg(np.arctan((1 - e2) * np.tan(np.deg2rad(lat_deg))))


def locations2degrees(lat1, lon1, lat2, lon2) -> float:
    """Angular separation in degrees (spherical law of cosines; replaces
    the obspy helper, reference plotter.py:400-402)."""
    la1, lo1, la2, lo2 = map(np.deg2rad, (lat1, lon1, lat2, lon2))
    cos_d = np.sin(la1) * np.sin(la2) + np.cos(la1) * np.cos(la2) * np.cos(
        lo2 - lo1
    )
    return float(np.rad2deg(np.arccos(np.clip(cos_d, -1, 1))))


def create_projection(
    name: str = "default",
    central_longitude: float = 0.0,
    central_latitude: float = 0.0,
    satellite_height: float = 10000000.0,
    lat_extent=(-90.0, 90.0),
    lon_extent=(-180.0, 180.0),
):
    """Pick a cartopy projection by name or by extent (reference
    plotter.py:212-306).  Without cartopy installed, returns None (plots
    fall back to plain lat/lon axes)."""
    if not _have_cartopy():
        return None
    import cartopy.crs as ccrs  # pragma: no cover - not in CI image

    lat_diff = lat_extent[1] - lat_extent[0]
    lon_diff = lon_extent[1] - lon_extent[0]
    if name == "default":
        if lat_diff > 160.0 or lon_diff > 180.0:
            return ccrs.Robinson(central_longitude=central_longitude)
        if lat_diff > 90.0 or lon_diff > 90.0:
            return ccrs.Orthographic(
                central_longitude=central_longitude,
                central_latitude=central_latitude,
            )
        return ccrs.Mercator(
            central_longitude=central_longitude,
            min_latitude=lat_extent[0],
            max_latitude=lat_extent[1],
        )
    table = {
        "flatearth": lambda: ccrs.NorthPolarStereo(
            central_longitude=central_longitude
        ),
        "mercator": lambda: ccrs.Mercator(
            central_longitude=central_longitude,
            min_latitude=lat_extent[0],
            max_latitude=lat_extent[1],
        ),
        "mollweide": lambda: ccrs.Mollweide(
            central_longitude=central_longitude
        ),
        "nearsideperspective": lambda: ccrs.NearsidePerspective(
            central_longitude=central_longitude,
            central_latitude=central_latitude,
            satellite_height=satellite_height,
        ),
        "orthographic": lambda: ccrs.Orthographic(
            central_latitude=central_latitude,
            central_longitude=central_longitude,
        ),
        "platecarree": lambda: ccrs.PlateCarree(
            central_longitude=central_longitude
        ),
        "robinson": lambda: ccrs.Robinson(
            central_longitude=central_longitude
        ),
    }
    key = name.lower()
    if key not in table:
        raise ValueError(
            "Projection not implemented, try implementing it in Cartopy"
        )
    return table[key]()


def _create_depthslice(
    depth_in_m: float,
    num: int,
    lat_extent=(-90.0, 90.0),
    lon_extent=(-180.0, 180.0),
):
    """[num*num, 3] (lat, lon, depth) sampling grid at fixed depth
    (reference plotter.py:159-187)."""
    lat = np.linspace(lat_extent[0], lat_extent[1], num=num)
    lon = np.linspace(lon_extent[0], lon_extent[1], num=num)
    xx, yy = np.meshgrid(lat, lon)
    return np.stack(
        [xx.ravel(), yy.ravel(), np.full(xx.size, depth_in_m)], axis=-1
    )


def _depth_slice_values(mesh, depth_in_km, num, lat_extent, lon_extent,
                        parameter_to_plot, device=None):
    """The depth slice's [num, num] values on the host: the sampling grid
    of ``_create_depthslice`` through ``api.interpolate_to_points``
    (geocentric lat/lon/depth), zero where no element holds a point."""
    from ..api import interpolate_to_points

    points = _create_depthslice(
        depth_in_m=depth_in_km * 1000.0,
        num=num,
        lat_extent=lat_extent,
        lon_extent=lon_extent,
    )
    vals = interpolate_to_points(
        mesh=mesh,
        points=points,
        params_to_interp=[parameter_to_plot],
        make_spherical=False,
        geocentric=True,
        device=device,
    )
    return vals.cpu().numpy().reshape(num, num)  # host once


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
    """Plot a lat/lon slice at fixed depth (reference plotter.py:16-156)."""
    plt = _pyplot()
    cmap = get_colormap(cmap, reverse)
    vals = _depth_slice_values(mesh, depth_in_km, num, lat_extent,
                               lon_extent, parameter_to_plot, device)

    vmin = vmax = None
    if plot_diff_percentage:
        lat_mean = np.mean(vals)
        vals = (vals - lat_mean) / lat_mean * 100.0
        vmax = np.max(np.abs(vals))
        vmin = -vmax
        if vmax < 0.1:  # 1D models: show zeros instead of noise
            vals = np.zeros_like(vals)
    else:
        zero_center = False
    if not zero_center:
        vmin = vmax = None
    if limits is not None:
        vmin, vmax = limits

    Y, X = np.meshgrid(
        np.linspace(lat_extent[0], lat_extent[1], num=num),
        np.linspace(lon_extent[0], lon_extent[1], num=num),
    )

    fig = plt.figure(figsize=figsize)
    if not _have_cartopy():
        proj = None
    elif projection is not None and not isinstance(projection, str):
        # a ready cartopy CRS object passes through untouched
        proj = projection
    else:
        proj = create_projection(
            name=projection if isinstance(projection, str) else "default",
            lat_extent=lat_extent,
            lon_extent=lon_extent,
        )
    if proj is not None:  # pragma: no cover - cartopy branch
        import cartopy.crs as ccrs
        import cartopy.feature as cfeature

        ax = fig.add_subplot(1, 1, 1, projection=proj)
        if stock_img:
            ax.stock_img()
        img = ax.pcolormesh(
            X, Y, vals, transform=ccrs.PlateCarree(), cmap=cmap,
            vmin=vmin, vmax=vmax,
        )
        if coastlines:
            ax.coastlines()
        if borders:
            ax.add_feature(cfeature.BORDERS)
    else:
        ax = fig.add_subplot(1, 1, 1)
        img = ax.pcolormesh(X, Y, vals, cmap=cmap, vmin=vmin, vmax=vmax,
                            shading="auto")
        ax.set_xlabel("Longitude [deg]")
        ax.set_ylabel("Latitude [deg]")

    if title is None:
        what = "deviations " if plot_diff_percentage else ""
        ax.set_title(
            f"{parameter_to_plot} {what}at {depth_in_km} km depth"
        )
    else:
        ax.set_title(title, fontsize=20)
    fig.colorbar(img, ax=ax)
    fig.tight_layout()
    if savefig:
        fig.savefig(figname)
        plt.close(fig)
    else:
        plt.show()
    return fig


def _cross_section_points(point_1_lat, point_1_lng, point_2_lat,
                          point_2_lng, max_depth_in_km, min_depth_in_km,
                          nrads, npoints):
    """The cross section's sampling: (points [nrads * npoints, 3]
    cartesian meters, radius-major, and the radii [nrads]) on the
    geodesic from point 1 toward point 2 (reference plotter.py:269-298)."""
    rads = np.linspace(
        R_EARTH_M - max_depth_in_km * 1000,
        R_EARTH_M - min_depth_in_km * 1000,
        nrads,
    )
    gc = greatcircle_points(
        point_1_lat, point_1_lng, point_2_lat, point_2_lng, npts=npoints
    )
    lats, lons = gc.T
    lats = np.asarray(
        [elliptic_to_geocentric_latitude(la) for la in lats]
    )
    colats = lat2colat(lats)
    all_colats, _ = np.meshgrid(colats, rads)
    all_lons, all_rads = np.meshgrid(lons, rads)
    x, y, z = sph2cart(
        np.deg2rad(all_colats.ravel()),
        np.deg2rad(all_lons.ravel()),
        all_rads.ravel(),
    )
    return np.stack([x, y, z], axis=-1), rads


def _cross_section_values(mesh, points, nrads, npoints, param_to_interp,
                          device=None):
    """The cross section's [nrads, npoints] values on the host, through
    ``api.interpolate_to_points`` on the sphere-mapped mesh (zero where no
    element holds a point)."""
    from ..api import interpolate_to_points

    vals = interpolate_to_points(
        mesh,
        points=points,
        make_spherical=True,
        params_to_interp=[param_to_interp],
        device=device,
    )
    return vals.cpu().numpy().reshape(nrads, npoints)  # host once


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
    discontinuities_to_plot=(410, 660, 1000),
    device=None,
):
    """Great-circle cross section with per-radius percent deviation
    (reference plotter.py:309-503)."""
    plt = _pyplot()
    cmap = get_colormap(cmap, reverse)
    points, rads = _cross_section_points(
        point_1_lat, point_1_lng, point_2_lat, point_2_lng,
        max_depth_in_km, min_depth_in_km, nrads, npoints)
    data = _cross_section_values(mesh, points, nrads, npoints,
                                 param_to_interp, device)

    # percent deviation from the per-radius mean
    mean_r = data.mean(axis=1, keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        data = np.nan_to_num((data - mean_r) / mean_r * 100.0)

    degrees = locations2degrees(
        point_1_lat, point_1_lng, point_2_lat, point_2_lng
    )
    all_degrees = np.linspace(-degrees / 2, degrees / 2, npoints)
    yv = np.sin(np.deg2rad(90 - all_degrees))
    xv = np.cos(np.deg2rad(90 - all_degrees))
    all_x = xv[:, None] * rads[None, :] / 1000.0
    all_y = yv[:, None] * rads[None, :] / 1000.0

    fig = plt.figure(dpi=300)
    # gouraud: coordinates ARE the sample points (a curvilinear polar
    # fan is not monotonic in x/y, which the cell-edge inference of
    # shading="auto" warns about)
    plt.pcolormesh(all_x, all_y, data.T, cmap=cmap, shading="gouraud")
    for xm, ym, face in (
        (all_x[5, -5], all_y[5, -5], "k"),
        (all_x[-5, -5], all_y[-5, -5], "w"),
    ):
        plt.plot(
            xm, ym, "o", markersize=10, markerfacecolor=face,
            markeredgecolor="r", markeredgewidth=1,
        )
    plt.colorbar()
    plt.clim(clim[0], clim[1])
    for disc in discontinuities_to_plot:
        scalef = (6371 - disc - min_depth_in_km) / (6371 - min_depth_in_km)
        plt.plot(
            all_x[:, -1] * scalef, all_y[:, -1] * scalef,
            "--", color="black", linewidth=0.5,
        )
    plt.axis("off")
    plt.tight_layout()
    fig.savefig(filename)
    plt.close(fig)
    return fig
