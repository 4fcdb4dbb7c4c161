"""Depth slices, cross sections and colormaps (host side).

Counterpart of the JAX package's ``viz``.  Importing it needs no
matplotlib: the drawing functions import it when they draw, and the
colormaps are built on first use.
"""
from .colormaps import get_colormap  # noqa: F401
from .plotter import (  # noqa: F401
    plot_depth_slice,
    plot_cross_section,
    create_projection,
    elliptic_to_geocentric_latitude,
    locations2degrees,
)


def __getattr__(name):
    if name in ("roma", "roma_r"):
        from . import colormaps

        return getattr(colormaps, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
