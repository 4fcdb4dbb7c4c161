"""Scientific colormaps for seismic model plotting.

A copy of the JAX package's ``viz/colormaps.py``, with matplotlib
imported when a colormap is first built, so that the module imports
without it.

The reference vendors Crameri's *roma* colormap as a 256-row RGB table
(reference multi_mesh/data/roma.py) and prefers cmasher / cmcrameri maps
when plotting (reference multi_mesh/components/plotter.py:190-209).  Those
packages are not available here and the table is not copied; instead a
perceptually-ordered roma-style diverging map (dark red -> ochre -> pale
yellow -> teal -> deep blue) is synthesized from a small set of anchor
colors with smooth interpolation in sRGB.  Seismologists use it so that
"slow = red, fast = blue" keeps working.
"""
from __future__ import annotations

import functools

# Anchor colors chosen to follow roma's hue/lightness trajectory.
_ROMA_ANCHORS = [
    (0.451, 0.224, 0.341),   # dark wine red
    (0.557, 0.318, 0.271),   # brick
    (0.671, 0.467, 0.235),   # ochre
    (0.788, 0.647, 0.282),   # sand
    (0.882, 0.843, 0.494),   # pale yellow
    (0.753, 0.906, 0.718),   # pale green
    (0.482, 0.806, 0.769),   # light teal
    (0.302, 0.639, 0.722),   # teal blue
    (0.196, 0.443, 0.616),   # medium blue
    (0.102, 0.255, 0.459),   # deep blue
]
_LOCAL = {"roma": _ROMA_ANCHORS, "roma_r": _ROMA_ANCHORS[::-1]}


@functools.lru_cache(maxsize=None)
def _local(name: str):
    """The synthesized colormap ``name`` ("roma" or "roma_r"), built once."""
    from matplotlib.colors import LinearSegmentedColormap

    return LinearSegmentedColormap.from_list(name, _LOCAL[name], N=256)


def __getattr__(name):
    # ``roma`` and ``roma_r`` as module attributes, built on first access
    if name in _LOCAL:
        return _local(name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def get_colormap(cmap, reverse: bool = False):
    """Resolve a colormap name like the reference does: cmasher first,
    then cmcrameri, then matplotlib, plus the locally synthesized maps
    (reference plotter.py:190-209).  A ready Colormap object passes
    through (reversed when asked)."""
    if not isinstance(cmap, str):
        if reverse and hasattr(cmap, "reversed"):
            return cmap.reversed()
        return cmap
    if reverse:
        # requesting the reverse of an already-reversed name ("roma_r")
        # strips the suffix instead of stacking "_r_r"
        name = cmap[:-2] if cmap.endswith("_r") else cmap + "_r"
    else:
        name = cmap
    try:  # pragma: no cover - not in CI image
        import cmasher as cmr

        if hasattr(cmr, name):
            return getattr(cmr, name)
    except ImportError:
        pass
    try:  # pragma: no cover - not in CI image
        import cmcrameri

        if hasattr(cmcrameri.cm, name):
            return getattr(cmcrameri.cm, name)
    except ImportError:
        pass
    if name in _LOCAL:
        return _local(name)
    import matplotlib.pyplot as plt

    try:
        return plt.get_cmap(name)
    except ValueError:
        # graceful default: reference users often pass cmasher names like
        # "chroma"/"fusion" which matplotlib lacks
        return _local("roma_r" if reverse else "roma")
