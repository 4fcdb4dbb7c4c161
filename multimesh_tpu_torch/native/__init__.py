from .bindings import (  # noqa: F401
    available,
    load,
    centroids,
    gll_basis,
    inverse_map,
    locate,
)
