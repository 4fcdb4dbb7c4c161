"""Public API facade.

Same function names, signatures, and defaults as the JAX package's facade
(and the reference's, reference multi_mesh/api.py), plus ``device``,
including the wall-clock timing print after each call (reference
api.py:50-57 pattern) and lazy imports of the engine, so ``h5py`` only
loads when a file entry point is called.  So far: ``gll_2_gll``.
"""
from __future__ import annotations

import functools
import pathlib
import time
from typing import Union

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
