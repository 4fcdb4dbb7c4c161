"""Mesh file I/O (host side).  Imports ``h5py``: the package root does
not import this subpackage, so only the file entry points need it."""
from .salvus import (  # noqa: F401
    SalvusMesh,
    format_dim_label,
    load_hdf5_params,
    parse_dim_label,
    recreate_dataset,
    write_salvus_mesh,
)
