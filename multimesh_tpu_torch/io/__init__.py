"""Mesh file I/O (host side): ``salvus`` (HDF5, imports ``h5py``) and
``exodus`` (NetCDF-3 through ``scipy``).  Import the submodule you need:
neither the package root nor this subpackage imports them, so only the
HDF5 entry points need ``h5py``."""
