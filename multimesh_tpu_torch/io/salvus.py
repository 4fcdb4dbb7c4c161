"""Salvus-format HDF5 mesh I/O (host side).

A copy of the JAX package's ``io/salvus.py`` (numpy and h5py only): a file
written by either package reads identically through the other.
From-scratch reader/writer for the HDF5 layout the reference consumes
and produces (reference multi_mesh/components/salvus_mesh_reader.py and
multi_mesh/utils.py:137-168):

* ``MODEL/coordinates``  float64 [nelem, n_gll, dim]
* ``MODEL/data``         float64 [nelem, n_params, n_gll], with an HDF5
  dimension-scale label on axis 1 of the form ``"[ VP | VS | RHO ]"``
* ``MODEL/element_data`` float64 [nelem, n_elem_params], same label style
  (carries the ``fluid`` flag and ``layer`` ids)
* byte-string attributes on the ``MODEL`` group ("global strings",
  e.g. ``moho_idx``)

The reader mirrors the attribute surface of the reference's ``SalvusMesh``
class so downstream code (layered transfers, sphere mapping) is drop-in;
the writer can also create meshes from scratch, which the reference cannot
(it only updates existing fields, salvus_mesh_reader.py:171-178).
"""
from __future__ import annotations

import pathlib
from typing import Dict, List, Union

import h5py
import numpy as np

PathLike = Union[str, pathlib.Path]

_COORDS = "MODEL/coordinates"
_DATA = "MODEL/data"
_EDATA = "MODEL/element_data"


def format_dim_label(parameters: List[str]) -> str:
    """The ``[ A | B | C ]`` label format (reference utils.py:165)."""
    return "[ " + " | ".join(parameters) + " ]"


def parse_dim_label(label) -> List[str]:
    """Parse a dimension label into parameter names.

    Accepts bytes or str; mirrors the reference's parsing
    (salvus_mesh_reader.py:67-72: strip brackets/spaces, split on '|').
    """
    if isinstance(label, bytes):
        label = label.decode()
    return label.replace(" ", "")[1:-1].split("|")


def read_dim_labels(dataset, axis: int = 1) -> List[str]:
    labels = dataset.attrs.get("DIMENSION_LABELS")
    if labels is None:
        raise KeyError(
            f"dataset {dataset.name!r} has no DIMENSION_LABELS attribute; "
            "parameter names cannot be inferred (not a Salvus-format mesh?)"
        )
    return parse_dim_label(labels[axis])


def write_dim_labels(f: h5py.File, path: str, parameters: List[str]):
    """Attach element/<params>/point dimension labels to a dataset."""
    ds = f[path]
    ds.dims[0].label = "element"
    ds.dims[1].label = format_dim_label(parameters)
    if ds.ndim > 2:
        ds.dims[2].label = "point"


class SalvusMesh:
    """Fast h5py-backed Salvus mesh reader/writer.

    API-compatible with the reference's reader (same attribute names:
    ``points``, ``nelem``, ``n_gll_points``, ``dimensions``,
    ``shape_order``, ``global_strings``, ``elemental_fields``,
    ``element_nodal_fields``, ``attach_field``, ...;
    reference salvus_mesh_reader.py:7-178).
    """

    def __init__(self, filename: PathLike, fast_mode: bool = True):
        self.filename = str(filename)
        with h5py.File(self.filename, "r") as f:
            self.points = np.asarray(f[_COORDS][()], dtype=np.float64)
            self.nelem = self.points.shape[0]
            self.n_gll_points = self.points.shape[1]
            self.dimensions = self.points.shape[2]
            self.shape_order = int(
                round(self.n_gll_points ** (1.0 / self.dimensions)) - 1
            )
            self.global_strings = {
                k: v
                for k, v in f["MODEL"].attrs.items()
                if isinstance(v, (bytes, np.bytes_))
            }
            self.nodal_parameter_indices = read_dim_labels(f[_DATA])
            if _EDATA in f:
                self.elemental_parameter_indices = read_dim_labels(f[_EDATA])
            else:
                self.elemental_parameter_indices = []
            self.elemental_fields: Dict[str, np.ndarray] = {}
            self.element_nodal_fields: Dict[str, np.ndarray] = {}
            if not fast_mode:
                self._load_fields(f)

    def _load_fields(self, f: h5py.File):
        data = f[_DATA][()]
        for i, p in enumerate(self.nodal_parameter_indices):
            self.element_nodal_fields[p] = data[:, i, :]
        if self.elemental_parameter_indices:
            edata = f[_EDATA][()]
            for i, p in enumerate(self.elemental_parameter_indices):
                self.elemental_fields[p] = edata[:, i]

    # -- reference-compatible accessors ----------------------------------
    def get_element_centroids(self) -> np.ndarray:
        return self.points.mean(axis=1)

    # alias used by salvus UnstructuredMesh-style callers
    get_element_centroid = get_element_centroids

    def get_element_nodes(self) -> np.ndarray:
        return self.points

    def get_elemental_fields(self) -> Dict[str, np.ndarray]:
        if not self.elemental_fields and self.elemental_parameter_indices:
            with h5py.File(self.filename, "r") as f:
                edata = f[_EDATA][()]
            for i, p in enumerate(self.elemental_parameter_indices):
                self.elemental_fields[p] = edata[:, i]
        return self.elemental_fields

    def get_element_nodal_fields(self) -> Dict[str, np.ndarray]:
        if not self.element_nodal_fields:
            with h5py.File(self.filename, "r") as f:
                self._load_fields(f)
        return self.element_nodal_fields

    def get_element_nodal_field(self, param: str) -> np.ndarray:
        idx = self.nodal_parameter_indices.index(param)
        with h5py.File(self.filename, "r") as f:
            return f[_DATA][:, idx, :]

    def get_elemental_field(self, param: str) -> np.ndarray:
        idx = self.elemental_parameter_indices.index(param)
        with h5py.File(self.filename, "r") as f:
            return f[_EDATA][:, idx]

    def set_global_string(self, name: str, value: str):
        with h5py.File(self.filename, "r+") as f:
            f["MODEL"].attrs[name] = np.bytes_(value.encode())
            self.global_strings = {
                k: v
                for k, v in f["MODEL"].attrs.items()
                if isinstance(v, (bytes, np.bytes_))
            }

    def attach_field(self, name: str, data: np.ndarray):
        """Write a nodal [nelem, n_gll] or elemental [nelem] field back to
        the file (existing parameters only, like the reference,
        salvus_mesh_reader.py:136-178)."""
        data = np.asarray(data)
        with h5py.File(self.filename, "r+") as f:
            if data.shape == (self.nelem, self.n_gll_points):
                if name not in self.nodal_parameter_indices:
                    raise ValueError(
                        f"nodal parameter {name!r} not present in mesh; "
                        f"have {self.nodal_parameter_indices}"
                    )
                idx = self.nodal_parameter_indices.index(name)
                f[_DATA][:, idx, :] = data
                if name in self.element_nodal_fields:
                    self.element_nodal_fields[name] = data
            elif data.shape == (self.nelem,):
                if name not in self.elemental_parameter_indices:
                    raise ValueError(
                        f"elemental parameter {name!r} not present in mesh"
                    )
                idx = self.elemental_parameter_indices.index(name)
                f[_EDATA][:, idx] = data
                if name in self.elemental_fields:
                    self.elemental_fields[name] = data
            else:
                raise ValueError(
                    f"field shape {data.shape} matches neither nodal "
                    f"({self.nelem}, {self.n_gll_points}) nor elemental "
                    f"({self.nelem},)"
                )


def write_salvus_mesh(
    filename: PathLike,
    points: np.ndarray,
    nodal_fields: Dict[str, np.ndarray],
    elemental_fields: Dict[str, np.ndarray] | None = None,
    global_strings: Dict[str, str] | None = None,
):
    """Create a Salvus-format HDF5 mesh from scratch.

    points [nelem, n_gll, dim]; nodal_fields name -> [nelem, n_gll];
    elemental_fields name -> [nelem].
    """
    points = np.asarray(points, dtype=np.float64)
    nelem, n_gll, _ = points.shape
    params = list(nodal_fields)
    data = np.stack([np.asarray(nodal_fields[p], np.float64) for p in params],
                    axis=1)
    with h5py.File(str(filename), "w") as f:
        f.create_dataset(_COORDS, data=points)
        f.create_dataset(_DATA, data=data)
        write_dim_labels(f, _DATA, params)
        if elemental_fields:
            eparams = list(elemental_fields)
            edata = np.stack(
                [np.asarray(elemental_fields[p], np.float64) for p in eparams],
                axis=1,
            )
            f.create_dataset(_EDATA, data=edata)
            write_dim_labels(f, _EDATA, eparams)
        for k, v in (global_strings or {}).items():
            f["MODEL"].attrs[k] = np.bytes_(v.encode())


def load_hdf5_params(
    gll_file: PathLike,
    model_path: str = _DATA,
    coordinates_path: str = _COORDS,
):
    """(points, data, params) straight from an HDF5 mesh, with the
    reference's label munging incl. the 'grad' strip
    (reference utils.py:206-217)."""
    with h5py.File(str(gll_file), "r") as f:
        points = np.asarray(f[coordinates_path][()], dtype=np.float64)
        data = f[model_path][()]
        labels = f[model_path].attrs.get("DIMENSION_LABELS")
        if labels is None:
            raise KeyError(
                f"dataset {model_path!r} has no DIMENSION_LABELS "
                "attribute; parameter names cannot be inferred (not a "
                "Salvus-format mesh?)"
            )
        label = labels[1]
        if isinstance(label, bytes):
            label = label.decode()
        params = label.replace(" ", "").replace("grad", "")[1:-1].split("|")
    return points, data, params


def recreate_dataset(
    f: h5py.File,
    parameters: List[str],
    model_path: str = _DATA,
    coordinates_path: str = _COORDS,
):
    """Drop and re-create MODEL/data for a new parameter set
    (reference utils.py:137-156)."""
    shape = (
        f[coordinates_path].shape[0],
        len(parameters),
        f[coordinates_path].shape[1],
    )
    if model_path in f:
        del f[model_path]
    f.create_dataset(model_path, shape=shape, dtype=np.float64)
    write_dim_labels(f, model_path, parameters)
