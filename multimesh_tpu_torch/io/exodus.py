"""Exodus II mesh I/O built directly on NetCDF-3 (host side).

A copy of the JAX package's ``io/exodus.py`` (numpy and scipy only, on
this package's ``core.gll``): a file written by either package reads
identically through the other.  The reference wraps the external ``pyexodus`` package
(reference multi_mesh/io/exodus.py); that dependency is absent here, so
this is a from-scratch minimal Exodus II implementation over
``scipy.io.netcdf_file`` (Exodus II files are NetCDF classic / 64-bit
offset).  It covers what the mesh-transfer pipeline needs: one hex/quad
element block, nodal + elemental variables, read and in-place write.

Conventions handled exactly like the reference's wrapper:

* ``connect1`` is 1-based on file, exposed 0-based in Python
  (reference io/exodus.py:41-43),
* Exodus hex-8 corner ordering differs from this framework's canonical
  tensor-lattice corner ordering; ``HEX8_TO_CANONICAL`` is the
  permutation (the reference instead permutes into its C kernel's private
  node order with [0, 3, 2, 1, 4, 5, 6, 7], reference cli.py:79-81 -- we
  derive ours programmatically from the ref-coordinate tables).
"""
from __future__ import annotations

import pathlib
import re
from typing import List, Union

import numpy as np
from scipy.io import netcdf_file

from ..core import gll

PathLike = Union[str, pathlib.Path]


def _hex_to_canonical_permutation() -> np.ndarray:
    """Permutation p with canonical_corners = exodus_corners[p].

    Exodus hex-8 local nodes sit at reference coords (counter-clockwise
    bottom face then top face); canonical ordering is the order-1 tensor
    lattice.  Computed by matching coordinates, not hand-written.
    """
    exodus_ref = np.array(
        [
            [-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
            [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1],
        ],
        dtype=np.float64,
    )
    canonical = gll.lattice_coords(1, 3)
    perm = []
    for c in canonical:
        matches = np.where((exodus_ref == c).all(axis=1))[0]
        perm.append(int(matches[0]))
    return np.asarray(perm, dtype=np.int64)


HEX8_TO_CANONICAL = _hex_to_canonical_permutation()


def _quad_to_canonical_permutation() -> np.ndarray:
    exodus_ref = np.array(
        [[-1, -1], [1, -1], [1, 1], [-1, 1]], dtype=np.float64
    )
    canonical = gll.lattice_coords(1, 2)
    return np.asarray(
        [int(np.where((exodus_ref == c).all(axis=1))[0][0]) for c in canonical],
        dtype=np.int64,
    )


QUAD4_TO_CANONICAL = _quad_to_canonical_permutation()


def _chars_to_strings(arr) -> List[str]:
    return [
        row.tobytes().split(b"\x00")[0].decode().strip()
        for row in np.asarray(arr)
    ]


def _strings_to_chars(names: List[str], width: int) -> np.ndarray:
    out = np.zeros((len(names), width), dtype="S1")
    for i, name in enumerate(names):
        b = name.encode()[:width]
        out[i, : len(b)] = [bytes([c]) for c in b]
    return out


class Exodus:
    """Minimal Exodus II file wrapper (single element block).

    Mirrors the reference wrapper's API surface: ``connectivity`` (0-based),
    ``points``, ``nelem``, ``nodes_per_element``, ``npoint``,
    ``elem_var_names``, ``nodal_parameters``, ``get_nodal_field``,
    ``get_element_field``, ``attach_field``, ``get_element_centroid``
    (reference io/exodus.py:9-143).
    """

    def __init__(self, filename: PathLike, mode: str = "r"):
        if mode not in ("r", "a"):
            raise ValueError("mode must be 'r' or 'a'")
        self._filename = str(filename)
        self.mode = mode
        with netcdf_file(self._filename, "r", mmap=False) as f:
            self.ndim = int(f.dimensions["num_dim"])
            conn = np.asarray(f.variables["connect1"][:], dtype=np.int64)
            self.connectivity = conn - 1  # file is 1-based
            self.nelem, self.nodes_per_element = self.connectivity.shape
            coords = []
            for ax in "xyz"[: self.ndim]:
                coords.append(np.asarray(f.variables[f"coord{ax}"][:],
                                         dtype=np.float64))
            self.points = np.stack(coords, axis=-1)
            self.nodal_parameters = (
                _chars_to_strings(f.variables["name_nod_var"][:])
                if "name_nod_var" in f.variables
                else []
            )
            self.elem_var_names = (
                _chars_to_strings(f.variables["name_elem_var"][:])
                if "name_elem_var" in f.variables
                else []
            )

    @property
    def npoint(self) -> int:
        return self.points.shape[0]

    def get_nodal_field(self, name: str) -> np.ndarray:
        if name not in self.nodal_parameters:
            raise KeyError(
                f"nodal variable {name!r} not in {self.nodal_parameters}"
            )
        idx = self.nodal_parameters.index(name) + 1
        with netcdf_file(self._filename, "r", mmap=False) as f:
            return np.asarray(
                f.variables[f"vals_nod_var{idx}"][0, :], dtype=np.float64
            )

    def get_element_field(self, name: str) -> np.ndarray:
        if name not in self.elem_var_names:
            raise KeyError(
                f"element variable {name!r} not in {self.elem_var_names}"
            )
        idx = self.elem_var_names.index(name) + 1
        with netcdf_file(self._filename, "r", mmap=False) as f:
            return np.asarray(
                f.variables[f"vals_elem_var{idx}eb1"][0, :], dtype=np.float64
            )

    def attach_field(self, name: str, values: np.ndarray):
        """Write a nodal (npoint) or elemental (nelem) variable.

        A variable not yet declared in the file is added on the fly (the
        reference's pyexodus wrapper creates variables on put, see
        reference interpolator.py:283-285 attaching brand-new gradient
        fields); NetCDF-3 fixes the variable table in the header, so
        declaring one means rewriting the file once.
        """
        if self.mode != "a":
            raise PermissionError("attach_field requires mode='a'")
        values = np.asarray(values, dtype=np.float64)
        # elemental checked FIRST: the reference wrapper dispatches
        # nelem before npoint (reference io/exodus.py:66-97), which
        # decides the ambiguous npoint == nelem case
        if values.size == self.nelem:
            if name not in self.elem_var_names:
                self._declare_variable(name, nodal=False)
            idx = self.elem_var_names.index(name) + 1
            var = f"vals_elem_var{idx}eb1"
        elif values.size == self.npoint:
            if name not in self.nodal_parameters:
                self._declare_variable(name, nodal=True)
            idx = self.nodal_parameters.index(name) + 1
            var = f"vals_nod_var{idx}"
        else:
            raise ValueError(
                "value count matches neither nodes nor elements"
            )
        with netcdf_file(self._filename, "a", mmap=False) as f:
            f.variables[var][0, :] = values
            f.flush()

    # NetCDF variables this minimal single-block model round-trips; a
    # file containing anything else (side sets, node sets, extra blocks,
    # element maps...) cannot be safely rewritten by _declare_variable.
    _MODELED_VARS = re.compile(
        r"^(coord[xyz]|connect1|eb_prop1|time_whole|eb_status"
        r"|name_nod_var|vals_nod_var\d+"
        r"|name_elem_var|vals_elem_var\d+eb1"
        r"|coor_names|coord_names|eb_names)$"
    )

    def _declare_variable(self, name: str, nodal: bool):
        """Add a new (zero-filled) variable by rewriting the file."""
        with netcdf_file(self._filename, "r", mmap=False) as f:
            extra = [
                v for v in f.variables if not self._MODELED_VARS.match(v)
            ]
            n_steps = f.variables["time_whole"].shape[0] \
                if "time_whole" in f.variables else 1
        if extra or (n_steps or 0) > 1:
            what = sorted(extra)[:6] if extra else (
                f"{n_steps} timesteps (this writer keeps only step 0)"
            )
            raise KeyError(
                f"variable {name!r} is not declared in the file, and the "
                f"file contains structures this writer does not model "
                f"({what}); declaring a new variable "
                "would rewrite the file and drop them. Add the variable "
                "with the tool that produced the mesh instead."
            )
        nodal_fields = {
            p: self.get_nodal_field(p) for p in self.nodal_parameters
        }
        elemental_fields = {
            p: self.get_element_field(p) for p in self.elem_var_names
        }
        if nodal:
            nodal_fields[name] = np.zeros(self.npoint)
        else:
            elemental_fields[name] = np.zeros(self.nelem)
        write_exodus(
            self._filename,
            self.points,
            self.connectivity,
            nodal_fields=nodal_fields,
            elemental_fields=elemental_fields,
            canonical_order=False,
        )
        if nodal:
            self.nodal_parameters = list(nodal_fields)
        else:
            self.elem_var_names = list(elemental_fields)

    def get_element_centroid(self) -> np.ndarray:
        """Element centroids (mean of corner nodes).

        The reference calls a C OpenMP kernel for this
        (reference src/centroid.c:3-25 via io/exodus.py:55-64); here it is
        one vectorized numpy gather-mean.
        """
        return self.points[self.connectivity].mean(axis=1)

    def canonical_connectivity(self) -> np.ndarray:
        """Connectivity re-ordered to canonical lattice corner order."""
        perm = (
            HEX8_TO_CANONICAL if self.ndim == 3 else QUAD4_TO_CANONICAL
        )
        return self.connectivity[:, perm]

    def canonical_corner_nodes(self) -> np.ndarray:
        """Element corner coords in canonical lattice order:
        [nelem, 2^dim, dim] -- the order-1 lattice ``locate`` takes."""
        return self.points[self.canonical_connectivity()]


def write_exodus(
    filename: PathLike,
    points: np.ndarray,
    connectivity: np.ndarray,
    nodal_fields: dict | None = None,
    elemental_fields: dict | None = None,
    canonical_order: bool = True,
):
    """Create a minimal single-block Exodus II file.

    points [npoint, dim]; connectivity [nelem, 2^dim] 0-based.  When
    ``canonical_order`` the input connectivity uses this framework's
    canonical corner ordering and is converted to Exodus ordering on write.
    """
    points = np.asarray(points, dtype=np.float64)
    connectivity = np.asarray(connectivity, dtype=np.int64)
    npoint, ndim = points.shape
    nelem, npe = connectivity.shape
    if canonical_order:
        perm = HEX8_TO_CANONICAL if ndim == 3 else QUAD4_TO_CANONICAL
        inv = np.argsort(perm)
        connectivity = connectivity[:, inv]

    nodal_fields = nodal_fields or {}
    elemental_fields = elemental_fields or {}

    with netcdf_file(str(filename), "w", version=2) as f:
        f.title = b"multimesh_tpu"
        # scipy's netcdf writer requires the unlimited dimension first
        f.createDimension("time_step", None)
        f.createDimension("len_string", 33)
        f.createDimension("len_line", 81)
        f.createDimension("four", 4)
        f.createDimension("num_dim", ndim)
        f.createDimension("num_nodes", npoint)
        f.createDimension("num_elem", nelem)
        f.createDimension("num_el_blk", 1)
        f.createDimension("num_el_in_blk1", nelem)
        f.createDimension("num_nod_per_el1", npe)

        for i, ax in enumerate("xyz"[:ndim]):
            v = f.createVariable(f"coord{ax}", "d", ("num_nodes",))
            v[:] = points[:, i]
        conn = f.createVariable(
            "connect1", "i", ("num_el_in_blk1", "num_nod_per_el1")
        )
        conn[:] = (connectivity + 1).astype(np.int32)
        conn.elem_type = b"HEX8" if ndim == 3 else b"QUAD4"
        eb = f.createVariable("eb_prop1", "i", ("num_el_blk",))
        eb[:] = np.array([1], np.int32)
        eb.name = b"ID"
        ebs = f.createVariable("eb_status", "i", ("num_el_blk",))
        ebs[:] = np.array([1], np.int32)
        cn = f.createVariable(
            "coor_names", "c", ("num_dim", "len_string")
        )
        cn[:] = _strings_to_chars(list("xyz"[:ndim]), 33)
        ebn = f.createVariable(
            "eb_names", "c", ("num_el_blk", "len_string")
        )
        ebn[:] = _strings_to_chars([""], 33)
        t = f.createVariable("time_whole", "d", ("time_step",))
        t[0] = 0.0

        if nodal_fields:
            f.createDimension("num_nod_var", len(nodal_fields))
            nv = f.createVariable(
                "name_nod_var", "c", ("num_nod_var", "len_string")
            )
            nv[:] = _strings_to_chars(list(nodal_fields), 33)
            for i, (name, vals) in enumerate(nodal_fields.items(), start=1):
                v = f.createVariable(
                    f"vals_nod_var{i}", "d", ("time_step", "num_nodes")
                )
                v[0, :] = np.asarray(vals, dtype=np.float64)
        if elemental_fields:
            f.createDimension("num_elem_var", len(elemental_fields))
            ev = f.createVariable(
                "name_elem_var", "c", ("num_elem_var", "len_string")
            )
            ev[:] = _strings_to_chars(list(elemental_fields), 33)
            for i, (name, vals) in enumerate(
                elemental_fields.items(), start=1
            ):
                v = f.createVariable(
                    f"vals_elem_var{i}eb1", "d", ("time_step", "num_el_in_blk1")
                )
                v[0, :] = np.asarray(vals, dtype=np.float64)
        f.flush()
