"""Sphere / ellipse geometry mapping for elliptic meshes.

Counterpart of the JAX package's ``ops/spherical.py``; re-implements the
reference's radial rescaling utilities
(reference multi_mesh/components/interpolator.py:1085-1144):

* ``map_to_sphere``: rescale every node radially so its radius equals
  r_earth * z_node_1D (the 1D reference radius fraction stored on the
  mesh) -- turns an elliptic/topographic mesh into a perfect sphere so
  two such meshes can be compared point-to-point,
* ``map_to_ellipse``: transfer a base mesh's ellipticity (radius ratio
  field) onto another mesh by interpolating r/r_1D.

Both rescale ``mesh.points`` IN PLACE.  ``search.locate`` caches its
per-mesh geometry by content, and by identity only for read-only
arrays, so a mesh whose points are rescaled (or restored) here is
prepared anew by the next transfer; do not freeze an array that these
functions will write to.
"""
from __future__ import annotations

import numpy as np

from ..config import DEFAULT_LOCATE, PREFILTER_M, R_EARTH_M, LocateConfig


def _nodal_radius_fraction(mesh) -> np.ndarray:
    """z_node_1D as [nelem, n_gll], from either our SalvusMesh or a
    connectivity-based (UnstructuredMesh-like) object."""
    fields = mesh.get_element_nodal_fields() if hasattr(
        mesh, "get_element_nodal_fields"
    ) else mesh.element_nodal_fields
    return np.asarray(fields["z_node_1D"])


def map_to_sphere(mesh) -> None:
    """Rescale mesh.points in place so every node sits at
    r_earth * z_node_1D.  Nodes at the exact center are left alone
    (r == 0 guard, as in the reference interpolator.py:1142-1144).

    Handles both mesh layouts the reference does
    (interpolator.py:1125-1137): element-nodal points
    [nelem, n_gll, dim], or a flat vertex list [npoints, dim] plus
    ``connectivity`` (UnstructuredMesh-like), where the element-nodal
    z_node_1D field is folded to one value per vertex via the first
    occurrence of each node id in the connectivity."""
    rad_frac = np.asarray(_nodal_radius_fraction(mesh))
    pts = mesh.points
    if pts.ndim == 2 and rad_frac.shape != pts.shape[:-1]:
        conn = getattr(mesh, "connectivity", None)
        if conn is None:
            raise ValueError(
                "flat-point mesh needs a connectivity to fold the "
                "element-nodal z_node_1D field onto vertices"
            )
        _, first = np.unique(np.asarray(conn).ravel(), return_index=True)
        rad_frac = rad_frac.reshape(-1)[first]
    r = np.linalg.norm(pts, axis=-1)
    scale = np.ones_like(r)
    nz = r > 0
    scale[nz] = R_EARTH_M * rad_frac[nz] / r[nz]
    pts *= scale[..., None]


def map_to_ellipse(base_mesh, mesh, cfg: LocateConfig = DEFAULT_LOCATE,
                   device=None):
    """Stretch ``mesh`` to carry ``base_mesh``'s ellipticity.

    Computes the per-node radius ratio r / (r_earth * z_node_1D) of the
    base mesh, maps both meshes to spheres, interpolates the ratio onto
    the target nodes on ``device`` (None means ``cuda``), and multiplies
    the target points by it.  The base mesh's original geometry is
    restored afterwards (reference interpolator.py:1085-1122).
    """
    from .transfer import TransferOperator

    base_pts_orig = base_mesh.points.copy()
    tgt_pts_orig = mesh.points.copy()
    try:
        base_r = np.linalg.norm(base_mesh.points, axis=-1)
        rad_frac = _nodal_radius_fraction(base_mesh)
        with np.errstate(invalid="ignore", divide="ignore"):
            ratio = np.where(
                rad_frac > 0, base_r / (R_EARTH_M * rad_frac), 1.0
            )

        map_to_sphere(base_mesh)
        map_to_sphere(mesh)

        tgt = mesh.points.reshape(-1, mesh.points.shape[-1])
        op = TransferOperator.build(
            base_mesh.points, tgt, order=base_mesh.shape_order, cfg=cfg,
            fallback="snap", prefilter_m=PREFILTER_M,
            device=device,
        )
        point_ratio = op.apply(ratio).cpu().numpy().reshape(
            mesh.points.shape[:2])
        mesh.points *= point_ratio[..., None]
    except BaseException:
        # never leave the caller's mesh silently sphere-mapped when the
        # transfer itself fails
        mesh.points[...] = tgt_pts_orig
        raise
    finally:
        base_mesh.points[...] = base_pts_orig
