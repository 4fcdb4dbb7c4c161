"""Named geological layer resolution and element masks.

A copy of the JAX package's ``ops/layers.py`` (host numpy only).
Re-implements the reference's layer semantics
(reference multi_mesh/utils.py:355-462):

* meshes carry an elemental ``layer`` id field; ids are sorted descending
  (crust first, core last),
* the named groups are resolved as
    - "all":    every layer
    - "crust":  the first ``moho_idx`` layers (from the ``moho_idx``
                global string)
    - "mantle": layers between moho and the first fluid element's layer
    - "core":   layers from the first fluid element's layer inward
    - "nocore": everything above the core
* per-layer boolean element masks are returned as a dict keyed by the
  layer id's string form.
"""
from __future__ import annotations

from typing import Dict, List, Tuple, Union

import numpy as np

LayerSpec = Union[str, int, List[int], np.ndarray]

NAMED_GROUPS = ("all", "crust", "mantle", "core", "nocore")


def resolve_layers(
    layer_field: np.ndarray,
    layers: LayerSpec,
    moho_idx: int | None = None,
    fluid_field: np.ndarray | None = None,
) -> Tuple[np.ndarray, bool]:
    """Resolve a layer spec to a list of numeric layer ids.

    Returns (layer_ids descending, needs_masking).
    """
    mesh_layers = np.sort(np.unique(layer_field))[::-1].astype(int)
    if isinstance(layers, (list, np.ndarray)):
        layers = np.asarray(layers, dtype=int)
        # membership, not just range: an in-range id absent from a mesh
        # with non-contiguous layer ids would otherwise produce an
        # all-false mask and crash obscurely downstream
        if not np.isin(layers, mesh_layers).all():
            raise ValueError(
                f"requested layers {layers.tolist()} not all in mesh "
                f"layers {mesh_layers.tolist()}"
            )
        return layers, set(layers.tolist()) != set(mesh_layers.tolist())
    if isinstance(layers, (int, np.integer)):
        if int(layers) not in mesh_layers:
            raise ValueError(f"layer {layers} not in mesh")
        return np.asarray([int(layers)]), True
    if not isinstance(layers, str) or layers not in NAMED_GROUPS:
        raise ValueError(
            f"layers must be ids or one of {NAMED_GROUPS}, got {layers!r}"
        )
    if layers == "all":
        return mesh_layers, False
    if layers in ("crust", "mantle") and moho_idx is None:
        raise ValueError(
            f"layer group {layers!r} needs the mesh's moho_idx global string"
        )
    if layers == "crust":
        return mesh_layers[:moho_idx], True
    # groups below need the outer-core boundary: the layer of the first
    # fluid element
    if fluid_field is None or not (fluid_field == 1).any():
        if layers == "nocore":
            return mesh_layers, False  # no fluid core present
        raise ValueError(
            f"layer group {layers!r} needs a fluid element flag"
        )
    ocore_layer = layer_field[np.where(fluid_field == 1)[0][0]]
    ocore_pos = int(np.where(mesh_layers == ocore_layer)[0][0])
    if layers == "mantle":
        return mesh_layers[moho_idx:ocore_pos], True
    if layers == "core":
        return mesh_layers[ocore_pos:], True
    return mesh_layers[:ocore_pos], True  # nocore


def layer_masks(
    layer_field: np.ndarray, layer_ids: np.ndarray
) -> Dict[str, np.ndarray]:
    """Per-layer boolean element masks keyed by str(layer id)."""
    return {
        str(int(l)): np.asarray(layer_field == l) for l in layer_ids
    }


def mesh_layer_masks(mesh, layers: LayerSpec):
    """Resolve + mask from a SalvusMesh-like object (needs
    ``elemental_fields['layer']``, optional 'fluid' and the moho_idx
    global string).  Returns (masks dict, layer_ids)."""
    efields = mesh.get_elemental_fields()
    layer_field = efields["layer"]
    fluid = efields.get("fluid")
    moho = None
    gs = getattr(mesh, "global_strings", {})
    if "moho_idx" in gs:
        raw = gs["moho_idx"]
        if isinstance(raw, (bytes, np.bytes_)):
            raw = raw.decode()
        if isinstance(raw, np.ndarray):
            raw = raw.item()
            if isinstance(raw, bytes):
                raw = raw.decode()
        moho = int(raw)
    ids, _ = resolve_layers(layer_field, layers, moho, fluid)
    return layer_masks(layer_field, ids), ids
