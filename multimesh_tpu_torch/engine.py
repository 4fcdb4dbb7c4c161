"""Mesh-to-mesh transfer pipelines (the engine).

Counterpart of the JAX package's ``engine.py``: every pipeline is

    host I/O  ->  dedup  ->  device locate  ->  device apply
              ->  host expansion / repair  ->  host write-back

with the (elements, refs) pair materialized as an ``ops.TransferOperator``
that can be cached on disk and reused (the reference's ``stored_array``
feature), in the JAX package's formats: a ``gll_2_gll`` cache directory or
a layered ``interp_info.h5`` saved by either package is accepted by the
other's for the same two files.  Layered variants run each geological
layer through the same device pipeline with per-layer masks.

Every entry point runs on ``device`` (None means ``cuda``).  The file
pipelines are thin wrappers that open the files around a core on numpy
arrays: ``gll_2_gll`` around ``transfer_arrays``, ``exodus_2_gll`` around
``exodus_2_gll_arrays`` (both write through a sink with ``sink[s:e] =
block`` semantics, an ``h5py`` dataset or a numpy array), ``gll_2_exodus``
and ``query_model`` around ``gll_2_points_arrays``.  The layered and
point-query pipelines take paths, ``SalvusMesh`` objects or any live
mesh-like object (``_as_salvus``).  ``h5py`` is imported only where an
HDF5 file is opened; the Exodus legs need ``scipy`` alone.
"""
from __future__ import annotations

import os
import pathlib
from typing import Callable, Dict, List, Tuple, Union

import numpy as np
import torch

from . import utils
from .config import DEFAULT_LOCATE, PREFILTER_M, LocateConfig
from .hashing import (
    array_fingerprint_hit,
    combine_fingerprints,
    content_fingerprint,
    content_fingerprint_device,
)
from .ops import (
    TransferOperator,
    map_to_sphere,
    mesh_layer_masks,
    unique_points_device,
    unique_points_per_layer,
)
from .ops.fluid import shear_index
from .progress import progress as _progress
from .utils_profile import count, stage_timer

PathLike = Union[str, pathlib.Path]


def _df32_default() -> bool:
    """MMT_DF32_POLISH=1 flips every engine transfer to the df32 polish
    (K4) and the pair apply (K5): f64-grade values.  Off by default: the
    f32 pipeline already meets the < 1e-6 target."""
    return os.environ.get("MMT_DF32_POLISH", "") == "1"


def _locate_cfg(nelem_to_search: int, accept_tol: float) -> LocateConfig:
    return LocateConfig(
        nelem_to_search=nelem_to_search, accept_tol=accept_tol,
        df32_polish=_df32_default(),
    )


def _device(device) -> torch.device:
    return torch.device("cuda" if device is None else device)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _as_salvus(mesh, fast_mode=False):
    """Accept a path, our own SalvusMesh, or any live salvus-like mesh
    object.  The reference's interpolate_to_points takes a
    salvus.mesh.UnstructuredMesh directly (reference
    multi_mesh/components/interpolator.py:945-954, element nodes via
    ``points[connectivity]``); objects exposing points/connectivity (or
    an element-nodal ``points``) duck-type through the same engine."""
    if isinstance(mesh, (str, pathlib.Path)):
        from .io import salvus as sio

        return sio.SalvusMesh(mesh, fast_mode=fast_mode)
    # a SalvusMesh (or a subclass) passes through; told by its class's
    # name, since importing io.salvus for isinstance needs h5py
    if any(c.__name__ == "SalvusMesh" for c in type(mesh).__mro__):
        return mesh
    pts = getattr(mesh, "points", None)
    conn = getattr(mesh, "connectivity", None)
    if pts is not None and getattr(pts, "ndim", 0) == 2 and conn is not None:
        # salvus.mesh.UnstructuredMesh shape: flat vertex list + conn
        return _DuckMesh(np.asarray(pts)[np.asarray(conn)], mesh)
    if pts is not None and getattr(pts, "ndim", 0) == 3:
        return _DuckMesh(np.asarray(pts), mesh)
    return mesh


class _DuckMesh:
    """SalvusMesh-compatible view over a live mesh object: the derived
    geometry attributes the engine reads (``dimensions``, ``nelem``,
    ``n_gll_points``) plus field access and write-back delegated to the
    wrapped object, so duck-typed inputs work on every engine path
    (interpolate_to_mesh, the layered transfers), not just
    interpolate_to_points."""

    def __init__(self, elem_points: np.ndarray, source):
        self.points = elem_points
        self._source = source
        dim = elem_points.shape[2]
        self.shape_order = int(
            round(elem_points.shape[1] ** (1.0 / dim))
        ) - 1

    @property
    def dimensions(self) -> int:
        return self.points.shape[2]

    @property
    def nelem(self) -> int:
        return self.points.shape[0]

    @property
    def n_gll_points(self) -> int:
        return self.points.shape[1]

    @property
    def global_strings(self):
        return getattr(self._source, "global_strings", {})

    @property
    def element_nodal_fields(self):
        enf = getattr(self._source, "element_nodal_fields", None)
        if enf is None:
            raise AttributeError(
                "mesh object has no element_nodal_fields; pass a file "
                "path or a SalvusMesh for field access"
            )
        return enf

    def get_element_nodal_fields(self):
        get = getattr(self._source, "get_element_nodal_fields", None)
        if get is not None:
            return get()
        return self.element_nodal_fields

    def get_elemental_fields(self):
        get = getattr(self._source, "get_elemental_fields", None)
        if get is not None:
            return get()
        ef = getattr(self._source, "elemental_fields", None)
        if ef is None:
            raise AttributeError(
                "mesh object has no elemental fields; the layered paths "
                "need a SalvusMesh or file path"
            )
        return ef

    def attach_field(self, name, data):
        att = getattr(self._source, "attach_field", None)
        if att is not None:
            return att(name, data)
        self.element_nodal_fields[name] = np.asarray(data)


def _nodal_fields(mesh) -> dict:
    """Element-nodal fields of any mesh-like input.  Prefers the lazy
    accessor: a user-constructed ``SalvusMesh`` defaults to
    ``fast_mode=True``, where the raw ``element_nodal_fields`` dict is
    empty until first access -- reading it directly would silently turn
    ``parameters="all"`` into a no-op transfer."""
    get = getattr(mesh, "get_element_nodal_fields", None)
    return get() if get is not None else mesh.element_nodal_fields


# -------------------------------------------------------------------------
# GLL -> GLL (whole mesh)
# -------------------------------------------------------------------------
def gll_2_gll(
    from_gll: PathLike,
    to_gll: PathLike,
    nelem_to_search: int = 20,
    parameters="ISO",
    from_model_path: str = "MODEL/data",
    to_model_path: str = "MODEL/data",
    from_coordinates_path: str = "MODEL/coordinates",
    to_coordinates_path: str = "MODEL/coordinates",
    gradient: bool = False,
    stored_array: PathLike | None = None,
    device=None,
):
    """Transfer every parameter of ``from_gll`` onto ``to_gll``.

    Mirrors the reference flagship path (interpolator.py:621-852): all
    source parameters are transferred (the ``parameters`` argument is kept
    for API compatibility; the reference overrides it with the source's
    parameter list at :668), unique target points are deduplicated, the
    transfer operator is optionally cached under ``stored_array``, and
    fluid/solid contamination is repaired unless ``gradient``.  Runs on
    ``device`` (None means ``cuda``); returns the written values, f64
    [nelem, n_params, n_gll].
    """
    import h5py

    from .io import salvus as sio

    del parameters
    with stage_timer("g2g.read_source"):
        src_points, src_data, src_params = sio.load_hdf5_params(
            from_gll, from_model_path, from_coordinates_path
        )
    with h5py.File(str(to_gll), "r+") as new:
        with stage_timer("g2g.read_target"):
            new_points = np.asarray(
                new[to_coordinates_path][()], np.float64
            )
            elem_params = sio.read_dim_labels(new["MODEL/element_data"])
            fluid_idx = elem_params.index("fluid")
            fluid = new["MODEL/element_data"][:, fluid_idx].astype(bool)
            old_values = np.asarray(new[to_model_path][()])

        def open_sink(params):
            sio.recreate_dataset(
                new, params, to_model_path, to_coordinates_path
            )
            return new[to_model_path]

        return transfer_arrays(
            src_points, src_data, src_params, new_points, old_values,
            ~fluid, open_sink, nelem_to_search=nelem_to_search,
            gradient=gradient, stored_array=stored_array, device=device,
        )


def transfer_arrays(
    src_points: np.ndarray,
    src_data: np.ndarray,
    parameters: List[str],
    new_points: np.ndarray,
    old_values: np.ndarray,
    solid: np.ndarray,
    open_sink: Callable[[List[str]], object],
    nelem_to_search: int = 20,
    gradient: bool = False,
    stored_array: PathLike | None = None,
    device=None,
) -> np.ndarray:
    """``gll_2_gll`` between "arrays read" and "blocks written".

    src_points [E_s, n, d], src_data [E_s, P, n] with its ``parameters``;
    new_points [E, n, d], old_values [E, P_old, n] and ``solid`` [E] of
    the target.  ``open_sink(parameters)`` is called once, after the NaN
    audit, and returns the sink the [E, P, n] f64 result is written to in
    element blocks (``sink[s:e] = block``).  Returns that result.
    """
    device = _device(device)
    dim = src_points.shape[2]
    order = int(round(src_data.shape[2] ** (1.0 / dim))) - 1
    gll_points = new_points.shape[1]

    # Source and target hashed SEPARATELY so the target's fingerprint also
    # keys the dedup cache, and their combination guards the on-disk
    # operator cache.  Keying the operator on the raw target coordinates
    # (not the deduplicated points) is what lets a cache hit skip the
    # dedup entirely: the operator is saved WITH its reconstruction
    # indices (recon.npy).  On the card the target's bytes are summed
    # where the dedup takes them (``tgt_dev``); a frozen source is hashed
    # once, and a writable one once a call: it is frozen for the call in
    # a view, whose fingerprint locate's mesh prep finds in the identity
    # cache.
    with stage_timer("g2g.fingerprint"):
        fp_tgt, tgt_dev = content_fingerprint_device(new_points, device)
        if src_points.flags.writeable:
            src_points = src_points.view()
            src_points.setflags(write=False)
        fp_src, hit = array_fingerprint_hit(src_points, device)
        count("fingerprint.frozen_hits", int(hit))
        fp = combine_fingerprints(fp_src, fp_tgt)

    op = None
    if stored_array and TransferOperator.exists(stored_array):
        tgt_dev = None  # a hit skips the dedup; a miss uploads again
        with stage_timer("g2g.load_operator"):
            try:
                op = TransferOperator.load(stored_array, fingerprint=fp,
                                           device=device)
            except ValueError as exc:
                print(f"Ignoring stored operator: {exc}")
        if op is not None and op.recon is None:
            # a recon computed here need not be the ordering the stored
            # rows were built on: expanding with it could scramble values
            print(f"Ignoring stored operator at {stored_array}: it has no "
                  "recon.npy; rebuilding")
            op = None
    if op is None:
        with stage_timer("g2g.dedup"):
            # first-appearance unique ordering, the JAX package's: a
            # stored operator's rows and recon.npy pass between the two
            uniq, recon = unique_points_device(
                new_points, fp_tgt, order_by="first", device=device,
                uploaded=tgt_dev,
            )
            tgt_dev = None
        op = TransferOperator.build(
            src_points,
            uniq,
            order=order,
            cfg=_locate_cfg(nelem_to_search, accept_tol=1.04),
            fallback="fixed_ref",
            use_aabb=True,
            prefilter_m=PREFILTER_M,
            recon=recon,
            device=device,
        )
        if stored_array:
            with stage_timer("g2g.save_operator"):
                op.save(stored_array, fingerprint=fp)

    fields = np.ascontiguousarray(np.moveaxis(src_data, 1, 0))  # [P, E, n]
    with stage_timer("g2g.apply"):
        # UNIQUE values only, as a list of device chunks: the expansion
        # to the ~2x larger slot array is the write's (below)
        chunks, _ = op.apply(fields, out_chunks=True)
    # NaN audit: one device reduction over the chunks and one host read,
    # before anything is written (expansion cannot introduce NaNs, so
    # auditing the unique values covers the full result)
    with stage_timer("g2g.nan_audit"):
        has_nan = bool(torch.stack([torch.isnan(c).any()
                                    for c in chunks]).any())
    if has_nan:
        raise FloatingPointError(
            "interpolation produced NaNs; check source mesh/fields"
        )

    with stage_timer("g2g.stream_write"):
        values = _stream_expand_write(
            open_sink, chunks, op.recon, parameters, gll_points,
            old_values, solid, gradient,
        )
    return values


def _stream_pull_write(sink, out_dev: torch.Tensor,
                       block_bytes: int = 1 << 25):
    """Pipelined device->host pull + write for DIRECT-ordered results (no
    dedup/reconstruction): ``out_dev`` [n, ...] is copied in row blocks of
    about ``block_bytes`` through ``_start_pull`` (a pinned buffer, a side
    stream, one event a block), and block j is written to ``sink`` while
    the later blocks are still being copied."""
    n = out_dev.shape[0]
    row_bytes = int(np.prod(out_dev.shape[1:])) * out_dev.element_size()
    blk = max(1, block_bytes // max(1, row_bytes))
    starts = list(range(0, n, blk))
    if not starts:
        return
    host, wait = _start_pull([out_dev[s:s + blk] for s in starts], blk)
    pbar = _progress(n, "write-back", unit="rows", n_steps=len(starts))
    for j, s in enumerate(starts):
        wait(j)
        e = min(s + blk, n)
        sink[s:e] = host[s:e]
        pbar.step(e - s)
    pbar.close()


def _start_pull(chunks, CH: int):
    """Start copying the device chunks (rows ``[j*CH, (j+1)*CH)``) into
    one host array: ``(vals_host, wait)``, where ``wait(j)`` returns once
    chunk ``j`` has landed.

    On the card the host array is pinned and every chunk is copied with
    ``copy_(non_blocking=True)`` on a side stream, an event recorded after
    each: the copies are all enqueued here and run back to back while the
    caller expands and writes what has landed.  Events on a side stream
    rather than a worker thread that pulls: the copy engine needs no host
    thread, and the caller's HDF5 writes then never share the interpreter
    with a second thread.  CPU chunks are copied at once."""
    U = sum(int(c.shape[0]) for c in chunks)
    first = chunks[0]
    host = torch.empty((U,) + tuple(first.shape[1:]), dtype=first.dtype,
                       pin_memory=first.is_cuda)
    if not first.is_cuda:
        for j, c in enumerate(chunks):
            host[j * CH : j * CH + c.shape[0]] = c
        return host.numpy(), lambda j: None
    side = torch.cuda.Stream(first.device)
    side.wait_stream(torch.cuda.current_stream(first.device))
    events = []
    with torch.cuda.stream(side):
        for j, c in enumerate(chunks):
            host[j * CH : j * CH + c.shape[0]].copy_(c, non_blocking=True)
            events.append(torch.cuda.Event())
            events[-1].record(side)
    return host.numpy(), lambda j: events[j].synchronize()


def _stream_expand_write(
    open_sink, chunks, recon, parameters, gll_points, old_values, solid,
    gradient, block_bytes: int = 1 << 25,
):
    """Expansion where the unique values live, then a pipelined pull +
    write-back of finished f64 element blocks.

    On the chunks' device (``apply(out_chunks=True)``'s unique rows) the
    values are gathered by ``recon`` (any order), relaid [E, n, P] ->
    [E, P, n] and cast to f64, and the elements ``repair_fluid_solid``
    would revert are picked (fluid, or solid with a zero VS / VSV: a value
    is zero in f32 exactly when it is in f64); none with ``gradient``.
    The blocks of about ``block_bytes`` are copied to the host through
    ``_start_pull``, and block j goes into ``values``, its picked elements
    back to ``old_values``, then into the sink, while later blocks are
    still being copied.  ``values`` is an ordinary host array: it does not
    alias the pinned buffer, which the caching host allocator takes back
    on return.
    """
    n_elem = old_values.shape[0]
    n_par = len(parameters)
    dev = chunks[0].device
    blk = max(1, block_bytes // (n_par * gll_points * 8))
    with stage_timer("g2g.expand"):
        uniq = chunks[0] if len(chunks) == 1 else torch.cat(chunks)
        recon = torch.as_tensor(recon, device=dev)
        out = torch.empty((n_elem, n_par, gll_points), dtype=torch.float64,
                          device=dev)
        for s in range(0, n_elem, blk):
            e = min(s + blk, n_elem)
            rows = uniq.index_select(0, recon[s * gll_points:e * gll_points])
            out[s:e] = rows.view(e - s, gll_points, n_par).transpose(1, 2)
        patched = np.empty(0, np.int64)
        if not gradient:
            revert = ~torch.as_tensor(solid, device=dev)
            vs = shear_index(parameters)
            if vs is not None:
                revert |= (out[:, vs] == 0).any(dim=1)
            patched = np.flatnonzero(revert.cpu().numpy())
    count("expand.card_slots", n_elem * gll_points)
    count("expand.patched_elems", len(patched))

    sink = open_sink(parameters)
    values = np.empty((n_elem, n_par, gll_points), np.float64)
    host, wait = _start_pull(list(out.split(blk)), blk)
    pbar = _progress(n_elem, "write-back", unit="elems",
                     n_steps=-(-n_elem // blk))
    for j, s in enumerate(range(0, n_elem, blk)):
        e = min(s + blk, n_elem)
        with stage_timer("g2g.pull_wait"):
            wait(j)
        # torch's copy runs on its intra-op threads, so the first touch
        # of the fresh pages of ``values`` is spread over the cores
        torch.from_numpy(values[s:e]).copy_(torch.from_numpy(host[s:e]))
        a, b = np.searchsorted(patched, (s, e))
        values[patched[a:b]] = old_values[patched[a:b]]
        sink[s:e] = values[s:e]
        pbar.step(e - s)
    pbar.close()
    return values


# -------------------------------------------------------------------------
# GLL -> GLL (layered)
# -------------------------------------------------------------------------
def _layered_operators(
    original_mesh,
    new_mesh,
    layers,
    nelem_to_search: int,
    stored_array: PathLike | None,
    accept_tol: float,
    fallback: str,
    use_aabb: bool,
    device=None,
) -> Tuple[Dict[str, TransferOperator], Dict[str, np.ndarray],
           Dict[str, np.ndarray]]:
    """Shared core of the layered transfers: per-layer (operator,
    source-mask, target-mask), with interp_info.h5 caching (the file
    holds each layer's elements and dense coefficients, in the JAX
    package's layout, and needs ``h5py``)."""
    device = _device(device)
    with stage_timer("layered.masks_dedup"):
        src_masks, layer_ids = mesh_layer_masks(original_mesh, layers)
        tgt_masks, _ = mesh_layer_masks(new_mesh, list(layer_ids))
        with stage_timer("layered.dedup"):
            uniq = unique_points_per_layer(new_mesh.points, tgt_masks,
                                           device=device)

    cache_path = (
        os.path.join(str(stored_array), "interp_info.h5")
        if stored_array is not None
        else None
    )
    ops: Dict[str, TransferOperator] = {}
    # geometry fingerprint + locate semantics form the cache key: the
    # three layered entry points share the same file name but differ in
    # accept tolerance and fallback mode, and a layer selection not in
    # the cached set must rebuild, not KeyError.  Without stored_array
    # there is no cache to guard, so the (GB-scale on big meshes) host
    # hash is skipped entirely.
    sem = f"{accept_tol}/{fallback}/{int(use_aabb)}/{nelem_to_search}"
    fp = (
        content_fingerprint(original_mesh.points, new_mesh.points)
        if cache_path
        else None
    )
    if cache_path and os.path.exists(cache_path):
        import h5py

        with h5py.File(cache_path, "r") as f:
            cached_sem = f.attrs.get("semantics", "")
            if isinstance(cached_sem, bytes):
                cached_sem = cached_sem.decode()
            if int(f.attrs.get("fingerprint", 0)) != fp:
                print(
                    f"Ignoring stored interp_info at {cache_path}: built "
                    "from different geometry"
                )
            elif cached_sem != sem:
                print(
                    f"Ignoring stored interp_info at {cache_path}: built "
                    f"with different locate semantics ({cached_sem!r} != "
                    f"{sem!r})"
                )
            elif not all(f"elements/{l}" in f for l in uniq):
                print(
                    f"Ignoring stored interp_info at {cache_path}: does "
                    "not cover the requested layers"
                )
            else:
                for layer in uniq:
                    # coefficients, not refs: the operator applies them
                    # as stored, in their stored dtype
                    op = TransferOperator(
                        elements=torch.as_tensor(
                            f[f"elements/{layer}"][()].astype(np.int32),
                            device=device),
                        order=original_mesh.shape_order,
                        recon=torch.as_tensor(uniq[layer][1],
                                              device=device),
                    )
                    op.weights = f[f"coeffs/{layer}"][()]
                    ops[layer] = op
                return ops, src_masks, tgt_masks

    order = original_mesh.shape_order
    with stage_timer("layered.build"):
        for layer in list(uniq):
            # each layer's unique points go once its operator is built
            pts_u, recon = uniq.pop(layer)
            ops[layer] = TransferOperator.build(
                original_mesh.points[src_masks[layer]],
                pts_u,
                order=order,
                cfg=_locate_cfg(nelem_to_search, accept_tol),
                fallback=fallback,
                use_aabb=use_aabb,
                prefilter_m=PREFILTER_M,
                recon=recon,
                device=device,
            )
    if cache_path:
        import h5py

        os.makedirs(str(stored_array), exist_ok=True)
        with h5py.File(cache_path, "w") as f:
            f.attrs["fingerprint"] = np.uint64(fp)
            f.attrs["semantics"] = sem
            for layer, op in ops.items():
                f.create_dataset(f"coeffs/{layer}", data=_host(op.weights))
                f.create_dataset(f"elements/{layer}",
                                 data=_host(op.elements))
    return ops, src_masks, tgt_masks


def _layered_apply_and_write(
    original_mesh,
    new_mesh,
    ops: Dict[str, TransferOperator],
    src_masks: Dict[str, np.ndarray],
    tgt_masks: Dict[str, np.ndarray],
    parameters: List[str],
):
    # all parameters in one device pass per layer, one host pull each
    count("layered.layers", len(ops))
    with stage_timer("layered.apply_write"):
        new_fields = {
            p: np.array(_nodal_fields(new_mesh)[p], copy=True)
            for p in parameters
        }
        for layer, op in ops.items():
            src = np.stack(
                [
                    _nodal_fields(original_mesh)[p][src_masks[layer]]
                    for p in parameters
                ]
            )  # [P, E_layer, n]
            with stage_timer("layered.apply"):
                vals = _host(op.apply(src))  # [N_layer, P]
            count("layered.slots", vals.shape[0])
            for i, p in enumerate(parameters):
                tgt = new_fields[p]
                tgt[tgt_masks[layer]] = vals[:, i].reshape(
                    tgt[tgt_masks[layer]].shape
                )
        for p in parameters:
            new_mesh.attach_field(name=p, data=new_fields[p])


def _layered_inputs(from_mesh, to_mesh, parameters, make_spherical):
    """(source mesh, target mesh, parameter list) of a layered entry
    point: paths opened, "all" and the presets resolved, both meshes
    mapped to spheres on request."""
    original_mesh = _as_salvus(from_mesh)
    if make_spherical:
        map_to_sphere(original_mesh)
    if parameters == "all":
        parameters = [
            p for p in _nodal_fields(original_mesh)
            if p != "z_node_1D"
        ]
    parameters = utils.pick_parameters(parameters)
    new_mesh = _as_salvus(to_mesh)
    if make_spherical:
        map_to_sphere(new_mesh)
    return original_mesh, new_mesh, parameters


def gll_2_gll_layered(
    from_gll: PathLike,
    to_gll: PathLike,
    layers,
    nelem_to_search: int = 20,
    parameters="ISO",
    stored_array: PathLike | None = None,
    make_spherical: bool = False,
    device=None,
):
    """Layer-restricted GLL->GLL transfer (reference
    interpolator.py:288-439).  Per-layer candidate search + locate with
    the reference's _check_if_inside_element semantics (AABB prefilter,
    accept tol 1.04, fixed-ref fallback)."""
    original_mesh, new_mesh, parameters = _layered_inputs(
        from_gll, to_gll, parameters, make_spherical)
    ops, src_masks, tgt_masks = _layered_operators(
        original_mesh, new_mesh, layers, nelem_to_search, stored_array,
        accept_tol=1.04, fallback="fixed_ref", use_aabb=True,
        device=device,
    )
    _layered_apply_and_write(
        original_mesh, new_mesh, ops, src_masks, tgt_masks, parameters
    )


def gll_2_gll_layered_multi(
    from_gll: PathLike,
    to_gll: PathLike,
    layers="nocore",
    nelem_to_search: int = 20,
    parameters="all",
    threads: int | None = None,
    stored_array: PathLike | None = None,
    make_spherical: bool = False,
    device=None,
):
    """Reference parity alias (interpolator.py:442-618).

    The reference parallelizes layers over a process pool; here every
    layer already runs through the batched device pipeline, so this simply
    delegates (``threads`` accepted and ignored)."""
    del threads
    return gll_2_gll_layered(
        from_gll=from_gll,
        to_gll=to_gll,
        layers=layers,
        nelem_to_search=nelem_to_search,
        parameters=parameters,
        stored_array=stored_array,
        make_spherical=make_spherical,
        device=device,
    )


def gll_2_gll_layered_multi_two(
    from_gll: PathLike,
    to_gll: PathLike,
    layers,
    nelem_to_search: int = 30,
    parameters="all",
    stored_array: PathLike | None = None,
    make_spherical: bool = False,
    tolerance: float = 1.05,
    device=None,
):
    """Layered transfer with the get_element_weights engine per layer
    (reference interpolator.py:980-1082): acceptance ``tolerance``,
    snap-to-nearest fallback."""
    original_mesh, new_mesh, parameters = _layered_inputs(
        from_gll, to_gll, parameters, make_spherical)
    ops, src_masks, tgt_masks = _layered_operators(
        original_mesh, new_mesh, layers, nelem_to_search, stored_array,
        accept_tol=tolerance, fallback="snap", use_aabb=False,
        device=device,
    )
    _layered_apply_and_write(
        original_mesh, new_mesh, ops, src_masks, tgt_masks, parameters
    )


# -------------------------------------------------------------------------
# Exodus <-> GLL
# -------------------------------------------------------------------------
def _exodus_operator(corner_nodes, points, nelem_to_search: int,
                     device) -> TransferOperator:
    """Locate ``points`` in trilinear hexes / bilinear quads with the
    reference C kernel's acceptance semantics (accept 1.025, best-so-far
    below 1.5, trilinearinterpolator.c:93-137); any missing point raises."""
    cfg = LocateConfig(
        nelem_to_search=nelem_to_search, accept_tol=1.025,
        fallback_max=1.5, df32_polish=_df32_default(),
    )
    op = TransferOperator.build(
        corner_nodes, points, order=1, cfg=cfg, fallback="best",
        device=device,
    )
    n_missing = op.num_missing
    if n_missing:
        raise RuntimeError(
            f"{n_missing} points could not be interpolated."
        )
    return op


def _exodus_source(exo, parameters):
    """(parameter list, corner nodes [E, 2^d, d], canonical connectivity)
    of an open Exodus source; raises if a parameter is not nodal there."""
    parameters = utils.pick_parameters(parameters)
    missing = [p for p in parameters if p not in exo.nodal_parameters]
    if missing:
        raise ValueError(
            f"exodus mesh lacks nodal parameters {missing}; "
            f"has {exo.nodal_parameters}"
        )
    return (parameters, exo.canonical_corner_nodes(),
            exo.canonical_connectivity())


def exodus_2_gll(
    mesh: PathLike,
    gll_model: PathLike,
    gll_order: int = 4,
    dimensions: int = 3,
    nelem_to_search: int = 20,
    parameters="TTI",
    model_path: str = "MODEL/data",
    coordinates_path: str = "MODEL/coordinates",
    device=None,
):
    """Exodus (trilinear hexes) -> GLL mesh nodal transfer.

    Replaces the reference's per-GLL-slot C trilinear kernel loop
    (interpolator.py:142-224 + src/trilinearinterpolator.c): all
    npoints * n_gll target nodes are located in one batched device pass
    against the hex corners with the C kernel's acceptance semantics
    (accept 1.025, best-so-far below 1.5).  ``gll_order`` and
    ``dimensions`` are read from the files, as in the JAX package.
    """
    import h5py

    from .io import exodus as eio
    from .io import salvus as sio

    del gll_order, dimensions
    with stage_timer("e2g.read_exodus"):
        exo = eio.Exodus(mesh)
        parameters, corner_nodes, conn = _exodus_source(exo, parameters)

    with h5py.File(str(gll_model), "r+") as gll:
        with stage_timer("e2g.read_gll_coords"):
            # The target coordinates are read as f32 (h5py converts during
            # the read), as the JAX package reads them: every coordinate
            # is rounded to the nearest f32 (about 0.5 m at Earth scale)
            # before it is located.  A trilinear source's own error is far
            # above that, and both packages then locate the same points.
            coords = np.asarray(gll[coordinates_path][()], np.float32)
        with stage_timer("e2g.gather_fields"):
            fields = np.stack(
                [exo.get_nodal_field(p)[conn] for p in parameters]
            )  # [F, E, 2^d]

        def open_sink(params):
            sio.recreate_dataset(gll, params, model_path, coordinates_path)
            return gll[model_path]

        exodus_2_gll_arrays(
            corner_nodes, fields, parameters, coords, open_sink,
            nelem_to_search=nelem_to_search, device=device,
        )


def exodus_2_gll_arrays(
    corner_nodes: np.ndarray,
    fields: np.ndarray,
    parameters: List[str],
    coords: np.ndarray,
    open_sink: Callable[[List[str]], object],
    nelem_to_search: int = 20,
    device=None,
) -> None:
    """``exodus_2_gll`` between "arrays read" and "blocks written".

    corner_nodes [E, 2^d, d] and fields [F, E, 2^d] (the nodal fields
    gathered through the canonical connectivity) of the source;
    coords [npoints, n_gll, d] of the target, as read (f32 from
    ``exodus_2_gll``).  ``open_sink(parameters)`` is called once, after
    the build found every point, and returns the sink the
    [npoints, F, n_gll] f32 result is written to in row blocks
    (``sink[s:e] = block``)."""
    device = _device(device)
    npoints, n_gll, dim = coords.shape
    with stage_timer("e2g.locate"):
        op = _exodus_operator(corner_nodes, coords.reshape(-1, dim),
                              nelem_to_search, device)
    # all parameters in ONE device pass
    with stage_timer("e2g.apply"):
        # Relayout to the target layout [npoints, F, n_gll] on the device
        # and round to f32 before the pull, as the JAX package does: the
        # written values are the nearest f32 of the interpolated ones (the
        # f64 dataset stores them exactly), whatever dtype the apply ran
        # in, so both packages write values of one precision.
        out_dev = op.apply(fields).view(
            npoints, n_gll, len(parameters)
        ).transpose(1, 2).to(torch.float32).contiguous()
    with stage_timer("e2g.stream_write"):
        _stream_pull_write(open_sink(parameters), out_dev)


def gll_2_points_arrays(
    gll_points: np.ndarray,
    gll_data: np.ndarray,
    points: np.ndarray,
    nelem_to_search: int = 20,
    device=None,
) -> torch.Tensor:
    """Every parameter of a GLL model at ``points`` [N, d] with the
    flagship semantics (accept 1.04, AABB, fixed-ref fallback): the core
    of ``gll_2_exodus`` and ``query_model``.  gll_points [E, n, d],
    gll_data [E, P, n]; returns [N, P] on the device."""
    dim = gll_points.shape[2]
    order = int(round(gll_data.shape[2] ** (1.0 / dim))) - 1
    op = TransferOperator.build(
        gll_points,
        points,
        order=order,
        cfg=_locate_cfg(nelem_to_search, accept_tol=1.04),
        fallback="fixed_ref",
        use_aabb=True,
        prefilter_m=PREFILTER_M,
        device=device,
    )
    # [P, E, n], all parameters in one device pass
    return op.apply(np.ascontiguousarray(np.moveaxis(gll_data, 1, 0)))


def gll_2_exodus(
    gll_model: PathLike,
    exodus_model: PathLike,
    gll_order: int = 4,
    dimensions: int = 3,
    nelem_to_search: int = 20,
    parameters="TTI",
    model_path: str = "MODEL/data",
    coordinates_path: str = "MODEL/coordinates",
    gradient: bool = False,
    device=None,
):
    """GLL -> Exodus nodal transfer (reference interpolator.py:227-285);
    parameter list is read from the GLL file's dimension labels.  Returns
    the attached values, [N, P] on the host."""
    import h5py

    from .io import exodus as eio
    from .io import salvus as sio

    del gll_order, dimensions, parameters, gradient
    with h5py.File(str(gll_model), "r") as f:
        gll_points = np.asarray(f[coordinates_path][()], np.float64)
        gll_data = np.asarray(f[model_path][()])
        parameters = sio.read_dim_labels(f[model_path])

    exo = eio.Exodus(exodus_model, mode="a")
    values = _host(gll_2_points_arrays(
        gll_points, gll_data, exo.points, nelem_to_search, device))
    for i, param in enumerate(parameters):
        exo.attach_field(param, values[:, i])
    return values


def get_element_weights(
    gll_points,
    shape_order: int,
    centroids,
    points,
    nelem_to_search: int = 25,
    tolerance: float = 1.05,
    snap_to_nearest: bool = False,
    device=None,
):
    """(elements, coeffs) for a point cloud -- reference parity wrapper.

    Same contract as the reference's main parallel engine
    (interpolator.py:1147-1255): gll_points [E, n, d], candidate count,
    acceptance tolerance, snap-to-nearest fallback; returns
    (elements [N] with -1 for missing, coeffs [N, n]) as host arrays.
    Instead of a centroid KD-tree this takes the centroids themselves
    (or None to compute them).
    """
    cfg = LocateConfig(nelem_to_search=nelem_to_search,
                       accept_tol=tolerance,
                       df32_polish=_df32_default())
    op = TransferOperator.build(
        gll_points,
        np.asarray(points, np.float64),
        order=shape_order,
        cfg=cfg,
        fallback="snap" if snap_to_nearest else "sentinel",
        prefilter_m=PREFILTER_M,
        centroids=centroids,
        device=device,
    )
    return _host(op.elements), _host(op.weights)


def get_element_weights_layered(
    new_coordinates,
    nearest_elements,
    original_mesh,
    original_mask,
    dimensions: int = 3,
    from_gll_order: int = 2,
    device=None,
):
    """Per-layer (elements, coeffs) dicts -- reference parity wrapper
    (interpolator.py:1258-1334; acceptance tolerance 1.03, sentinel).

    new_coordinates: layer -> (points, recon); nearest_elements: layer ->
    [N_layer, k] candidate ids into the masked element set."""
    del dimensions
    cfg = LocateConfig(accept_tol=1.03, df32_polish=_df32_default())
    elems, coeffs = {}, {}
    for layer, (pts, _recon) in new_coordinates.items():
        op = TransferOperator.build(
            original_mesh.points[original_mask[layer]],
            np.asarray(pts, np.float64),
            order=from_gll_order,
            cfg=cfg,
            fallback="sentinel",
            candidates=np.asarray(nearest_elements[layer]),
            device=device,
        )
        elems[layer] = _host(op.elements)
        coeffs[layer] = _host(op.weights)
    return elems, coeffs


def exodus_2_exodus(
    mesh_a: PathLike,
    mesh_b: PathLike,
    parameters="TTI",
    nelem_to_search: int = 20,
    device=None,
):
    """Exodus -> Exodus nodal field transfer (the reference CLI's
    interpolate_mesh_a_to_b path, cli.py:35-104 + the C trilinear kernel):
    locate every node of mesh B inside mesh A's hexes, then one weighted
    gather per parameter.  Needs ``scipy`` only."""
    from .io import exodus as eio

    exo_a = eio.Exodus(mesh_a)
    exo_b = eio.Exodus(mesh_b, mode="a")
    parameters, corner_nodes, conn = _exodus_source(exo_a, parameters)
    op = _exodus_operator(corner_nodes, exo_b.points, nelem_to_search,
                          device)
    # all parameters in ONE device pass + ONE host pull
    fields = np.stack(
        [exo_a.get_nodal_field(p)[conn] for p in parameters]
    )  # [F, E, 2^d]
    vals = _host(op.apply(fields))  # [N, F]
    for i, p in enumerate(parameters):
        exo_b.attach_field(p, vals[:, i])


# -------------------------------------------------------------------------
# Point queries
# -------------------------------------------------------------------------
def query_model(
    coordinates: np.ndarray,
    model: PathLike,
    nelem_to_search: int = 20,
    model_path: str = "MODEL/data",
    coordinates_path: str = "MODEL/coordinates",
    device=None,
):
    """Query a GLL model at lat/lon/depth coordinates -> [N, n_params] on
    the device (reference interpolator.py:60-139)."""
    from .io import salvus as sio

    coordinates = np.asarray(coordinates)
    if coordinates.shape[1] != 3:
        raise ValueError("coordinates must have shape [N, 3] (lat lon depth)")
    points = utils.latlondepth_to_xyz(coordinates)
    src_points, src_data, _params = sio.load_hdf5_params(
        model, model_path, coordinates_path
    )
    return gll_2_points_arrays(src_points, src_data, points,
                               nelem_to_search, device)


def interpolate_to_points(
    mesh,
    points: np.ndarray,
    params_to_interp: List[str],
    make_spherical: bool = False,
    cfg: LocateConfig = DEFAULT_LOCATE,
    device=None,
):
    """Mesh -> arbitrary point cloud, [N, n_params] on the device; zeros
    for unlocatable points (reference interpolator.py:931-977)."""
    mesh = _as_salvus(mesh)
    if make_spherical:
        map_to_sphere(mesh)
    op = TransferOperator.build(
        mesh.points,
        np.asarray(points, np.float64),
        order=mesh.shape_order,
        cfg=cfg,
        fallback="sentinel",
        prefilter_m=PREFILTER_M,
        device=device,
    )
    num_missing = op.num_missing
    count("points.sentinel_rows", num_missing)
    if num_missing:
        print(
            f"{num_missing} points could not find an enclosing element. "
            "These points will be set to zero. Please check your domain or "
            "the interpolation tuning parameters"
        )
    fields = np.stack(
        [_nodal_fields(mesh)[p] for p in params_to_interp]
    )
    with stage_timer("points.apply"):
        return op.apply(fields)


def interpolate_to_points_layered(
    from_mesh: PathLike,
    to_mesh: PathLike,
    parameters,
    layers="nocore",
    make_spherical: bool = False,
    nelem_to_search: int = 20,
    device=None,
):
    """Layered, more stable variant writing straight onto ``to_mesh``
    (reference interpolator.py:855-928): sentinel semantics, accept 1.03."""
    original_mesh, new_mesh, parameters = _layered_inputs(
        from_mesh, to_mesh, parameters, make_spherical)
    ops, src_masks, tgt_masks = _layered_operators(
        original_mesh, new_mesh, layers, nelem_to_search, None,
        accept_tol=1.03, fallback="sentinel", use_aabb=False,
        device=device,
    )
    num_failed = sum(op.num_missing for op in ops.values())
    _layered_apply_and_write(
        original_mesh, new_mesh, ops, src_masks, tgt_masks, parameters
    )
    if num_failed:
        print(f"{num_failed} points could not be interpolated")


def interpolate_to_mesh(
    old_mesh,
    new_mesh,
    params_to_interp=("VSV", "VSH", "VPV", "VPH"),
    device=None,
):
    """Map both meshes to spheres, interpolate old -> new nodal values,
    write onto the new mesh, restore geometry
    (reference api.py:353-393)."""
    old_mesh = _as_salvus(old_mesh)
    new_mesh = _as_salvus(new_mesh)
    old_pts = old_mesh.points.copy()
    new_pts = new_mesh.points.copy()
    try:
        map_to_sphere(old_mesh)
        map_to_sphere(new_mesh)
        flat = new_mesh.points.reshape(-1, new_mesh.dimensions)
        vals = _host(interpolate_to_points(
            old_mesh, flat, list(params_to_interp), device=device
        ))  # one host pull
        for i, p in enumerate(params_to_interp):
            new_mesh.attach_field(
                p, vals[:, i].reshape(new_mesh.nelem, new_mesh.n_gll_points)
            )
    finally:
        old_mesh.points[...] = old_pts
        new_mesh.points[...] = new_pts


def extract_regular_grid(
    mesh,
    parameters: List[str],
    lat_extent: Tuple[float, float, int],
    lon_extent: Tuple[float, float, int],
    depth_extent: Tuple[float, float, int],
    device=None,
) -> utils.RegularGridData:
    """Sample a mesh onto a regular lat/lon/depth grid
    (reference interpolator.py:1600-1646; implemented natively instead of
    delegating to salvus.mesh utilities)."""
    mesh = _as_salvus(mesh)
    with stage_timer("regular.make_points"):
        lat = np.linspace(lat_extent[0], lat_extent[1], int(lat_extent[2]))
        lon = np.linspace(lon_extent[0], lon_extent[1], int(lon_extent[2]))
        depth = np.linspace(depth_extent[0], depth_extent[1],
                            int(depth_extent[2]))
        ds = utils.create_dataset_grid(lat=lat, lon=lon, depth=depth)

        dd, la, lo = np.meshgrid(depth, lat, lon, indexing="ij")
        lld = np.stack([la.ravel(), lo.ravel(), dd.ravel()], axis=-1)
        points = utils.latlondepth_to_xyz(lld)
    count("regular.points", points.shape[0])
    vals = interpolate_to_points(mesh, points, parameters, device=device)
    with stage_timer("regular.pull"):
        vals = _host(vals)
    with stage_timer("regular.assemble"):
        for i, p in enumerate(parameters):
            ds.data[p] = vals[:, i].reshape(len(depth), len(lat), len(lon))
    return ds
