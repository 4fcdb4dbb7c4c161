"""Mesh-to-mesh transfer pipelines (the engine).

Counterpart of the JAX package's ``engine.py`` for the flagship file path,

    host I/O  ->  dedup  ->  device locate  ->  device apply
              ->  host expansion + fluid/solid repair  ->  host write-back

with the (elements, refs) pair materialized as an ``ops.TransferOperator``
that can be cached on disk and reused (the reference's ``stored_array``
feature), in the JAX package's format: a cache directory saved by either
package's ``gll_2_gll`` is accepted by the other's for the same two files.

``gll_2_gll`` reads and writes the HDF5 files; everything between "arrays
read" and "blocks written" is ``transfer_arrays``, which takes numpy
arrays and a sink with ``sink[s:e] = block`` semantics (an ``h5py``
dataset or a numpy array), so only ``gll_2_gll`` needs ``h5py``.
"""
from __future__ import annotations

import os
import pathlib
from typing import Callable, List, Union

import numpy as np
import torch

from .config import PREFILTER_M, LocateConfig
from .hashing import combine_fingerprints, content_fingerprint
from .ops import TransferOperator, repair_fluid_solid, unique_points_device
from .progress import progress as _progress
from .utils_profile import stage_timer

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
    device = torch.device("cuda" if device is None else device)
    dim = src_points.shape[2]
    order = int(round(src_data.shape[2] ** (1.0 / dim))) - 1
    gll_points = new_points.shape[1]

    # Source and target hashed SEPARATELY so the target's fingerprint also
    # keys the dedup cache, and their combination guards the on-disk
    # operator cache.  Keying the operator on the raw target coordinates
    # (not the deduplicated points) is what lets a cache hit skip the
    # host dedup lexsort entirely: the operator is saved WITH its
    # reconstruction indices (recon.npy).
    with stage_timer("g2g.fingerprint"):
        fp_tgt = content_fingerprint(new_points)
        fp = combine_fingerprints(content_fingerprint(src_points), fp_tgt)

    op = None
    if stored_array and TransferOperator.exists(stored_array):
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
    if op is not None:
        recon = op.recon.cpu().numpy()
    else:
        with stage_timer("g2g.dedup"):
            # first-appearance unique ordering: prefixes of the slot array
            # then reference prefixes of the unique values, which is what
            # lets _stream_expand_write start on the first elements while
            # later chunks are still being copied to the host
            uniq, recon = unique_points_device(
                new_points, fp_tgt, order_by="first", device=device
            )
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
            op.save(stored_array, fingerprint=fp)

    fields = np.ascontiguousarray(np.moveaxis(src_data, 1, 0))  # [P, E, n]
    with stage_timer("g2g.apply") as t:
        # UNIQUE values only, as a list of device chunks: reconstruction
        # to the ~2x larger slot array happens on the host, streamed
        # chunk by chunk below
        chunks, CH = op.apply(fields, out_chunks=True)
        t.sync(chunks[0])
    # NaN audit: one device reduction over the chunks and one host read,
    # before anything is written (expansion cannot introduce NaNs, so
    # auditing the unique values covers the full result)
    if bool(torch.stack([torch.isnan(c).any() for c in chunks]).any()):
        raise FloatingPointError(
            "interpolation produced NaNs; check source mesh/fields"
        )

    with stage_timer("g2g.stream_write"):
        values = _stream_expand_write(
            open_sink, chunks, CH, recon, parameters, gll_points,
            old_values, solid, gradient,
        )
    return values


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
    open_sink, chunks, CH, recon, parameters, gll_points, old_values, solid,
    gradient,
):
    """Pipelined device->host pull + host expansion + write-back.

    The host expansion (recon gather + [E, n, P] -> [E, P, n] relayout +
    fluid repair + write) starts on the elements whose unique values have
    landed while the later chunks are still being copied (``_start_pull``).
    ``chunks`` must stay alive until this returns; they do, as arguments.

    Streaming needs ``max(recon[:m])`` monotone in ``m`` -- guaranteed
    when the dedup used order_by="first" (ops.dedup).  Any other recon
    (e.g. an externally built stored_array) degrades gracefully: the
    element boundaries collapse toward the final chunk and the write
    simply happens after the full pull, bit-identically.
    """
    n_elem = old_values.shape[0]
    n_par = len(parameters)
    U = sum(int(c.shape[0]) for c in chunks)

    # last element writable after chunk j: cumulative max unique id per
    # element prefix vs pulled-row watermark (j+1)*CH
    elem_max = np.maximum.accumulate(
        recon.reshape(n_elem, gll_points).max(axis=1)
    )
    limits = [min((j + 1) * CH, U) for j in range(len(chunks))]
    e_bounds = np.searchsorted(elem_max, limits, side="left")
    e_bounds[-1] = n_elem

    sink = open_sink(parameters)
    values = np.empty((n_elem, n_par, gll_points), np.float64)
    blk = max(1, (1 << 25) // max(1, n_par * gll_points * 8))
    vals_host, wait = _start_pull(chunks, CH)

    pbar = _progress(n_elem, "write-back", unit="elems",
                     n_steps=-(-n_elem // blk))
    prev_e = 0
    for j in range(len(chunks)):
        wait(j)
        # expand/repair/write all elements newly covered by chunk j.  The
        # expansion converts to f64 in the same pass -- fluid /
        # reverted-solid elements then keep their original values
        # BIT-exactly, and the dataset is f64 anyway.
        for s in range(prev_e, int(e_bounds[j]), blk):
            e = min(s + blk, int(e_bounds[j]))
            rb = recon[s * gll_points : e * gll_points]
            block = np.asarray(
                vals_host[rb]
                .reshape(e - s, gll_points, n_par)
                .transpose(0, 2, 1),
                dtype=np.float64, order="C",
            )  # [blk, P, n]
            if not gradient:
                block = repair_fluid_solid(
                    block, old_values[s:e], solid[s:e], parameters
                )
            values[s:e] = block
            sink[s:e] = block
            pbar.step(e - s)
        prev_e = int(e_bounds[j])
    pbar.close()
    return values
