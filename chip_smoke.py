"""On-card smoke run of multimesh_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py

needs one NVIDIA GPU (Hopper, sm_90a) and ``nvcc``; it builds the CUDA
kernels of ``multimesh_tpu_torch/csrc`` itself.  Phases, one JSON line
each on stdout:

1. device and build: ``nvidia-smi`` name and power limit, torch / CUDA
   versions, the kernel build time, and ``nvcc -Xptxas -v``'s registers,
   spill bytes and shared memory of every kernel instantiation;
2. K2 (nearest centroid) against its plain PyTorch twin on one 262,144-
   query chunk of the ``gll`` configuration;
3. K1 (Newton rows) against its twin on 262,144 rows at 4/3, timed, and
   its order-1 use as the scan's prefilter;
4. K4 (f64 polish) against its twin on 262,144 accepted K1 solves of
   phase 3, and on known refs, timed;
5. K5 (pair apply) against its twin on 262,144 rows, 3 parameters,
   order 4, 3-D, and on the apply's 1,048,576-row chunk; then
   (``phase_orders``) K1, K4 and K5 against their twins at every
   (order, dim) pair they are built for, orders 1-7 in 2-D and 3-D, on
   65,536 rows each (3-D: the ``gll`` shell at that order; 2-D: a
   warped 64 x 64 box, at 4/2 the ``grid2d`` source), with each one's
   time, its grouping's and its kernel's, and its bound; and one
   ``TransferOperator.build`` + ``apply`` at orders 3 and 6 on the
   ``gll`` shell at that order for the slice's first 1,000,000 targets,
   3 parameters, f32 and with the df32 polish: the polished values
   < 1e-6 against the analytic field, the f32 ones within 2e-6 of them
   (at order 6 the f32 path alone reaches ~1.1e-6);
6. the slice: ``TransferOperator.build(...).apply(...)`` at the ``gll``
   configuration -- an order-4 spherical-shell source of 4,096 elements,
   10,000,000 targets, 3 parameters, snap fallback -- once to warm up and
   once timed, with launch counts, accuracy against the analytic field
   and the first chunk against the plain path on the card;
7. the df32 slice: the same with ``LocateConfig(df32_polish=True)``
   (K1, K2, K4, K5), warm and timed, held to max rel err < 1e-8, its
   first chunk against the plain twins; then ``f64_polish=True`` once;
   then (``phase_f64``) ``Precision.F64`` on the first 262,144 targets:
   f64 refs, < 1e-8 against the analytic field, bit for bit the same
   call with ``f64_polish=True``;
8. the flagship options (``gll_2_gll``'s locate call): 2% of the
   targets lifted just above the source's outer surface, ``fixed_ref``,
   ``use_aabb``, ``prefilter_m=4``, ``accept_tol=1.04``, df32 polish;
   the retried rows against the plain path; then 1M of those targets
   through ``strategy="scan"`` and its trilinear prefilter (K1 at order
   1);
9. the dedup (``phase_dedup``): ``dedup_first`` on the card at the
   ``mesh_new_1m`` benchmark cell's target (``shell_mesh(20, 20, 20,
   order=4)`` rotated, 1,000,000 slots) and at the file target below
   (9,925,250 slots): unique rows and recon bit for bit the host path's
   ``unique_points(order_by="first")``; its ms, the wrapper's
   (``unique_points_device``: upload, grouping, recon pulled) and the
   host path's; then KF (``phase_fingerprint``, the content
   fingerprint's weighted-sum kernel) at the ``mesh_new_1m`` and
   ``mesh_new_10m`` cells' targets: its four sums, twice, bit for bit
   its plain twin's and the host's numpy layer 1,
   ``content_fingerprint_device`` equal to ``content_fingerprint``, the
   kernel's time, its twin's, its bound and the two fingerprints' walls;
   then the file path: ``api.gll_2_gll`` file to
   file at the ``gll_file``
   configuration -- the same source with VP, VS, RHO and z_node_1D onto
   an order-4 shell target of 79,402 elements (9,925,250 GLL slots,
   ~5.2M unique points) -- first, warm, from a ``stored_array`` cache,
   with ``MMT_DF32_POLISH=1`` and once under ``MMT_PROFILE=1`` for the
   stage seconds (a first and a warm call); every written parameter
   against its analytic value, the calls bit for bit against each other
   and against the operator built and applied in memory (f32 and
   polished), and K5 against its twin on the polished operator's own
   rows with the file's 4 fields, in the apply's chunks; the target's
   rows grouped on the card (counter ``dedup.card_rows``) in the
   profiled first call, not in the warm one, nor in the stored hit with
   the dedup's caches emptied (it reads ``recon.npy``; profiled too);
   KF launched in the first and the df32 call, and in the profiled first
   call every head byte of the target and the (writable) source summed
   on the card, once, none on the host (``fingerprint.*`` counters);
   the result expanded on the card (counter ``expand.card_slots``, every
   slot, in the profiled calls; span ``g2g.expand`` inside
   ``g2g.stream_write``, both reported) and the warm call pinning no new
   host memory (``num_host_alloc`` of the caching host allocator).
   Without ``h5py`` (decided by the import alone) the same arrays go
   through ``engine.transfer_arrays`` with a numpy sink, and the line
   says ``"h5py": false``.

10. the grid route (``phase_big``): the same build + apply at the
   ``gll_big`` shape -- an order-4 shell source of 80 x 78 x 80 = 499,200
   elements (62.4M GLL nodes), the same 10,000,000 targets, 3 parameters,
   snap fallback -- where every search probes the balanced-bin index of
   ``search/grid.py``: the prep and the index (built, then hit on the
   frozen lattice), ``nearest_member`` and ``grid_knn`` against the exact
   kNN, K1 against its twin on round 1's sparse rows (nearly every row
   its own element) with and without its grouping, one warm-up and three
   timed runs of the slice, its first chunk against the plain path, and
   the slice once more with the df32 polish (K1, K4, K5); every column
   of both runs against its analytic field, the df32 run's first chunk
   against the plain twins (pair refs and all 3 columns), and K4 and K5
   against their twins on that chunk's own sparse rows.

11. the Exodus transfer (``phase_exodus``): ``engine.exodus_2_exodus``
   file to file (``scipy`` only) from an order-1 shell of 48 x 48 x 44 =
   101,376 hexes onto the 97,336 nodes of a 45 x 45 x 45 shell inside it,
   VP; first and warm, no missing point, the written values against the
   plain path (rtol 1e-5) and the analytic field; where ``click``
   imports, ``python -m multimesh_tpu_torch.cli
   interpolate-mesh-a-to-b`` in a subprocess on the same files, its
   output file byte for byte the engine call's (else ``"click":
   false``); then (``phase_native``) the native host runtime, built from
   ``native/src/mmt_native.cpp``, against the plain path on a
   20,000-point candidate scan;
12. Exodus -> GLL (``phase_exodus_gll``): a 40 x 40 x 36 = 57,600-hex
   source written as an Exodus file and read back, onto the file path's
   GLL target (9,925,250 slots, read as f32), VP, VS, RHO, through
   ``engine.exodus_2_gll_arrays`` with a numpy sink (``"h5py": false``:
   the HDF5 wrapper is not what runs here): first, three warm walls, the
   stage seconds of one call under ``MMT_PROFILE=1``, the sink bit for
   bit against the operator built in memory, the first chunk against the
   plain path, and K1 at order 1 against its twin on that chunk's rows
   and on 262,144 slots spread over the target (sparse ids over the
   57,600 hexes);
13. the layered path (``phase_layered``): ``engine.gll_2_gll_layered`` on
   live mesh objects -- the ``gll`` source with 4 layers of 1,024
   elements onto an order-4 target of 37 x 37 x 60 = 82,140 elements
   (10,267,500 slots) whose 4 layer interfaces coincide with the
   source's, 4 parameters, per-layer dedup -- warm-up and three timed
   calls, every parameter against its analytic value (< 1e-6), each
   layer's operator against one built directly on that layer's arrays
   and the first chunk of that one against the plain path, once with
   ``MMT_DF32_POLISH=1`` (K1, K2, K4, K5; < 1e-8; the same per-layer
   comparisons, the plain twins held to 1e-10) and once through
   ``gll_2_gll_layered_multi_two`` (snap, tolerance 1.05);
14. the point queries (``phase_points``): ``engine.extract_regular_grid``
   on the ``gll`` source for a 216^3 = 10,077,696-point lat/lon/depth
   grid that overhangs the shell on every side, 3 parameters, sentinel:
   zeros exactly on the rows outside, < 1e-6 inside, the retry's rows
   and share of the wall, one chunk from the middle of the grid against
   the plain path (sentinel and scan retry included); the grid written
   by ``RegularGridData.to_netcdf(format="NETCDF3_64BIT")`` (scipy) and
   read back with ``scipy.io.netcdf_file``, every variable and coordinate
   equal; then ``bench.py``'s ``grid2d`` shape (a 2-D
   order-4 24 x 24 warped box, 512 x 512 points) for K1 at 4/2;
15. the entries no other phase calls (``phase_entries``), each with
   ``device`` omitted as a user calls it, so on ``cuda``: first call,
   three warm ones (the two layered entries one), launches, peak memory,
   one ``entries`` line each.  Inside the file path's block, onto its
   target (``phase_entries_mesh``): (a) ``api.interpolate_to_mesh`` from
   the ``gll`` source as a live mesh with VSV, VSH, VPV, VPH onto the
   9,925,250 nodes, both lattices sphere-mapped in place and restored bit
   for bit, the attached fields < 1e-6; (b) ``map_to_ellipse`` from that
   source stretched by WGS84's first-order ellipticity
   (``testing.elliptic_mesh``) onto a writable copy of the target's
   lattice, its radius ratio < 1e-6 of 1 + eps, the base restored; both
   with their first chunk against the plain path on the sphere-mapped
   points (values, rtol 1e-5).  After the point queries: (c)
   ``get_element_weights`` on the slice's first 1,000,000 targets with
   the mesh's own centroids (bit for bit ``TransferOperator.build``'s
   elements and coefficients), with the centroids moved a tenth of an
   element toward the centre (snap off and on; K2's sources recorded:
   the given ones), again with the own ones (bit for bit the first), and
   polished (K4, < 1e-8); (d) ``get_element_weights_layered`` on the
   layered target's 4 x 1,354,261 unique points with each layer's exact
   20 nearest masked centroids as candidates (K2 not launched, no fewer
   rows found than an unconstrained build); (e)
   ``interpolate_to_points_layered`` onto live layered meshes, the
   source's innermost layer fluid, ``layers="all"`` and ``"nocore"``
   (3 layers written, the 4th kept), its printed failures the operators'
   missing rows, within 2e-6 of ``gll_2_gll_layered``'s values of phase
   13; (f) ``gll_2_points_arrays``, the core of ``query_model`` and
   ``gll_2_exodus``, at 1,000,000 lat/lon/depth points inside the shell
   and at the 97,336 nodes of phase 11's target, < 1e-6, first chunk
   against the plain path;
16. the sharded schemes (``phase_sharded``, after the entries and
   before the ``gll_big`` source is built), at ``bench.py``'s ``sharded``
   config (the ``gll`` source, the same 10,000,000 device-resident
   targets, 3 parameters, snap, ``device_out=True``): (a)
   ``sharded_transfer`` on the one-rank nccl group of ``make_mesh(1)``,
   one warm-up and three timed calls, every column < 1e-6 against
   ``smooth_field``, bit for bit against ``TransferOperator`` on the same
   inputs (or the differing rows counted and held to rtol 1e-6), K1 and K2
   launches those of the slice, peak memory; (b) 2 gloo ranks sharing
   the card through ``launch.run_ranks`` (exchanges staged on the host):
   ``sharded_transfer`` and ``source_sharded_transfer`` with sentinel and
   with snap, three timed calls each, held to (a) at rtol 1e-6 and to
   the analytic field, the sentinel run's found count the operator's; per
   rank its rows, pass-2 window, misses, overflow, K1 / K2 launches,
   walls and exchange seconds; then, in this process, the routing owners
   of the first 262,144 points against the twin of K2 and rank 0's pass 1
   on its first 262,144 points against the plain path.
17. the plotting entries (``phase_viz``, after ``phase_big``, on its
   ``gll_big`` source): a depth slice of 1000 x 1000 lat/lon points at
   1,000 km over the shell's own extent and a cross section of 201 radii
   x 301 points at ``plot_cross_section``'s defaults between two points
   inside it, through ``api.plot_depth_slice`` / ``plot_cross_section``
   into a temporary directory where matplotlib imports, else through the
   sampling and interpolation helpers those entries call
   (``"matplotlib": false``); a warm-up and three timed calls each, K1's
   launches, the share of points inside, the values inside < 1e-6
   against ``smooth_field_torch`` and one chunk against the plain path.

Then a ``{"kernels": [...]}`` line (per kernel its time, its plain
twin's, its bound -- see ``bound`` -- and its launches in the df32
slice's run, as ``launches_file`` in the file path's df32 call (KF's
there alone, its time at the ``mesh_new_10m`` target), as
``launches_big`` in the grid route's df32 run, and as ``launches_exodus``,
``launches_exodus_gll``, ``launches_layered`` (its df32 call),
``launches_points`` and ``launches_grid2d`` in phases 11-14,
``launches_entries`` (per entry of phase 15, its last call; the polished
``get_element_weights`` call apart), ``launches_sharded`` in (a) of
phase 16, ``launches_f64``,
``launches_orders`` (the order-3 and order-6 transfers) and
``launches_viz`` (the depth slice); ``orders``: per (order, dim) pair
its ``ms``, ``group_ms``, ``kernel_ms`` and bound; K1 also with
its order-1 times on the Exodus -> GLL path's first chunk
(``*_order1_chunk``) and on rows spread over its source
(``*_order1_sparse``),
K5 also with ``max_rel_diff_file`` against its twin on that call's
inputs, K4 with ``max_abs_diff_big`` and K5 with ``max_rel_diff_big``
against their twins on the first chunk of the grid route's df32 run; the times of K1, K4 and K5 include their grouping pre-pass,
also timed alone as ``group_ms``, and K4's and K5's kernel alone as
``kernel_ms``) and, last, the ``{"ok": true, ...}`` line.  Any
failed check raises: the script exits non-zero and prints no ``ok``
line, as it does without a CUDA device.

    python3 chip_smoke.py --profile

runs phase 1 and then, instead of the checks, times the slice, df32
slice, f64_polish slice, flagship, scan, file, Exodus -> GLL, layered,
regular-grid and ``gll_big`` slice runs warm and profiles each once with
``torch.profiler`` (see ``profile``).
"""
import argparse
import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch
import torch.distributed as dist

from multimesh_tpu_torch import (TransferOperator, _build, engine, hashing,
                                 testing, utils, utils_profile)
from multimesh_tpu_torch import api
from multimesh_tpu_torch.config import (PREFILTER_M, R_EARTH_M, LocateConfig,
                                        Precision)
from multimesh_tpu_torch.io import exodus as eio
from multimesh_tpu_torch.ops import dedup, spherical
from multimesh_tpu_torch.ops import layers as layer_ops
from multimesh_tpu_torch.search import locate as _locate
from multimesh_tpu_torch.core import gll, shape
from multimesh_tpu_torch.search import grid, knn, nearest, newton, polish
from multimesh_tpu_torch.dist import launch, sharding

ROWS = 262_144  # one locate chunk
N_TARGETS = 10_000_000
ITERS = 18  # newton_iters + polish_iters of the default LocateConfig
CONV_TOL = 1e-4  # the ladder's f32 convergence threshold
ACCEPT_TOL = LocateConfig().accept_tol
# the slice's locate configuration; the df32 slice adds the polish
SLICE_CFG = LocateConfig(nelem_to_search=20, precision=Precision.MIXED)
DF32_CFG = dataclasses.replace(SLICE_CFG, df32_polish=True)
# gll_2_gll's locate call (the flagship options)
FLAGSHIP_CFG = dataclasses.replace(DF32_CFG, accept_tol=1.04)
FLAGSHIP_KW = dict(fallback="fixed_ref", use_aabb=True, prefilter_m=4)
N_SCAN = 1_000_000  # targets of the strategy="scan" run
APPLY_CHUNK = 1_048_576  # rows of one apply chunk (TransferOperator.apply)
# the file path reads and writes HDF5 where h5py is installed; where it is
# not, the same arrays take engine.transfer_arrays with a numpy sink
HAVE_H5PY = importlib.util.find_spec("h5py") is not None
FILE_PARAMS = ("VP", "VS", "RHO")
# the gll_big source: 80 x 78 x 80 = 499,200 elements of order 4
BIG_SHELL = dict(n_lat=80, n_lon=78, n_rad=80, order=4)
N_BIG_KNN = 8_192  # rows of the grid_knn check (and of a rescue launch)
# phase_orders: rows of each kernel's check per (order, dim) pair, and the
# 3-D orders and targets of its transfers
ORDER_ROWS = 65_536
ORDER_TRANSFERS = (3, 6)
ORDER_TARGETS = 1_000_000
# Exodus -> Exodus (bench.py's ``exodus`` shape): 101,376 hexes, 97,336 nodes
EXO_SRC = dict(n_lat=48, n_lon=48, n_rad=44, order=1)
EXO_TGT = dict(n_lat=45, n_lon=45, n_rad=45, order=1, r_inner=3.7e6,
               r_outer=6.2e6, lat_extent=(0.58, 1.12),
               lon_extent=(0.38, 1.32))
# Exodus -> GLL (bench.py's ``exodus_gll`` source): 57,600 hexes
E2G_SRC = dict(n_lat=40, n_lon=40, n_rad=36, order=1)
EXO_CFG = LocateConfig(nelem_to_search=20, accept_tol=1.025,
                       fallback_max=1.5)  # engine._exodus_operator's
# the layered pair: 4 layers whose interfaces coincide (same radial
# extent, both radial counts multiples of 4)
LAYERED_SRC = dict(n_lat=16, n_lon=16, n_rad=16, order=4, n_layers=4)
LAYERED_TGT = dict(n_lat=37, n_lon=37, n_rad=60, order=4, n_layers=4,
                   lat_extent=(0.55, 1.15), lon_extent=(0.35, 1.35))
LAYERED_PARAMS = ("VP", "VS", "RHO", "QMU")
# the regular grid (lat deg, lon deg, depth m; 216^3 points) around the
# gll source, which spans lat 21.2..61.4, lon 17.2..80.2, depth 0..2.891e6
GRID_LAT, GRID_LON = (15.0, 68.0, 216), (10.0, 88.0, 216)
GRID_DEPTH = (-1.0e5, 3.0e6, 216)
# bench.py's ``grid2d`` shape
GRID2D_SRC = dict(shape=(24, 24), order=4, warp=0.05)
GRID2D_N = 512
# phase_viz on the gll_big source: a depth slice of VIZ_NUM^2 points over
# the shell's own extent (colatitude 0.5..1.2 rad, longitude 0.3..1.4 rad,
# in degrees) and a cross section at plot_cross_section's defaults between
# two points inside it
VIZ_PARAM = "VSV"
VIZ_DEPTH_KM = 1000.0
VIZ_NUM = 1000
VIZ_LAT = (90.0 - float(np.rad2deg(1.2)), 90.0 - float(np.rad2deg(0.5)))
VIZ_LON = (float(np.rad2deg(0.3)), float(np.rad2deg(1.4)))
VIZ_XSEC = dict(point_1_lat=30.0, point_1_lng=25.0, point_2_lat=52.0,
                point_2_lng=72.0)
VIZ_NRADS, VIZ_NPOINTS, VIZ_MAX_DEPTH_KM = 201, 301, 2800.0
# phase_entries: interpolate_to_mesh's default parameters; the slice's
# first targets for get_element_weights, whose search centroids are also
# moved by a tenth of an element's radial extent toward the shell's
# centre; lat/lon/depth query points (deg, deg, m) strictly inside the
# gll source (lat 21.25..61.35, lon 17.19..80.21, depth 0..2.891e6)
ENTRY_PARAMS = ("VSV", "VSH", "VPV", "VPH")
ENTRY_WEIGHT_ROWS = 1_000_000
CENTROID_SHIFT = 0.1
ENTRY_QUERY_N = 1_000_000
ENTRY_LLD = ((22.0, 61.0), (18.0, 80.0), (1.0e3, 2.88e6))
# the sharded schemes' second part: ranks sharing the one card (gloo)
SHARDED_RANKS = 2
SHARDED_TIMEOUT_S = 300
# published peaks of one H100 SXM (NVIDIA's data sheet; at 700 W): f32 and
# f64 outside the tensor cores, HBM3
PEAK_F32, PEAK_F64, PEAK_BYTES = 67e12, 34e12, 3.35e12
# the kernels of csrc/ (K1 with its grouping pre-pass, K2, K4, K5),
# listed by --profile whatever their rank
PORT_KERNELS = ("newton_rows_kernel", "group_count_kernel",
                "group_scan_tiles_kernel", "group_scan_kernel",
                "group_scatter_kernel",
                "nearest_centroid_kernel", "polish_pairs_kernel",
                "apply_pairs_kernel", "content_sums_kernel")
# phase_dedup: the mesh_new_1m cell's target (its rotation drawn from the
# cell's +-0.05 rad)
DEDUP_MESH_NEW = dict(n_lat=20, n_lon=20, n_rad=20, order=4, r_inner=3.7e6,
                      r_outer=6.2e6, lat_extent=(0.58, 1.12),
                      lon_extent=(0.38, 1.32))
DEDUP_ANGLE = 0.03


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def reset_launches():
    """Every kernel's launch count to 0, just before a path is driven."""
    newton.newton_rows.launches = 0
    newton.newton_rows.launches_order1 = 0
    nearest.nearest.launches = 0
    polish.polish_pairs.launches = 0
    polish.apply_pairs.launches = 0
    hashing.layer1_sums.launches = 0


def read_launches():
    return {"newton_rows": newton.newton_rows.launches,
            "newton_rows_order1": newton.newton_rows.launches_order1,
            "nearest_centroid": nearest.nearest.launches,
            "polish_pairs": polish.polish_pairs.launches,
            "apply_pairs": polish.apply_pairs.launches,
            "content_sums": hashing.layer1_sums.launches}


def card_rows():
    """Rows the dedup grouped on the card since ``reset_stages()``
    (counter ``dedup.card_rows``; counted under ``MMT_PROFILE``)."""
    return utils_profile.counter_totals().get("dedup.card_rows", 0)


def expand_counts():
    """The expansion's counters since ``reset_stages()``:
    ``expand.card_slots`` and ``expand.patched_elems``."""
    counters = utils_profile.counter_totals()
    return {k: counters.get(k, 0)
            for k in ("expand.card_slots", "expand.patched_elems")}


def max_rel(vals, truth):
    return float(((vals.double() - truth).abs() / truth.abs()).max())


def max_rel_columns(vals, truth):
    """``max_rel`` of each column i of ``vals`` against the i-th field of
    the runs, ``truth * (1 + 0.1 i)``."""
    return [max_rel(vals[:, i], truth * (1 + 0.1 * i))
            for i in range(vals.shape[1])]


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, after
    one warm-up call (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def bound(flop, peak, nbytes):
    """The least time the card could take for a call: the larger of its
    operations over the peak rate of their type and its bytes (each input
    read once, each output written once) over the memory rate, as
    (bound_ms, "operations" | "bytes")."""
    op_ms, byte_ms = flop / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (op_ms, "operations") if op_ms >= byte_ms else (byte_ms, "bytes")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def sumfact_fmas(order, dim, jac):
    """FMAs of one sum-factorised evaluation of one component over the
    order-``order`` lattice (over k, then j, then i): the value alone, or
    with ``jac`` the value and its ``dim`` derivatives.  The least work of
    such an evaluation; the 1-D bases and a Newton solve, under a tenth
    of it, are left out, so a bound from it slightly underestimates."""
    n = order + 1
    if dim == 3:
        return 2 * n**3 + 3 * n**2 + 4 * n if jac else n**3 + n**2 + n
    return 2 * n**2 + 3 * n if jac else n**2 + n


def newton_bound(args, refs, res):
    """K1's bound: per row, ``iters`` evaluations of x and J and one of x
    for the residual, d components each, 2 FLOP an FMA, in f32; the bytes
    of the rows and of the lattice, centre and scale of each element that
    occurs among them, once."""
    points, ids, ctr, inv_scale, nodes, order, dim, iters, _ = args
    per_row = dim * (iters * sumfact_fmas(order, dim, True)
                     + sumfact_fmas(order, dim, False))
    E = ctr.shape[0]
    occur = int(torch.unique(ids[(ids >= 0) & (ids < E)]).numel())
    per_elem = nbytes(ctr, inv_scale, nodes) // E
    return bound(2 * per_row * points.shape[0], PEAK_F32,
                 nbytes(points, ids, refs, res) + occur * per_elem)


def ptxas_table(log):
    """``nvcc -Xptxas -v``'s report per kernel instantiation, as
    {"name order/dim": [registers, spill store bytes, spill load bytes,
    static shared bytes]} (the grouping's kernels under their own names)."""
    table, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '_Z\w*?(\d+)"
                          r"([a-z_]+_kernel)(?:ILi(\d)ELi(\d)E)?", line)
        if entry:
            name = entry.group(2)
            if entry.group(3):
                name += f" {entry.group(3)}/{entry.group(4)}"
            table[name] = [None, 0, 0, 0]
        elif name and "spill stores" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes spill", line)]
            table[name][1:3] = nums
        elif name and "Used" in line and "registers" in line:
            table[name][0] = int(re.search(r"Used (\d+) registers",
                                           line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            table[name][3] = int(smem.group(1)) if smem else 0
    return table


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    nvcc = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True).stdout
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    emit({"phase": "ptxas", "kernels": ptxas_table(_build.build_log)})
    emit({"phase": "device", "nvidia_smi": smi,
          "gpu": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc.strip().splitlines()[-1],
          "triton": importlib.util.find_spec("triton") is not None,
          "build_s": build_s})
    return smi


def phase_nearest(dev, centroids, queries):
    """K2 against its twin: picks distance-equivalent, mostly identical."""
    k_idx = nearest.nearest(queries, centroids)
    p_idx = nearest.nearest_centroid_ref(queries, centroids)
    torch.cuda.synchronize()
    check(bool(((k_idx >= 0) & (k_idx < centroids.shape[0])).all()),
          "K2 index out of range")
    dk = ((queries - centroids[k_idx.long()]) ** 2).sum(-1)
    dp = ((queries - centroids[p_idx.long()]) ** 2).sum(-1)
    # Both rank by the f32 score |c|^2 - 2 q.c on jointly centred
    # coordinates; two evaluations of it differ by a few f32 ulp of
    # |q|^2 + |c|^2, so near-ties inside that band may swap.
    center = centroids.mean(dim=0)
    band = 4 * 2.0 ** -24 * float(
        ((queries - center) ** 2).sum(-1).max()
        + ((centroids - center) ** 2).sum(-1).max())
    excess = (dk - dp).abs() - 1e-5 * dp
    same = float((k_idx == p_idx).double().mean())
    check(float(excess.max()) <= band,
          f"K2 pick farther than rtol 1e-5 + {band:.3g} m^2")
    check(same >= 0.999, f"K2 identical picks {same:.6f} < 0.999")
    ms = cuda_ms(lambda: nearest.nearest(queries, centroids), 20)
    plain_ms = cuda_ms(
        lambda: nearest.nearest_centroid_ref(queries, centroids), 5)
    rel = float(((dk - dp).abs() / dp.clamp_min(1.0)).max())
    C, d = queries.shape
    E = centroids.shape[0]
    # d FMAs a (query, centroid) pair, f32; f64 inputs, int32 picks
    bound_ms, bound_by = bound(2 * d * C * E, PEAK_F32,
                               nbytes(queries, centroids, k_idx))
    emit({"phase": "K2", "rows": C, "sources": E, "identical": same,
          "max_rel_d2_diff": rel, "band_m2": band, "ms": ms,
          "plain_ms": plain_ms, "bound_ms": bound_ms,
          "bound_share": bound_ms / ms})
    return {"name": "nearest_centroid", "route": "cuda",
            "source": "multimesh_tpu_torch/csrc/nearest_centroid.cu",
            "replaces": "multimesh_tpu/search/pallas_argmin.py:68",
            # metres between the distances to the two picks
            "max_abs_err": float((dk.sqrt() - dp.sqrt()).abs().max()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by,
            # cdist + argmin is two calls; no single one picks the nearest
            "library_ms": None}


def _newton_rows(mesh, pts, dev, seed, rows=ROWS):
    """``rows`` (point, element) rows: the nearest-centroid element of
    each point, with 10% of the ids replaced by random elements."""
    order, dim = mesh.order, mesh.dim
    prep = _locate._mesh_prep(mesh.points, order, dev)
    p = torch.as_tensor(pts[:rows], device=dev)
    ids = nearest.nearest_centroid_ref(p, prep.centroids)
    rng = np.random.default_rng(seed)
    wild = torch.as_tensor(rng.random(rows) < 0.1, device=dev)
    rand = torch.as_tensor(rng.integers(0, mesh.nelem, rows, dtype=np.int32),
                           device=dev)
    ids = torch.where(wild, rand, ids).contiguous()
    return (p, ids, prep.ctr, prep.inv_scale, prep.nodes, order, dim, ITERS,
            LocateConfig().newton_clamp)


def extrapolation_tol(order, t):
    """The bound on K1's converged refs against its twin's beyond the
    element, up to |ref| ``t``: 1e-4 through order 4, and above it 1e-4
    times the growth of the GLL Lebesgue function sum |l_i(t)| over its
    order-4 value.  Outside [-1, 1] f32 rounding in x(ref) is amplified
    by that sum (24 at order 4, 167 at 6, 439 at 7 for t = 1.5), so the
    two summation orders part further there; inside the element
    (accepted rows) both stay within 1e-5 at every order."""
    ref = torch.tensor([t], dtype=torch.float64)

    def growth(p):
        return float(gll.lagrange_eval(p, ref).abs().sum())

    return 1e-4 * max(1.0, growth(order) / growth(4))


def _k1_case(mesh, args):
    """K1 against its twin on ``args``, checked: acceptance agreement,
    agreement on converged rows below |ref| ``fallback_max``, accepted
    refs to 1e-5.  Returns (record, refs, residuals, max accepted ref
    difference)."""
    k_ref, k_res = newton.newton_rows(*args)
    p_ref, p_res = newton.newton_refs_rows_ref(*args)
    torch.cuda.synchronize()
    kc, pc = k_res < CONV_TOL, p_res < CONV_TOL
    ka = kc & (k_ref.abs().amax(-1) < ACCEPT_TOL)
    pa = pc & (p_ref.abs().amax(-1) < ACCEPT_TOL)
    acc_agree = float((ka == pa).double().mean())
    # "usable": converged with max |ref| < fallback_max (1.5), the
    # widest band any fallback reads refs from.  Beyond it (rows of
    # random far elements) the f32 residual plateau grows with
    # |ref|^order up to the threshold, so convergence there may flip
    # with summation order: reported, not held to a bound.
    fb_max = LocateConfig().fallback_max
    k_mag, p_mag = k_ref.abs().amax(-1), p_ref.abs().amax(-1)
    ku, pu = kc & (k_mag < fb_max), pc & (p_mag < fb_max)
    usable_agree = float((ku == pu).double().mean())
    conv_agree = float((kc == pc).double().mean())
    both_a = ka & pa
    both_c = kc & pc
    tag = f"{mesh.order}/{mesh.dim}"
    check(bool(both_a.any()), f"K1 {tag}: no row accepted")
    diff = (k_ref - p_ref).abs().amax(-1)
    err_acc = float(diff[both_a].max())
    by_band = {}
    for lo, hi in ((0.0, ACCEPT_TOL), (ACCEPT_TOL, fb_max), (fb_max, 4.0),
                   (4.0, 9.0)):
        sel = both_c & (p_mag >= lo) & (p_mag < hi)
        by_band[f"{lo:g}-{hi:g}"] = [
            int(sel.sum()), float(diff[sel].max()) if sel.any() else 0.0]
    rec = {"rows": int(args[0].shape[0]),
           "accepted": float(ka.double().mean()),
           "accept_agree": acc_agree, "usable_agree": usable_agree,
           "conv_agree": conv_agree, "max_abs_err_accepted": err_acc,
           "converged_rows_and_max_err_by_ref": by_band}
    check(acc_agree >= 0.9999, f"K1 {tag} acceptance agreement "
          f"{acc_agree:.6f} < 0.9999")
    check(usable_agree >= 0.9999, f"K1 {tag} agreement on converged "
          f"rows below |ref| {fb_max} is {usable_agree:.6f} < 0.9999")
    check(err_acc <= 1e-5, f"K1 {tag} accepted refs differ by "
          f"{err_acc:.3g} > 1e-5")
    near = by_band[f"{ACCEPT_TOL:g}-{fb_max:g}"][1]
    near_tol = extrapolation_tol(mesh.order, fb_max)
    rec["near_tol"] = near_tol
    check(near <= near_tol, f"K1 {tag} converged refs below |ref| {fb_max} "
          f"differ by {near:.3g} > {near_tol:.3g}")
    return rec, k_ref, k_res, err_acc


def phase_newton(dev, gll_mesh, gll_pts):
    """K1 against its twin at the main path's shape (4/3, ROWS rows),
    timed, and its order-1 use as the scan's prefilter.  Returns the
    kernels-line entry and (mesh, args, refs, res) for phase 4."""
    args = _newton_rows(gll_mesh, gll_pts, dev, seed=10)
    rec, k_ref, k_res, err_acc = _k1_case(gll_mesh, args)
    emit({"phase": "K1", "order_dim": "4/3", **rec})
    ms = cuda_ms(lambda: newton.newton_rows(*args), 10)
    group_ms = cuda_ms(lambda: newton.group_rows(args[1], gll_mesh.nelem), 10)
    plain_ms = cuda_ms(lambda: newton.newton_refs_rows_ref(*args), 3)
    bound_ms, bound_by = newton_bound(args, k_ref, k_res)
    emit({"phase": "K1 time", "order_dim": "4/3", "rows": ROWS,
          "ms": ms, "group_ms": group_ms, "plain_ms": plain_ms,
          "bound_ms": bound_ms, "bound_share": bound_ms / ms})
    entry = {"name": "newton_rows", "route": "cuda",
             "source": "multimesh_tpu_torch/csrc/newton_rows.cu",
             "replaces": "multimesh_tpu/search/pallas_newton.py:261",
             "max_abs_err": err_acc, "ms": ms, "group_ms": group_ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by,
             # no PyTorch call inverts a GLL map
             "library_ms": None}
    entry.update(_prefilter_time(dev, gll_mesh, args))
    return entry, (gll_mesh, args, k_ref, k_res)



def _prefilter_time(dev, mesh, args):
    """K3's order-1 use as the scan's prefilter runs it: one launch over
    the 12 nearest candidates of each of ROWS points, 8 steps on the
    element corners; against its twin, both in the solves and in the 4
    columns ``_prefilter_rank`` keeps.  The shell's symmetric neighbours
    tie to an ulp, so kept columns are held equal only where the 4th and
    5th best scores are more than 1e-5 apart, and elsewhere held to the
    same scores."""
    cfg = LocateConfig()
    m = 4
    prep = _locate._mesh_prep(mesh.points, mesh.order, dev)
    pts = args[0]
    cand = knn.knn(prep.centroids, pts, cfg.prefilter_pool)[1]
    pre = (pts.repeat(cand.shape[1], 1), cand.T.reshape(-1), prep.ctr,
           prep.inv_scale, prep.corners, 1, mesh.dim, cfg.prefilter_iters,
           args[8])
    k_ref, k_res = newton.newton_rows(*pre)
    p_ref, p_res = newton.newton_refs_rows_ref(*pre)
    solvers = [_locate._row_solver(prep, prep.corners, 1, mesh.dim,
                                   cfg.prefilter_iters, args[8], plain)
               for plain in (False, True)]
    k_kept, p_kept = (_locate._prefilter_rank(pts, cand, s, m)
                      for s in solvers)
    torch.cuda.synchronize()
    both = (k_res < CONV_TOL) & (p_res < CONV_TOL)
    conv_agree = float(((k_res < CONV_TOL) == (p_res < CONV_TOL))
                       .double().mean())
    err = float((k_ref - p_ref)[both].abs().max())
    # the twin's scores [ROWS, pool], as _prefilter_rank computes them
    score = torch.where(p_res < CONV_TOL, p_ref.abs().amax(-1),
                        float("inf")).view(cand.shape[1], -1).T

    def kept_scores(kept):
        pos = (kept[:, :, None] == cand[:, None, :]).int().argmax(-1)
        return score.gather(1, pos).sort(dim=1).values

    ks, ps = kept_scores(k_kept), kept_scores(p_kept)
    fin = torch.isfinite(ps)
    score_err = float((ks - ps)[fin].abs().max())
    ranked = score.sort(dim=1).values
    clear = (ranked[:, m] - ranked[:, m - 1]).nan_to_num(0.0) > 1e-5
    kept_agree = float((k_kept == p_kept).all(dim=1)[clear].double().mean())
    ms = cuda_ms(lambda: newton.newton_rows(*pre), 10)
    group_ms = cuda_ms(lambda: newton.group_rows(pre[1], mesh.nelem), 10)
    plain_ms = cuda_ms(lambda: newton.newton_refs_rows_ref(*pre), 3)
    bound_ms, bound_by = newton_bound(pre, k_ref, k_res)
    emit({"phase": "K1 time", "order_dim": "1/3 prefilter",
          "rows": int(cand.numel()), "conv_agree": conv_agree,
          "max_abs_err_converged": err, "kept_clear_rows": float(
              clear.double().mean()), "kept_agree_clear": kept_agree,
          "kept_max_score_diff": score_err, "ms": ms, "group_ms": group_ms,
          "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
          "bound_share": bound_ms / ms})
    check(conv_agree >= 0.9999, f"K1 prefilter convergence agreement "
          f"{conv_agree:.6f} < 0.9999")
    check(err <= 1e-5, f"K1 prefilter converged refs differ by {err:.3g} "
          "> 1e-5")
    check(bool((torch.isfinite(ks) == fin).all()) and score_err <= 1e-5,
          f"prefilter kept columns score differently ({score_err:.3g})")
    check(kept_agree >= 0.999, f"prefilter kept columns agree on "
          f"{kept_agree:.6f} < 0.999 of the untied rows")
    return {"ms_order1": ms, "group_ms_order1": group_ms,
            "plain_ms_order1": plain_ms, "bound_ms_order1": bound_ms}


def _k4_case(dev, mesh, args, k_ref, k_res, seed):
    """K4 against its twin, checked: warm starts are the accepted K1
    solves ``k_ref`` of ``args`` (cycled to as many rows), one step as
    the main path runs it; and known refs recovered from the points they
    map to.  Returns (record, the polish's arguments, its outputs, their
    largest pair-ref difference from the twin's)."""
    order, dim = mesh.order, mesh.dim
    n = args[0].shape[0]
    prep = _locate._mesh_prep(mesh.points, order, dev, want64=True)
    acc = torch.nonzero((k_res < CONV_TOL)
                        & (k_ref.abs().amax(-1) < ACCEPT_TOL)).squeeze(1)
    rows = acc[torch.arange(n, device=dev) % acc.shape[0]]
    pargs = (args[0][rows].contiguous(), args[1][rows].contiguous(),
             k_ref[rows].contiguous(), prep.ctr, prep.inv_scale,
             prep.nodes64, order, dim, DF32_CFG.df32_polish_iters)
    hi, lo, ok = polish.polish_pairs(*pargs)
    p_hi, p_lo, p_ok = polish.polish_pairs_ref(*pargs)
    torch.cuda.synchronize()
    ok_agree = float((ok == p_ok).double().mean())
    both = ok & p_ok
    diff = float(((hi.double() + lo.double())
                  - (p_hi.double() + p_lo.double()))[both].abs().max())
    # known refs: the points they map to, warm starts 3e-6 off
    rng = np.random.default_rng(seed)
    refs = torch.as_tensor(rng.uniform(-0.95, 0.95, (n, dim)), device=dev)
    ids = torch.as_tensor(rng.integers(0, mesh.nelem, n, dtype=np.int32),
                          device=dev)
    pts = shape.forward_map(
        order, torch.as_tensor(mesh.points, device=dev)[ids.long()],
        refs).contiguous()
    ref0 = (refs + torch.as_tensor(rng.uniform(-3e-6, 3e-6, (n, dim)),
                                   device=dev)).float().contiguous()
    t_hi, t_lo, t_ok = polish.polish_pairs(pts, ids, ref0, *pargs[3:])
    true_err = float((t_hi.double() + t_lo.double() - refs).abs().max())
    tag = f"{order}/{dim}"
    rec = {"rows": n, "distinct_rows": int(acc.shape[0]),
           "ok": float(ok.double().mean()), "ok_agree": ok_agree,
           "max_abs_diff_vs_twin": diff, "known_refs_max_err": true_err,
           "known_refs_ok": float(t_ok.double().mean())}
    check(ok_agree >= 0.9999, f"K4 {tag} ok agreement {ok_agree:.6f}")
    check(diff <= 1e-11, f"K4 {tag} hi+lo differ by {diff:.3g}")
    check(bool(t_ok.all()), f"K4 {tag} known refs not all ok")
    check(true_err < 1e-10, f"K4 {tag} known refs err {true_err:.3g}")
    return rec, pargs, (hi, lo, ok), diff


def _polish_bound(pargs, outs):
    """K4's bound: per row and step, x and J of d components by sum
    factorisation, 2 FLOP an FMA, in f64; the rows' and elements' bytes
    once.  Also the direct form's, for comparison: per node d + 1 weight
    products and d (d + 1) FMAs.  (bound_ms, bound_by, direct bound_ms)"""
    order, dim, iters = pargs[6], pargs[7], pargs[8]
    rows_n, io = pargs[0].shape[0], nbytes(*pargs[:6], *outs)
    flop = 2 * iters * dim * sumfact_fmas(order, dim, True) * rows_n
    direct = (iters * (order + 1) ** dim
              * (2 * dim * (dim + 1) + dim + 1) * rows_n)
    return (*bound(flop, PEAK_F64, io), bound(direct, PEAK_F64, io)[0])


def phase_polish(dev, solved):
    """K4 against its twin at the main path's shape (4/3, ROWS rows),
    timed."""
    mesh, args, k_ref, k_res = solved
    rec, pargs, outs, diff = _k4_case(dev, mesh, args, k_ref, k_res, seed=30)
    rec.update(_grouped_times(polish.polish_pairs, polish._polish_kernel,
                              pargs, pargs[1], mesh.nelem))
    rec["plain_ms"] = cuda_ms(lambda: polish.polish_pairs_ref(*pargs), 3)
    bound_ms, bound_by, direct_ms = _polish_bound(pargs, outs)
    rec.update(bound_ms=bound_ms, bound_share=bound_ms / rec["ms"],
               bound_ms_direct=direct_ms)
    emit({"phase": "K4", "order_dim": "4/3", **rec})
    return {"name": "polish_pairs", "route": "cuda",
            "source": "multimesh_tpu_torch/csrc/polish_pairs.cu",
            "replaces": "multimesh_tpu/search/pallas_df32.py:318",
            "max_abs_err": diff, "ms": rec["ms"],
            "group_ms": rec["group_ms"], "kernel_ms": rec["kernel_ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by,
            # no PyTorch call takes a Newton step of a GLL map
            "library_ms": None}


def _grouped_times(wrapper, kernel, args, ids, E):
    """A grouped kernel's times: ``ms`` of its wrapper (the grouping and
    the kernel), ``group_ms`` of the grouping alone and ``kernel_ms`` of
    the kernel alone on a grouping made beforehand."""
    perm = newton.group_rows(ids, E)
    return {"ms": cuda_ms(lambda: wrapper(*args), 20),
            "group_ms": cuda_ms(lambda: newton.group_rows(ids, E), 20),
            "kernel_ms": cuda_ms(lambda: kernel(perm, *args), 20)}


def _apply_args(dev, src, fields, rows, seed):
    """Random pair refs in random elements (every 16th row element -1)."""
    rng = np.random.default_rng(seed)
    refs = torch.as_tensor(rng.uniform(-1.0, 1.0, (rows, src.dim)),
                           device=dev)
    hi = refs.float()
    lo = (refs - hi.double()).float()
    el = torch.as_tensor(rng.integers(0, src.nelem, rows, dtype=np.int32),
                         device=dev)
    el[::16] = -1
    return (hi, lo, el, fields, src.order, src.dim)


def _apply_bound(args, out, direct=False):
    """K5's bound: per row and parameter one sum-factorised value, 2 FLOP
    an FMA, in f64; with ``direct`` the direct form, for comparison: per
    lattice node a weight product and an FMA."""
    hi, lo, el, fields, order, dim = args
    per = (3 * (order + 1) ** dim if direct
           else 2 * sumfact_fmas(order, dim, False))
    return bound(per * hi.shape[0] * fields.shape[0], PEAK_F64,
                 nbytes(hi, lo, el, fields, out))


def _apply_rel(args):
    """K5 against its twin: (max relative difference on rows with an
    element, whether -1 rows gave 0, max absolute difference, values)."""
    got = polish.apply_pairs(*args)
    want = polish.apply_pairs_ref(*args)
    torch.cuda.synchronize()
    el = args[2]
    rel = float(((got - want).abs() / want.abs().clamp_min(1e-300))[
        el >= 0].max())
    return (rel, bool((got[el < 0] == 0).all()),
            float((got - want).abs().max()), got)


def phase_apply(dev, src, fields):
    """K5 against its twin: random pair refs in random elements (every
    16th row element -1), the slice's 3 fields, on ROWS rows and on the
    apply's 1,048,576-row chunk."""
    args = _apply_args(dev, src, fields, ROWS, seed=40)
    rel, zeros, err, got = _apply_rel(args)
    times = _grouped_times(polish.apply_pairs, polish._apply_kernel, args,
                           args[2], src.nelem)
    plain_ms = cuda_ms(lambda: polish.apply_pairs_ref(*args), 3)
    bound_ms, bound_by = _apply_bound(args, got)
    big = _apply_args(dev, src, fields, APPLY_CHUNK, seed=41)
    rel_1m, zeros_1m, _, got_1m = _apply_rel(big)
    times_1m = {f"{k}_1m": v for k, v in _grouped_times(
        polish.apply_pairs, polish._apply_kernel, big, big[2],
        src.nelem).items()}
    bound_1m = _apply_bound(big, got_1m)[0]
    emit({"phase": "K5", "rows": ROWS, "params": 3, "order_dim": "4/3",
          "max_rel_diff": rel, "missing_rows_zero": zeros, **times,
          "plain_ms": plain_ms, "bound_ms": bound_ms,
          "bound_share": bound_ms / times["ms"],
          "bound_ms_direct": _apply_bound(args, got, direct=True)[0],
          "rows_1m": APPLY_CHUNK,
          "max_rel_diff_1m": rel_1m, **times_1m, "bound_ms_1m": bound_1m,
          "bound_share_1m": bound_1m / times_1m["ms_1m"]})
    check(rel <= 1e-12, f"K5 values differ by {rel:.3g} relative")
    check(zeros, "K5 element -1 did not give 0")
    check(rel_1m <= 1e-12, f"K5 values (1M rows) differ by {rel_1m:.3g}")
    check(zeros_1m, "K5 element -1 did not give 0 (1M rows)")
    return {"name": "apply_pairs", "route": "cuda",
            "source": "multimesh_tpu_torch/csrc/apply_pairs.cu",
            "replaces": "multimesh_tpu/search/pallas_df32.py:407",
            "max_abs_err": err, **times, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, **times_1m,
            "bound_ms_1m": bound_1m,
            # a gather and an einsum at least: no single call
            "library_ms": None}



def _order_mesh(order, dim):
    """The mesh of an (order, dim) pair in ``phase_orders``: the ``gll``
    shell at that order in 3-D; in 2-D a warped 64 x 64 box, or at 4/2
    ``bench.py``'s ``grid2d`` source."""
    if dim == 3:
        return testing.shell_mesh(n_lat=16, n_lon=16, n_rad=16, order=order)
    if order == 4:
        return testing.box_mesh(**GRID2D_SRC)
    return testing.box_mesh(shape=(64, 64), order=order, warp=0.1)


def _orders_pair(dev, order, dim, pts3, pts2):
    """K1, K4 and K5 against their twins at one (order, dim) pair on
    ORDER_ROWS rows, with their times (the wrapper's ``ms``, the
    grouping's ``group_ms``, the kernel's ``kernel_ms``) and bounds."""
    mesh = _order_mesh(order, dim)
    seed = 100 + 10 * order + dim
    args = _newton_rows(mesh, pts3 if dim == 3 else pts2, dev, seed,
                        rows=ORDER_ROWS)
    rec1, k_ref, k_res, _ = _k1_case(mesh, args)
    rec1.update(_grouped_times(newton.newton_rows, newton._newton_kernel,
                               args, args[1], mesh.nelem))
    rec1["bound_ms"], rec1["bound_by"] = newton_bound(args, k_ref, k_res)
    rec4, pargs, outs, _ = _k4_case(dev, mesh, args, k_ref, k_res, seed)
    rec4.update(_grouped_times(polish.polish_pairs, polish._polish_kernel,
                               pargs, pargs[1], mesh.nelem))
    rec4["bound_ms"], rec4["bound_by"], _ = _polish_bound(pargs, outs)
    base = testing.element_nodal_field(mesh, "smooth")
    fields = torch.as_tensor(np.stack([base * (1 + 0.1 * i)
                                       for i in range(3)]), device=dev)
    aargs = _apply_args(dev, mesh, fields, ORDER_ROWS, seed)
    rel, zeros, _, got = _apply_rel(aargs)
    rec5 = {"rows": ORDER_ROWS, "params": 3, "max_rel_diff": rel,
            "missing_rows_zero": zeros,
            **_grouped_times(polish.apply_pairs, polish._apply_kernel,
                             aargs, aargs[2], mesh.nelem)}
    rec5["bound_ms"], rec5["bound_by"] = _apply_bound(aargs, got)
    tag = f"{order}/{dim}"
    check(rel <= 1e-12, f"K5 {tag} values differ by {rel:.3g} relative")
    check(zeros, f"K5 {tag} element -1 did not give 0")
    for rec in (rec1, rec4, rec5):
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    return {"K1": rec1, "K4": rec4, "K5": rec5}


def phase_orders(dev, smi, gll_pts, pts_d, truth):
    """Every (order, dim) pair the kernels are built for: K1, K4 and K5
    against their twins on ORDER_ROWS rows each (see ``_orders_pair``);
    then ``TransferOperator.build`` + ``apply`` at orders 3 and 6 in 3-D
    on the ``gll`` shell at that order, the first ORDER_TARGETS targets
    of the slice, 3 parameters, on the f32 path and with the df32 polish
    (K4, K5): the polished values < 1e-6 against the analytic field, the
    f32 ones within 2e-6 of them.  Returns {pair: records} and the
    polished transfers' launch counts."""
    rng = np.random.default_rng(1)
    pts2 = rng.uniform(0.0, 1.0, (ORDER_ROWS, 2))
    pairs = {}
    for order in newton.ORDERS:
        for dim in (3, 2):
            tag = f"{order}/{dim}"
            pairs[tag] = _orders_pair(dev, order, dim, gll_pts, pts2)
            emit({"phase": "orders", "order_dim": tag, **pairs[tag]})
    launches = {}
    for order in ORDER_TRANSFERS:
        src = testing.shell_mesh(n_lat=16, n_lon=16, n_rad=16, order=order)
        base = testing.element_nodal_field(src, "smooth")
        fields = torch.as_tensor(np.stack([base * (1 + 0.1 * i)
                                           for i in range(3)]), device=dev)
        targets = pts_d[:ORDER_TARGETS]
        rec = {}
        for name, cfg in (("f32", SLICE_CFG), ("df32", DF32_CFG)):
            run_transfer(src, targets, fields, cfg, dev, fallback="snap")
            reset_launches()
            t0 = time.perf_counter()
            op, vals, build_s, apply_s = run_transfer(
                src, targets, fields, cfg, dev, fallback="snap")
            wall = time.perf_counter() - t0
            rec[name] = {"wall_s": wall, "build_s": build_s,
                         "apply_s": apply_s, "n_retry": op.n_retry,
                         "num_missing": op.num_missing,
                         "launches": read_launches(),
                         "max_rel_err_columns": max_rel_columns(
                             vals, truth[:ORDER_TARGETS])}
            rec[name]["vals"] = vals
        f32_vs_df32 = max_rel(rec["f32"].pop("vals"),
                              rec["df32"].pop("vals"))
        launches[str(order)] = rec["df32"]["launches"]
        emit({"phase": "orders transfer", "nvidia_smi": smi,
              "order": order, "elements": src.nelem,
              "targets": ORDER_TARGETS, "params": 3, **rec,
              "f32_max_rel_diff_vs_df32": f32_vs_df32})
        ran = rec["df32"]["launches"]
        check(ran["newton_rows"] > 0 and ran["polish_pairs"] > 0
              and ran["apply_pairs"] > 0, f"order {order}: launches {ran}")
        rels = rec["df32"]["max_rel_err_columns"]
        check(max(rels) < 1e-6, f"order {order} transfer max rel errs "
              f"{rels} >= 1e-6")
        # f32 refs: values within f32 grade of the polished ones (the
        # order-4 slice's f32 path is within 7.3e-7 of its field)
        check(f32_vs_df32 < 2e-6, f"order {order}: f32 values differ from "
              f"the polished ones by {f32_vs_df32:.3g}")
    return pairs, launches


def run_scan(src, targets, dev):
    """The first N_SCAN ``targets`` through ``strategy="scan"`` with the
    flagship options (the polish runs on the ladder only, so it is left
    out here)."""
    return _locate.locate(
        targets[:N_SCAN], src.points, src.order,
        dataclasses.replace(FLAGSHIP_CFG, df32_polish=False),
        strategy="scan", device=dev, want_weights=False, **FLAGSHIP_KW)


def run_transfer(src, targets, fields, cfg, dev, plain=False, **kw):
    """build + apply, synchronised: (op, vals, build_s, apply_s)."""
    t0 = time.perf_counter()
    op = TransferOperator.build(src.points, targets, order=src.order,
                                cfg=cfg, device=dev, plain=plain, **kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    vals = op.apply(fields)
    torch.cuda.synchronize()
    return op, vals, t1 - t0, time.perf_counter() - t1


def phase_slice(dev, src, pts_d, fields, truth):
    """build + apply at the gll configuration, warm and timed."""
    def run(targets, plain=False):
        return run_transfer(src, targets, fields, SLICE_CFG, dev, plain,
                            fallback="snap")

    run(pts_d)  # warm-up: mesh prep cache, allocator, lazy module loads
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    op, vals, build_s, apply_s = run(pts_d)
    wall = time.perf_counter() - t0
    counts = read_launches()
    launches = {k: counts[k] for k in ("newton_rows", "nearest_centroid")}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the path was not launched: {launches}")
    check(tuple(vals.shape) == (N_TARGETS, 3), f"shape {tuple(vals.shape)}")
    check(bool(torch.isfinite(vals).all()), "non-finite values")
    check(bool(op.found.all()), "snap left a target unassigned")
    rel = max_rel(vals[:, 0], truth)
    check(rel < 1e-6, f"max rel err {rel:.3g} >= 1e-6")

    # the first chunk through the plain twins, on the card
    p_op, p_vals, _, _ = run(pts_d[:ROWS], plain=True)
    same = op.elements[:ROWS] == p_op.elements
    agree = float(same.double().mean())
    check(agree >= 0.999, f"plain path elements agree {agree:.6f} < 0.999")
    v, pv = vals[:ROWS][same], p_vals[same]
    vdiff = float(((v - pv).abs() / pv.abs()).max())
    check(vdiff <= 1e-5, f"plain path values differ by {vdiff:.3g}")
    emit({"phase": "slice", "targets": N_TARGETS, "elements": src.nelem,
          "params": 3, "wall_s": wall, "build_s": build_s,
          "apply_s": apply_s, "mpts_per_s": N_TARGETS / wall / 1e6,
          "n_retry": op.n_retry, "launches": launches,
          "max_rel_err": rel, "peak_mem_gb": peak_gb,
          "plain_elements_agree": agree, "plain_max_rel_diff": vdiff})
    return launches


def phase_df32_slice(dev, src, pts_d, fields, truth):
    """The slice with the df32 polish (K1, K2, K4, K5), warm and timed;
    its first chunk through the plain twins; then f64_polish once."""
    def run(targets, cfg=DF32_CFG, plain=False):
        return run_transfer(src, targets, fields, cfg, dev, plain,
                            fallback="snap")

    run(pts_d)  # warm-up: the prep with the f64 lattice, allocator
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    op, vals, build_s, apply_s = run(pts_d)
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(launches[k] > 0 for k in ("newton_rows", "nearest_centroid",
                                        "polish_pairs", "apply_pairs")),
          f"a kernel of the df32 path was not launched: {launches}")
    check(op.refs_lo is not None, "the df32 polish did not run")
    check(vals.dtype == torch.float64 and tuple(vals.shape) == (N_TARGETS, 3),
          f"values {vals.dtype} {tuple(vals.shape)}")
    check(bool(torch.isfinite(vals).all()), "non-finite values")
    rel = max_rel(vals[:, 0], truth)
    polished = float((op.refs_lo != 0).any(dim=-1).double().mean())

    # the first chunk through the plain twins, on the card
    p_op, _, _, _ = run(pts_d[:ROWS], plain=True)
    p_vals = polish.apply_pairs_ref(p_op.refs, p_op.refs_lo, p_op.elements,
                                    fields, src.order, 3)
    same = op.elements[:ROWS] == p_op.elements
    agree = float(same.double().mean())
    vdiff = float(((vals[:ROWS] - p_vals).abs() / p_vals.abs())[same].max())

    t0 = time.perf_counter()
    f_op, f_vals, f_build, f_apply = run(
        pts_d, cfg=dataclasses.replace(SLICE_CFG, f64_polish=True))
    f_wall = time.perf_counter() - t0
    f_rel = max_rel(f_vals[:, 0], truth)
    emit({"phase": "df32 slice", "targets": N_TARGETS,
          "elements": src.nelem, "params": 3, "wall_s": wall,
          "build_s": build_s, "apply_s": apply_s,
          "mpts_per_s": N_TARGETS / wall / 1e6, "n_retry": op.n_retry,
          "launches": launches, "max_rel_err": rel,
          "rows_with_lo": polished, "peak_mem_gb": peak_gb,
          "plain_elements_agree": agree, "plain_max_rel_diff": vdiff,
          "f64_polish": {"wall_s": f_wall, "build_s": f_build,
                         "apply_s": f_apply, "max_rel_err": f_rel,
                         "refs_dtype": str(f_op.refs.dtype)}})
    check(rel < 1e-8, f"df32 max rel err {rel:.3g} >= 1e-8")
    check(agree >= 0.999, f"df32 plain path elements agree {agree:.6f}")
    check(vdiff <= 1e-10, f"df32 plain path values differ by {vdiff:.3g}")
    check(f_op.refs.dtype == torch.float64, "f64_polish refs not f64")
    check(f_rel < 1e-8, f"f64_polish max rel err {f_rel:.3g} >= 1e-8")
    return launches



def phase_f64(dev, smi, src, pts_d, fields, truth):
    """``Precision.F64`` on the slice's first ROWS targets: f64 refs, the
    3 columns within 1e-8 of their analytic fields, and the operator and
    values bit for bit those of the same call with ``f64_polish=True``.
    Returns its launch counts."""
    targets = pts_d[:ROWS]
    f64_cfg = dataclasses.replace(SLICE_CFG, precision=Precision.F64)
    pol_cfg = dataclasses.replace(SLICE_CFG, f64_polish=True)
    run_transfer(src, targets, fields, f64_cfg, dev, fallback="snap")
    reset_launches()
    op, vals, build_s, apply_s = run_transfer(src, targets, fields, f64_cfg,
                                              dev, fallback="snap")
    launches = read_launches()
    pop, pvals, _, _ = run_transfer(src, targets, fields, pol_cfg, dev,
                                    fallback="snap")
    rels = max_rel_columns(vals, truth[:ROWS])
    same = (torch.equal(op.elements, pop.elements)
            and torch.equal(op.refs, pop.refs)
            and torch.equal(vals, pvals))
    emit({"phase": "f64", "nvidia_smi": smi, "targets": ROWS,
          "build_s": build_s, "apply_s": apply_s,
          "refs_dtype": str(op.refs.dtype), "launches": launches,
          "max_rel_err_columns": rels, "bit_equal_f64_polish": same})
    check(op.refs.dtype == torch.float64 and vals.dtype == torch.float64,
          f"F64 refs {op.refs.dtype}, values {vals.dtype}")
    check(max(rels) < 1e-8, f"F64 max rel errs {rels} >= 1e-8")
    check(same, "F64 differs from f64_polish=True")
    check(launches["newton_rows"] > 0 and launches["nearest_centroid"] > 0,
          f"F64 launches {launches}")
    return launches


def phase_native(dev, smi):
    """The native host runtime (``multimesh_tpu_torch.native``), built
    here from ``native/src/mmt_native.cpp``, against the port's plain path
    on the card: a candidate-scan ``locate`` of 20,000 points inside a
    warped order-2 box on the same 6 candidates, ``Precision.F64``;
    elements equal where both accept, refs and weights within 1e-12."""
    from multimesh_tpu_torch import native

    t0 = time.perf_counter()
    path = native.bindings.build()
    build_s = time.perf_counter() - t0
    mesh = testing.box_mesh(shape=(12, 12, 12), order=2, warp=0.1)
    rng = np.random.default_rng(7)
    pts = rng.uniform(0.0, 1.0, (20_000, 3))
    cand = knn.knn(torch.as_tensor(mesh.centroids(), device=dev),
                   torch.as_tensor(pts, device=dev), 6)[1]
    el, refs, w, failed = native.locate(
        pts, cand.cpu().numpy().astype(np.int64), mesh.points, 2,
        rtol=1e-14)
    res = _locate.locate(pts, mesh.points, 2,
                         LocateConfig(precision=Precision.F64,
                                      nelem_to_search=6),
                         candidates=cand, strategy="scan", device=dev,
                         plain=True)
    t_el = res.elements.cpu().numpy()
    both = (el >= 0) & res.accepted.cpu().numpy()
    agree = float((el[both] == t_el[both]).mean())
    same = both & (el == t_el)
    ref_err = float(np.abs(refs[same] - res.refs.cpu().numpy()[same]).max())
    w_err = float(np.abs(w[same] - res.weights.cpu().numpy()[same]).max())
    emit({"phase": "native", "nvidia_smi": smi, "library": path.name,
          "build_s": build_s, "points": pts.shape[0],
          "native_failed": failed, "both_accepted": float(both.mean()),
          "elements_agree": agree, "max_abs_ref_diff": ref_err,
          "max_abs_weight_diff": w_err})
    check(both.mean() > 0.99, f"native / plain accepted {both.mean():.4f}")
    check(agree >= 0.999, f"native elements agree {agree:.6f}")
    check(ref_err <= 1e-12 and w_err <= 1e-12,
          f"native refs / weights differ by {ref_err:.3g} / {w_err:.3g}")


def lifted_targets(pts):
    """The targets with 2% of them lifted radially to 6.371-6.40e6 m, just
    above the source's outer surface (the overhang of a target mesh with
    another surface): (targets, lifted mask)."""
    rng = np.random.default_rng(50)
    targets = pts.copy()
    lifted = rng.random(N_TARGETS) < 0.02
    radius = np.linalg.norm(targets[lifted], axis=1)
    targets[lifted] *= (rng.uniform(6.371e6, 6.40e6, int(lifted.sum()))
                        / radius)[:, None]
    return targets, lifted


def phase_flagship(dev, src, pts, fields):
    """gll_2_gll's locate options on the 10M targets, 2% of them lifted
    (``lifted_targets``); then 1M of them through the scan and its
    trilinear prefilter."""
    targets, lifted = lifted_targets(pts)
    tgt_d = torch.as_tensor(targets, device=dev)
    interior = torch.as_tensor(~lifted, device=dev)
    cfg, kw = FLAGSHIP_CFG, FLAGSHIP_KW

    # what TransferOperator.build runs, kept whole for its accepted mask
    reset_launches()
    t0 = time.perf_counter()
    res = _locate.locate(tgt_d, src.points, src.order, cfg, device=dev,
                         want_weights=False, **kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    op = TransferOperator(res.elements, src.order, res.refs, res.found,
                          n_retry=res.n_retry, refs_lo=res.refs_lo)
    vals = op.apply(fields)
    torch.cuda.synchronize()
    build_s, apply_s = t1 - t0, time.perf_counter() - t1
    launches = read_launches()
    truth = torch.as_tensor(testing.smooth_field(targets), device=dev)
    acc_int = res.accepted & interior
    acc_share = float(acc_int.sum()) / float(interior.sum())
    rel = max_rel(vals[acc_int, 0], truth[acc_int])

    # the lifted rows (where the retry runs) through the plain path
    rows = torch.nonzero(~interior).squeeze(1)
    p_res = _locate.locate(tgt_d[rows], src.points, src.order, cfg,
                           device=dev, plain=True, want_weights=False, **kw)
    agree = float((p_res.elements == res.elements[rows]).double().mean())

    # 1M of the targets through strategy="scan"
    reset_launches()
    t0 = time.perf_counter()
    s_res = run_scan(src, tgt_d, dev)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    scan_launches = read_launches()
    s_int = interior[:N_SCAN]
    s_agree = float((s_res.elements == res.elements[:N_SCAN])[s_int]
                    .double().mean())
    emit({"phase": "flagship", "targets": N_TARGETS,
          "lifted": int(lifted.sum()), "build_s": build_s,
          "apply_s": apply_s, "n_retry": op.n_retry, "launches": launches,
          "interior_accepted": acc_share, "accepted_max_rel_err": rel,
          "lifted_accepted": float(res.accepted[rows].double().mean()),
          "plain_elements_agree_lifted": agree,
          "scan": {"targets": N_SCAN, "wall_s": scan_s,
                   "launches": scan_launches,
                   "interior_elements_agree_ladder": s_agree}})
    check(op.n_retry > 0, "the flagship run retried no row")
    check(all(launches[k] > 0 for k in ("newton_rows", "nearest_centroid",
                                        "polish_pairs", "apply_pairs")),
          f"a kernel of the flagship path was not launched: {launches}")
    check(acc_share >= 0.9999, f"interior accepted {acc_share:.6f}")
    check(rel < 1e-8, f"accepted interior max rel err {rel:.3g} >= 1e-8")
    check(agree >= 0.999, f"lifted rows vs plain path agree {agree:.6f}")
    check(scan_launches["newton_rows_order1"] > 0,
          "the scan's prefilter launched no order-1 K1")
    check(s_agree >= 0.999, f"scan vs ladder interior agree {s_agree:.6f}")
    return scan_launches["newton_rows_order1"]


def phase_dedup(dev, smi, targets):
    """The card's dedup against the host path at each of ``targets``
    (name -> [E, n, 3] lattice); see the module docstring."""
    out = {}
    for name, points in targets.items():
        flat = np.ascontiguousarray(points.reshape(-1, points.shape[-1]))
        t0 = time.perf_counter()
        want_u, want_r = dedup.unique_points(points, order_by="first")
        host_ms = (time.perf_counter() - t0) * 1e3
        pts_d = torch.as_tensor(flat, device=dev)
        for _ in range(2):
            uniq, recon = dedup.dedup_first(pts_d)
            check(np.array_equal(uniq.cpu().numpy().view(np.int64),
                                 want_u.view(np.int64))
                  and np.array_equal(recon.cpu().numpy(), want_r),
                  f"the card's dedup differs from the host path at {name}")
            del uniq, recon
        call_ms = cuda_ms(lambda: dedup.dedup_first(pts_d), 3)
        del pts_d
        fp = hashing.content_fingerprint(points)
        walls = []
        for _ in range(5):
            dedup._UNIQ_DEV_CACHE.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dev_u, host_r = dedup.unique_points_device(points, fp,
                                                       device=dev)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        check(np.array_equal(host_r, want_r)
              and np.array_equal(dev_u.cpu().numpy(), want_u),
              f"unique_points_device differs from the host path at {name}")
        dedup._UNIQ_DEV_CACHE.clear()
        out[name] = {"rows": flat.shape[0], "unique": want_u.shape[0],
                     "call_ms": call_ms,
                     "wrapper_ms": sorted(walls)[len(walls) // 2],
                     "wrapper_ms_runs": walls, "host_ms": host_ms}
    emit({"phase": "dedup", "nvidia_smi": smi, "targets": out})


def phase_fingerprint(dev, smi, targets):
    """KF at each of ``targets`` (name -> host array); see the module
    docstring.  Returns its kernels-line entry, timed at the last."""
    C = hashing.HASH_COLS
    out = {}
    for name, a in targets.items():
        b8 = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
        R = b8.size // 4 // C
        head = b8[: 4 * R * C].view(np.uint32).reshape(R, C)
        t0 = time.perf_counter()
        col, row, colw, roww = hashing.layer1_sums_host(head)
        host_sums_ms = (time.perf_counter() - t0) * 1e3
        want = np.concatenate([col, colw, row, roww])
        words = torch.from_numpy(head.view(np.int32)).to(dev)
        for _ in range(2):
            sums = hashing.layer1_sums(words)
            check(np.array_equal(sums.cpu().numpy().view(np.uint32), want),
                  f"KF's sums differ from the host's at {name}")
        check(np.array_equal(
            hashing.layer1_sums_ref(words).cpu().numpy().view(np.uint32),
            want), f"KF's twin differs from the host's at {name}")
        ms = cuda_ms(lambda: hashing.layer1_sums(words), 20)
        plain_ms = cuda_ms(lambda: hashing.layer1_sums_ref(words), 3)
        # the words read once, the four sums written once; its four
        # integer operations a word take far less than the bytes' time
        bound_ms, bound_by = nbytes(words, sums) / PEAK_BYTES * 1e3, "bytes"
        del words, sums
        want_fp = hashing.content_fingerprint(a)
        walls = {"card": [], "host": []}
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fp, up = hashing.content_fingerprint_device(a, dev)
            torch.cuda.synchronize()
            walls["card"].append((time.perf_counter() - t0) * 1e3)
            check(fp == want_fp, f"content_fingerprint_device differs from "
                  f"content_fingerprint at {name}")
            check(np.array_equal(up.cpu().numpy().view(np.uint8).reshape(-1),
                                 b8), f"the fingerprint's upload at {name}")
            del up
            t0 = time.perf_counter()
            hashing.content_fingerprint(a)
            walls["host"].append((time.perf_counter() - t0) * 1e3)
        out[name] = {"rows": R, "bytes": 4 * R * C, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "bound_share": bound_ms / ms,
                     "host_sums_ms": host_sums_ms,
                     "fingerprint_card_ms": walls["card"],
                     "fingerprint_host_ms": walls["host"]}
    emit({"phase": "fingerprint", "nvidia_smi": smi, "targets": out})
    last = out[name]
    return {"name": "content_sums", "route": "cuda",
            "source": "multimesh_tpu_torch/csrc/content_sums.cu",
            # both packages sum the weighted-sum layer on the host
            "replaces": None, "max_abs_err": 0, "target": name,
            **{k: last[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by")},
            # numpy's wrapping uint32 sums; no PyTorch call takes them
            "library_ms": None}


def mesh_new_target(points):
    """``points`` [E, n, 3] rotated about the polar axis by
    ``DEDUP_ANGLE``, as a mesh cell's target."""
    c, s_ = np.cos(DEDUP_ANGLE), np.sin(DEDUP_ANGLE)
    return np.stack([c * points[..., 0] - s_ * points[..., 1],
                     s_ * points[..., 0] + c * points[..., 1],
                     points[..., 2]], axis=-1)


def file_target():
    """The ``gll_file`` target: an order-4 shell of 37 x 37 x 58 = 79,402
    elements (9,925,250 GLL slots) strictly inside the source."""
    return testing.shell_mesh(n_lat=37, n_lon=37, n_rad=58, order=4,
                              r_inner=3.7e6, r_outer=6.2e6,
                              lat_extent=(0.58, 1.12),
                              lon_extent=(0.38, 1.32))


class FileCase:
    """One source / target pair of the file path: the source with the
    ``smooth`` field, the target with the ``linear`` one (so a target left
    unwritten cannot pass).  With ``h5py`` both are Salvus HDF5 files
    under ``tmpdir`` and ``run`` drives ``api.gll_2_gll`` on them, the
    target restored from a pristine copy first; without it ``run`` drives
    ``engine.transfer_arrays`` on the arrays the files would hold, with a
    numpy sink."""

    def __init__(self, src, tgt, tmpdir, dev, have_h5py=HAVE_H5PY):
        self.src, self.tgt, self.dev = src, tgt, dev
        self.tmpdir, self.have_h5py = tmpdir, have_h5py
        s_nodal, _ = testing.salvus_fixture_fields(src, FILE_PARAMS)
        t_nodal, t_elem = testing.salvus_fixture_fields(
            tgt, FILE_PARAMS, field_kind="linear")
        self.params = list(s_nodal)
        self.src_data = np.stack(list(s_nodal.values()), axis=1)
        if have_h5py:
            self.f_src = os.path.join(tmpdir, "src.h5")
            self.f_tgt0 = os.path.join(tmpdir, "tgt_pristine.h5")
            self.f_tgt = os.path.join(tmpdir, "tgt.h5")
            testing.write_salvus_fixture(self.f_src, src, FILE_PARAMS)
            testing.write_salvus_fixture(self.f_tgt0, tgt, FILE_PARAMS,
                                         field_kind="linear")
        else:
            self.old_values = np.stack(list(t_nodal.values()), axis=1)
            self.solid = ~t_elem["fluid"].astype(bool)

    def run(self, **kw):
        """One transfer: (returned values, written values, written
        labels, wall seconds); the wall ends after a device sync and
        leaves out restoring the target and reading it back."""
        if self.have_h5py:
            import h5py

            from multimesh_tpu_torch import api
            from multimesh_tpu_torch.io import salvus as sio

            shutil.copyfile(self.f_tgt0, self.f_tgt)
            t0 = time.perf_counter()
            values = api.gll_2_gll(self.f_src, self.f_tgt, device=self.dev,
                                   **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            with h5py.File(self.f_tgt, "r") as f:
                return (values, f["MODEL/data"][()],
                        sio.read_dim_labels(f["MODEL/data"]), wall)
        sink = {}

        def open_sink(params):
            sink["labels"] = list(params)
            sink["data"] = np.full(
                (self.tgt.nelem, len(params), self.tgt.n_gll), np.nan)
            return sink["data"]

        t0 = time.perf_counter()
        values = engine.transfer_arrays(
            self.src.points, self.src_data, self.params, self.tgt.points,
            self.old_values, self.solid, open_sink, device=self.dev, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return values, sink["data"], sink["labels"], wall


def clear_caches():
    """The in-process caches a first call finds empty: the dedup's (host
    and device) and the mesh prep's."""
    dedup._UNIQ_CACHE.clear()
    dedup._UNIQ_DEV_CACHE.clear()
    _locate._PREP_CACHE.clear()


def phase_file(case, smi):
    """The file path at the ``gll_file`` configuration (see the module
    docstring).  Returns the launch counts of its df32 call and K5's
    largest relative difference from its twin on that call's inputs."""
    dev, src, tgt = case.dev, case.src, case.tgt
    n_slots = tgt.nelem * tgt.n_gll
    # every written parameter's analytic value, [E, P, n]: VP, VS, RHO
    # scaled copies of the smooth field, z_node_1D the radius fraction
    truth = np.stack(list(testing.salvus_fixture_fields(
        tgt, FILE_PARAMS)[0].values()), axis=1)
    fields = torch.as_tensor(
        np.ascontiguousarray(np.moveaxis(case.src_data, 1, 0)), device=dev)

    def rel_errs(written):
        """Max relative error of each parameter."""
        return [float(x) for x in np.max(
            np.abs(written - truth) / np.abs(truth), axis=(0, 2))]

    def in_memory(uniq, recon):
        """``gll_2_gll``'s operator built on the unique points and applied
        in memory on the card (with the polish where MMT_DF32_POLISH=1):
        the operator and its expanded values as the file holds them."""
        op = TransferOperator.build(
            src.points, uniq, order=src.order,
            cfg=engine._locate_cfg(20, accept_tol=1.04), device=dev,
            **FLAGSHIP_KW)
        mem = op.apply(fields)[torch.as_tensor(recon, device=dev)]
        mem = mem.view(tgt.nelem, tgt.n_gll, -1).permute(0, 2, 1).double()
        return op, mem.cpu().numpy()

    # (a) first: kernels built and allocator warm, caches empty
    clear_caches()
    reset_launches()
    vals_a, wr_a, labels, wall_first = case.run()
    launches_a = read_launches()
    check(labels == list(FILE_PARAMS) + ["z_node_1D"], f"labels {labels}")
    check(wr_a.dtype == np.float64
          and wr_a.shape == (tgt.nelem, len(case.params), tgt.n_gll),
          f"written {wr_a.dtype} {wr_a.shape}")
    check(np.array_equal(vals_a, wr_a), "returned values differ from the "
          "written ones")
    del vals_a
    rel_a = rel_errs(wr_a)
    check(max(rel_a) < 1e-6, f"file path max rel errs {rel_a} >= 1e-6")
    check(all(launches_a[k] > 0 for k in ("newton_rows", "nearest_centroid",
                                          "content_sums")),
          f"a kernel of the file path was not launched: {launches_a}")

    # (b) warm: the same call again, the in-process caches filled; its
    # pinned staging buffer taken from the caching host allocator
    reset_launches()
    pinned = torch.cuda.host_memory_stats()["num_host_alloc"]
    _, wr, _, wall_warm = case.run()
    pinned_warm = torch.cuda.host_memory_stats()["num_host_alloc"] - pinned
    launches_b = read_launches()
    check(np.array_equal(wr, wr_a), "the warm call differs from the first")
    check(pinned_warm == 0, f"the warm call pinned {pinned_warm} new host "
          "blocks")

    # (c) stored hit: once to save, once to load (timed)
    stored = os.path.join(case.tmpdir, "stored")
    _, wr, _, wall_save = case.run(stored_array=stored)
    check(np.array_equal(wr, wr_a), "the saving call differs from the first")
    check(os.path.exists(os.path.join(stored, "recon.npy")),
          "the stored operator has no recon.npy")
    # the dedup's caches emptied, so that a dedup would have to run, and
    # put back after it for the calls below; under MMT_PROFILE=1 for the
    # counter dedup.card_rows
    held = dict(dedup._UNIQ_CACHE), dict(dedup._UNIQ_DEV_CACHE)
    dedup._UNIQ_CACHE.clear()
    dedup._UNIQ_DEV_CACHE.clear()
    os.environ["MMT_PROFILE"] = "1"
    try:
        utils_profile.reset_stages()
        reset_launches()
        _, wr, _, wall_hit = case.run(stored_array=stored)
        launches_c = read_launches()
        grouped = {"stored_hit": card_rows()}
    finally:
        del os.environ["MMT_PROFILE"]
    dedup._UNIQ_CACHE.update(held[0])
    dedup._UNIQ_DEV_CACHE.update(held[1])
    del held
    check(np.array_equal(wr, wr_a), "the stored hit differs from the first")
    check(launches_c["newton_rows"] == 0, "the stored hit located again")
    check(grouped["stored_hit"] == 0, "the stored hit grouped its target "
          "on the card: recon.npy was not used")
    del wr

    # the operator built and applied in memory, on the card
    uniq, recon = dedup.unique_points_cached(tgt.points, order_by="first")
    op, mem = in_memory(uniq, recon)
    check(np.array_equal(mem, wr_a),
          "the file's values differ from the in-memory operator's")
    n_unique, num_missing, n_retry = len(uniq), op.num_missing, op.n_retry
    del mem, op, wr_a

    # (d) df32: MMT_DF32_POLISH=1 around the call, then the polished
    # operator in memory
    os.environ["MMT_DF32_POLISH"] = "1"
    try:
        reset_launches()
        _, wr_d, _, wall_df32 = case.run()
        launches_d = read_launches()
        op, mem = in_memory(uniq, recon)
    finally:
        del os.environ["MMT_DF32_POLISH"]
    rel_d = rel_errs(wr_d)
    check(max(rel_d) < 1e-8, f"df32 file path max rel errs {rel_d} >= 1e-8")
    check(all(launches_d[k] > 0 for k in ("newton_rows", "nearest_centroid",
                                          "polish_pairs", "apply_pairs",
                                          "content_sums")),
          f"a kernel of the df32 file path was not launched: {launches_d}")
    check(np.array_equal(mem, wr_d), "the df32 file's values differ from "
          "the in-memory polished operator's")
    del mem, wr_d
    # K5 against its twin at the file path's own inputs: the polished
    # operator's pair refs and elements and the file's 4 fields, in the
    # chunks apply launches it on
    k5_rows, k5_rel = [], []
    for s in range(0, op.n_points, APPLY_CHUNK):
        e = s + APPLY_CHUNK
        rel, zeros, _, _ = _apply_rel(
            (op.refs[s:e].float(), op.refs_lo[s:e], op.elements[s:e],
             fields, src.order, 3))
        k5_rows.append(int(op.elements[s:e].shape[0]))
        k5_rel.append(rel)
        check(rel <= 1e-12 and zeros, f"K5 on the file's rows {s}:{e}, "
              f"{fields.shape[0]} fields, differs by {rel:.3g} relative")
    check(len(k5_rows) == launches_d["apply_pairs"],
          f"K5 chunks {k5_rows} != launches {launches_d['apply_pairs']}")
    del op

    # (e) the stage seconds of a first call (caches emptied) and of a
    # warm one after it, under MMT_PROFILE=1 (stages timed by CUDA events,
    # inclusive), each call's own wall beside its stages
    clear_caches()
    os.environ["MMT_PROFILE"] = "1"
    try:
        utils_profile.reset_stages()
        wall_prof_first = case.run()[3]
        stages = utils_profile.stage_totals()
        grouped["first"] = card_rows()
        expanded = {"first": expand_counts()}
        hashed = {k: v for k, v in utils_profile.counter_totals().items()
                  if k.startswith("fingerprint.")}
        utils_profile.reset_stages()
        wall_prof_warm = case.run()[3]
        stages_warm = utils_profile.stage_totals()
        grouped["warm"] = card_rows()
        expanded["warm"] = expand_counts()
    finally:
        del os.environ["MMT_PROFILE"]
    check(grouped["first"] == n_slots, f"the first call grouped "
          f"{grouped['first']} rows on the card, not its {n_slots} slots")
    check(grouped["warm"] == 0, "the warm call grouped its target again")
    row = 4 * hashing.HASH_COLS
    heads = sum(a.nbytes // row * row for a in (src.points, tgt.points))
    check(hashed == {"fingerprint.card_bytes": heads,
                     "fingerprint.frozen_hits": 0},
          f"the first call's fingerprint counters {hashed}: not every head "
          f"byte ({heads}) of the target and the source on the card, once")
    # every slot expanded on the card; no element reverted (the target
    # has no fluid and no zero VS: the values equal the in-memory
    # operator's, which knows no repair)
    check(all(c == {"expand.card_slots": n_slots, "expand.patched_elems": 0}
              for c in expanded.values()), f"expansion counters {expanded}")
    want = {"g2g.fingerprint", "g2g.dedup", "g2g.apply", "g2g.stream_write",
            "g2g.expand"}
    if case.have_h5py:
        want |= {"g2g.read_source", "g2g.read_target"}
    check(want <= set(stages), f"stages {sorted(stages)}")

    emit({"phase": "file", "h5py": case.have_h5py, "nvidia_smi": smi,
          "n_slots": n_slots, "n_unique": n_unique,
          "elements": src.nelem, "params": len(case.params),
          "wall_first_s": wall_first, "wall_warm_s": wall_warm,
          "wall_stored_save_s": wall_save, "wall_stored_hit_s": wall_hit,
          "wall_df32_s": wall_df32,
          "mslots_per_s_first": n_slots / wall_first / 1e6,
          "mslots_per_s_warm": n_slots / wall_warm / 1e6,
          "stages_s": stages, "wall_profiled_first_s": wall_prof_first,
          "stages_warm_s": stages_warm,
          "wall_profiled_warm_s": wall_prof_warm,
          "stream_write_s": {k: st["g2g.stream_write"] for k, st in (
              ("first", stages), ("warm", stages_warm))},
          "expand_s": {k: st["g2g.expand"] for k, st in (
              ("first", stages), ("warm", stages_warm))},
          "expand_counters": expanded, "pinned_new_blocks_warm": pinned_warm,
          "parameters": case.params,
          "max_rel_err": rel_a, "max_rel_err_df32": rel_d,
          "k5_file_rows": k5_rows, "k5_file_params": int(fields.shape[0]),
          "k5_file_max_rel_diff": k5_rel, "num_missing": num_missing,
          "n_retry": n_retry, "launches_first": launches_a,
          "launches_warm": launches_b, "launches_stored_hit": launches_c,
          "launches_df32": launches_d, "dedup_card_rows": grouped,
          "fingerprint_counters_first": hashed})
    return launches_d, max(k5_rel)


def big_source():
    """The ``gll_big`` source mesh with its lattice frozen (so it is
    hashed once, see ``hashing.array_fingerprint``) and its 3 fields, as
    (mesh, fields [3, E, 125] f64 on the host, seconds it took)."""
    t0 = time.perf_counter()
    src = testing.shell_mesh(**BIG_SHELL)
    src.points.setflags(write=False)
    base = testing.element_nodal_field(src, "smooth")
    fields = np.stack([base * (1 + 0.1 * i) for i in range(3)])
    return src, fields, time.perf_counter() - t0



def _viz_check(dev, mesh, xyz, vals, rows):
    """The interpolated plot values ``vals`` (flat, host) at the points
    ``xyz`` [N, 3]: the share of points inside (a value), the largest
    relative error there against ``smooth_field_torch`` on the card, and
    the ``rows`` slice against the plain path (the entry's locate
    configuration, ``plain=True``): found agreement and the largest
    relative difference where both found a value."""
    pts = torch.as_tensor(xyz, device=dev)
    truth = testing.smooth_field_torch(pts)
    got = torch.as_tensor(vals, device=dev)
    inside = got != 0
    rel = float(((got - truth).abs() / truth.abs())[inside].max())
    op = TransferOperator.build(
        mesh.points, pts[rows], order=4, cfg=LocateConfig(),
        fallback="sentinel", prefilter_m=PREFILTER_M, device=dev, plain=True)
    p_vals = op.apply(torch.as_tensor(
        mesh.element_nodal_fields[VIZ_PARAM], device=dev))
    both = inside[rows] & (p_vals != 0)
    return {"points": int(xyz.shape[0]),
            "share_inside": float(inside.double().mean()),
            "max_rel_err_inside": rel,
            "plain_rows": int(p_vals.shape[0]),
            "plain_found_agree": float(
                (inside[rows] == (p_vals != 0)).double().mean()),
            "plain_max_rel_diff": float(
                ((got[rows] - p_vals).abs() / p_vals.abs())[both].max())}


def phase_viz(dev, smi, big):
    """The plotting entries on the ``gll_big`` source (see the module
    docstring): a 1000 x 1000 depth slice and a 201 x 301 cross section,
    each through ``api.plot_depth_slice`` / ``api.plot_cross_section``
    into a temporary directory where matplotlib imports, else through the
    sampling and interpolation helpers those entries call; a warm-up and
    three timed calls each, K1's launches, the share of points inside,
    the values inside against the analytic field and one chunk against
    the plain path.  Returns the depth slice's launch counts."""
    from multimesh_tpu_torch import api
    from multimesh_tpu_torch.viz import plotter

    src, fields_h, _ = big
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    base = fields_h[0]  # the smooth field at every node
    slice_mesh = types.SimpleNamespace(
        points=src.points, element_nodal_fields={VIZ_PARAM: base})
    # the cross section sphere-maps its mesh in place (make_spherical),
    # so it gets a writable lattice, as a user's mesh object holds one
    xsec_mesh = types.SimpleNamespace(
        points=src.points.copy(), element_nodal_fields={
            VIZ_PARAM: base,
            "z_node_1D": np.linalg.norm(src.points, axis=-1) / 6.371e6})
    xsec_args = (*VIZ_XSEC.values(), VIZ_MAX_DEPTH_KM, 0.0, VIZ_NRADS,
                 VIZ_NPOINTS)
    out = {}
    with tempfile.TemporaryDirectory() as tmpdir:
        def depth_slice():
            if have_mpl:
                return api.plot_depth_slice(
                    mesh=slice_mesh, depth_in_km=VIZ_DEPTH_KM, num=VIZ_NUM,
                    lat_extent=VIZ_LAT, lon_extent=VIZ_LON,
                    parameter_to_plot=VIZ_PARAM, savefig=True,
                    figname=os.path.join(tmpdir, "slice.png"), device=dev)
            return plotter._depth_slice_values(
                slice_mesh, VIZ_DEPTH_KM, VIZ_NUM, VIZ_LAT, VIZ_LON,
                VIZ_PARAM, dev)

        def cross_section():
            if have_mpl:
                return api.plot_cross_section(
                    mesh=xsec_mesh, **VIZ_XSEC,
                    max_depth_in_km=VIZ_MAX_DEPTH_KM, nrads=VIZ_NRADS,
                    npoints=VIZ_NPOINTS,
                    filename=os.path.join(tmpdir, "xsec.png"),
                    param_to_interp=VIZ_PARAM, device=dev)
            pts, _ = plotter._cross_section_points(*xsec_args)
            return plotter._cross_section_values(
                xsec_mesh, pts, VIZ_NRADS, VIZ_NPOINTS, VIZ_PARAM, dev)

        for name, fn in (("depth_slice", depth_slice),
                         ("cross_section", cross_section)):
            _host_s(fn)  # warm-up: prep, index, caches
            reset_launches()
            walls = [_host_s(fn)[1]]
            launches = read_launches()
            walls += [_host_s(fn)[1] for _ in range(2)]
            median, spread = _median_spread(walls)
            out[name] = {"walls_s": walls, "wall_median_s": median,
                         "wall_spread_s": spread, "launches": launches}
            check(launches["newton_rows"] > 0,
                  f"{name}: K1 not launched ({launches})")
        if have_mpl:
            check(os.path.getsize(os.path.join(tmpdir, "slice.png")) > 1000
                  and os.path.getsize(os.path.join(tmpdir, "xsec.png"))
                  > 1000, "the plots were not written")

    # the values each plot holds, checked once
    ll = plotter._create_depthslice(VIZ_DEPTH_KM * 1000.0, VIZ_NUM, VIZ_LAT,
                                    VIZ_LON)
    vals = plotter._depth_slice_values(slice_mesh, VIZ_DEPTH_KM, VIZ_NUM,
                                       VIZ_LAT, VIZ_LON, VIZ_PARAM, dev)
    out["depth_slice"].update(_viz_check(
        dev, slice_mesh, utils.latlondepth_to_xyz(ll), vals.ravel(),
        slice(0, ROWS)))
    pts, _ = plotter._cross_section_points(*xsec_args)
    vals = plotter._cross_section_values(xsec_mesh, pts, VIZ_NRADS,
                                         VIZ_NPOINTS, VIZ_PARAM, dev)
    out["cross_section"].update(_viz_check(
        dev, xsec_mesh, pts, vals.ravel(), slice(0, pts.shape[0])))
    emit({"phase": "viz", "nvidia_smi": smi, "matplotlib": have_mpl,
          "elements": src.nelem, **out})
    for name, rec in out.items():
        check(rec["share_inside"] > 0.9, f"{name}: {rec['share_inside']:.4f} "
              "of the points inside")
        check(rec["max_rel_err_inside"] < 1e-6, f"{name}: max rel err "
              f"{rec['max_rel_err_inside']:.3g} >= 1e-6")
        check(rec["plain_found_agree"] >= 0.999, f"{name}: found agreement "
              f"with the plain path {rec['plain_found_agree']:.6f}")
        check(rec["plain_max_rel_diff"] <= 1e-5, f"{name}: values differ "
              f"from the plain path by {rec['plain_max_rel_diff']:.3g}")
    return out["depth_slice"]["launches"]


def _host_s(fn):
    """(result, wall seconds) of ``fn()``, the device synchronised."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_big(dev, smi, big, pts_d, truth):
    """The grid route at the ``gll_big`` shape (see the module docstring).
    Returns the launch counts of its df32 run and, on that run's first
    chunk, K4's largest pair-ref difference and K5's largest relative
    difference against their twins."""
    src, fields_h, mesh_s = big
    E, order, dim = src.nelem, src.order, src.dim
    check(E > grid.APPROX_GRID_MIN_SOURCES and E > grid.EXACT_KNN_MAX_SOURCES,
          f"{E} elements do not take the grid route")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fields = torch.as_tensor(fields_h, device=dev)
    del fields_h

    # the lattice's fingerprint (hashed once: frozen), the prep on the
    # card, the index; each a second time as a cache hit
    fp, hash_s = _host_s(lambda: hashing.array_fingerprint(src.points))
    fp2, hash_hit_s = _host_s(lambda: hashing.array_fingerprint(src.points))
    check(fp == fp2, "the frozen lattice's fingerprint changed")
    prep, prep_s = _host_s(lambda: _locate._mesh_prep(src.points, order, dev))
    prep2, prep_hit_s = _host_s(
        lambda: _locate._mesh_prep(src.points, order, dev))
    check(prep2 is prep, "the second prep of the frozen lattice missed")
    index, index_s = _host_s(lambda: grid.get_grid_index(
        prep.centroids_host, _locate.ROUND1_MEMBERS, dev))
    index2, index_hit_s = _host_s(lambda: grid.get_grid_index(
        prep.centroids_host, _locate.ROUND1_MEMBERS, dev))
    check(index2 is index, "the second get_grid_index missed")
    n_bins, m = index.n_bins, index.members_per_bin
    p1 = _locate.ROUND1_PROBES

    # round 1's search on the first chunk against the exact kNN
    q = pts_d[:ROWS]
    cand = grid.nearest_member(index, q, n_probe=p1)
    (d_exact, i_exact), exact_s = _host_s(
        lambda: knn.knn(prep.centroids, q, 1))
    d_cand = ((q - prep.centroids[cand.long()]) ** 2).sum(-1)
    nearest_share = float((cand == i_exact[:, 0]).double().mean())
    never_nearer = bool((d_cand >= d_exact[:, 0] * (1 - 1e-12)).all())
    d64, i64 = grid._grid_query(index, q, 1, p1, index.bin_coords64)
    same64 = float((cand == i64[:, 0]).double().mean())
    d_64 = ((q - prep.centroids[i64[:, 0].long()]) ** 2).sum(-1)
    d64_err = float(((d_cand - d_64).abs() / d_cand.clamp_min(1.0)).max())
    # stage 1 alone (score + top-p over the bins), in the search's blocks
    step = grid._row_step(n_bins, p1, dim, m)

    def stage1():
        for s0 in range(0, ROWS, step):
            grid._probe_bins(index, q[s0:s0 + step] - index.center, p1)

    stage1_ms = cuda_ms(stage1, 5)
    search_ms = cuda_ms(
        lambda: grid.nearest_member(index, q, n_probe=p1), 5)
    # one PyTorch call for stage 1's ranking: cdist, then the same top-p
    q32 = (q - index.center).float()
    cdist_topk_ms = cuda_ms(lambda: [
        torch.topk(torch.cdist(q32[s0:s0 + step], index.bin_reps32), p1,
                   dim=1, largest=False) for s0 in range(0, ROWS, step)], 3)

    # grid_knn, k = 20 of 8 probed bins, by distance against the exact kNN
    qk = q[:N_BIG_KNN]
    gd2, gidx = grid.grid_knn(index, qk, 20, n_probe=8)
    ed2, _ = knn.knn(prep.centroids, qk, 20)
    gd_true = ((qk[:, None, :] - prep.centroids[gidx.long()]) ** 2).sum(-1)
    # by distance, not by index: two members at one distance may swap.  A
    # row is complete when all 20 distances are the exact ones; 8 bins do
    # not always hold a query's 20 nearest (its ladder has a round 4)
    knn_off = (gd_true.sqrt() - ed2.sqrt()).abs() / ed2.sqrt()
    knn_rel = float(knn_off.max())
    knn_rows = float((knn_off <= 1e-5).all(dim=1).double().mean())
    knn_first = float((knn_off[:, 0] <= 1e-5).double().mean())
    knn_self = float(((gd2 - gd_true).abs() / gd_true).max())
    grid_knn_ms = cuda_ms(lambda: grid.grid_knn(index, qk, 20, n_probe=8), 5)
    emit({"phase": "big index", "nvidia_smi": smi, "elements": E,
          "mesh_host_s": mesh_s, "hash_s": hash_s, "hash_hit_s": hash_hit_s,
          "prep_s": prep_s, "prep_hit_s": prep_hit_s, "n_bins": n_bins,
          "members_per_bin": m, "build_s": index_s, "hit_s": index_hit_s,
          "cache_hit": index2 is index, "rows": ROWS, "n_probe": p1,
          "nearest_is_exact": nearest_share, "never_nearer": never_nearer,
          "same_as_f64_ranking": same64, "max_rel_d2_vs_f64_ranking": d64_err,
          "exact_knn_s": exact_s, "row_block": step, "stage1_ms": stage1_ms,
          "search_ms": search_ms, "stage2_ms": search_ms - stage1_ms,
          "stage1_cdist_topk_ms": cdist_topk_ms,
          "grid_knn_rows": N_BIG_KNN, "grid_knn_max_rel_dist": knn_rel,
          "grid_knn_complete_rows": knn_rows,
          "grid_knn_first_is_nearest": knn_first,
          "grid_knn_d2_self_rel": knn_self, "grid_knn_ms": grid_knn_ms})
    check(nearest_share >= 0.97, f"nearest_member is the exact nearest on "
          f"{nearest_share:.4f} < 0.97 of the rows")
    check(never_nearer, "a nearest_member candidate is nearer than the "
          "exact nearest")
    check(same64 >= 0.999 and d64_err <= 1e-5, f"nearest_member differs "
          f"from the f64 ranking of its bins ({same64:.6f}, {d64_err:.3g})")
    check(knn_first >= 0.999, f"grid_knn's first column is the nearest "
          f"(rtol 1e-5) on {knn_first:.4f} < 0.999 of the rows")
    check(knn_rows >= 0.995, f"grid_knn's 20 distances are the exact ones "
          f"(rtol 1e-5) on {knn_rows:.4f} < 0.995 of the rows")
    check(knn_self <= 1e-9, f"grid_knn's own d2 is off by {knn_self:.3g}")
    del d_exact, i_exact, d64, i64, gd2, gidx, ed2, gd_true, knn_off

    # K1 on round 1's rows: nearly every row of a block its own element
    args = (q.contiguous(), cand.contiguous(), prep.ctr, prep.inv_scale,
            prep.nodes, order, dim, ITERS, LocateConfig().newton_clamp)
    k_ref, k_res = newton.newton_rows(*args)
    p_ref, p_res = newton.newton_refs_rows_ref(*args)
    torch.cuda.synchronize()
    kc, pc = k_res < CONV_TOL, p_res < CONV_TOL
    ka = kc & (k_ref.abs().amax(-1) < ACCEPT_TOL)
    pa = pc & (p_ref.abs().amax(-1) < ACCEPT_TOL)
    acc_agree = float((ka == pa).double().mean())
    k1_err = float((k_ref - p_ref)[ka & pa].abs().max())
    conv_err = float((k_ref - p_ref)[kc & pc].abs().max())
    ident = torch.arange(ROWS, dtype=torch.int32, device=dev)
    times = _grouped_times(newton.newton_rows, newton._newton_kernel, args,
                           args[1], E)
    ungrouped_ms = cuda_ms(lambda: newton._newton_kernel(ident, *args), 20)
    bit_equal = all(torch.equal(a, b) for a, b in zip(
        newton._newton_kernel(ident, *args), (k_ref, k_res)))
    plain_ms = cuda_ms(lambda: newton.newton_refs_rows_ref(*args), 3)
    bound_ms, bound_by = newton_bound(args, k_ref, k_res)
    # a rescue launch's rows: the grouping's scan walks E + 1 bins whatever M
    small = tuple(a[:N_BIG_KNN].contiguous() for a in args[:2]) + args[2:]
    small_t = _grouped_times(newton.newton_rows, newton._newton_kernel,
                             small, small[1], E)
    distinct = int(torch.unique(args[1]).numel())
    k1 = {"phase": "big K1", "order_dim": f"{order}/{dim}", "rows": ROWS,
          "elements": E, "distinct_elements": distinct,
          "accepted": float(ka.double().mean()), "accept_agree": acc_agree,
          "max_abs_err_accepted": k1_err, "max_abs_err_converged": conv_err,
          "grouped_bit_equal_row_order": bit_equal, **times,
          "ungrouped_ms": ungrouped_ms, "plain_ms": plain_ms,
          "bound_ms": bound_ms, "bound_by": bound_by,
          "bound_share": bound_ms / times["ms"],
          "rows_rescue": N_BIG_KNN,
          **{f"{k}_rescue": v for k, v in small_t.items()}}
    emit(k1)
    check(acc_agree >= 0.9999, f"big K1 acceptance agreement {acc_agree:.6f}")
    check(k1_err <= 1e-5, f"big K1 accepted refs differ by {k1_err:.3g}")
    check(bit_equal, "big K1 grouped differs from row order")
    del k_ref, k_res, p_ref, p_res, args, small

    # one chunk of the ladder alone, warm (stage list of PERF.md)
    def one_chunk():
        return _locate.locate(q, src.points, order, SLICE_CFG,
                              fallback="snap", device=dev,
                              want_weights=False)

    one_chunk()
    chunk_s = min(_host_s(one_chunk)[1] for _ in range(3))

    # the slice: one warm-up, three timed runs
    def run(targets, cfg=SLICE_CFG, plain=False):
        return run_transfer(src, targets, fields, cfg, dev, plain,
                            fallback="snap")

    run(pts_d)
    walls, builds, applies = [], [], []
    for _ in range(3):
        reset_launches()
        t0 = time.perf_counter()
        op, vals, build_s, apply_s = run(pts_d)
        walls.append(time.perf_counter() - t0)
        builds.append(build_s)
        applies.append(apply_s)
        launches = read_launches()
    check(launches["newton_rows"] > 0, f"K1 was not launched: {launches}")
    check(launches["nearest_centroid"] == 0, "K2 ran on the grid route")
    check(tuple(vals.shape) == (N_TARGETS, 3), f"shape {tuple(vals.shape)}")
    check(bool(torch.isfinite(vals).all()), "non-finite values")
    check(bool(op.found.all()), "snap left a target unassigned")
    rels = max_rel_columns(vals, truth)
    rel = max(rels)
    p_op, p_vals, _, _ = run(q, plain=True)
    same = op.elements[:ROWS] == p_op.elements
    agree = float(same.double().mean())
    v, pv = vals[:ROWS][same], p_vals[same]
    vdiff = float(((v - pv).abs() / pv.abs()).max())
    n_retry = op.n_retry
    del op, vals, p_op, p_vals, v, pv

    # the same once with the df32 polish (the prep with the f64 lattice
    # first, so the run itself is warm)
    _, prep64_s = _host_s(
        lambda: _locate._mesh_prep(src.points, order, dev, want64=True))
    reset_launches()
    t0 = time.perf_counter()
    d_op, d_vals, d_build, d_apply = run(pts_d, cfg=DF32_CFG)
    d_wall = time.perf_counter() - t0
    d_launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(d_op.refs_lo is not None and d_vals.dtype == torch.float64,
          "the df32 polish did not run")
    d_rels = max_rel_columns(d_vals, truth)
    d_rel = max(d_rels)
    # K4 and K5 at this shape: the first chunk through the plain twins,
    # pair refs and all 3 columns where the elements agree; then each
    # kernel on the run's own sparse rows against its twin
    dp_op, _, _, _ = run(q, cfg=DF32_CFG, plain=True)
    dp_vals = polish.apply_pairs_ref(dp_op.refs, dp_op.refs_lo,
                                     dp_op.elements, fields, order, 3)
    d_same = d_op.elements[:ROWS] == dp_op.elements
    d_agree = float(d_same.double().mean())
    pair = d_op.refs[:ROWS].double() + d_op.refs_lo[:ROWS].double()
    p_pair = dp_op.refs.double() + dp_op.refs_lo.double()
    d_ref_diff = float((pair - p_pair)[d_same].abs().max())
    d_vdiffs = [float(c) for c in (
        (d_vals[:ROWS] - dp_vals).abs() / dp_vals.abs())[d_same].amax(dim=0)]
    del dp_op, dp_vals, pair, p_pair
    prep = _locate._mesh_prep(src.points, order, dev, want64=True)
    el = d_op.elements[:ROWS].contiguous()
    pargs = (q.contiguous(), el, d_op.refs[:ROWS].contiguous(), prep.ctr,
             prep.inv_scale, prep.nodes64, order, dim,
             DF32_CFG.df32_polish_iters)
    hi, lo, ok = polish.polish_pairs(*pargs)
    t_hi, t_lo, t_ok = polish.polish_pairs_ref(*pargs)
    k4_ok_agree = float((ok == t_ok).double().mean())
    k4_diff = float(((hi.double() + lo.double())
                     - (t_hi.double() + t_lo.double()))[ok & t_ok].abs().max())
    k4_times = _grouped_times(polish.polish_pairs, polish._polish_kernel,
                              pargs, el, E)
    aargs = (d_op.refs[:ROWS].contiguous(),
             d_op.refs_lo[:ROWS].contiguous(), el, fields, order, 3)
    k5_rel, _, _, k5_got = _apply_rel(aargs)
    k5_col_rel = [float(c) for c in (
        (k5_got - d_vals[:ROWS]).abs() / d_vals[:ROWS].abs()).amax(dim=0)]
    k5_times = _grouped_times(polish.apply_pairs, polish._apply_kernel,
                              aargs, el, E)
    big_pairs = {
        "rows": ROWS, "distinct_elements": int(torch.unique(el).numel()),
        "plain_elements_agree": d_agree,
        "plain_max_abs_ref_diff": d_ref_diff,
        "plain_max_rel_diff_columns": d_vdiffs,
        "k4_ok_agree": k4_ok_agree, "k4_max_abs_diff_vs_twin": k4_diff,
        **{f"k4_{k}": v for k, v in k4_times.items()},
        "k5_max_rel_diff_vs_twin": k5_rel,
        "k5_max_rel_diff_vs_run_columns": k5_col_rel,
        **{f"k5_{k}": v for k, v in k5_times.items()}}
    del hi, lo, ok, t_hi, t_lo, t_ok, pargs, aargs, k5_got
    walls_sorted = sorted(walls)
    emit({"phase": "big slice", "nvidia_smi": smi, "targets": N_TARGETS,
          "elements": E, "params": 3, "walls_s": walls,
          "wall_median_s": walls_sorted[1],
          "wall_spread_s": walls_sorted[-1] - walls_sorted[0],
          "build_s": builds, "apply_s": applies,
          "mpts_per_s_median": N_TARGETS / walls_sorted[1] / 1e6,
          "one_chunk_locate_s": chunk_s, "n_retry": n_retry,
          "launches": launches, "max_rel_err": rel,
          "max_rel_err_columns": rels,
          "plain_elements_agree": agree, "plain_max_rel_diff": vdiff,
          "df32": {"prep64_s": prep64_s, "wall_s": d_wall,
                   "build_s": d_build, "apply_s": d_apply,
                   "launches": d_launches, "max_rel_err": d_rel,
                   "max_rel_err_columns": d_rels,
                   "n_retry": d_op.n_retry, "first_chunk": big_pairs},
          # of the phase up to the df32 run; then with the twins' chunk
          "peak_mem_gb": peak_gb, "peak_mem_gb_with_twins":
              torch.cuda.max_memory_allocated() / 1e9})
    check(rel < 1e-6, f"big slice max rel err {rel:.3g} >= 1e-6")
    check(agree >= 0.999, f"big plain path elements agree {agree:.6f}")
    check(vdiff <= 1e-5, f"big plain path values differ by {vdiff:.3g}")
    check(d_rel < 1e-8, f"big df32 max rel err {d_rel:.3g} >= 1e-8")
    check(all(d_launches[k] > 0 for k in ("newton_rows", "polish_pairs",
                                          "apply_pairs")),
          f"a kernel of the big df32 path was not launched: {d_launches}")
    check(d_agree >= 0.999, f"big df32 plain path elements agree "
          f"{d_agree:.6f}")
    check(d_ref_diff <= 1e-10, f"big df32 plain path pair refs differ by "
          f"{d_ref_diff:.3g}")
    check(max(d_vdiffs) <= 1e-10, f"big df32 plain path values differ by "
          f"{d_vdiffs}")
    check(k4_ok_agree >= 0.9999, f"big K4 ok agreement {k4_ok_agree:.6f}")
    check(k4_diff <= 1e-11, f"big K4 hi+lo differ by {k4_diff:.3g}")
    check(k5_rel <= 1e-12, f"big K5 values differ by {k5_rel:.3g} relative")
    check(max(k5_col_rel) <= 1e-12, f"big K5 on the run's rows differs "
          f"from the run's values by {k5_col_rel}")
    return d_launches, k4_diff, k5_rel


def _median_spread(walls):
    w = sorted(walls)
    return w[len(w) // 2], w[-1] - w[0]


def _rel_np(got, truth):
    return float(np.max(np.abs(got - truth) / np.abs(truth)))



def _cli_exodus(f_a, f_b0, f_b, tmpdir):
    """Where ``click`` imports: ``python -m multimesh_tpu_torch.cli
    interpolate-mesh-a-to-b`` in a subprocess (device ``cuda``, the
    default) onto a fresh copy of the target; its output file must equal
    ``engine.exodus_2_exodus``'s ``f_b`` byte for byte.  Returns the
    line's fields."""
    if importlib.util.find_spec("click") is None:
        return {"click": False}
    f_cli = os.path.join(tmpdir, "exo_b_cli.e")
    shutil.copyfile(f_b0, f_cli)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "multimesh_tpu_torch.cli",
         "interpolate-mesh-a-to-b", "--mesh_a", f_a, "--mesh_b", f_cli,
         "--params", "VP"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"the CLI exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    with open(f_cli, "rb") as a, open(f_b, "rb") as b:
        same = a.read() == b.read()
    check(same, "the CLI's output file differs from exodus_2_exodus's")
    return {"click": True, "cli_wall_s": wall, "cli_file_bit_equal": same}


def phase_exodus(dev, smi, tmpdir):
    """Exodus -> Exodus, file to file (see the module docstring).  Returns
    the launch counts of the first call."""
    src, tgt = testing.shell_mesh(**EXO_SRC), testing.shell_mesh(**EXO_TGT)
    f_a = os.path.join(tmpdir, "exo_a.e")
    f_b0 = os.path.join(tmpdir, "exo_b_pristine.e")
    f_b = os.path.join(tmpdir, "exo_b.e")
    testing.write_exodus_fixture(f_a, src, parameters=("VP",))
    testing.write_exodus_fixture(f_b0, tgt, parameters=("VP",),
                                 field_kind="linear")

    def run():
        shutil.copyfile(f_b0, f_b)
        return _host_s(lambda: engine.exodus_2_exodus(
            f_a, f_b, parameters=["VP"], device=dev))[1]

    clear_caches()
    reset_launches()
    wall_first = run()
    launches = read_launches()
    walls = [run() for _ in range(3)]
    got = eio.Exodus(f_b).get_nodal_field("VP")
    truth = testing.smooth_field(tgt.vertices)
    cli = _cli_exodus(f_a, f_b0, f_b, tmpdir)
    rel = _rel_np(got, truth)
    check(got.shape == (tgt.vertices.shape[0],) and np.isfinite(got).all(),
          f"written VP {got.shape}")
    check(launches["newton_rows"] > 0 and launches["nearest_centroid"] == 0,
          f"the Exodus path's launches {launches}")

    # the plain path on the arrays the files hold
    exo_a, exo_b = eio.Exodus(f_a), eio.Exodus(f_b0)
    check(exo_a.nelem == src.nelem > grid.APPROX_GRID_MIN_SOURCES,
          f"{exo_a.nelem} hexes do not take the grid route")
    conn = exo_a.canonical_connectivity()
    p_op = TransferOperator.build(
        exo_a.canonical_corner_nodes(), exo_b.points, order=1, cfg=EXO_CFG,
        fallback="best", device=dev, plain=True)
    p_vals = p_op.apply(exo_a.get_nodal_field("VP")[conn]).cpu().numpy()
    p_rel = _rel_np(p_vals, truth)
    vdiff = _rel_np(got, p_vals)
    median, spread = _median_spread(walls)
    emit({"phase": "exodus", "nvidia_smi": smi, "hexes": src.nelem,
          "nodes": int(got.shape[0]), "params": 1, "wall_first_s": wall_first,
          "walls_warm_s": walls, "wall_warm_median_s": median,
          "wall_warm_spread_s": spread,
          "mnodes_per_s_warm": got.shape[0] / median / 1e6,
          "launches": launches,
          "num_missing_plain": p_op.num_missing,
          "max_rel_err_vs_analytic": rel,
          "plain_max_rel_err_vs_analytic": p_rel,
          "plain_max_rel_diff": vdiff, **cli})
    check(p_op.num_missing == 0, "the plain path left a node unassigned")
    # a trilinear source: the error is its discretisation's, so it is held
    # to the plain path's, and both to the reference's 5e-3
    check(rel < 5e-3, f"Exodus max rel err {rel:.3g} >= 5e-3")
    check(vdiff <= 1e-5, f"Exodus plain path values differ by {vdiff:.3g}")
    check(abs(rel - p_rel) <= 1e-5, f"Exodus error {rel:.6g} against the "
          f"plain path's {p_rel:.6g}")
    return launches


def phase_exodus_gll(dev, smi, tgt, tmpdir):
    """Exodus -> GLL through the arrays core (see the module docstring).
    Returns the launch counts of a warm call and K1's entry keys on the
    source's sparse order-1 rows."""
    src = testing.shell_mesh(**E2G_SRC)
    params = list(FILE_PARAMS)
    f_exo = os.path.join(tmpdir, "e2g_src.e")
    testing.write_exodus_fixture(f_exo, src, parameters=FILE_PARAMS)
    exo = eio.Exodus(f_exo)
    check(exo.nelem == src.nelem > grid.APPROX_GRID_MIN_SOURCES,
          f"{exo.nelem} hexes do not take the grid route")
    corner_nodes = exo.canonical_corner_nodes()
    conn = exo.canonical_connectivity()
    fields = np.stack([exo.get_nodal_field(p)[conn] for p in params])
    # what exodus_2_gll hands its core: the target coordinates as f32
    coords = tgt.points.astype(np.float32)
    n_slots = tgt.nelem * tgt.n_gll
    sink = np.empty((tgt.nelem, len(params), tgt.n_gll), np.float32)

    def open_sink(names):
        check(names == params, f"sink opened for {names}")
        sink.fill(np.nan)
        return sink

    def run():
        return _host_s(lambda: engine.exodus_2_gll_arrays(
            corner_nodes, fields, params, coords, open_sink,
            device=dev))[1]

    clear_caches()
    wall_first = run()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(3):
        reset_launches()
        walls.append(run())
        launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(launches["newton_rows"] > 0 and launches["nearest_centroid"] == 0,
          f"the Exodus -> GLL path's launches {launches}")
    check(bool(np.isfinite(sink).all()), "the sink holds non-finite values")
    truth = np.stack(list(testing.salvus_fixture_fields(
        tgt, FILE_PARAMS)[0].values())[:3], axis=1)
    rels = [float(x) for x in np.max(
        np.abs(sink - truth) / np.abs(truth), axis=(0, 2))]

    # the operator built and applied in memory: bit for bit the sink
    flat = torch.as_tensor(coords.reshape(-1, 3), device=dev)
    op = TransferOperator.build(corner_nodes, flat, order=1, cfg=EXO_CFG,
                                fallback="best", device=dev)
    f_dev = torch.as_tensor(fields, device=dev)
    mem = op.apply(f_dev).view(tgt.nelem, tgt.n_gll, len(params)).transpose(
        1, 2).float().cpu().numpy()
    check(op.num_missing == 0, f"{op.num_missing} slots missing")
    check(np.array_equal(mem, sink), "the sink differs from the in-memory "
          "operator's values")
    n_retry, n_missing = op.n_retry, op.num_missing
    del mem

    # the first chunk through the plain path: values, not element ids (a
    # slot on a face of the order-1 source is accepted by two hexes)
    p_op = TransferOperator.build(corner_nodes, flat[:ROWS], order=1,
                                  cfg=EXO_CFG, fallback="best", device=dev,
                                  plain=True)
    v, pv = op.apply(f_dev)[:ROWS], p_op.apply(f_dev)
    agree = float((op.elements[:ROWS] == p_op.elements).double().mean())
    vdiff = float(((v - pv).abs() / pv.abs()).max())

    # K1 at order 1 on round 1's rows, on the corner lattice: the path's
    # own first chunk (slots in element order, so few hexes occur among
    # them) and ROWS slots spread over the whole target (sparse ids over
    # the 57,600 hexes)
    prep = _locate._mesh_prep(corner_nodes, 1, dev)
    index = grid.get_grid_index(prep.centroids_host, _locate.ROUND1_MEMBERS,
                                dev)
    k1, k1_checks = {}, []
    for tag, q in (("chunk", flat[:ROWS]),
                   ("sparse", flat[::flat.shape[0] // ROWS][:ROWS])):
        q = q.double().contiguous()
        cand = grid.nearest_member(index, q, n_probe=_locate.ROUND1_PROBES)
        args = (q, cand.contiguous(), prep.ctr, prep.inv_scale, prep.nodes,
                1, 3, ITERS, LocateConfig().newton_clamp)
        k_ref, k_res = newton.newton_rows(*args)
        t_ref, t_res = newton.newton_refs_rows_ref(*args)
        torch.cuda.synchronize()
        ka = (k_res < CONV_TOL) & (k_ref.abs().amax(-1) < EXO_CFG.accept_tol)
        ta = (t_res < CONV_TOL) & (t_ref.abs().amax(-1) < EXO_CFG.accept_tol)
        acc_agree = float((ka == ta).double().mean())
        k1_err = float((k_ref - t_ref)[ka & ta].abs().max())
        times = _grouped_times(newton.newton_rows, newton._newton_kernel,
                               args, args[1], src.nelem)
        plain_ms = cuda_ms(lambda: newton.newton_refs_rows_ref(*args), 3)
        bound_ms, bound_by = newton_bound(args, k_ref, k_res)
        k1.update({f"ms_order1_{tag}": times["ms"],
                   f"group_ms_order1_{tag}": times["group_ms"],
                   f"plain_ms_order1_{tag}": plain_ms,
                   f"bound_ms_order1_{tag}": bound_ms,
                   f"max_abs_err_order1_{tag}": k1_err})
        emit({"phase": "exodus_gll K1", "order_dim": "1/3", "rows_of": tag,
              "rows": ROWS, "elements": src.nelem,
              "distinct_elements": int(torch.unique(cand).numel()),
              "accepted": float(ka.double().mean()),
              "accept_agree": acc_agree, "max_abs_err_accepted": k1_err,
              **times, "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "bound_share": bound_ms / times["ms"]})
        k1_checks.append((tag, acc_agree, k1_err))
    del op, p_op, v, pv, f_dev, flat, q, cand, args, k_ref, t_ref

    # the stage seconds of one warm call
    os.environ["MMT_PROFILE"] = "1"
    try:
        utils_profile.reset_stages()
        wall_prof = run()
        stages = utils_profile.stage_totals()
    finally:
        del os.environ["MMT_PROFILE"]
    check({"e2g.locate", "operator.build", "e2g.apply", "e2g.stream_write"}
          <= set(stages),
          f"stages {sorted(stages)}")
    median, spread = _median_spread(walls)
    emit({"phase": "exodus_gll", "h5py": False, "nvidia_smi": smi,
          "hexes": src.nelem, "n_slots": n_slots, "params": len(params),
          "wall_first_s": wall_first, "walls_warm_s": walls,
          "wall_warm_median_s": median, "wall_warm_spread_s": spread,
          "mslots_per_s_warm": n_slots / median / 1e6,
          "launches": launches, "num_missing": n_missing,
          "n_retry": n_retry,
          "peak_mem_gb": peak_gb, "max_rel_err_vs_analytic": rels,
          "plain_elements_agree": agree, "plain_max_rel_diff": vdiff,
          "stages_s": stages, "wall_profiled_s": wall_prof})
    check(max(rels) < 5e-3, f"Exodus -> GLL max rel errs {rels} >= 5e-3")
    check(vdiff <= 1e-5, f"Exodus -> GLL plain path values differ by "
          f"{vdiff:.3g}")
    for tag, acc_agree, k1_err in k1_checks:
        check(acc_agree >= 0.9999, f"K1 1/3 {tag} rows: acceptance "
              f"agreement {acc_agree:.6f}")
        check(k1_err <= 1e-5, f"K1 1/3 {tag} rows: accepted refs differ by "
              f"{k1_err:.3g}")
    return launches, k1


def _live_mesh(mesh, params, field_kind, fluid=None):
    """make() -> a live mesh object, as a user of salvus would hold it:
    element-nodal points, a dict of element-nodal fields (each parameter a
    scaled copy of the analytic field) and the elemental ``layer`` and
    ``fluid`` (none fluid unless ``fluid`` flags some).  Every object gets
    a dict of its own over the same arrays: the engine attaches new
    arrays, it does not write into these."""
    nodal, elemental = testing.salvus_fixture_fields(mesh, params, fluid,
                                                     field_kind)
    return lambda: types.SimpleNamespace(points=mesh.points,
                                         element_nodal_fields=dict(nodal),
                                         elemental_fields=elemental)


def phase_layered(dev, smi):
    """The layered path on live mesh objects (see the module docstring).
    Returns the launch counts of its df32 call and the parameters a warm
    f32 call wrote (name -> [E, n])."""
    src, tgt = (testing.shell_mesh(**LAYERED_SRC),
                testing.shell_mesh(**LAYERED_TGT))
    params = list(LAYERED_PARAMS)
    n_slots = tgt.nelem * tgt.n_gll
    old = _live_mesh(src, LAYERED_PARAMS, "smooth")()
    fresh_target = _live_mesh(tgt, LAYERED_PARAMS, "linear")
    base = testing.smooth_field(tgt.points)
    truth = [base * (1 + 0.1 * i) for i in range(len(params))]
    del base

    written = {}

    def run(entry=engine.gll_2_gll_layered, **kw):
        """One call onto a fresh target (the linear field: a node left
        unwritten cannot pass): (wall seconds, max rel err by parameter);
        the written fields are left in ``written``."""
        new = fresh_target()
        wall = _host_s(lambda: entry(old, new, layers="all",
                                     parameters=params, device=dev,
                                     **kw))[1]
        written.update((p, new.element_nodal_fields[p]) for p in params)
        return wall, [_rel_np(new.element_nodal_fields[p], t)
                      for p, t in zip(params, truth)]

    clear_caches()
    wall_first, _ = run()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(3):
        reset_launches()
        wall, rels = run()
        walls.append(wall)
        launches = read_launches()
    # the f32 path's values, for phase_entries
    written_f32 = dict(written)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(launches["newton_rows"] > 0 and launches["nearest_centroid"] > 0,
          f"a kernel of the layered path was not launched: {launches}")

    # the stage seconds of one warm call
    os.environ["MMT_PROFILE"] = "1"
    try:
        utils_profile.reset_stages()
        wall_prof, _ = run()
        stages = utils_profile.stage_totals()
    finally:
        del os.environ["MMT_PROFILE"]
    check({"layered.masks_dedup", "layered.build", "operator.build",
           "layered.apply_write"} <= set(stages), f"stages {sorted(stages)}")

    # each layer's operator against one built directly on its arrays, and
    # that one's first chunk against the plain path: K1, K2 (and, polished,
    # K4 and K5) against their twins at the layers' shapes -- sources of
    # 1,024 elements, chunks of deduplicated points
    uniq_of = {}

    def layer_checks():
        """layer -> what was compared (``engine._locate_cfg`` reads
        MMT_DF32_POLISH, so the caller chooses the path)."""
        ops, src_masks, tgt_masks = engine._layered_operators(
            engine._as_salvus(old), engine._as_salvus(fresh_target()),
            "all", 20, None, accept_tol=1.04, fallback="fixed_ref",
            use_aabb=True, device=dev)
        kw = dict(order=src.order, cfg=engine._locate_cfg(20, accept_tol=1.04),
                  device=dev, **FLAGSHIP_KW)
        out = {}
        for layer, op in ops.items():
            if layer not in uniq_of:
                uniq_of[layer] = dedup.unique_points(
                    tgt.points[tgt_masks[layer]])
            uniq, recon = uniq_of[layer]
            src_l = src.points[src_masks[layer]]
            direct = TransferOperator.build(src_l, uniq, **kw)
            polished = direct.refs_lo is not None
            same = (torch.equal(op.elements, direct.elements)
                    and torch.equal(op.refs, direct.refs)
                    and (not polished
                         or torch.equal(op.refs_lo, direct.refs_lo))
                    and np.array_equal(op.recon.cpu().numpy(), recon))
            p_op = TransferOperator.build(src_l, uniq[:ROWS], plain=True,
                                          **kw)
            f_l = torch.as_tensor(np.stack(
                [old.element_nodal_fields[p][src_masks[layer]]
                 for p in params]), dtype=torch.float64, device=dev)
            vals = direct.apply(f_l)[:ROWS]
            if polished:
                p_vals = polish.apply_pairs_ref(
                    p_op.refs, p_op.refs_lo, p_op.elements, f_l, src.order, 3)
                pair = (direct.refs[:ROWS].double()
                        + direct.refs_lo[:ROWS].double())
                p_pair = p_op.refs.double() + p_op.refs_lo.double()
            else:
                p_vals = p_op.apply(f_l)
                pair, p_pair = direct.refs[:ROWS], p_op.refs
            agree = ((direct.elements[:ROWS] == p_op.elements)
                     & (direct.found[:ROWS] == p_op.found))
            out[layer] = {
                "source_elements": int(src_masks[layer].sum()),
                "slots": int(tgt_masks[layer].sum()) * tgt.n_gll,
                "unique": int(uniq.shape[0]), "n_retry": op.n_retry,
                "num_missing": op.num_missing, "equal_direct": same,
                "plain_rows": int(p_op.elements.shape[0]),
                "plain_found_agree": float(
                    (direct.found[:ROWS] == p_op.found).double().mean()),
                "plain_elements_agree": float(agree.double().mean()),
                "plain_max_abs_ref_diff": float(
                    (pair - p_pair)[agree].abs().max()),
                "plain_max_rel_diff": float(
                    ((vals - p_vals).abs() / p_vals.abs())[agree].max())}
            check(same, f"layer {layer}'s operator differs from the one "
                  "built directly on its arrays")
        return out

    def hold_plain(layers, ref_tol, val_tol, what):
        for layer, c in layers.items():
            check(c["plain_rows"] == ROWS, f"{what} layer {layer}: "
                  f"{c['plain_rows']} rows through the plain path")
            check(c["plain_found_agree"] >= 0.999
                  and c["plain_elements_agree"] >= 0.999,
                  f"{what} layer {layer}: plain path agrees on found "
                  f"{c['plain_found_agree']:.6f}, on elements "
                  f"{c['plain_elements_agree']:.6f}")
            check(c["plain_max_abs_ref_diff"] <= ref_tol,
                  f"{what} layer {layer}: plain path refs differ by "
                  f"{c['plain_max_abs_ref_diff']:.3g}")
            check(c["plain_max_rel_diff"] <= val_tol,
                  f"{what} layer {layer}: plain path values differ by "
                  f"{c['plain_max_rel_diff']:.3g}")

    layers = layer_checks()

    # multi_two's semantics (snap, tolerance 1.05, 30 candidates), once
    wall_two, rels_two = run(engine.gll_2_gll_layered_multi_two)

    # the polished path
    os.environ["MMT_DF32_POLISH"] = "1"
    try:
        run()  # the prep with the f64 lattice first
        reset_launches()
        wall_df32, rels_df32 = run()
        launches_df32 = read_launches()
        layers_df32 = layer_checks()
    finally:
        del os.environ["MMT_DF32_POLISH"]
    median, spread = _median_spread(walls)
    emit({"phase": "layered", "nvidia_smi": smi, "n_slots": n_slots,
          "elements": src.nelem, "target_elements": tgt.nelem,
          "n_layers": len(layers), "params": len(params),
          "wall_first_s": wall_first, "walls_warm_s": walls,
          "wall_warm_median_s": median, "wall_warm_spread_s": spread,
          "mslots_per_s_warm": n_slots / median / 1e6,
          "launches": launches, "max_rel_err": rels, "layers": layers,
          "peak_mem_gb": peak_gb, "stages_s": stages,
          "wall_profiled_s": wall_prof,
          "multi_two": {"wall_s": wall_two, "max_rel_err": rels_two},
          "df32": {"wall_s": wall_df32, "max_rel_err": rels_df32,
                   "launches": launches_df32, "layers": layers_df32}})
    check(max(rels) < 1e-6, f"layered max rel errs {rels} >= 1e-6")
    hold_plain(layers, 1e-5, 1e-5, "layered")
    hold_plain(layers_df32, 1e-10, 1e-10, "layered df32")
    check(max(rels_two) < 1e-6, f"multi_two max rel errs {rels_two} >= 1e-6")
    check(max(rels_df32) < 1e-8, f"layered df32 max rel errs {rels_df32} "
          ">= 1e-8")
    check(all(launches_df32[k] > 0 for k in (
        "newton_rows", "nearest_centroid", "polish_pairs", "apply_pairs")),
        f"a kernel of the layered df32 path was not launched: "
        f"{launches_df32}")
    return launches_df32, written_f32


def _netcdf3_check(ds, params):
    """``ds.to_netcdf(format="NETCDF3_64BIT")`` (scipy, no HDF5) into a
    temporary directory, read back with ``scipy.io.netcdf_file``: each
    variable and coordinate against ``ds``'s, value for value."""
    from scipy.io import netcdf_file

    with tempfile.TemporaryDirectory() as tmpdir:
        path = os.path.join(tmpdir, "grid.nc")
        t0 = time.perf_counter()
        ds.to_netcdf(path, format="NETCDF3_64BIT")
        wall = time.perf_counter() - t0
        with netcdf_file(path, "r", mmap=False) as f:
            var = f.variables
            same = all(np.array_equal(var[p].data, ds.data[p])
                       for p in params)
            coords = all(np.array_equal(var[name].data, ds.coords[name])
                         for name in ("depth", "latitude", "longitude"))
        size = os.path.getsize(path)
    return {"format": "NETCDF3_64BIT", "bytes": size, "write_s": wall,
            "variables_equal": same, "coordinates_equal": coords}


def phase_points(dev, smi, src):
    """The point queries (see the module docstring).  Returns the launch
    counts of the regular-grid call and of the ``grid2d`` one."""
    params = list(FILE_PARAMS)
    mesh = _live_mesh(src, FILE_PARAMS, "smooth")()
    extents = dict(lat_extent=GRID_LAT, lon_extent=GRID_LON,
                   depth_extent=GRID_DEPTH)

    def run():
        return _host_s(lambda: engine.extract_regular_grid(
            mesh, params, device=dev, **extents))

    clear_caches()
    _, wall_first = run()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    ds, wall = run()
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(launches["newton_rows"] > 0 and launches["nearest_centroid"] > 0,
          f"a kernel of the regular-grid path was not launched: {launches}")

    # once more under MMT_PROFILE=1 for the stage seconds, with the scan
    # retry timed (device-complete on both sides)
    retry = {"s": 0.0, "rows": 0}
    rescan = _locate._rescan

    def timed_rescan(rows, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rescan(rows, *a, **k)
        torch.cuda.synchronize()
        retry["s"] += time.perf_counter() - t0
        retry["rows"] += int(rows.shape[0])

    _locate._rescan = timed_rescan
    os.environ["MMT_PROFILE"] = "1"
    try:
        utils_profile.reset_stages()
        _, wall_timed = run()
        stages = utils_profile.stage_totals()
    finally:
        del os.environ["MMT_PROFILE"]
        _locate._rescan = rescan
    check({"operator.build", "points.apply"} <= set(stages),
          f"stages {sorted(stages)}")

    # one chunk of the grid through the plain path, sentinel fallback and
    # scan retry included: the engine's 20th chunk, 5.6 depth levels from
    # the middle of the grid, each with points inside and outside (the
    # first chunk lies wholly above the surface)
    dd, la, lo = np.meshgrid(ds.depth, ds.lat, ds.lon, indexing="ij")
    start = dd.size // 2 // ROWS * ROWS
    rows = slice(start, start + ROWS)
    chunk = utils.latlondepth_to_xyz(np.stack(
        [la.ravel()[rows], lo.ravel()[rows], dd.ravel()[rows]], axis=-1))
    f_dev = torch.as_tensor(
        np.stack([mesh.element_nodal_fields[p] for p in params]), device=dev)
    kw = dict(order=src.order, cfg=engine.DEFAULT_LOCATE,
              fallback="sentinel", prefilter_m=engine.PREFILTER_M, device=dev)
    k_op = TransferOperator.build(src.points, chunk, **kw)
    p_op = TransferOperator.build(src.points, chunk, plain=True, **kw)
    k_vals, p_vals = k_op.apply(f_dev), p_op.apply(f_dev)
    found_agree = k_op.found == p_op.found
    same = found_agree & (k_op.elements == p_op.elements)
    hit = same & k_op.found
    run_vals = torch.as_tensor(np.stack(
        [ds[p].ravel()[rows] for p in params], axis=-1),
        dtype=k_vals.dtype, device=dev)
    plain_chunk = {
        "rows": ROWS, "first_row": start,
        "found": float(k_op.found.double().mean()),
        "n_retry": k_op.n_retry, "n_retry_plain": p_op.n_retry,
        "found_agree": float(found_agree.double().mean()),
        "elements_agree": float(same.double().mean()),
        "max_rel_diff": float(
            ((k_vals - p_vals).abs() / p_vals.abs())[hit].max()),
        "missing_rows_zero": bool((k_vals[~k_op.found] == 0).all()
                                  and (p_vals[~p_op.found] == 0).all()),
        "rows_equal_run": float(
            (k_vals == run_vals).all(dim=-1).double().mean())}
    del k_op, p_op, k_vals, p_vals, run_vals, f_dev, chunk

    # where each grid point lies: the source spans colatitude 0.5..1.2,
    # longitude 0.3..1.4 rad and radius 3.48e6..6.371e6 m in 16 elements
    # each way; a point within 5% of an element's width of the hull may
    # or may not be accepted (accept_tol 1.05), and is held to neither
    shape3 = (GRID_DEPTH[2], GRID_LAT[2], GRID_LON[2])
    r = 6.371e6 - dd
    colat, lon = np.deg2rad(90.0 - la), np.deg2rad(lo)
    inside = np.ones(shape3, bool)
    outside = np.zeros(shape3, bool)
    for x, (a, b) in ((r, (3.48e6, 6.371e6)), (colat, (0.5, 1.2)),
                      (lon, (0.3, 1.4))):
        band = 0.05 * (b - a) / 16
        inside &= (x >= a) & (x <= b)
        outside |= (x < a - band) | (x > b + band)
    truth = testing.smooth_field(np.stack(
        [r * np.sin(colat) * np.cos(lon), r * np.sin(colat) * np.sin(lon),
         r * np.cos(colat)], -1))
    del dd, la, lo, r, colat, lon
    rels, zeros, nonzero = [], True, True
    for i, p in enumerate(params):
        check(ds[p].shape == shape3, f"{p} {ds[p].shape}")
        zeros &= bool((ds[p][outside] == 0).all())
        nonzero &= bool((ds[p][inside] != 0).all())
        rels.append(_rel_np(ds[p][inside], truth[inside] * (1 + 0.1 * i)))
    n_points = int(np.prod(shape3))
    netcdf = _netcdf3_check(ds, params)
    emit({"phase": "points", "nvidia_smi": smi, "n_points": n_points,
          "elements": src.nelem, "params": len(params),
          "share_outside": float(outside.mean()),
          "share_inside": float(inside.mean()),
          "wall_first_s": wall_first, "wall_s": wall,
          "mpts_per_s": n_points / wall / 1e6, "launches": launches,
          "n_retry": retry["rows"], "retry_s": retry["s"],
          "wall_retry_timed_s": wall_timed,
          "retry_share_of_wall": retry["s"] / wall_timed,
          "stages_s": stages,
          "outside_rows_zero": zeros, "inside_rows_nonzero": nonzero,
          "max_rel_err_inside": rels, "peak_mem_gb": peak_gb,
          "plain_chunk": plain_chunk, "to_netcdf": netcdf})
    check(netcdf["variables_equal"] and netcdf["coordinates_equal"],
          f"the NETCDF3 file does not read back as written: {netcdf}")
    check(zeros, "a grid point outside the shell is not zero")
    check(0.05 < plain_chunk["found"] < 0.95 and plain_chunk["n_retry"] > 0,
          f"the plain path's chunk does not mix inside and outside rows: "
          f"{plain_chunk}")
    check(plain_chunk["found_agree"] >= 0.999
          and plain_chunk["elements_agree"] >= 0.999,
          f"regular grid plain path: found agree "
          f"{plain_chunk['found_agree']:.6f}, elements "
          f"{plain_chunk['elements_agree']:.6f}")
    check(plain_chunk["max_rel_diff"] <= 1e-5, "regular grid plain path "
          f"values differ by {plain_chunk['max_rel_diff']:.3g}")
    check(plain_chunk["missing_rows_zero"], "a row without an element is "
          "not zero")
    check(plain_chunk["rows_equal_run"] >= 0.999, "the chunk built alone "
          f"equals the run's rows on {plain_chunk['rows_equal_run']:.6f}")
    check(nonzero, "a grid point inside the shell was not located")
    check(max(rels) < 1e-6, f"regular grid max rel errs {rels} >= 1e-6")
    del ds, truth, inside, outside

    # bench.py's grid2d shape: K1 at 4/2 on the main path
    src2 = testing.box_mesh(**GRID2D_SRC)
    gx, gy = np.meshgrid(np.linspace(0.02, 0.98, GRID2D_N),
                         np.linspace(0.02, 0.98, GRID2D_N))
    pts = np.stack([gx.ravel(), gy.ravel()], -1)
    field = torch.as_tensor(testing.element_nodal_field(src2, "smooth"),
                            device=dev)

    def run2d(plain=False):
        def build_apply():
            op = TransferOperator.build(
                src2.points, pts, order=src2.order, cfg=SLICE_CFG,
                fallback="sentinel", device=dev, plain=plain)
            return op, op.apply(field)

        (op, vals), wall = _host_s(build_apply)
        return op, vals, wall

    run2d()
    reset_launches()
    op, vals, wall2d = run2d()
    launches2d = read_launches()
    p_op, p_vals, _ = run2d(plain=True)
    truth2 = torch.as_tensor(testing.smooth_field(pts), device=dev)
    rel2 = max_rel(vals, truth2)
    same = op.elements == p_op.elements
    agree = float(same.double().mean())
    vdiff = float(((vals - p_vals).abs() / p_vals.abs()).max())
    emit({"phase": "grid2d", "n_points": int(pts.shape[0]),
          "elements": src2.nelem, "order_dim": "4/2", "wall_s": wall2d,
          "mpts_per_s": pts.shape[0] / wall2d / 1e6,
          "launches": launches2d, "num_missing": op.num_missing,
          "max_rel_err": rel2, "plain_elements_agree": agree,
          "plain_max_rel_diff": vdiff})
    check(launches2d["newton_rows"] > 0, f"K1 was not launched at 4/2: "
          f"{launches2d}")
    check(op.num_missing == 0, f"grid2d left {op.num_missing} points")
    check(rel2 < 1e-6, f"grid2d max rel err {rel2:.3g} >= 1e-6")
    check(vdiff <= 1e-5, f"grid2d plain path values differ by {vdiff:.3g}")
    return launches, launches2d


def _entry_walls(fn, n_warm=3, setup=None):
    """The first call of ``fn`` and ``n_warm`` warm ones, each after
    ``setup()`` (not timed), the counts set to 0 just before it, its wall
    ending in a device sync: (the last result, the first wall, the warm
    walls, the launches of the last call, the peak device memory of the
    warm calls in GB, or of the first where there is none)."""
    walls = []
    for i in range(1 + n_warm):
        if setup is not None:
            setup()
        if i <= 1:
            torch.cuda.reset_peak_memory_stats()
        out = None  # the last result goes before the next call
        reset_launches()
        out, wall = _host_s(fn)
        launches = read_launches()
        walls.append(wall)
    return (out, walls[0], walls[1:], launches,
            torch.cuda.max_memory_allocated() / 1e9)


def _entry_line(smi, entry, first, walls, launches, peak_gb, **rest):
    """One ``entries`` line: the entry's walls, launches and peak, and
    ``rest`` (its checks' figures)."""
    median, spread = _median_spread(walls)
    emit({"phase": "entries", "entry": entry, "nvidia_smi": smi,
          "device_argument": "omitted", "wall_first_s": first,
          "walls_warm_s": walls, "wall_warm_median_s": median,
          "wall_warm_spread_s": spread, "launches": launches,
          "peak_mem_gb": peak_gb, **rest})


def _check_launched(entry, launches, kernels, absent=()):
    for k in kernels:
        check(launches[k] > 0, f"{entry}: {k} was not launched: {launches}")
    for k in absent:
        check(launches[k] == 0, f"{entry}: {k} was launched: {launches}")


def _plain_chunk(dev, src_points, chunk, fields, run_vals, **kw):
    """``chunk``'s targets through the kernels and through the plain twins
    (``TransferOperator.build(..., **kw)``, both on the card) against
    ``run_vals`` [rows, P], the entry's values there: the shares of rows
    whose found flag and element agree, the largest relative difference of
    the plain values from the entry's on the rows both found, and the
    share of rows where the kernels' values built on the chunk alone equal
    the entry's (to f64 rounding: ``run_vals`` may be derived from them).
    Values, not elements, are held: a target node on a face that two
    source elements share is accepted by either."""
    k_op = TransferOperator.build(src_points, chunk, device=dev, **kw)
    p_op = TransferOperator.build(src_points, chunk, device=dev, plain=True,
                                  **kw)
    fields = torch.as_tensor(fields, device=dev)
    k_vals = k_op.apply(fields).double().reshape(len(chunk), -1)
    p_vals = p_op.apply(fields).double().reshape(len(chunk), -1)
    run = torch.as_tensor(run_vals, device=dev).double().reshape(
        len(chunk), -1)
    found_agree = k_op.found == p_op.found
    same = found_agree & (k_op.elements == p_op.elements)
    hit = found_agree & p_op.found
    return {"rows": len(chunk),
            "found_agree": float(found_agree.double().mean()),
            "elements_agree": float(same.double().mean()),
            "max_rel_diff": float(
                ((run - p_vals).abs() / p_vals.abs())[hit].max()),
            "rows_equal_run": float(
                ((k_vals - run).abs() <= 1e-12 * run.abs())
                .all(dim=-1).double().mean())}


def _hold_plain(entry, plain):
    check(plain["found_agree"] >= 0.999, f"{entry}: the plain path agrees "
          f"on found {plain['found_agree']:.6f}")
    check(plain["max_rel_diff"] <= 1e-5, f"{entry}: the plain path's "
          f"values differ by {plain['max_rel_diff']:.3g}")
    check(plain["rows_equal_run"] >= 0.999, f"{entry}: the chunk built "
          f"alone equals the entry's rows on {plain['rows_equal_run']:.6f}")


def _sphere_mapped(points, z_node_1d):
    """A copy of ``points`` mapped to the sphere as ``ops.spherical``
    maps a mesh (radius 6.371e6 * ``z_node_1d``)."""
    mesh = types.SimpleNamespace(
        points=points.copy(), element_nodal_fields={"z_node_1D": z_node_1d})
    spherical.map_to_sphere(mesh)
    return mesh.points


def phase_entries_mesh(dev, smi, src, tgt):
    """``api.interpolate_to_mesh`` and ``ops.spherical.map_to_ellipse``
    from the ``gll`` source onto the file target, ``device`` omitted (see
    the module docstring).  Returns the launch counts of each entry's last
    call."""
    src0, tgt0 = src.points.copy(), tgt.points.copy()
    rows = slice(0, ROWS)

    # (a) both lattices mapped to spheres in place, the four parameters
    # interpolated and attached, the geometry restored
    params = list(ENTRY_PARAMS)
    old = _live_mesh(src, ENTRY_PARAMS, "smooth")()
    fresh_new = _live_mesh(tgt, ENTRY_PARAMS, "linear")

    def run_a():
        new = fresh_new()
        api.interpolate_to_mesh(old, new)
        return new

    clear_caches()
    new, first, walls, launches_a, peak = _entry_walls(run_a)
    restored = bool(np.array_equal(src.points, src0)
                    and np.array_equal(tgt.points, tgt0))
    base = testing.smooth_field(tgt.points)
    rels = [_rel_np(new.element_nodal_fields[p], base * (1 + 0.1 * i))
            for i, p in enumerate(params)]
    del base
    z_tgt = new.element_nodal_fields["z_node_1D"].reshape(-1)
    plain_a = _plain_chunk(
        dev, _sphere_mapped(src0, old.element_nodal_fields["z_node_1D"]),
        _sphere_mapped(tgt0.reshape(-1, 3)[rows], z_tgt[rows]),
        np.stack([old.element_nodal_fields[p] for p in params]),
        np.stack([new.element_nodal_fields[p].reshape(-1)[rows]
                  for p in params], axis=-1),
        order=src.order, cfg=engine.DEFAULT_LOCATE, fallback="sentinel",
        prefilter_m=PREFILTER_M)
    _entry_line(smi, "interpolate_to_mesh", first, walls, launches_a, peak,
                call="api.interpolate_to_mesh(old, new)",
                source_elements=src.nelem, target_nodes=int(z_tgt.size),
                params=len(params), max_rel_err=rels,
                lattices_restored=restored, plain_chunk=plain_a)
    del new
    check(restored, "interpolate_to_mesh left a lattice changed")
    check(max(rels) < 1e-6, f"interpolate_to_mesh max rel errs {rels}")
    _hold_plain("interpolate_to_mesh", plain_a)
    _check_launched("interpolate_to_mesh", launches_a,
                    ("newton_rows", "nearest_centroid"))

    # (b) the source stretched to the WGS84 ellipsoid's first-order shape,
    # its radius ratio carried onto a writable copy of the target
    base = testing.elliptic_mesh(src)
    base0 = base.points.copy()
    target = testing.elliptic_mesh(tgt, flattening=0.0)
    z_b = base.element_nodal_fields["z_node_1D"]
    z_t = target.element_nodal_fields["z_node_1D"]

    def restore_target():
        target.points[...] = tgt0

    _, first, walls, launches_b, peak = _entry_walls(
        lambda: spherical.map_to_ellipse(base, target), setup=restore_target)
    want = 1.0 + testing.ellipticity(tgt0)
    ratio = np.linalg.norm(target.points, axis=-1) / (R_EARTH_M * z_t)
    ratio_err = float(np.max(np.abs(ratio - want) / want))
    base_restored = bool(np.array_equal(base.points, base0))
    sphere_rows = _sphere_mapped(tgt0.reshape(-1, 3)[rows],
                                 z_t.reshape(-1)[rows])
    run_ratio = (np.linalg.norm(target.points.reshape(-1, 3)[rows], axis=-1)
                 / np.linalg.norm(sphere_rows, axis=-1))
    plain_b = _plain_chunk(
        dev, _sphere_mapped(base0, z_b), sphere_rows,
        (np.linalg.norm(base0, axis=-1) / (R_EARTH_M * z_b))[None],
        run_ratio[:, None], order=src.order, cfg=engine.DEFAULT_LOCATE,
        fallback="snap", prefilter_m=PREFILTER_M)
    _entry_line(smi, "map_to_ellipse", first, walls, launches_b, peak,
                call="ops.spherical.map_to_ellipse(base, target)",
                flattening=testing.WGS84_FLATTENING,
                source_elements=src.nelem, target_nodes=int(z_t.size),
                ratio_max_rel_err=ratio_err,
                ratio_range=[float(ratio.min()), float(ratio.max())],
                base_restored=base_restored, plain_chunk=plain_b)
    check(base_restored, "map_to_ellipse left the base's lattice changed")
    check(ratio_err < 1e-6, f"map_to_ellipse radius ratio off 1 + eps by "
          f"{ratio_err:.3g}")
    _hold_plain("map_to_ellipse", plain_b)
    _check_launched("map_to_ellipse", launches_b,
                    ("newton_rows", "nearest_centroid"))
    return {"interpolate_to_mesh": launches_a, "map_to_ellipse": launches_b}


def _coeffs_err(dev, el, co, field, truth):
    """Host (elements, coeffs) of a point cloud against the analytic field:
    (the largest relative error of coeffs . field over the found rows, the
    found rows, whether every row without an element has zero coeffs)."""
    el_d = torch.as_tensor(el, device=dev).long()
    co_d = torch.as_tensor(co, device=dev)
    found = el_d >= 0
    vals = (field[el_d.clamp_min(0)] * co_d.double()).sum(dim=-1)
    rel = ((vals - truth).abs() / truth.abs())[found]
    return (float(rel.max()) if rel.numel() else 0.0, int(found.sum()),
            bool((co_d[~found] == 0).all()))


def phase_entries(dev, smi, src, layered_written):
    """``engine.get_element_weights``, ``get_element_weights_layered``,
    ``interpolate_to_points_layered`` and ``gll_2_points_arrays``,
    ``device`` omitted (see the module docstring); ``layered_written`` is
    what ``phase_layered``'s f32 call wrote.  Returns the launch counts of
    each entry's last call."""
    launches = {}
    clear_caches()

    # (c) the slice's first targets, sentinel; the search centroids the
    # prep's own, then moved toward the centre (snap off and on), then the
    # prep's again; once polished.  K2's sources are recorded in place.
    pts = testing.shell_targets(N_TARGETS, seed=0)[:ENTRY_WEIGHT_ROWS].copy()
    field = torch.as_tensor(testing.element_nodal_field(src), device=dev)
    truth = torch.as_tensor(testing.smooth_field(pts), device=dev)
    cent = src.points.mean(axis=1)
    radius = np.linalg.norm(src.points, axis=-1)
    step = CENTROID_SHIFT * (radius.max(axis=1) - radius.min(axis=1))
    shifted = cent * (1.0 - step / np.linalg.norm(cent, axis=1))[:, None]
    node_means = torch.as_tensor(cent, device=dev)
    shifted_d = torch.as_tensor(shifted, device=dev)
    ranked = []
    nearest_centroid = knn.nearest_centroid

    def recording(sources, queries, **kw):
        ranked.append(sources)
        return nearest_centroid(sources, queries, **kw)

    def weights(centroids, **kw):
        return engine.get_element_weights(src.points, src.order, centroids,
                                          pts, **kw)

    def ranked_only(cents):
        out = bool(ranked) and all(
            s.shape == cents.shape
            and torch.allclose(s, cents, rtol=1e-12, atol=0) for s in ranked)
        ranked.clear()
        return out

    knn.nearest_centroid = recording
    try:
        (el, co), first, walls, launches_c, peak = _entry_walls(
            lambda: weights(None))
        own_ranked = ranked_only(node_means)
        rel, found, zero = _coeffs_err(dev, el, co, field, truth)
        op = TransferOperator.build(
            src.points, pts, order=src.order,
            cfg=LocateConfig(nelem_to_search=25, accept_tol=1.05),
            fallback="sentinel", prefilter_m=PREFILTER_M, device=dev)
        equal_build = bool(np.array_equal(el, op.elements.cpu().numpy())
                           and np.array_equal(co, op.weights.cpu().numpy()))
        del op
        ranked.clear()
        moved = {}
        for snap in (False, True):
            reset_launches()
            s_el, s_co = weights(shifted, snap_to_nearest=snap)
            n = read_launches()
            s_rel, s_found, s_zero = _coeffs_err(dev, s_el, s_co, field,
                                                 truth)
            moved[f"snap_{snap}".lower()] = {
                "launches": n, "max_rel_err": s_rel, "found": s_found,
                "sentinel_rows_zero": s_zero,
                "elements_differ": int((s_el != el).sum()),
                "ranked_given_centroids": ranked_only(shifted_d)}
            del s_el, s_co
        # the prep's cache entry does not keep the given centroids
        again_el, again_co = weights(None)
        no_leak = bool(np.array_equal(again_el, el)
                       and np.array_equal(again_co, co)
                       and ranked_only(node_means))
        del again_el, again_co, el, co
    finally:
        knn.nearest_centroid = nearest_centroid
    os.environ["MMT_DF32_POLISH"] = "1"
    try:
        reset_launches()
        (p_el, p_co), p_wall = _host_s(lambda: weights(None))
        launches_df32 = read_launches()
    finally:
        del os.environ["MMT_DF32_POLISH"]
    p_rel, p_found, p_zero = _coeffs_err(dev, p_el, p_co, field, truth)
    p_dtype = str(p_co.dtype)
    del p_el, p_co
    _entry_line(smi, "get_element_weights", first, walls, launches_c, peak,
                call="engine.get_element_weights(src.points, 4, centroids, "
                     "points)", points=len(pts), source_elements=src.nelem,
                max_rel_err=rel, found=found, sentinel_rows=len(pts) - found,
                sentinel_rows_zero=zero, equal_transfer_operator=equal_build,
                ranked_own_centroids=own_ranked, moved_centroids=moved,
                next_call_equal_first=no_leak,
                df32={"wall_s": p_wall, "launches": launches_df32,
                      "max_rel_err": p_rel, "found": p_found,
                      "sentinel_rows_zero": p_zero, "coeffs_dtype": p_dtype})
    check(equal_build, "get_element_weights differs from "
          "TransferOperator.build on the same inputs")
    check(own_ranked and no_leak, "get_element_weights without centroids "
          "did not rank the mesh's own, or differs after a call with moved "
          "ones")
    check(found == p_found == len(pts) and zero and p_zero,
          f"get_element_weights found {found} / {p_found} of {len(pts)}")
    check(rel < 1e-6 and p_rel < 1e-8,
          f"get_element_weights max rel err {rel:.3g}, polished {p_rel:.3g}")
    for key, m in moved.items():
        check(m["ranked_given_centroids"], f"get_element_weights {key}: K2 "
              "did not rank the given centroids")
        check(m["found"] == len(pts) and m["max_rel_err"] < 1e-6,
              f"get_element_weights with moved centroids, {key}: {m}")
        _check_launched(f"get_element_weights {key}", m["launches"],
                        ("newton_rows", "nearest_centroid"))
    _check_launched("get_element_weights", launches_c,
                    ("newton_rows", "nearest_centroid"))
    _check_launched("get_element_weights polished", launches_df32,
                    ("newton_rows", "nearest_centroid", "polish_pairs"))
    launches["get_element_weights"] = launches_c
    launches["get_element_weights_df32"] = launches_df32
    del pts, field, truth

    # (d) the layered pair's per-layer unique target points, the caller's
    # candidates: each layer's exact 20 nearest masked centroids
    lsrc, ltgt = (testing.shell_mesh(**LAYERED_SRC),
                  testing.shell_mesh(**LAYERED_TGT))
    ids = np.sort(np.unique(lsrc.layer_id))[::-1]
    smasks = layer_ops.layer_masks(lsrc.layer_id, ids)
    tmasks = layer_ops.layer_masks(ltgt.layer_id, ids)
    coords = dedup.unique_points_per_layer(ltgt.points, tmasks)
    near = {
        layer: knn.knn(
            torch.as_tensor(lsrc.points[smasks[layer]].mean(axis=1),
                            device=dev),
            torch.as_tensor(coords[layer][0], device=dev), 20)[1].cpu().numpy()
        for layer in coords}
    original = types.SimpleNamespace(points=lsrc.points)
    (el, co), first, walls, launches_d, peak = _entry_walls(
        lambda: engine.get_element_weights_layered(
            coords, near, original, smasks, from_gll_order=lsrc.order),
        n_warm=1)
    lfield = testing.element_nodal_field(lsrc)
    per_layer = {}
    for layer, (upts, _) in coords.items():
        rel, found, zero = _coeffs_err(
            dev, el[layer], co[layer],
            torch.as_tensor(lfield[smasks[layer]], device=dev),
            torch.as_tensor(testing.smooth_field(upts), device=dev))
        free = TransferOperator.build(
            lsrc.points[smasks[layer]], upts, order=lsrc.order,
            cfg=LocateConfig(accept_tol=1.03), fallback="sentinel",
            device=dev)
        per_layer[layer] = {
            "points": len(upts), "source_elements": int(smasks[layer].sum()),
            "max_id": int(el[layer].max()), "max_rel_err": rel,
            "found": found, "found_unconstrained": int(free.found.sum()),
            "sentinel_rows_zero": zero,
            "elements_differ_unconstrained": int(
                (el[layer] != free.elements.cpu().numpy()).sum())}
        del free
    del el, co, near
    _entry_line(smi, "get_element_weights_layered", first, walls,
                launches_d, peak,
                call="engine.get_element_weights_layered(coords, "
                     "nearest_elements, mesh, masks, from_gll_order=4)",
                k=20, layers=per_layer)
    for layer, c in per_layer.items():
        check(c["max_id"] < c["source_elements"], f"layer {layer}: element "
              f"{c['max_id']} outside its {c['source_elements']}")
        check(c["max_rel_err"] < 1e-6 and c["sentinel_rows_zero"],
              f"get_element_weights_layered layer {layer}: {c}")
        check(c["found"] >= c["found_unconstrained"],
              f"get_element_weights_layered layer {layer} found fewer rows "
              f"than an unconstrained build: {c}")
    _check_launched("get_element_weights_layered", launches_d,
                    ("newton_rows",), absent=("nearest_centroid",))
    launches["get_element_weights_layered"] = launches_d
    del coords

    # (e) onto live layered meshes; the source's innermost layer is fluid,
    # so "nocore" writes 3 of the 4 layers and leaves the core's nodes be
    params = list(LAYERED_PARAMS)
    fluid = (lsrc.layer_id == lsrc.layer_id.min()).astype(np.float64)
    old = _live_mesh(lsrc, LAYERED_PARAMS, "smooth", fluid)()
    fresh = _live_mesh(ltgt, LAYERED_PARAMS, "linear")
    before = fresh().element_nodal_fields
    base = testing.smooth_field(ltgt.points)
    built = {}
    layered_operators = engine._layered_operators

    def recording_ops(*a, **k):
        built["ops"] = layered_operators(*a, **k)
        return built["ops"]

    def run_e(spec):
        new, printed = fresh(), io.StringIO()
        with contextlib.redirect_stdout(printed):
            engine.interpolate_to_points_layered(old, new, params,
                                                 layers=spec)
        return new, printed.getvalue()

    engine._layered_operators = recording_ops
    try:
        specs = {}
        for spec, n_warm in (("all", 1), ("nocore", 0)):
            (new, printed), first, walls, n, peak = _entry_walls(
                lambda: run_e(spec), n_warm=n_warm)
            ops, _, tgt_masks = built["ops"]
            said = re.search(r"(\d+) points could not be interpolated",
                             printed)
            written = np.zeros(ltgt.nelem, bool)
            missing = np.zeros((ltgt.nelem, ltgt.n_gll), bool)
            for layer, op in ops.items():
                written |= tgt_masks[layer]
                lost = (~op.found)[op.recon.long()].cpu().numpy()
                missing[tgt_masks[layer]] = lost.reshape(-1, ltgt.n_gll)
            good = written[:, None] & ~missing
            rels, vs_layered, zeros, kept = [], [], True, True
            for i, p in enumerate(params):
                got = new.element_nodal_fields[p]
                rels.append(_rel_np(got[good], base[good] * (1 + 0.1 * i)))
                vs_layered.append(_rel_np(got[good],
                                          layered_written[p][good]))
                zeros &= bool((got[missing] == 0).all())
                kept &= bool(np.array_equal(got[~written],
                                            before[p][~written]))
            specs[spec] = {
                "wall_first_s": first, "walls_warm_s": walls,
                "launches": n, "peak_mem_gb": peak,
                "layers": sorted(ops), "written_slots": int(
                    written.sum()) * ltgt.n_gll,
                "num_missing": sum(op.num_missing for op in ops.values()),
                "num_failed_printed": int(said.group(1)) if said else 0,
                "missing_slots": int(missing.sum()),
                "missing_slots_zero": zeros, "unwritten_kept": kept,
                "max_rel_err": rels,
                "max_rel_diff_gll_2_gll_layered": vs_layered}
            del new
    finally:
        engine._layered_operators = layered_operators
    del base, before, built
    top = specs["all"]
    _entry_line(smi, "interpolate_to_points_layered", top["wall_first_s"],
                top["walls_warm_s"], top["launches"], top["peak_mem_gb"],
                call="engine.interpolate_to_points_layered(old, new, "
                     "params, layers=spec)", slots=ltgt.nelem * ltgt.n_gll,
                params=len(params), specs=specs)
    for spec, c in specs.items():
        check(c["num_failed_printed"] == c["num_missing"],
              f"interpolate_to_points_layered {spec}: printed "
              f"{c['num_failed_printed']} failed, operators miss "
              f"{c['num_missing']}")
        check(max(c["max_rel_err"]) < 1e-6 and c["missing_slots_zero"]
              and c["unwritten_kept"],
              f"interpolate_to_points_layered {spec}: {c}")
        check(max(c["max_rel_diff_gll_2_gll_layered"]) <= 2e-6,
              f"interpolate_to_points_layered {spec} against "
              f"gll_2_gll_layered: {c['max_rel_diff_gll_2_gll_layered']}")
        _check_launched(f"interpolate_to_points_layered {spec}",
                        c["launches"], ("newton_rows", "nearest_centroid"))
    check(specs["nocore"]["layers"]
          == sorted(str(i) for i in ids if i != ids.min()),
          f"nocore wrote layers {specs['nocore']['layers']}")
    launches["interpolate_to_points_layered"] = top["launches"]
    del old, fresh, lsrc, ltgt

    # (f) the gll source's [E, P, n] arrays at lat/lon/depth points, as
    # query_model locates them, and at the Exodus target's nodes, as
    # gll_2_exodus does
    gll_data = np.stack([testing.element_nodal_field(src) * (1 + 0.1 * i)
                         for i in range(3)], axis=1)
    rng = np.random.default_rng(7)
    lld = np.stack([rng.uniform(lo, hi, ENTRY_QUERY_N)
                    for lo, hi in ENTRY_LLD], axis=-1)
    cases = {"query_model": utils.latlondepth_to_xyz(lld),
             "gll_2_exodus": testing.shell_mesh(**EXO_TGT).vertices}
    out = {}
    for name, xyz in cases.items():
        vals, first, walls, n, peak = _entry_walls(
            lambda: engine.gll_2_points_arrays(src.points, gll_data, xyz))
        rels = max_rel_columns(vals, torch.as_tensor(
            testing.smooth_field(xyz), device=dev))
        plain = _plain_chunk(
            dev, src.points, xyz[:ROWS], np.moveaxis(gll_data, 1, 0),
            vals[:ROWS], order=src.order,
            cfg=engine._locate_cfg(20, accept_tol=1.04),
            fallback="fixed_ref", use_aabb=True, prefilter_m=PREFILTER_M)
        out[name] = {"points": len(xyz), "wall_first_s": first,
                     "walls_warm_s": walls, "launches": n,
                     "peak_mem_gb": peak, "device": str(vals.device),
                     "shape": list(vals.shape),
                     "finite": bool(torch.isfinite(vals).all()),
                     "max_rel_err": rels, "plain_chunk": plain}
        del vals
    top = out["query_model"]
    _entry_line(smi, "gll_2_points_arrays", top["wall_first_s"],
                top["walls_warm_s"], top["launches"], top["peak_mem_gb"],
                call="engine.gll_2_points_arrays(src.points, gll_data, "
                     "points)", source_elements=src.nelem, params=3,
                cases=out)
    for name, c in out.items():
        check(c["device"].startswith("cuda") and c["finite"]
              and c["shape"] == [c["points"], 3],
              f"gll_2_points_arrays {name}: {c['device']} {c['shape']}")
        check(max(c["max_rel_err"]) < 1e-6,
              f"gll_2_points_arrays {name} max rel errs {c['max_rel_err']}")
        _hold_plain(f"gll_2_points_arrays {name}", c["plain_chunk"])
        _check_launched(f"gll_2_points_arrays {name}", c["launches"],
                        ("newton_rows", "nearest_centroid"))
    launches["gll_2_points_arrays"] = top["launches"]
    return launches


def _sharded_walls(fn):
    """One warm-up and three timed calls of ``fn``: (the last result, the
    walls, the launches of the first timed call, ``sharding.LAST_RUN``
    after it, the peak device memory of the timed calls in GB)."""
    fn()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for i in range(3):
        if i == 0:
            reset_launches()
        out, wall = _host_s(fn)
        walls.append(wall)
        if i == 0:
            launches, stats = read_launches(), dict(sharding.LAST_RUN)
    return (out, walls, launches, stats,
            torch.cuda.max_memory_allocated() / 1e9)


def sharded_rank(rank, inputs, dev):
    """Part (b) of ``phase_sharded`` on one of the ranks that share the
    card ``dev`` (run by ``launch.run_ranks``): each scheme at the
    ``sharded`` config, warm once and timed three times; rank 0 also
    returns the values, as f32 (what both schemes compute in)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    with np.load(inputs) as z:
        pts, nodes, fields = z["pts"], z["nodes"], z["fields"]
    pts_d = torch.as_tensor(pts, device=dev)
    mesh = sharding.make_mesh(device=dev)
    kw = dict(order=4, cfg=SLICE_CFG, mesh=mesh, device=dev)
    runs = {
        "sharded": lambda: sharding.sharded_transfer(
            pts_d, nodes, torch.as_tensor(fields, device=dev),
            fallback="snap", device_out=True, **kw),
        # host sources: each rank uploads only its shard
        "source_sentinel": lambda: sharding.source_sharded_transfer(
            pts_d, nodes, fields, fallback="sentinel", **kw),
        "source_snap": lambda: sharding.source_sharded_transfer(
            pts_d, nodes, fields, fallback="snap", **kw),
    }
    out = {"backend": dist.get_backend(mesh.get_group()),
           "world": mesh.size()}
    for name, fn in runs.items():
        vals, walls, launches, stats, peak = _sharded_walls(fn)
        out[name] = json.dumps({
            "wall_s": _median_spread(walls)[0], "walls_s": walls,
            "launches": {k: launches[k]
                         for k in ("newton_rows", "nearest_centroid")},
            "peak_mem_gb": peak, **stats})
        if rank == 0:
            out[f"{name}_values"] = np.asarray(
                vals.cpu() if isinstance(vals, torch.Tensor) else vals,
                dtype=np.float32)
    return out


def phase_sharded(dev, smi, src, slice_launches):
    """The sharded schemes (see the module docstring).  Returns the
    launch counts of (a)'s first timed call."""
    pts = testing.shell_targets(N_TARGETS, seed=0)
    pts_d = torch.as_tensor(pts, device=dev)
    base = testing.element_nodal_field(src, "smooth")
    fields_np = np.stack([base * (1 + 0.1 * i) for i in range(3)])
    fields = torch.as_tensor(fields_np, device=dev)
    truth = torch.as_tensor(testing.smooth_field(pts), device=dev)

    # (a) world size 1: make_mesh(1) starts a one-rank nccl group
    mesh = sharding.make_mesh(1, device=dev)
    backend = dist.get_backend(mesh.get_group())
    check(backend == "nccl", f"make_mesh(1) on the card made a {backend} "
          "group")
    vals, walls, launches, stats, peak_gb = _sharded_walls(
        lambda: sharding.sharded_transfer(
            pts_d, src.points, fields, order=src.order, cfg=SLICE_CFG,
            fallback="snap", mesh=mesh, device_out=True, device=dev))
    wall, spread = _median_spread(walls)
    k12 = ("newton_rows", "nearest_centroid")
    check(all(launches[k] > 0 for k in k12)
          and all(launches[k] == slice_launches[k] for k in k12),
          f"sharded launches {launches} differ from the slice's "
          f"{slice_launches}")
    check(vals.dtype == torch.float32 and tuple(vals.shape) == (N_TARGETS, 3),
          f"sharded values {vals.dtype} {tuple(vals.shape)}")
    rels = max_rel_columns(vals, truth)
    check(max(rels) < 1e-6, f"sharded max rel errs {rels} >= 1e-6")
    # the operator on the same inputs: the same program, so bit for bit
    want = TransferOperator.build(
        src.points, pts_d, order=src.order, cfg=SLICE_CFG, fallback="snap",
        device=dev).apply(fields)
    differ = (vals != want).any(dim=1)
    n_differ = int(differ.sum())
    op_diff = (float(((vals - want).abs() / want.abs())[differ].max())
               if n_differ else 0.0)
    check(op_diff <= 1e-6, f"sharded rows differ from the operator's by "
          f"{op_diff:.3g}")
    del want, differ
    part_a = {"world": 1, "backend": backend, "wall_s": wall,
              "spread_s": spread, "walls_s": walls,
              "mpts_per_s": N_TARGETS / wall / 1e6,
              "launches": launches, "exchange_s": stats["exchange_s"],
              "max_rel_err": rels, "rows_differing_from_operator": n_differ,
              "max_rel_diff_operator": op_diff, "peak_mem_gb": peak_gb}
    dist.destroy_process_group()

    # (b) SHARDED_RANKS gloo ranks sharing the card
    sentinel = TransferOperator.build(
        src.points, pts_d, order=src.order, cfg=SLICE_CFG,
        fallback="sentinel", device=dev)
    n_found = int(sentinel.found.sum())
    del sentinel
    _build.library()  # built here: the ranks only load it
    with tempfile.TemporaryDirectory() as tmpdir:
        inputs = os.path.join(tmpdir, "inputs.npz")
        np.savez(inputs, pts=pts, nodes=src.points, fields=fields_np)
        ranks, ranks_s = _host_s(lambda: launch.run_ranks(
            sharded_rank, SHARDED_RANKS, backend="gloo", args=(inputs, dev),
            timeout_s=SHARDED_TIMEOUT_S))
    del pts
    part_b = {"world": SHARDED_RANKS, "backend": str(ranks[0]["backend"]),
              "command_s": ranks_s, "found_operator": n_found}
    for name in ("sharded", "source_sentinel", "source_snap"):
        per_rank = [json.loads(str(r[name])) for r in ranks]
        got = torch.as_tensor(ranks[0][f"{name}_values"], device=dev)
        found = got[:, 0] != 0
        rel_a = ((got - vals).abs() / vals.abs())[found]
        entry = {"ranks": per_rank, "found": int(found.sum()),
                 "max_rel_err": [
                     _max_rel_where(got[:, i], truth * (1 + 0.1 * i), found)
                     for i in range(3)],
                 "max_rel_diff_a": float(rel_a.max()),
                 "rows_above_1e-6_of_a": int((rel_a > 1e-6).sum())}
        part_b[name] = entry
        check(all(p["launches"]["newton_rows"] > 0 for p in per_rank),
              f"{name}: K1 was not launched on every rank: {per_rank}")
        if name.startswith("source"):
            check(all(p["launches"]["nearest_centroid"] > 0
                      for p in per_rank),
                  f"{name}: K2 (routing) was not launched: {per_rank}")
            unfound = per_rank[0]["unfound"]
            check(N_TARGETS - unfound == entry["found"],
                  f"{name}: {unfound} unfound against the values' zeros")
        if name == "source_sentinel":
            check(entry["found"] == n_found,
                  f"source-sharded found {entry['found']} != the "
                  f"operator's {n_found}")
        check(max(entry["max_rel_err"]) < 1e-6,
              f"{name}: max rel errs {entry['max_rel_err']} >= 1e-6")
        check(entry["max_rel_diff_a"] <= 1e-6,
              f"{name}: {entry['rows_above_1e-6_of_a']} rows differ from "
              f"(a) by up to {entry['max_rel_diff_a']:.3g}")
    del got, rel_a, vals

    # the routing and rank 0's pass 1, kernels against twins, first chunk
    shard_ids, reps, center, bin_shard = sharding.partition_source(
        src.points, SHARDED_RANKS)
    owner = sharding.route_points(pts_d, reps, center, bin_shard)
    plain_owner = sharding.route_points(pts_d[:ROWS], reps, center,
                                        bin_shard, plain=True)
    route_agree = float((owner[:ROWS] == plain_owner).double().mean())
    mine = torch.nonzero(owner == 0).squeeze(1)[:ROWS]
    ids = np.sort(shard_ids[0])

    def pass1(plain):
        return sharding.local_try(
            pts_d[mine], src.points[ids],
            fields[:, torch.as_tensor(ids, device=dev)], src.order,
            sharding.pass_cfg(SLICE_CFG, "snap"), True, strategy="auto",
            chunk=ROWS, device=dev, plain=plain)

    # a row missed here lies in an element of the other shard, and pass 2
    # decides it: its local best-so-far depends on which candidates the
    # ladder tried and on the convergence flags of solves extrapolated far
    # outside, which K1 and its twin may flip, so elements and values are
    # held on the accepted rows, and of the missed rows only that both
    # paths missed them (their scores are recorded)
    k_score, k_vals, k_res = pass1(False)
    p_score, p_vals, p_res = pass1(True)
    same = (k_res.found == p_res.found) & (k_res.elements == p_res.elements)
    both = k_res.accepted & p_res.accepted
    missed = ~k_res.accepted & ~p_res.accepted
    part_b["plain_pass1"] = {
        "rows": int(mine.shape[0]), "shard_elements": int(ids.size),
        "found_agree": float((k_res.found == p_res.found).double().mean()),
        "accepted_agree": float(
            (k_res.accepted == p_res.accepted).double().mean()),
        "missed": int(missed.sum()),
        "elements_agree": float(same.double().mean()),
        "elements_agree_accepted": float(same[both].double().mean()),
        "max_rel_diff_missed_score": float(
            ((k_score - p_score).abs() / p_score)[missed].max()),
        "max_rel_diff": float(((k_vals - p_vals).abs()
                               / p_vals.abs())[same & both].max())}
    part_b["routing_plain_agree"] = route_agree
    emit({"phase": "sharded", "nvidia_smi": smi, "targets": N_TARGETS,
          "elements": src.nelem, "params": 3, "a": part_a, "b": part_b})
    check(route_agree >= 0.999, f"routing agrees with the twin on "
          f"{route_agree:.6f} < 0.999")
    p1 = part_b["plain_pass1"]
    check(p1["found_agree"] >= 0.999 and p1["accepted_agree"] >= 0.999
          and p1["elements_agree_accepted"] >= 0.999,
          f"rank 0's pass 1 against the plain path: {p1}")
    check(p1["max_rel_diff"] <= 1e-5, f"rank 0's pass 1 values differ from "
          f"the plain path's by {p1['max_rel_diff']:.3g}")
    return launches


def _max_rel_where(vals, truth, rows):
    return float(((vals[rows].double() - truth[rows]).abs()
                  / truth[rows].abs()).max())


def profile(dev, src, pts_d, fields, targets, case, big):
    """``--profile``: per run of the time breakdown in PERF.md (the
    slices, the flagship options, the scan, the file path's ``case.run``
    and the slice on the ``gll_big`` source ``big``), one warm-up, three timed warm walls and one run under
    ``torch.profiler``;
    one JSON line each with the walls, the device time of all kernels of
    the profiled run, the busy share (that device time over the mean warm
    wall), the eight kernels with the most device time and every kernel
    of ``PORT_KERNELS`` (name, ms, launches).  The profiled run goes
    through ``utils_profile.trace``, whose chrome trace lands in the
    temporary directory and goes with it."""
    tgt_d = torch.as_tensor(targets, device=dev)

    def transfer(t, cfg, **kw):
        return lambda: run_transfer(src, t, fields, cfg, dev, **kw)

    runs = {
        "slice": transfer(pts_d, SLICE_CFG, fallback="snap"),
        "df32 slice": transfer(pts_d, DF32_CFG, fallback="snap"),
        "f64_polish slice": transfer(
            pts_d, dataclasses.replace(SLICE_CFG, f64_polish=True),
            fallback="snap"),
        "flagship options": transfer(tgt_d, FLAGSHIP_CFG, **FLAGSHIP_KW),
        "scan, 1M targets": lambda: run_scan(src, tgt_d, dev),
        "file": case.run,
    }
    # phases 12-14: Exodus -> GLL through its arrays core, the layered
    # path and the regular grid, as the smoke phases drive them
    e2g_src = testing.shell_mesh(**E2G_SRC)
    e2g_corners = e2g_src.points  # order 1: the lattice is the corners
    e2g_fields = np.stack([testing.element_nodal_field(e2g_src, "smooth")
                           * (1 + 0.1 * i) for i in range(3)])
    e2g_coords = case.tgt.points.astype(np.float32)
    e2g_sink = np.empty((case.tgt.nelem, 3, case.tgt.n_gll), np.float32)
    runs["exodus_gll"] = lambda: engine.exodus_2_gll_arrays(
        e2g_corners, e2g_fields, list(FILE_PARAMS), e2g_coords,
        lambda names: e2g_sink, device=dev)
    lay_old = _live_mesh(testing.shell_mesh(**LAYERED_SRC), LAYERED_PARAMS,
                         "smooth")()
    lay_new = _live_mesh(testing.shell_mesh(**LAYERED_TGT), LAYERED_PARAMS,
                         "linear")
    runs["layered"] = lambda: engine.gll_2_gll_layered(
        lay_old, lay_new(), layers="all", parameters=list(LAYERED_PARAMS),
        device=dev)
    grid_mesh = _live_mesh(src, FILE_PARAMS, "smooth")()
    runs["regular grid"] = lambda: engine.extract_regular_grid(
        grid_mesh, list(FILE_PARAMS), lat_extent=GRID_LAT,
        lon_extent=GRID_LON, depth_extent=GRID_DEPTH, device=dev)
    big_src, big_fields, _ = big
    big_fields = torch.as_tensor(big_fields, device=dev)
    runs["gll_big slice"] = lambda: run_transfer(
        big_src, pts_d, big_fields, SLICE_CFG, dev, fallback="snap")
    for name, fn in runs.items():
        walls = []
        for _ in range(4):  # the first warms up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        walls = walls[1:]
        with utils_profile.trace(
                os.path.join(case.tmpdir, "trace", name)) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
        port = [e for e in kernels if any(k in e.key for k in PORT_KERNELS)]
        emit({"profile": name, "walls_s": walls, "device_ms": device_ms,
              "busy": device_ms / (1e3 * sum(walls) / len(walls)),
              "top": [[e.key[:70], e.self_device_time_total / 1e3, e.count]
                      for e in top],
              "port": [[e.key[:70], e.self_device_time_total / 1e3, e.count]
                       for e in port]})


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--profile", action="store_true",
        help="time and profile the slice runs instead of the smoke phases")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    # the plain twins' f32 matmuls stay f32, whatever a caller enabled
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = phase_device()

    src = testing.shell_mesh(n_lat=16, n_lon=16, n_rad=16, order=4)
    pts = testing.shell_targets(N_TARGETS, seed=0)
    base = testing.element_nodal_field(src, "smooth")
    fields = torch.as_tensor(
        np.stack([base * (1 + 0.1 * i) for i in range(3)]), device=dev)
    pts_d = torch.as_tensor(pts, device=dev)
    if args.profile:
        with tempfile.TemporaryDirectory() as tmpdir:
            profile(dev, src, pts_d, fields, lifted_targets(pts)[0],
                    FileCase(src, file_target(), tmpdir, dev), big_source())
        return 0
    centroids = torch.as_tensor(src.points.mean(axis=1), device=dev)
    truth = torch.as_tensor(testing.smooth_field(pts), device=dev)
    k2 = phase_nearest(dev, centroids, pts_d[:ROWS])
    k1, solved = phase_newton(dev, src, pts)
    k4 = phase_polish(dev, solved)
    del solved
    k5 = phase_apply(dev, src, fields)
    orders, launches_orders = phase_orders(dev, smi, pts, pts_d, truth)
    launches_slice = phase_slice(dev, src, pts_d, fields, truth)
    launches = phase_df32_slice(dev, src, pts_d, fields, truth)
    launches_f64 = phase_f64(dev, smi, src, pts_d, fields, truth)
    order1 = phase_flagship(dev, src, pts, fields)
    del pts, pts_d, fields
    with tempfile.TemporaryDirectory() as tmpdir:
        # one GLL target for the file path and for Exodus -> GLL
        tgt = file_target()
        mesh_new = mesh_new_target(testing.shell_mesh(**DEDUP_MESH_NEW).points)
        phase_dedup(dev, smi, {"mesh_new_1m": mesh_new, "file": tgt.points})
        kf = phase_fingerprint(dev, smi, {
            "mesh_new_1m": mesh_new,
            "mesh_new_10m": mesh_new_target(tgt.points)})
        del mesh_new
        launches_file, k5["max_rel_diff_file"] = phase_file(
            FileCase(src, tgt, tmpdir, dev), smi)
        clear_caches()
        launches_e2g, k1_sparse = phase_exodus_gll(dev, smi, tgt, tmpdir)
        k1.update(k1_sparse)
        clear_caches()
        launches_entries = phase_entries_mesh(dev, smi, src, tgt)
        del tgt
        clear_caches()
        launches_exo = phase_exodus(dev, smi, tmpdir)
    phase_native(dev, smi)
    clear_caches()
    launches_layered, layered_written = phase_layered(dev, smi)
    clear_caches()
    launches_points, launches_2d = phase_points(dev, smi, src)
    clear_caches()
    launches_entries.update(phase_entries(dev, smi, src, layered_written))
    del layered_written
    clear_caches()
    launches_sharded = phase_sharded(dev, smi, src, launches_slice)
    # the small case's tensors and caches go before the 499,200-element one
    del src, centroids
    clear_caches()
    big = big_source()
    (launches_big, k4["max_abs_diff_big"],
     k5["max_rel_diff_big"]) = phase_big(
        dev, smi, big,
        torch.as_tensor(testing.shell_targets(N_TARGETS, seed=0), device=dev),
        truth)
    del truth
    clear_caches()
    launches_viz = phase_viz(dev, smi, big)

    # launches of the df32 slice's run, of the file path's df32 call, of
    # the grid route's df32 run and of the pipelines' phases (the layered
    # one's df32 call); K1's order-1 ones of the scan's
    for entry, name in ((k1, "newton_rows"), (k2, "nearest_centroid"),
                        (k4, "polish_pairs"), (k5, "apply_pairs")):
        entry["launches"] = launches[name]
        entry["launches_file"] = launches_file[name]
        entry["launches_big"] = launches_big[name]
        entry["launches_exodus"] = launches_exo[name]
        entry["launches_exodus_gll"] = launches_e2g[name]
        entry["launches_layered"] = launches_layered[name]
        entry["launches_points"] = launches_points[name]
        entry["launches_grid2d"] = launches_2d[name]
        entry["launches_sharded"] = launches_sharded[name]
        entry["launches_f64"] = launches_f64[name]
        entry["launches_viz"] = launches_viz[name]
        entry["launches_entries"] = {e: n[name]
                                     for e, n in launches_entries.items()}
        entry["launches_orders"] = {o: n[name]
                                    for o, n in launches_orders.items()}
        entry["bound_share"] = entry["bound_ms"] / entry["ms"]
    # every order/dim pair of K1, K4 and K5, ORDER_ROWS rows each
    for entry, key in ((k1, "K1"), (k4, "K4"), (k5, "K5")):
        entry["orders"] = {
            tag: {f: rec[key][f] for f in ("ms", "group_ms", "kernel_ms",
                                           "bound_ms", "bound_by")}
            for tag, rec in orders.items()}
    k1["launches_order1"] = order1
    kf["launches_file"] = launches_file["content_sums"]
    kf["bound_share"] = kf["bound_ms"] / kf["ms"]
    print(smi, flush=True)
    emit({"kernels": [k1, k2, k4, k5, kf]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
