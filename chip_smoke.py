"""On-card smoke run of multimesh_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py

needs one NVIDIA GPU (Hopper, sm_90a) and ``nvcc``; it builds the CUDA
kernels of ``multimesh_tpu_torch/csrc`` itself.  Phases, one JSON line
each on stdout:

1. device and build: ``nvidia-smi`` name and power limit, torch / CUDA
   versions, the kernel build time;
2. K2 (nearest centroid) against its plain PyTorch twin on one 262,144-
   query chunk of the ``gll`` configuration;
3. K1 (Newton rows) against its twin on 262,144 rows at order/dim 4/3,
   2/3, 1/3 and 2/2;
4. the slice: ``TransferOperator.build(...).apply(...)`` at the ``gll``
   configuration -- an order-4 spherical-shell source of 4,096 elements,
   10,000,000 targets, 3 parameters, snap fallback -- once to warm up and
   once timed, with launch counts, accuracy against the analytic field
   and the first chunk against the plain path on the card.

Then a ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line.  Any failed check raises: the script exits non-zero and prints no
``ok`` line, as it does without a CUDA device.
"""
import importlib.util
import json
import subprocess
import sys
import time

import numpy as np
import torch

from multimesh_tpu_torch import TransferOperator, _build, testing
from multimesh_tpu_torch.config import LocateConfig, Precision
from multimesh_tpu_torch.search import locate as _locate
from multimesh_tpu_torch.search import nearest, newton

ROWS = 262_144  # one locate chunk
N_TARGETS = 10_000_000
ITERS = 18  # newton_iters + polish_iters of the default LocateConfig
CONV_TOL = 1e-4  # the ladder's f32 convergence threshold
ACCEPT_TOL = LocateConfig().accept_tol


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


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
    # registers / spills per kernel, for the record (stderr)
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(line.strip(), file=sys.stderr)
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
    emit({"phase": "K2", "rows": queries.shape[0],
          "sources": centroids.shape[0], "identical": same,
          "max_rel_d2_diff": rel, "band_m2": band, "ms": ms,
          "plain_ms": plain_ms})
    return {"name": "nearest_centroid", "route": "cuda",
            "source": "multimesh_tpu_torch/csrc/nearest_centroid.cu",
            "replaces": "multimesh_tpu/search/pallas_argmin.py:68",
            # metres between the distances to the two picks
            "max_abs_err": float((dk.sqrt() - dp.sqrt()).abs().max()),
            "ms": ms,
            "plain_ms": plain_ms}


def _newton_rows(mesh, pts, dev, seed):
    """ROWS (point, element) rows: the nearest-centroid element of each
    point, with 10% of the ids replaced by random elements."""
    order, dim = mesh.order, mesh.dim
    prep = _locate._mesh_prep(mesh.points, order, dev)
    p = torch.as_tensor(pts, device=dev)
    ids = nearest.nearest_centroid_ref(p, prep.centroids)
    rng = np.random.default_rng(seed)
    wild = torch.as_tensor(rng.random(ROWS) < 0.1, device=dev)
    rand = torch.as_tensor(rng.integers(0, mesh.nelem, ROWS, dtype=np.int32),
                           device=dev)
    ids = torch.where(wild, rand, ids).contiguous()
    return (p, ids, prep.ctr, prep.inv_scale, prep.nodes, order, dim, ITERS,
            LocateConfig().newton_clamp)


def phase_newton(dev, gll_mesh, gll_pts):
    """K1 against its twin at the main path's orders and dims."""
    rng = np.random.default_rng(1)
    box_pts = rng.uniform(0.0, 1.0, (ROWS, 2))
    cases = [
        (gll_mesh, gll_pts),
        (testing.shell_mesh(n_lat=16, n_lon=16, n_rad=16, order=2), gll_pts),
        (testing.shell_mesh(n_lat=16, n_lon=16, n_rad=16, order=1), gll_pts),
        (testing.box_mesh(shape=(64, 64), order=2, warp=0.1), box_pts),
    ]
    entry = None
    for i, (mesh, pts) in enumerate(cases):
        args = _newton_rows(mesh, pts, dev, seed=10 + i)
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
        check(bool(both_a.any()), f"K1 {mesh.order}/{mesh.dim}: no row "
              "accepted")
        diff = (k_ref - p_ref).abs().amax(-1)
        err_acc = float(diff[both_a].max())
        by_band = {}
        for lo, hi in ((0.0, ACCEPT_TOL), (ACCEPT_TOL, fb_max), (fb_max, 4.0),
                       (4.0, 9.0)):
            sel = both_c & (p_mag >= lo) & (p_mag < hi)
            by_band[f"{lo:g}-{hi:g}"] = [
                int(sel.sum()), float(diff[sel].max()) if sel.any() else 0.0]
        tag = f"{mesh.order}/{mesh.dim}"
        emit({"phase": "K1", "order_dim": tag, "rows": ROWS,
              "accepted": float(ka.double().mean()),
              "accept_agree": acc_agree, "usable_agree": usable_agree,
              "conv_agree": conv_agree, "max_abs_err_accepted": err_acc,
              "converged_rows_and_max_err_by_ref": by_band})
        check(acc_agree >= 0.9999, f"K1 {tag} acceptance agreement "
              f"{acc_agree:.6f} < 0.9999")
        check(usable_agree >= 0.9999, f"K1 {tag} agreement on converged "
              f"rows below |ref| {fb_max} is {usable_agree:.6f} < 0.9999")
        check(err_acc <= 1e-5, f"K1 {tag} accepted refs differ by "
              f"{err_acc:.3g} > 1e-5")
        near = by_band[f"{ACCEPT_TOL:g}-{fb_max:g}"][1]
        check(near <= 1e-4, f"K1 {tag} converged refs below |ref| {fb_max} "
              f"differ by {near:.3g} > 1e-4")
        if i == 0:
            ms = cuda_ms(lambda: newton.newton_rows(*args), 10)
            plain_ms = cuda_ms(lambda: newton.newton_refs_rows_ref(*args), 3)
            emit({"phase": "K1 time", "order_dim": tag, "rows": ROWS,
                  "ms": ms, "plain_ms": plain_ms})
            entry = {"name": "newton_rows", "route": "cuda",
                     "source": "multimesh_tpu_torch/csrc/newton_rows.cu",
                     "replaces": "multimesh_tpu/search/pallas_newton.py:261",
                     "max_abs_err": err_acc, "ms": ms, "plain_ms": plain_ms}
    return entry


def phase_slice(dev, src, pts):
    """build + apply at the gll configuration, warm and timed."""
    cfg = LocateConfig(nelem_to_search=20, precision=Precision.MIXED)
    base = testing.element_nodal_field(src, "smooth")
    fields = torch.as_tensor(
        np.stack([base * (1 + 0.1 * i) for i in range(3)]), device=dev)
    pts_d = torch.as_tensor(pts, device=dev)

    def run(targets, plain=False):
        t0 = time.perf_counter()
        op = TransferOperator.build(src.points, targets, order=4, cfg=cfg,
                                    fallback="snap", device=dev,
                                    plain=plain)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        vals = op.apply(fields)
        torch.cuda.synchronize()
        return op, vals, t1 - t0, time.perf_counter() - t1

    run(pts_d)  # warm-up: mesh prep cache, allocator, lazy module loads
    newton.newton_rows.launches = 0
    nearest.nearest.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    op, vals, build_s, apply_s = run(pts_d)
    wall = time.perf_counter() - t0
    launches = {"newton_rows": newton.newton_rows.launches,
                "nearest_centroid": nearest.nearest.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the path was not launched: {launches}")
    check(tuple(vals.shape) == (N_TARGETS, 3), f"shape {tuple(vals.shape)}")
    check(bool(torch.isfinite(vals).all()), "non-finite values")
    check(bool(op.found.all()), "snap left a target unassigned")
    truth = torch.as_tensor(testing.smooth_field(pts), device=dev)
    rel = float(((vals[:, 0].double() - truth).abs() / truth.abs()).max())
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


def main():
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
    centroids = torch.as_tensor(src.points.mean(axis=1), device=dev)
    k2 = phase_nearest(dev, centroids, torch.as_tensor(pts[:ROWS],
                                                       device=dev))
    k1 = phase_newton(dev, src, pts[:ROWS])
    launches = phase_slice(dev, src, pts)

    k1["launches"] = launches["newton_rows"]
    k2["launches"] = launches["nearest_centroid"]
    print(smi, flush=True)
    emit({"kernels": [k1, k2]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
