"""One whole job of a regular-grid cell against the plain reference; not
a run of the cell, and the benchmark's own runs never run it.

    python3 benchmark/grid_check.py --workload gll4_e4096.grid_216 \
        --seed <n> [--block 65536]

Set-up and the warm-up as in a run; then one job's grid (job 1 of the
seed: its shifted extents) timed, and the whole grid recomputed by
``reference_grid.py`` in blocks of ``--block`` points on the same
device.  Against it, by the kind's own sides of the source's box:
inside rows, the largest relative error of the program and of the
reference's own interpolation in bfloat16 (the control); outside rows
(beyond the band), whether program and reference read exactly 0; band
rows, the share on which both read 0 or both read values within the
configuration's limit.  One JSON line.
"""
import argparse
import json
import pathlib
import sys
import time

if __name__ == "__main__":
    sys.path[0] = str(pathlib.Path(__file__).resolve().parent.parent)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import reference_grid, run, spec  # noqa: E402


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def whole_job(cell: spec.Cell, seed: int, device="cuda",
              block: int = 65536) -> dict:
    """The numbers of one job of ``cell`` against the plain reference."""
    device = torch.device(device)
    Jobs = spec.job_kind(cell.traffic["kind"], cell.base)
    jobs = Jobs(cell.config, cell.traffic, seed, device)
    try:
        jobs.run(jobs.prepare(run.WARMUP_JOB))
        extents = jobs.prepare(1)
        _sync(device)
        t = time.perf_counter()
        ds = jobs.run(extents)
        wall = time.perf_counter() - t
        lat, lon, depth = reference_grid.grid_axes(*extents)
        t = time.perf_counter()
        element, xi = reference_grid.locate(
            jobs.source.lattice, reference_grid.grid_points(lat, lon, depth),
            int(cell.config["locate"]["nelem_to_search"]), device, block)
        shape = (-1, len(depth), len(lat), len(lon))
        want = reference_grid.interpolate(jobs.source.values, element, xi,
                                          block=block)
        _sync(device)
        ref_s = time.perf_counter() - t
        bf16 = reference_grid.interpolate(jobs.source.values, element, xi,
                                          dtype=torch.bfloat16, block=block)
        want = want.T.reshape(shape).cpu().numpy()
        bf16 = bf16.T.reshape(shape).cpu().numpy()
        (i_d, o_d), (i_la, o_la), (i_lo, o_lo) = jobs._sides(
            [depth, lat, lon])
        inside = i_d[:, None, None] & i_la[None, :, None] & i_lo[None, None]
        outside = ~(~o_d[:, None, None] & ~o_la[None, :, None]
                    & ~o_lo[None, None])
        band = ~inside & ~outside
    finally:
        jobs.close()
    got = np.stack([ds.data[p] for p in jobs.source.parameters]).astype(
        np.float64)
    limit = float(cell.config["check"]["max_rel_err"])

    def rel(a, b):
        return np.abs(a - b) / np.abs(b)

    zero_got, zero_want = got[:, band] == 0, want[:, band] == 0
    both = ~zero_got & ~zero_want
    agree = (zero_got & zero_want) | (
        both & (rel(got[:, band], np.where(both, want[:, band], 1.0))
                <= limit))
    return {
        "workload": cell.name, "seed": seed, "extents": extents,
        "points": int(got[0].size), "wall_s": wall, "reference_s": ref_s,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else device.type),
        "coordinates_equal": all(np.array_equal(a, b) for a, b in (
            (ds.lat, lat), (ds.lon, lon), (ds.depth, depth))),
        "share_inside": float(inside.mean()),
        "share_outside": float(outside.mean()),
        "share_band": float(band.mean()),
        "inside_nonzero": bool((want[:, inside] != 0).all()),
        "max_rel_err_inside": float(rel(got[:, inside],
                                        want[:, inside]).max()),
        "bf16_max_rel_err_inside": float(rel(bf16[:, inside],
                                             want[:, inside]).max()),
        "outside_zero": bool((got[:, outside] == 0).all()),
        "outside_zero_reference": bool((want[:, outside] == 0).all()),
        "band_agree_share": float(agree.all(axis=0).mean()),
        "band_zero_program": float(zero_got.all(axis=0).mean()),
        "band_zero_reference": float(zero_want.all(axis=0).mean()),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--block", type=int, default=65536)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload, run.ROOT)
    if not torch.cuda.is_available():
        print("grid_check: needs a CUDA device", file=sys.stderr)
        return 2
    print(json.dumps(whole_job(cell, args.seed, "cuda", args.block)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
