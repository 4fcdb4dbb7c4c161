"""Run one cell of the benchmark of multimesh_tpu_torch once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA card.  Set-up
makes the cell's inputs from the seed and runs one warm-up job; the
window then runs whole jobs, one caller waiting for each, until
``--seconds`` have passed; then the sampled answers are compared with
the plain reference.  The last line on standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics, read in
a profiled stretch of whole jobs), ``device`` (with ``--trace 1`` also
``busy_s`` and ``window_s``), with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared, with its limit.  The same numbers are
the last lines on standard error.

Exits with 2 and prints no result without a CUDA device, and with 3 if
the JAX package or JAX was loaded.
"""
import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    # the checkout's root, not this folder, is where imports start
    sys.path[0] = str(ROOT)
    # kernel caches at fixed places inside the checkout (the program's
    # own nvcc build lives in multimesh_tpu_torch/_build)
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".bench_build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / ".bench_build"
                                             / "extensions")

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from benchmark import inputs, profiling, spec, timeline  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "multimesh_tpu")
WARMUP_JOB = 0  # window jobs are 1, 2, ...
GIB = 2.0 ** 30


def forbidden_modules():
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (``multimesh_tpu_torch`` is not ``multimesh_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _window(jobs, seconds: float):
    """Whole jobs until ``seconds`` have passed: (start, end of the last
    job, walls, attempted, failed)."""
    walls, failed, job = [], 0, WARMUP_JOB
    start = end = time.perf_counter()
    while time.perf_counter() - start < seconds:
        job += 1
        job_inputs = jobs.prepare(job)
        t = time.perf_counter()
        try:
            with record_function("bench.job"):
                out = jobs.run(job_inputs)
        except Exception:  # a failed job delivers nothing; counted
            failed += 1
            out = None
            if failed == 1:
                traceback.print_exc()
        end = time.perf_counter()
        walls.append(end - t)
        if out is not None:
            jobs.keep(job, job_inputs, out)
    return start, end, walls, len(walls), failed


def _per_layer(cell, jobs, done, prof, probe_read, ops):
    """The context the per-layer readers take, and the breakdown, of a
    traced stretch of ``done`` jobs."""
    from multimesh_tpu_torch import LocateConfig

    stages, launches = probe_read()
    dev, spans = profiling.trace_events(prof)
    window = [s for s in spans if s[2] == "bench.window"][0]
    cfg = LocateConfig(**cell.config["locate"])
    k1_names = ("newton_rows_kernel", "group_count_kernel",
                "group_scan_tiles_kernel", "group_scan_kernel",
                "group_scatter_kernel")
    intervals = [(s, e) for _, s, e in dev]
    busy = timeline.busy(intervals, window[0], window[1])
    ctx = {
        "jobs": done, "stages": stages, "launches": launches,
        "rows_located": sum(r for r, _, _ in ops),
        "retry_rows": sum(n for _, n, _ in ops),
        "distinct_elements": profiling.distinct_elements(ops),
        "source_elements": int(jobs.source.lattice.shape[0]),
        "order": jobs.source.order, "dim": 3,
        "newton_iters": cfg.newton_iters + cfg.polish_iters,
        "k1_device_s": sum(e - s for n, s, e in dev
                           if any(k in n for k in k1_names)),
        "k2_device_s": sum(e - s for n, s, e in dev
                           if "nearest_centroid_kernel" in n),
        "busy_s": busy, "window_s": window[1] - window[0],
        "device_events": len(dev),
    }
    idle = timeline.gaps(intervals, window[0], window[1])
    breakdown = {
        "device_ops": [[n[:120], s] for n, s in
                       timeline.by_name(dev)[:10]],
        "idle_gaps": [[n, s] for n, s in
                      timeline.label_gaps(idle, spans)[:10]],
    }
    return ctx, breakdown


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device="cuda", t0: float | None = None):
    """One run of ``cell``: the result object, ``checks`` (each number
    compared, with its limit) last.  On a device other than CUDA (a
    rehearsal) it carries no metric: its times are not the card's."""
    t0 = time.perf_counter() if t0 is None else t0
    device = torch.device(device)
    on_card = device.type == "cuda"
    Jobs = spec.job_kind(cell.traffic["kind"], cell.base)
    jobs = Jobs(cell.config, cell.traffic, seed, device)
    try:
        jobs.run(jobs.prepare(WARMUP_JOB))
        if on_card:
            torch.cuda.synchronize(device)
            setup_peak = torch.cuda.max_memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = time.perf_counter() - t0

        metrics, extra = {}, {}
        if trace:
            ops = []
            activities = [ProfilerActivity.CPU]
            if on_card:
                activities.append(ProfilerActivity.CUDA)
            with profiling.program_probe(ops) as probe_read:
                with profile(activities=activities) as prof:
                    with record_function("bench.window"):
                        start, end, walls, attempted, failed = _window(
                            jobs, min(seconds, cell.traffic["trace_seconds"]))
            ctx, breakdown = _per_layer(cell, jobs, attempted - failed, prof,
                                        probe_read, ops)
            for m in cell.per_layer:
                value = spec.metric_reader(m["name"], cell.base)(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            extra = {"busy_s": ctx["busy_s"], "window_s": ctx["window_s"]}
        else:
            start, end, walls, attempted, failed = _window(jobs, seconds)
            done = (attempted - failed) * jobs.points_per_job
            e2e = {
                "setup_s": setup_s,
                "mpts_per_s": timeline.rate(done, start, end) / 1e6,
                "job_p95_s": timeline.percentile(walls, 95.0),
            }
            if on_card:
                e2e["peak_mem_gib"] = (
                    torch.cuda.max_memory_allocated(device) / GIB)
            for m in cell.end_to_end:
                if m["name"] in e2e:
                    metrics[m["name"]] = {"value": e2e[m["name"]],
                                          "unit": m["unit"]}
        if on_card:
            window_peak = torch.cuda.max_memory_allocated(device)
            dev = {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(device),
                   "count": 1,
                   "memory_peak_bytes": max(setup_peak, window_peak),
                   **extra, "power_limit": _power_limit()}
        else:
            dev = {"platform": device.type, "count": 0}
            metrics = {}

        ws = sorted(walls)
        print(f"benchmark: {attempted} jobs, walls min {ws[0]:.4f} median "
              f"{ws[len(ws) // 2]:.4f} max {ws[-1]:.4f} s, setup "
              f"{setup_s:.3f} s", file=sys.stderr)
        t_ref = time.perf_counter()
        res = inputs.compare(jobs.source, jobs.answers, jobs.values_of_job,
                             device)
        # a grouped check's own numbers (face slack), which no limit holds
        extra = "".join(f", {k} {v!r}" for k, v in res.items()
                        if k not in ("max_rel_err", "unlocated", "checked"))
        print(f"benchmark: {res['checked']} values compared with the "
              f"reference in {time.perf_counter() - t_ref:.3f} s{extra}",
              file=sys.stderr)
    finally:
        jobs.close()
    limit = float(cell.config["check"]["max_rel_err"])
    checks = {
        "max_rel_err": [res["max_rel_err"], limit],
        "unlocated": [res["unlocated"], 0],
        "failed_jobs": [failed, 0],
    }
    correct = res["checked"] > 0 and all(v <= lim
                                         for v, lim in checks.values())
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and on_card:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def _power_limit():
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s), "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", _T0)
    loaded = forbidden_modules()
    if loaded:
        print(f"benchmark: loaded {', '.join(loaded)}; the port must run "
              f"without JAX and without the JAX package", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
