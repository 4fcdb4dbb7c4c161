"""The control of the correctness check, read on the card.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 \
        --seconds 5

For each seed, one window of whole jobs at the cell's own load (set-up
and the warm-up once, for all seeds), then the numbers the check
compares, twice over the same sampled targets: the program's values
against the f64 plain reference (the readings its limit is set above),
and the control's: the reference's own interpolation computed in
bfloat16, the precision below the configuration's float32, put in the
program's place (the readings its limit must stay below).  One JSON line
a seed.  The benchmark's own runs never run this.
"""
import argparse
import json
import pathlib
import sys
import time

if __name__ == "__main__":
    sys.path[0] = str(pathlib.Path(__file__).resolve().parent.parent)

import torch  # noqa: E402

from benchmark import inputs, run, spec  # noqa: E402

CONTROL_DTYPE = torch.bfloat16


def readings(cell: spec.Cell, seeds, seconds: float, device="cuda"):
    """[(seed, program's numbers, control's numbers)] of ``cell``."""
    device = torch.device(device)
    Jobs = spec.job_kind(cell.traffic["kind"], cell.base)
    jobs = Jobs(cell.config, cell.traffic, seeds[0], device)
    out = []
    try:
        jobs.run(jobs.prepare(run.WARMUP_JOB))
        for seed in seeds:
            jobs.seed = seed
            jobs.answers = inputs.Answers()
            run._window(jobs, seconds)
            program = inputs.compare(jobs.source, jobs.answers,
                                     jobs.values_of_job, device)
            control = inputs.compare(jobs.source, jobs.answers,
                                     jobs.values_of_job, device,
                                     dtype=CONTROL_DTYPE)
            out.append((seed, program, control))
    finally:
        jobs.close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload, run.ROOT)
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    t = time.perf_counter()
    for seed, program, control in readings(
            cell, [int(s) for s in args.seeds.split(",")], args.seconds):
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "program": program, "control": control,
                          "elapsed_s": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
