"""Point-cloud jobs: each job locates a fresh cloud of targets in the
source and interpolates the source's values there.

Traffic parameters (``traffic/<mix>.json``): ``targets_per_job``,
``law`` (the r, theta, phi ranges of the targets, inside the source),
``fallback``, ``check_rows_per_job``.

One job: ``TransferOperator.build(source lattice, targets, order, cfg,
fallback)`` then ``op.apply(values)`` -> [N, P], synchronised on the
device.  The targets are drawn on the device before the job's clock
starts.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from benchmark import inputs


class Jobs:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from multimesh_tpu_torch import LocateConfig, TransferOperator

        self.device = torch.device(device)
        self.seed = seed
        self.traffic = traffic
        self.source = inputs.make_source(config, self.device)
        self.cfg = LocateConfig(**config["locate"])
        self.operator = TransferOperator
        self.points_per_job = int(traffic["targets_per_job"])
        self.answers = inputs.Answers()

    def prepare(self, job: int):
        with record_function("bench.make_targets"):
            gen = inputs.job_generator(self.seed, job, 0, self.device)
            return inputs.meshes.shell_targets(
                self.points_per_job, self.traffic["law"], gen, self.device)

    def run(self, targets):
        with record_function("bench.build"):
            op = self.operator.build(self.source.lattice, targets,
                                     order=self.source.order, cfg=self.cfg,
                                     fallback=self.traffic["fallback"],
                                     device=self.device)
        with record_function("bench.apply"):
            vals = op.apply(self.source.values)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return vals

    def keep(self, job: int, targets, vals):
        k = int(self.traffic["check_rows_per_job"])
        rng = inputs.job_rng(self.seed, job, 1)
        idx = torch.as_tensor(rng.choice(self.points_per_job, k, replace=False),
                              device=self.device)
        self.answers.add(job, targets[idx], vals[idx].to(torch.float64))

    def values_of_job(self, job: int):
        return self.source.values

    def close(self):
        pass
