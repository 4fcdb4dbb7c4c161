"""Mesh-to-mesh jobs: each job carries the source's values onto every GLL
slot of a target mesh through ``engine.transfer_arrays``, the core of
``api.gll_2_gll`` between "arrays read" and "blocks written".

Traffic parameters (``traffic/<mix>.json``):

* ``target_mesh``: the target shell's maker arguments;
* ``rotate_max_rad``: each job rotates the target about the polar axis
  by a seed-drawn angle in [-a, a] (0: every job has the same target);
* ``stored_operator``: set-up saves the operator once through
  ``stored_array``, and every job loads it from there;
* ``perturb_max``: each job's source values are the configuration's
  times 1 + p sin(k . x / R + b), with |p| <= perturb_max and k, b drawn
  from the seed: a smooth model update (0: the same values every job);
* ``check_rows_per_job``.

The target's arrays are host arrays, as read from a file: f64
coordinates, old values [E, P, n] and every element solid.  The sink is
a preallocated host array standing in for the HDF5 dataset.  A job's
inputs (the rotated coordinates, the updated values) are made before its
clock starts; its clock stops when ``transfer_arrays`` has returned and
written every block into the sink.
"""
from __future__ import annotations

import math
import shutil
import tempfile

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import inputs, meshes


class Sink:
    """The host array the transfer writes into, block by block."""

    def __init__(self, shape):
        self.array = np.zeros(shape, np.float64)

    def __setitem__(self, key, block):
        with record_function("bench.sink_write"):
            self.array[key] = block


class Jobs:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from multimesh_tpu_torch import engine

        self.engine = engine
        self.device = torch.device(device)
        self.seed = seed
        self.traffic = traffic
        self.config = config
        self.source = inputs.make_source(config, self.device)
        self.src_data = self._host_values(self.source.values)
        args = {k: v for k, v in traffic["target_mesh"].items()
                if k != "maker"}
        self.target = meshes.shell_lattice(**args, device=self.device)
        E, n, _ = self.target.shape
        P = len(self.source.parameters)
        self.points_per_job = E * n
        self.old_values = np.ones((E, P, n), np.float64)
        self.solid = np.ones(E, bool)
        self.sink = Sink((E, P, n))
        self.answers = inputs.Answers()
        self.stored = None
        if traffic.get("perturb_max", 0.0):
            self.lattice_dev = inputs.on_device(self.source.lattice,
                                                self.device)
        if traffic.get("stored_operator", False):
            self.stored = tempfile.mkdtemp(prefix="mmt_bench_operator_")
            self.run((self._target_points(0.0), self.src_data))

    @staticmethod
    def _host_values(values):
        """[P, E, n] device values as the [E, P, n] host array of a file."""
        return values.permute(1, 0, 2).contiguous().cpu().numpy()

    def _target_points(self, angle: float):
        return meshes.rotate_z(self.target, angle).cpu().numpy()

    def _angle(self, job: int) -> float:
        a = float(self.traffic.get("rotate_max_rad", 0.0))
        return float(inputs.job_rng(self.seed, job, 0).uniform(-a, a)) if a else 0.0

    def values_of_job(self, job: int):
        """[P, E, n] device values the source holds in ``job``."""
        amp_max = float(self.traffic.get("perturb_max", 0.0))
        if not amp_max:
            return self.source.values
        rng = inputs.job_rng(self.seed, job, 2)
        k = rng.uniform(-3.0, 3.0, 3)
        b = rng.uniform(0.0, 2.0 * math.pi)
        amp = rng.uniform(-amp_max, amp_max)
        u = self.lattice_dev / meshes.R_EARTH
        phase = u[..., 0] * k[0] + u[..., 1] * k[1] + u[..., 2] * k[2] + b
        return self.source.values * (1.0 + amp * torch.sin(phase))[None]

    def prepare(self, job: int):
        with record_function("bench.make_job"):
            data = (self._host_values(self.values_of_job(job))
                    if self.traffic.get("perturb_max", 0.0)
                    else self.src_data)
            return self._target_points(self._angle(job)), data

    def run(self, job_inputs):
        new_points, data = job_inputs
        with record_function("bench.transfer_arrays"):
            return self.engine.transfer_arrays(
                self.source.lattice, data, self.source.parameters,
                new_points, self.old_values, self.solid,
                lambda params: self.sink,
                nelem_to_search=int(self.config["locate"]["nelem_to_search"]),
                stored_array=self.stored, device=self.device)

    def keep(self, job: int, job_inputs, values):
        new_points, _ = job_inputs
        E, P, n = self.sink.array.shape
        k = int(self.traffic["check_rows_per_job"])
        flat = inputs.job_rng(self.seed, job, 1).choice(E * n, k,
                                                        replace=False)
        e, m = flat // n, flat % n
        self.answers.add(job, new_points[e, m], self.sink.array[e, :, m])

    def close(self):
        if self.stored:
            shutil.rmtree(self.stored, ignore_errors=True)
