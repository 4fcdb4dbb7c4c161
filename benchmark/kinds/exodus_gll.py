"""Exodus-to-GLL jobs: each job carries the nodal fields of the
configuration's trilinear hex source onto every GLL slot of a new target
mesh through ``engine.exodus_2_gll_arrays``, the core of
``api.exodus_2_gll`` between "arrays read" and "blocks written".

The configuration's mesh must be of order 1: its lattice is the hexes'
corner nodes [E, 8, 3] in the canonical tensor-product order that
``io/exodus.canonical_corner_nodes`` hands the program, and its values
at those corners are the nodal fields gathered through the canonical
connectivity [F, E, 8] (a vertex shared by hexes carries the same bits
in each, as an Exodus nodal field does).  Both are host arrays, the
corners frozen, as read from the file.

Traffic parameters (``traffic/<mix>.json``):

* ``target_mesh``: the target shell's maker arguments;
* ``rotate_max_rad``: each job rotates the target about the polar axis
  by a seed-drawn angle in [-a, a];
* ``check_rows_per_job``.

A job's target coordinates are made before its clock starts, rounded to
float32 as ``exodus_2_gll`` reads them.  The sink is a preallocated f32
host array standing in for the ``MODEL/data`` dataset, so the path's f32
blocks land in it as they are; its clock stops when
``exodus_2_gll_arrays`` has returned and written every block.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import inputs, meshes
from benchmark.kinds.mesh import Sink


class F32Sink(Sink):
    """``kinds/mesh.Sink`` holding float32, the dtype the path writes."""

    def __init__(self, shape):
        self.array = np.zeros(shape, np.float32)


class Jobs:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from multimesh_tpu_torch import engine

        self.engine = engine
        self.device = torch.device(device)
        self.seed = seed
        self.traffic = traffic
        self.config = config
        self.source = inputs.make_source(config, self.device)
        if self.source.order != 1:
            raise ValueError("an Exodus source is of order 1, got "
                             f"{self.source.order}")
        self.fields = self.source.values.cpu().numpy()  # [F, E, 8]
        args = {k: v for k, v in traffic["target_mesh"].items()
                if k != "maker"}
        self.target = meshes.shell_lattice(**args, device=self.device)
        E, n, _ = self.target.shape
        self.points_per_job = E * n
        self.sink = F32Sink((E, len(self.source.parameters), n))
        self.answers = inputs.Answers()

    def _angle(self, job: int) -> float:
        a = float(self.traffic.get("rotate_max_rad", 0.0))
        return float(inputs.job_rng(self.seed, job, 0).uniform(-a, a)) if a else 0.0

    def values_of_job(self, job: int):
        """[P, E, 8] device values the source holds in every job."""
        return self.source.values

    def prepare(self, job: int):
        with record_function("bench.make_job"):
            return meshes.rotate_z(self.target, self._angle(job)).to(
                torch.float32).cpu().numpy()

    def run(self, coords):
        """The job; returns the sink's array, written."""
        with record_function("bench.exodus_2_gll_arrays"):
            self.engine.exodus_2_gll_arrays(
                self.source.lattice, self.fields, self.source.parameters,
                coords, lambda params: self.sink,
                nelem_to_search=int(self.config["locate"]["nelem_to_search"]),
                device=self.device)
        return self.sink.array

    def keep(self, job: int, coords, values):
        E, P, n = self.sink.array.shape
        k = int(self.traffic["check_rows_per_job"])
        flat = inputs.job_rng(self.seed, job, 1).choice(E * n, k,
                                                        replace=False)
        e, m = flat // n, flat % n
        self.answers.add(job, coords[e, m].astype(np.float64),
                         self.sink.array[e, :, m])

    def close(self):
        pass
