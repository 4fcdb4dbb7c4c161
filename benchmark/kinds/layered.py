"""Layered mesh-to-mesh jobs: each job carries a layered model, which jumps
at the interfaces between its layers, onto every GLL slot of a new
target mesh through ``engine.gll_2_gll_layered``, each slot located only
among the source elements of its own layer.

Configuration keys beyond a shell source's: ``n_layers`` (the source's
radial bands split into that many layers, ``meshes.shell_layer_ids``),
``field_scales`` and ``layer_jump``: each parameter is ``smooth_field``
times its own scale and times ``layer_jump ** (layer - 1)``, the values
``layered_rehearsal._fields`` makes.

Traffic parameters (``traffic/<mix>.json``):

* ``target_mesh`` and ``n_layers``: the target shell and its layers, on
  the source's radii so that the interfaces coincide;
* ``rotate_max_rad``: each job rotates the target about the polar axis
  by a seed-drawn angle in [-a, a];
* ``layers``: the call's layer selection (``"nocore"``: every layer of a
  mesh without fluid elements);
* ``check_rows_per_job`` slots sampled a job, ``interface_share`` of them
  on the interfaces.

Source and target are live mesh objects, as a caller holding salvus
meshes passes them: element-nodal host arrays of coordinates and fields,
and the elemental fields ``fluid`` (all 0) and ``layer``.  A job's inputs
(the rotated coordinates, the target's fields reset to NaN, so that a
slot left unwritten fails the check) are made before its clock starts;
its clock stops when the call has returned, every field written.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import inputs, layered_rehearsal, meshes


class Jobs:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from multimesh_tpu_torch import engine

        self.engine = engine
        self.device = torch.device(device)
        self.seed = seed
        self.traffic = traffic
        self.config = config
        params = list(config["parameters"])
        if (config["layer_jump"] != layered_rehearsal.JUMP
                or config["field_scales"] != [1.0 + 0.1 * i
                                              for i in range(len(params))]):
            raise ValueError("the fields are layered_rehearsal._fields': "
                             "scales 1 + 0.1 i and a jump of "
                             f"{layered_rehearsal.JUMP} a layer")
        mesh = {k: v for k, v in config["mesh"].items() if k != "maker"}
        lattice = meshes.shell_lattice(**mesh, device=self.device)
        layer = meshes.shell_layer_ids(mesh["n_lat"], mesh["n_lon"],
                                       mesh["n_rad"], config["n_layers"],
                                       device=self.device)
        values = layered_rehearsal._fields(lattice, layer, params)
        host = lattice.cpu().numpy()
        host.setflags(write=False)
        del lattice
        self.source = inputs.Source(host, values, int(mesh["order"]), params,
                                    element_group=layer)
        self.old = layered_rehearsal._live(host, values.cpu().numpy(),
                                           layer.cpu().numpy(), params)

        args = {k: v for k, v in traffic["target_mesh"].items()
                if k != "maker"}
        self.target = meshes.shell_lattice(**args, device=self.device)
        shape = (args["n_lat"], args["n_lon"], args["n_rad"],
                 traffic["n_layers"])
        self.target_layer = meshes.shell_layer_ids(
            *shape, device=self.device).cpu().numpy()
        E, n, _ = self.target.shape
        self.points_per_job = E * n
        self.fields = {p: np.full((E, n), np.nan) for p in params}
        iface, _ = layered_rehearsal._boundary_slots(shape, args["order"])
        self.interface = iface
        inside = np.ones(E * n, bool)
        inside[iface] = False
        self.others = np.nonzero(inside)[0]
        self.answers = inputs.Answers()

    def _angle(self, job: int) -> float:
        a = float(self.traffic.get("rotate_max_rad", 0.0))
        return float(inputs.job_rng(self.seed, job, 0).uniform(-a, a)) if a else 0.0

    def values_of_job(self, job: int):
        """[P, E, n] device values the source holds in every job."""
        return self.source.values

    def prepare(self, job: int):
        """A live target mesh: the rotated coordinates and NaN fields."""
        with record_function("bench.make_job"):
            points = meshes.rotate_z(self.target,
                                     self._angle(job)).cpu().numpy()
            for f in self.fields.values():
                f.fill(np.nan)
            return layered_rehearsal._live(
                points, list(self.fields.values()), self.target_layer,
                self.source.parameters)

    def run(self, new):
        """The job; returns the target, its fields written."""
        with record_function("bench.gll_2_gll_layered"):
            self.engine.gll_2_gll_layered(
                self.old, new, layers=self.traffic["layers"],
                parameters=self.source.parameters,
                nelem_to_search=int(self.config["locate"]["nelem_to_search"]),
                device=self.device)
        return new

    def keep(self, job: int, new, out):
        E, n, _ = new.points.shape
        k = int(self.traffic["check_rows_per_job"])
        k_iface = int(round(k * float(self.traffic["interface_share"])))
        rng = inputs.job_rng(self.seed, job, 1)
        flat = np.concatenate([
            self.others[rng.choice(self.others.size, k - k_iface,
                                   replace=False)],
            self.interface[rng.choice(self.interface.size, k_iface,
                                      replace=False)]])
        e, m = flat // n, flat % n
        values = np.stack([out.element_nodal_fields[p][e, m]
                           for p in self.source.parameters], axis=-1)
        self.answers.add(job, new.points[e, m], values,
                         self.target_layer[e])

    def close(self):
        pass
