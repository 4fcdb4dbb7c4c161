"""Regular-grid jobs: each job samples the source model onto a new regular
lat/lon/depth grid through ``engine.extract_regular_grid``, the entry
``api.extract_regular_grid`` calls; the grid overhangs the model, and
every point that no element holds reads 0.

Traffic parameters (``traffic/<mix>.json``):

* ``lat_deg``, ``lon_deg``, ``depth_m``: each axis as (first, last,
  count), depth in metres below a sphere of radius ``meshes.R_EARTH``;
* ``shift_max_deg``: each job shifts the lat and the lon axis by offsets
  drawn from the seed, uniform in [-s, s] degrees (depth is fixed), so
  every job is a new grid;
* ``check_rows_per_job`` grid points sampled a job among those at least
  ``inside_margin`` of an element's width inside every face of the
  source's (r, colatitude, longitude) box, handed to ``Answers.add`` and
  compared with the plain reference by ``inputs.compare``;
* ``outside_rows_per_job`` grid points sampled a job among those more
  than ``outside_band`` of an element's width outside a face of that box,
  beyond the reach of the program's accept tolerance 1.05 (2.5% of a
  width past a face); each must read exactly 0.0 in every parameter.
  Points between the two margins are held to neither rule.

How the zeros enter ``correct``: an outside row that reads anything but
0.0 is printed on standard error and handed to ``Answers.add`` as the
value NaN at the job's first inside row, which ``compare`` reads as a
relative error of inf.  The sampled rows' coordinates are the kind's
own: r = R - depth, colatitude = 90 - lat, longitude.

The source is a live mesh object, as a caller holding a salvus mesh
passes it: the frozen element-nodal lattice and host fields.  A job's
inputs (the shifted extents) are made before its clock starts; its clock
stops when the call has returned the grid's dataset.  The NetCDF write
is left out.
"""
from __future__ import annotations

import sys
import types

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import inputs, meshes


def _box(mesh: dict):
    """(r, colatitude, longitude) of the source shell: each axis's (low,
    high, element width)."""
    r = (mesh["r_inner"], mesh["r_outer"], mesh["n_rad"])
    th = (*mesh["lat_extent"], mesh["n_lat"])
    ph = (*mesh["lon_extent"], mesh["n_lon"])
    return [(lo, hi, (hi - lo) / n) for lo, hi, n in (r, th, ph)]


class Jobs:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from multimesh_tpu_torch import engine

        self.engine = engine
        self.device = torch.device(device)
        self.seed = seed
        self.traffic = traffic
        self.source = inputs.make_source(config, self.device)
        host = self.source.values.cpu().numpy()
        self.mesh = types.SimpleNamespace(
            points=self.source.lattice,
            element_nodal_fields={p: host[i] for i, p in
                                  enumerate(self.source.parameters)})
        self.box = _box(config["mesh"])
        self.shape = (int(traffic["depth_m"][2]), int(traffic["lat_deg"][2]),
                      int(traffic["lon_deg"][2]))
        self.points_per_job = int(np.prod(self.shape))
        self.answers = inputs.Answers()

    def values_of_job(self, job: int):
        """[P, E, n] device values the source holds in every job."""
        return self.source.values

    def prepare(self, job: int):
        """The job's (lat, lon, depth) extents, lat and lon shifted."""
        with record_function("bench.make_job"):
            s = float(self.traffic["shift_max_deg"])
            shifts = inputs.job_rng(self.seed, job, 0).uniform(-s, s, 2)
            (lat0, lat1, n_lat), (lon0, lon1, n_lon), (d0, d1, n_d) = (
                self.traffic[k] for k in ("lat_deg", "lon_deg", "depth_m"))
            return ((lat0 + shifts[0], lat1 + shifts[0], int(n_lat)),
                    (lon0 + shifts[1], lon1 + shifts[1], int(n_lon)),
                    (d0, d1, int(n_d)))

    def run(self, extents):
        """The job; returns the grid's dataset."""
        lat, lon, depth = extents
        with record_function("bench.extract_regular_grid"):
            return self.engine.extract_regular_grid(
                self.mesh, self.source.parameters, lat, lon, depth,
                device=self.device)

    def _sides(self, axes):
        """Per axis (depth, lat, lon): each grid value's (inside, outside)
        masks against the source's box, by the kind's own formula."""
        depth, lat, lon = axes
        coords = (meshes.R_EARTH - depth, np.deg2rad(90.0 - lat),
                  np.deg2rad(lon))
        margin = float(self.traffic["inside_margin"])
        band = float(self.traffic["outside_band"])
        out = []
        for x, (lo, hi, w) in zip(coords, self.box):
            out.append(((x >= lo + margin * w) & (x <= hi - margin * w),
                        (x < lo - band * w) | (x > hi + band * w)))
        return out

    @staticmethod
    def _xyz(depth, lat, lon):
        r = meshes.R_EARTH - depth
        th, ph = np.deg2rad(90.0 - lat), np.deg2rad(lon)
        return np.stack([r * np.sin(th) * np.cos(ph),
                         r * np.sin(th) * np.sin(ph), r * np.cos(th)], -1)

    def keep(self, job: int, extents, ds):
        axes = [np.linspace(e[0], e[1], e[2]) for e in
                (extents[2], extents[0], extents[1])]
        rng = inputs.job_rng(self.seed, job, 1)
        sides = self._sides(axes)
        # inside: uniform over the product of each axis's inside values
        ins = [np.flatnonzero(i) for i, _ in sides]
        flat = rng.choice(int(np.prod([a.size for a in ins])),
                          int(self.traffic["check_rows_per_job"]),
                          replace=False)
        i_idx = [a[i] for a, i in zip(ins, np.unravel_index(
            flat, [a.size for a in ins]))]
        # outside: uniform over the points outside some face, by rejection
        k_out = int(self.traffic["outside_rows_per_job"])
        near = np.prod([(~o).sum() for _, o in sides])
        if self.points_per_job - near < k_out:
            raise ValueError(f"the grid has fewer than {k_out} points "
                             "outside the source")
        picked = np.zeros(0, np.int64)
        while picked.size < k_out:
            draw = rng.integers(0, self.points_per_job, 8 * k_out)
            idx = np.unravel_index(draw, self.shape)
            far = np.zeros(draw.size, bool)
            for (_, o), ix in zip(sides, idx):
                far |= o[ix]
            picked = np.unique(np.concatenate([picked, draw[far]]))
        picked = rng.permutation(picked)[:k_out]
        o_idx = np.unravel_index(picked, self.shape)

        params = self.source.parameters
        vals_in = np.stack([ds.data[p][tuple(i_idx)] for p in params], -1)
        vals_out = np.stack([ds.data[p][o_idx] for p in params], -1)
        xyz_in = self._xyz(*(a[i] for a, i in zip(axes, i_idx)))
        bad = np.flatnonzero((vals_out != 0).any(axis=1))
        for b in bad:
            print(f"benchmark: job {job}: outside grid point (depth, lat, "
                  f"lon) {tuple(float(a[i[b]]) for a, i in zip(axes, o_idx))}"
                  f" reads {vals_out[b].tolist()}, not 0", file=sys.stderr)
        self.answers.add(job, np.concatenate(
            [xyz_in, np.repeat(xyz_in[:1], bad.size, axis=0)]),
            np.concatenate([vals_in.astype(np.float64),
                            np.full((bad.size, len(params)), np.nan)]))

    def close(self):
        pass
