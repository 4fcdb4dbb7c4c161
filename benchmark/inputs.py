"""Inputs shared by every kind of job: the source of a configuration, the
seeds of each job, and the sampled answers that the check compares.

The source lattice is made on the device and handed to the program as a
frozen host array, as a caller holds a mesh read from a file (the
program's ``locate`` hashes a read-only lattice once); the source values
stay on the device, as a caller making many transfers from one model
holds them.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from . import meshes, reference


def job_seed(seed: int, job: int, stream: int) -> int:
    """A 63-bit seed for one stream of one job, from the run's ``seed``
    (any integer) and the job's index."""
    ss = np.random.SeedSequence([seed % 2**64, job % 2**64, stream])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def job_rng(seed: int, job: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(job_seed(seed, job, stream))


def job_generator(seed: int, job: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        job_seed(seed, job, stream))


@dataclasses.dataclass
class Source:
    """A configuration's source: ``lattice`` [E, n, 3] f64 frozen host
    array, ``values`` [P, E, n] f64 on the device, ``order``,
    ``parameters``."""

    lattice: np.ndarray
    values: torch.Tensor
    order: int
    parameters: list


def on_device(array: np.ndarray, device) -> torch.Tensor:
    """A device copy of a (possibly frozen) host array; it is only read."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*not writable")
        return torch.as_tensor(array, device=device)


def make_source(config: dict, device) -> Source:
    mesh = config["mesh"]
    if mesh["maker"] != "shell":
        raise ValueError(f"unknown mesh maker {mesh['maker']!r}")
    args = {k: v for k, v in mesh.items() if k != "maker"}
    lat = meshes.shell_lattice(**args, device=device)
    base = meshes.smooth_field(lat)
    scales = torch.as_tensor(config["field_scales"], dtype=torch.float64,
                             device=device)
    values = base[None] * scales[:, None, None]
    host = lat.cpu().numpy()
    host.setflags(write=False)
    del lat
    return Source(host, values, int(mesh["order"]),
                  list(config["parameters"]))


class Answers:
    """The sampled answers of the window's jobs: per job, the targets'
    coordinates and the program's values there, kept as they come and
    compared with the reference once the window has closed."""

    def __init__(self):
        self.points, self.values, self.jobs = [], [], []

    def add(self, job: int, points, values):
        self.points.append(torch.as_tensor(points))
        self.values.append(torch.as_tensor(values))
        self.jobs.append(job)


def compare(source: Source, answers: Answers, values_of_job, device,
            dtype: torch.dtype = torch.float64) -> dict:
    """Locate every sampled target in the source with the plain
    reference, interpolate ``values_of_job(job)`` [P, E, n] there in
    ``dtype``, and return the numbers compared: ``max_rel_err`` (the
    largest |program - reference| / |reference|; NaN reads as inf),
    ``unlocated`` (sampled targets that no source element contains) and
    ``checked`` (values compared).  With ``dtype`` below f64 the
    program's values are replaced by that interpolation's (the
    control)."""
    lattice = on_device(source.lattice, device)
    pts = torch.cat([p.to(device) for p in answers.points])
    elem, xi, found = reference.locate(lattice, pts, source.order)
    del lattice
    worst, checked, start = 0.0, 0, 0
    for job, p, v in zip(answers.jobs, answers.points, answers.values):
        sl = slice(start, start + p.shape[0])
        start += p.shape[0]
        vals = values_of_job(job)
        ref = reference.interpolate(vals, elem[sl], xi[sl], source.order)
        if dtype == torch.float64:
            got = v.to(device=device, dtype=torch.float64)
        else:
            got = reference.interpolate(vals, elem[sl], xi[sl], source.order,
                                        dtype=dtype)
        rel = ((got - ref).abs() / ref.abs()).nan_to_num(float("inf"))
        worst = max(worst, float(rel.max()) if rel.numel() else 0.0)
        checked += rel.numel()
    return {"max_rel_err": worst, "unlocated": int((~found).sum()),
            "checked": checked}
