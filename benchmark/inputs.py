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


# A target on an interface between groups (or on the source's outer
# surface) lies on an exact sphere, and so do the nodes of the group's
# faces there; between the nodes an order-4 face is a polynomial, which
# can pass a hair inside the sphere, so such a target may lie just outside
# every element of its own group.  Where no element of its group contains
# a target at ``reference.INSIDE_TOL``, one within this many reference
# units of [-1, 1]^3 does, and the target is interpolated at the clipped
# xi.  The largest misses measured: 1.68e-8 on a 64-element two-layer
# shell (every slot on its spheres, CPU), 3.77e-11 on the 4,096-element
# four-layer shell (65,536 slots on its spheres, H100); a miss in
# reference units falls as the element's size to the fourth.  This sits
# 6x above the first.
GROUP_FACE_TOL = 1e-7


@dataclasses.dataclass
class Source:
    """A configuration's source: ``lattice`` [E, n, 3] f64 frozen host
    array, ``values`` [P, E, n] f64 on the device, ``order``,
    ``parameters``, and optionally ``element_group`` [E] int: the check
    then locates each sampled target only among the elements of its own
    group (a layered model, discontinuous between its layers)."""

    lattice: np.ndarray
    values: torch.Tensor
    order: int
    parameters: list
    element_group: torch.Tensor | None = None


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
        self.points, self.values, self.jobs, self.groups = [], [], [], []

    def add(self, job: int, points, values, group=None):
        """One job's sampled targets [k, 3], the program's values there
        [k, P] and, where the source is grouped, each target's group [k]:
        a kind passes groups with all of its rows or with none."""
        if self.points and (group is None) != (not self.groups):
            raise ValueError("answers come with a group for every row or "
                             "for none")
        self.points.append(torch.as_tensor(points))
        self.values.append(torch.as_tensor(values))
        self.jobs.append(job)
        if group is not None:
            self.groups.append(torch.as_tensor(group))


def compare(source: Source, answers: Answers, values_of_job, device,
            dtype: torch.dtype = torch.float64) -> dict:
    """Locate every sampled target in the source with the plain
    reference, interpolate ``values_of_job(job)`` [P, E, n] there in
    ``dtype``, and return the numbers compared: ``max_rel_err`` (the
    largest |program - reference| / |reference|; NaN reads as inf),
    ``unlocated`` (sampled targets that no source element contains) and
    ``checked`` (values compared).  With ``dtype`` below f64 the
    program's values are replaced by that interpolation's (the
    control).  A grouped source is compared by ``compare_grouped``."""
    if source.element_group is not None or answers.groups:
        return compare_grouped(source, answers, values_of_job, device,
                               dtype)
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


def locate_grouped(lattice: torch.Tensor, element_group: torch.Tensor,
                   targets: torch.Tensor, groups: torch.Tensor, order: int,
                   inside_tol: float = GROUP_FACE_TOL):
    """``reference.locate`` of each target [S, 3] among the elements of
    ``lattice`` [E, n, 3] whose ``element_group`` [E] is the target's own
    ``groups`` [S], group by group: (element [S] long in the whole
    lattice, xi [S, 3], found [S], miss [S] as ``reference.locate``
    gives them, grouped [S]: False where the target's group holds no
    element, and then it is not found and its element and xi are 0)."""
    S, dev = targets.shape[0], lattice.device
    element = torch.zeros(S, dtype=torch.long, device=dev)
    xi = torch.zeros((S, 3), dtype=torch.float64, device=dev)
    found = torch.zeros(S, dtype=torch.bool, device=dev)
    miss = torch.full((S,), float("inf"), dtype=torch.float64, device=dev)
    grouped = torch.zeros(S, dtype=torch.bool, device=dev)
    element_group = element_group.to(device=dev, dtype=torch.long)
    groups = groups.to(device=dev, dtype=torch.long)
    for g in torch.unique(groups).tolist():
        rows = (groups == g).nonzero()[:, 0]
        members = (element_group == g).nonzero()[:, 0]
        if not members.numel():
            continue
        e, x, f, m = reference.locate(lattice[members], targets[rows], order,
                                      inside_tol=inside_tol, miss=True)
        element[rows], xi[rows], found[rows] = members[e], x, f
        miss[rows] = m
        grouped[rows] = True
    return element, xi, found, miss, grouped


def compare_grouped(source: Source, answers: Answers, values_of_job, device,
                    dtype: torch.dtype = torch.float64) -> dict:
    """``compare`` of a grouped source: each sampled target located only
    among its own group's elements (``locate_grouped``, with the face
    slack ``GROUP_FACE_TOL``).  ``max_rel_err``, ``unlocated`` and
    ``checked`` mean what they mean in ``compare``, over all groups; a
    target whose group holds no element is unlocated and not compared.
    Also ``face_slack``: the targets that only the slack located, and
    ``face_miss_max``: the largest distance past [-1, 1]^3 of a located
    target's element."""
    if source.element_group is None or len(answers.groups) != len(
            answers.points):
        raise ValueError("a grouped check needs the source's groups and "
                         "a group for every sampled target")
    lattice = on_device(source.lattice, device)
    pts = torch.cat([p.to(device) for p in answers.points])
    groups = torch.cat([g.to(device) for g in answers.groups])
    elem, xi, found, miss, grouped = locate_grouped(
        lattice, source.element_group, pts, groups, source.order)
    del lattice
    worst, checked, start = 0.0, 0, 0
    for job, p, v in zip(answers.jobs, answers.points, answers.values):
        sl = slice(start, start + p.shape[0])
        start += p.shape[0]
        keep = grouped[sl]
        e, x = elem[sl][keep], xi[sl][keep]
        vals = values_of_job(job)
        ref = reference.interpolate(vals, e, x, source.order)
        if dtype == torch.float64:
            got = v.to(device=device, dtype=torch.float64)[keep]
        else:
            got = reference.interpolate(vals, e, x, source.order,
                                        dtype=dtype)
        rel = ((got - ref).abs() / ref.abs()).nan_to_num(float("inf"))
        worst = max(worst, float(rel.max()) if rel.numel() else 0.0)
        checked += rel.numel()
    return {"max_rel_err": worst, "unlocated": int((~found).sum()),
            "checked": checked,
            "face_slack": int((found & (miss > reference.INSIDE_TOL)).sum()),
            "face_miss_max": float(miss[found].max()) if found.any()
            else 0.0}
