"""The job generators: the same seed gives the same jobs, another seed
other jobs, and every target lies inside the source."""
import json

import numpy as np
import pytest
import torch

from benchmark import inputs, meshes, spec
from benchmark.tests import tiny

SEED = 2**31 + 12345  # more than 32 signed bits hold


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def _jobs(root, mix, seed):
    cell = spec.load_cell(f"tiny.{mix}", root)
    Jobs = spec.job_kind(cell.traffic["kind"], cell.base)
    return Jobs(cell.config, cell.traffic, seed, "cpu")


def _flat(job_inputs):
    if isinstance(job_inputs, torch.Tensor):
        return [job_inputs.numpy()]
    return [np.asarray(a) for a in job_inputs]


@pytest.mark.parametrize("mix", tiny.MIXES)
def test_the_same_seed_gives_the_same_jobs(root, mix):
    a, b = _jobs(root, mix, SEED), _jobs(root, mix, SEED)
    for job in (1, 2, 7):
        for x, y in zip(_flat(a.prepare(job)), _flat(b.prepare(job))):
            np.testing.assert_array_equal(x, y)
    a.close()
    b.close()


@pytest.mark.parametrize("mix", ["points_1m", "mesh_new_1m",
                                 "mesh_refresh_1m"])
def test_another_seed_or_job_gives_other_jobs(root, mix):
    a, b = _jobs(root, mix, SEED), _jobs(root, mix, SEED + 1)
    first = _flat(a.prepare(1))
    assert any(not np.array_equal(x, y)
               for x, y in zip(first, _flat(b.prepare(1))))
    assert any(not np.array_equal(x, y)
               for x, y in zip(first, _flat(a.prepare(2))))
    a.close()
    b.close()


def _spherical(p):
    p = np.asarray(p).reshape(-1, 3)
    r = np.linalg.norm(p, axis=-1)
    return r, np.arccos(p[:, 2] / r), np.arctan2(p[:, 1], p[:, 0])


@pytest.mark.parametrize("mix", tiny.MIXES)
def test_targets_lie_inside_the_source(mix):
    """Every real mix's targets (the real source's extent) lie inside the
    source shell: points by their law, meshes rotated by up to the
    mix's largest angle."""
    from benchmark.tests.tiny import REPO

    cfg = json.loads(
        (REPO / "benchmark/configs/gll4_shell_e4096.json").read_text())
    src = cfg["mesh"]
    t = json.loads((REPO / f"benchmark/traffic/{mix}.json").read_text())
    if t["kind"] == "points":
        gen = torch.Generator().manual_seed(SEED)
        pts = meshes.shell_targets(20000, t["law"], gen, "cpu")
    else:
        m = {k: v for k, v in t["target_mesh"].items() if k != "maker"}
        m.update(n_lat=4, n_lon=4, n_rad=4)  # the extent, fewer elements
        lat = meshes.shell_lattice(**m)
        a = t["rotate_max_rad"]
        pts = torch.cat([meshes.rotate_z(lat, s * a) for s in (-1, 1)])
    r, th, ph = _spherical(pts)
    assert r.min() > src["r_inner"] and r.max() < src["r_outer"]
    assert th.min() > src["lat_extent"][0] and th.max() < src["lat_extent"][1]
    assert ph.min() > src["lon_extent"][0] and ph.max() < src["lon_extent"][1]


def test_job_seeds_take_any_integer():
    seeds = {inputs.job_seed(s, j, k) for s in (0, 1, -1, 2**31 + 5, 2**40)
             for j in (0, 1) for k in (0, 1)}
    assert len(seeds) == 20
    assert all(0 <= s < 2**63 for s in seeds)


def test_the_target_mesh_has_exact_duplicate_nodes():
    """Shared nodes get the same bits from both elements, so a dedup of
    the mesh-to-mesh cells' target finds (20 * 4 + 1)^3 unique points,
    also after a rotation."""
    lat = meshes.shell_lattice(20, 20, 20, 4, 3.7e6, 6.2e6, (0.58, 1.12),
                               (0.38, 1.32))
    for angle in (0.0, 0.0312):
        pts = meshes.rotate_z(lat, angle).reshape(-1, 3).numpy()
        assert len(np.unique(pts, axis=0)) == 81**3
