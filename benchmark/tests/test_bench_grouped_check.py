"""The check's reference grouped by layer (``inputs.compare`` on a
source with ``element_group``), on the CPU at a tiny size: without groups
it reads what the check read before groups existed, bit for bit; one
group of every element reads the same; on a two-layer shell whose field
jumps by 10% at the interface it passes the program's own answers, which
the group-blind check fails, and fails a program that took the other
layer's value, the bfloat16 control and a target whose group holds no
element."""
import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from benchmark import inputs, meshes, reference, run, spec
from benchmark.tests import test_bench_exodus_gll, tiny

LIMIT = json.loads((tiny.REPO / "benchmark/configs/gll4_shell_e4096.json")
                   .read_text())["check"]["max_rel_err"]


def _locate_before(lattice, targets, order, block=8192):
    """``reference.locate`` as it was before ``inside_tol``, frozen."""
    lattice = lattice.to(torch.float64)
    targets = targets.to(device=lattice.device, dtype=torch.float64)
    centroids = lattice.mean(dim=1)
    k = min(reference.CANDIDATES, lattice.shape[0])
    rows = max(1, min(block, 2**27 // lattice.shape[0]))
    cand = torch.cat([
        torch.cdist(targets[s:s + rows], centroids)
        .topk(k, largest=False).indices
        for s in range(0, targets.shape[0], rows)])
    elems, xis, founds = [], [], []
    for s in range(0, targets.shape[0], block):
        c = cand[s:s + block]
        q = targets[s:s + block, None, :].expand(-1, k, -1)
        xi, res = reference._newton(order, lattice[c], q)
        outside = xi.abs().amax(dim=-1)
        inside = (outside <= 1.0 + reference.INSIDE_TOL) & (res < 1e-9)
        first = torch.where(inside.any(dim=1),
                            inside.to(torch.int8).argmax(dim=1),
                            outside.argmin(dim=1))
        r = torch.arange(c.shape[0], device=c.device)
        elems.append(c[r, first])
        xis.append(xi[r, first].clamp(-1.0, 1.0))
        founds.append(inside.any(dim=1))
    return torch.cat(elems), torch.cat(xis), torch.cat(founds)


def _compare_before(source, answers, values_of_job, device,
                    dtype=torch.float64):
    """``inputs.compare`` as it was before groups, frozen."""
    lattice = inputs.on_device(source.lattice, device)
    pts = torch.cat([p.to(device) for p in answers.points])
    elem, xi, found = _locate_before(lattice, pts, source.order)
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


# --- the tiny cells' own answers, with no groups --------------------------

CELLS = [f"tiny.{mix}" for mix in tiny.MIXES] + [test_bench_exodus_gll.CELL]


@pytest.fixture(scope="module")
def windows(tmp_path_factory):
    """cell -> its Jobs after a warm-up and a short window on the CPU,
    holding the window's sampled answers."""
    root = test_bench_exodus_gll.make_root(tmp_path_factory.mktemp("bench"))
    out = {}
    for name in CELLS:
        cell = spec.load_cell(name, root)
        Jobs = spec.job_kind(cell.traffic["kind"], cell.base)
        jobs = Jobs(cell.config, cell.traffic, 2**31 + 313, "cpu")
        try:
            jobs.run(jobs.prepare(run.WARMUP_JOB))
            run._window(jobs, 0.2)
        finally:
            jobs.close()
        assert jobs.answers.points and not jobs.answers.groups
        out[name] = jobs
    return out


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16],
                         ids=["program", "control"])
@pytest.mark.parametrize("cell", CELLS)
def test_without_groups_the_check_reads_as_before(windows, cell, dtype):
    jobs = windows[cell]
    got = inputs.compare(jobs.source, jobs.answers, jobs.values_of_job,
                         "cpu", dtype=dtype)
    want = _compare_before(jobs.source, jobs.answers, jobs.values_of_job,
                           "cpu", dtype=dtype)
    assert got == want  # the same keys and the same bits
    assert got["checked"] > 0 and got["unlocated"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_one_group_of_every_element_reads_the_same(windows, cell):
    jobs = windows[cell]
    E = jobs.source.lattice.shape[0]
    source = dataclasses.replace(
        jobs.source, element_group=torch.full((E,), 7, dtype=torch.int64))
    answers = inputs.Answers()
    for job, p, v in zip(jobs.answers.jobs, jobs.answers.points,
                         jobs.answers.values):
        answers.add(job, p, v, torch.full((p.shape[0],), 7))
    for dtype in (torch.float64, torch.bfloat16):
        got = inputs.compare(source, answers, jobs.values_of_job, "cpu",
                             dtype=dtype)
        want = inputs.compare(jobs.source, jobs.answers, jobs.values_of_job,
                              "cpu", dtype=dtype)
        assert {k: got[k] for k in want} == want
        assert got["face_slack"] == 0  # every target lies inside the shell


# --- a two-layer shell, discontinuous at its interface ---------------------

SRC = dict(n_lat=4, n_lon=4, n_rad=4, order=4, n_layers=2)
TGT = dict(n_lat=3, n_lon=3, n_rad=4, order=4, n_layers=2,
           lat_extent=(0.55, 1.15), lon_extent=(0.35, 1.35))
PARAMS = ["VP", "VS", "RHO"]
JUMP = {1: 1.0, 2: 1.1}  # the field's factor in each layer
INTERIOR, ON_INTERFACE = 96, 32  # check rows of each kind


@pytest.fixture(scope="module")
def layered():
    """The port's ``engine.gll_2_gll_layered`` on the CPU between two
    live two-layer shells whose interfaces coincide: the grouped source,
    the sampled answers (random slots, then slots on the interface) and
    each row's layer and whether it lies on the interface."""
    from multimesh_tpu_torch import engine, testing

    src, tgt = testing.shell_mesh(**SRC), testing.shell_mesh(**TGT)

    def live(mesh, fill=None):
        base = testing.smooth_field(mesh.points)
        jump = np.array([JUMP[layer] for layer in mesh.layer_id])[:, None]
        nodal = {p: (base * jump * (1.0 + 0.1 * i) if fill is None
                     else np.full_like(base, fill))
                 for i, p in enumerate(PARAMS)}
        return types.SimpleNamespace(
            points=mesh.points, element_nodal_fields=nodal,
            elemental_fields={"fluid": np.zeros(mesh.nelem),
                              "layer": mesh.layer_id.astype(np.float64)})

    old, new = live(src), live(tgt, 0.0)
    engine.gll_2_gll_layered(old, new, layers="all", parameters=PARAMS,
                             device="cpu")
    E, n, o = tgt.nelem, tgt.n_gll, tgt.order
    elem = np.repeat(np.arange(E), n)
    node_r = np.tile(np.arange(n) // (o + 1) ** 2, E)  # radial node index
    band = elem // (TGT["n_lat"] * TGT["n_lon"])
    top = TGT["n_rad"] // 2  # the first band of layer 2
    iface = np.nonzero(((band == top - 1) & (node_r == o))
                       | ((band == top) & (node_r == 0)))[0]
    rng = np.random.default_rng(2**31 + 55)
    pick = np.concatenate([
        rng.choice(np.setdiff1d(np.arange(E * n), iface), INTERIOR,
                   replace=False),
        rng.choice(iface, ON_INTERFACE, replace=False)])
    e, m = pick // n, pick % n
    values = torch.stack([torch.as_tensor(old.element_nodal_fields[p])
                          for p in PARAMS])
    source = inputs.Source(
        src.points, values, src.order, PARAMS,
        element_group=meshes.shell_layer_ids(SRC["n_lat"], SRC["n_lon"],
                                             SRC["n_rad"], SRC["n_layers"]))
    return types.SimpleNamespace(
        source=source, points=tgt.points[e, m],
        values=np.stack([new.element_nodal_fields[p][e, m] for p in PARAMS],
                        -1),
        layer=tgt.layer_id[e], on_interface=np.arange(pick.size) >= INTERIOR)


def _answers(rows, points, values, groups=None):
    a = inputs.Answers()
    a.add(1, points[rows], values[rows],
          None if groups is None else groups[rows])
    return a


def _check(lay, rows=slice(None), values=None, grouped=True,
           dtype=torch.float64, groups=None):
    values = lay.values if values is None else values
    source = lay.source if grouped else dataclasses.replace(
        lay.source, element_group=None)
    groups = (lay.layer if groups is None else groups) if grouped else None
    return inputs.compare(source, _answers(rows, lay.points, values, groups),
                          lambda job: source.values, "cpu", dtype=dtype)


def test_the_grouped_check_passes_the_layered_program(layered):
    res = _check(layered)
    assert res["unlocated"] == 0
    assert res["checked"] == (INTERIOR + ON_INTERFACE) * len(PARAMS)
    assert res["max_rel_err"] < 2e-6 < LIMIT
    # slots on the interface and on the outer sphere lie a hair outside
    # their own layer's polynomial faces: the slack takes them
    assert res["face_slack"] > 0
    assert 1e-9 < res["face_miss_max"] <= inputs.GROUP_FACE_TOL


def test_the_group_blind_check_fails_it_on_the_interface(layered):
    on = layered.on_interface
    assert _check(layered, on, grouped=False)["max_rel_err"] > LIMIT
    assert _check(layered, ~on, grouped=False)["max_rel_err"] < LIMIT


def test_the_other_layers_value_on_the_interface_fails(layered):
    on = layered.on_interface
    other = np.where(layered.layer == 1, JUMP[2] / JUMP[1],
                     JUMP[1] / JUMP[2])
    swapped = layered.values.copy()
    swapped[on] *= other[on, None]
    res = _check(layered, values=swapped)
    assert res["unlocated"] == 0 and res["max_rel_err"] > LIMIT
    assert _check(layered, on, values=swapped)["max_rel_err"] > 0.05


def test_the_bfloat16_control_fails_the_grouped_check(layered):
    res = _check(layered, dtype=torch.bfloat16)
    assert res["unlocated"] == 0 and res["max_rel_err"] > LIMIT


def test_a_target_whose_group_holds_no_element_is_unlocated(layered):
    groups = layered.layer.copy()
    groups[:5] = 3  # no source element is in layer 3
    res = _check(layered, groups=groups)
    assert res["unlocated"] == 5
    assert res["checked"] == (INTERIOR + ON_INTERFACE - 5) * len(PARAMS)
    assert res["max_rel_err"] < LIMIT


def test_answers_take_groups_for_all_rows_or_none(layered):
    a = _answers(slice(0, 4), layered.points, layered.values, layered.layer)
    with pytest.raises(ValueError):
        a.add(2, layered.points[:4], layered.values[:4])
    b = _answers(slice(0, 4), layered.points, layered.values)
    with pytest.raises(ValueError):
        b.add(2, layered.points[:4], layered.values[:4], layered.layer[:4])
    with pytest.raises(ValueError):  # groups on one side only
        inputs.compare(dataclasses.replace(layered.source,
                                           element_group=None),
                       a, lambda job: layered.source.values, "cpu")


@pytest.mark.parametrize("shape", [(4, 4, 4, 2), (3, 5, 16, 4),
                                   (2, 3, 6, 4), (3, 3, 5, 1)])
def test_shell_layer_ids_are_shell_meshs_layer_field(shape):
    from multimesh_tpu_torch import testing

    n_lat, n_lon, n_rad, n_layers = shape
    mesh = testing.shell_mesh(n_lat, n_lon, n_rad, order=1,
                              n_layers=n_layers)
    ids = meshes.shell_layer_ids(n_lat, n_lon, n_rad, n_layers)
    assert ids.dtype == torch.int64
    np.testing.assert_array_equal(ids.numpy(), mesh.layer_id)
    nodal, elemental = testing.salvus_fixture_fields(mesh)
    np.testing.assert_array_equal(ids.numpy(), elemental["layer"])


def test_locate_at_its_default_tolerance_is_as_before():
    lattice = meshes.shell_lattice(3, 3, 4, 4)
    gen = torch.Generator().manual_seed(2**31 + 7)
    law = {"r": [3.3e6, 6.5e6], "theta": [0.45, 1.25], "phi": [0.25, 1.45]}
    q = torch.cat([meshes.shell_targets(400, law, gen, "cpu"),
                   lattice[::5, ::7].reshape(-1, 3)])  # nodes: on faces
    want = _locate_before(lattice, q, 4, block=256)
    assert not want[2].all()  # some targets lie outside the shell
    for got in (reference.locate(lattice, q, 4, block=256),
                reference.locate(lattice, q, 4, block=256,
                                 inside_tol=reference.INSIDE_TOL,
                                 miss=True)[:3]):
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_the_layered_rehearsal_at_a_tiny_size():
    from benchmark import layered_rehearsal

    out = layered_rehearsal.rehearse(2**31 + 91, 128, True, "cpu")
    assert out["on_interface"] == 32 and out["checked_slots"] == 128
    assert out["grouped"]["unlocated"] == 0
    assert out["grouped"]["max_rel_err"] < 2e-6
    assert out["blind_interface"]["max_rel_err"] > LIMIT
    assert out["blind_elsewhere"]["max_rel_err"] < 2e-6
    assert out["control_bf16"]["max_rel_err"] > LIMIT
    sphere = out["sphere_slots"]
    assert sphere["found_at_1e-3"] == sphere["sampled"] == 900
    assert sphere["past_inside_tol"] > 0 and sphere["past_group_face_tol"] == 0
