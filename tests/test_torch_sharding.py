"""Both sharded schemes of the port (``multimesh_tpu_torch.dist``) on
gloo ranks of the CPU against the JAX package's ``dist`` on its 8-device
virtual mesh, its ``TransferOperator`` and its ``locate``.

The ranks come from a few spawns of ``launch.run_ranks``: every rank of
a spawn runs every case and returns its arrays, and the parent, which
alone imports JAX (inside the fixtures), compares.  So this module
imports no JAX at its top: each spawned rank imports it to find its
worker functions.  Inputs are numpy from fixed seeds, made alike in the
ranks and in the parent by ``_cases``.

Tolerances, each for its reason: values of two packages agree to rtol
1e-5 (atol 1e-9 of the largest value where sentinel zeros occur, the bar
of ``test_sharding.py``): f32 refs move an interpolated value by ~1e-7
relative, and a point on a shared face may be located in either element,
both interpolating the same continuous field.  At W = 1 the port's
schemes equal its single-device operator bit for bit: same program.
"""
import contextlib
import io
import multiprocessing
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import torch.distributed as dist  # noqa: E402

from multimesh_tpu_torch import TransferOperator as TOp  # noqa: E402
from multimesh_tpu_torch import testing  # noqa: E402
from multimesh_tpu_torch.config import LocateConfig as TCfg  # noqa: E402
from multimesh_tpu_torch.dist import (launch, make_mesh,  # noqa: E402
                                      partition_source, sharded_transfer,
                                      sharding, source_sharded_transfer)

# the rank spawns' limit: a hung collective fails the test, never the suite
RANK_TIMEOUT_S = 240
CFG_2D = dict(nelem_to_search=8, newton_iters=10, polish_iters=2)


def _shell_points(rng, n, scale_exterior=0):
    """``n`` points inside the shell_mesh chunk, the first
    ``scale_exterior`` moved outward by x1.5 (most of them outside)."""
    r = rng.uniform(3.6e6, 6.2e6, n)
    th = rng.uniform(0.55, 1.15, n)
    ph = rng.uniform(0.35, 1.35, n)
    pts = np.stack([r * np.sin(th) * np.cos(ph),
                    r * np.sin(th) * np.sin(ph), r * np.cos(th)], -1)
    pts[:scale_exterior] *= 1.5
    return pts


def _cases():
    """The fixtures of ``test_sharding.py`` (meshes, fields, points),
    from fixed seeds: made alike in every rank and in the parent."""
    rng = np.random.default_rng(1234)
    shell = testing.shell_mesh(n_lat=4, n_lon=5, n_rad=3, order=2)
    box = testing.box_mesh(shape=(6, 6, 6), order=2, warp=0.08)
    box_f = testing.element_nodal_field(box, "smooth")
    near = testing.box_mesh(shape=(6, 6, 6), order=2, warp=0.05)
    near_pts = rng.uniform(0.05, 0.95, size=(300, 3))
    near_pts[:40] = rng.uniform(1.0, 1.02, size=(40, 3))  # just outside
    square = testing.box_mesh(shape=(6, 6), order=2, warp=0.05)
    return {
        "shell": (shell.points,
                  testing.element_nodal_field(shell, "smooth")[None],
                  _shell_points(rng, 1500, scale_exterior=150)),
        "box": (box.points, np.stack([box_f, 3.0 * box_f]),
                rng.uniform(0.02, 0.98, size=(700, 3))),
        "near": (near.points,
                 testing.element_nodal_field(near, "smooth")[None], near_pts),
        "square": (square.points,
                   testing.element_nodal_field(square, "smooth")[None],
                   rng.uniform(0.03, 0.97, (300, 2))),
        # 40% outside: more local misses than a 64-row window holds
        "crowded": (shell.points,
                    testing.element_nodal_field(shell, "smooth")[None],
                    _shell_points(rng, 1500, scale_exterior=600)),
    }


def _rank_cases(rank):
    """Every case on this rank of a gloo group (run by ``run_ranks``)."""
    torch.set_num_threads(1)
    c = _cases()
    mesh = make_mesh(device="cpu")
    kw = dict(mesh=mesh, device="cpu")
    out = {"world": mesh.size(), "rank": mesh.get_local_rank()}
    nodes, fields, pts = c["shell"]
    for fb in ("sentinel", "snap", "fixed_ref"):
        out[f"shell_{fb}"] = sharded_transfer(
            pts, nodes, fields, order=2, cfg=TCfg(), fallback=fb,
            use_aabb=fb == "fixed_ref", chunk=512, **kw)
    shell_kw = dict(order=2, cfg=TCfg(), fallback="sentinel", chunk=256, **kw)
    out["shell_host"] = sharded_transfer(pts, nodes, fields, **shell_kw)
    dev = sharded_transfer(torch.as_tensor(pts), nodes, fields,
                           device_out=True, **shell_kw)
    out["shell_device_out_is_tensor"] = isinstance(dev, torch.Tensor)
    out["shell_device_out"] = dev.numpy()

    nodes, fields, pts = c["box"]
    out["box_sentinel"] = source_sharded_transfer(
        pts, nodes, fields, order=2, cfg=TCfg(nelem_to_search=8), **kw)
    out["box_stats"] = [sharding.LAST_RUN[k]
                        for k in ("rows", "window", "misses", "overflow")]
    nodes, fields, pts = c["near"]
    for fb in ("snap", "best"):
        out[f"near_{fb}"] = source_sharded_transfer(
            pts, nodes, fields, order=2, cfg=TCfg(nelem_to_search=8),
            fallback=fb, **kw)
    nodes, fields, pts = c["square"]
    out["square_sharded"] = sharded_transfer(
        pts, nodes, fields, order=2, cfg=TCfg(**CFG_2D), fallback="snap",
        **kw)
    out["square_source"] = source_sharded_transfer(
        pts, nodes, fields, order=2, cfg=TCfg(**CFG_2D), fallback="snap",
        **kw)

    nodes, fields, pts = c["crowded"]
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        source_sharded_transfer(pts, nodes, fields, order=2,
                                retry_frac=100_000, **kw)
    out["crowded_printed"] = text.getvalue()
    out["crowded_stats"] = [sharding.LAST_RUN[k]
                            for k in ("window", "misses", "overflow")]
    try:
        make_mesh(mesh.size() + 1, device="cpu")
        out["too_big"] = ""
    except ValueError as e:
        out["too_big"] = str(e)
    # a mesh over the first two ranks; the others get None
    sub = make_mesh(2, device="cpu")
    out["sub_size"] = -1 if sub is None else sub.size()
    if sub is not None:
        nodes, fields, pts = c["square"]
        out["sub_square"] = sharded_transfer(
            pts, nodes, fields, order=2, cfg=TCfg(**CFG_2D),
            fallback="snap", mesh=sub, device="cpu")
    return out


def _fresh_process(path):
    """World size 1 in a plain process: ``make_mesh(1)`` starts its own
    group; both schemes against the single-device operator."""
    torch.set_num_threads(1)
    out = {"had_group": dist.is_initialized()}
    mesh = make_mesh(1, device="cpu")
    out["backend"] = dist.get_backend(mesh.get_group())
    out["size"] = mesh.size()
    out["names"] = list(mesh.mesh_dim_names)
    try:
        make_mesh(2, device="cpu")
        out["too_big"] = ""
    except ValueError as e:
        out["too_big"] = str(e)
    nodes, fields, pts = _cases()["shell"]
    for fb in ("sentinel", "snap"):
        op = TOp.build(nodes, pts, order=2, fallback=fb, device="cpu")
        out[f"op_{fb}"] = op.apply(torch.as_tensor(fields)).numpy()
        out[f"sharded_{fb}"] = sharded_transfer(
            pts, nodes, fields, order=2, fallback=fb, mesh=mesh,
            device="cpu")
        out[f"source_{fb}"] = source_sharded_transfer(
            pts, nodes, fields, order=2, fallback=fb, mesh=mesh,
            device="cpu")
    np.savez(path, **out)


def _raise_on_rank_1(rank):
    if rank == 1:
        raise ValueError("rank 1 gives up")
    dist.barrier()  # rank 0 waits for a rank that never comes


def _hang(rank):
    time.sleep(3600)


@pytest.fixture(scope="module")
def cases():
    return _cases()


def _run_fresh_process(path):
    proc = multiprocessing.get_context("spawn").Process(
        target=_fresh_process, args=(path,))
    proc.start()
    proc.join(RANK_TIMEOUT_S)
    if proc.is_alive():
        proc.kill()
        proc.join()
        raise TimeoutError("the fresh process did not finish")
    assert proc.exitcode == 0, f"the fresh process exited {proc.exitcode}"
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module", autouse=True)
def spawns(tmp_path_factory):
    """The module's spawns, started together when it starts (the parent
    computes the JAX references meanwhile): ``_rank_cases`` on 2 and on
    4 gloo ranks, and ``_fresh_process``."""
    path = str(tmp_path_factory.mktemp("fresh") / "out.npz")
    with ThreadPoolExecutor(3) as pool:
        yield {"W2": pool.submit(launch.run_ranks, _rank_cases, 2,
                                 backend="gloo", timeout_s=RANK_TIMEOUT_S),
               "W4": pool.submit(launch.run_ranks, _rank_cases, 4,
                                 backend="gloo", timeout_s=RANK_TIMEOUT_S),
               "fresh": pool.submit(_run_fresh_process, path)}


@pytest.fixture(scope="module", params=["W2", "W4"])
def ranks(request, spawns):
    """Every rank's results of ``_rank_cases`` on W gloo ranks."""
    return spawns[request.param].result()


@pytest.fixture(scope="module")
def jax_refs(cases):
    """The JAX package's results on the same inputs (8 virtual devices)."""
    from multimesh_tpu.config import LocateConfig as JCfg
    from multimesh_tpu.dist import make_mesh as jmake_mesh
    from multimesh_tpu.dist import sharded_transfer as jsharded
    from multimesh_tpu.ops import TransferOperator as JOp
    from multimesh_tpu.search import locate as jlocate

    out = {}
    nodes, fields, pts = cases["shell"]
    for fb in ("sentinel", "snap"):
        out[f"shell_{fb}"] = np.asarray(jsharded(
            pts, nodes, fields, order=2, cfg=JCfg(), fallback=fb,
            mesh=jmake_mesh(), chunk=512))
    res = jlocate(pts, nodes, order=2, cfg=JCfg(), fallback="fixed_ref",
                  use_aabb=True, engine="xla", strategy="scan")
    el, f = np.asarray(res.elements), np.asarray(res.found)
    val = np.einsum("fnk,nk->nf", fields[:, np.maximum(el, 0), :],
                    np.asarray(res.weights))
    out["shell_fixed_ref"] = (val, f & (el >= 0))
    nodes, fields, pts = cases["box"]
    out["box_sentinel"] = np.asarray(JOp.build(
        nodes, pts, order=2, cfg=JCfg(nelem_to_search=8),
        fallback="sentinel").apply(fields))
    nodes, fields, pts = cases["near"]
    for fb in ("snap", "best"):
        out[f"near_{fb}"] = np.asarray(JOp.build(
            nodes, pts, order=2, cfg=JCfg(nelem_to_search=8),
            fallback=fb).apply(fields))
    nodes, fields, pts = cases["square"]
    res = jlocate(pts, nodes, order=2, fallback="snap", cfg=JCfg(**CFG_2D))
    out["square"] = np.einsum("pn,pn->p", np.asarray(res.weights),
                              fields[0][np.asarray(res.elements)])[:, None]
    return out


def _close(got, want):
    """rtol 1e-5, atol 1e-9 of the largest value (module docstring)."""
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-9 * np.abs(want).max())


def test_partition_source_is_the_jax_partition(cases):
    """Shard ids and bin_shard bit-equal to the JAX package's (the same
    host binning over the same centroid means), with its balance checks:
    every element in one shard, sizes within one 32-member bin plus
    slack."""
    from multimesh_tpu.dist import partition_source as jpartition

    mesh = testing.box_mesh(shape=(8, 8, 8), order=1)
    ids, reps, center, bin_shard = partition_source(mesh.points, 8)
    j_ids, j_reps, j_center, j_bin_shard = jpartition(mesh.points, 8)
    assert len(ids) == len(j_ids) == 8
    for a, b in zip(ids, j_ids):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(bin_shard, np.asarray(j_bin_shard))
    np.testing.assert_array_equal(reps, np.asarray(j_reps))
    np.testing.assert_array_equal(center, np.asarray(j_center))
    sizes = np.array([len(i) for i in ids])
    assert sizes.sum() == mesh.nelem
    assert np.unique(np.concatenate(ids)).size == mesh.nelem
    assert sizes.max() <= sizes.min() + 40


def test_routing_matches_jax(cases):
    """Owners of 4,096 points against the JAX ``_route_points_jit``:
    >= 99.9% equal.  Both rank the bin representatives in f32, the port
    centred on their mean and the JAX package on the centroids' mean,
    so a point nearly equidistant from two bins may go either way."""
    import jax.numpy as jnp
    from multimesh_tpu.dist.sharding import _route_points_jit

    nodes = cases["box"][0]
    pts = np.random.default_rng(7).uniform(0.0, 1.0, (4096, 3))
    _, reps, center, bin_shard = partition_source(nodes, 4)
    got = sharding.route_points(torch.as_tensor(pts), reps, center,
                                bin_shard).numpy()
    want = np.asarray(_route_points_jit(jnp.asarray(pts), jnp.asarray(reps),
                                        jnp.asarray(center),
                                        jnp.asarray(bin_shard)))
    assert (got == want).mean() >= 0.999
    assert set(np.unique(got)) == {0, 1, 2, 3}
    plain = sharding.route_points(torch.as_tensor(pts), reps, center,
                                  bin_shard, plain=True).numpy()
    np.testing.assert_array_equal(got, plain)  # the CPU runs the twin


@pytest.fixture(scope="module")
def port_ops(cases):
    """The port's single-device operator on the shell case."""
    nodes, fields, pts = cases["shell"]
    return {fb: TOp.build(nodes, pts, order=2, cfg=TCfg(), fallback=fb,
                          device="cpu").apply(torch.as_tensor(fields))
            .double().numpy() for fb in ("sentinel", "snap")}


@pytest.mark.parametrize("fallback", ["sentinel", "snap"])
def test_sharded_matches_jax(ranks, jax_refs, port_ops, fallback):
    """The replicated scheme against the JAX one on 8 virtual devices:
    the same rows found (non-zero), values to rtol 1e-5.  Under snap a
    point 25-45% of the shell's radius outside it takes the candidate of
    least max |ref| (~5) among those whose f32 Newton converged, and
    some candidates' residuals sit at the 1e-4 threshold, so the two
    packages' single-device operators already snap ~3% of the rows to
    different elements: those rows are held to the port's own operator
    instead (the sharded program is that program, in other chunks)."""
    want = jax_refs[f"shell_{fallback}"]
    got = ranks[0][f"shell_{fallback}"]
    own = port_ops[fallback]
    assert got.shape == want.shape == (1500, 1) and got.dtype == np.float64
    np.testing.assert_array_equal(got != 0, want != 0)
    same = np.isclose(own, want, rtol=1e-5, atol=0).all(axis=1)
    assert same.mean() > (0.999 if fallback == "sentinel" else 0.95)
    _close(got[same], want[same])
    _close(got, own)
    if fallback == "sentinel":
        assert 0.85 < (got != 0).mean() < 1.0  # exterior rows stay zero


def test_sharded_fixed_ref_with_aabb_matches_jax_scan(ranks, jax_refs):
    """``fixed_ref`` + ``use_aabb`` (every unaccepted row through the
    scan retry) against the JAX scan locate: every row assigned."""
    want, ok = jax_refs["shell_fixed_ref"]
    got = ranks[0]["shell_fixed_ref"]
    assert ok.all() and (got != 0).all()
    _close(got, want)


def test_every_rank_returns_the_same_result(ranks):
    """Each rank returns the full result in input order, and the ranks
    agree bit for bit."""
    assert [int(r["rank"]) for r in ranks] == list(range(len(ranks)))
    assert all(int(r["world"]) == len(ranks) for r in ranks)
    for key, val in ranks[0].items():
        if key.startswith(("shell_", "box_sentinel", "near_", "square_")):
            for other in ranks[1:]:
                np.testing.assert_array_equal(other[key], val, err_msg=key)


def test_device_out_with_tensor_input_equals_host_path(ranks):
    """``device_out=True`` on a tensor of points returns a tensor (on the
    CPU here) whose values are the host path's f64 ones, rounded from the
    same f32."""
    r = ranks[0]
    assert bool(r["shell_device_out_is_tensor"])
    assert r["shell_device_out"].dtype == np.float32
    np.testing.assert_array_equal(r["shell_device_out"].astype(np.float64),
                                  r["shell_host"])


def test_source_sharded_matches_jax_operator(ranks, jax_refs):
    """Sources split over the ranks, sentinel: >= 99% found, the found
    rows to rtol 1e-5 of the JAX single-device operator (points crossing
    a shard boundary are resolved by the all-gathered retry)."""
    want = jax_refs["box_sentinel"]
    got = ranks[0]["box_sentinel"]
    found = want[:, 0] != 0
    assert found.mean() > 0.99
    np.testing.assert_array_equal(got[:, 0] != 0, found)
    np.testing.assert_allclose(got[found], want[found], rtol=1e-5)
    rows, window, misses, overflow = ranks[0]["box_stats"]
    assert window >= 64 and overflow == 0
    assert sum(int(r["box_stats"][0]) for r in ranks) == 700


@pytest.mark.parametrize("fallback", ["snap", "best"])
def test_source_sharded_fallback_modes_match_jax(ranks, jax_refs, cases,
                                                 fallback):
    """The cross-rank snap / best combine: every point assigned, interior
    rows to rtol 1e-4 of the JAX operator; the 40 points just outside may
    snap to another boundary element across the shard split, so they are
    held to the smooth field at the clipped point (atol 0.05), as in
    ``test_sharding.py``."""
    got = ranks[0][f"near_{fallback}"]
    want = jax_refs[f"near_{fallback}"]
    pts = cases["near"][2]
    assert (got[:, 0] != 0).all()
    np.testing.assert_allclose(got[40:], want[40:], rtol=1e-4)
    np.testing.assert_allclose(
        got[:40, 0], testing.smooth_field(np.clip(pts[:40], 0, 1)),
        atol=0.05)


@pytest.mark.parametrize("scheme", ["sharded", "source"])
def test_2d_both_schemes_match_jax_locate(ranks, jax_refs, scheme):
    """2-D quads through both schemes against the JAX single-device
    locate under snap: rtol 1e-5 (two packages' f32 refs)."""
    got = ranks[0][f"square_{scheme}"]
    assert got.shape == (300, 1)
    _close(got, jax_refs["square"])


def test_window_overflow_is_printed(ranks):
    """``retry_frac`` so large that the pass-2 window is 64 rows: local
    misses beyond it are counted over all ranks and printed once."""
    window, _, overflow = (int(v) for v in ranks[0]["crowded_stats"])
    misses = [int(r["crowded_stats"][1]) for r in ranks]
    assert window == 64
    assert overflow == sum(max(m - window, 0) for m in misses) > 0
    printed = str(ranks[0]["crowded_printed"])
    assert f"{overflow} points missed locally" in printed
    assert "could not find an enclosing element" in printed
    assert all(str(r["crowded_printed"]) == "" for r in ranks[1:])


def test_make_mesh_larger_than_the_world_raises(ranks):
    for r in ranks:
        msg = str(r["too_big"])
        assert f"requested a {len(ranks) + 1}-device mesh" in msg
        assert f"only {len(ranks)} ranks" in msg


def test_make_mesh_over_the_first_ranks(ranks):
    """``make_mesh(2)`` spans ranks 0 and 1, as the JAX one takes the
    first devices; a transfer on it equals the one over all ranks."""
    assert [int(r["sub_size"]) for r in ranks] == [2, 2] + [-1] * (
        len(ranks) - 2)
    for r in ranks[:2]:
        _close(r["sub_square"], ranks[0]["square_sharded"])


@pytest.fixture(scope="module")
def fresh(spawns):
    return spawns["fresh"].result()


def test_make_mesh_1_in_a_fresh_process(fresh):
    """``make_mesh(1)`` starts a one-rank gloo group for the CPU itself;
    ``make_mesh(2)`` there raises."""
    assert not bool(fresh["had_group"])
    assert str(fresh["backend"]) == "gloo"
    assert int(fresh["size"]) == 1
    assert list(fresh["names"]) == ["points"]
    assert "requested a 2-device mesh but only 1 rank" in str(
        fresh["too_big"])


@pytest.mark.parametrize("fallback", ["sentinel", "snap"])
@pytest.mark.parametrize("scheme", ["sharded", "source"])
def test_world_size_1_equals_the_operator_bit_for_bit(fresh, scheme,
                                                      fallback):
    """At W = 1 both schemes run the single-device program: the rank
    holds every element in global order and every row."""
    want = fresh[f"op_{fallback}"].astype(np.float64)
    np.testing.assert_array_equal(fresh[f"{scheme}_{fallback}"], want)


def test_a_failing_rank_fails_run_ranks_fast():
    """Rank 1 raises while rank 0 waits in a barrier for it: run_ranks
    kills rank 0 and raises with rank 1's traceback long before its
    timeout."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 gives up"):
        launch.run_ranks(_raise_on_rank_1, 2, backend="gloo",
                         timeout_s=RANK_TIMEOUT_S)
    assert time.monotonic() - t0 < RANK_TIMEOUT_S / 4


def test_a_hung_group_times_out():
    """Ranks that never finish are killed at ``timeout_s``."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        launch.run_ranks(_hang, 2, backend="gloo", timeout_s=5)
    assert time.monotonic() - t0 < 60
