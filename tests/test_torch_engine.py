"""The flagship file path of the port, ``multimesh_tpu_torch.api.gll_2_gll``
(file -> dedup -> locate -> apply -> expand + repair -> file), on the CPU
against the JAX package's ``api.gll_2_gll`` on the same pair of files,
its pieces (``apply(out_chunks=True)``, ``_stream_expand_write``, the
stage timers) on their own, and the ``stored_array`` cache passing
between the two packages in both directions.

The JAX package on the CPU runs its XLA engine in f64; the port's CPU
path runs the f32 plain twins of its kernels, so values agree to 1e-6
relative, and to 1e-9 once the port polishes its refs
(``MMT_DF32_POLISH=1``).
"""
import dataclasses
import inspect
import json
import shutil

import h5py
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from multimesh_tpu import api as japi  # noqa: E402
from multimesh_tpu_torch import TransferOperator as TOp  # noqa: E402
from multimesh_tpu_torch import api as tapi  # noqa: E402
from multimesh_tpu_torch import engine as tengine  # noqa: E402
from multimesh_tpu_torch import progress as tprogress  # noqa: E402
from multimesh_tpu_torch import testing as tmt  # noqa: E402
from multimesh_tpu_torch import utils_profile as tprofile  # noqa: E402
from multimesh_tpu_torch.config import PREFILTER_M  # noqa: E402
from multimesh_tpu_torch.io import salvus as tsio  # noqa: E402
from multimesh_tpu_torch.ops import dedup as tdedup  # noqa: E402
from multimesh_tpu_torch.ops.fluid import repair_fluid_solid  # noqa: E402

from oracle import interpolate_np  # noqa: E402

PARAMS = ("VP", "VS", "RHO")
LABELS = ["VP", "VS", "RHO", "z_node_1D"]
N_FLUID = 3  # leading target elements marked fluid


def _meshes():
    """Source (finer) and target (coarser, strictly interior) order-4
    shells, the sizes of the JAX package's engine tests."""
    src = tmt.shell_mesh(n_lat=5, n_lon=5, n_rad=3, order=4,
                         lat_extent=(0.5, 1.2), lon_extent=(0.3, 1.4))
    tgt = tmt.shell_mesh(n_lat=3, n_lon=3, n_rad=2, order=4,
                         r_inner=3.6e6, r_outer=6.3e6,
                         lat_extent=(0.55, 1.15), lon_extent=(0.35, 1.35))
    return src, tgt


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The pair as Salvus files: the source with the smooth field, a
    pristine target with the linear one (a target left unwritten cannot
    pass) whose first elements are fluid."""
    d = tmp_path_factory.mktemp("pair")
    src, tgt = _meshes()
    fluid = np.zeros(tgt.nelem)
    fluid[:N_FLUID] = 1.0
    src_fields = tmt.write_salvus_fixture(d / "src.h5", src, PARAMS)
    tmt.write_salvus_fixture(d / "tgt0.h5", tgt, PARAMS, fluid=fluid,
                             field_kind="linear")
    return src, tgt, d / "src.h5", d / "tgt0.h5", src_fields


def _fresh(pair, tmp_path, name="tgt.h5"):
    """A copy of the pristine target to transfer onto."""
    return shutil.copyfile(pair[3], tmp_path / name)


def _read(path):
    with h5py.File(path, "r") as f:
        return f["MODEL/data"][()], tsio.read_dim_labels(f["MODEL/data"])


def _rel(a, b):
    return float(np.max(np.abs(a - b) / np.abs(b)))


@pytest.fixture(scope="module")
def jax_result(pair, tmp_path_factory):
    """The JAX package's transfer of the pair (f64 XLA engine)."""
    d = tmp_path_factory.mktemp("jax")
    tgt = shutil.copyfile(pair[3], d / "tgt.h5")
    values = japi.gll_2_gll(pair[2], tgt)
    data, labels = _read(tgt)
    np.testing.assert_array_equal(values, data)
    return data, labels


@pytest.fixture(scope="module")
def torch_result(pair, tmp_path_factory):
    d = tmp_path_factory.mktemp("torch")
    tgt = shutil.copyfile(pair[3], d / "tgt.h5")
    values = tapi.gll_2_gll(pair[2], tgt, device="cpu")
    return values, tgt


def test_file_path_matches_jax(pair, jax_result, torch_result):
    """Every parameter of MODEL/data within 1e-6 relative of the JAX
    package's, equal labels, f64 [E, P, n], the returned values equal to
    the written ones, fluid elements bit-equal to the pristine file."""
    want, want_labels = jax_result
    values, tgt = torch_result
    got, labels = _read(tgt)
    assert labels == want_labels == LABELS
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_array_equal(values, got)
    for i, name in enumerate(labels):
        assert _rel(got[:, i], want[:, i]) < 1e-6, name
    pristine, _ = _read(pair[3])
    np.testing.assert_array_equal(got[:N_FLUID], pristine[:N_FLUID])
    np.testing.assert_array_equal(want[:N_FLUID], pristine[:N_FLUID])
    assert not np.array_equal(got[N_FLUID:], pristine[N_FLUID:])


def test_file_path_with_df32_polish_matches_jax_f64(pair, jax_result,
                                                    tmp_path, monkeypatch):
    """With MMT_DF32_POLISH=1 on the port's side only (K4's and K5's
    twins), within 1e-9 of the JAX f64 result."""
    monkeypatch.setenv("MMT_DF32_POLISH", "1")
    tgt = _fresh(pair, tmp_path)
    tapi.gll_2_gll(pair[2], tgt, device="cpu")
    got, labels = _read(tgt)
    assert labels == LABELS
    assert _rel(got, jax_result[0]) < 1e-9


def test_end_to_end_oracle_stored_rerun_and_cache_is_read(pair, tmp_path):
    """The three steps of the JAX package's end-to-end test, on the port:
    accuracy against the independent oracle, a bit-identical rerun from
    ``stored_array``, and doubled dense coefficients flowing through to
    the output (the cache is read, not rebuilt)."""
    src, tgt, src_path, _, src_fields = pair
    cache = tmp_path / "stored"
    f_tgt = _fresh(pair, tmp_path)
    tapi.gll_2_gll(from_gll=str(src_path), to_gll=str(f_tgt),
                   stored_array=str(cache), device="cpu")
    out = tsio.SalvusMesh(f_tgt, fast_mode=False)
    assert out.nodal_parameter_indices == LABELS

    sample = N_FLUID * tgt.n_gll + np.random.default_rng(0).choice(
        (tgt.nelem - N_FLUID) * tgt.n_gll, size=400, replace=False)
    pts = tgt.points.reshape(-1, 3)[sample]
    oracle_vals, _ = interpolate_np(pts, src.points, src_fields["VS"],
                                    order=4)
    mine = out.element_nodal_fields["VS"].reshape(-1)[sample]
    assert _rel(mine, oracle_vals) < 1e-6

    for name in ("elements.npy", "refs.npy", "found.npy", "recon.npy",
                 "meta.npy"):
        assert (cache / name).exists(), name
    f_tgt = _fresh(pair, tmp_path)
    tapi.gll_2_gll(from_gll=str(src_path), to_gll=str(f_tgt),
                   stored_array=str(cache), device="cpu")
    out2 = tsio.SalvusMesh(f_tgt, fast_mode=False)
    np.testing.assert_array_equal(
        out2.element_nodal_fields["VS"], out.element_nodal_fields["VS"])

    cached_op = TOp.load(cache, device="cpu")
    np.save(cache / "coeffs.npy", 2.0 * cached_op.weights.numpy())
    (cache / "refs.npy").unlink()
    (cache / "found.npy").unlink()
    f_tgt = _fresh(pair, tmp_path)
    tapi.gll_2_gll(from_gll=str(src_path), to_gll=str(f_tgt),
                   stored_array=str(cache), device="cpu")
    out3 = tsio.SalvusMesh(f_tgt, fast_mode=False)
    np.testing.assert_allclose(
        out3.element_nodal_fields["VS"].reshape(-1)[sample], 2.0 * mine,
        rtol=1e-6)


@pytest.mark.parametrize("saver", ["jax", "torch"])
def test_stored_array_passes_between_the_packages(saver, pair, jax_result,
                                                  tmp_path, capsys):
    """A ``stored_array`` directory saved by one package's ``gll_2_gll``
    is loaded by the other's for the same files (nothing is ignored, and
    no locate runs: the elements are the saver's) and gives values within
    1e-6; for a changed target it is refused by fingerprint and rebuilt."""
    def run(pkg, tgt, cache):
        if pkg == "jax":
            return japi.gll_2_gll(pair[2], tgt, stored_array=cache)
        return tapi.gll_2_gll(pair[2], tgt, stored_array=cache,
                              device="cpu")

    loader = "torch" if saver == "jax" else "jax"
    cache = tmp_path / "stored"
    run(saver, _fresh(pair, tmp_path), cache)
    saved = {n: np.load(cache / n) for n in ("elements.npy", "recon.npy")}
    capsys.readouterr()
    got = run(loader, _fresh(pair, tmp_path), cache)
    assert "Ignoring stored operator" not in capsys.readouterr().out
    assert _rel(got, jax_result[0]) < 1e-6
    # the loader did not save again: a hit leaves the directory alone
    for name, arr in saved.items():
        np.testing.assert_array_equal(np.load(cache / name), arr)

    # another target (its coordinates shrunk a little): refused, rebuilt
    other = _fresh(pair, tmp_path, "other.h5")
    with h5py.File(other, "r+") as f:
        f["MODEL/coordinates"][...] = f["MODEL/coordinates"][()] * 0.999
    got = run(loader, other, cache)
    assert "Ignoring stored operator" in capsys.readouterr().out
    truth = tmt.smooth_field(tmt.shell_mesh(
        n_lat=3, n_lon=3, n_rad=2, order=4, r_inner=3.6e6, r_outer=6.3e6,
        lat_extent=(0.55, 1.15), lon_extent=(0.35, 1.35)).points * 0.999)
    assert _rel(got[N_FLUID:, 0], truth[N_FLUID:]) < 1e-5


def test_matching_cache_without_recon_is_rebuilt(pair, torch_result,
                                                 tmp_path, capsys):
    """A stored operator whose fingerprint matches but which has no
    recon.npy -- here with its rows in another (the sorted) order -- is
    rebuilt with a notice, not expanded with a recon computed afresh; the
    JAX package would expand it and scramble the values."""
    cache = tmp_path / "stored"
    tapi.gll_2_gll(pair[2], _fresh(pair, tmp_path), stored_array=cache,
                   device="cpu")
    tgt_points = pair[1].points
    _, recon_first = tdedup.unique_points(tgt_points, order_by="first")
    _, recon_sorted = tdedup.unique_points(tgt_points, order_by="sorted")
    to_first = np.empty(recon_first.max() + 1, np.int64)
    to_first[recon_sorted] = recon_first  # sorted id -> first id
    for name in ("elements.npy", "refs.npy", "found.npy"):
        np.save(cache / name, np.load(cache / name)[to_first])
    (cache / "recon.npy").unlink()
    capsys.readouterr()
    f_tgt = _fresh(pair, tmp_path)
    tapi.gll_2_gll(pair[2], f_tgt, stored_array=cache, device="cpu")
    out = capsys.readouterr().out
    assert "no recon.npy" in out and "rebuilding" in out
    np.testing.assert_array_equal(_read(f_tgt)[0], torch_result[0])
    assert (cache / "recon.npy").exists()  # the rebuilt operator is saved


def test_nan_audit_raises_before_anything_is_written(pair, tmp_path):
    """A NaN in the source fields reaches the unique values: the call
    raises and the target file is still the pristine one."""
    src_bad = shutil.copyfile(pair[2], tmp_path / "src_bad.h5")
    with h5py.File(src_bad, "r+") as f:
        f["MODEL/data"][:, 1, :] = np.nan
    f_tgt = _fresh(pair, tmp_path)
    with pytest.raises(FloatingPointError, match="NaNs"):
        tapi.gll_2_gll(src_bad, f_tgt, device="cpu")
    want, labels = _read(pair[3])
    got, got_labels = _read(f_tgt)
    assert got_labels == labels
    np.testing.assert_array_equal(got, want)


def test_transfer_arrays_with_a_numpy_sink_equals_the_files(pair,
                                                            torch_result):
    """``transfer_arrays`` on the arrays the files hold, writing into a
    numpy array: the same values as file to file, bit for bit."""
    src, tgt = pair[0], pair[1]
    src_points, src_data, params = tsio.load_hdf5_params(pair[2])
    old_values, _ = _read(pair[3])
    solid = np.ones(tgt.nelem, bool)
    solid[:N_FLUID] = False
    sink = {}

    def open_sink(names):
        sink["labels"] = list(names)
        sink["data"] = np.full((tgt.nelem, len(names), tgt.n_gll), np.nan)
        return sink["data"]

    values = tengine.transfer_arrays(
        src_points, src_data, params, tgt.points, old_values, solid,
        open_sink, device="cpu")
    assert sink["labels"] == LABELS
    np.testing.assert_array_equal(sink["data"], torch_result[0])
    np.testing.assert_array_equal(values, torch_result[0])


# -- apply(out_chunks=True) ------------------------------------------------
@pytest.fixture(scope="module")
def small_ops(pair):
    """The three apply routes on the pair's unique target points: refs
    (f32), explicit weights, and pair refs (K5's twin)."""
    src, tgt = pair[0], pair[1]
    uniq, recon = tdedup.unique_points(tgt.points, order_by="first")
    kw = dict(order=4, fallback="fixed_ref", use_aabb=True,
              prefilter_m=PREFILTER_M, recon=recon, device="cpu")
    refs = TOp.build(src.points, uniq,
                     cfg=tengine._locate_cfg(20, accept_tol=1.04), **kw)
    weights = TOp(elements=refs.elements, order=4, recon=refs.recon,
                  _weights=refs.weights.double())
    pairs = TOp.build(
        src.points, uniq,
        cfg=dataclasses.replace(tengine._locate_cfg(20, accept_tol=1.04),
                                df32_polish=True), **kw)
    assert pairs.refs_lo is not None
    fields = np.stack([tmt.element_nodal_field(src) * (1 + 0.1 * i)
                       for i in range(3)])
    return {"refs": refs, "weights": weights, "pairs": pairs}, fields


@pytest.mark.parametrize("route", ["refs", "weights", "pairs"])
def test_apply_out_chunks_equals_unexpanded_apply(route, small_ops):
    """``out_chunks=True`` gives ``(chunks, chunk)``: un-expanded row
    ranges whose concatenation equals ``apply(expand=False)`` with the
    same chunk bit for bit, whatever ``expand`` says."""
    ops, fields = small_ops
    op = ops[route]
    chunk = 400
    want = op.apply(fields, expand=False, chunk=chunk)
    chunks, got_chunk = op.apply(fields, out_chunks=True, chunk=chunk)
    assert got_chunk == chunk
    assert len(chunks) == -(-op.n_points // chunk) > 2
    assert all(c.shape == (min(chunk, op.n_points - i * chunk), 3)
               for i, c in enumerate(chunks))
    assert torch.equal(torch.cat(chunks), want)
    assert want.shape[0] == op.n_points < op.recon.shape[0]
    assert want.dtype == (torch.float32 if route == "refs"
                          else torch.float64)
    one, _ = op.apply(fields, out_chunks=True)
    assert len(one) == 1


# -- _stream_expand_write --------------------------------------------------
def _expand_case(order_by):
    """A small target's recon (first-appearance, sorted, or the
    first-appearance one reversed), its unique f32 values in chunks of 40
    rows, old values, elements 0 and 7 fluid and a zero VS in solid
    element 4."""
    tgt = tmt.shell_mesh(n_lat=3, n_lon=2, n_rad=2, order=2)
    n_elem, n = tgt.nelem, tgt.n_gll
    if order_by == "reversed":
        uniq, recon = tdedup.unique_points(tgt.points, order_by="first")
        uniq, recon = uniq[::-1], len(uniq) - 1 - recon
    else:
        uniq, recon = tdedup.unique_points(tgt.points, order_by=order_by)
    rng = np.random.default_rng(3)
    vals = rng.uniform(1.0, 5.0, (len(uniq), 3)).astype(np.float32)
    old = rng.uniform(6.0, 9.0, (n_elem, 3, n))
    solid = np.ones(n_elem, bool)
    solid[[0, 7]] = False
    vals[recon[4 * n + 5], 1] = 0.0  # a zero VS in solid element 4
    chunks = [torch.from_numpy(vals[s:s + 40])
              for s in range(0, len(vals), 40)]
    assert len(chunks) > 3
    return n_elem, n, vals, recon, chunks, old, solid


@pytest.mark.parametrize("gradient", [False, True])
@pytest.mark.parametrize("order_by", ["first", "sorted", "reversed"])
def test_stream_expand_write_equals_direct_expansion(order_by, gradient):
    """Several small chunks through ``_stream_expand_write`` against the
    direct ``vals[recon]`` + relayout + f64 + repair, bit for bit: with a
    first-appearance recon, a sorted-order one and the first-appearance
    one reversed, every element is written once, in element order, in
    blocks of ``block_bytes``; fluid and zero-VS elements keep their old
    f64 values unless ``gradient``.  ``values`` owns its memory."""
    n_elem, n, vals, recon, chunks, old, solid = _expand_case(order_by)
    written = []

    class Sink:
        data = np.full((n_elem, 3, n), np.nan)

        def __setitem__(self, key, block):
            written.append((key.start, key.stop))
            self.data[key] = block

    sink = Sink()
    values = tengine._stream_expand_write(
        lambda names: sink, chunks, recon, list(PARAMS), n, old, solid,
        gradient, block_bytes=5 * 3 * n * 8)
    want = vals[recon].reshape(n_elem, n, 3).transpose(0, 2, 1).astype(
        np.float64)
    if not gradient:
        want = repair_fluid_solid(want, old, solid, list(PARAMS))
        np.testing.assert_array_equal(values[[0, 4, 7]], old[[0, 4, 7]])
    assert values.dtype == np.float64 and values.flags.owndata
    np.testing.assert_array_equal(values, want)
    np.testing.assert_array_equal(sink.data, want)
    # every element once, in order, in blocks of 5 elements
    assert written == [(s, min(s + 5, n_elem)) for s in range(0, n_elem, 5)]
    assert len(written) > 2


@pytest.mark.parametrize("gradient", [False, True])
def test_stream_expand_write_counts_slots_and_patched_elements(gradient,
                                                               monkeypatch):
    """Under ``MMT_PROFILE``: ``expand.card_slots`` counts every slot
    expanded where the unique values live, ``expand.patched_elems`` the
    elements set back to their old values: the 2 fluid ones and the solid
    ones that share the zero VS (element 4 and its neighbours on that
    node), none with ``gradient``; the write is timed as ``g2g.expand``
    and ``g2g.pull_wait``."""
    n_elem, n, vals, recon, chunks, old, solid = _expand_case("reversed")
    zero_vs = (vals[recon, 1] == 0).reshape(n_elem, n).any(axis=1)
    reverted = int((zero_vs & solid).sum())
    assert zero_vs[4] and reverted > 1
    monkeypatch.setenv("MMT_PROFILE", "1")
    tprofile.reset_stages()
    try:
        tengine._stream_expand_write(
            lambda names: np.empty((n_elem, 3, n)), chunks, recon,
            list(PARAMS), n, old, solid, gradient)
        counters = tprofile.counter_totals()
        stages = tprofile.stage_totals()
    finally:
        tprofile.reset_stages()
    assert counters == {"expand.card_slots": n_elem * n,
                        "expand.patched_elems": 0 if gradient
                        else 2 + reverted}
    assert {"g2g.expand", "g2g.pull_wait"} <= set(stages)


def test_transfer_arrays_through_a_reversed_stored_operator(tmp_path,
                                                           monkeypatch):
    """``transfer_arrays`` with a stored operator whose unique rows and
    recon are reversed (``testing.reverse_stored_operator``) writes and
    returns what the operator it was copied from gives, bit for bit: the
    expansion takes a loaded recon in any order."""
    src, tgt = _meshes()
    data = np.stack([tmt.element_nodal_field(src) * (1 + 0.1 * i)
                     for i in range(3)], axis=1)
    old = np.random.default_rng(1).uniform(6.0, 9.0, (tgt.nelem, 3,
                                                       tgt.n_gll))
    solid = np.arange(tgt.nelem) >= N_FLUID

    def run(stored):
        sink = np.full(old.shape, np.nan)
        values = tengine.transfer_arrays(
            src.points, data, list(PARAMS), tgt.points, old, solid,
            lambda names: sink, stored_array=stored, device="cpu")
        np.testing.assert_array_equal(values, sink)
        return values

    want = run(tmp_path / "a")
    tmt.reverse_stored_operator(tmp_path / "a", tmp_path / "b")
    recon = np.load(tmp_path / "b" / "recon.npy")
    assert recon[0] == recon.max() > 0
    monkeypatch.setenv("MMT_PROFILE", "1")
    tprofile.reset_stages()
    try:
        np.testing.assert_array_equal(run(tmp_path / "b"), want)
        stages = tprofile.stage_totals()
    finally:
        tprofile.reset_stages()
    assert "g2g.load_operator" in stages and "operator.build" not in stages
    np.testing.assert_array_equal(want[:N_FLUID], old[:N_FLUID])


# -- the smoke script's file case, both of its branches --------------------
def test_smoke_file_case_hdf5_branch_equals_the_array_branch(tmp_path,
                                                             monkeypatch):
    """``chip_smoke.FileCase`` on the small pair with ``device="cpu"``:
    the HDF5 branch (fixtures written, the target restored, the API
    called, the file read back) and the array branch (the same arrays
    through ``transfer_arrays`` with a numpy sink) return and write the
    same values bit for bit, with the same labels, twice in a row."""
    import chip_smoke

    # the script syncs the card after each call; there is none here
    monkeypatch.setattr(chip_smoke.torch.cuda, "synchronize", lambda: None)
    src, tgt = _meshes()
    out = []
    for have_h5py in (True, False):
        case = chip_smoke.FileCase(src, tgt, str(tmp_path), "cpu",
                                   have_h5py=have_h5py)
        values, written, labels, wall = case.run()
        assert labels == LABELS and wall > 0
        np.testing.assert_array_equal(values, written)
        np.testing.assert_array_equal(case.run()[1], written)
        out.append(written)
    np.testing.assert_array_equal(out[0], out[1])
    truth = np.stack(list(tmt.salvus_fixture_fields(
        tgt, chip_smoke.FILE_PARAMS)[0].values()), axis=1)
    assert _rel(out[0], truth) < 1e-6


# -- stage timers, trace, progress, the facade ----------------------------
G2G_STAGES = {"g2g.read_source", "g2g.read_target", "g2g.fingerprint",
              "g2g.dedup", "g2g.apply", "g2g.nan_audit", "g2g.stream_write",
              "g2g.expand", "g2g.pull_wait"}
# the build's own stages on the pair (75 source elements: the ladder,
# round 1 on the nearest centroid); no polish, no stored operator.  The
# target lies inside the source, so round 1 accepts every row and the
# rescue rounds (``locate.rounds23``, ``locate.round4``) are skipped
BUILD_STAGES = {"operator.build", "locate.prep", "locate.round1",
                "locate.retry"}


def test_stage_timer_is_a_noop_without_mmt_profile(pair, tmp_path,
                                                   monkeypatch, capsys):
    monkeypatch.delenv("MMT_PROFILE", raising=False)
    tprofile.reset_stages()
    assert tprofile.stage_timer("x") is tprofile._OFF
    with tprofile.stage_timer("x") as t:
        assert t is None
    tapi.gll_2_gll(pair[2], _fresh(pair, tmp_path), device="cpu")
    assert tprofile.stage_totals() == {}
    assert tprofile.counter_totals() == {}
    out = capsys.readouterr()
    assert "mmt" not in out.out and "mmt" not in out.err


def test_stage_timer_accumulates_the_g2g_stages(pair, tmp_path,
                                                monkeypatch, capsys):
    monkeypatch.setenv("MMT_PROFILE", "1")
    monkeypatch.setattr(tdedup, "_UNIQ_CACHE", {})
    monkeypatch.setattr(tdedup, "_UNIQ_DEV_CACHE", {})
    tprofile.reset_stages()
    tapi.gll_2_gll(pair[2], _fresh(pair, tmp_path), device="cpu")
    once = tprofile.stage_totals()
    assert set(once) == G2G_STAGES | BUILD_STAGES
    assert all(v > 0 for v in once.values())
    assert "mmt" not in capsys.readouterr().out  # nothing while recording
    tapi.gll_2_gll(pair[2], _fresh(pair, tmp_path), device="cpu")
    twice = tprofile.stage_totals()
    assert all(twice[k] > once[k] for k in once)
    tprofile.report()
    out = capsys.readouterr()
    assert "mmt" not in out.out
    reported = {ln.split()[0] for ln in out.err.splitlines()[1:]
                if not ln.startswith("mmt counter")}
    assert reported == set(twice)
    assert "mmt counter k1.rows" in out.err
    tprofile.reset_stages()
    assert tprofile.stage_totals() == {}
    assert tprofile.counter_totals() == {}


def test_trace_yields_the_profiler_and_writes_a_chrome_trace(tmp_path):
    with tprofile.trace(str(tmp_path / "tr")) as prof:
        torch.ones(8).sum()
    assert any("sum" in e.key for e in prof.key_averages())
    with open(tmp_path / "tr" / "trace.json") as f:
        assert json.load(f)["traceEvents"]


def test_progress_reports_the_write_back(monkeypatch, capsys):
    monkeypatch.setenv("MMT_PROGRESS", "0")
    assert tprogress.progress(100, "x", n_steps=10) is tprogress._NULL
    monkeypatch.setenv("MMT_PROGRESS", "1")
    assert tprogress.progress(100, "x", n_steps=2) is tprogress._NULL
    with tprogress.progress(1000, "write-back", unit="elems",
                            n_steps=10) as p:
        for _ in range(10):
            p.step(100)
    err = capsys.readouterr().err
    assert "write-back" in err and "done" in err and "1.0k elems" in err


def test_facade_has_the_jax_arguments_plus_device(monkeypatch):
    """Same names, order and defaults as the JAX entry, then ``device``
    (None: the card); the polish follows MMT_DF32_POLISH at call time."""
    j = inspect.signature(japi.gll_2_gll).parameters
    t = inspect.signature(tapi.gll_2_gll).parameters
    assert list(t) == list(j) + ["device"]
    assert all(t[k].default == j[k].default for k in j)
    assert t["device"].default is None
    e = inspect.signature(tengine.gll_2_gll).parameters
    assert list(e) == list(t)
    monkeypatch.delenv("MMT_DF32_POLISH", raising=False)
    cfg = tengine._locate_cfg(7, 1.04)
    assert (cfg.nelem_to_search, cfg.accept_tol, cfg.df32_polish) == (
        7, 1.04, False)
    monkeypatch.setenv("MMT_DF32_POLISH", "1")
    assert tengine._locate_cfg(7, 1.04).df32_polish is True
