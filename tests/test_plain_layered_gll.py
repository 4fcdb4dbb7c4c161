"""The port's layered GLL-to-GLL transfer (``engine.gll_2_gll_layered``)
held on the CPU to the plain reference of upstream's semantics,
``plain/layered_gll.py``, which shares no code with either package: on
seeded random nodal values, continuous inside each layer and
discontinuous between layers, at orders 2 and 4 on shells of 2 and 4
layers; interface slots on their own side of the jump; the reference at
the source's own GLL nodes; and the benchmark's copy of it."""
import ast
import pathlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from multimesh_tpu_torch import engine as tengine  # noqa: E402
from multimesh_tpu_torch import testing as tmt  # noqa: E402
from plain import layered_gll as ref  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
PARAMS = ["VP", "VS"]
CASES = [(2, 2), (2, 4), (4, 2), (4, 4)]  # (layers, order)
# The port locates in float32 Newton refs and applies float32 coefficients;
# the reference works in float64.  On values of 1-2 with per-node random
# jumps the port lies within 3.6e-6 of it (relative); the reference's own
# interpolation in bfloat16 lies 1.2e-2 to 4.1e-2 away.  The tolerance
# sits between them, with a factor of over 25 on either side.
RTOL = 1e-4


def _live(mesh, values):
    """A live mesh object as a caller holding a salvus mesh passes it."""
    return types.SimpleNamespace(
        points=mesh.points,
        element_nodal_fields={p: values[i].copy()
                              for i, p in enumerate(PARAMS)},
        elemental_fields={"fluid": np.zeros(mesh.nelem),
                          "layer": mesh.layer_id.astype(np.float64)})


def _layer_values(mesh, seed):
    """[P, E, n] random values in [1, 2], one per node position and layer:
    shared nodes inside a layer carry one value, and a node on an
    interface carries one for each side."""
    E, n, _ = mesh.points.shape
    key = np.concatenate([np.broadcast_to(
        mesh.layer_id[:, None, None].astype(np.float64), (E, n, 1)),
        mesh.points], axis=-1).reshape(-1, 4)
    _, inv = np.unique(key, axis=0, return_inverse=True)
    inv = inv.ravel()
    rng = np.random.default_rng(seed)
    return rng.uniform(1.0, 2.0, (len(PARAMS), inv.max() + 1))[
        :, inv].reshape(len(PARAMS), E, n)


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{nl}layers-order{o}" for nl, o in CASES])
def case(request):
    """The source (6 x 6 x 8 elements), a target inside it whose
    interfaces coincide with the source's (3 x 3 x 8), the source's
    values, the port's answer at every target slot [S, P] and the
    reference's (element, xi) of each slot."""
    n_layers, order = request.param
    src = tmt.shell_mesh(n_lat=6, n_lon=6, n_rad=8, order=order,
                         n_layers=n_layers)
    tgt = tmt.shell_mesh(n_lat=3, n_lon=3, n_rad=8, order=order,
                         n_layers=n_layers, lat_extent=(0.55, 1.15),
                         lon_extent=(0.35, 1.35))
    values = _layer_values(src, seed=n_layers * 10 + order)
    new = _live(tgt, np.full((len(PARAMS), tgt.nelem, tgt.n_gll), np.nan))
    tengine.gll_2_gll_layered(_live(src, values), new, layers="all",
                              parameters=PARAMS, device="cpu")
    got = np.stack([new.element_nodal_fields[p].reshape(-1)
                    for p in PARAMS], axis=-1)
    tgt_layer = np.repeat(tgt.layer_id, tgt.n_gll)
    element, xi = ref.locate(src.points, src.layer_id, tgt.points, tgt_layer)
    return types.SimpleNamespace(src=src, tgt=tgt, values=values, got=got,
                                 tgt_layer=tgt_layer, element=element, xi=xi,
                                 n_layers=n_layers)


def _rel(a, b):
    return np.abs(a - b) / np.abs(b)


def _interfaces(case):
    """(flat target slots on an interface, the layer across it)."""
    r = np.linalg.norm(case.tgt.points.reshape(-1, 3), axis=-1)
    radii = 3.48e6 + (6.371e6 - 3.48e6) * np.arange(
        1, case.n_layers) / case.n_layers
    near = np.isclose(r[:, None], radii, rtol=1e-12, atol=0)
    slots = np.nonzero(near.any(axis=1))[0]
    below = near[slots].argmax(axis=1) + 1  # the layer under interface k
    own = case.tgt_layer[slots]
    return slots, np.where(own == below, below + 1, below)


def test_port_matches_the_plain_reference_and_bf16_does_not(case):
    want = ref.interpolate(case.values, case.element, case.xi).numpy()
    assert np.isfinite(want).all() and (case.element >= 0).all()
    assert np.isfinite(case.got).all()
    assert _rel(case.got, want).max() < RTOL
    bf16 = ref.interpolate(case.values, case.element, case.xi,
                           dtype=torch.bfloat16).numpy()
    assert _rel(bf16, want).max() > 10 * RTOL
    # the whole entry point gives the same numbers as its two steps
    whole = ref.gll_2_gll_layered(case.src.points, case.src.layer_id,
                                  case.values, case.tgt.points,
                                  case.tgt_layer).numpy()
    np.testing.assert_array_equal(whole, want)


def test_interface_slots_take_their_own_side(case):
    """On every interface slot the port holds its own layer's value; a
    group-blind pick (every element in one layer) takes the other side's
    value at some of them, off by the jump there."""
    slots, across = _interfaces(case)
    assert slots.size >= 2 * 9 * (case.n_layers - 1)
    pts = case.tgt.points.reshape(-1, 3)[slots]
    own = ref.gll_2_gll_layered(case.src.points, case.src.layer_id,
                                case.values, pts,
                                case.tgt_layer[slots]).numpy()
    other = ref.gll_2_gll_layered(case.src.points, case.src.layer_id,
                                  case.values, pts, across).numpy()
    blind = ref.gll_2_gll_layered(case.src.points,
                                  np.zeros(case.src.nelem), case.values,
                                  pts, np.zeros(slots.size)).numpy()
    got = case.got[slots]
    assert _rel(got, own).max() < RTOL
    jump = np.abs(other - own)
    assert np.median(jump) > 0.1  # the random values differ across
    # each blind pick is one side's value; some are the other side's
    is_own = np.isclose(blind, own, rtol=1e-9, atol=0).all(axis=1)
    is_other = np.isclose(blind, other, rtol=1e-9, atol=0).all(axis=1)
    assert (is_own | is_other).all()
    is_other &= ~is_own
    assert is_other.any()
    off = np.abs(np.abs(blind - got) - jump)[is_other]
    assert (off <= 2 * RTOL * np.abs(own[is_other])).all()


@pytest.mark.parametrize("n_layers,order", CASES)
def test_reference_at_the_source_nodes_gives_the_nodal_values(n_layers,
                                                              order):
    """Every GLL node of the source, taken as a target of its element's
    layer, reads that element's nodal value to 1e-10: the f64 Newton
    lands on the node.  Nodes shared inside a layer carry one value, so
    any element of the layer that holds the node gives it."""
    src = tmt.shell_mesh(n_lat=4, n_lon=4, n_rad=4, order=order,
                         n_layers=n_layers)
    values = _layer_values(src, seed=7)
    got = ref.gll_2_gll_layered(src.points, src.layer_id, values,
                                src.points,
                                np.repeat(src.layer_id, src.n_gll)).numpy()
    want = values.reshape(len(PARAMS), -1).T
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def test_the_benchmark_copy_is_byte_equal_and_imports_no_package():
    plain = (REPO / "plain/layered_gll.py").read_bytes()
    assert (REPO / "benchmark/reference_layered.py").read_bytes() == plain
    imported = set()
    for node in ast.walk(ast.parse(plain)):
        if isinstance(node, ast.Import):
            imported |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, "a relative import"
            imported.add(node.module.split(".")[0])
    assert imported == {"__future__", "contextlib", "functools", "math",
                        "numpy", "torch"}
