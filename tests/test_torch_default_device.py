"""No entry of the port runs on the CPU unless its caller asks for it.

(i) Every public function of ``api``, ``engine``, ``ops.spherical`` and
``viz.plotter`` that takes ``device`` defaults it to None, which the port
reads as ``cuda`` (found by introspection, so a later entry is covered
without an edit).  (ii) The six entries that ``chip_smoke.py`` calls with
``device`` omitted, called so here on tiny fixtures: the port's ``locate``,
as ``TransferOperator.build`` calls it, is replaced by a stub that records
the device it was given and raises, so each call must reach it asking for
the card, with nothing located on the CPU and its meshes left as they
were; and ``locate`` itself places the points of such a call on ``cuda``.
"""
import inspect
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from multimesh_tpu_torch import api, engine  # noqa: E402
from multimesh_tpu_torch import testing as tmt  # noqa: E402
from multimesh_tpu_torch.ops import dedup, spherical, transfer  # noqa: E402
from multimesh_tpu_torch.ops import layers as tlayers  # noqa: E402
from multimesh_tpu_torch.search import locate as tloc  # noqa: E402
from multimesh_tpu_torch.viz import plotter  # noqa: E402

MODULES = (api, engine, spherical, plotter)


def _device_functions():
    return [(mod.__name__.rsplit(".", 1)[-1] + "." + name, fn)
            for mod in MODULES
            for name, fn in inspect.getmembers(mod, inspect.isfunction)
            if not name.startswith("_") and fn.__module__ == mod.__name__
            and "device" in inspect.signature(fn).parameters]


DEVICE_FUNCTIONS = _device_functions()


@pytest.mark.parametrize("name,fn", DEVICE_FUNCTIONS,
                         ids=[n for n, _ in DEVICE_FUNCTIONS])
def test_device_defaults_to_none(name, fn):
    assert inspect.signature(fn).parameters["device"].default is None, name


def test_the_introspection_finds_the_entries():
    names = {n for n, _ in DEVICE_FUNCTIONS}
    assert {"api.interpolate_to_mesh", "spherical.map_to_ellipse",
            "engine.get_element_weights",
            "engine.get_element_weights_layered",
            "engine.interpolate_to_points_layered",
            "engine.gll_2_points_arrays", "plotter.plot_depth_slice",
            "api.gll_2_gll"} <= names
    assert "spherical.map_to_sphere" not in names  # it takes no device


# -- the entries, device omitted ---------------------------------------------
class _Located(Exception):
    """Raised by the stub in place of ``locate``."""


@pytest.fixture
def devices(monkeypatch):
    """The devices ``TransferOperator.build`` passed to ``locate``."""
    seen = []

    def stub(*args, device=None, **kwargs):
        seen.append(device)
        raise _Located

    monkeypatch.setattr(transfer, "_locate", stub)
    return seen


@pytest.fixture
def dedup_devices(monkeypatch):
    """The devices the layered entries asked ``unique_points_per_layer``
    for; the host groups the slots here (there is no card), so the call
    goes on to ``locate``."""
    seen = []
    per_layer = dedup.unique_points_per_layer

    def host_dedup(points, masks, device=None):
        seen.append(device)
        return per_layer(points, masks)

    monkeypatch.setattr(engine, "unique_points_per_layer", host_dedup)
    return seen


def _meshes():
    src = tmt.shell_mesh(n_lat=3, n_lon=3, n_rad=2, order=2, n_layers=2)
    tgt = tmt.shell_mesh(n_lat=2, n_lon=2, n_rad=2, order=2, n_layers=2,
                         r_inner=3.7e6, r_outer=6.2e6,
                         lat_extent=(0.58, 1.12), lon_extent=(0.38, 1.32))
    return src, tgt


def _live(mesh, kind):
    nodal, elemental = tmt.salvus_fixture_fields(mesh, ("VP",),
                                                 field_kind=kind)
    return types.SimpleNamespace(points=mesh.points.copy(),
                                 element_nodal_fields=nodal,
                                 elemental_fields=elemental)


def _unchanged(*meshes):
    """() -> whether each mesh holds the points and the field arrays it
    held when this was called."""
    kept = [(m, m.points.copy(), dict(m.element_nodal_fields))
            for m in meshes]
    return lambda: all(
        np.array_equal(m.points, pts)
        and m.element_nodal_fields.keys() == fields.keys()
        and all(m.element_nodal_fields[k] is v for k, v in fields.items())
        for m, pts, fields in kept)


def _interpolate_to_mesh(src, tgt):
    old, new = _live(src, "smooth"), _live(tgt, "linear")
    return (lambda: api.interpolate_to_mesh(old, new,
                                            params_to_interp=["VP"]),
            _unchanged(old, new))


def _map_to_ellipse(src, tgt):
    base, target = tmt.elliptic_mesh(src), tmt.elliptic_mesh(tgt, 0.0)
    return (lambda: spherical.map_to_ellipse(base, target),
            _unchanged(base, target))


def _get_element_weights(src, tgt):
    return (lambda: engine.get_element_weights(
        src.points, src.order, None, tgt.points.reshape(-1, 3)),
        lambda: True)


def _get_element_weights_layered(src, tgt):
    ids = np.unique(src.layer_id)
    masks = tlayers.layer_masks(src.layer_id, ids)
    coords = dedup.unique_points_per_layer(
        tgt.points, tlayers.layer_masks(tgt.layer_id, ids))
    near = {layer: np.zeros((len(pts), 2), np.int32)
            for layer, (pts, _) in coords.items()}
    mesh = types.SimpleNamespace(points=src.points)
    return (lambda: engine.get_element_weights_layered(
        coords, near, mesh, masks, from_gll_order=src.order),
        lambda: True)


def _interpolate_to_points_layered(src, tgt):
    old, new = _live(src, "smooth"), _live(tgt, "linear")
    return (lambda: engine.interpolate_to_points_layered(
        old, new, ["VP"], layers="all"), _unchanged(old, new))


def _gll_2_points_arrays(src, tgt):
    data = tmt.element_nodal_field(src)[:, None, :]
    return (lambda: engine.gll_2_points_arrays(
        src.points, data, tgt.points.reshape(-1, 3)), lambda: True)


ENTRIES = {
    "interpolate_to_mesh": _interpolate_to_mesh,
    "map_to_ellipse": _map_to_ellipse,
    "get_element_weights": _get_element_weights,
    "get_element_weights_layered": _get_element_weights_layered,
    "interpolate_to_points_layered": _interpolate_to_points_layered,
    "gll_2_points_arrays": _gll_2_points_arrays,
}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_entry_without_device_asks_locate_for_the_card(entry, devices,
                                                       dedup_devices):
    call, unchanged = ENTRIES[entry](*_meshes())
    with pytest.raises(_Located):
        call()
    # one locate call, for the card by locate's rule (None means cuda),
    # and no other work done: the call stopped there and left its meshes;
    # a layered entry's dedup was asked for the card too
    assert len(devices) == 1
    for device in devices + dedup_devices:
        assert torch.device(
            "cuda" if device is None else device).type == "cuda"
    assert bool(dedup_devices) == (entry == "interpolate_to_points_layered")
    assert unchanged()


def test_locate_places_the_points_of_a_call_without_device_on_the_card(
        monkeypatch):
    """The rule the test above relies on, driven: ``locate``'s first
    placement of a tensor off the host is on ``cuda``."""
    placed = []
    as_tensor = torch.as_tensor

    def recording(data, *args, device=None, **kwargs):
        if device is not None and torch.device(device).type != "cpu":
            placed.append(torch.device(device))
            raise _Located
        return as_tensor(data, *args, device=device, **kwargs)

    src, tgt = _meshes()
    monkeypatch.setattr(torch, "as_tensor", recording)
    with pytest.raises(_Located):
        tloc.locate(tgt.points.reshape(-1, 3), src.points, src.order)
    assert placed == [torch.device("cuda")]
