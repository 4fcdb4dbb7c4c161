"""The grouped check rehearsed on the port's layered path at full size;
not a cell, and the benchmark's own runs never run it.

    python3 benchmark/layered_rehearsal.py --seed <n> [--tiny]

A 4,096-element order-4 shell source of 4 layers and a 10,267,500-slot
order-4 target of 4 layers whose interfaces coincide with the source's
(``chip_smoke.py``'s layered pair, made here by ``meshes``), handed to
``engine.gll_2_gll_layered`` as live mesh objects.  Each parameter is
``smooth_field`` times its own factor and times 1.1 ** (layer - 1), so
the field jumps by 10% at every interface.  After the call: ``--check``
sampled slots (a quarter of them on the interfaces, drawn from the
seed) through the grouped check, the group-blind check on the same
answers, and the bfloat16 control; the misses past [-1, 1]^3 of the
targets on the groups' spheres (interfaces, inner and outer surface)
that the face slack ``inputs.GROUP_FACE_TOL`` must cover.  One JSON
line.  ``--tiny`` runs a two-layer shell on the CPU.
"""
import argparse
import json
import pathlib
import sys
import time
import types

if __name__ == "__main__":
    sys.path[0] = str(pathlib.Path(__file__).resolve().parent.parent)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import inputs, meshes, reference, run  # noqa: E402

FULL = ((16, 16, 16, 4), (37, 37, 60, 4), ["VP", "VS", "RHO", "QMU"])
TINY = ((4, 4, 4, 2), (3, 3, 4, 2), ["VP", "VS", "RHO"])
TARGET_BOX = dict(lat_extent=(0.55, 1.15), lon_extent=(0.35, 1.35))
JUMP = 1.1  # the field's factor from one layer to the next


def _shell(shape, device, **box):
    """(lattice [E, n, 3] f64 on ``device``, layer ids [E]) of a shell of
    (n_lat, n_lon, n_rad, n_layers) at order 4."""
    n_lat, n_lon, n_rad, n_layers = shape
    lattice = meshes.shell_lattice(n_lat, n_lon, n_rad, 4, device=device,
                                   **box)
    return lattice, meshes.shell_layer_ids(n_lat, n_lon, n_rad, n_layers,
                                           device=device)


def _fields(lattice, layer, params):
    """[P, E, n] f64: ``smooth_field`` x (1 + 0.1 i) x JUMP ** (layer - 1)."""
    base = meshes.smooth_field(lattice) * JUMP ** (layer - 1).double()[:, None]
    return torch.stack([base * (1.0 + 0.1 * i) for i in range(len(params))])


def _live(points, fields, layer, params):
    """A live mesh object as a caller holding a salvus mesh passes it."""
    return types.SimpleNamespace(
        points=points,
        element_nodal_fields={p: fields[i] for i, p in enumerate(params)},
        elemental_fields={"fluid": np.zeros(points.shape[0]),
                          "layer": layer.astype(np.float64)})


def _boundary_slots(shape, order):
    """(flat slots on the interfaces, flat slots on any sphere that
    bounds a layer: the interfaces, the inner and the outer surface) of
    a target shell of ``shape``."""
    n_lat, n_lon, n_rad, n_layers = shape
    n = (order + 1) ** 3
    elem = np.repeat(np.arange(n_lat * n_lon * n_rad), n)
    node_r = np.tile(np.arange(n) // (order + 1) ** 2, elem.size // n)
    band = elem // (n_lat * n_lon)
    starts = [b for b in range(1, n_rad)
              if b * n_layers // n_rad != (b - 1) * n_layers // n_rad]
    iface = np.zeros(elem.size, bool)
    for b in starts:
        iface |= ((band == b - 1) & (node_r == order)) | (
            (band == b) & (node_r == 0))
    sphere = iface | ((band == 0) & (node_r == 0)) | (
        (band == n_rad - 1) & (node_r == order))
    return np.nonzero(iface)[0], np.nonzero(sphere)[0]


def rehearse(seed: int, n_check: int, tiny: bool, device) -> dict:
    from multimesh_tpu_torch import engine

    src_shape, tgt_shape, params = TINY if tiny else FULL
    device = torch.device(device)
    src_lat, src_layer = _shell(src_shape, device)
    tgt_lat, tgt_layer = _shell(tgt_shape, device, **TARGET_BOX)
    values = _fields(src_lat, src_layer, params)
    src_host, tgt_host = src_lat.cpu().numpy(), tgt_lat.cpu().numpy()
    E, n, _ = tgt_host.shape
    old = _live(src_host, values.cpu().numpy(), src_layer.cpu().numpy(),
                params)
    zeros = np.zeros((len(params), E, n))
    new = _live(tgt_host, zeros, tgt_layer.cpu().numpy(), params)
    del src_lat, tgt_lat
    t = time.perf_counter()
    engine.gll_2_gll_layered(old, new, layers="all", parameters=params,
                             device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t

    iface, sphere = _boundary_slots(tgt_shape, 4)
    rng = inputs.job_rng(seed, 1, 1)
    k_iface = n_check // 4
    others = np.setdiff1d(np.arange(E * n), iface)
    pick = np.concatenate([rng.choice(others, n_check - k_iface,
                                      replace=False),
                           rng.choice(iface, k_iface, replace=False)])
    e, m = pick // n, pick % n
    on_iface = np.arange(pick.size) >= n_check - k_iface
    points = tgt_host[e, m]
    got = np.stack([new.element_nodal_fields[p][e, m] for p in params], -1)
    groups = tgt_layer.cpu().numpy()[e]
    source = inputs.Source(src_host, values, 4, params,
                           element_group=src_layer)
    blind = inputs.Source(src_host, values, 4, params)

    def check(rows, grouped=True, dtype=torch.float64):
        a = inputs.Answers()
        a.add(1, points[rows], got[rows], groups[rows] if grouped else None)
        return inputs.compare(source if grouped else blind, a,
                              lambda job: values, device, dtype=dtype)

    every = np.ones(pick.size, bool)
    out = {
        "source_elements": int(src_host.shape[0]),
        "target_slots": int(E * n), "parameters": len(params),
        "layered_call_s": wall, "checked_slots": int(pick.size),
        "on_interface": int(on_iface.sum()),
        "grouped": check(every),
        "grouped_interface": check(on_iface),
        "blind": check(every, grouped=False),
        "blind_interface": check(on_iface, grouped=False),
        "blind_elsewhere": check(~on_iface, grouped=False),
        "control_bf16": check(every, dtype=torch.bfloat16),
    }
    # how far the slots on the layers' spheres lie outside their own
    # group, found with a wide slack: what GROUP_FACE_TOL has to cover
    rows = rng.choice(sphere, min(sphere.size, 65536), replace=False)
    re, rm = rows // n, rows % n
    _, _, found, miss, _ = inputs.locate_grouped(
        torch.as_tensor(src_host, device=device), src_layer,
        torch.as_tensor(tgt_host[re, rm], device=device),
        torch.as_tensor(tgt_layer.cpu().numpy()[re], device=device), 4,
        inside_tol=1e-3)
    miss = miss[found]
    out["sphere_slots"] = {
        "sampled": int(rows.size), "found_at_1e-3": int(found.sum()),
        "past_inside_tol": int((miss > reference.INSIDE_TOL).sum()),
        "past_group_face_tol": int((miss > inputs.GROUP_FACE_TOL).sum()),
        "miss_max": float(miss.max()),
        "miss_p99": float(miss.quantile(0.99)),
        "miss_median": float(miss.median())}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--check", type=int, default=4096)
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)
    device = "cpu" if args.tiny else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        print("layered_rehearsal: needs a CUDA device", file=sys.stderr)
        return 2
    out = rehearse(args.seed, args.check, args.tiny, device)
    if device == "cuda":
        out["device"] = torch.cuda.get_device_name()
        out["power_limit"] = run._power_limit()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
