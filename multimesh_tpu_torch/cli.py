"""Command-line interface.

The JAX package's three commands (the reference's console script,
reference multi_mesh/scripts/cli.py: interpolate_mesh_a_to_b at :35,
interpolate_mesh_to_gll at :107, interpolate_gll_to_mesh at :260) with
the same options, over this package's engine.  The group option
``--device`` (or ``$MMT_DEVICE``; ``cuda`` or ``cpu``, default ``cuda``)
takes the place of the JAX package's ``--platform`` and is passed to the
engine entry each command calls.

Entry point:  python -m multimesh_tpu_torch.cli <command> [options]
(installed as ``multimesh_tpu_torch`` via setup.py).  With
``MMT_PROFILE`` set, a command ends by printing its stage and counter
table on standard error (``utils_profile.report``).
"""
from __future__ import annotations

import time

import click

from . import utils_profile


def _report(start: float):
    runtime = time.time() - start
    if runtime >= 60:
        click.echo(f"Finished in time: {runtime / 60:.3f} minutes")
    else:
        click.echo(f"Finished in time: {runtime:.3f} seconds")
    if utils_profile.profiling_enabled():
        utils_profile.report()


def _params(params: str):
    """"VP, VS" / a trailing comma -> a list of names; "TTI" stays a
    preset name."""
    if "," in params:
        return [q.strip() for q in params.split(",") if q.strip()]
    return params.strip()


@click.group()
@click.option(
    "--device",
    type=click.Choice(["cuda", "cpu"]),
    default="cuda",
    envvar="MMT_DEVICE",
    show_default=True,
    help="Device the transfer runs on ($MMT_DEVICE): the CUDA kernels, "
    "or their plain twins on the CPU.",
)
@click.pass_context
def cli(ctx, device):
    """multimesh_tpu_torch -- mesh-to-mesh interpolation on a GPU."""
    ctx.obj = device


@cli.command()
@click.option("--mesh_a", help="Exodus file to interpolate from.",
              required=True)
@click.option("--mesh_b", help="Exodus file to interpolate onto.",
              required=True)
@click.option("--params", help="Comma-separated parameters or TTI/ISO.",
              default="TTI", show_default=True)
@click.pass_obj
def interpolate_mesh_a_to_b(device, mesh_a, mesh_b, params):
    """Interpolate nodal values from exodus mesh A onto exodus mesh B
    (3D hex meshes)."""
    from .engine import exodus_2_exodus

    start = time.time()
    exodus_2_exodus(mesh_a=mesh_a, mesh_b=mesh_b,
                    parameters=_params(params), device=device)
    _report(start)


@cli.command()
@click.option("--mesh", help="Exodus file with nodal parameters.",
              required=True)
@click.option("--gll_model", help="HDF5 GLL mesh to write onto.",
              required=True)
@click.option("--gll_order", help="Polynomial order of the GLL model.",
              default=4, show_default=True, type=int)
@click.option("--params", help="Comma-separated parameters or TTI/ISO.",
              default="TTI", show_default=True)
@click.pass_obj
def interpolate_mesh_to_gll(device, mesh, gll_model, gll_order, params):
    """Interpolate from an exodus mesh onto a GLL (smoothiesem) model."""
    from .engine import exodus_2_gll

    start = time.time()
    exodus_2_gll(
        mesh=mesh, gll_model=gll_model, gll_order=gll_order,
        parameters=_params(params), device=device,
    )
    _report(start)


@cli.command()
@click.option("--mesh", help="Exodus file to receive nodal parameters.",
              required=True)
@click.option("--gll_model", help="HDF5 GLL mesh to read from.",
              required=True)
@click.option("--gll_order", help="Polynomial order of the GLL model.",
              default=4, show_default=True, type=int)
@click.pass_obj
def interpolate_gll_to_mesh(device, mesh, gll_model, gll_order):
    """Interpolate parameters stored on a GLL model onto a nodal exodus
    mesh (parameters taken from the GLL file's dimension labels)."""
    from .engine import gll_2_exodus

    start = time.time()
    gll_2_exodus(gll_model=gll_model, exodus_model=mesh,
                 gll_order=gll_order, device=device)
    _report(start)


if __name__ == "__main__":
    cli()
