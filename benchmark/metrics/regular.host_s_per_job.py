"""Seconds of the regular-grid export's host stages per job of the
traced stretch: ``regular.make_points`` (the linspaces, the meshgrid and
``latlondepth_to_xyz``), ``regular.pull`` (the [N, P] values pulled to
the host) and ``regular.assemble`` (their reshape into the dataset).
None where ``regular.make_points`` never ran (a program without the
spans, or another path)."""


def read(ctx):
    stages, jobs = ctx["stages"], ctx["jobs"]
    if "regular.make_points" not in stages or not jobs:
        return None
    return (stages["regular.make_points"] + stages.get("regular.pull", 0.0)
            + stages.get("regular.assemble", 0.0)) / jobs
