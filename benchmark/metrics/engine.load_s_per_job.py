"""Seconds of loading the stored operator in ``engine.transfer_arrays``
(stage ``g2g.load_operator``, ``TransferOperator.load``) per job of the
traced stretch.  None where the engine (stage ``g2g.fingerprint``) never
ran; 0 where it ran and loaded no operator."""


def read(ctx):
    stages, jobs = ctx["stages"], ctx["jobs"]
    if "g2g.fingerprint" not in stages or not jobs:
        return None
    return stages.get("g2g.load_operator", 0.0) / jobs
