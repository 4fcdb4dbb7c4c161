"""Central configuration: tolerances, search constants, precision policy.

The same dataclass as the JAX package's ``config.py`` (a pure dataclass, copied
so the port never imports the JAX package): both packages read one set
of knobs with identical defaults and identical meaning.
"""
from __future__ import annotations

import dataclasses
import enum

# Geocentric sphere radius of the lat/lon/depth conversions, in metres
# (reference multi_mesh/utils.py:534).
R_EARTH_M = 6_371_000.0

# Default trilinear-prefilter width: the prefilter ranks candidates with a
# cheap order-1 Newton and keeps the best PREFILTER_M for the full-order
# solve (shared by every engine path; retune it here, not at call sites).
PREFILTER_M = 4


class Precision(enum.Enum):
    """Numerical policy for the device pipeline.

    F64     -- float64 refs and weights (exactness validation): the
               float32 ladder decides acceptance, then every accepted
               row takes ``f64_polish``'s float64 Newton steps.
    MIXED   -- candidate search and Newton bulk iterations in float32 on
               element-centered coordinates.  Default.
    F32     -- everything float32 (max-throughput benchmarking).
    """

    F64 = "f64"
    MIXED = "mixed"
    F32 = "f32"


@dataclasses.dataclass(frozen=True)
class LocateConfig:
    """Point-location behavior knobs (one object instead of scattered args)."""

    # Number of candidate source elements examined per query point.
    # Reference defaults: 20 (gll_2_gll, interpolator.py:624), 25
    # (get_element_weights, interpolator.py:1152), 30 (layered_multi_two,
    # interpolator.py:984).
    nelem_to_search: int = 20

    # A candidate is accepted when all |ref coords| < accept_tol.
    # Reference: 1.05 (interpolator.py:1208), 1.04 (:1439), 1.03 (:1288),
    # 1.025 (trilinearinterpolator.c:93).
    accept_tol: float = 1.05

    # When snapping to the best candidate, ref coords are clipped to
    # +/- snap_clip (reference interpolator.py:1219).
    snap_clip: float = 1.02

    # Best-so-far fallback only taken when its max |ref| is below this
    # (reference trilinearinterpolator.c:113 uses 1.5).
    fallback_max: float = 1.5

    # Newton iteration counts: a fixed, branchless schedule of
    # `newton_iters` bulk iterations plus `polish_iters` (the reference
    # runs up to 50 double-precision iterations with early exit,
    # trilinearinterpolator.c:264).  `prefilter_iters` is the cheaper
    # schedule of the trilinear candidate prefilter.
    newton_iters: int = 16
    polish_iters: int = 2
    prefilter_iters: int = 8

    # When the trilinear prefilter is active, only the nearest
    # `prefilter_pool` candidates enter the ranking.
    prefilter_pool: int = 12

    # Convergence tolerance, relative to element scale
    # (reference trilinearinterpolator.c:282: tol = 1e-8 * scale).
    newton_rtol: float = 1e-8

    # Ref-coord magnitude at which Newton iterates are clamped to avoid
    # overflow for far-away candidates (pure numerical guard; points with
    # clamped solutions can never pass accept_tol).
    newton_clamp: float = 8.0

    # float64 Newton polish of accepted pairs after the f32 ladder.
    f64_polish: bool = False

    # Double-f32 polish of accepted pairs (pair-precision refs and the
    # compensated apply).
    df32_polish: bool = False
    df32_polish_iters: int = 1

    precision: Precision = Precision.MIXED


DEFAULT_LOCATE = LocateConfig()

# Hardcoded interior fallback ref coordinate used by the reference when a
# point cannot be located at all but a value is still required
# (reference interpolator.py:1468-1471).
FALLBACK_REF_COORD = (0.645, -0.5, 0.22)

# Parameter-set presets (reference multi_mesh/utils.py:171-188).
PARAM_PRESETS = {
    "TTI": ["VPV", "VPH", "VSV", "VSH", "RHO", "ETA", "QKAPPA", "QMU"],
    "ISO": ["QKAPPA", "QMU", "RHO", "VP", "VS"],
}
