"""Transfer operators, unique-point dedup, fluid/solid repair."""
from .dedup import (  # noqa: F401
    unique_points,
    unique_points_cached,
    unique_points_device,
)
from .fluid import repair_fluid_solid  # noqa: F401
from .transfer import TransferOperator  # noqa: F401
