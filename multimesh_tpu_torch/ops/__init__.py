"""Transfer operators, unique-point dedup, layers, fluid/solid repair."""
from .dedup import (  # noqa: F401
    unique_points,
    unique_points_cached,
    unique_points_device,
    unique_points_per_layer,
)
from .fluid import repair_fluid_solid  # noqa: F401
from .layers import (  # noqa: F401
    layer_masks,
    mesh_layer_masks,
    resolve_layers,
)
from .spherical import map_to_ellipse, map_to_sphere  # noqa: F401
from .transfer import TransferOperator  # noqa: F401
