"""Sharded transfers on ``torch.distributed`` (see ``sharding``); ranks
for tests and one-host runs from ``launch.run_ranks``."""
from .sharding import (  # noqa: F401
    make_mesh,
    partition_source,
    sharded_transfer,
    source_sharded_transfer,
)
