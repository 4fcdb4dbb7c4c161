"""Point location: nearest-centroid and Newton kernels, kNN, the ladder."""
from .grid import GridIndex, build_grid, grid_knn, knn_any  # noqa: F401
