"""Point location: nearest-centroid and Newton kernels, kNN, the ladder."""
