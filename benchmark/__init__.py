"""The benchmark of multimesh_tpu_torch on an NVIDIA card: ``run.py``
runs one cell of ``BENCHMARK.json`` once (see its docstring)."""
