"""Packaging for multimesh_tpu.

Console script mirrors the reference's ``multi_mesh`` entry
(reference setup.py:48-51) under this package's name.  The native host
runtime (C++ OpenMP kernels under native/) is built separately via
``make -C native`` and loaded through ctypes when present; it is an
optional validation/host-fallback component, not required for the TPU
path.
"""
from setuptools import setup, find_packages

setup(
    name="multimesh_tpu",
    version="0.1.0",
    description=(
        "TPU-native mesh-to-mesh interpolation framework (JAX/XLA/Pallas)"
    ),
    packages=find_packages(exclude=["tests"]),
    # the CUDA sources multimesh_tpu_torch compiles with nvcc on first use
    package_data={"multimesh_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=[
        "numpy",
        "scipy",
        "jax",
        "h5py",
        "click",
    ],
    extras_require={
        "viz": ["matplotlib", "cartopy", "cmasher", "cmcrameri"],
        "grid": ["xarray"],
    },
    entry_points={
        "console_scripts": [
            "multimesh_tpu = multimesh_tpu.cli:cli",
            "multimesh_tpu_torch = multimesh_tpu_torch.cli:cli",
        ]
    },
)
