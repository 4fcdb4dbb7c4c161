"""multimesh_tpu_torch -- the PyTorch/CUDA port of the JAX package beside it.

Mesh-to-mesh interpolation between spectral-element (GLL) meshes, with
the hot kernels written by hand for NVIDIA Hopper (``csrc/``, built with
``nvcc`` on first use, see ``_build``).  Module names mirror the JAX
package, which stays the reference; this package
imports torch and numpy, never JAX.

Main path::

    from multimesh_tpu_torch import TransferOperator
    op = TransferOperator.build(source_nodes, targets, order=4,
                                fallback="snap", device="cuda")
    values = op.apply(fields)

File to file (needs ``h5py``, which this root does not import)::

    from multimesh_tpu_torch import api
    api.gll_2_gll("source.h5", "target.h5", stored_array="cache_dir")
"""
from .config import DEFAULT_LOCATE, LocateConfig, Precision  # noqa: F401
from .ops.transfer import TransferOperator  # noqa: F401

__version__ = "0.1.0"
