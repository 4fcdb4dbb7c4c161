"""Fluid/solid contamination repair for interpolated seismic models.

When interpolating between meshes whose fluid (outer-core) regions do not
align exactly, solid elements can pick up fluid values (zero shear
velocity) and fluid elements can pick up solid ones.  The reference
repairs this after the transfer (reference
multi_mesh/components/interpolator.py:681-691 and :829-841):

1. non-solid (fluid) target elements keep their pre-transfer values,
2. solid target elements that received a zero VS anywhere ("fake fluid")
   are reverted to their pre-transfer values wholesale.
"""
from __future__ import annotations

from typing import List

import numpy as np


def repair_fluid_solid(
    new_values: np.ndarray,
    old_values: np.ndarray,
    solid_elements: np.ndarray,
    parameters: List[str],
) -> np.ndarray:
    """Apply both repairs; returns the repaired array (copy-on-write).

    new_values / old_values: [nelem, n_params, n_gll];
    solid_elements: boolean [nelem].
    """
    new_values = np.array(new_values, copy=True)
    # 1. fluid elements keep their original values
    new_values[~solid_elements] = old_values[~solid_elements]

    # 2. solid elements that received zero shear velocity revert entirely
    vs_index = shear_index(parameters)
    if vs_index is None:
        return new_values
    zero_vs = (new_values[:, vs_index, :] == 0.0).any(axis=1)
    revert = zero_vs & solid_elements
    new_values[revert] = old_values[revert]
    return new_values


def shear_index(parameters: List[str]) -> int | None:
    """Index of the shear velocity whose zero reverts a solid element:
    VS, else VSV; None when ``parameters`` hold neither."""
    for name in ("VS", "VSV"):
        if name in parameters:
            return parameters.index(name)
    return None
