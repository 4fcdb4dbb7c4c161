"""Every order the JAX Pallas kernels take (1-7, in 2-D and 3-D) in the
port's kernels, checked on the CPU.

* The GLL node and barycentric-weight tables written into the CUDA
  sources (``csrc/newton_rows.cu`` in f32 for K1, ``csrc/gll64.cuh`` in
  f64 for K4 and K5) are parsed back and held against ``core.gll``: to
  f32 rounding and to 1e-15.
* Each kernel's dispatch switch has a case for every (order, dim) pair of
  ``newton.ORDERS`` / ``polish.ORDERS``, and those are 1-7.
* K1's plain twin against the JAX kernel ``newton_refs_rows`` in
  interpret mode at orders 5 and 6 in 3-D (a minute or two of
  interpretation; 7/3, over two minutes, has a file of its own,
  ``test_torch_newton_order7.py``, so that test workers take it in
  parallel; the other orders are in ``test_torch_newton.py``).

The kernels themselves run on the card only (``test_torch_kernels_cuda.py``
at every pair).
"""
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from multimesh_tpu.core import gll as jgll  # noqa: E402
from multimesh_tpu_torch.core import gll as tgll  # noqa: E402
from multimesh_tpu_torch.search import newton, polish  # noqa: E402
from tests import test_torch_newton  # noqa: E402

CSRC = pathlib.Path(newton.__file__).resolve().parents[1] / "csrc"


def _tables(path):
    """{order: (x, w)} parsed from the ``Gll<ORDER>`` specialisations of a
    source: the values each function's ``case``/``default`` lines
    return, in order."""
    src = path.read_text()
    tables = {}
    for m in re.finditer(r"template <> struct Gll<(\d+)> \{(.*?)\n\};", src,
                         re.S):
        funcs = {}
        for f in re.finditer(r"static \w+ (x|w)\(int i\) \{(.*?)\n  \}",
                             m.group(2), re.S):
            vals = re.findall(r"return (?:\(float\))?([-+0-9.eE]+);",
                              f.group(2))
            funcs[f.group(1)] = np.array([float(v) for v in vals])
        tables[int(m.group(1))] = (funcs["x"], funcs["w"])
    return tables


def test_kernel_orders_are_one_to_seven():
    assert newton.ORDERS == polish.ORDERS == (1, 2, 3, 4, 5, 6, 7)


@pytest.mark.parametrize("order", newton.ORDERS)
def test_f32_tables_of_k1_are_core_gll_rounded(order):
    """K1's f32 tables: each value, rounded to f32 as the kernel does,
    equals ``core.gll``'s node or barycentric weight rounded to f32; the
    literals themselves are the f64 values to 1e-15 (and the JAX
    package's nodes agree)."""
    x, w = _tables(CSRC / "newton_rows.cu")[order]
    nodes, bary = tgll.gll_nodes(order)[0], tgll.barycentric_weights(order)
    assert x.shape == w.shape == (order + 1,)
    np.testing.assert_array_equal(x.astype(np.float32),
                                  nodes.astype(np.float32))
    np.testing.assert_array_equal(w.astype(np.float32),
                                  bary.astype(np.float32))
    np.testing.assert_allclose(x, nodes, rtol=0, atol=1e-15)
    np.testing.assert_allclose(w, bary, rtol=1e-15, atol=0)
    np.testing.assert_allclose(x, jgll.gll_nodes(order)[0], rtol=0,
                               atol=1e-15)


@pytest.mark.parametrize("order", polish.ORDERS)
def test_f64_tables_of_k4_k5_are_core_gll(order):
    """K4's and K5's f64 tables equal ``core.gll``'s nodes and
    barycentric weights to 1e-15 (relative for the weights, which reach
    11 at order 7)."""
    x, w = _tables(CSRC / "gll64.cuh")[order]
    assert x.shape == w.shape == (order + 1,)
    np.testing.assert_allclose(x, tgll.gll_nodes(order)[0], rtol=0,
                               atol=1e-15)
    np.testing.assert_allclose(w, tgll.barycentric_weights(order),
                               rtol=1e-15, atol=0)


@pytest.mark.parametrize("source", ["newton_rows.cu", "polish_pairs.cu",
                                    "apply_pairs.cu"])
def test_dispatch_has_every_order_and_dim(source):
    """The launch switch instantiates the kernel at every (order, dim)
    pair the wrapper accepts, and at no other."""
    src = (CSRC / source).read_text()
    cases = {(int(o), int(d))
             for o, d in re.findall(r"MMT_CASE\((\d), (\d)\)", src)}
    assert cases == {(o, d) for o in newton.ORDERS for d in (2, 3)}


@pytest.mark.parametrize("order", [5, 6])
def test_twin_matches_pallas_interpret_3d(order):
    """K1's twin against ``newton_refs_rows(interpret=True)`` at orders
    5 and 6 in 3-D, with ``test_torch_newton``'s check: acceptance equal
    on every row, accepted refs to 1e-5."""
    test_torch_newton.test_twin_matches_pallas_interpret(order, 3)
