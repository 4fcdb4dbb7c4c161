"""K1's plain twin against the JAX kernel ``newton_refs_rows`` in
interpret mode at order 7 in 3-D, with ``test_torch_newton``'s check:
acceptance equal on every row, accepted refs to 1e-5.  Over two minutes
of interpretation, so it is a file of its own: test workers that take
files whole run it beside ``test_torch_orders.py``.
"""
import pytest

pytest.importorskip("torch")

from tests import test_torch_newton  # noqa: E402


def test_twin_matches_pallas_interpret_order7_3d():
    test_torch_newton.test_twin_matches_pallas_interpret(7, 3)
