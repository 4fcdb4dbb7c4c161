"""The port's surface: for every module of ``multimesh_tpu``, the module
of the same relative name in ``multimesh_tpu_torch``, and in it every
public function and class (jitted ones included) of the JAX module --
except the written list below, each entry with the reason ``ROADMAP.md``
gives for it.

The three Pallas modules are the TPU kernels: each maps to the module
that holds its hand-written CUDA counterpart, and each kernel function to
that module's wrapper.
"""
import importlib
import pkgutil

import pytest

pytest.importorskip("torch")

import multimesh_tpu  # noqa: E402

# JAX module -> the port's module holding its kernels' counterparts
KERNEL_MODULES = {
    "search.pallas_newton": "search.newton",  # K1, K3 folded in
    "search.pallas_argmin": "search.nearest",  # K2
    "search.pallas_df32": "search.polish",  # K4, K5
}
# JAX name -> the port's name, where the port's differs
RENAMED = {
    ("search.pallas_newton", "newton_refs_rows"): "newton_rows",
    ("search.pallas_newton", "newton_refs"): "newton_rows",
    ("search.pallas_df32", "polish_refs_rows"): "polish_pairs",
    ("search.pallas_df32", "apply_refs_rows"): "apply_pairs",
    ("testing", "smooth_field_jnp"): "smooth_field_torch",
}
# not ported on purpose: (module, name or None for the whole module) ->
# reason (ROADMAP.md, "Not ported, on purpose")
NOT_PORTED = {
    ("core.df32", None): "native f64 replaces the TPU's double-f32 pair "
                         "arithmetic",
    ("search.knn", "approx_knn"): "approx_max_k is a TPU op; the port "
                                  "selects exactly",
    ("search.pallas_df32", "prepare_field_rows"): "the TPU's split, "
                                                  "128-padded field rows; "
                                                  "K5 reads f64 fields",
    ("search.locate", "default_engine"): "the port picks the kernels by "
                                         "the tensors' device; there is "
                                         "no engine to choose",
}


def _modules():
    return [m.name[len("multimesh_tpu."):]
            for m in pkgutil.walk_packages(multimesh_tpu.__path__,
                                           "multimesh_tpu.")]


def _public(module):
    return sorted(n for n, o in vars(module).items()
                  if not n.startswith("_") and callable(o)
                  and getattr(o, "__module__", None) == module.__name__)


@pytest.mark.parametrize("rel", _modules())
def test_port_has_the_module_and_its_public_names(rel):
    if (rel, None) in NOT_PORTED:
        with pytest.raises(ImportError):
            importlib.import_module("multimesh_tpu_torch." + rel)
        return
    jmod = importlib.import_module("multimesh_tpu." + rel)
    tmod = importlib.import_module(
        "multimesh_tpu_torch." + KERNEL_MODULES.get(rel, rel))
    missing = [n for n in _public(jmod)
               if (rel, n) not in NOT_PORTED
               and not callable(getattr(tmod, RENAMED.get((rel, n), n),
                                        None))]
    assert not missing, f"{rel}: {missing}"


def test_the_written_list_is_still_needed():
    """Every excluded or renamed name exists in the JAX package and is
    absent from the port under its JAX name (else the list is stale)."""
    for rel, name in [*NOT_PORTED, *RENAMED]:
        jmod = importlib.import_module("multimesh_tpu." + rel)
        if name is None:
            continue
        assert name in _public(jmod), (rel, name)
        port = "multimesh_tpu_torch." + KERNEL_MODULES.get(rel, rel)
        assert not hasattr(importlib.import_module(port), name), (rel, name)
    assert len(_modules()) >= 30
