"""API surface of innr_tpu_torch against innr_tpu.

Every public name at the top of ``innr_tpu`` (its ``__init__.py``) is
either reachable at the top of ``innr_tpu_torch`` or on the explicit
not-yet-ported list below, which shrinks as the port grows; a ported name
left on the list fails too. A listed package may already hold internal
pieces that a ported module uses (``innr_tpu_torch.parallel._scan``, the
scan body of the sharded containers); it counts as ported once it exports
the reference package's public names. The reference crate's symbols that the JAX
package keeps in a module of its own (the backend report, the sparse_ext
tuple API, the distance metrics) are checked in the port's module of the
same name.
"""

import importlib

import pytest

torch = pytest.importorskip("torch")

import innr_tpu as it  # noqa: E402
import innr_tpu_torch as itt  # noqa: E402

NOT_YET_PORTED: list[str] = []

PUBLIC = sorted(n for n in dir(it) if not n.startswith("_"))

MODULE_NAMES = {
    "backend": ["Backend", "dense_backend", "batch_backend", "slot_backend"],
    "distance": ["Distance", "DistCosine", "DistDot", "DistL2", "DistL1", "DistHamming",
                 "DistSlotU32"],
    "ops.sparse_ext": ["sparse_dot", "sparse_dense_dot", "sparse_l2_norm", "sparse_normalize",
                       "sparse_top_k", "sparse_max_weight"],
    "ops.dense_f64": ["dot_f64", "norm_f64", "normalize_f64", "cosine_f64",
                      "l2_distance_squared_f64", "l2_distance_f64", "l1_distance_f64"],
    "ops.maxsim": ["maxsim", "maxsim_cosine", "batch_maxsim", "maxsim_knn",
                   "maxsim_knn_batch"],
}


def _exports(name):
    """The reference's public names under ``name`` that the port exports."""
    ref = set(getattr(getattr(it, name), "__all__", ()))
    return ref & set(getattr(getattr(itt, name, None), "__all__", ()))


@pytest.mark.parametrize("name", PUBLIC)
def test_public_name_ported_or_listed(name):
    if name in NOT_YET_PORTED:
        assert not hasattr(itt, name) or not _exports(name), (
            f"{name} is ported: take it off NOT_YET_PORTED")
    else:
        assert hasattr(itt, name), f"innr_tpu.{name} has no innr_tpu_torch counterpart"


def test_not_yet_ported_names_exist_in_the_reference():
    assert set(NOT_YET_PORTED) <= set(PUBLIC)


@pytest.mark.parametrize("module", sorted(MODULE_NAMES))
def test_module_names(module):
    mod = importlib.import_module(f"innr_tpu_torch.{module}")
    ref = importlib.import_module(f"innr_tpu.{module}")
    for name in MODULE_NAMES[module]:
        assert hasattr(ref, name), f"innr_tpu.{module}.{name}"
        assert hasattr(mod, name), f"innr_tpu_torch.{module}.{name}"


def test_exported_functions_are_the_modules_own():
    """A top-level name is the object of the module that defines it."""
    for module, names in MODULE_NAMES.items():
        mod = importlib.import_module(f"innr_tpu_torch.{module}")
        for name in names:
            if hasattr(itt, name) and module != "ops.sparse_ext":
                assert getattr(itt, name) is getattr(mod, name), f"{module}.{name}"


def test_parallel_exports_the_reference_names():
    """``innr_tpu_torch.parallel`` exports the reference package's
    ``__all__``, and ``parallel.multihost`` its three names."""
    import innr_tpu.parallel as ref
    import innr_tpu.parallel.multihost as ref_multihost
    import innr_tpu_torch.parallel as par

    assert sorted(par.__all__) == sorted(ref.__all__)
    assert _exports("parallel") == set(ref.__all__)
    for name in ref.__all__:
        assert hasattr(par, name), name
    assert par.multihost.__all__ == ref_multihost.__all__
    for name in ref_multihost.__all__:
        assert callable(getattr(par.multihost, name)), name


def test_native_host_functions_are_ported():
    """Every public function of ``innr_tpu._native`` (the ctypes wrappers
    over ``native/innr_host.c``) has its namesake in
    ``innr_tpu_torch._native``."""
    import inspect

    import innr_tpu._native as ref
    import innr_tpu_torch._native as port

    def public(mod):
        return {n for n, o in vars(mod).items() if not n.startswith("_")
                and inspect.isfunction(o) and o.__module__ == mod.__name__}

    assert {"pack_ternary", "hamming_scan"} <= public(ref)
    assert public(ref) <= public(port), sorted(public(ref) - public(port))
