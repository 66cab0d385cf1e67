"""No module that the benchmark loads is JAX or the JAX package, compared by
whole top-level names, and the reference imports nothing of the port."""

import ast
import subprocess
import sys
import types

import pytest
from conftest import ROOT

from gpubench import run as run_mod


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    for name in ("innr_tpu.batch", "jaxlib", "flax.linen", "innr_tpu_torch.batch",
                 "jax_like", "innr_tpu_extra"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    found = set(run_mod.forbidden_modules())
    assert {"innr_tpu", "jaxlib", "flax"} <= found
    assert not found & {"innr_tpu_torch", "jax_like", "innr_tpu_extra"}


def _loaded_by(modules: str, then: str = "pass") -> set:
    code = (f"import sys; import {modules}; {then}; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True)
    return set(out.stdout.split())


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    # with every index kind and loop in the folder loaded, as runs load them
    loaded = _loaded_by("gpubench.run, gpubench.sweep, gpubench.control",
                        "from gpubench import bench; "
                        "[getattr(bench, f)(p.stem) for f in ('system', 'loop') "
                        "for p in (bench.HERE / (f + 's')).glob('[!_]*.py')]")
    assert "innr_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "innr_tpu"}


def test_the_reference_imports_nothing_of_the_program():
    loaded = _loaded_by("gpubench.reference, gpubench.compare, gpubench.roofline, "
                        "gpubench.gen.mixture, gpubench.gen.arrivals, gpubench.trace")
    assert not loaded & {"innr_tpu_torch", "innr_tpu", "jax", "jaxlib", "flax"}
    tree = ast.parse((ROOT / "gpubench/reference.py").read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert names == {"__future__", "dataclasses", "torch"}


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the run would measure")
    rc = run_mod.main(["--workload", "deep100m.serve", "--seed", "1", "--seconds", "1"])
    assert rc == 2 and capsys.readouterr().out == ""
