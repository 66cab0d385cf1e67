"""innr_tpu_torch stands apart from JAX and builds its kernels or raises."""

import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from innr_tpu_torch.kernels import _build  # noqa: E402
from innr_tpu_torch import config  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """Host data goes to the card by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "innr_tpu_torch"


def test_imports_with_jax_blocked():
    """Every module found under the package imports with JAX blocked and
    pulls in nothing of innr_tpu."""
    code = (
        "import sys, importlib, pkgutil; sys.modules['jax'] = None; "
        "import innr_tpu_torch as pkg; "
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'innr_tpu_torch.')]; "
        "[importlib.import_module(n) for n in names]; "
        "assert 'innr_tpu' not in sys.modules; "
        "print(len(names), ' '.join(names))"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    count, names = proc.stdout.split(maxsplit=1)
    on_disk = {p.relative_to(ROOT).with_suffix("").as_posix().replace("/", ".").removesuffix(
        ".__init__") for p in PKG.rglob("*.py")} - {"innr_tpu_torch"}
    assert set(names.split()) == on_disk and int(count) == len(on_disk)


def test_no_module_imports_jax_or_innr_tpu():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|innr_tpu)(\.|\s|$)", re.M)
    offenders = [p.name for p in PKG.rglob("*.py") if pattern.search(p.read_text())]
    assert offenders == []
    assert "jax" not in (ROOT / "chip_smoke.py").read_text().replace("JAX", "")


def test_only_the_distribution_layer_imports_it():
    """No module outside ``innr_tpu_torch/parallel/`` imports from
    ``innr_tpu_torch.parallel``: what an index shares with the sharded
    family lives below both."""
    pattern = re.compile(
        r"^\s*(from\s+innr_tpu_torch\.parallel\b|import\s+innr_tpu_torch\.parallel\b"
        r"|from\s+innr_tpu_torch\s+import\s+.*\bparallel\b)", re.M)
    offenders = [p.relative_to(ROOT).as_posix() for p in PKG.rglob("*.py")
                 if "parallel" not in p.relative_to(PKG).parts and pattern.search(p.read_text())]
    assert offenders == []


def test_build_without_nvcc_raises_naming_nvcc(monkeypatch):
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(_build.Path, "is_file", lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()


def test_sources_ship_with_the_package():
    assert sorted(p.name for p in (PKG / "csrc").glob("*.cu")) == [
        "assign.cu", "knn.cu", "maxsim.cu", "maxsim_bf16.cu", "packed.cu", "packed_knn.cu",
        "pruned.cu", "slot_knn.cu", "sparse_knn.cu"]
    assert sorted(p.name for p in (PKG / "csrc").glob("*.cuh")) == [
        "maxsim_tokens.cuh", "mma.cuh", "packed.cuh", "row_scan.cuh", "topk.cuh", "vec.cuh"]
    text = (ROOT / "pyproject.toml").read_text()
    assert 'innr_tpu_torch = ["csrc/*.cu", "csrc/*.cuh"]' in text
    assert 'include = ["innr_tpu*"]' in text  # picks up innr_tpu_torch too
