# The port stands alone: it and chip_smoke.py load neither JAX nor any
# module of the JAX package, its kernels are CUDA sources that name the TPU
# kernel they replace, and what needs the card refuses to run without one.
#
# tests/conftest.py imports jax into THIS process, so the import check runs
# in a fresh interpreter.
import ast
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "copilot_for_consensus_tpu_torch"
PORT_FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import copilot_for_consensus_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "copilot_for_consensus_tpu"
             or m.startswith("copilot_for_consensus_tpu."))
print(len([m for m in sys.modules
           if m.startswith("copilot_for_consensus_tpu_torch")]))
assert not bad, bad
"""


def test_port_and_smoke_import_no_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15      # every module imported


def _imported_names(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_imports_in_source(path):
    for name in _imported_names(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "copilot_for_consensus_tpu"), \
            f"{path.name} imports {name}"


@pytest.mark.parametrize("name,replaces", [
    ("flash_attention", "copilot_for_consensus_tpu/ops/flash_attention.py"),
    ("int8_matmul", "copilot_for_consensus_tpu/ops/quant_matmul.py")])
def test_kernel_sources_carry_their_note(name, replaces):
    src = (PKG / "csrc" / f"{name}.cu").read_text()
    head = src.split("#include")[0]
    assert f"Replaces: {replaces}" in head
    assert "What bounds it on this card" in head
    assert f'extern "C" int {name}_fwd' in src
    assert f'extern "C" const char* {name}_error' in src


def test_build_refuses_without_nvcc(monkeypatch, tmp_path):
    if shutil.which("nvcc") or pathlib.Path("/usr/local/cuda/bin/nvcc") \
            .exists():
        pytest.skip("nvcc is installed here")
    from copilot_for_consensus_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "cuda_kernels")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all()
    assert not _build._libs


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "alone"])
def test_chip_smoke_fails_without_a_card(alone, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
