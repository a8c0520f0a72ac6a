# The port stands alone: it and chip_smoke.py load neither JAX nor any
# module of the JAX package, its kernels are CUDA sources that name the TPU
# kernel they replace, and what needs the card refuses to run without one.
#
# tests/conftest.py imports jax into THIS process, so the import check runs
# in a fresh interpreter.
import ast
import pathlib
import re
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


@pytest.mark.parametrize("rel", [
    "models/encoder.py", "engine/embedding.py", "embedding/cuda_provider.py",
    "embedding/eval.py", "vectorstore/cuda.py", "vectorstore/ivf.py",
    "vectorstore/native.py"])
def test_the_retrieval_modules_are_among_the_checked_files(rel):
    # the import checks below run over every file of the package; the
    # retrieval half's modules are among them
    assert PKG / rel in PORT_FILES


@pytest.mark.parametrize("rel", [
    "engine/__init__.py", "engine/journal.py", "obs/ship.py",
    "tools/journal_storm.py"])
def test_the_journal_modules_are_among_the_checked_files(rel):
    # the request journal, the telemetry spool and the storm driver are
    # checked with every other file of the package
    assert PKG / rel in PORT_FILES


@pytest.mark.parametrize("rel", [
    "engine/roles.py", "engine/generation.py", "engine/prefix_cache.py",
    "models/decoder.py"])
def test_the_serving_role_modules_are_among_the_checked_files(rel):
    # the roles, piggyback prefill, the admission holds, the contiguous
    # prefix cache and the gather route are checked with every other file
    # of the package
    assert PKG / rel in PORT_FILES


@pytest.mark.parametrize("rel", [
    "engine/longctx.py", "obs/profile.py", "summarization/summarizer.py",
    "summarization/factory.py"])
def test_the_long_context_modules_are_among_the_checked_files(rel):
    # the long-context engine, the profiler hooks and the summarizer's long
    # route are checked with every other file of the package
    assert PKG / rel in PORT_FILES


@pytest.mark.parametrize("rel", [
    "models/moe.py", "models/configs.py", "checkpoint/hf.py",
    "checkpoint/bridge.py"])
def test_the_moe_modules_are_among_the_checked_files(rel):
    # the MoE FFN, the Mixtral configs and the Mixtral reader are checked
    # with every other file of the package
    assert PKG / rel in PORT_FILES


PARALLEL_MODULES = ["parallel/__init__.py", "parallel/mesh.py",
                    "parallel/multihost.py", "parallel/sharding.py",
                    "parallel/collectives.py"]


@pytest.mark.parametrize("rel", PARALLEL_MODULES)
def test_the_parallel_modules_are_among_the_checked_files(rel):
    # the mesh, the multihost join, the sharding rules and the collectives
    # are checked with every other file of the package
    assert PKG / rel in PORT_FILES


_PARALLEL_ALONE = """
import importlib, sys
for rel in sys.argv[1:]:
    name = rel.removesuffix(".py").removesuffix("/__init__").replace("/", ".")
    importlib.import_module("copilot_for_consensus_tpu_torch." + name)
from copilot_for_consensus_tpu_torch.parallel import build_mesh
assert build_mesh().size == 1
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "copilot_for_consensus_tpu"
             or m.startswith("copilot_for_consensus_tpu."))
assert not bad, bad
"""


def test_parallel_modules_import_without_jax():
    # each of them by name, in a fresh interpreter that never loads JAX
    out = subprocess.run([sys.executable, "-c", _PARALLEL_ALONE,
                          *PARALLEL_MODULES], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr


_STORM_ALONE = """
import sys
from copilot_for_consensus_tpu_torch.tools import journal_storm
d = sys.argv[1]
rc = journal_storm.main(["--journal", d + "/j.sqlite3", "--out",
                         d + "/out.jsonl", "--result", d + "/r.json",
                         "--requests", "2", "--new-tokens", "3",
                         "--spool", d + "/spool.sqlite3", "--device", "cpu"])
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "copilot_for_consensus_tpu"
             or m.startswith("copilot_for_consensus_tpu."))
assert rc == 0 and not bad, (rc, bad)
"""


def test_journal_storm_runs_without_jax(tmp_path):
    # the storm drives the port's engine, journal and spool end to end in
    # a fresh interpreter that never loads JAX
    out = subprocess.run([sys.executable, "-c", _STORM_ALONE, str(tmp_path)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert len((tmp_path / "out.jsonl").read_text().splitlines()) == 2


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


def _module_level_imports(path):
    """Imports that run when the module is imported: everywhere but inside
    a function body."""
    todo = list(ast.parse(path.read_text(), filename=str(path)).body)
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        todo.extend(ast.iter_child_nodes(node))


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_module_level_import_of_optional_packages(path):
    # the card's machine need not have these: the port reads checkpoints
    # with its own safetensors module and imports tokenizers only where an
    # HF tokenizer is loaded
    for name in _module_level_imports(path):
        assert name.split(".")[0] not in (
            "safetensors", "ml_dtypes", "tokenizers", "yaml"), \
            f"{path.name} imports {name} when it is imported"


@pytest.mark.parametrize("name,replaces", [
    ("flash_attention", "copilot_for_consensus_tpu/ops/flash_attention.py"),
    ("int8_matmul", "copilot_for_consensus_tpu/ops/quant_matmul.py"),
    ("paged_attention", "copilot_for_consensus_tpu/ops/paged_attention.py"),
    ("int4_matmul", "copilot_for_consensus_tpu/ops/quant_matmul.py"),
    ("w8a8_matmul", "copilot_for_consensus_tpu/ops/quant_matmul.py"),
    ("w4a8_matmul", "copilot_for_consensus_tpu/ops/quant_matmul.py"),
    ("probe_stream", "scripts/probe_stream.py"),
    # the Hopper bodies, headers of the library that launches them
    ("int4_wgmma.cuh", "copilot_for_consensus_tpu/ops/quant_matmul.py"),
    ("flash_wgmma.cuh", "copilot_for_consensus_tpu/ops/flash_attention.py"),
    ("flash_d32.cuh", "copilot_for_consensus_tpu/ops/flash_attention.py"),
    ("int8_wgmma.cuh", "copilot_for_consensus_tpu/ops/quant_matmul.py"),
    ("paged_decode.cuh", "copilot_for_consensus_tpu/ops/paged_attention.py"),
    ("paged_wgmma.cuh", "copilot_for_consensus_tpu/ops/paged_attention.py"),
    ("int4_stream.cuh", "copilot_for_consensus_tpu/ops/quant_matmul.py"),
    ("int8_stream.cuh", "copilot_for_consensus_tpu/ops/quant_matmul.py"),
    ("w4a8_wgmma.cuh", "copilot_for_consensus_tpu/ops/quant_matmul.py"),
    ("w4a8_stream.cuh", "copilot_for_consensus_tpu/ops/quant_matmul.py")])
def test_kernel_sources_carry_their_note(name, replaces):
    if name.endswith(".cuh"):
        head = (PKG / "csrc" / name).read_text().split("#pragma once")[0]
        assert f"Replaces: {replaces}" in head
        assert "What bounds it on this card" in head
        return
    src = (PKG / "csrc" / f"{name}.cu").read_text()
    head = src.split("#include")[0]
    assert f"Replaces: {replaces}" in head
    assert "What bounds it on this card" in head
    assert f'extern "C" int {name}_fwd' in src
    assert f'extern "C" const char* {name}_error' in src


def _includes(path):
    return re.findall(r'^#include "([^"]+)"', path.read_text(), re.M)


def test_every_source_is_built_and_bound():
    from copilot_for_consensus_tpu_torch.ops import _build

    csrc = PKG / "csrc"
    sources = sorted(p.stem for p in csrc.glob("*.cu"))
    assert sorted(_build.SIGNATURES) == sources
    # every header reaches a built source, directly or through another
    # header, and every header a source includes exists
    reached, todo = set(), [csrc / f"{n}.cu" for n in sources]
    while todo:
        for inc in _includes(todo.pop()):
            assert (csrc / inc).exists(), inc
            if inc not in reached:
                reached.add(inc)
                todo.append(csrc / inc)
    assert reached == {p.name for p in csrc.glob("*.cuh")}


@pytest.mark.parametrize("name,bound", [
    ("int8_wgmma.cuh", "bound by operations on the bf16 tensor cores"),
    ("paged_decode.cuh", "bound by the bytes of the attended positions"),
    ("paged_wgmma.cuh", "bound by bytes"),
    ("int8_stream.cuh", "bound by reading the int8 bytes once"),
    ("w4a8_wgmma.cuh", "bound by operations on the int8 tensor cores"),
    ("w4a8_stream.cuh", "bound by reading the packed bytes once")])
def test_new_bodies_state_their_bound_and_design(name, bound):
    # K2's tiled path is bound by operations, K3 by bytes in both regimes;
    # each note says so and what its design does about it
    head = (PKG / "csrc" / name).read_text().split("#pragma once")[0]
    assert bound in " ".join(head.replace("//", " ").split())
    assert "The design" in head


@pytest.mark.parametrize("lib,entry", [
    ("int4_matmul", "int4_matmul_wgmma_fwd"),
    ("flash_attention", "flash_attention_wgmma_fwd"),
    ("int8_matmul", "int8_matmul_wgmma_fwd"),
    ("paged_attention", "paged_attention_decode_fwd"),
    ("paged_attention", "paged_attention_seeded_fwd"),
    ("int4_matmul", "int4_matmul_stream_fwd"),
    ("int8_matmul", "int8_matmul_stream_fwd"),
    ("w4a8_matmul", "w4a8_matmul_wgmma_fwd"),
    ("w4a8_matmul", "w4a8_matmul_stream_fwd")])
def test_wgmma_bodies_have_their_own_entry(lib, entry):
    # the wrapper picks a body by calling its entry; the entry is bound with
    # its argument types and defined in the library's source
    from copilot_for_consensus_tpu_torch.ops import _build

    assert entry in _build.SIGNATURES[lib]
    assert f'extern "C" int {entry}(' in (PKG / "csrc" / f"{lib}.cu") \
        .read_text()


def test_build_target_follows_shared_headers(monkeypatch, tmp_path):
    from copilot_for_consensus_tpu_torch.ops import _build

    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._target("k")
    (tmp_path / "common.cuh").write_text("// v2\n")
    assert _build._target("k") != first


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
