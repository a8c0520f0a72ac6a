# The port's copies of the JAX package's host modules stay copies. A copy
# is the JAX file with "copilot_for_consensus_tpu" replaced by
# "copilot_for_consensus_tpu_torch" everywhere, strings included; a cut copy
# is a stated line range of it; a swapped copy imports one module under the
# name of its port. Every other module of the port is on the
# list of ported modules, with the reason it is not a copy. A reviewer can
# then trust the ~80 copied files without reading them.
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF = ROOT / "copilot_for_consensus_tpu"
PORT = ROOT / "copilot_for_consensus_tpu_torch"

COPIES = """
archive/__init__.py archive/azure_blob.py archive/base.py archive/factory.py
bus/__init__.py bus/azure_servicebus.py bus/base.py bus/broker.py
bus/factory.py bus/faults.py bus/inproc.py bus/validating.py
consensus/__init__.py consensus/base.py consensus/factory.py
core/__init__.py core/config.py core/events.py core/factory.py core/ids.py
core/openai_compat.py core/retry.py core/startup.py core/validation.py
embedding/__init__.py embedding/openai_provider.py
engine/__init__.py engine/async_runner.py engine/faults.py
engine/journal.py engine/telemetry.py engine/tokenizer.py
fetch/__init__.py fetch/base.py fetch/factory.py
obs/__init__.py obs/azure_monitor.py obs/errors.py obs/factory.py
obs/logging.py obs/metrics.py obs/ship.py obs/trace.py
security/__init__.py security/factory.py security/secrets.py
services/__init__.py services/base.py services/chunking.py
services/embedding.py services/ingestion.py services/orchestrator.py
services/parsing.py services/pool.py services/reporting.py
services/runner.py services/summarization.py
storage/__init__.py storage/azure_cosmos.py storage/base.py
storage/factory.py storage/memory.py storage/registry.py storage/sqlite.py
storage/validating.py
summarization/__init__.py summarization/base.py
text/__init__.py text/chunkers.py text/drafts.py text/factory.py
text/mbox.py text/normalizer.py text/threads.py
tools/__init__.py tools/retry_job.py
vectorstore/__init__.py vectorstore/_inverted.py
vectorstore/azure_ai_search.py vectorstore/base.py vectorstore/memory.py
vectorstore/native.py
""".split()

#: files copied byte for byte (no package name in them)
VERBATIM = ["vectorstore/_native/topk.cpp"]

#: copies that import one module under the name of its port: (JAX
#: module, port module), both relative to the package
SWAPS = {
    # the prompt template comes from TPUSummarizer's port
    "summarization/openai_summarizer.py": ("summarization.tpu_summarizer",
                                           "summarization.summarizer"),
}

#: cut copies: the JAX file's lines [first, last] (1-based, inclusive)
CUTS = {
    # without the shardcheck contract block (:689-753), which imports
    # analysis.contracts and JAX
    "engine/scheduler.py": (1, 686),
    # without TPUEmbeddingProvider (:79-118), the JAX encoder engine's
    # driver (ROADMAP Queue 1 item 2)
    "embedding/base.py": (1, 76),
}

#: modules written for the port, not copied, and why
PORTED = {
    "__init__.py": "the port's own package docstring",
    "device.py": "the port's device resolution (None → the card)",
    "checkpoint/__init__.py": "re-exports the ported hf and native "
                              "halves, not train_state (item 6)",
    "checkpoint/bridge.py": "numpy or mapped trees to torch leaves on a "
                            "device; the JAX package has no counterpart",
    "checkpoint/safetensors.py": "stands in for the safetensors package "
                                 "and ml_dtypes",
    "checkpoint/hf.py": "torch leaves over the port's safetensors "
                        "reader",
    "checkpoint/native.py": "torch leaves over the port's safetensors "
                            "reader and writer",
    "embedding/factory.py": "the cuda driver; tpu refused with a pointer "
                            "to it",
    "embedding/cuda_provider.py": "CUDAEmbeddingProvider, the port of "
                                  "TPUEmbeddingProvider (embedding/base.py "
                                  "79-118)",
    "embedding/eval.py": "recall@k ranks through CUDAVectorStore; "
                         "train_encoder_on_fixture needs train.py (item 6)",
    "engine/embedding.py": "the embedding engine, in PyTorch",
    "models/encoder.py": "the sentence encoder, in PyTorch",
    "vectorstore/factory.py": "the cuda and native drivers; tpu refused "
                              "with a pointer to cuda",
    "vectorstore/cuda.py": "CUDAVectorStore, vectorstore/tpu.py in PyTorch "
                           "without the shardcheck contracts or a mesh",
    "vectorstore/ivf.py": "the IVF index, in PyTorch, on one card",
    "summarization/factory.py": "the cuda driver; tpu refused with a "
                                "pointer to it",
    "summarization/summarizer.py": "CUDASummarizer, TPUSummarizer's port",
    "engine/generation.py": "the engine, in PyTorch",
    "engine/longctx.py": "LongContextEngine on one device, in PyTorch, "
                         "without a mesh (item 6c) or the shardcheck "
                         "contracts",
    "obs/profile.py": "the profiler hooks on torch.profiler and NVTX",
    "engine/graphs.py": "CUDA graphs of the decode dispatch; no JAX "
                        "counterpart (jit per bucket)",
    "engine/kv_pool.py": "the paged pool, in PyTorch",
    "engine/prefix_cache.py": "the trie over its own pool or the shared "
                              "one, in PyTorch",
    "engine/roles.py": "RoleConfig and DisaggregatedEngine over torch "
                       "devices, one a role (roles over more wait for "
                       "item 6), without the hlocheck contracts",
    "engine/sampling.py": "sampling, in PyTorch",
    "engine/supervisor.py": "reads the roles' _handoff with getattr, calls "
                            "set_slot_cap behind hasattr, and calls "
                            "on_repaired; over a mesh of several ranks it "
                            "logs rank 0's verdicts, and FollowerSupervisor "
                            "applies them on the other ranks",
    "engine/mesh_runner.py": "the async runner over a dp×tp mesh: rank 0's "
                             "operation log and the follower loop; the JAX "
                             "package's one controller needs neither",
    "models/__init__.py": "the port's config exports",
    "models/configs.py": "the decoder and encoder configs the port serves "
                         "(no llama-3-8b)",
    "models/decoder.py": "the decoder, in PyTorch",
    "models/moe.py": "the MoE FFN, in PyTorch: a gather and scatter over "
                     "the capacity slots in place of the one-hot einsums",
    "models/layers.py": "the layers, in PyTorch",
    "models/quant.py": "quantization, in PyTorch",
    "ops/__init__.py": "the port's kernel wrappers",
    "ops/_build.py": "builds the CUDA sources with nvcc",
    "ops/attention.py": "attention, in PyTorch",
    "ops/flash_attention.py": "K1's wrapper and plain version",
    "ops/paged_attention.py": "K3's wrapper and plain version",
    "ops/probe_stream.py": "P's wrappers and plain versions",
    "ops/quant_matmul.py": "K2, K4, K5, K6's wrappers and plain versions",
    "parallel/__init__.py": "exports what parallel/ ports so far: no ring, "
                            "Ulysses or pipeline (items 6c.2, 6e)",
    "parallel/mesh.py": "the mesh on torch.distributed's DeviceMesh: a "
                        "rank's view (groups, coordinates, device), "
                        "without the shardcheck contracts",
    "parallel/multihost.py": "the join on torch.distributed "
                             "(init_process_group, NCCL or gloo)",
    "parallel/sharding.py": "the rules, and shard_pytree slicing a rank's "
                            "shard of each leaf, without the shardcheck "
                            "contracts",
    "parallel/collectives.py": "the collectives GSPMD inserts, written out; "
                               "no JAX counterpart",
    "scripts/__init__.py": "the port's scripts package",
    "scripts/flash_d32_variants.py": "times variants of K1's d32 body on "
                                     "the card; no JAX counterpart (the "
                                     "body is the port's own)",
    "scripts/probe_stream.py": "the weight-stream probe's driver on the "
                               "card",
    "tools/journal_storm.py": "builds the port's engine (the JAX one "
                              "imports JAX), on the card unless --device "
                              "cpu; adds --model, --quantize, --dtype and "
                              "--checkpoint-every for full-width storms",
}


def _renamed(text: str) -> str:
    return text.replace("copilot_for_consensus_tpu",
                        "copilot_for_consensus_tpu_torch")


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_the_jax_file(rel):
    assert (PORT / rel).read_text() == _renamed((REF / rel).read_text()), \
        f"{rel} drifted from the JAX package's file"


@pytest.mark.parametrize("rel", sorted(SWAPS))
def test_swapped_copy_equals_the_jax_file(rel):
    old, new = (_renamed(f"copilot_for_consensus_tpu.{m}")
                for m in SWAPS[rel])
    text = _renamed((REF / rel).read_text())
    assert old in text
    assert (PORT / rel).read_text() == text.replace(old, new)


@pytest.mark.parametrize("rel", sorted(CUTS))
def test_cut_copy_equals_its_line_range(rel):
    first, last = CUTS[rel]
    lines = (REF / rel).read_text().splitlines(keepends=True)
    assert (PORT / rel).read_text() == _renamed(
        "".join(lines[first - 1:last]))


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copy_equals_the_jax_file(rel):
    assert (PORT / rel).read_bytes() == (REF / rel).read_bytes()


def test_every_port_module_is_listed_once():
    files = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    lists = [set(COPIES), set(SWAPS), set(CUTS), set(PORTED)]
    assert sum(len(s) for s in lists) == len(set().union(*lists)), \
        "a module is on two lists"
    assert files == set().union(*lists)
    assert all(reason for reason in PORTED.values())


#: the cuda drivers' schemas, which the JAX package does not have
CUDA_SCHEMAS = {f"configs/adapters/{kind}/cuda.schema.json"
                for kind in ("llm_backend", "embedding_backend",
                             "vector_store")}


def test_schemas_are_copies_plus_the_cuda_driver():
    ref = {str(p.relative_to(REF / "schemas")): p
           for p in (REF / "schemas").rglob("*.json")}
    port = {str(p.relative_to(PORT / "schemas")): p
            for p in (PORT / "schemas").rglob("*.json")}
    assert set(port) == set(ref) | CUDA_SCHEMAS
    for rel, p in ref.items():
        assert port[rel].read_text() == _renamed(p.read_text()), rel
