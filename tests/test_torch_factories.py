# The port's driver factories: the summarizer, embedding and vector-store
# drivers it serves, the ones it refuses (each naming the ROADMAP item that
# brings it), the cuda driver's schema, and the adapter registry reaching
# the port's own modules.
import json
import pathlib

import pytest
import torch

from copilot_for_consensus_tpu_torch.core import factory as core_factory
from copilot_for_consensus_tpu_torch.core.validation import (
    FileSchemaProvider,
    SchemaValidationError,
    validate_json,
)
from copilot_for_consensus_tpu_torch.embedding.base import (
    MockEmbeddingProvider,
)
from copilot_for_consensus_tpu_torch.embedding.factory import (
    create_embedding_provider,
)
from copilot_for_consensus_tpu_torch.summarization.base import (
    MockSummarizer,
)
from copilot_for_consensus_tpu_torch.summarization.factory import (
    create_summarizer,
)
from copilot_for_consensus_tpu_torch.summarization.openai_summarizer import (
    OpenAISummarizer,
)
from copilot_for_consensus_tpu_torch.summarization.summarizer import (
    CUDASummarizer,
)
from copilot_for_consensus_tpu_torch.vectorstore.factory import (
    create_vector_store,
)
from copilot_for_consensus_tpu_torch.vectorstore.memory import (
    InMemoryVectorStore,
)

PKG = pathlib.Path(__file__).resolve().parent.parent / \
    "copilot_for_consensus_tpu_torch"
CUDA = {"driver": "cuda", "model": "tiny", "max_new_tokens": 4,
        "num_slots": 2, "max_len": 128, "device": "cpu"}


@pytest.mark.parametrize("key,value,item", [
    ("long_context", True, "item 6"),
    ("journal", {"path": "/nowhere"}, "item 4"),
    ("journal_path", "/nowhere", "item 4"),
    ("deadline_s", 5.0, "item 4"),
    ("profile_dir", "/nowhere", "item 7"),
    ("kv_dtype", "float8_e4m3fn", "item 4")])
def test_cuda_driver_refuses_what_it_does_not_serve(key, value, item):
    with pytest.raises(NotImplementedError, match=f"Queue 1 {item}"):
        create_summarizer({**CUDA, key: value})


@pytest.mark.parametrize("key,value", [
    ("long_context", False), ("journal", None), ("journal_path", ""),
    ("deadline_s", None), ("profile_dir", ""), ("kv_dtype", ""),
    ("kv_dtype", "bfloat16")])
def test_cuda_driver_takes_the_defaults_of_those_options(key, value):
    assert isinstance(create_summarizer({**CUDA, key: value}),
                      CUDASummarizer)


def test_tpu_driver_is_refused_naming_cuda():
    with pytest.raises(ValueError, match="'cuda'"):
        create_summarizer({**CUDA, "driver": "tpu"})


def test_cuda_driver_builds_the_summarizer_it_is_asked_for():
    summ = create_summarizer({**CUDA, "quantize": "int4",
                              "supervisor": True})
    assert isinstance(summ, CUDASummarizer)
    eng = summ.engine
    assert eng.device.type == "cpu" and eng.quant_mode == "int4"
    assert (eng.num_slots, eng.max_len) == (2, 128)
    assert summ.max_new_tokens == 4 and summ.supervisor is True
    assert summ._model == "tiny"


def test_cuda_driver_without_a_device_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = {k: v for k, v in CUDA.items() if k != "device"}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_summarizer(cfg)


def test_other_llm_drivers():
    assert isinstance(create_summarizer(None), MockSummarizer)
    assert isinstance(create_summarizer({"driver": "openai",
                                         "base_url": "http://localhost:1"}),
                      OpenAISummarizer)
    with pytest.raises(ValueError, match="unknown llm_backend"):
        create_summarizer({"driver": "llamacpp"})


def test_embedding_drivers():
    assert isinstance(create_embedding_provider({"driver": "mock",
                                                 "dimension": 8}),
                      MockEmbeddingProvider)
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        create_embedding_provider({"driver": "tpu"})
    with pytest.raises(ValueError, match="unknown embedding"):
        create_embedding_provider({"driver": "bogus"})


@pytest.mark.parametrize("driver", ["tpu", "native"])
def test_vector_store_drivers_not_ported_are_refused(driver):
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        create_vector_store({"driver": driver})


def test_vector_store_drivers():
    assert isinstance(create_vector_store(None), InMemoryVectorStore)
    azure = create_vector_store({"driver": "azure_ai_search",
                                 "endpoint": "http://localhost:1",
                                 "index_name": "x", "api_key": "k",
                                 "dimension": 4})
    assert type(azure).__name__ == "AzureAISearchVectorStore"
    with pytest.raises(ValueError, match="unknown vector_store"):
        create_vector_store({"driver": "qdrant"})


@pytest.mark.parametrize("kind,drivers", [
    ("llm_backend", ["azure_openai", "cuda", "mock", "openai"]),
    ("embedding_backend", ["azure_openai", "mock", "openai"]),
    ("vector_store", ["azure_ai_search", "memory"])])
def test_registry_names_the_ports_drivers(kind, drivers):
    assert core_factory.available_drivers(kind) == drivers


def test_create_adapter_reaches_the_cuda_driver():
    summ = core_factory.create_adapter("llm_backend", CUDA)
    assert isinstance(summ, CUDASummarizer)


def test_registry_kind_modules_are_the_ports():
    # the registry names its modules in strings; a copy must name the
    # port's, or importlib would load the JAX package at run time
    for kind, module in core_factory._KIND_MODULES.items():
        assert module.startswith("copilot_for_consensus_tpu_torch."), kind


def test_cuda_schema_is_the_tpu_schema_with_a_device():
    root = PKG / "schemas" / "configs" / "adapters" / "llm_backend"
    tpu = json.loads((root / "tpu.schema.json").read_text())
    cuda = json.loads((root / "cuda.schema.json").read_text())
    assert cuda["properties"].pop("device") == {"type": "string",
                                                "default": "cuda"}
    assert cuda["properties"].pop("driver") == {"const": "cuda"}
    assert tpu["properties"].pop("driver") == {"const": "tpu"}
    assert cuda.pop("$id") == tpu.pop("$id").replace("tpu.schema",
                                                     "cuda.schema")
    assert cuda.pop("title") == tpu.pop("title").replace(": tpu", ": cuda")
    assert cuda == tpu


def test_cuda_schema_validates_a_cuda_config():
    provider = FileSchemaProvider()
    name = "configs/adapters/llm_backend/cuda"
    validate_json(CUDA, name, provider)
    with pytest.raises(SchemaValidationError):
        validate_json({**CUDA, "driver": "tpu"}, name, provider)
    with pytest.raises(SchemaValidationError):
        validate_json({**CUDA, "num_slots": "four"}, name, provider)


def test_service_collector_attach_is_a_no_op_without_telemetry():
    # SummarizationService re-points engine telemetry at its collector;
    # the port's engine has none yet (ROADMAP Queue 1 item 4)
    from copilot_for_consensus_tpu_torch.engine.telemetry import (
        attach_service_collector,
    )
    from copilot_for_consensus_tpu_torch.obs.metrics import InMemoryMetrics

    summ = create_summarizer(CUDA)
    assert attach_service_collector(summ, InMemoryMetrics()) == 0
    assert summ.engine.prefix_stats()["enabled"] is False
