# The port's driver factories: the summarizer, embedding and vector-store
# drivers it serves (the cuda ones on device "cpu" here), the ones it
# refuses (the JAX package's tpu drivers with a pointer to cuda, unserved
# options naming the ROADMAP item that brings them), the cuda drivers'
# schemas, and the adapter registry reaching the port's own modules.
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
from copilot_for_consensus_tpu_torch.embedding.cuda_provider import (
    CUDAEmbeddingProvider,
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
from copilot_for_consensus_tpu_torch.vectorstore.cuda import (
    CUDAVectorStore,
)
from copilot_for_consensus_tpu_torch.vectorstore.memory import (
    InMemoryVectorStore,
)
from copilot_for_consensus_tpu_torch.vectorstore.native import (
    NativeFlatVectorStore,
)

PKG = pathlib.Path(__file__).resolve().parent.parent / \
    "copilot_for_consensus_tpu_torch"
CUDA = {"driver": "cuda", "model": "tiny", "max_new_tokens": 4,
        "num_slots": 2, "max_len": 128, "device": "cpu"}


@pytest.mark.parametrize("key,value,item", [
    ("long_context", True, "item 6"),
    ("profile_dir", "/nowhere", "item 7")])
def test_cuda_driver_refuses_what_it_does_not_serve(key, value, item):
    with pytest.raises(NotImplementedError, match=f"Queue 1 {item}"):
        create_summarizer({**CUDA, key: value})


@pytest.mark.parametrize("key,value", [
    ("journal", {"path": ":memory:", "checkpoint_every": 3}),
    ("journal_path", ":memory:"),
    ("deadline_s", 5.0),
    ("kv_dtype", "float8_e4m3fn")])
def test_cuda_driver_serves_the_deployed_options(key, value):
    summ = create_summarizer({**CUDA, key: value})
    eng = summ.engine
    if key.startswith("journal"):
        assert eng.journal is not None and eng.journal.depth() == 0
        assert eng.journal.checkpoint_every == (
            3 if key == "journal" else 8)
    elif key == "deadline_s":
        assert summ.deadline_s == 5.0
    else:
        assert eng.kv_dtype == torch.float8_e4m3fn
        assert eng._cache["k"].dtype == torch.float8_e4m3fn


@pytest.mark.parametrize("key,value", [
    ("long_context", False), ("journal", None), ("journal_path", ""),
    ("deadline_s", None), ("profile_dir", ""), ("kv_dtype", ""),
    ("kv_dtype", "bfloat16")])
def test_cuda_driver_takes_the_defaults_of_those_options(key, value):
    assert isinstance(create_summarizer({**CUDA, key: value}),
                      CUDASummarizer)


def test_deployed_llm_block_builds_on_the_cuda_driver(tmp_path):
    # deploy/config/pipeline.json's llm block, its tpu drivers mapped to
    # cuda in memory (the file is read, never written), at the tiny
    # config on the CPU: nothing in it is refused
    path = PKG.parent / "deploy" / "config" / "pipeline.json"
    text = path.read_text()
    deployed = json.loads(text)
    mapped = {k: {**v, "driver": "cuda"} if isinstance(v, dict)
              and v.get("driver") == "tpu" else v
              for k, v in deployed.items()}
    llm = {**mapped["llm"], **{k: v for k, v in CUDA.items()
                               if k != "driver"},
           "journal": {**mapped["llm"]["journal"],
                       "path": str(tmp_path / "j.sqlite3")}}
    assert llm["driver"] == "cuda"
    summ = create_summarizer(llm)
    assert isinstance(summ, CUDASummarizer)
    assert summ.supervisor is True and summ.deadline_s == 300
    eng = summ.engine
    assert eng.journal.checkpoint_every == 8 and eng.telemetry is not None
    assert path.read_text() == text


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
    with pytest.raises(ValueError, match="'cuda'"):
        create_embedding_provider({"driver": "tpu"})
    with pytest.raises(ValueError, match="unknown embedding"):
        create_embedding_provider({"driver": "bogus"})


@pytest.mark.parametrize("driver", ["tpu", "native"])
def test_vector_store_drivers_not_ported_are_refused(driver):
    # the JAX package's tpu driver is refused with a pointer to cuda; the
    # native driver, refused until the store was ported, is now the copy
    if driver == "tpu":
        with pytest.raises(ValueError, match="'cuda'"):
            create_vector_store({"driver": driver})
    else:
        assert isinstance(create_vector_store({"driver": driver}),
                          NativeFlatVectorStore)


def test_cuda_embedding_driver_builds_on_the_cpu():
    prov = create_embedding_provider({"driver": "cuda", "model": "tiny",
                                      "batch_size": 4, "device": "cpu"})
    assert isinstance(prov, CUDAEmbeddingProvider)
    assert prov.engine.device.type == "cpu"
    assert prov.engine.batch_size == 4 and prov.dimension == 64
    assert prov.model_name == "cuda:tiny"
    vecs = prov.embed_batch(["rough consensus", "running code"])
    assert len(vecs) == 2 and len(vecs[0]) == 64
    assert prov.embed("rough consensus") == vecs[0]


def test_cuda_vector_store_driver_builds_on_the_cpu():
    store = create_vector_store({"driver": "cuda", "dimension": 4,
                                 "index": "ivf", "device": "cpu"})
    assert isinstance(store, CUDAVectorStore)
    assert store.device.type == "cpu" and store._index_kind == "ivf"
    store.add_embedding("a", [1.0, 0.0, 0.0, 0.0])
    assert [r.id for r in store.query([1.0, 0.1, 0.0, 0.0])] == ["a"]


@pytest.mark.parametrize("mesh", [2, 4, "8"])
def test_cuda_vector_store_refuses_a_mesh_of_several_cards(mesh):
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        create_vector_store({"driver": "cuda", "mesh": mesh,
                             "device": "cpu"})


@pytest.mark.parametrize("make", [
    lambda: create_embedding_provider({"driver": "cuda", "model": "tiny"}),
    lambda: create_vector_store({"driver": "cuda"})],
    ids=["embedding", "vector_store"])
def test_cuda_drivers_without_a_device_need_the_card(make):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()


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
    ("embedding_backend", ["azure_openai", "cuda", "mock", "openai"]),
    ("vector_store", ["azure_ai_search", "cuda", "memory", "native"])])
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


#: the deployed llm block's keys (deploy/config/pipeline.json) that the
#: cuda schema documents and the tpu schema takes only as additional
#: properties
LLM_DEPLOYED_KEYS = {
    "supervisor": {"type": ["boolean", "object", "null"], "default": None},
    "deadline_s": {"type": ["number", "null"], "default": None},
    "journal": {"type": ["object", "string", "null"], "default": None,
                "properties": {"path": {"type": "string"},
                               "checkpoint_every": {"type": "integer",
                                                    "minimum": 1}}},
    "journal_path": {"type": "string", "default": ""}}


def test_cuda_schema_is_the_tpu_schema_with_a_device():
    _check_cuda_schema("llm_backend", LLM_DEPLOYED_KEYS)


@pytest.mark.parametrize("kind", ["embedding_backend", "vector_store"])
def test_cuda_retrieval_schema_is_the_tpu_schema_with_a_device(kind):
    _check_cuda_schema(kind)


def _check_cuda_schema(kind, extra=None):
    root = PKG / "schemas" / "configs" / "adapters" / kind
    tpu = json.loads((root / "tpu.schema.json").read_text())
    cuda = json.loads((root / "cuda.schema.json").read_text())
    assert cuda["properties"].pop("device") == {"type": "string",
                                                "default": "cuda"}
    for key, want in (extra or {}).items():
        assert key not in tpu["properties"]
        assert cuda["properties"].pop(key) == want
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
    # the deployed block's resilience keys, and their wrong types
    deployed = {**CUDA, "supervisor": True, "deadline_s": 300,
                "journal": {"path": "/data/j.sqlite3", "checkpoint_every": 8}}
    validate_json(deployed, name, provider)
    for wrong in ({"deadline_s": "soon"}, {"journal": 3},
                  {"journal": {"checkpoint_every": 0}}):
        with pytest.raises(SchemaValidationError):
            validate_json({**deployed, **wrong}, name, provider)


@pytest.mark.parametrize("kind,config,bad", [
    ("embedding_backend", {"driver": "cuda", "model": "minilm-l6",
                           "device": "cpu"}, {"batch_size": "many"}),
    ("vector_store", {"driver": "cuda", "dtype": "float32",
                      "device": "cpu"}, {"dimension": "wide"})])
def test_cuda_retrieval_schemas_validate_a_cuda_config(kind, config, bad):
    provider = FileSchemaProvider()
    name = f"configs/adapters/{kind}/cuda"
    validate_json(config, name, provider)
    for wrong in ({**config, "driver": "tpu"}, {**config, **bad}):
        with pytest.raises(SchemaValidationError):
            validate_json(wrong, name, provider)


def test_service_collector_attach_is_a_no_op_without_telemetry():
    # SummarizationService re-points engine telemetry at its collector;
    # an engine built with telemetry=False has none to re-point
    from copilot_for_consensus_tpu_torch.engine.generation import (
        GenerationEngine,
    )
    from copilot_for_consensus_tpu_torch.engine.telemetry import (
        attach_service_collector,
    )
    from copilot_for_consensus_tpu_torch.models.configs import (
        decoder_config,
    )
    from copilot_for_consensus_tpu_torch.obs.metrics import InMemoryMetrics

    eng = GenerationEngine(decoder_config("tiny"), num_slots=2, max_len=128,
                           telemetry=False, device="cpu")
    summ = CUDASummarizer(engine=eng, max_new_tokens=4)
    assert attach_service_collector(summ, InMemoryMetrics()) == 0
    assert summ.engine.prefix_stats()["enabled"] is False


def test_service_collector_attach_repoints_the_engine_series():
    # the cuda driver's engine has telemetry on by default: the service's
    # collector then renders the copilot_engine_* series it emits
    from copilot_for_consensus_tpu_torch.engine.telemetry import (
        attach_service_collector,
    )
    from copilot_for_consensus_tpu_torch.obs.metrics import InMemoryMetrics

    summ = create_summarizer(CUDA)
    shared = InMemoryMetrics(namespace="copilot")
    assert attach_service_collector(summ, shared) == 1
    assert summ.engine.telemetry.metrics is shared
    summ.engine.generate([[5, 6, 7]], 3)
    body = shared.render_prometheus()
    assert 'copilot_engine_requests_total{engine="generation"' in body
    assert "copilot_engine_step_seconds_bucket" in body
