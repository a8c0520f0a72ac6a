# The retrieval half of the port as a whole, on the CPU: build_pipeline of
# both packages over the fixture mbox, with the mock summarizer in both so
# that only retrieval differs — embedding "tpu" (JAX) or "cuda" (the port,
# device "cpu") reading one tiny BERT directory with a WordPiece
# tokenizer.json, vector store "tpu" or "cuda", flat, f32 — store the same
# chunk vectors (within 1e-5), retrieve the same chunk ids and write the
# same report citations; the pipeline on the port's drivers loads no JAX at
# run time; and an encoder trained by the JAX package, carried across,
# ranks the labeled fixture through the port's engine and store above the
# reference's recall bar (recall@10 > 0.8 and > the hash baseline + 0.3).
import pathlib
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from copilot_for_consensus_tpu.services import runner as jrunner
from copilot_for_consensus_tpu_torch.embedding.eval import (
    recall_at_k,
    synthetic_fixture,
    train_encoder_on_fixture,
)
from copilot_for_consensus_tpu_torch.services import runner as trunner

ROOT = pathlib.Path(__file__).resolve().parent.parent
MBOX = ROOT / "tests" / "fixtures" / "ietf-sample.mbox"


@pytest.fixture(scope="module")
def bert_dir(tmp_path_factory):
    """A tiny BERT (64 wide, 2 heads of 32, 2 layers, random weights from
    a seed) and a WordPiece tokenizer.json whose vocabulary is the fixture
    mbox's words, so chunks tokenize to distinct ids."""
    transformers = pytest.importorskip("transformers")
    tk = pytest.importorskip("tokenizers")
    vocab = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3}
    for w in sorted(set(re.findall(r"[a-z]+", MBOX.read_text().lower()))):
        vocab.setdefault(w, len(vocab))
    out = tmp_path_factory.mktemp("bert")
    torch.manual_seed(0)
    transformers.BertModel(transformers.BertConfig(
        vocab_size=len(vocab), hidden_size=64, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=96,
        max_position_embeddings=512, type_vocab_size=2)).save_pretrained(
            out, safe_serialization=True)
    tok = tk.Tokenizer(tk.models.WordPiece(vocab, unk_token="[UNK]"))
    tok.normalizer = tk.normalizers.BertNormalizer(lowercase=True)
    tok.pre_tokenizer = tk.pre_tokenizers.BertPreTokenizer()
    tok.post_processor = tk.processors.TemplateProcessing(
        single="[CLS] $A [SEP]", pair="[CLS] $A [SEP] $B [SEP]",
        special_tokens=[("[CLS]", 2), ("[SEP]", 3)])
    tok.save(str(out / "tokenizer.json"))
    return str(out)


def _run(runner, config):
    p = runner.build_pipeline(config)
    p.ingestion.create_source({"source_id": "s", "name": "s",
                               "fetcher": "local", "location": str(MBOX)})
    return p, p.ingest_and_run("s")


@pytest.fixture(scope="module")
def pipelines(bert_dir):
    jax_p = _run(jrunner, {
        "embedding": {"driver": "tpu", "checkpoint": bert_dir},
        "vector_store": {"driver": "tpu", "dtype": "float32"}})
    port_p = _run(trunner, {
        "embedding": {"driver": "cuda", "checkpoint": bert_dir,
                      "device": "cpu"},
        "vector_store": {"driver": "cuda", "dtype": "float32",
                         "device": "cpu"}})
    return jax_p, port_p


def _inner(store):
    while hasattr(store, "inner"):
        store = store.inner
    return store


def test_the_port_pipeline_runs_on_its_own_drivers(pipelines, bert_dir):
    (_, jstats), (p, stats) = pipelines
    from copilot_for_consensus_tpu_torch.embedding.cuda_provider import (
        CUDAEmbeddingProvider,
    )
    from copilot_for_consensus_tpu_torch.vectorstore.cuda import (
        CUDAVectorStore,
    )

    assert isinstance(p.embedding.provider, CUDAEmbeddingProvider)
    assert p.embedding.provider.engine.device.type == "cpu"
    store = _inner(p.vector_store)
    assert isinstance(store, CUDAVectorStore)
    assert store.device.type == "cpu" and store.dimension == 64
    assert stats == jstats
    assert stats["reports"] == stats["threads"] >= 3
    assert store.count() == stats["chunks"]
    assert store.last_query_stats["route"] in ("flat", "host")


def test_stored_chunk_vectors_equal_the_jax_pipeline(pipelines):
    (jp, _), (tp, _) = pipelines
    chunks = sorted(c["chunk_id"] for c in tp.store.query_documents(
        "chunks", {}))
    assert chunks == sorted(c["chunk_id"] for c in jp.store.query_documents(
        "chunks", {}))
    jstore, tstore = _inner(jp.vector_store), _inner(tp.vector_store)
    for cid in chunks:
        (jv, jmeta), (tv, tmeta) = jstore.get(cid), tstore.get(cid)
        np.testing.assert_allclose(tv, jv, atol=1e-5, rtol=0)
        assert tmeta == jmeta


def test_retrieved_chunk_ids_equal_the_jax_pipeline(pipelines):
    (jp, _), (tp, _) = pipelines
    jstore, tstore = _inner(jp.vector_store), _inner(tp.vector_store)
    texts = [m["body"][:200] for m in tp.store.query_documents("messages",
                                                               {})]
    texts += ["consensus on the draft", "rough consensus and running code"]
    jq = jp.embedding.provider.embed_batch(texts)
    tq = tp.embedding.provider.embed_batch(texts)
    np.testing.assert_allclose(tq, jq, atol=1e-5, rtol=0)
    for flt in (None, {"thread_id": tp.store.query_documents(
            "threads", {})[0]["thread_id"]}):
        want = jstore.query_batch(jq, top_k=5, flt=flt)
        got = tstore.query_batch(tq, top_k=5, flt=flt)
        assert [[h.id for h in g] for g in got] == \
            [[h.id for h in w] for w in want]


def test_report_citations_equal_the_jax_pipeline(pipelines):
    (jp, _), (tp, _) = pipelines

    def citations(p):
        return {r["thread_id"]: [c["chunk_id"] for c in r["citations"]]
                for r in p.store.query_documents("reports", {})}

    got = citations(tp)
    assert got == citations(jp)
    assert all(got.values())


def test_report_search_equals_the_jax_pipeline(pipelines):
    (jp, _), (tp, _) = pipelines
    for words in ("consensus", "draft adoption"):
        want = jp.reporting.search_reports(words)
        got = tp.reporting.search_reports(words)
        assert [h["thread_id"] for h in got] == \
            [h["thread_id"] for h in want]
        assert got


_RUN_ALONE = """
import sys
from copilot_for_consensus_tpu_torch.services.runner import build_pipeline
p = build_pipeline({
    "embedding": {"driver": "cuda", "checkpoint": sys.argv[1],
                  "device": "cpu"},
    "vector_store": {"driver": "cuda", "index": "ivf", "device": "cpu"}})
p.ingestion.create_source({"source_id": "s", "name": "s",
                           "fetcher": "local", "location": sys.argv[2]})
stats = p.ingest_and_run("s")
assert stats["reports"] == stats["threads"] >= 3, stats
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "copilot_for_consensus_tpu"
             or m.startswith("copilot_for_consensus_tpu."))
assert not bad, bad
print("reports", stats["reports"])
"""


def test_retrieval_pipeline_loads_no_jax_at_run_time(bert_dir):
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_RUN_ALONE), bert_dir,
         str(MBOX)], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-1] != "0"


# -- the recall gate through the port ------------------------------------

def test_a_jax_trained_encoder_meets_the_recall_bar_on_the_port():
    """The reference's retrieval-quality bar (its test is in the slow lane;
    this one is not): a contrastively trained encoder ranks the labeled
    fixture far above a random-weight hashed baseline. The JAX package
    trains (the port has no trainer yet, ROADMAP Queue 1 item 6); its
    weights are carried across, and the port's engine and store rank."""
    import jax

    from copilot_for_consensus_tpu.embedding.eval import (
        train_encoder_on_fixture as jax_train,
    )
    from copilot_for_consensus_tpu_torch.checkpoint.bridge import (
        params_from_numpy,
    )
    from copilot_for_consensus_tpu_torch.engine.embedding import (
        EmbeddingEngine,
    )
    from copilot_for_consensus_tpu_torch.engine.tokenizer import (
        HashWordTokenizer,
    )
    from copilot_for_consensus_tpu_torch.models.configs import (
        EncoderConfig,
    )

    fixture = synthetic_fixture(n_topics=4, docs_per_topic=6,
                                queries_per_topic=3, seed=0)
    base_cfg = EncoderConfig(name="hash-baseline", vocab_size=1024,
                             d_model=32, n_layers=1, n_heads=4, d_ff=64,
                             max_positions=32)
    baseline = EmbeddingEngine(
        base_cfg, tokenizer=HashWordTokenizer(base_cfg.vocab_size),
        dtype=torch.float32, device="cpu")
    base = recall_at_k(baseline.embed_batch, fixture, ks=(10,),
                       device="cpu")

    from copilot_for_consensus_tpu.models.configs import (
        EncoderConfig as JaxEncoderConfig,
    )

    jcfg, jparams, _, _ = jax_train(
        fixture, steps=40, batch=12,
        cfg=JaxEncoderConfig(name="tiny", vocab_size=1024, d_model=32,
                             n_layers=1, n_heads=4, d_ff=64,
                             max_positions=16))
    cfg = EncoderConfig(**vars(jcfg))
    trained = EmbeddingEngine(
        cfg, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu",
                               torch.float32),
        tokenizer=HashWordTokenizer(cfg.vocab_size), dtype=torch.float32,
        device="cpu")
    got = recall_at_k(trained.embed_batch, fixture, ks=(1, 5, 10),
                      device="cpu")
    assert got["recall@10"] > base["recall@10"] + 0.3, (base, got)
    assert got["recall@10"] > 0.8, got


def test_fixture_and_trainer_refusal():
    fx = synthetic_fixture(n_topics=2, docs_per_topic=3,
                           queries_per_topic=2, seed=1)
    assert len(fx.docs) == 6 and len(fx.queries) == 4
    assert all(len(q["relevant"]) == 3 for q in fx.queries)
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        train_encoder_on_fixture(fx)
