# The port's pipeline entry (services/runner.build_pipeline over the port's
# copies of the host services) against the JAX package's, on the CPU: with
# mock drivers the two pipelines store the same documents for the fixture
# mbox; the scenarios of tests/test_services_pipeline.py hold on the port;
# and the cuda driver on tiny (device "cpu", a checkpoint the JAX package
# wrote) turns the mbox into cited reports, one a thread, sync and
# pipelined alike, from the same prompt ids as the JAX tpu driver.
import json
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from copilot_for_consensus_tpu import checkpoint as jck
from copilot_for_consensus_tpu.models import decoder as jdec
from copilot_for_consensus_tpu.models.configs import (
    decoder_config as jax_config,
)
from copilot_for_consensus_tpu.services import runner as jrunner
from copilot_for_consensus_tpu_torch.checkpoint.native import (
    save_byte_tokenizer,
)
from copilot_for_consensus_tpu_torch.core import events as ev
from copilot_for_consensus_tpu_torch.services import runner as trunner
from copilot_for_consensus_tpu_torch.summarization.summarizer import (
    CUDASummarizer,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
MBOX = str(ROOT / "tests" / "fixtures" / "ietf-sample.mbox")
COLLECTIONS = ("sources", "archives", "messages", "threads", "chunks",
               "summaries", "reports")
#: the fields that hold a wall-clock time or a duration: they differ
#: between any two runs; every other field must be equal
TIME_FIELDS = {"created_at", "last_fetch_at", "ingested_at", "parsed_at",
               "embedded_at", "generated_at", "generation_seconds",
               "published_at", "updated_at", "delivered_at"}


def _run(runner, config=None, source="ietf-test"):
    p = runner.build_pipeline(config)
    p.ingestion.create_source({"source_id": source, "name": source,
                               "fetcher": "local", "location": MBOX})
    return p, p.ingest_and_run(source)


def _docs(p) -> dict:
    def strip(doc):
        return {k: v for k, v in doc.items() if k not in TIME_FIELDS}

    return {c: sorted((strip(d) for d in p.store.query_documents(c, {})),
                      key=repr) for c in COLLECTIONS}


def test_mock_pipeline_documents_equal_the_jax_pipeline():
    jp, jstats = _run(jrunner)
    tp, tstats = _run(trunner)
    assert tstats == jstats
    assert tstats["threads"] >= 3 and tstats["reports"] == tstats["threads"]
    want, got = _docs(jp), _docs(tp)
    for c in COLLECTIONS:
        assert got[c] == want[c], c
    seen = {k for c in COLLECTIONS for d in tp.store.query_documents(c, {})
            for k in d}
    assert TIME_FIELDS & seen           # the named fields do occur


# -- the reference's pipeline scenarios on the port --------------------

@pytest.fixture
def pipeline():
    p = trunner.build_pipeline()
    p.ingestion.create_source({"source_id": "ietf-test",
                               "name": "ietf-test", "fetcher": "local",
                               "location": MBOX})
    return p


def test_end_to_end_fixture_mbox(pipeline):
    stats = pipeline.ingest_and_run("ietf-test")
    assert stats["archives"] == 1 and stats["messages"] > 0
    assert stats["chunks"] >= stats["messages"]
    assert stats["summaries"] == stats["reports"] == stats["threads"] > 0
    chunks = pipeline.store.query_documents("chunks", {})
    assert all(c["embedding_generated"] for c in chunks)
    assert pipeline.vector_store.count() == len(chunks)
    report = pipeline.reporting.get_reports(limit=1)[0]
    cited = report["citations"][0]["chunk_id"]
    assert pipeline.store.get_document("chunks", cited) is not None
    assert all("consensus" in s
               for s in pipeline.store.query_documents("summaries", {}))
    for th in pipeline.store.query_documents("threads", {}):
        assert th.get("summary_id")


def test_reingest_is_idempotent(pipeline):
    first = pipeline.ingest_and_run("ietf-test")
    assert pipeline.ingest_and_run("ietf-test") == first


def test_replayed_events_do_not_duplicate(pipeline):
    pipeline.ingest_and_run("ietf-test")
    stats = pipeline.reporting.stats()
    msg = pipeline.store.query_documents("messages", {}, limit=1)[0]
    archive = pipeline.store.query_documents("archives", {}, limit=1)[0]
    pub = pipeline.ingestion.publisher
    pub.publish(ev.ArchiveIngested(archive_id=archive["archive_id"],
                                   source_id="ietf-test"))
    pub.publish(ev.JSONParsed(message_doc_id=msg["message_doc_id"],
                              archive_id=msg["archive_id"],
                              thread_id=msg["thread_id"]))
    pipeline.drain()
    assert pipeline.reporting.stats() == stats


def test_source_cascade_delete(pipeline):
    pipeline.ingest_and_run("ietf-test")
    pipeline.ingestion.delete_source("ietf-test")
    pipeline.drain()
    stats = pipeline.reporting.stats()
    assert stats["archives"] == stats["messages"] == stats["chunks"] == 0
    assert pipeline.vector_store.count() == 0
    assert pipeline.store.get_document("sources", "ietf-test") is None


def test_failure_event_published_on_bad_archive(pipeline):
    failures = []
    pipeline.broker.bind("parsing.failed", failures.append)
    pipeline.parsing.publisher.publish(
        ev.ArchiveIngested(archive_id="missing-archive"))
    pipeline.drain()
    assert failures
    assert failures[0]["data"]["archive_id"] == "missing-archive"


def test_startup_requeue_resumes_stuck_documents(pipeline):
    pipeline.ingestion.trigger_source("ietf-test")
    pipeline.drain()
    chunk = pipeline.store.query_documents("chunks", {}, limit=1)[0]
    pipeline.store.update_document("chunks", chunk["chunk_id"],
                                   {"embedding_generated": False})
    pipeline.vector_store.delete([chunk["chunk_id"]])
    n = pipeline.vector_store.count()
    pipeline.startup()
    pipeline.drain()
    assert pipeline.vector_store.count() == n + 1
    assert pipeline.store.get_document(
        "chunks", chunk["chunk_id"])["embedding_generated"]


def test_semantic_search_finds_reports(pipeline):
    pipeline.ingest_and_run("ietf-test")
    msg = pipeline.store.query_documents("messages", {}, limit=1)[0]
    word = next((w for w in msg["body"].split() if len(w) > 5),
                msg["subject"].split()[0])
    hits = pipeline.reporting.search_reports(word)
    assert isinstance(hits, list) and hits


# -- the cuda driver on tiny, on the CPU --------------------------------

@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A native int8 tiny checkpoint written by the JAX package, with a
    byte-level tokenizer.json (ids equal to ByteTokenizer's)."""
    path = tmp_path_factory.mktemp("ckpt")
    jcfg = jax_config("tiny")
    tree = jax.tree.map(np.asarray, jdec.init_params(
        jax.random.PRNGKey(7), jcfg, dtype=jnp.float32))
    jck.save_native(path, jcfg, jck.quantize_tree(tree, mode="int8"))
    save_byte_tokenizer(path)
    return str(path)


def _llm(driver, ckpt, **kw):
    cfg = {"driver": driver, "model": "tiny", "checkpoint": ckpt,
           "max_new_tokens": 8, "num_slots": 4, "max_len": 256, **kw}
    if driver == "cuda":
        cfg["device"] = "cpu"
    return cfg


def _recording(pipeline) -> list:
    """Every prompt the pipeline's engine is given, in submit order."""
    eng = pipeline.summarization.summarizer.engine
    prompts, submit = [], eng.submit

    def recording_submit(prompt, *a, **kw):
        prompts.append(list(prompt))
        return submit(prompt, *a, **kw)

    eng.submit = recording_submit
    return prompts


def _cuda_run(ckpt, pipelined):
    p = trunner.build_pipeline({"llm": _llm("cuda", ckpt,
                                            pipelined=pipelined),
                                "embedding": {"driver": "mock"}})
    prompts = _recording(p)
    p.ingestion.create_source({"source_id": "s", "name": "s",
                               "fetcher": "local", "location": MBOX})
    stats = p.ingest_and_run("s")
    assert p.summarization.in_flight == 0
    return p, stats, prompts


@pytest.fixture(scope="module")
def cuda_runs(ckpt):
    runs = {mode: _cuda_run(ckpt, mode == "pipelined")
            for mode in ("sync", "pipelined")}
    yield runs
    for p, _, _ in runs.values():
        p.summarization.summarizer.close()


@pytest.fixture(scope="module")
def jax_prompts(ckpt):
    p = jrunner.build_pipeline({"llm": _llm("tpu", ckpt),
                                "embedding": {"driver": "mock"}})
    prompts = _recording(p)
    p.ingestion.create_source({"source_id": "s", "name": "s",
                               "fetcher": "local", "location": MBOX})
    p.ingest_and_run("s")
    p.summarization.summarizer.close()
    return prompts


@pytest.mark.parametrize("mode", ["sync", "pipelined"])
def test_cuda_driver_reports_cite_stored_chunks(cuda_runs, ckpt, mode):
    p, stats, _ = cuda_runs[mode]
    summ = p.summarization.summarizer
    assert isinstance(summ, CUDASummarizer)
    assert summ.engine.device.type == "cpu"
    assert summ.engine.quant_mode == "int8"
    assert p.summarization.pipelined == (mode == "pipelined")
    assert stats["archives"] == 1
    assert stats["summaries"] == stats["reports"] == stats["threads"] >= 3
    reports = p.store.query_documents("reports", {})
    assert sorted(r["thread_id"] for r in reports) == sorted(
        t["thread_id"] for t in p.store.query_documents("threads", {}))
    for r in reports:
        assert r["citations"]
        for c in r["citations"]:
            assert p.store.get_document("chunks", c["chunk_id"]) is not None
    for s in p.store.query_documents("summaries", {}):
        assert s["model"] == f"cuda:checkpoint:{ckpt}"
        assert s["completion_tokens"] >= 1


def test_cuda_driver_sync_and_pipelined_give_the_same_reports(cuda_runs):
    def reports(p):
        return sorted(({k: v for k, v in r.items() if k not in TIME_FIELDS}
                       for r in p.store.query_documents("reports", {})),
                      key=repr)

    # (the prompts submitted may differ: in pipelined mode a thread whose
    # embeddings land in several waves can be summarized over part of its
    # context first and superseded, as in the JAX package)
    assert reports(cuda_runs["sync"][0]) == reports(cuda_runs["pipelined"][0])


def test_cuda_driver_prompts_equal_the_jax_tpu_driver(cuda_runs,
                                                      jax_prompts):
    got = cuda_runs["sync"][2]
    assert len(got) >= 3
    assert got == jax_prompts


def test_pipelined_crash_between_ack_and_store_recovers(ckpt):
    """The pipelined summarizer acks the bus before the summary is stored;
    a worker that dies there is recovered by the startup requeue, exactly
    once a thread."""
    p = trunner.build_pipeline({"llm": _llm("cuda", ckpt, pipelined=True),
                                "embedding": {"driver": "mock"}})
    p.ingestion.create_source({"source_id": "s", "name": "s",
                               "fetcher": "local", "location": MBOX})
    summ = p.summarization
    summ._ensure_harvester = lambda: None
    p.ingestion.trigger_source("s")
    p.broker.drain(None)
    assert summ.in_flight > 0
    lost = p.store.count_documents("threads")
    assert lost >= 3 and p.store.count_documents("summaries") == 0
    summ._in_flight.clear()
    del summ._ensure_harvester
    p.startup()
    p.drain()
    summaries = p.store.query_documents("summaries", {})
    assert len(summaries) == lost
    assert len({s["thread_id"] for s in summaries}) == lost
    p.startup()
    p.drain()
    assert p.store.count_documents("summaries") == lost
    runner = summ.summarizer._runner
    assert p.drain_engines(10.0) == {"summarization": True}
    assert summ.summarizer._runner is None and runner._thread is None
    summ.summarizer.close()


def test_configured_tenant_and_priority_are_served(ckpt):
    """A pipeline's tenancy block reaches summarize_async, which the copied
    service probes for tenant and priority: every thread is summarized and
    reported, and every engine request carries the configured identity
    (the journal row and a replay keep it)."""
    p = trunner.build_pipeline({
        "llm": _llm("cuda", ckpt, pipelined=True),
        "embedding": {"driver": "mock"},
        "tenancy": {"tenant": "ietf", "priority": "batch"}})
    summ = p.summarization
    assert {"tenant", "priority"} <= summ._async_kwargs
    eng = summ.summarizer.engine
    seen, submit = [], eng.submit

    def recording_submit(prompt, *a, **kw):
        seen.append((kw.get("tenant"), kw.get("priority")))
        return submit(prompt, *a, **kw)

    eng.submit = recording_submit
    failures = []
    p.broker.bind("summarization.failed", failures.append)
    p.ingestion.create_source({"source_id": "s", "name": "s",
                               "fetcher": "local", "location": MBOX})
    stats = p.ingest_and_run("s")
    summ.summarizer.close()
    threads = {t["thread_id"] for t in p.store.query_documents("threads", {})}
    assert not failures
    assert stats["threads"] == len(threads) >= 3
    assert stats["reports"] == len(threads)
    assert seen and set(seen) == {("ietf", "batch")}


def test_summarize_async_carries_a_tenant_and_a_priority(ckpt):
    summ = CUDASummarizer(checkpoint=ckpt, max_new_tokens=4, num_slots=4,
                          max_len=256, device="cpu", tenant="ietf",
                          priority="batch")
    from copilot_for_consensus_tpu_torch.summarization.base import (
        ThreadContext,
    )

    thread = ThreadContext(thread_id="t", subject="s", chunks=[])
    seen, submit = [], summ.engine.submit

    def recording_submit(prompt, *a, **kw):
        seen.append((kw.get("tenant"), kw.get("priority")))
        return submit(prompt, *a, **kw)

    summ.engine.submit = recording_submit
    waits = [summ.summarize_async(thread, tenant="acme",
                                  priority="interactive"),
             summ.summarize_async(thread)]
    assert all(w(60.0).completion_tokens >= 1 for w in waits)
    # a call's own identity overrides the summarizer's defaults
    assert seen == [("acme", "interactive"), ("ietf", "batch")]
    summ.close()


def _deployed_llm(ckpt, journal_path) -> dict:
    """deploy/config/pipeline.json's llm block (read, never written) on
    the cuda driver: the tiny checkpoint on the CPU, its journal moved
    under the test's directory, pipelined."""
    block = json.loads((ROOT / "deploy" / "config" / "pipeline.json")
                       .read_text())["llm"]
    assert block["driver"] == "tpu"
    assert {"supervisor", "deadline_s", "journal"} <= set(block)
    return {**block, **_llm("cuda", ckpt, pipelined=True),
            "journal": {**block["journal"], "path": str(journal_path)}}


def test_deployed_llm_block_serves_on_the_cuda_driver(ckpt, tmp_path):
    llm = _deployed_llm(ckpt, tmp_path / "engine-journal.sqlite3")
    p = trunner.build_pipeline({"llm": llm,
                                "embedding": {"driver": "mock"}})
    summ = p.summarization.summarizer
    eng = summ.engine
    assert summ.supervisor is True and summ.deadline_s == 300
    assert eng.journal is not None and eng.journal.checkpoint_every == 8
    assert eng.telemetry.metrics is p.metrics       # the service's
    p.ingestion.create_source({"source_id": "s", "name": "s",
                               "fetcher": "local", "location": MBOX})
    stats = p.ingest_and_run("s")
    assert summ.drain(30.0) is True
    threads = {t["thread_id"] for t in p.store.query_documents("threads", {})}
    assert stats["threads"] == len(threads) >= 3
    assert stats["reports"] == p.store.count_documents("reports") \
        == len(threads)
    m = p.metrics
    lb = {"engine": "generation"}
    assert m.histogram_stats("engine_queue_wait_seconds", lb)["count"] > 0
    assert m.histogram_stats("engine_step_seconds",
                             {**lb, "kind": "decode"})["count"] > 0
    assert "copilot_engine_requests_total" in m.render_prometheus()
    st = eng.journal_stats()
    assert st["depth"] == 0 and st["retired"] >= len(threads)


_RUN_ALONE = """
import sys
from copilot_for_consensus_tpu_torch.services.runner import build_pipeline
p = build_pipeline({"llm": {"driver": "cuda", "model": "tiny",
                            "checkpoint": sys.argv[1], "max_new_tokens": 4,
                            "num_slots": 4, "max_len": 256,
                            "device": "cpu", "pipelined": True}})
p.ingestion.create_source({"source_id": "s", "name": "s",
                           "fetcher": "local", "location": sys.argv[2]})
stats = p.ingest_and_run("s")
p.summarization.summarizer.close()
assert stats["reports"] == stats["threads"] >= 3, stats
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "copilot_for_consensus_tpu"
             or m.startswith("copilot_for_consensus_tpu."))
assert not bad, bad
print("reports", stats["reports"])
"""


def test_whole_pipeline_loads_no_jax_at_run_time(ckpt):
    # the copies name driver modules in strings (core/factory.py); a copy
    # that kept the JAX package's name there would import it at run time,
    # which no import-time check sees
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_RUN_ALONE), ckpt, MBOX],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-1] != "0"
