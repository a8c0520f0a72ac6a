# The port's profiler hooks (obs/profile.py, on torch.profiler): a trace
# file only where a directory is given, step annotations named
# "<kind>:<flight-recorder step>" around every dispatch of the engines, and
# the engines' and the summarizer's profile_dir.
import json

import numpy as np
import pytest
import torch

from copilot_for_consensus_tpu_torch.engine.embedding import EmbeddingEngine
from copilot_for_consensus_tpu_torch.engine.generation import (
    GenerationEngine,
)
from copilot_for_consensus_tpu_torch.engine.longctx import LongContextEngine
from copilot_for_consensus_tpu_torch.engine.scheduler import SchedulerConfig
from copilot_for_consensus_tpu_torch.models.configs import (
    decoder_config,
    encoder_config,
)
from copilot_for_consensus_tpu_torch.obs.profile import (
    maybe_profile,
    step_annotation,
)
from copilot_for_consensus_tpu_torch.summarization.base import ThreadContext
from copilot_for_consensus_tpu_torch.summarization.summarizer import (
    CUDASummarizer,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # tiny shapes: thousands of small ops a decode, which an intra-op
    # thread pool only slows, the more so beside other test workers
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _annotations(path) -> list[str]:
    """The user annotations (record_function ranges) of a trace file."""
    events = json.loads(open(path).read())["traceEvents"]
    return [e["name"] for e in events
            if e.get("cat") == "user_annotation"]


def _trace_files(d):
    return sorted(d.glob("trace-*.json"))


@pytest.mark.parametrize("trace_dir", [None, ""])
def test_no_directory_is_a_no_op(trace_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with maybe_profile(trace_dir) as out:
        torch.ones(3).sum()
    assert out is None and list(tmp_path.iterdir()) == []


def test_a_directory_gets_one_trace_a_capture(tmp_path):
    d = tmp_path / "a" / "b"
    for _ in range(2):
        with maybe_profile(str(d)) as out:
            with step_annotation("decode", 7):
                torch.ones(3).sum()
            with step_annotation("prefill"):
                pass
    files = _trace_files(d)
    assert len(files) == 2 and str(files[-1]) == out
    names = _annotations(files[0])
    assert "decode:7" in names and "prefill" in names


def test_step_annotation_on_the_cpu_needs_no_card(tmp_path):
    # NVTX only for a CUDA device; on the CPU the range alone
    with maybe_profile(str(tmp_path)) as out:
        with step_annotation("verify", 3, torch.device("cpu")):
            pass
    assert "verify:3" in _annotations(out)


ENGINE_KW = dict(num_slots=2, max_len=64, prefill_buckets=(16, 32),
                 decode_window=4, dtype="float32", device="cpu")


def test_generation_engine_traces_its_dispatches(tmp_path):
    eng = GenerationEngine(decoder_config("tiny"), profile_dir=str(tmp_path),
                           **ENGINE_KW)
    eng.generate([[5, 9, 13], list(range(40, 61))], max_new_tokens=9)
    (path,) = _trace_files(tmp_path)
    names = _annotations(path)
    # every dispatch the flight recorder holds is one annotation of the
    # same kind and step
    want = [f"{r.kind}:{r.seq}" for r in eng.telemetry.recorder.records()]
    assert want and want[0].startswith("prefill:")
    assert any(n.startswith("decode:") for n in want)
    assert [n for n in names if n in want] == want


def test_engine_without_a_directory_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    eng = GenerationEngine(decoder_config("tiny"), **ENGINE_KW)
    assert eng.profile_dir is None
    eng.generate([[5, 9, 13]], max_new_tokens=5)
    assert list(tmp_path.iterdir()) == []


def test_chunk_and_verify_dispatches_are_annotated(tmp_path):
    # chunked prefill (scheduler) and speculative verify: their own kinds
    eng = GenerationEngine(decoder_config("tiny"), profile_dir=str(tmp_path),
                           scheduler=SchedulerConfig(chunk_tokens=16),
                           spec_decode=True,
                           **{**ENGINE_KW, "max_len": 128,
                              "prefill_buckets": (16, 32, 64)})
    prompt = [7, 8, 9] * 20
    eng.generate([prompt], max_new_tokens=12)
    names = _annotations(_trace_files(tmp_path)[0])
    kinds = {n.split(":")[0] for n in names if ":" in n}
    assert {"prefill_chunk", "decode", "verify"} <= kinds
    assert {r.kind for r in eng.telemetry.recorder.records()} <= kinds


def test_long_engine_traces_prefill_and_decode(tmp_path):
    eng = LongContextEngine(decoder_config("tiny"), dtype="float32",
                            profile_dir=str(tmp_path), decode_window=4,
                            ctx_block=16, eos_id=-1, device="cpu")
    prompt = np.random.default_rng(1).integers(3, 512, size=200).tolist()
    eng.generate(prompt, max_new_tokens=9)
    names = _annotations(_trace_files(tmp_path)[0])
    recs = eng.telemetry.recorder.records()
    assert [r.kind for r in recs] == ["prefill", "decode", "decode"]
    want = [f"{r.kind}:{r.seq}" for r in recs]
    assert [n for n in names if n in want] == want


def test_embedding_dispatches_are_annotated(tmp_path):
    eng = EmbeddingEngine(encoder_config("tiny"), dtype="float32",
                          device="cpu")
    with maybe_profile(str(tmp_path)) as out:
        eng.embed_batch(["one text", "and another"])
    assert any(n.startswith("embed:") for n in _annotations(out))


def test_summarizer_profile_dir_reaches_both_engines(tmp_path):
    summ = CUDASummarizer("tiny", max_new_tokens=4, num_slots=2,
                          max_len=128, dtype="float32", quantize=False,
                          long_context=True, profile_dir=str(tmp_path),
                          device="cpu")
    assert summ.engine.profile_dir == summ.long_engine.profile_dir \
        == str(tmp_path)
    long = ThreadContext(thread_id="t", subject="s", participants=["a@x"],
                         message_count=2,
                         chunks=[{"chunk_id": "c", "text": "word " * 60}])
    short = ThreadContext(thread_id="u", subject="s", participants=[],
                          message_count=1,
                          chunks=[{"chunk_id": "d", "text": "ok"}])
    summ.engine.buckets = (128,)
    got = summ.summarize_batch([long, short])
    assert got[0].prompt_tokens > summ.engine.prompt_limit
    # one trace from the long engine's generate, one from the short's
    assert len(_trace_files(tmp_path)) == 2
