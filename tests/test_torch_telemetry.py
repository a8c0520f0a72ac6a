# The engine's telemetry on the port (engine/telemetry.py, a copy of the
# JAX package's), against the JAX engine on the same weights in float32:
# on by default with the same exports; greedy streams with telemetry on
# equal those with it off and the JAX engine's; the flight recorder's
# steps equal the JAX engine's for the same work; prefix hits show in the
# spans; a failed generate dumps a flight record naming the requests in
# flight; the copied SummarizationService re-points the engine's
# copilot_engine_* series onto its collector. Telemetry reads host state
# only: a decode dispatch still makes exactly one device-to-host fetch.
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copilot_for_consensus_tpu.engine.generation import (
    GenerationEngine as JaxEngine,
)
from copilot_for_consensus_tpu.models import decoder as jdec
from copilot_for_consensus_tpu.models.configs import (
    decoder_config as jax_config,
)
from copilot_for_consensus_tpu_torch.checkpoint.bridge import (
    params_from_numpy,
)
from copilot_for_consensus_tpu_torch.engine.faults import (
    FaultPlan,
    FaultSpec,
    InjectedFault,
)
from copilot_for_consensus_tpu_torch.engine.generation import (
    GenerationEngine,
)
from copilot_for_consensus_tpu_torch.engine.telemetry import (
    EngineTelemetry,
    attach_service_collector,
)
from copilot_for_consensus_tpu_torch.models.configs import decoder_config
from copilot_for_consensus_tpu_torch.obs.metrics import (
    InMemoryMetrics,
    NoopMetrics,
)

#: the JAX package's telemetry test engine
KW = dict(num_slots=4, max_len=64, prefill_buckets=(16, 32))
PROMPTS = [[5, 9, 13], [40, 41, 42, 43, 44, 45, 46], [3, 4, 5]]


@functools.lru_cache(maxsize=None)
def _weights():
    cfg = jax_config("tiny")
    jp = jdec.init_params(jax.random.PRNGKey(7), cfg, dtype=jnp.float32)
    return cfg, jp, jax.tree.map(np.asarray, jp)


def _jax_engine(**kw):
    cfg, jp, _ = _weights()
    return JaxEngine(cfg, jp, dtype=jnp.float32, kv_dtype=jnp.float32,
                     attn_impl="xla", **{**KW, **kw})


def _engine(**kw):
    _, _, tree = _weights()
    return GenerationEngine(decoder_config("tiny"),
                            params_from_numpy(tree, "cpu", "float32"),
                            dtype="float32", device="cpu", **{**KW, **kw})


def test_engine_telemetry_default_on_and_exports():
    eng = _engine()
    assert eng.telemetry is not None            # on by default
    eng.submit([5, 6, 7], 6, correlation_id="evt-1")
    eng.submit([8, 9, 10, 11], 6, correlation_id="evt-2")
    for _ in range(30):
        eng.step()
        if not eng._active and not eng._queue:
            break
    tele = eng.telemetry
    comps = list(tele.completed)
    assert {t.correlation_id for t in comps} == {"evt-1", "evt-2"}
    for t in comps:
        assert t.ttft_s > 0 and t.e2e_s >= t.ttft_s
        assert t.admit_kind == "wave"
        assert t.new_tokens > 0
    kinds = {r.kind for r in tele.recorder.records()}
    assert "prefill" in kinds and "decode" in kinds
    body = tele.metrics.render_prometheus()
    assert "copilot_engine_ttft_seconds_bucket" in body
    assert 'copilot_engine_requests_total{engine="generation"' in body
    assert "copilot_engine_queue_depth" in body


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_greedy_equal_with_telemetry_on_and_off_and_jax(paged):
    kw = dict(kv_pool_blocks=40, prefill_chunk=16) if paged else {}
    on = _engine(telemetry=True, **kw).generate(PROMPTS, max_new_tokens=8)
    off_eng = _engine(telemetry=False, **kw)
    assert off_eng.telemetry is None
    off = off_eng.generate(PROMPTS, max_new_tokens=8)
    jax_kw = dict(kv_pool_blocks=40, prefill_chunk=16,
                  kv_kernel="pallas") if paged else {}
    ref = _jax_engine(telemetry=True, **jax_kw).generate(
        PROMPTS, max_new_tokens=8)
    for got in (on, off):
        assert [c.tokens for c in got] == [c.tokens for c in ref]
        assert [c.finish_reason for c in got] == \
            [c.finish_reason for c in ref]


def _steps(eng) -> list[tuple]:
    return [(r.kind, r.rows, r.batch, r.tokens, r.padded_tokens, r.route)
            for r in eng.telemetry.recorder.records()]


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_step_records_equal_the_jax_engines(paged):
    kw = dict(kv_pool_blocks=40, prefill_chunk=16) if paged else {}
    jax_kw = dict(kw, kv_kernel="pallas") if paged else {}
    prompts = PROMPTS + [list(range(60, 80)), [7, 7, 7, 7]]
    teng, jeng = _engine(**kw), _jax_engine(**jax_kw)
    teng.generate(prompts, max_new_tokens=10)
    jeng.generate(prompts, max_new_tokens=10)
    assert _steps(teng) == _steps(jeng)
    assert {s[5] for s in _steps(teng)} == {"kernel" if paged else ""}
    want = [(t.correlation_id, t.prompt_len, t.new_tokens, t.admit_kind,
             t.finish_reason) for t in jeng.telemetry.completed]
    assert [(t.correlation_id, t.prompt_len, t.new_tokens, t.admit_kind,
             t.finish_reason) for t in teng.telemetry.completed] == want


def test_prefix_cache_hits_show_in_spans():
    eng = _engine(kv_pool_blocks=40, prefill_chunk=8, prefix_cache_blocks=8)
    common = list(range(40, 56))                 # two full blocks
    p1 = common + [7, 8, 9]
    p2 = common + [10, 11, 12]
    eng.generate([p1], max_new_tokens=4)         # miss: fills the pool
    eng.generate([p2], max_new_tokens=4)         # hit: seeded admit
    tr = list(eng.telemetry.completed)[-1]
    assert tr.admit_kind == "seeded"
    assert tr.prefix_hit_tokens >= 16
    kinds = [r.kind for r in eng.telemetry.recorder.records()]
    assert "prefill_seeded" in kinds
    body = eng.telemetry.metrics.render_prometheus()
    assert "copilot_engine_prefix_hit_rate" in body
    assert "copilot_engine_kv_pool_free_blocks" in body
    assert 'copilot_engine_kv_route{engine="generation",route="kernel"}' \
        in body


def test_generate_failure_dumps_flight_record(tmp_path):
    eng = _engine()
    eng.telemetry.dump_dir = str(tmp_path)

    # sabotage the decode dispatch so the error path fires mid-generate
    def boom(*a, **k):
        raise RuntimeError("dispatch exploded")

    eng._decode_dispatch = boom
    with pytest.raises(RuntimeError, match="dispatch exploded"):
        eng.generate([[5, 6, 7]], max_new_tokens=8)
    dumps = list(tmp_path.glob("error-*.json"))
    assert dumps, "engine error did not auto-dump the flight recorder"
    data = json.loads(dumps[0].read_text())
    assert data["error"]["message"] == "dispatch exploded"
    assert data["in_flight"], "dump must name the requests in flight"


def test_injected_fault_is_counted():
    plan = FaultPlan(specs=[FaultSpec(kind="decode", at=1, count=1)])
    eng = _engine(faults=plan)
    eng.submit([5, 6, 7], 4)
    with pytest.raises(InjectedFault):
        for _ in range(5):
            eng.step()
    body = eng.telemetry.metrics.render_prometheus()
    assert 'copilot_engine_fault_injected_total{engine="generation",' \
        'kind="decode"' in body


def test_attach_service_collector_production_wiring():
    """The engine's telemetry must be re-pointed at the service's
    collector (what /metrics serves), or every copilot_engine_* panel
    watches series nobody emits."""
    class Holder:
        engine = _engine(num_slots=2)
        long_engine = None

    shared = InMemoryMetrics(namespace="copilot")
    assert attach_service_collector(Holder(), shared) == 1
    Holder.engine.generate([[5, 6, 7]], max_new_tokens=3)
    assert shared.histogram_stats("engine_ttft_seconds",
                                  {"engine": "generation"})["count"] == 1
    # a Noop collector must not replace the engine's renderable copy
    fresh = EngineTelemetry(engine="g2", num_slots=1)

    class H2:
        engine = type("E", (), {"telemetry": fresh})()

    assert attach_service_collector(H2(), NoopMetrics()) == 0
    assert isinstance(fresh.metrics, InMemoryMetrics)


def test_summarization_service_wires_engine_telemetry_and_reporter():
    from copilot_for_consensus_tpu_torch.obs.errors import (
        CollectingErrorReporter,
    )
    from copilot_for_consensus_tpu_torch.services.summarization import (
        SummarizationService,
    )
    from copilot_for_consensus_tpu_torch.summarization.summarizer import (
        CUDASummarizer,
    )

    summ = CUDASummarizer(engine=_engine(num_slots=2), max_new_tokens=3)
    shared = InMemoryMetrics(namespace="copilot")
    rep = CollectingErrorReporter()
    SummarizationService(publisher=None, store=None, summarizer=summ,
                         metrics=shared, error_reporter=rep)
    assert summ.engine.telemetry.metrics is shared
    assert summ.error_reporter is rep


class _Fetches:
    """Counts every device-to-host read a tensor method can make: the
    port's decode dispatch fetches its tokens with one ``.cpu()``; a
    ``.item()``, a ``.tolist()`` or a truth or number conversion would be
    another sync on the card, and so would ``torch.cuda.synchronize``."""

    NAMES = ("cpu", "item", "tolist", "__bool__", "__int__", "__float__",
             "__index__")

    def __init__(self, monkeypatch):
        self.calls: list[str] = []
        for name in self.NAMES:
            orig = getattr(torch.Tensor, name)
            monkeypatch.setattr(torch.Tensor, name, self._wrap(name, orig))
        monkeypatch.setattr(torch.cuda, "synchronize",
                            self._wrap("synchronize", lambda *a, **k: None))

    def _wrap(self, name, orig):
        def counted(*a, **k):
            self.calls.append(name)
            return orig(*a, **k)
        return counted


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_telemetry_adds_no_device_fetch(monkeypatch, paged):
    kw = dict(kv_pool_blocks=40, prefill_chunk=16) if paged else {}
    eng = _engine(telemetry=True, **kw)
    for p in PROMPTS:
        eng.submit(p, 24, correlation_id="f", deadline_s=600.0)
    fetches = _Fetches(monkeypatch)
    decode_once = eng._decode_once
    per_dispatch = []

    def counted_once():
        before = len(fetches.calls)
        decode_once()
        per_dispatch.append(fetches.calls[before:])

    eng._decode_once = counted_once
    while eng._active or eng._queue:
        eng.step()
    assert len(per_dispatch) >= 3
    # one fetch a dispatch, with telemetry, deadlines and gauges on
    assert all(calls == ["cpu"] for calls in per_dispatch), per_dispatch
    assert len(eng.telemetry.recorder.records()) > len(per_dispatch)
