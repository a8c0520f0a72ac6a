# The port's on-device vector store (vectorstore/cuda.py, vectorstore/ivf.py)
# against the JAX package's TPUVectorStore and IVFIndex on the CPU: the flat
# route returns the JAX store's ids at f32 (distinct scores), single and
# batched, under selective and broad filters; writes, deletes and growth
# behave as the reference's tests say; .npz files load across the two
# packages both ways; the IVF index trains the JAX package's centroids and
# assignment, meets the reference's recall gate at 10k (recall@10 >= 0.95
# while scanning <= 15% of the lists) and keeps its invariants; the store
# emits its metric series; and the native copy builds and matches the
# memory driver.
import numpy as np
import pytest
import torch

from copilot_for_consensus_tpu.vectorstore.ivf import IVFIndex as JaxIVF
from copilot_for_consensus_tpu.vectorstore.ivf import IVFParams as JaxParams
from copilot_for_consensus_tpu.vectorstore.tpu import TPUVectorStore
from copilot_for_consensus_tpu_torch.obs.metrics import InMemoryMetrics
from copilot_for_consensus_tpu_torch.vectorstore.base import VectorStoreError
from copilot_for_consensus_tpu_torch.vectorstore.cuda import (
    VECTORSTORE_METRICS,
    CUDAVectorStore,
)
from copilot_for_consensus_tpu_torch.vectorstore.ivf import (
    IVFIndex,
    IVFParams,
    ListShardAllocator,
    next_pow2,
)
from copilot_for_consensus_tpu_torch.vectorstore.memory import (
    InMemoryVectorStore,
)
from copilot_for_consensus_tpu_torch.vectorstore.native import (
    NativeFlatVectorStore,
    load_native_lib,
)

DIM = 32


def _store(**cfg):
    return CUDAVectorStore({"dimension": DIM, "device": "cpu", **cfg})


def _clustered(n, clusters, dim=DIM, seed=0, noise=0.15):
    """The ANN preset's geometry: centers on the unit sphere, members
    center + gaussian noise."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((clusters, dim)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    which = rng.integers(0, clusters, size=n)
    pts = centers[which] + noise * rng.standard_normal(
        (n, dim), dtype=np.float32)
    return pts, centers, rng


def _fill(store, vecs, meta=None):
    store.add_embeddings(
        (f"v{i}", vecs[i], (meta(i) if meta else None))
        for i in range(len(vecs)))


def _ids(hits):
    return [h.id for h in hits]


def _thread(i):
    return {"thread_id": f"t{i % 5}", "seq": i}


# -- the flat route against the JAX store -------------------------------

@pytest.fixture(scope="module")
def flat_pair():
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((300, DIM)).astype(np.float32)
    jax_store = TPUVectorStore({"dimension": DIM, "dtype": "float32"})
    port = _store(dtype="float32")
    _fill(jax_store, vecs, _thread)
    _fill(port, vecs, _thread)
    return jax_store, port, rng.standard_normal((12, DIM)).astype(np.float32)


@pytest.mark.parametrize("flt", [None, {"thread_id": "t3"},
                                 {"thread_id": "t3", "seq": 8}],
                         ids=["none", "selective", "two_keys"])
def test_flat_ids_equal_the_jax_store(flat_pair, flt):
    jax_store, port, queries = flat_pair
    for q in queries:
        want = jax_store.query(q, top_k=7, flt=flt)
        got = port.query(q, top_k=7, flt=flt)
        assert _ids(got) == _ids(want)
        np.testing.assert_allclose([r.score for r in got],
                                   [r.score for r in want], atol=1e-5)
    assert port.last_query_stats["route"] == ("host" if flt else "flat")


def test_batched_flat_ids_equal_the_jax_store(flat_pair):
    jax_store, port, queries = flat_pair
    want = jax_store.query_batch(list(queries), top_k=9)
    got = port.query_batch(list(queries), top_k=9)
    assert [_ids(g) for g in got] == [_ids(w) for w in want]
    singles = [port.query(q, top_k=9) for q in queries]
    assert [_ids(g) for g in got] == [_ids(s) for s in singles]


def test_broad_filter_takes_the_device_route_and_equals_jax(monkeypatch):
    # a filter over more rows than the host limit runs the device route
    # with top-k escalation
    from copilot_for_consensus_tpu.vectorstore import tpu as jtpu
    from copilot_for_consensus_tpu_torch.vectorstore import cuda as tcuda

    monkeypatch.setattr(jtpu, "_SELECTIVE_HOST_LIMIT", 8)
    monkeypatch.setattr(tcuda, "_SELECTIVE_HOST_LIMIT", 8)
    rng = np.random.default_rng(5)
    vecs = rng.standard_normal((400, DIM)).astype(np.float32)
    meta = lambda i: {"group": "a" if i % 7 == 0 else "b"}  # noqa: E731
    jax_store = TPUVectorStore({"dimension": DIM, "dtype": "float32"})
    port = _store(dtype="float32")
    _fill(jax_store, vecs, meta)
    _fill(port, vecs, meta)
    queries = list(rng.standard_normal((6, DIM)).astype(np.float32))
    want = jax_store.query_batch(queries, top_k=10, flt={"group": "a"})
    got = port.query_batch(queries, top_k=10, flt={"group": "a"})
    assert [_ids(g) for g in got] == [_ids(w) for w in want]
    assert all(h.metadata["group"] == "a" for g in got for h in g)
    assert port.last_query_stats["route"] == "flat"


def test_bf16_scores_are_rounded_products_in_f32(flat_pair):
    # the default dtype scores as a bf16 product rounded, then f32: every
    # score is a bf16 value, within one bf16 step (2**-8 of a score below
    # 1) of the JAX store's, whose CPU product is not rounded; rounded
    # scores tie, so ranks are compared by score, not by id
    _, _, queries = flat_pair
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((300, DIM)).astype(np.float32)
    jax_store = TPUVectorStore({"dimension": DIM})
    port = _store()
    _fill(jax_store, vecs)
    _fill(port, vecs)
    for q in queries:
        want = [r.score for r in jax_store.query(q, top_k=10)]
        got = [r.score for r in port.query(q, top_k=10)]
        assert got == sorted(got, reverse=True)
        rounded = torch.tensor(got).to(torch.bfloat16).float().tolist()
        assert got == rounded
        np.testing.assert_allclose(got, want, atol=2.0 ** -8, rtol=0)


# -- writes, deletes, growth --------------------------------------------

def test_upsert_and_delete():
    rng = np.random.default_rng(0)
    store = _store()
    _fill(store, rng.normal(size=(10, DIM)), _thread)
    assert store.count() == 10
    newv = np.zeros(DIM)
    newv[0] = 1.0
    store.add_embedding("v3", newv, {"thread_id": "tX"})
    assert store.count() == 10
    assert _ids(store.query(newv, top_k=1)) == ["v3"]
    assert store.delete(["v3", "v4"]) == 2
    assert store.count() == 8 and store.get("v3") is None
    assert not {"v3", "v4"} & set(_ids(store.query(newv, top_k=8)))
    assert float(store._device[store._index["v3"]].abs().sum()) == 0.0


def test_delete_by_filter():
    store = _store()
    _fill(store, np.random.default_rng(0).normal(size=(50, DIM)), _thread)
    assert store.delete_by_filter({"thread_id": "t1"}) == 10
    assert store.count() == 40
    assert store.delete_by_filter({"thread_id": "t1"}) == 0


def test_growth_past_initial_capacity():
    store = _store()
    _fill(store, np.random.default_rng(0).normal(size=(100, DIM)))
    assert store.count() == 100 and store._device.shape[0] == 128
    q = np.random.default_rng(3).normal(size=DIM)
    assert len(store.query(q, top_k=10)) == 10


def test_an_upsert_twice_in_one_call_keeps_the_last():
    store = _store(dtype="float32")
    a, b = np.eye(DIM)[0], np.eye(DIM)[1]
    store.add_embeddings([("x", a, None), ("y", a, None)])
    store.add_embeddings([("x", a, None), ("x", b, None)])
    assert _ids(store.query(b, top_k=1)) == ["x"]
    np.testing.assert_array_equal(store._device[0].numpy(), b)


def test_dimension_mismatch_and_bad_config_raise():
    store = _store()
    store.add_embedding("a", np.ones(DIM))
    with pytest.raises(VectorStoreError, match="dimension mismatch"):
        store.add_embedding("b", np.ones(DIM + 1))
    with pytest.raises(VectorStoreError, match="unknown index"):
        _store(index="hnsw")
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        _store(mesh=4)
    assert _store(mesh="auto").query(np.ones(DIM)) == []


def test_the_store_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CUDAVectorStore({"dimension": DIM})


def test_empty_store_answers_every_query():
    assert _store().query_batch([np.ones(DIM)] * 3, top_k=3) == [[]] * 3


# -- persistence across the packages ------------------------------------

@pytest.mark.parametrize("index", ["flat", "ivf"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_npz_loads_across_packages(tmp_path, index, writer):
    vecs, _, rng = _clustered(400, 8, seed=9)
    cfg = {"dimension": DIM, "index": index, "ivf_nlist": 8,
           "ivf_nprobe": 8, "ivf_min_train": 64, "dtype": "float32"}
    jax_store = TPUVectorStore(cfg)
    port = _store(**cfg)
    src, dst = (jax_store, port) if writer == "jax" else (port, jax_store)
    _fill(src, vecs, _thread)
    src.delete(["v0", "v11"])
    want = _ids(src.query(vecs[5], top_k=5))      # trains an ivf index
    path = src.save(str(tmp_path / "store.npz"))
    assert dst.load(path) == 398
    assert _ids(dst.query(vecs[5], top_k=5)) == want
    assert dst.get("v0") is None and dst.get("v1")[1] == _thread(1)
    if index == "ivf":
        assert dst._ivf.trained and dst.last_query_stats["route"] == "ivf"
        np.testing.assert_array_equal(dst._ivf.centroids_np,
                                      src._ivf.centroids_np)


def test_bulk_load_does_not_reingest_per_row(tmp_path, monkeypatch):
    vecs, _, _ = _clustered(100, 4, seed=13)
    path = str(tmp_path / "store.npz")
    store = _store(persist_path=path)
    _fill(store, vecs)
    store.save()
    again = _store(persist_path=path)

    def boom(*a, **k):
        raise AssertionError("load() must not ingest row-by-row")
    monkeypatch.setattr(again, "add_embedding", boom)
    monkeypatch.setattr(again, "add_embeddings", boom)
    assert again.load() == 100
    assert _ids(again.query(vecs[17], top_k=1)) == ["v17"]
    with pytest.raises(VectorStoreError, match="no persist_path"):
        _store().save()


# -- the IVF index against the JAX one ----------------------------------

def test_next_pow2_and_params():
    assert [next_pow2(n) for n in (0, 1, 2, 3, 8, 9, 1000)] == \
        [1, 1, 2, 4, 8, 16, 1024]
    p = IVFParams.from_config({"ivf_nlist": 64, "ivf_nprobe": 4,
                               "ivf_min_train": 16, "ivf_pad_factor": 2})
    assert (p.nlist, p.nprobe, p.min_train, p.pad_factor) == (64, 4, 16, 2.0)
    assert vars(IVFParams.from_config({})) == vars(JaxParams())


def test_allocator_places_lists_as_the_jax_allocator():
    from copilot_for_consensus_tpu.vectorstore.ivf import (
        ListShardAllocator as JaxAllocator,
    )

    sizes = np.random.default_rng(3).integers(1, 1000, size=37)
    for shards in (1, 8):
        np.testing.assert_array_equal(
            ListShardAllocator(shards, 37).assign(sizes),
            JaxAllocator(shards, 37).assign(sizes))
    slots = ListShardAllocator(8, 37).assign(sizes)
    assert sorted(set(slots)) == sorted(slots)


def test_kmeans_and_assignment_equal_the_jax_index():
    vecs, _, _ = _clustered(3000, 16, seed=21)
    host = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
    params = dict(nlist=16, min_train=64)
    jax_ivf = JaxIVF(DIM, JaxParams(**params))
    port = IVFIndex(DIM, IVFParams(**params))
    rows = list(range(0, 3000, 1))
    jax_ivf.rebuild(host, rows)
    port.rebuild(host, rows)
    np.testing.assert_allclose(port.centroids_np, jax_ivf.centroids_np,
                               atol=1e-5, rtol=0)
    assert (port.nlist, port.pad, port.sps) == \
        (jax_ivf.nlist, jax_ivf.pad, jax_ivf.sps)
    assert port._locator == jax_ivf._locator
    np.testing.assert_array_equal(port._d_rowids.numpy(),
                                  np.asarray(jax_ivf._d_rowids))
    np.testing.assert_array_equal(port._d_spill.numpy(),
                                  np.asarray(jax_ivf._d_spill))


def test_overflowing_lists_spill_as_in_the_jax_index():
    vecs, _, _ = _clustered(600, 2, seed=23)      # two lists, 8 wanted
    host = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
    params = dict(nlist=8, min_train=64, pad_factor=1.0)
    jax_ivf = JaxIVF(DIM, JaxParams(**params))
    port = IVFIndex(DIM, IVFParams(**params))
    jax_ivf.rebuild(host, range(600))
    port.rebuild(host, range(600))
    assert port.overflow_count == jax_ivf.overflow_count > 0
    assert port._locator == jax_ivf._locator


def test_retrain_policy():
    idx = IVFIndex(DIM, IVFParams(min_train=100, spill_fraction=0.25,
                                  growth_factor=2.0))
    assert not idx.needs_retrain(99) and idx.needs_retrain(100)
    idx.trained, idx.trained_at_n, idx._indexed_live = True, 100, 100
    assert not idx.needs_retrain(110) and idx.needs_retrain(200)
    idx._spill_live = 50
    assert idx.needs_retrain(150)


def _recall(ivf_store, flat_store, queries, top_k=10):
    approx = ivf_store.query_batch(list(queries), top_k=top_k)
    exact = flat_store.query_batch(list(queries), top_k=top_k)
    return float(np.mean([len(set(_ids(a)) & set(_ids(e))) / len(e)
                          for a, e in zip(approx, exact) if e]))


def test_recall_gate_clustered_10k():
    """The reference's gate at tier-1 scale: recall@10 >= 0.95 against
    the exact route while scanning <= 15% of the posting lists."""
    vecs, centers, rng = _clustered(10_000, 64)
    flat, ivf = _store(), _store(index="ivf", ivf_nprobe=16)
    _fill(flat, vecs)
    _fill(ivf, vecs)
    queries = (centers[rng.integers(0, 64, size=32)]
               + 0.15 * rng.standard_normal((32, DIM), dtype=np.float32))
    recall = _recall(ivf, flat, queries)
    stats = ivf.last_query_stats
    assert stats["route"] == "ivf"
    assert recall >= 0.95, recall
    assert stats["lists_scanned_frac"] <= 0.15, stats


def test_ivf_ids_equal_the_jax_ivf_route():
    vecs, centers, rng = _clustered(2000, 16, seed=3)
    cfg = {"dimension": DIM, "index": "ivf", "ivf_nprobe": 4,
           "ivf_min_train": 128, "dtype": "float32"}
    jax_store, port = TPUVectorStore(cfg), _store(**cfg)
    _fill(jax_store, vecs)
    _fill(port, vecs)
    queries = list(centers[rng.integers(0, 16, size=8)]
                   + 0.2 * rng.standard_normal((8, DIM), dtype=np.float32))
    want = jax_store.query_batch(queries, top_k=10)
    got = port.query_batch(queries, top_k=10)
    assert [_ids(g) for g in got] == [_ids(w) for w in want]
    assert port.last_query_stats == {
        **jax_store.last_query_stats,
        "duration_s": port.last_query_stats["duration_s"]}


def test_uniform_corpus_full_probe_is_exact():
    rng = np.random.default_rng(7)
    vecs = rng.standard_normal((1500, DIM), dtype=np.float32)
    flat = _store()
    ivf = _store(index="ivf", ivf_nlist=16, ivf_nprobe=16, ivf_min_train=64)
    _fill(flat, vecs)
    _fill(ivf, vecs)
    assert _recall(ivf, flat, rng.standard_normal((16, DIM),
                                                  dtype=np.float32)) == 1.0


def test_filtered_query_parity():
    vecs, _, _ = _clustered(2000, 16, seed=11)
    meta = lambda i: {"thread_id": f"t{i % 7}"}          # noqa: E731
    flat = _store()
    ivf = _store(index="ivf", ivf_nprobe=4, ivf_min_train=128)
    _fill(flat, vecs, meta)
    _fill(ivf, vecs, meta)
    ivf.query(vecs[42], top_k=5)                       # trains
    got = ivf.query(vecs[42], top_k=5, flt={"thread_id": "t3"})
    assert _ids(got) == _ids(flat.query(vecs[42], top_k=5,
                                        flt={"thread_id": "t3"}))
    assert all(h.metadata["thread_id"] == "t3" for h in got)


def test_upsert_delete_retrain_invariants():
    """Across train → upsert → delete the locator covers every live row
    exactly once, and queries see upserts and deletes at once."""
    vecs, _, _ = _clustered(600, 8, seed=5)
    store = _store(index="ivf", ivf_nlist=8, ivf_nprobe=8, ivf_min_train=64)
    _fill(store, vecs)
    store.query(vecs[0], top_k=1)
    ivf = store._ivf
    assert ivf.trained

    def live_rows():
        return {r for r in range(len(store._ids))
                if r not in store._deleted_rows}

    assert set(ivf._locator) == live_rows()
    assert ivf.live_count == len(live_rows())
    probe = np.zeros(DIM, dtype=np.float32)
    probe[DIM - 1] = 1.0
    store.add_embedding("v7", probe, None)
    assert _ids(store.query(probe, top_k=1)) == ["v7"]
    assert ivf._locator[7][0] == "s"
    assert set(ivf._locator) == live_rows()
    store.delete([f"v{i}" for i in range(20)])
    assert store.count() == 580
    assert set(ivf._locator) == live_rows()
    assert not set(_ids(store.query(vecs[3], top_k=10))) & \
        {f"v{i}" for i in range(20)}
    # new rows past the spill block's capacity grow it and compact it
    more, _, _ = _clustered(300, 8, seed=6)
    store.add_embeddings((f"n{i}", more[i], None) for i in range(300))
    assert set(ivf._locator) == live_rows()
    assert int(ivf._d_spill.shape[0]) >= ivf._spill_live == 300


def test_topk_bucketing_stays_correct_at_odd_k():
    vecs, _, rng = _clustered(500, 8, seed=17)
    flat = _store()
    _fill(flat, vecs)
    q = rng.standard_normal(DIM).astype(np.float32)
    full = _ids(flat.query(q, top_k=16))
    for k in (1, 3, 7, 11, 13):
        assert _ids(flat.query(q, top_k=k)) == full[:k]


# -- metrics ------------------------------------------------------------

def test_the_store_emits_its_metric_series():
    vecs, _, _ = _clustered(600, 8, seed=2)
    m = InMemoryMetrics()
    store = _store(index="ivf", ivf_nlist=8, ivf_nprobe=2, ivf_min_train=64)
    store.set_metrics(m)
    _fill(store, vecs, _thread)
    store.query_batch([vecs[1], vecs[2]], top_k=3)
    store.query(vecs[1], top_k=3, flt={"thread_id": "t1"})
    body = m.render_prometheus()
    for name in VECTORSTORE_METRICS:
        assert name in body, name
    assert 'route="ivf"' in body and 'route="host"' in body


# -- the native copy ----------------------------------------------------

def test_native_copy_compiles_and_matches_the_memory_driver():
    assert load_native_lib() is not None
    nat, mem = NativeFlatVectorStore(), InMemoryVectorStore()
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(200, 16)).astype(np.float32)
    for s in (nat, mem):
        s.add_embeddings([(f"v{i}", vecs[i].tolist(),
                           {"thread_id": f"t{i % 7}"}) for i in range(200)])
    for flt in (None, {"thread_id": "t3"}):
        for _ in range(5):
            q = rng.normal(size=16).tolist()
            got, want = nat.query(q, 9, flt), mem.query(q, 9, flt)
            assert _ids(got) == _ids(want)
            np.testing.assert_allclose([g.score for g in got],
                                       [w.score for w in want], rtol=1e-5,
                                       atol=1e-6)
