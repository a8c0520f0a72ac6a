"""On-device vector store: exact flat search + IVF ANN on the card (port
of the JAX package's ``vectorstore/tpu.py``).

Vectors live as one device-resident ``[capacity, dim]`` matrix (bf16 by
default) beside a host f32 master. The default ``index="flat"`` route
scores a batch of queries as one ``q @ Mᵀ`` (a product in the matrix's
dtype, rounded, then f32 — the JAX package's order) plus ``torch.topk``:
exact cosine search, no index build. ``index="ivf"`` layers the IVF index
(``vectorstore/ivf.py``) over the SAME matrix: a k-means coarse quantizer
routes each query to ``nprobe`` posting lists, their rows are rescored
exactly against the live matrix, and rows ingested after a (re)train
append to a spill block scored on every query; the quantizer retrains
lazily on the query path.

Filtered queries use the host-side inverted index over metadata: a
selective filter (under ``_SELECTIVE_HOST_LIMIT`` candidate rows) scores
just those rows on the host; a broad one runs the device route with
top-k oversampling, whose width escalates in powers of two (the IVF route
falls back to the exact flat route for an under-filled filtered query).
Capacity grows geometrically; the device matrix is rebuilt on growth and
patched in place (an indexed write) for small flushes. ``save`` and
``load`` use the JAX package's ``.npz`` layout, so a file written by
either package loads in the other.

Against the JAX store: no shardcheck contracts (they check JAX programs)
and one card, so no retrieval mesh — ``mesh`` "auto" (or none) means no
mesh, an integer above 1 is refused until the port's sharding lands
(ROADMAP Queue 1 item 6). ``device`` None means the card. The JAX package
has no Pallas kernel here, and neither does the port: the scoring is
``torch.matmul`` and ``torch.topk``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from copilot_for_consensus_tpu_torch.device import resolve_device
from copilot_for_consensus_tpu_torch.obs.metrics import check_registry_labels
from copilot_for_consensus_tpu_torch.storage.base import matches_filter
from copilot_for_consensus_tpu_torch.vectorstore._inverted import \
    InvertedIndexMixin
from copilot_for_consensus_tpu_torch.vectorstore.base import (
    QueryResult,
    VectorStore,
    VectorStoreError,
)
from copilot_for_consensus_tpu_torch.vectorstore.ivf import (
    IVFIndex,
    IVFParams,
    next_pow2,
)

_SELECTIVE_HOST_LIMIT = 4096     # filter hits below this → host-side scoring

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

#: retrieval telemetry families the store emits through ``set_metrics``
#: (exposition-prefixed names): dashboards and alert expressions can only
#: reference series the code emits
VECTORSTORE_METRICS = {
    "copilot_vectorstore_query_seconds": (
        "histogram", ("route",),
        "end-to-end query_batch latency per index route"),
    "copilot_vectorstore_queries_total": (
        "counter", ("route",),
        "queries answered per index route (flat | ivf | host)"),
    "copilot_vectorstore_query_nprobe": (
        "gauge", (),
        "posting lists probed per query on the ivf route"),
    "copilot_vectorstore_lists_scanned_total": (
        "counter", (),
        "posting lists scanned, summed over queries (ivf route)"),
    "copilot_vectorstore_spill_fraction": (
        "gauge", (),
        "fraction of live vectors answered from the spill block — "
        "sustained > ivf_spill_fraction means retrain is lagging"),
    "copilot_vectorstore_retrains_total": (
        "counter", (),
        "coarse-quantizer (re)trains — drift policy firings"),
}

# proc/role are stamped by the cross-process aggregator; declaring them
# here must fail at import, not at scrape time
check_registry_labels(VECTORSTORE_METRICS, owner="VECTORSTORE_METRICS")


def _no_mesh(mesh) -> None:
    """One card, one shard: refuse a mesh of several cards."""
    if mesh in (None, "none", "", "auto", 0, 1, False):
        return
    raise NotImplementedError(
        f"vector_store mesh {mesh!r}: the port keeps the store on one card; "
        f"a retrieval mesh over several is ROADMAP Queue 1 item 6 "
        f"(parallel/)")


class CUDAVectorStore(InvertedIndexMixin, VectorStore):
    def __init__(self, config: Any = None):
        cfg = dict(config or {})
        self._dim: int | None = cfg.get("dimension") or None
        self._dtype_name = cfg.get("dtype", "bfloat16")
        if self._dtype_name not in _DTYPES:
            raise VectorStoreError(
                f"unknown dtype {self._dtype_name!r} ({sorted(_DTYPES)})")
        self.persist_path = cfg.get("persist_path")
        self._index_kind = cfg.get("index", "flat")
        if self._index_kind not in ("flat", "ivf"):
            raise VectorStoreError(
                f"unknown index {self._index_kind!r} (flat|ivf)")
        _no_mesh(cfg.get("mesh", "none"))
        self.device = resolve_device(cfg.get("device") or None)
        self._ivf_params = IVFParams.from_config(cfg)
        self._ivf: IVFIndex | None = None
        self.metrics = None                          # set via set_metrics
        self.last_query_stats: dict[str, Any] | None = None
        self._lock = threading.RLock()
        self._ids: list[str] = []
        self._index: dict[str, int] = {}
        self._metadata: list[dict[str, Any]] = []
        self._host: np.ndarray | None = None        # [n, dim] f32 master
        self._init_inverted()
        self._device: torch.Tensor | None = None     # [capacity, dim]
        self._device_rows = 0                        # rows synced
        self._deleted_rows: set[int] = set()

    def set_metrics(self, collector) -> None:
        """Wire a MetricsCollector; queries then emit the
        ``vectorstore_*`` series."""
        with self._lock:
            self.metrics = collector

    @property
    def dimension(self) -> int | None:
        with self._lock:
            return self._dim

    def count(self) -> int:
        with self._lock:
            return len(self._ids) - len(self._deleted_rows)

    # -- writes --------------------------------------------------------

    def add_embedding(self, vec_id, vector, metadata=None):
        self.add_embeddings([(vec_id, vector, metadata)])

    def add_embeddings(self, items) -> int:
        n = 0
        with self._lock:
            rows, vecs = [], []
            for vec_id, vector, metadata in items:
                arr = np.asarray(vector, dtype=np.float32)
                if self._dim is None:
                    self._dim = int(arr.shape[0])
                if arr.shape[0] != self._dim:
                    raise VectorStoreError(
                        f"dimension mismatch: {arr.shape[0]} != {self._dim}")
                norm = float(np.linalg.norm(arr))
                if norm > 0:
                    arr = arr / norm
                meta = dict(metadata or {})
                if vec_id in self._index:            # upsert semantics
                    row = self._index[vec_id]
                    self._unindex_meta(row)
                    self._host[row] = arr
                    self._metadata[row] = meta
                    self._index_meta(row, meta)
                    self._deleted_rows.discard(row)
                else:
                    row = len(self._ids)
                    self._ids.append(vec_id)
                    self._index[vec_id] = row
                    self._metadata.append(meta)
                    self._index_meta(row, meta)
                    self._append_host(arr)
                rows.append(row)
                vecs.append(arr)
                n += 1
            self._sync_device(rows, vecs)
            if self._ivf is not None and self._ivf.trained and rows:
                # upserted rows move list → spill (their centroid may no
                # longer be nearest); new rows append to spill
                self._ivf.remove(rows)
                self._ivf.add(rows)
        return n

    def _append_host(self, arr: np.ndarray) -> None:
        if self._host is None:
            self._host = np.zeros((16, self._dim), dtype=np.float32)
        if len(self._ids) > self._host.shape[0]:
            grown = np.zeros((self._host.shape[0] * 2, self._dim),
                             dtype=np.float32)
            grown[:self._host.shape[0]] = self._host
            self._host = grown
        self._host[len(self._ids) - 1] = arr

    def _unindex_meta(self, row: int) -> None:
        meta = self._metadata[row]
        for k, v in meta.items():
            if isinstance(v, (str, int, bool)):
                self._inverted[(k, v)].discard(row)

    def _sync_device(self, rows: list[int], vecs: list[np.ndarray]) -> None:
        """Patch the device matrix; rebuild it on growth."""
        dtype = _DTYPES[self._dtype_name]
        capacity = self._host.shape[0] if self._host is not None else 0
        if self._device is None or self._device.shape[0] != capacity:
            self._device = torch.from_numpy(self._host).to(
                self.device, copy=True).to(dtype)
            self._device_rows = len(self._ids)
            return
        if not rows:
            return
        # the last write of a row wins, as in a sequential patch
        last = dict(zip(rows, range(len(rows))))
        idx = torch.tensor(list(last), dtype=torch.int64, device=self.device)
        upd = torch.from_numpy(np.stack([vecs[i] for i in last.values()]))
        self._device[idx] = upd.to(self.device).to(dtype)
        self._device_rows = len(self._ids)

    # -- IVF maintenance ----------------------------------------------

    def _ensure_ivf(self) -> IVFIndex:
        if self._ivf is None:
            self._ivf = IVFIndex(self._dim, self._ivf_params,
                                 device=self.device)
        return self._ivf

    def _maybe_retrain(self) -> None:
        """Lazy (re)train on the query path — never on ingest."""
        if self._index_kind != "ivf" or self._host is None:
            return
        live = len(self._ids) - len(self._deleted_rows)
        ivf = self._ensure_ivf()
        if not ivf.needs_retrain(live):
            return
        rows = [i for i in range(len(self._ids))
                if i not in self._deleted_rows]
        ivf.rebuild(self._host, rows)
        if self.metrics is not None:
            self.metrics.increment("vectorstore_retrains_total")

    # -- reads ---------------------------------------------------------

    def get(self, vec_id):
        with self._lock:
            row = self._index.get(vec_id)
            if row is None or row in self._deleted_rows:
                return None
            return self._host[row].tolist(), dict(self._metadata[row])

    def query(self, vector, top_k: int = 10, flt=None):
        return self.query_batch([vector], top_k=top_k, flt=flt)[0]

    def query_batch(self, vectors, top_k: int = 10, flt=None):
        """B queries in one device dispatch: [B, D] @ matrixᵀ with a
        per-row top-k (flat), or the IVF probe → gather → rescore search
        when the index is trained."""
        with self._lock:
            n = len(self._ids)
            if n == 0 or self._dim is None:
                return [[] for _ in vectors]
            t0 = time.perf_counter()
            qs = np.asarray(list(vectors), dtype=np.float32)
            norms = np.linalg.norm(qs, axis=1, keepdims=True)
            qs = np.where(norms > 0, qs / np.maximum(norms, 1e-30), qs)
            self._maybe_retrain()
            if flt:
                cand = self._filter_rows(flt)
                if cand is not None and len(cand) <= _SELECTIVE_HOST_LIMIT:
                    out = [self._host_query(q, cand, top_k, flt)
                           for q in qs]
                    self._record_query("host", len(qs), t0)
                    return out
            if (self._index_kind == "ivf" and self._ivf is not None
                    and self._ivf.trained):
                out, stats, esc = self._ivf_query_many(qs, top_k, flt)
                self._record_query("ivf", len(qs), t0, stats, esc)
                return out
            out = self._device_query_many(qs, top_k, flt)
            self._record_query("flat", len(qs), t0)
            return out

    def _record_query(self, route: str, nq: int, t0: float,
                      stats: dict | None = None,
                      escalations: int = 0) -> None:
        dur = time.perf_counter() - t0
        snap: dict[str, Any] = {
            "route": route, "queries": nq, "duration_s": dur,
            "escalations": escalations,
        }
        if stats:
            snap.update(
                nprobe=stats["nprobe"],
                lists_scanned=stats["lists_scanned"],
                lists_scanned_frac=stats["lists_scanned_frac"],
                spill_fraction=stats["spill_fraction"])
        self.last_query_stats = snap
        m = self.metrics
        if m is None:
            return
        m.observe("vectorstore_query_seconds", dur,
                  labels={"route": route})
        m.increment("vectorstore_queries_total", float(nq),
                    labels={"route": route})
        if stats:
            m.gauge("vectorstore_query_nprobe", float(stats["nprobe"]))
            m.increment("vectorstore_lists_scanned_total",
                        float(stats["lists_scanned"] * nq))
            m.gauge("vectorstore_spill_fraction",
                    float(stats["spill_fraction"]))

    def _filter_rows(self, flt: Mapping[str, Any]) -> list[int] | None:
        """Candidate rows via the shared inverted index (superset guess;
        callers re-verify with matches_filter); None = not decidable."""
        cand = self._filter_candidates(flt)
        if cand is None:
            return None
        return sorted(cand - self._deleted_rows)

    def _host_query(self, q, rows: list[int], top_k: int, flt):
        if not rows:
            return []
        sub = self._host[rows]                       # [m, dim]
        scores = sub @ q
        order = np.argsort(-scores)[:top_k]
        return [
            QueryResult(self._ids[rows[i]], float(scores[i]),
                        dict(self._metadata[rows[i]]))
            for i in order
            if matches_filter(self._metadata[rows[i]], flt)
        ]

    def _collect_hits(self, vals, rows, top_k, flt):
        """Host side of a device top-k: skip padding/deleted rows,
        re-verify the filter, stop at top_k."""
        out = []
        with self._lock:
            for score, row in zip(vals, rows):
                row = int(row)
                if (row < 0 or row >= len(self._ids)
                        or row in self._deleted_rows):
                    continue  # padding rows; skip
                meta = self._metadata[row]
                if flt and not matches_filter(meta, flt):
                    continue
                out.append(QueryResult(self._ids[row], float(score),
                                       dict(meta)))
                if len(out) == top_k:
                    break
        return out

    def _flat_topk(self, qs: np.ndarray, k: int):
        """[B, D] queries against the whole matrix: scores as a product in
        the matrix's dtype, then f32; the top ``k`` of each row."""
        with torch.inference_mode():
            q = torch.from_numpy(np.ascontiguousarray(qs)).to(self.device)
            scores = (q.to(self._device.dtype) @ self._device.T).float()
            vals, idx = torch.topk(scores, k, dim=1)
            return vals.cpu().numpy(), idx.cpu().numpy()

    def _device_query_many(self, qs: np.ndarray, top_k: int, flt
                           ) -> list[list[QueryResult]]:
        """One implementation for single and batched exact device search,
        with top-k oversampling escalation for filtered/deleted rows.
        Escalation rounds rescore only the still-pending queries, and stop
        once k covers every row ever added. The width rounds up to a power
        of two."""
        with self._lock:
            capacity = self._device.shape[0]
            oversample = max(top_k, 16)
            pending = list(range(len(qs)))
            results: dict[int, list[QueryResult]] = {}
            while True:
                k = min(capacity, next_pow2(oversample))
                vals, idx = self._flat_topk(qs[pending], k)
                still = []
                for bi, qi in enumerate(pending):
                    out = self._collect_hits(vals[bi], idx[bi],
                                             top_k, flt)
                    results[qi] = out
                    if (len(out) < top_k and k < capacity
                            and k < len(self._ids)):
                        still.append(qi)
                if not still:
                    return [results[i] for i in range(len(qs))]
                pending = still
                oversample = k * 4

    def _ivf_query_many(self, qs: np.ndarray, top_k: int, flt):
        """The ANN route: probe → gather → rescore, then the flat route's
        verify/escalate discipline — k escalates in power-of-two buckets
        up to everything the probed lists + spill can reach. Filtered
        queries still under-filled at the ceiling fall back to the exact
        route."""
        ivf = self._ivf
        ceiling = max(1, ivf.max_candidates() // ivf.num_shards)
        oversample = max(top_k, 16)
        pending = list(range(len(qs)))
        results: dict[int, list[QueryResult]] = {}
        stats: dict[str, Any] = {}
        escalations = 0
        while True:
            k = min(ceiling, next_pow2(oversample))
            with torch.inference_mode():
                vals, rows, stats = ivf.search(self._device, qs[pending], k)
            still = []
            for bi, qi in enumerate(pending):
                out = self._collect_hits(vals[bi], rows[bi], top_k, flt)
                results[qi] = out
                if len(out) < top_k and k < ceiling:
                    still.append(qi)
            if not still:
                break
            pending = still
            oversample = k * 4
            escalations += 1
        if flt:
            short = [i for i in range(len(qs))
                     if len(results[i]) < top_k]
            if short:
                for i, exact in zip(
                        short,
                        self._device_query_many(qs[short], top_k, flt)):
                    results[i] = exact
        return ([results[i] for i in range(len(qs))], stats,
                escalations)

    # -- deletes / persistence ----------------------------------------

    def delete(self, vec_ids: Sequence[str]) -> int:
        n = 0
        with self._lock:
            zero_rows = []
            for vec_id in vec_ids:
                row = self._index.get(vec_id)
                if row is None or row in self._deleted_rows:
                    continue
                self._deleted_rows.add(row)
                self._unindex_meta(row)
                zero_rows.append(row)
                n += 1
            if zero_rows:
                self._host[zero_rows] = 0.0
            if zero_rows and self._device is not None:
                self._device[torch.tensor(zero_rows, dtype=torch.int64,
                                          device=self.device)] = 0
                self._device_rows = len(self._ids)
            if zero_rows and self._ivf is not None:
                self._ivf.remove(zero_rows)
        return n

    def delete_by_filter(self, flt):
        with self._lock:
            rows = self._filter_rows(flt)
            if rows is None:
                rows = [i for i, m in enumerate(self._metadata)
                        if i not in self._deleted_rows
                        and matches_filter(m, flt)]
            else:
                # index candidates are a superset guess: re-verify before
                # anything irreversible
                rows = [i for i in rows
                        if matches_filter(self._metadata[i], flt)]
            return self.delete([self._ids[i] for i in rows])

    def clear(self):
        with self._lock:
            self._ids.clear()
            self._index.clear()
            self._metadata.clear()
            self._init_inverted()
            self._deleted_rows.clear()
            self._host = None
            self._device = None
            self._device_rows = 0
            self._ivf = None
            self.last_query_stats = None

    def save(self, path: str | None = None) -> str:
        import json
        p = path or self.persist_path
        if not p:
            raise VectorStoreError("no persist_path configured")
        with self._lock:
            extra = {}
            if self._ivf is not None and self._ivf.trained:
                # the trained quantizer travels with the corpus; load()
                # rebuilds posting lists by assignment (spill folds in),
                # skipping the k-means re-fit
                extra["ivf_centroids"] = self._ivf.centroids_np
            np.savez_compressed(
                p,
                vectors=(self._host[:len(self._ids)]
                         if self._host is not None
                         else np.zeros((0, 0))),
                ids=np.array(self._ids, dtype=object),
                metadata=np.array(
                    [json.dumps(m) for m in self._metadata], dtype=object),
                deleted=np.array(sorted(self._deleted_rows)),
                **extra,
            )
        return p

    def load(self, path: str | None = None) -> int:
        """Bulk restore: rebuild the host state in one pass and move the
        matrix to the device in one copy. Deleted rows compact away; a
        saved trained quantizer is restored without re-running k-means."""
        import json
        p = path or self.persist_path
        if not p:
            raise VectorStoreError("no persist_path configured")
        data = np.load(p if str(p).endswith(".npz") else p + ".npz",
                       allow_pickle=True)
        with self._lock:
            self.clear()
            vectors = data["vectors"]
            ids = list(data["ids"])
            metas = [json.loads(m) for m in data["metadata"]]
            deleted = set(int(i) for i in data["deleted"])
            self._dim = int(vectors.shape[1]) if vectors.size else self._dim
            live = [i for i in range(len(ids)) if i not in deleted]
            if not live:
                return 0
            n = len(live)
            capacity = 16
            while capacity < n:
                capacity *= 2
            self._host = np.zeros((capacity, self._dim), dtype=np.float32)
            sub = vectors[live].astype(np.float32)
            norms = np.linalg.norm(sub, axis=1, keepdims=True)
            self._host[:n] = np.where(norms > 0,
                                      sub / np.maximum(norms, 1e-30), sub)
            self._ids = [str(ids[i]) for i in live]
            self._index = {vid: r for r, vid in enumerate(self._ids)}
            self._metadata = [metas[i] for i in live]
            for r, meta in enumerate(self._metadata):
                self._index_meta(r, meta)
            self._sync_device([], [])                # one copy
            if self._index_kind == "ivf" and "ivf_centroids" in data:
                self._ensure_ivf().rebuild(
                    self._host, list(range(n)),
                    centroids=data["ivf_centroids"])
            return len(self._ids)
