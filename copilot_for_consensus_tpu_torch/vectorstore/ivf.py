"""IVF index over the card vector store's device matrix (port of the JAX
package's ``vectorstore/ivf.py``).

Instead of scoring the whole ``[capacity, dim]`` matrix a query (exact
flat search), a k-means coarse quantizer routes each query to ``nprobe``
posting lists, and only those lists' rows are rescored exactly against
the SAME device matrix the flat route scores. The index adds only posting
lists of global row ids and a small centroid matrix on the card; upserts
and deletes keep mutating the matrix as the flat route does, and the lists
only say where to look.

Layout: centroids ``[nlist_padded, dim]`` f32 and posting lists
``[nlist_padded, pad]`` int64 global row ids (``-1`` = empty slot) on the
card. The host-side :class:`ListShardAllocator` (LPT greedy over list
sizes) places lists into shard slot ranges; one card is one shard, so
every list lands in shard 0's slots. Rows added after a (re)train append
into a SPILL block scored exactly on every query, so ``add_embeddings``
never blocks on a rebuild; the spill folds into the lists at the next
retrain.

Retrain policy (lazy, on the query path, never on ingest): first train
once the live corpus reaches ``min_train`` rows; retrain when the spill
fraction crosses ``spill_fraction`` or the corpus outgrows the trained
size by ``growth_factor``.

The JAX package has no Pallas kernel here (its scoring is ``@`` and
``lax.top_k`` under ``jit``), and neither does the port: the search is
``torch.matmul``, ``torch.topk`` and gathers; k-means sums are
``index_add_``. The k-means initialisation is drawn from numpy with the
same seed, so the port's centroids are the JAX package's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

#: queries rescored together: bounds the candidate working set to
#: [_RESCORE_GROUP, C, dim] (the JAX package's ``lax.map`` batch size)
_RESCORE_GROUP = 8
#: rows a nearest-centroid assignment scores at once
_ASSIGN_CHUNK = 8192


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (>=1)."""
    return 1 << max(0, int(n - 1).bit_length()) if n > 1 else 1


@dataclass
class IVFParams:
    """Tuning knobs; every field has a serving-sane default."""

    nlist: int = 0              # 0 = auto: ~sqrt(n), pow2, in [8, 4096]
    nprobe: int = 8             # lists probed per shard per query
    train_size: int = 65536     # k-means sample = first N live rows
    min_train: int = 256        # corpus size that triggers first train
    kmeans_iters: int = 8
    spill_fraction: float = 0.25   # spill/live ratio forcing a retrain
    growth_factor: float = 2.0     # corpus growth forcing a retrain
    pad_factor: float = 4.0        # list capacity ≈ pad_factor * mean
    seed: int = 0

    @staticmethod
    def from_config(cfg: dict) -> "IVFParams":
        p = IVFParams()
        for f, cast in (("nlist", int), ("nprobe", int),
                        ("train_size", int), ("min_train", int),
                        ("kmeans_iters", int), ("spill_fraction", float),
                        ("growth_factor", float), ("pad_factor", float),
                        ("seed", int)):
            key = f"ivf_{f}"
            if key in cfg:
                setattr(p, f, cast(cfg[key]))
        return p


class ListShardAllocator:
    """Assign posting lists to shards balancing row totals: LPT greedy
    (largest list first, onto the shard with the least rows that still
    has a free slot). Every shard gets exactly ``slots_per_shard`` slots.
    """

    def __init__(self, num_shards: int, nlist: int):
        self.num_shards = int(num_shards)
        self.slots_per_shard = max(
            1, math.ceil(nlist / max(1, num_shards)))

    def assign(self, sizes: np.ndarray) -> np.ndarray:
        """``sizes[l]`` = rows in list l → global slot per list. Shard s
        owns slots ``[s*sps, (s+1)*sps)``; unassigned slots are padding
        (zero centroid, all-empty list)."""
        sps = self.slots_per_shard
        order = np.argsort(-sizes, kind="stable")
        load = np.zeros(self.num_shards, dtype=np.int64)
        used = np.zeros(self.num_shards, dtype=np.int64)
        slot_of_list = np.full(len(sizes), -1, dtype=np.int64)
        for l in order:
            open_shards = np.flatnonzero(used < sps)
            s = open_shards[np.argmin(load[open_shards])]
            slot_of_list[l] = s * sps + used[s]
            used[s] += 1
            load[s] += sizes[l]
        return slot_of_list


class IVFIndex:
    """Centroids + posting lists + spill block on the card.

    Holds GLOBAL row ids only; candidate vectors gather from the store's
    device matrix at query time, so the store's one vector allocation
    stays the one source of truth (upserted vectors rescore correctly
    even before the index catches up).
    """

    def __init__(self, dim: int, params: IVFParams | None = None, *,
                 device: torch.device | str = "cpu"):
        self.dim = int(dim)
        self.params = params or IVFParams()
        self.device = torch.device(device)
        self.num_shards = 1
        self.trained = False
        self.generation = 0
        self.nlist = 0               # real (unpadded) list count
        self.pad = 0                 # per-list slot capacity
        self.sps = 0                 # list slots per shard
        self.trained_at_n = 0
        self.overflow_count = 0      # rows a full list pushed to spill
        self.centroids_np: np.ndarray | None = None  # [nlist, dim]
        self._locator: dict[int, tuple] = {}  # row -> ("l",slot,off)|("s",pos)
        self._d_centroids: torch.Tensor | None = None  # [lp, dim] f32
        self._d_rowids: torch.Tensor | None = None     # [lp, pad] int64
        self._d_spill: torch.Tensor | None = None      # [spill_cap] int64
        self._spill_n = 0            # high-water append cursor
        self._spill_live = 0
        self._indexed_live = 0

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    # -- sizing --------------------------------------------------------

    def auto_nlist(self, n: int) -> int:
        if self.params.nlist:
            return min(self.params.nlist, max(1, n))
        return max(8, min(4096, next_pow2(int(math.sqrt(max(1, n))))))

    @property
    def live_count(self) -> int:
        return self._indexed_live + self._spill_live

    def spill_frac(self) -> float:
        live = self.live_count
        return (self._spill_live / live) if live else 0.0

    def needs_retrain(self, live_n: int) -> bool:
        if not self.trained:
            return live_n >= self.params.min_train
        if live_n < 1:
            return False
        if self.spill_frac() > self.params.spill_fraction:
            return True
        return live_n >= self.params.growth_factor * self.trained_at_n

    def max_candidates(self, nprobe: int | None = None) -> int:
        """Rows one query can reach — the escalation ceiling: probed list
        capacity plus the whole spill block."""
        if not self.trained:
            return 0
        npb = min(nprobe if nprobe is not None else self.params.nprobe,
                  self.sps)
        spill_cap = (int(self._d_spill.shape[0])
                     if self._d_spill is not None else 0)
        return self.num_shards * npb * self.pad + spill_cap

    # -- training ------------------------------------------------------

    def _kmeans(self, X: np.ndarray, K: int) -> np.ndarray:
        """Lloyd iterations on the card over unit vectors (cosine = dot).
        The sample is the first power-of-two rows (at least K), the
        initial centroids a numpy permutation of it — the JAX package's
        draw."""
        m = min(len(X), self.params.train_size)
        m = max(K, 1 << (m.bit_length() - 1))  # pow2 <= m, >= K
        sample = X[:m]
        rng = np.random.default_rng(self.params.seed)
        init = sample[rng.permutation(m)[:K]].astype(np.float32)
        Xd = self._put(np.ascontiguousarray(sample, dtype=np.float32))
        C = self._put(init)
        ones = torch.ones(len(Xd), dtype=torch.float32, device=self.device)
        for _ in range(self.params.kmeans_iters):
            a = torch.argmax(Xd @ C.T, dim=1)
            sums = torch.zeros_like(C).index_add_(0, a, Xd)
            cnt = torch.zeros(K, dtype=torch.float32,
                              device=self.device).index_add_(0, a, ones)
            newc = torch.where(cnt[:, None] > 0,
                               sums / cnt[:, None].clamp_min(1.0), C)
            norm = torch.linalg.vector_norm(newc, dim=1, keepdim=True)
            C = newc / norm.clamp_min(1e-30)
        return C.cpu().numpy()

    def _assign_all(self, X: np.ndarray, C: np.ndarray) -> np.ndarray:
        """Nearest-centroid assignment, ``_ASSIGN_CHUNK`` rows at a time."""
        Cd = self._put(np.ascontiguousarray(C, dtype=np.float32))
        out = np.empty(len(X), dtype=np.int64)
        for lo in range(0, len(X), _ASSIGN_CHUNK):
            hi = min(lo + _ASSIGN_CHUNK, len(X))
            block = self._put(np.ascontiguousarray(X[lo:hi],
                                                   dtype=np.float32))
            out[lo:hi] = torch.argmax(block @ Cd.T, dim=1).cpu().numpy()
        return out

    def rebuild(self, host: np.ndarray, rows: Sequence[int],
                centroids: np.ndarray | None = None) -> None:
        """(Re)train on the live corpus and rebuild every device buffer:
        k-means (or the given centroids — the persistence path), full
        reassignment, allocator placement, spill fold."""
        rows = np.asarray(list(rows), dtype=np.int64)
        n = len(rows)
        if n == 0:
            self.trained = False
            self._locator.clear()
            self._d_centroids = self._d_rowids = self._d_spill = None
            self._spill_n = self._spill_live = self._indexed_live = 0
            return
        X = host[rows].astype(np.float32)
        if centroids is None:
            K = min(self.auto_nlist(n), n)
            centroids = self._kmeans(X, K)
        else:
            centroids = np.asarray(centroids, dtype=np.float32)
        K = centroids.shape[0]
        assign = self._assign_all(X, centroids)
        sizes = np.bincount(assign, minlength=K)
        mean = max(1, n // K)
        cap = max(8, int(self.params.pad_factor * mean))
        pad = next_pow2(min(int(sizes.max()), cap))
        alloc = ListShardAllocator(self.num_shards, K)
        slot_of_list = alloc.assign(sizes)
        sps = alloc.slots_per_shard
        lp = self.num_shards * sps
        rowids_np = np.full((lp, pad), -1, dtype=np.int64)
        cents_np = np.zeros((lp, self.dim), dtype=np.float32)
        cents_np[slot_of_list] = centroids
        # each row's rank in its list, in row order: the first ``pad``
        # members of a list fill its slot, the rest overflow to the spill
        order = np.argsort(assign, kind="stable")
        starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        rank = np.empty(n, dtype=np.int64)
        rank[order] = np.arange(n) - starts[assign[order]]
        keep = rank < pad
        slots = slot_of_list[assign]
        rowids_np[slots[keep], rank[keep]] = rows[keep]
        self._locator = {
            int(r): ("l", int(s), int(c))
            for r, s, c in zip(rows[keep], slots[keep], rank[keep])}
        spill_rows = rows[~keep].tolist()
        self.overflow_count = len(spill_rows)
        self._indexed_live = n - len(spill_rows)
        self.nlist, self.pad, self.sps = K, pad, sps
        self.centroids_np = centroids
        self._d_centroids = self._put(cents_np)
        self._d_rowids = self._put(rowids_np)
        self._rebuild_spill(spill_rows)
        self.trained = True
        self.trained_at_n = n
        self.generation += 1

    def _rebuild_spill(self, spill_rows: list[int]) -> None:
        per_shard = next_pow2(max(
            64, math.ceil(2 * max(1, len(spill_rows)) / self.num_shards)))
        cap = self.num_shards * per_shard
        arr = np.full(cap, -1, dtype=np.int64)
        for pos, r in enumerate(spill_rows):
            arr[pos] = r
            self._locator[r] = ("s", pos)
        self._d_spill = self._put(arr)
        self._spill_n = len(spill_rows)
        self._spill_live = len(spill_rows)

    # -- incremental maintenance --------------------------------------

    def _ids(self, values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, dtype=np.int64),
                               device=self.device)

    def add(self, rows: Sequence[int]) -> None:
        """Append freshly-ingested rows to the spill block (the fold
        happens at the next retrain)."""
        rows = [int(r) for r in rows if int(r) not in self._locator]
        if not rows or not self.trained:
            return
        cap = int(self._d_spill.shape[0])
        if self._spill_n + len(rows) > cap:
            # grow + compact (drops -1 holes left by removals)
            live = [r for r, loc in self._locator.items()
                    if loc[0] == "s"]
            for r in live:
                del self._locator[r]
            self._rebuild_spill(live + rows)  # counts _spill_live itself
            return
        pos = np.arange(self._spill_n, self._spill_n + len(rows))
        self._d_spill[self._ids(pos)] = self._ids(rows)
        for i, r in enumerate(rows):
            self._locator[r] = ("s", self._spill_n + i)
        self._spill_n += len(rows)
        self._spill_live += len(rows)

    def remove(self, rows: Sequence[int]) -> None:
        """Drop rows from their posting-list / spill slots (one indexed
        write a buffer, not one a row)."""
        if not self.trained:
            return
        slots, offs, spos = [], [], []
        for r in rows:
            loc = self._locator.pop(int(r), None)
            if loc is None:
                continue
            if loc[0] == "l":
                slots.append(loc[1])
                offs.append(loc[2])
                self._indexed_live -= 1
            else:
                spos.append(loc[1])
                self._spill_live -= 1
        if slots:
            self._d_rowids[self._ids(slots), self._ids(offs)] = -1
        if spos:
            self._d_spill[self._ids(spos)] = -1

    # -- search --------------------------------------------------------

    def _search_groups(self, matrix: torch.Tensor, q: torch.Tensor, *,
                       nprobe: int, k: int):
        """Centroid scores → top-nprobe lists → candidate gather → exact
        rescore against the live matrix → top-k, rescoring
        ``_RESCORE_GROUP`` queries at a time so the candidate working set
        stays [G, C, dim]."""
        b = q.shape[0]
        pad = self._d_rowids.shape[1]
        cs = q @ self._d_centroids.T                   # [B, lists]
        _, pl = torch.topk(cs, nprobe, dim=1)          # [B, nprobe]
        cand = self._d_rowids[pl].reshape(b, nprobe * pad)
        cand = torch.cat([cand, self._d_spill[None, :].expand(b, -1)],
                         dim=1)
        vals, rows = [], []
        for g in range(0, b, _RESCORE_GROUP):
            c = cand[g:g + _RESCORE_GROUP]
            vecs = matrix[c.clamp(0, matrix.shape[0] - 1)]  # [G, C, dim]
            qv = q[g:g + _RESCORE_GROUP].to(matrix.dtype)[:, :, None]
            s = torch.bmm(vecs, qv)[..., 0].float()
            s = s.masked_fill(c < 0, float("-inf"))
            v, i = torch.topk(s, k, dim=1)
            vals.append(v)
            rows.append(torch.gather(c, 1, i))
        return torch.cat(vals), torch.cat(rows)

    def search(self, matrix: torch.Tensor, qs: np.ndarray, k: int,
               nprobe: int | None = None):
        """Search B queries; returns host arrays ``(vals, rows)`` of shape
        ``[B, k]`` sorted by score, and a stats dict. ``rows`` may contain
        -1 (score -inf) when fewer than k live candidates were
        reachable."""
        npb = min(nprobe if nprobe is not None else self.params.nprobe,
                  self.sps)
        spill_local = int(self._d_spill.shape[0]) // self.num_shards
        k_eff = min(int(k), npb * self.pad + spill_local)
        q = self._put(np.ascontiguousarray(qs, dtype=np.float32))
        vals, rows = self._search_groups(matrix, q, nprobe=npb, k=k_eff)
        vals = vals.cpu().numpy()
        rows = rows.cpu().numpy()
        order = np.argsort(-vals, axis=1, kind="stable")
        vals = np.take_along_axis(vals, order, axis=1)
        rows = np.take_along_axis(rows, order, axis=1)
        lists_scanned = min(npb * self.num_shards, self.nlist)
        stats = {
            "nprobe": npb,
            "lists_scanned": lists_scanned,
            "lists_scanned_frac": (lists_scanned / self.nlist
                                   if self.nlist else 0.0),
            "spill_fraction": round(self.spill_frac(), 4),
            "k": k_eff,
        }
        return vals, rows, stats
