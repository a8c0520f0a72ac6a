"""Retrieval-quality evaluation: recall@k over a labeled fixture (port of
the JAX package's ``embedding/eval.py``).

Embed a labeled corpus, query through the port's on-device vector store
(``CUDAVectorStore``), and report recall@k — so the random-weight
hashed-BoW fallback can never silently masquerade as semantic retrieval.

The synthetic fixture is built for exactly that distinction: every topic
has two *disjoint* vocabularies — documents draw from one, queries from
the other — so lexical/hash overlap carries zero signal and only an
encoder that has learned the topic structure (contrastively tuned or
pretrained) can score.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch


@dataclass
class RetrievalFixture:
    """Labeled corpus: docs, queries, and relevance sets (qrels)."""

    docs: list[dict] = field(default_factory=list)       # {id, text, topic}
    queries: list[dict] = field(default_factory=list)    # {id, text, relevant}

    def training_pairs(self, n: int, seed: int = 0,
                       batch: int | None = None) -> list[tuple[str, str]]:
        """(query-style, doc-style) same-topic pairs, freshly sampled —
        never the eval queries themselves. With ``batch`` set, topics
        within each batch-sized block are drawn without replacement, so
        in-batch InfoNCE negatives are never same-topic false negatives."""
        rng = random.Random(seed + 7)
        topics = sorted({d["topic"] for d in self.docs})
        out: list[tuple[str, str]] = []
        if batch is None:
            return [_pair_for_topic(rng.choice(topics), rng)
                    for _ in range(n)]
        while len(out) < n:
            # Without replacement per block; when batch > n_topics,
            # cycle fresh permutations (collisions then unavoidable but
            # minimized).
            block: list[int] = []
            while len(block) < batch:
                block.extend(rng.sample(topics, len(topics)))
            out.extend(_pair_for_topic(t, rng) for t in block[:batch])
        return out[:n]


def _topic_vocab(topic: int, style: str, size: int = 16) -> list[str]:
    return [f"{style}{topic}w{i}" for i in range(size)]


def _sample_text(topic: int, style: str, rng: random.Random,
                 n_words: int) -> str:
    vocab = _topic_vocab(topic, style)
    return " ".join(rng.choice(vocab) for _ in range(n_words))


def _pair_for_topic(topic: int, rng: random.Random) -> tuple[str, str]:
    return (_sample_text(topic, "q", rng, 6),
            _sample_text(topic, "d", rng, 12))


def synthetic_fixture(n_topics: int = 8, docs_per_topic: int = 8,
                      queries_per_topic: int = 4,
                      seed: int = 0) -> RetrievalFixture:
    """Deterministic labeled fixture with doc/query vocabulary disjointness
    (see module docstring)."""
    rng = random.Random(seed)
    fx = RetrievalFixture()
    for t in range(n_topics):
        doc_ids = []
        for i in range(docs_per_topic):
            doc_id = f"t{t}d{i}"
            doc_ids.append(doc_id)
            fx.docs.append({"id": doc_id, "topic": t,
                            "text": _sample_text(t, "d", rng, 12)})
        for i in range(queries_per_topic):
            fx.queries.append({"id": f"t{t}q{i}", "topic": t,
                               "text": _sample_text(t, "q", rng, 6),
                               "relevant": list(doc_ids)})
    return fx


def recall_at_k(embed_fn: Callable[[Sequence[str]], np.ndarray],
                fixture: RetrievalFixture,
                ks: Sequence[int] = (1, 5, 10), *,
                device: str | torch.device | None = None
                ) -> dict[str, float]:
    """Embed docs+queries with ``embed_fn`` ([N texts] → [N, dim]), rank
    by cosine, and report mean recall@k = |top-k ∩ relevant| / min(k, R).
    Retrieval runs through the on-device vector store on ``device`` (None
    → the card) — the same path production queries take."""
    from copilot_for_consensus_tpu_torch.vectorstore.cuda import (
        CUDAVectorStore,
    )

    doc_vecs = np.asarray(embed_fn([d["text"] for d in fixture.docs]),
                          dtype=np.float32)
    q_vecs = np.asarray(embed_fn([q["text"] for q in fixture.queries]),
                        dtype=np.float32)
    store = CUDAVectorStore({"dimension": int(doc_vecs.shape[1]),
                             "dtype": "float32", "device": device})
    store.add_embeddings([(d["id"], v.tolist(), None)
                          for d, v in zip(fixture.docs, doc_vecs)])
    out: dict[str, float] = {}
    max_k = max(ks)
    hits_per_q = []
    for q, vec in zip(fixture.queries, q_vecs):
        got = store.query(vec.tolist(), top_k=max_k)
        hits_per_q.append(([g.id for g in got], set(q["relevant"])))
    for k in ks:
        vals = [len(set(ids[:k]) & rel) / min(k, len(rel))
                for ids, rel in hits_per_q]
        out[f"recall@{k}"] = float(np.mean(vals))
    return out


def train_encoder_on_fixture(fixture: RetrievalFixture, **kwargs):
    """Contrastive tuning of a small encoder: needs the port's trainer
    (``train.py``), which is not ported yet."""
    raise NotImplementedError(
        "train_encoder_on_fixture needs the trainer (train.py), ROADMAP "
        "Queue 1 item 6; train with the JAX package and carry the weights "
        "across with checkpoint.bridge.params_from_numpy")
