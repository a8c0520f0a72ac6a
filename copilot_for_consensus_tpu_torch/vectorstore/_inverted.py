"""Shared inverted index for metadata-equality filters.

One implementation, one semantics, for every host-resident driver
(memory/native/tpu): scalar (str/int/bool) top-level metadata values
index into (key, value) → row sets. ``filter_candidates`` answers a
filter ONLY when the index can decide it soundly — any dotted-path key,
any key that ever carried an unindexable value, or any non-scalar filter
condition returns None so the caller falls back to the full
``matches_filter`` scan. Candidates are a SUPERSET guess (int/bool/float
hash-equality blurs 1/True/1.0): callers must re-verify each candidate
with ``matches_filter`` before returning it.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Mapping


class InvertedIndexMixin:
    _inverted: dict[tuple[str, Any], set[int]]
    _unindexed_keys: set[str]

    def _init_inverted(self) -> None:
        self._inverted = defaultdict(set)
        self._unindexed_keys = set()

    def _index_meta(self, row: int, meta: Mapping[str, Any],
                    remove: Mapping[str, Any] | None = None) -> None:
        for k, v in (remove or {}).items():
            if isinstance(v, (str, int, bool)):
                self._inverted.get((k, v), set()).discard(row)
        for k, v in meta.items():
            if isinstance(v, (str, int, bool)):
                self._inverted[(k, v)].add(row)
            else:
                # This key is no longer fully covered by the index; any
                # filter on it must scan (a miss would otherwise read as
                # authoritative "no matches").
                self._unindexed_keys.add(k)

    def _filter_candidates(self, flt: Mapping[str, Any]) -> set[int] | None:
        """Candidate row superset for ``flt`` via the index, or None when
        the index cannot decide the filter soundly."""
        sets = []
        for k, v in flt.items():
            if ("." in k or k.startswith("$")
                    or k in self._unindexed_keys
                    or not isinstance(v, (str, int, bool))):
                return None
            sets.append(self._inverted.get((k, v), set()))
        if not sets:
            return None
        return set.intersection(*sets) if len(sets) > 1 else set(sets[0])
