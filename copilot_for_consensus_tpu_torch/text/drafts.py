"""IETF draft-mention detection (role parity with the reference's
``parsing/app/draft_detector.py:9``)."""

from __future__ import annotations

import re

# draft-ietf-quic-http-34, draft-author-topic-name (optionally versioned)
_DRAFT_RE = re.compile(
    r"\bdraft-[a-z0-9]+(?:-[a-z0-9]+)+\b", re.IGNORECASE)

_VERSION_SUFFIX = re.compile(r"-\d{2}$")


def detect_draft_mentions(text: str) -> list[str]:
    """Unique draft names mentioned in text, version suffix stripped,
    in first-seen order."""
    seen: dict[str, None] = {}
    for match in _DRAFT_RE.finditer(text or ""):
        name = _VERSION_SUFFIX.sub("", match.group(0).lower())
        seen.setdefault(name, None)
    return list(seen)
