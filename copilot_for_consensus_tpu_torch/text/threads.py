"""Thread building: group messages into discussion threads.

Role parity with the reference's ``parsing/app/thread_builder.py:16``
(in-reply-to chain walking ``:125``, subject cleaning ``:180``). Strategy:

1. chase ``in_reply_to`` / ``references`` chains to a root message;
2. orphans (reply target never seen) fall back to grouping by normalized
   subject, so split archives still thread correctly;
3. thread id is deterministic over (normalized subject, root message id) —
   re-parsing the same archive yields the same thread ids.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from copilot_for_consensus_tpu_torch.core.ids import generate_thread_id
from copilot_for_consensus_tpu_torch.text.mbox import ParsedMessage

_SUBJECT_PREFIX = re.compile(r"^\s*((re|fwd?|aw|sv)\s*(\[\d+\])?\s*:\s*)+",
                             re.IGNORECASE)
_WS = re.compile(r"\s+")


def normalize_subject(subject: str) -> str:
    cleaned = _SUBJECT_PREFIX.sub("", subject or "")
    cleaned = _WS.sub(" ", cleaned).strip()
    return cleaned.lower()


@dataclass
class Thread:
    thread_id: str
    subject: str
    root_message_id: str
    message_indices: list[int] = field(default_factory=list)
    participants: list[str] = field(default_factory=list)
    first_date: str | None = None
    last_date: str | None = None


class ThreadBuilder:
    def build_threads(self, messages: list[ParsedMessage]) -> dict[str, Thread]:
        """Group parsed messages into threads; returns thread_id → Thread.

        ``message_indices`` index into the input list, ordered by date.
        """
        by_msg_id = {m.message_id: m for m in messages if m.message_id}

        def find_root(msg: ParsedMessage) -> ParsedMessage:
            seen = set()
            current = msg
            while True:
                if current.message_id:
                    if current.message_id in seen:
                        return current  # cycle guard
                    seen.add(current.message_id)
                parent_id = None
                if current.in_reply_to and current.in_reply_to in by_msg_id:
                    parent_id = current.in_reply_to
                else:
                    # references: first resolvable ancestor, oldest first
                    for ref in current.references:
                        if ref in by_msg_id and ref not in seen:
                            parent_id = ref
                            break
                if parent_id is None:
                    return current
                current = by_msg_id[parent_id]

        groups: dict[tuple[str, str], list[ParsedMessage]] = {}
        genuine_root: dict[tuple[str, str], bool] = {}
        for msg in messages:
            root = find_root(msg)
            subj = normalize_subject(root.subject or msg.subject)
            key = (subj, root.message_id)
            groups.setdefault(key, []).append(msg)
            # A root that itself claims a parent we never saw is an orphan
            # (archive split); a genuine root has no reply markers.
            genuine_root[key] = (not root.in_reply_to and not root.references)

        # Orphan groups merge into a genuinely-rooted group with the same
        # cleaned subject when one exists (subject fallback).
        rooted_by_subject = {subj: (subj, rid)
                             for (subj, rid), ok in genuine_root.items() if ok}
        merged: dict[tuple[str, str], list[ParsedMessage]] = {}
        for (subj, rid), msgs in groups.items():
            target = (subj, rid)
            if not genuine_root[(subj, rid)] and subj in rooted_by_subject:
                target = rooted_by_subject[subj]
            merged.setdefault(target, []).extend(msgs)

        threads: dict[str, Thread] = {}
        for (subj, rid), msgs in merged.items():
            msgs_sorted = sorted(
                msgs, key=lambda m: (m.date is None, m.date or "", m.index))
            root_msg = msgs_sorted[0]
            thread_id = generate_thread_id(subj, rid or root_msg.message_id)
            dates = [m.date for m in msgs_sorted if m.date]
            participants = sorted({m.from_addr for m in msgs_sorted
                                   if m.from_addr})
            threads[thread_id] = Thread(
                thread_id=thread_id,
                subject=root_msg.subject or subj,
                root_message_id=rid or root_msg.message_id,
                message_indices=[m.index for m in msgs_sorted],
                participants=participants,
                first_date=min(dates) if dates else None,
                last_date=max(dates) if dates else None,
            )
        return threads
