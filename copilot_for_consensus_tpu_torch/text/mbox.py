"""mbox archive parsing → normalized message dicts.

Role parity with the reference's ``parsing/app/parser.py:42`` (stdlib
``mailbox`` walk, RFC-2047 header decode, date/address parsing, multipart
body extraction preferring text/plain). Output is a plain dict per message;
the parsing service turns these into ``messages`` documents.
"""

from __future__ import annotations

import email.header
import email.message
import email.utils
import mailbox
import pathlib
import tempfile
from dataclasses import dataclass, field
from datetime import timezone
from typing import Iterator


@dataclass
class ParsedMessage:
    index: int
    message_id: str = ""
    in_reply_to: str | None = None
    references: list[str] = field(default_factory=list)
    subject: str = ""
    from_name: str = ""
    from_addr: str = ""
    to_addrs: list[str] = field(default_factory=list)
    date: str | None = None  # ISO-8601 UTC
    body_raw: str = ""


def decode_header_value(raw: str | None) -> str:
    """RFC-2047 decode a header into a clean unicode string."""
    if not raw:
        return ""
    try:
        parts = email.header.decode_header(raw)
    except Exception:
        return str(raw)
    out = []
    for data, charset in parts:
        if isinstance(data, bytes):
            try:
                out.append(data.decode(charset or "utf-8", errors="replace"))
            except LookupError:
                out.append(data.decode("utf-8", errors="replace"))
        else:
            out.append(data)
    return "".join(out).replace("\n", " ").replace("\r", " ").strip()


def parse_date(raw: str | None) -> str | None:
    if not raw:
        return None
    try:
        dt = email.utils.parsedate_to_datetime(raw)
    except (ValueError, TypeError):
        return None
    if dt is None:
        return None
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return dt.astimezone(timezone.utc).isoformat()


def _decode_payload(part: email.message.Message) -> str:
    payload = part.get_payload(decode=True)
    if payload is None:
        raw = part.get_payload()
        return raw if isinstance(raw, str) else ""
    charset = part.get_content_charset() or "utf-8"
    try:
        return payload.decode(charset, errors="replace")
    except LookupError:
        return payload.decode("utf-8", errors="replace")


def extract_body(msg: email.message.Message) -> tuple[str, bool]:
    """Return (body, is_html). Prefers text/plain; falls back to text/html."""
    if msg.is_multipart():
        plain, html = [], []
        for part in msg.walk():
            if part.is_multipart():
                continue
            ctype = part.get_content_type()
            disp = str(part.get("Content-Disposition", ""))
            if "attachment" in disp:
                continue
            if ctype == "text/plain":
                plain.append(_decode_payload(part))
            elif ctype == "text/html":
                html.append(_decode_payload(part))
        if plain:
            return "\n".join(plain), False
        if html:
            return "\n".join(html), True
        return "", False
    ctype = msg.get_content_type()
    return _decode_payload(msg), ctype == "text/html"


def _clean_msg_id(raw: str | None) -> str:
    if not raw:
        return ""
    return raw.strip().strip("<>").strip()


def _parse_references(raw: str | None) -> list[str]:
    if not raw:
        return []
    return [_clean_msg_id(tok) for tok in raw.replace("\n", " ").split()
            if tok.strip()]


def parse_mbox_bytes(raw: bytes) -> Iterator[tuple[ParsedMessage, bool]]:
    """Walk an mbox archive given as bytes; yields (message, body_is_html).

    Messages that fail to parse individually are skipped (the archive-level
    caller records counts); a malformed archive yields nothing rather than
    raising.
    """
    with tempfile.NamedTemporaryFile(suffix=".mbox", delete=False) as tmp:
        tmp.write(raw)
        tmp_path = tmp.name
    try:
        yield from parse_mbox_file(tmp_path)
    finally:
        pathlib.Path(tmp_path).unlink(missing_ok=True)


def parse_mbox_file(path: str | pathlib.Path) -> Iterator[tuple[ParsedMessage, bool]]:
    box = mailbox.mbox(str(path), create=False)
    try:
        # Fetch inside the guard: stdlib mbox decodes each From_ separator
        # as ascii at access time, so a corrupt separator must skip that
        # one message, not abort the whole archive walk.
        for index, key in enumerate(box.keys()):
            try:
                msg = box.get_message(key)
                body, is_html = extract_body(msg)
                to_raw = decode_header_value(msg.get("To"))
                cc_raw = decode_header_value(msg.get("Cc"))
                to_addrs = [addr for _, addr in
                            email.utils.getaddresses([to_raw, cc_raw]) if addr]
                from_pairs = email.utils.getaddresses(
                    [decode_header_value(msg.get("From"))])
                from_name, from_addr = from_pairs[0] if from_pairs else ("", "")
                yield ParsedMessage(
                    index=index,
                    message_id=_clean_msg_id(msg.get("Message-ID")),
                    in_reply_to=_clean_msg_id(msg.get("In-Reply-To")) or None,
                    references=_parse_references(msg.get("References")),
                    subject=decode_header_value(msg.get("Subject")),
                    from_name=from_name.strip(),
                    from_addr=from_addr.strip().lower(),
                    to_addrs=[a.strip().lower() for a in to_addrs],
                    date=parse_date(msg.get("Date")),
                    body_raw=body,
                ), is_html
            except Exception:
                continue
    finally:
        box.close()
