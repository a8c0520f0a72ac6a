"""Text normalization: HTML → text, signature and quoted-reply stripping.

Role parity with the reference's ``parsing/app/normalizer.py:17`` (html
strip, signature removal ``:128``, quoted-reply removal ``:144``). The
normalized body is what gets chunked and embedded, so aggressive cleanup
here directly improves retrieval quality.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from html.parser import HTMLParser


class _HTMLToText(HTMLParser):
    _BLOCK_TAGS = {"p", "div", "br", "li", "tr", "h1", "h2", "h3", "h4",
                   "blockquote", "pre"}
    _SKIP_TAGS = {"script", "style", "head"}

    def __init__(self):
        super().__init__(convert_charrefs=True)
        self.parts: list[str] = []
        self._skip_depth = 0

    def handle_starttag(self, tag, attrs):
        if tag in self._SKIP_TAGS:
            self._skip_depth += 1
        elif tag in self._BLOCK_TAGS:
            self.parts.append("\n")

    def handle_endtag(self, tag):
        if tag in self._SKIP_TAGS and self._skip_depth > 0:
            self._skip_depth -= 1
        elif tag in self._BLOCK_TAGS:
            self.parts.append("\n")

    def handle_data(self, data):
        if not self._skip_depth:
            self.parts.append(data)


def html_to_text(html: str) -> str:
    parser = _HTMLToText()
    try:
        parser.feed(html)
        parser.close()
    except Exception:
        return re.sub(r"<[^>]+>", " ", html)
    return "".join(parser.parts)


# "-- " is the RFC 3676 signature delimiter; the rest are common manual ones.
_SIG_DELIMITERS = re.compile(
    r"^(--\s?$|__+$|Best regards,?$|Regards,?$|Cheers,?$|Thanks,?$|"
    r"Sent from my \w+)", re.IGNORECASE)

# "On <date>, <someone> wrote:" intro line for a quoted block.
_QUOTE_INTRO = re.compile(
    r"^On .{4,120}(wrote|writes):\s*$", re.IGNORECASE | re.DOTALL)

_FORWARD_MARKER = re.compile(
    r"^-{2,}\s*(Original Message|Forwarded message)\s*-{2,}", re.IGNORECASE)


@dataclass
class NormalizerConfig:
    strip_html: bool = True
    strip_signatures: bool = True
    strip_quoted_replies: bool = True
    max_consecutive_blank: int = 1


class TextNormalizer:
    def __init__(self, config: NormalizerConfig | None = None):
        self.config = config or NormalizerConfig()

    def normalize(self, body: str, is_html: bool = False) -> str:
        text = html_to_text(body) if (is_html and self.config.strip_html) else body
        text = text.replace("\r\n", "\n").replace("\r", "\n")
        lines = text.split("\n")
        if self.config.strip_quoted_replies:
            lines = self._strip_quotes(lines)
        if self.config.strip_signatures:
            lines = self._strip_signature(lines)
        return self._collapse(lines)

    def _strip_quotes(self, lines: list[str]) -> list[str]:
        out: list[str] = []
        i = 0
        while i < len(lines):
            line = lines[i]
            stripped = line.strip()
            if stripped.startswith(">"):
                i += 1
                continue
            # Multi-line "On ... wrote:" intro directly preceding a quote.
            joined = stripped
            if (_QUOTE_INTRO.match(joined)
                    and i + 1 < len(lines)
                    and lines[i + 1].strip().startswith(">")):
                i += 1
                continue
            if _FORWARD_MARKER.match(stripped):
                break  # drop everything after a forward marker
            out.append(line)
            i += 1
        return out

    def _strip_signature(self, lines: list[str]) -> list[str]:
        # Scan the last 12 lines for a signature delimiter; cut from there.
        window_start = max(0, len(lines) - 12)
        for i in range(window_start, len(lines)):
            if _SIG_DELIMITERS.match(lines[i].strip()):
                return lines[:i]
        return lines

    def _collapse(self, lines: list[str]) -> str:
        out: list[str] = []
        blanks = 0
        for line in lines:
            line = line.rstrip()
            if not line.strip():
                blanks += 1
                if blanks > self.config.max_consecutive_blank:
                    continue
            else:
                blanks = 0
            out.append(line)
        return "\n".join(out).strip()
