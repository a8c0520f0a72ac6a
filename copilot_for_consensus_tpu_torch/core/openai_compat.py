"""Shared HTTP plumbing for the OpenAI-compatible drivers.

One place for the conventions both the summarizer and the embedding
provider need (and must keep in lockstep): base-url joining, Azure
``api-version`` query + ``api-key`` header vs plain ``Authorization:
Bearer``, the 429 Retry-After contract (numeric seconds OR an RFC 7231
HTTP date — some API-gateway front-ends send the latter), and the
mapping of transport/JSON failures onto each driver's exception type.
"""

from __future__ import annotations

import email.utils
import json
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Any


def parse_retry_after(value: str | None, default: float = 1.0) -> float:
    """Seconds to wait from a Retry-After header: numeric or HTTP-date
    (RFC 7231 allows both); unparseable values fall back, never raise."""
    if not value:
        return default
    try:
        return max(0.0, float(value))
    except ValueError:
        pass
    try:
        dt = email.utils.parsedate_to_datetime(value)
    except (TypeError, ValueError):
        return default
    if dt is None:
        return default
    return max(0.0, dt.timestamp() - time.time())


def openai_post(base_url: str, path: str, payload: dict[str, Any], *,
                api_key: str = "", api_version: str = "",
                timeout_s: float = 60.0,
                error_cls: type[Exception] = RuntimeError,
                rate_limit_cls: type[Exception] | None = None
                ) -> dict[str, Any]:
    """POST ``{base_url}{path}`` with OpenAI/Azure auth conventions.

    Raises ``rate_limit_cls(detail, retry_after_s=...)`` on 429 (when
    given) and ``error_cls`` for every other transport/format failure —
    callers never see raw urllib exceptions."""
    url = base_url.rstrip("/") + path
    headers = {"Content-Type": "application/json"}
    if api_version:                     # Azure OpenAI conventions
        url += f"?api-version={urllib.parse.quote(api_version)}"
        if api_key:
            headers["api-key"] = api_key
    elif api_key:
        headers["Authorization"] = f"Bearer {api_key}"
    req = urllib.request.Request(url, method="POST",
                                 data=json.dumps(payload).encode(),
                                 headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        detail = exc.read()[:500].decode("utf-8", "replace")
        if exc.code == 429 and rate_limit_cls is not None:
            raise rate_limit_cls(
                detail,
                retry_after_s=parse_retry_after(
                    exc.headers.get("Retry-After")))
        raise error_cls(f"backend HTTP {exc.code}: {detail}") from exc
    except urllib.error.URLError as exc:
        raise error_cls(f"backend unreachable: {exc}") from exc
    except json.JSONDecodeError as exc:
        raise error_cls(f"backend returned non-JSON: {exc}") from exc
    except (TimeoutError, OSError) as exc:
        # urlopen wraps connect-phase timeouts in URLError, but a stall
        # DURING resp.read() raises raw TimeoutError/OSError — callers
        # must never see raw transport exceptions.
        raise error_cls(f"backend timed out mid-response: {exc}") from exc


def azure_default_api_version(driver: str, configured: str) -> str:
    """Factory-shared default: azure_openai gets a pinned api-version
    unless the config overrides it."""
    return configured or ("2024-02-01" if driver == "azure_openai"
                          else "")
