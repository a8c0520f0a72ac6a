"""Azure Blob Storage archive store — REST API, no SDK.

The reference's ``AzureBlobArchiveStore``
(``copilot_archive_store/azure_blob_archive_store.py``) rides the Azure
SDK; this image has no Azure SDKs and no egress, so the driver speaks
the Blob REST API directly with stdlib HTTP and Shared Key
authorization (the documented HMAC-SHA256 scheme over the canonicalized
request). That makes it testable against an in-process mock implementing
the same wire contract (``tests/test_azure_drivers.py``) and usable
against real Azure (or Azurite) wherever the runtime has network access.

Auth: ``account_key`` (Shared Key) or a pre-issued ``sas_token``. One
blob per archive at ``{container}/{archive_id}.mbox``.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import time
import urllib.error
import urllib.parse
import urllib.request
from email.utils import formatdate

from copilot_for_consensus_tpu_torch.archive.base import (
    ArchiveStore,
    ArchiveStoreError,
    validate_archive_id,
)

API_VERSION = "2021-08-06"


def _shared_key_signature(account: str, key_b64: str, method: str,
                          url: str, headers: dict[str, str],
                          content_length: int) -> str:
    """Authorization: SharedKey — sign the canonicalized request exactly
    as documented (headers sorted, x-ms-* only; canonicalized resource
    from the path + sorted query params)."""
    parsed = urllib.parse.urlparse(url)
    ms_headers = sorted((k.lower(), v) for k, v in headers.items()
                        if k.lower().startswith("x-ms-"))
    canon_headers = "".join(f"{k}:{v}\n" for k, v in ms_headers)
    canon_resource = f"/{account}{parsed.path}"
    if parsed.query:
        q = urllib.parse.parse_qs(parsed.query, keep_blank_values=True)
        for k in sorted(q):
            canon_resource += f"\n{k.lower()}:{','.join(sorted(q[k]))}"
    string_to_sign = "\n".join([
        method,
        "",                                     # Content-Encoding
        "",                                     # Content-Language
        str(content_length) if content_length else "",
        "",                                     # Content-MD5
        headers.get("Content-Type", ""),
        "",                                     # Date (x-ms-date used)
        "", "", "", "", "",                     # If-*/Range
    ]) + "\n" + canon_headers + canon_resource
    mac = hmac.new(base64.b64decode(key_b64), string_to_sign.encode(),
                   hashlib.sha256)
    return f"SharedKey {account}:{base64.b64encode(mac.digest()).decode()}"


class AzureBlobArchiveStore(ArchiveStore):
    def __init__(self, account: str, container: str, *,
                 account_key: str = "", sas_token: str = "",
                 endpoint: str = "", timeout_s: float = 30.0):
        if not account or not container:
            raise ValueError("azure_blob needs account and container")
        if not account_key and not sas_token:
            raise ValueError("azure_blob needs account_key or sas_token")
        self.account = account
        self.container = container
        self.account_key = account_key
        self.sas_token = sas_token.lstrip("?")
        # endpoint override serves Azurite and the contract-test mock
        self.endpoint = (endpoint.rstrip("/")
                         or f"https://{account}.blob.core.windows.net")
        self.timeout_s = timeout_s

    def _url(self, archive_id: str) -> str:
        validate_archive_id(archive_id)
        url = f"{self.endpoint}/{self.container}/{archive_id}.mbox"
        if self.sas_token:
            url += "?" + self.sas_token
        return url

    def _request(self, method: str, archive_id: str,
                 body: bytes | None = None,
                 extra_headers: dict[str, str] | None = None,
                 ok: tuple[int, ...] = (200,)) -> tuple[int, bytes]:
        url = self._url(archive_id)
        headers = {
            "x-ms-date": formatdate(time.time(), usegmt=True),
            "x-ms-version": API_VERSION,
            **(extra_headers or {}),
        }
        if body is not None:
            headers["Content-Type"] = "application/octet-stream"
        if self.account_key:
            headers["Authorization"] = _shared_key_signature(
                self.account, self.account_key, method, url, headers,
                len(body) if body else 0)
        req = urllib.request.Request(url, method=method, data=body,
                                     headers=headers)
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.timeout_s) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as exc:
            if exc.code in ok:
                return exc.code, exc.read()
            body = exc.read()[:200].decode("utf-8", "replace")
            # Azure signals the error class in x-ms-error-code (HEAD
            # 404s carry no body); fall back to sniffing the body XML.
            err_code = exc.headers.get("x-ms-error-code", "")
            if not err_code and "ContainerNotFound" in body:
                err_code = "ContainerNotFound"
            if exc.code == 404 and err_code != "ContainerNotFound":
                err = ArchiveStoreError(
                    f"archive not found: {archive_id}", status=404)
            else:
                err = ArchiveStoreError(
                    f"blob {method} failed: HTTP {exc.code} "
                    f"{body or err_code}", status=exc.code)
            err.error_code = err_code
            raise err from exc
        except (urllib.error.URLError, TimeoutError, OSError) as exc:
            raise ArchiveStoreError(f"blob endpoint unreachable: "
                                    f"{exc}") from exc

    def save(self, archive_id, content, metadata=None):
        extra = {"x-ms-blob-type": "BlockBlob"}
        seen: dict[str, str] = {}
        for k, v in (metadata or {}).items():
            # blob metadata keys must be C identifiers and values must
            # be header-safe — reject what Azure (or urllib's header
            # injection guard) would, as ArchiveStoreError rather than
            # a raw UnicodeEncodeError/ValueError escaping mid-save.
            safe = "".join(c if (c.isascii() and c.isalnum())
                           else "_" for c in str(k))
            if not safe or not (safe[0].isalpha() or safe[0] == "_"):
                raise ArchiveStoreError(
                    f"metadata key {k!r} is not a valid identifier")
            if safe in seen:
                raise ArchiveStoreError(
                    f"metadata keys {seen[safe]!r} and {k!r} collide "
                    f"as {safe!r}")
            seen[safe] = str(k)
            value = str(v)
            try:
                value.encode("ascii")
            except UnicodeEncodeError as exc:
                raise ArchiveStoreError(
                    f"metadata value for {k!r} is not header-safe "
                    f"(ascii only)") from exc
            if "\r" in value or "\n" in value:
                raise ArchiveStoreError(
                    f"metadata value for {k!r} contains line breaks")
            extra[f"x-ms-meta-{safe}"] = value
        status, _ = self._request("PUT", archive_id, body=bytes(content),
                                  extra_headers=extra, ok=(201,))
        return self._url(archive_id).split("?")[0]

    def load(self, archive_id):
        _, body = self._request("GET", archive_id)
        return body

    def exists(self, archive_id):
        try:
            self._request("HEAD", archive_id)
            return True
        except ArchiveStoreError as exc:
            # Branch on structured fields only: a 404 whose error code
            # is ContainerNotFound (misconfigured container) must
            # raise, not masquerade as blob-absent — and an archive id
            # that happens to CONTAIN that substring must not confuse
            # the classification.
            if exc.status == 404 and getattr(
                    exc, "error_code", "") != "ContainerNotFound":
                return False
            raise

    def delete(self, archive_id):
        try:
            self._request("DELETE", archive_id, ok=(202,))
            return True
        except ArchiveStoreError as exc:
            if exc.status == 404 and getattr(
                    exc, "error_code", "") != "ContainerNotFound":
                return False
            raise
