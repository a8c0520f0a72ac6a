"""ArchiveFetcher ABC + drivers.

Reference surface: ``copilot_archive_fetcher/base.py:13`` with HTTP /
IMAP / Local / Rsync drivers and ``SourceConfig`` (``models.py:22``).
This container is zero-egress, so the network drivers (http, imap,
rsync) exist as config-selectable stubs that fail with a clear error
unless the runtime has network access; ``local`` and ``mock`` carry the
pipeline.
"""

from __future__ import annotations

import abc
import pathlib
from dataclasses import dataclass, field
from typing import Any, Iterator


class FetchError(Exception):
    pass


@dataclass
class SourceConfig:
    name: str
    fetcher: str = "local"                 # local|http|imap|rsync|mock
    location: str = ""                     # path / url / server
    enabled: bool = True
    schedule_seconds: int = 0              # 0 = manual trigger only
    options: dict[str, Any] = field(default_factory=dict)


@dataclass
class FetchedArchive:
    uri: str                               # where it came from
    filename: str
    content: bytes


class ArchiveFetcher(abc.ABC):
    @abc.abstractmethod
    def fetch(self, source: SourceConfig) -> Iterator[FetchedArchive]:
        """Yield archives for the source (an mbox file each)."""


class LocalFetcher(ArchiveFetcher):
    """Reads mbox files from a local path (file or directory)."""

    def fetch(self, source: SourceConfig) -> Iterator[FetchedArchive]:
        path = pathlib.Path(source.location)
        if not path.exists():
            raise FetchError(f"local path does not exist: {path}")
        files = [path] if path.is_file() else sorted(
            p for p in path.iterdir()
            if p.is_file() and p.suffix in (".mbox", ".mail", ".txt", ""))
        for f in files:
            yield FetchedArchive(uri=str(f), filename=f.name,
                                 content=f.read_bytes())


class MockFetcher(ArchiveFetcher):
    """Returns canned archives injected at construction (tests)."""

    def __init__(self, archives: list[FetchedArchive] | None = None):
        self.archives = archives or []

    def fetch(self, source: SourceConfig) -> Iterator[FetchedArchive]:
        yield from self.archives


class HTTPFetcher(ArchiveFetcher):
    """Downloads archives over HTTP(S) (stdlib urllib; reference
    ``http_fetcher.py:15``). Fails fast in zero-egress environments."""

    def __init__(self, timeout_s: float = 30.0):
        self.timeout_s = timeout_s

    def fetch(self, source: SourceConfig) -> Iterator[FetchedArchive]:
        import urllib.error
        import urllib.request

        try:
            with urllib.request.urlopen(source.location,
                                        timeout=self.timeout_s) as resp:
                content = resp.read()
        except (urllib.error.URLError, OSError) as exc:
            raise FetchError(f"http fetch failed for {source.location}: "
                             f"{exc}") from exc
        name = source.location.rstrip("/").rsplit("/", 1)[-1] or "archive.mbox"
        yield FetchedArchive(uri=source.location, filename=name, content=content)


class IMAPFetcher(ArchiveFetcher):
    """IMAP mailbox export (reference ``imap_fetcher.py:17``). Requires
    network; options: mailbox, username, password_secret."""

    def fetch(self, source: SourceConfig) -> Iterator[FetchedArchive]:
        import imaplib

        opts = source.options
        try:
            conn = imaplib.IMAP4_SSL(source.location)
            conn.login(opts.get("username", ""), opts.get("password", ""))
            conn.select(opts.get("mailbox", "INBOX"), readonly=True)
            _, data = conn.search(None, "ALL")
            lines = []
            for num in data[0].split():
                _, msg_data = conn.fetch(num, "(RFC822)")
                raw = msg_data[0][1]
                lines.append(b"From fetcher@imap\n" + raw + b"\n")
            conn.logout()
        except (OSError, imaplib.IMAP4.error) as exc:
            raise FetchError(f"imap fetch failed for {source.location}: "
                             f"{exc}") from exc
        yield FetchedArchive(uri=f"imap://{source.location}",
                             filename=f"{source.name}.mbox",
                             content=b"".join(lines))


class RsyncFetcher(ArchiveFetcher):
    """rsync-based mirror (reference ``rsync_fetcher.py:16``): syncs the
    remote path into a scratch dir, then reads like LocalFetcher."""

    def __init__(self, scratch_dir: str = "/tmp/copilot-rsync"):
        self.scratch_dir = scratch_dir

    def fetch(self, source: SourceConfig) -> Iterator[FetchedArchive]:
        import subprocess

        dest = pathlib.Path(self.scratch_dir) / source.name
        dest.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run(
            ["rsync", "-az", "--timeout=60", source.location, str(dest) + "/"],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise FetchError(f"rsync failed for {source.location}: "
                             f"{proc.stderr.strip()}")
        yield from LocalFetcher().fetch(
            SourceConfig(name=source.name, location=str(dest)))
