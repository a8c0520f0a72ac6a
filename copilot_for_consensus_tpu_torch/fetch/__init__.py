"""Archive fetchers (reference: ``adapters/copilot_archive_fetcher``)."""

from copilot_for_consensus_tpu_torch.fetch.base import (
    ArchiveFetcher,
    FetchedArchive,
    FetchError,
    LocalFetcher,
    MockFetcher,
    SourceConfig,
)
from copilot_for_consensus_tpu_torch.fetch.factory import create_archive_fetcher

__all__ = [
    "ArchiveFetcher",
    "FetchedArchive",
    "FetchError",
    "LocalFetcher",
    "MockFetcher",
    "SourceConfig",
    "create_archive_fetcher",
]
