"""Fetcher driver registry."""

from __future__ import annotations

from typing import Any

from copilot_for_consensus_tpu_torch.core.factory import register_driver
from copilot_for_consensus_tpu_torch.fetch.base import (
    ArchiveFetcher,
    HTTPFetcher,
    IMAPFetcher,
    LocalFetcher,
    MockFetcher,
    RsyncFetcher,
)

_DRIVERS = {
    "local": LocalFetcher,
    "http": HTTPFetcher,
    "imap": IMAPFetcher,
    "rsync": RsyncFetcher,
    "mock": MockFetcher,
}


def create_archive_fetcher(config: Any = None, **kwargs: Any
                           ) -> ArchiveFetcher:
    driver = "local"
    if config is not None:
        driver = (config.get("driver", "local")
                  if isinstance(config, dict)
                  else getattr(config, "driver", "local"))
    cls = _DRIVERS.get(driver)
    if cls is None:
        raise ValueError(f"unknown archive_fetcher driver {driver!r}")
    return cls(**kwargs)


for _name in _DRIVERS:
    register_driver("archive_fetcher", _name, create_archive_fetcher)
