"""Raw-archive blob storage (reference: ``adapters/copilot_archive_store``)."""

from copilot_for_consensus_tpu_torch.archive.base import (
    ArchiveStore,
    InMemoryArchiveStore,
    LocalVolumeArchiveStore,
    create_archive_store,
)

__all__ = [
    "ArchiveStore",
    "InMemoryArchiveStore",
    "LocalVolumeArchiveStore",
    "create_archive_store",
]
