"""Driver registration shim (registration lives in base.py)."""

from copilot_for_consensus_tpu_torch.archive.base import (  # noqa: F401
    create_archive_store,
)
