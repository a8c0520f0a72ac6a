"""Multi-process join on ``torch.distributed`` — port of the JAX package's
``parallel/multihost.py``.

Every process of a job runs the same script (one rank a process, as
``torchrun`` or ``torch.multiprocessing.spawn`` start them) and joins one
process group before it builds a mesh (``parallel.mesh.build_mesh``):
NCCL between cards by default, gloo on the CPU only when asked for. Geometry comes from the config, as in
the JAX package: an explicit ``coordinator_address`` ("host:port" of rank
0's store), ``num_processes`` and ``process_id``; with no coordinator the
launcher's environment (``torchrun``'s ``env://``) gives them.

Usage (each rank):

    from copilot_for_consensus_tpu_torch.parallel.multihost import (
        MultiHostConfig, initialize_multihost)
    initialize_multihost(MultiHostConfig(
        coordinator_address="host0:29500", num_processes=4, process_id=i,
        local_device_ids=(i,)))
    mesh = build_mesh(MeshConfig(dp=2, tp=2))
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Any, Mapping

from copilot_for_consensus_tpu_torch.parallel.mesh import DEFAULT_TIMEOUT_S


@dataclass(frozen=True)
class MultiHostConfig:
    """Explicit job geometry; every field None = the launcher's
    environment (``env://``).

    coordinator_address: "host:port" of process 0's store.
    num_processes: total processes in the job.
    process_id: this process's rank in [0, num_processes).
    local_device_ids: this process's card(s); the first is its device
        (None: rank modulo the cards of the host).
    """

    coordinator_address: str | None = None
    num_processes: int | None = None
    process_id: int | None = None
    local_device_ids: tuple[int, ...] | None = None

    @classmethod
    def from_config(cls, cfg: Mapping[str, Any] | bool | None
                    ) -> "MultiHostConfig":
        # `multihost: true` in a config file means "auto-discover",
        # same as an empty section.
        c = dict(cfg) if isinstance(cfg, Mapping) else {}
        ids = c.get("local_device_ids")
        return cls(
            coordinator_address=c.get("coordinator_address"),
            num_processes=c.get("num_processes"),
            process_id=c.get("process_id"),
            local_device_ids=tuple(ids) if ids is not None else None,
        )

    @property
    def is_explicit(self) -> bool:
        return self.coordinator_address is not None

    def validate(self) -> None:
        if not self.is_explicit:
            if (self.num_processes is not None
                    or self.process_id is not None
                    or self.local_device_ids is not None):
                raise ValueError(
                    "num_processes/process_id/local_device_ids given "
                    "without coordinator_address — explicit geometry "
                    "needs the coordinator (or omit everything for the "
                    "launcher's environment)")
            return
        if self.num_processes is None or self.process_id is None:
            raise ValueError(
                "explicit multihost config needs num_processes and "
                "process_id alongside coordinator_address")
        if not (0 <= self.process_id < self.num_processes):
            raise ValueError(
                f"process_id {self.process_id} out of range for "
                f"{self.num_processes} processes")


def initialize_multihost(cfg: MultiHostConfig | Mapping[str, Any] | None
                         = None, *, backend: str = "nccl",
                         timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group on ``backend``: "nccl" (the default) between
    cards, raising when this host has none; "gloo" on the CPU, only when
    the caller names it. Returns True if this call initialized the group,
    False if it was a no-op (already initialized, or a one-process
    config). Collectives on the world group fail after ``timeout_s``."""
    import torch
    import torch.distributed as dist

    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: one of 'nccl', 'gloo'")
    if not isinstance(cfg, MultiHostConfig):
        cfg = MultiHostConfig.from_config(cfg)
    cfg.validate()
    if dist.is_initialized():
        return False
    if cfg.is_explicit and cfg.num_processes == 1:
        return False                       # nothing to coordinate
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError(
            "initialize_multihost(backend='nccl') needs a CUDA device and "
            "none is available; pass backend='gloo' to join on the CPU")
    timeout = datetime.timedelta(seconds=timeout_s)
    if cfg.is_explicit:
        kwargs = dict(init_method=f"tcp://{cfg.coordinator_address}",
                      world_size=cfg.num_processes, rank=cfg.process_id)
    else:
        kwargs = dict(init_method="env://")
    if backend == "nccl":
        # the rank's card before the group: NCCL binds its communicator to
        # the current device
        ids = cfg.local_device_ids
        rank = cfg.process_id if cfg.is_explicit else None
        if ids:
            torch.cuda.set_device(ids[0])
        elif rank is not None:
            torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, timeout=timeout, **kwargs)
    if backend == "nccl" and not cfg.local_device_ids \
            and not cfg.is_explicit:
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return True


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def is_multihost() -> bool:
    return process_count() > 1


def default_store():
    """The key-value store the process group joined through (tcp://: the
    TCPStore rank 0 serves; a FileStore where one was given): the ranks'
    channel outside every collective. Raises when no group is joined."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d

    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_multihost "
                           "first")
    return distributed_c10d._get_default_store()
