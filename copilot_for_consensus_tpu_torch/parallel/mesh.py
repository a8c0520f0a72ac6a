"""The device mesh on ``torch.distributed`` — port of the JAX package's
``parallel/mesh.py``.

The JAX package is single-controller: one process sees every device and a
``jax.sharding.Mesh`` names their axes. PyTorch runs one process a rank,
so here a mesh is this rank's view of the job: the axis sizes (``shape``,
a mapping, as a JAX mesh gives it), this rank's coordinate on each axis,
the process group of each axis (None at size 1: a size-1 axis has no
collective, as GSPMD emits none) and this rank's device. The groups come
from ``torch.distributed.device_mesh.init_device_mesh`` with the axis
names ``MESH_AXES``; a mesh of one rank needs no process group at all.

Axis order is (dp, pp, sp, ep, tp) with tp innermost, so the ranks of a
tp group are adjacent: on one host they are the cards NVLink joins.
"""

from __future__ import annotations

import datetime
import math
from dataclasses import dataclass

import torch

MESH_AXES = ("dp", "pp", "sp", "ep", "tp")

#: how long a collective of a mesh group waits for its peers before it
#: fails: ranks that diverge must fail, not hang
DEFAULT_TIMEOUT_S = 300.0


@dataclass(frozen=True)
class MeshConfig:
    """Logical mesh shape. Product must equal the device count.

    Leave ``tp`` at 0 to auto-fill it with the remaining devices (serving
    default: shard the model), or set ``tp`` and leave ``dp`` at 0 to
    auto-fill the data axis instead.
    """

    dp: int = 1
    pp: int = 1
    sp: int = 1
    ep: int = 1
    tp: int = 0

    def resolve(self, n_devices: int) -> "MeshConfig":
        dp, pp, sp, ep, tp = self.dp, self.pp, self.sp, self.ep, self.tp
        if tp == 0:
            fixed = max(1, dp) * max(1, pp) * max(1, sp) * max(1, ep)
            if n_devices % fixed:
                raise ValueError(
                    f"mesh axes dp={dp} pp={pp} sp={sp} ep={ep} do not "
                    f"divide {n_devices} devices"
                )
            tp = n_devices // fixed
        elif dp == 0:
            fixed = max(1, pp) * max(1, sp) * max(1, ep) * tp
            if n_devices % fixed:
                raise ValueError(
                    f"mesh axes pp={pp} sp={sp} ep={ep} tp={tp} do not "
                    f"divide {n_devices} devices"
                )
            dp = n_devices // fixed
        total = max(1, dp) * max(1, pp) * max(1, sp) * max(1, ep) * tp
        if total != n_devices:
            raise ValueError(
                f"mesh {dp}x{pp}x{sp}x{ep}x{tp}={total} != "
                f"{n_devices} devices"
            )
        return MeshConfig(max(1, dp), max(1, pp), max(1, sp), max(1, ep),
                          tp)

    @property
    def shape(self) -> tuple[int, int, int, int, int]:
        return (self.dp, self.pp, self.sp, self.ep, self.tp)


class Mesh:
    """This rank's view of a resolved mesh.

    ``shape``: axis → size; ``axis_names``: ``MESH_AXES``; ``coords``: axis
    → this rank's coordinate; :meth:`group`: an axis's process group (None
    at size 1); ``world``: the world group (None for one rank), over which
    host decisions are broadcast from its first rank (``is_first``);
    ``device``: this rank's device (None
    given: the card, resolved when read). ``device_mesh`` is the
    ``DeviceMesh`` the groups came from (None for one rank)."""

    axis_names = MESH_AXES

    def __init__(self, config: MeshConfig, *, device_mesh=None,
                 coords: dict | None = None, device=None):
        self.config = config
        self.shape = dict(zip(MESH_AXES, config.shape))
        self.coords = dict(coords) if coords else dict.fromkeys(MESH_AXES, 0)
        self.device_mesh = device_mesh
        self._device = device

    @property
    def size(self) -> int:
        """Ranks the mesh spans."""
        return math.prod(self.shape.values())

    @property
    def device(self) -> torch.device:
        from copilot_for_consensus_tpu_torch.device import resolve_device

        return resolve_device(self._device)

    @property
    def world(self):
        """The group of every rank of the mesh (None for one rank)."""
        if self.size == 1:
            return None
        import torch.distributed as dist

        return dist.group.WORLD

    @property
    def is_first(self) -> bool:
        """Whether this rank is the world's first (rank 0), where the
        mesh's host decisions are taken and host-only stores (the request
        journal) live. True for a mesh of one rank; a view with no process
        group is first where every coordinate is 0."""
        if self.size == 1:
            return True
        import torch.distributed as dist

        if not dist.is_initialized():
            return not any(self.coords.values())
        return dist.get_rank() == 0

    def group(self, axis: str):
        """The process group of ``axis`` holding this rank; None where the
        axis has size 1."""
        if axis not in self.shape:
            raise KeyError(f"unknown mesh axis {axis!r}; one of {MESH_AXES}")
        if self.shape[axis] == 1:
            return None
        return self.device_mesh.get_group(axis)


def _group_options(backend: str, timeout_s: float):
    """Backend options carrying the collectives' timeout, for every group
    the device mesh creates."""
    import torch.distributed as dist

    opts = dist.ProcessGroupNCCL.Options() if backend == "nccl" \
        else dist.ProcessGroupGloo._Options()
    opts._timeout = datetime.timedelta(seconds=timeout_s)
    return opts


def build_mesh(config: MeshConfig | None = None,
               devices: list[int] | None = None, *,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """Build the 5-axis mesh over every rank of the process group (or the
    ranks ``devices`` lists, in that order).

    One rank builds a mesh with every axis 1, whether or not a process
    group exists; its device is the card unless the engine is given
    another. Otherwise the process group must be initialized
    (``parallel.multihost.initialize_multihost``): the groups come from
    ``init_device_mesh`` on the backend's device type (gloo: the CPU;
    NCCL: this rank's card), each with ``timeout_s``. The mesh's device
    is this rank's card on NCCL; on gloo it is left unset, so that an
    engine given no ``device`` still asks for the card."""
    import torch.distributed as dist

    n = len(devices) if devices is not None else _world_size()
    cfg = (config or MeshConfig()).resolve(n)
    if n == 1:
        return Mesh(cfg)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"a mesh of {n} ranks needs the process group: call "
            f"parallel.multihost.initialize_multihost first")
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    backend = dist.get_backend()
    device_type = "cuda" if backend == "nccl" else "cpu"
    override = {ax: (backend, _group_options(backend, timeout_s))
                for ax, size in zip(MESH_AXES, cfg.shape) if size > 1}
    if devices is None:
        dm = init_device_mesh(device_type, cfg.shape,
                              mesh_dim_names=MESH_AXES,
                              backend_override=override)
    else:
        dm = DeviceMesh(device_type,
                        torch.tensor(list(devices)).reshape(cfg.shape),
                        mesh_dim_names=MESH_AXES,
                        backend_override=tuple(
                            override.get(ax, (None, None))
                            for ax in MESH_AXES))
    coords = dict(zip(MESH_AXES, dm.get_coordinate()))
    # NCCL: this rank's card. gloo: None, which still means the card, so
    # an engine reaches the CPU only when it is given device="cpu"
    device = torch.device("cuda", torch.cuda.current_device()) \
        if device_type == "cuda" else None
    return Mesh(cfg, device_mesh=dm, coords=coords, device=device)


def _world_size() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def local_mesh(tp: int | None = None) -> Mesh:
    """Convenience single-axis-of-interest mesh on the job's ranks: all
    tp."""
    n = _world_size()
    t = tp or n
    if n % t:
        raise ValueError(f"tp={t} does not divide {n} devices")
    return build_mesh(MeshConfig(dp=n // t, tp=t))


def retrieval_mesh(n_devices: int | None = None) -> Mesh:
    """ANN retrieval plane: dp-only mesh — every rank owns one
    posting-list shard, no tp axis (the candidate rescore is a
    shard-local matvec with a host top-k merge)."""
    n = n_devices if n_devices is not None else _world_size()
    return build_mesh(MeshConfig(dp=n, tp=1), devices=list(range(n)))


def largest_pow2_leq(n: int) -> int:
    return 1 << (n.bit_length() - 1) if n else 1


def auto_mesh_for_serving(n_devices: int | None = None) -> Mesh:
    """Serving default: tp = largest power of two ≤ device count, dp
    rest."""
    n = n_devices if n_devices is not None else _world_size()
    tp = largest_pow2_leq(n)
    while n % tp:
        tp //= 2
    return build_mesh(MeshConfig(dp=n // tp, tp=tp),
                      devices=list(range(n)))
