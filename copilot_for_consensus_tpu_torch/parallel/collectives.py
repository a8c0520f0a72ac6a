"""The collectives GSPMD inserts in the JAX package, written out.

In the JAX package one program spans the mesh and XLA inserts every
collective its shardings need. Here each rank runs its own program, so
each of those collectives is a call: the tp all-reduce after a
row-parallel matmul, the tp all-gather of vocab-sharded logits, the dp
all-gather of a dispatch's rows, and the broadcast of a host decision from
rank 0 (every rank must decide alike, or the next collective hangs).

Each takes a process group; a mesh passes None for an axis of size 1, and
the helper is then a no-op that launches nothing. The tensor helpers use
only preallocated outputs and no host sync, so a CUDA graph can capture
them on NCCL (:func:`capture_supported` tells whether this build can).
"""

from __future__ import annotations

from typing import Any

import torch


def _dist():
    import torch.distributed as dist

    return dist


def _size(group) -> int:
    return 1 if group is None else _dist().get_world_size(group)


def _gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """[N, ...] on every rank → [n·N, ...], rank-major."""
    dist = _dist()
    n = dist.get_world_size(group)
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, x.contiguous(), group=group)
    return out


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over ``group`` in place (the tp all-reduce after a
    row-parallel matmul); returns ``x``."""
    if group is not None:
        _dist().all_reduce(x, group=group)
    return x


def all_gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """Concatenate ``x``'s last dim over ``group`` in rank order (the tp
    all-gather of vocab-sharded logits ``[.., V/tp]`` → ``[.., V]``)."""
    if group is None:
        return x
    n = _size(group)
    lead, last = x.shape[:-1], x.shape[-1]
    flat = _gather_rows(x.reshape(-1, last), group)       # [n·M, V/n]
    return flat.view(n, -1, last).permute(1, 0, 2).reshape(*lead, n * last)


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Concatenate ``x``'s first dim over ``group`` in rank order (the dp
    all-gather of a dispatch's rows: each dp group's logits or tokens →
    the whole batch on every rank)."""
    if group is None:
        return x
    return _gather_rows(x, group)


def broadcast_decision(obj: Any, group) -> Any:
    """``obj`` as the group's first rank holds it, on every rank of
    ``group`` (a host decision taken on rank 0: one that reads a clock).
    Picklable objects; one host round trip."""
    if group is None:
        return obj
    dist = _dist()
    box = [obj]
    dist.broadcast_object_list(
        box, src=dist.get_global_rank(group, 0), group=group)
    return box[0]


def capture_supported(group, device: torch.device) -> tuple[bool, str]:
    """Whether a collective of ``group`` can be captured in a CUDA graph
    and replayed on this build: an all-reduce runs eagerly once (the
    communicator exists before any capture), is captured, and the graph
    is replayed and checked. Returns (ok, reason)."""
    if group is None:
        return True, "no collective"
    if device.type != "cuda":
        return False, "graphs capture CUDA work only"
    try:
        x = torch.ones(8, device=device)
        all_reduce(x, group)
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            all_reduce(x, group)
        x.fill_(1.0)
        graph.replay()
        torch.cuda.synchronize(device)
        want = float(_size(group))
        if not bool((x == want).all()):
            return False, (f"a replayed all-reduce gave {x.tolist()}, "
                           f"not {want}")
    except Exception as exc:                       # the reason is reported
        return False, f"{type(exc).__name__}: {exc}"
    return True, "captured and replayed an all-reduce"
