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

One helper is no collective: :class:`ControlChannel` carries rank 0's
messages to the other ranks through the process group's store, so that a
rank waiting for rank 0's next word waits in no group (the async runner's
operation log, ``engine/mesh_runner.py``).
"""

from __future__ import annotations

import pickle
import threading
import time
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


#: what a collective's (or the store's) error says when a peer died or did
#: not answer within the groups' timeout
_PEER_MARKERS = ("gloo/transport", "Connection reset by peer",
                 "Connection closed by peer", "Timed out waiting",
                 "ProcessGroupNCCL", "ProcessGroupGloo", "NCCL error",
                 "Broken pipe")


def is_collective_failure(exc: BaseException) -> bool:
    """Whether ``exc`` is a collective or the store failing on a peer: a
    rank that died, or one that did not answer within the timeout."""
    if isinstance(exc, getattr(_dist(), "DistError", ())):
        return True
    msg = str(exc)
    return any(m in msg for m in _PEER_MARKERS)


class ChannelLost(RuntimeError):
    """The channel's publisher is gone: the store's connection to it broke,
    or its heartbeat stood still for longer than the reader allows."""


#: a waiting reader's pause between two reads of the store
_MIN_PAUSE_S, _MAX_PAUSE_S = 0.0002, 0.01
#: the base store's key rank 0's heartbeat counts up
HEARTBEAT_KEY = "ctl/heartbeat"
#: stores whose heartbeat thread runs in this process, by id
_BEATING: dict[int, threading.Thread] = {}
_BEAT_LOCK = threading.Lock()


def start_heartbeat(store, every_s: float = 1.0) -> None:
    """Count ``store``'s heartbeat up every ``every_s`` for the life of the
    process (rank 0; once a store). Readers of a :class:`ControlChannel`
    tell a quiet publisher from a dead one by it; the thread ends when the
    store does."""
    with _BEAT_LOCK:
        if id(store) in _BEATING:
            return

        tick = threading.Event()

        def beat():
            while True:
                try:
                    store.add(HEARTBEAT_KEY, 1)
                except Exception:     # the store is gone: so is the job
                    return
                tick.wait(every_s)

        t = threading.Thread(target=beat, daemon=True, name="ctl-heartbeat")
        _BEATING[id(store)] = t
        t.start()


class ControlChannel:
    """An ordered stream of picklable messages from rank 0 to every other
    rank, through the process group's key-value store (``Mesh.store``)
    under the prefix ``ctl/<name>/``: no process group takes part, so a
    reader may wait as long as rank 0 is idle without any collective
    timing out. Message ``k`` is key ``m<k>``; each reader counts itself
    in ``a<k>`` once it holds the message, and the last one deletes both
    (a lone reader deletes the message at once).

    :meth:`receive` reads whether the message is there, backing off from
    0.2 ms to 10 ms between reads, and every ``poll_s`` reads rank 0's
    heartbeat (:func:`start_heartbeat`); a store connection that breaks
    (rank 0 serves the TCPStore of a ``tcp://`` join) or a heartbeat that
    stands still for ``dead_after_s`` raises :class:`ChannelLost`."""

    def __init__(self, store, name: str, readers: int, *,
                 dead_after_s: float = 60.0, poll_s: float = 0.5):
        dist = _dist()
        self._base = store
        self._store = dist.PrefixStore(f"ctl/{name}/", store)
        self.readers = readers
        self.dead_after_s = float(dead_after_s)
        self.poll_s = float(poll_s)
        self._seq = 0
        self._tick = threading.Event()
        #: bytes and seconds: pickling and the store's round trips only
        #: (a reader's wait for the next message is ``wait_s``)
        self.bytes = 0
        self.io_s = 0.0
        self.wait_s = 0.0

    def publish(self, obj: Any) -> int:
        """Append ``obj`` to the stream (rank 0): one store round trip,
        never a wait for the readers. Returns its sequence number."""
        t0 = time.perf_counter()
        data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        self._seq += 1
        self._store.set(f"m{self._seq}", data)
        self.bytes += len(data)
        self.io_s += time.perf_counter() - t0
        return self._seq

    def receive(self) -> Any:
        """The next message (any other rank), waiting as long as the
        publisher lives."""
        key = f"m{self._seq + 1}"
        t0 = time.perf_counter()
        pause, beat = 0.0, None
        since = next_beat = time.monotonic()
        while True:
            try:
                if self._store.check([key]):
                    break
                now = time.monotonic()
                if now >= next_beat:
                    next_beat = now + self.poll_s
                    now_beat = self._base.add(HEARTBEAT_KEY, 0)
                    if now_beat != beat:
                        beat, since = now_beat, now
            except Exception as exc:
                raise ChannelLost(
                    f"rank 0's store is gone while waiting for message "
                    f"{self._seq + 1}: {type(exc).__name__}: {exc}") from exc
            if now - since > self.dead_after_s:
                raise ChannelLost(
                    f"rank 0's heartbeat stood still for "
                    f"{self.dead_after_s:.0f} s while waiting for message "
                    f"{self._seq + 1}")
            # back off from 0.2 ms to 10 ms: a message that follows a step
            # is seen within a fraction of a millisecond, an idle wait
            # costs a hundred store reads a second
            pause = min(_MAX_PAUSE_S, pause * 2 or _MIN_PAUSE_S)
            self._tick.wait(pause)
        t1 = time.perf_counter()
        self.wait_s += t1 - t0
        data = self._store.get(key)
        self._seq += 1
        if self.readers == 1:
            self._store.delete_key(key)
        elif self._store.add(f"a{self._seq}", 1) >= self.readers:
            self._store.delete_key(key)
            self._store.delete_key(f"a{self._seq}")
        self.bytes += len(data)
        obj = pickle.loads(data)
        self.io_s += time.perf_counter() - t1
        return obj
