"""Bounded device KV block pool — the paged engine's native layout.

Port of the JAX package's ``engine/kv_pool.py`` for one device. One pool
``[L, num_blocks, Hkv, block, Dh]`` backs every KV byte the paged engine
serves from: active slots map logical positions onto pool blocks through
per-slot block tables (position ``p`` of a slot lives at
``table[p // block]`` offset ``p % block``), and the radix prefix cache's
nodes reference the same blocks by id — so a prefix hit is a pointer
handoff (append the matched ids to the slot's table, pin them) and
publish-on-retire is a refcount handoff (the trie adopts the slot's own
blocks), neither of which moves a byte of KV.

The allocator is host Python with the reference's invariants (violations
raise — a silent double-assign would let two requests share one KV
timeline):

* a block id is in exactly one place: the free list, or assigned;
* ``free`` refuses ids that are already free (double-free) and ids with a
  nonzero pin count (a pinned block is visible to a reader);
* pins are counted, never boolean: the trie pins each published block
  once for itself, and lookups pin matched nodes per active request.
"""

from __future__ import annotations

import numpy as np
import torch

from copilot_for_consensus_tpu_torch.device import (
    resolve_device,
    storage_view,
    zeros,
)

#: dtype of every block table the paged dispatches consume
BLOCK_TABLE_DTYPE = np.int32


class KVPoolExhausted(RuntimeError):
    """The pool has no free block for a write the dispatch needs. The
    engine's free-block admission accounting makes this unreachable on
    the serving path."""

    def __init__(self, message: str, *, needed: int = 0, free: int = 0):
        super().__init__(message)
        self.needed = needed
        self.free = free
        #: resource-exhaustion classification, as in the reference
        self.resource_exhausted = True


class BlockPool:
    """Device KV blocks + the host allocator that owns them.

    ``k``/``v``: ``[L, num_blocks, Hkv, block, Dh]`` in the serving KV
    dtype on ``device`` (None → the card). ``num_blocks`` doubles as the
    out-of-range sentinel id: the attention kernel clamps it (the length
    mask hides what it reads), ``scatter`` drops it.
    """

    def __init__(self, cfg, *, num_blocks: int, block_size: int,
                 kv_dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device | None = None):
        if num_blocks < 1:
            raise ValueError("kv pool needs num_blocks >= 1")
        if block_size < 1:
            raise ValueError("kv pool needs block_size >= 1")
        self.block = int(block_size)
        self.num_blocks = int(num_blocks)
        shape = (cfg.n_layers, num_blocks, cfg.n_kv_heads, block_size,
                 cfg.head_dim)
        dev = resolve_device(device)
        self.k = zeros(shape, kv_dtype, dev)
        self.v = zeros(shape, kv_dtype, dev)
        self._free: list[int] = list(range(num_blocks))
        self._is_free = np.ones(num_blocks, dtype=bool)
        self._pins = np.zeros(num_blocks, dtype=np.int64)

    # -- introspection --------------------------------------------------

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def blocks_in_use(self) -> int:
        return self.num_blocks - self.free_blocks

    @property
    def pinned_blocks(self) -> int:
        """Blocks with at least one outstanding pin."""
        return int(np.count_nonzero(self._pins))

    def pins(self, bid: int) -> int:
        return int(self._pins[bid])

    def is_free(self, bid: int) -> bool:
        return bool(self._is_free[bid])

    # -- allocation -----------------------------------------------------

    def alloc(self, n: int = 1) -> list[int]:
        """Take ``n`` blocks off the free list. All-or-nothing: a partial
        grant would leave the caller's table covering less of the
        timeline than its positions claim."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            raise KVPoolExhausted(
                f"kv pool exhausted: need {n} blocks, {len(self._free)} "
                f"free of {self.num_blocks}", needed=n,
                free=len(self._free))
        out = [self._free.pop() for _ in range(n)]
        self._is_free[out] = False
        return out

    def free(self, bids) -> None:
        """Return blocks to the free list. Double-free and
        free-while-pinned raise."""
        for bid in bids:
            bid = int(bid)
            if not 0 <= bid < self.num_blocks:
                raise ValueError(f"free of out-of-range block {bid}")
            if self._is_free[bid]:
                raise ValueError(f"double free of block {bid}")
            if self._pins[bid]:
                raise ValueError(
                    f"free of pinned block {bid} "
                    f"({int(self._pins[bid])} pins outstanding)")
            self._is_free[bid] = True
            self._free.append(bid)

    def pin(self, bids) -> None:
        """Count a reader/owner reference on assigned blocks; pinning a
        free block raises."""
        for bid in bids:
            bid = int(bid)
            if self._is_free[bid]:
                raise ValueError(f"pin of free block {bid}")
            self._pins[bid] += 1

    def release(self, bids) -> None:
        for bid in bids:
            bid = int(bid)
            if self._pins[bid] <= 0:
                raise ValueError(f"release underflow on block {bid}")
            self._pins[bid] -= 1

    def rebuild_free_list(self, owned: set[int]) -> list[int]:
        """Recompute the free list as ``all - owned`` (repair after the
        allocator and the tables disagree). Pins on blocks nobody owns
        are cleared. Returns the ids whose free/used state changed."""
        changed = []
        for bid in range(self.num_blocks):
            want_free = bid not in owned
            if want_free and not self._is_free[bid]:
                self._pins[bid] = 0
                changed.append(bid)
            elif not want_free and self._is_free[bid]:
                changed.append(bid)
            self._is_free[bid] = want_free
        self._free = [b for b in range(self.num_blocks) if self._is_free[b]]
        return changed

    # -- geometry helpers -------------------------------------------------

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to hold ``n_tokens`` positions."""
        return -(-max(0, int(n_tokens)) // self.block)

    def fragmentation(self, used_tokens: int) -> float:
        """Fraction of reserved-but-dead positions in the allocated
        blocks (tail slack); 0.0 when nothing is allocated."""
        cap = self.blocks_in_use * self.block
        if cap <= 0:
            return 0.0
        return max(0.0, 1.0 - used_tokens / cap)

    # -- device writes ------------------------------------------------------

    def scatter(self, k_new: torch.Tensor, v_new: torch.Tensor,
                sbids: np.ndarray, soffs: np.ndarray) -> None:
        """Write fresh KV ``[L, R, Hkv, S, Dh]`` into the pool IN PLACE:
        column j of row i lands in block ``sbids[i, j]`` at offset
        ``soffs[i, j]`` (host maps ``[R, S]``). Entries holding the
        sentinel id (``num_blocks``: parked rows, padding, columns past
        ``max_len``) are dropped, as the reference's ``mode="drop"``
        drops them. An fp8 pool moves as bytes (``storage_view``)."""
        rows, cols = np.nonzero(sbids < self.num_blocks)
        if rows.size == 0:
            return
        dev = self.k.device

        def idx(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                dev, torch.long)

        r, c = idx(rows), idx(cols)
        bids, offs = idx(sbids[rows, cols]), idx(soffs[rows, cols])
        # advanced indices on axes 1 and 3 put the [N] index axis first:
        # [N, L, Hkv, Dh] on both sides
        for pool, new in ((self.k, k_new), (self.v, v_new)):
            storage_view(pool)[:, bids, :, offs, :] = storage_view(
                new[:, r, :, c, :].to(pool.dtype))

    def scatter_static(self, k_new: torch.Tensor, v_new: torch.Tensor,
                       bids: torch.Tensor, offs: torch.Tensor,
                       back: torch.Tensor) -> None:
        """:meth:`scatter` with a static shape, for the decode dispatch a
        CUDA graph holds: the maps are device tensors ``[R, S]`` (int32)
        and the sentinel is dropped on the device. A dropped entry is
        redirected to ``back`` (a device ``[2]`` tensor: block id, offset)
        and the value held there is written back. The caller picks for
        ``back`` a committed position that no kept entry of this write
        touches — a slot's position just below where the dispatch started
        — so the pool ends as :meth:`scatter` leaves it."""
        keep = bids < self.num_blocks
        b = torch.where(keep, bids, back[0]).long()
        o = torch.where(keep, offs, back[1]).long()
        keep = keep[:, :, None, None, None]
        for pool, new in ((self.k, k_new), (self.v, v_new)):
            # [R, S, L, Hkv, Dh] on both sides, as in scatter
            upd = storage_view(new.permute(1, 3, 0, 2, 4).to(pool.dtype))
            raw = storage_view(pool)
            raw[:, b, :, o, :] = torch.where(keep, upd, raw[:, b, :, o, :])
