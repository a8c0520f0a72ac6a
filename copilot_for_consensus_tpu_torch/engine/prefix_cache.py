"""Cross-request prefix KV reuse: a radix trie over a block pool.

Port of the JAX package's ``engine/prefix_cache.py``. Every summarization
prompt opens with the same template head, and a re-summarized thread
re-sends almost its whole prompt; the trie turns both into prefix hits.

* **Radix trie.** Prompts are cut into fixed token blocks (block size =
  the engine's ``prefill_chunk``). Each node is one block, keyed by a
  chained digest (``tokenizer.stable_block_hash``), so a node commits to
  its whole token prefix and longest-prefix match is a hash walk.
* **Owned pool** (the contiguous engine): the cache holds its own block
  pool ``pool["k"/"v"]`` ``[L, num_blocks, Hkv, block, Dh]`` in the
  serving KV dtype and its free list. :meth:`publish` COPIES a retiring
  slot's prompt KV cache→pool in one indexed write; a hit's blocks are
  gathered back into the slot cache by the engine's seeded wave. A full
  pool evicts its least-recently-used unpinned leaf.
* **Shared pool** (the paged engine): nodes reference blocks of the
  engine's :class:`~.kv_pool.BlockPool` by id. Publish is
  :meth:`adopt_blocks`, a refcount handoff of the retiring slot's own
  blocks (no device copy), and eviction returns blocks to the shared
  allocator. The trie pins each adopted block once in the pool for
  itself.
* **Refcount pinning.** ``lookup`` pins every matched node until the
  request retires (``release``); ``publish`` temp-pins its path while it
  allocates, and eviction takes the least-recently-used unpinned leaf
  only.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from copilot_for_consensus_tpu_torch.device import (
    resolve_device,
    storage_view,
    zeros,
)
from copilot_for_consensus_tpu_torch.engine.kv_pool import BlockPool
from copilot_for_consensus_tpu_torch.engine.tokenizer import (
    stable_block_hash,
)


class _Node:
    """One cached block: a radix-trie edge + its pool block id."""

    __slots__ = ("digest", "parent", "children", "block_id", "refcount",
                 "last_used")

    def __init__(self, digest: bytes, parent: "_Node | None",
                 block_id: int):
        self.digest = digest
        self.parent = parent
        self.children: dict[bytes, _Node] = {}
        self.block_id = block_id
        self.refcount = 0
        self.last_used = 0


@dataclass
class PrefixMatch:
    """A pinned longest-prefix match. Hold it while the request is
    active; hand it back through ``PrefixCache.release`` on retire."""

    nodes: list[_Node]
    block_ids: list[int]
    tokens: int                     # == len(block_ids) * block_size


@dataclass
class PrefixCacheStats:
    lookups: int = 0
    hits: int = 0                   # lookups matching >= 1 block
    misses: int = 0
    tokens_matched: int = 0         # prompt tokens NOT re-prefilled
    blocks_published: int = 0
    blocks_evicted: int = 0
    publish_skips: int = 0          # pool full of pinned/interior blocks,
    #                                 or an adoption refused (corrupt table)

    def as_dict(self) -> dict:
        return {f: getattr(self, f) for f in self.__dataclass_fields__}


class PrefixCache:
    """Radix trie + LRU/refcount policy over a block pool: its own
    (``num_blocks`` of ``block_size`` positions in ``kv_dtype`` on
    ``device``, None → the card), or a shared :class:`BlockPool`, whose
    block size it takes and whose blocks are its budget."""

    def __init__(self, cfg=None, *, num_blocks: int = 0,
                 block_size: int = 0,
                 kv_dtype: torch.dtype = torch.bfloat16,
                 shared: BlockPool | None = None,
                 device: str | torch.device | None = None):
        self.shared = shared
        if shared is not None:
            if block_size and shared.block != block_size:
                raise ValueError(
                    f"shared pool block size {shared.block} != prefix "
                    f"cache block size {block_size}")
            self.block = shared.block
            self.num_blocks = shared.num_blocks
            self.pool = None            # the engine owns the arrays
            self._free = None
        else:
            if num_blocks < 1:
                raise ValueError("prefix cache needs num_blocks >= 1")
            if block_size < 1:
                raise ValueError("prefix cache needs block_size >= 1")
            self.block = int(block_size)
            self.num_blocks = int(num_blocks)
            shape = (cfg.n_layers, self.num_blocks, cfg.n_kv_heads,
                     self.block, cfg.head_dim)
            dev = resolve_device(device)
            #: the owned KV blocks; block ids index axis 1
            self.pool = {"k": zeros(shape, kv_dtype, dev),
                         "v": zeros(shape, kv_dtype, dev)}
            self._free: list[int] | None = list(range(self.num_blocks))
        self._root = _Node(b"", None, -1)
        self._nodes: list[_Node] = []       # every live non-root node
        self._tick = 0
        self.stats = PrefixCacheStats()

    # -- introspection --------------------------------------------------

    @property
    def blocks_in_use(self) -> int:
        if self.shared is not None:
            return len(self._nodes)
        return self.num_blocks - len(self._free)

    @property
    def node_count(self) -> int:
        return len(self._nodes)

    @property
    def evictable_blocks(self) -> int:
        """Every unpinned node: interior nodes become evictable once
        their descendants go, so the whole refcount-0 population is
        reclaimable by cascaded LRU eviction. The paged engine's
        free-block admission accounting counts these as headroom."""
        return sum(1 for n in self._nodes if n.refcount == 0)

    @property
    def pinned_refcount(self) -> int:
        """Total outstanding match pins across all nodes."""
        return sum(n.refcount for n in self._nodes)

    def flush(self) -> int:
        """Drop every cached block and return how many were freed: an
        owned pool's free list is whole again; a shared pool gets each
        block back (the trie's own pin is the last one once the engine's
        slots are gone). A still-held ``PrefixMatch`` is orphaned; its
        ``release`` stays safe."""
        n = len(self._nodes)
        if self.shared is not None:
            for node in self._nodes:
                self.shared.release([node.block_id])
                self.shared.free([node.block_id])
        else:
            self._free = list(range(self.num_blocks))
        self._nodes.clear()
        self._root.children.clear()
        self.stats.blocks_evicted += n
        return n

    # -- hashing / matching ---------------------------------------------

    def _block_digests(self, tokens, n_blocks: int):
        """Yield the chained digest of each of the first n_blocks."""
        prev = b""
        for j in range(n_blocks):
            prev = stable_block_hash(
                prev, tokens[j * self.block:(j + 1) * self.block])
            yield prev

    def prompt_digests(self, tokens) -> list[bytes]:
        """Every matchable block digest for a prompt (the last token is
        never matchable — see lookup). Callers compute this once per
        request and pass it to match_tokens/lookup."""
        cap = (len(tokens) - 1) // self.block
        return list(self._block_digests(tokens, cap))

    def _walk(self, digests) -> list[_Node]:
        node = self._root
        nodes: list[_Node] = []
        for digest in digests:
            child = node.children.get(digest)
            if child is None:
                break
            nodes.append(child)
            node = child
        return nodes

    def match_tokens(self, tokens, digests=None) -> int:
        """Peek: longest cached prefix length in tokens. No pinning, no
        LRU touch, no stats."""
        if digests is None:
            digests = self.prompt_digests(tokens)
        return len(self._walk(digests)) * self.block

    def lookup(self, tokens, digests=None) -> PrefixMatch:
        """Longest-prefix match, PINNED. Always leaves >= 1 prompt token
        for the suffix prefill (the admission wave samples the first
        generated token from the last prompt position). The caller MUST
        ``release`` a non-empty match when the request retires."""
        self._tick += 1
        self.stats.lookups += 1
        if digests is None:
            digests = self.prompt_digests(tokens)
        nodes = self._walk(digests)
        for n in nodes:
            n.last_used = self._tick
            n.refcount += 1
        if nodes:
            self.stats.hits += 1
            self.stats.tokens_matched += len(nodes) * self.block
        else:
            self.stats.misses += 1
        return PrefixMatch(nodes=nodes,
                           block_ids=[n.block_id for n in nodes],
                           tokens=len(nodes) * self.block)

    def release(self, match: PrefixMatch) -> None:
        for n in match.nodes:
            n.refcount -= 1
            assert n.refcount >= 0, "prefix-cache refcount underflow"
        match.nodes = []
        match.block_ids = []

    # -- eviction / allocation ----------------------------------------------

    def _evict_one(self) -> bool:
        """Free the least-recently-used unpinned LEAF back to its pool.
        Returns False if every node is pinned or interior."""
        victim: _Node | None = None
        for n in self._nodes:
            if n.children or n.refcount > 0:
                continue
            if victim is None or n.last_used < victim.last_used:
                victim = n
        if victim is None:
            return False
        victim.parent.children.pop(victim.digest, None)
        self._nodes.remove(victim)
        if self.shared is not None:
            self.shared.release([victim.block_id])
            self.shared.free([victim.block_id])
        else:
            self._free.append(victim.block_id)
        self.stats.blocks_evicted += 1
        return True

    def _alloc(self) -> int | None:
        """One owned-pool block, evicting an LRU leaf when the free list
        is empty; None when every block is pinned or interior."""
        if self.shared is not None:
            # shared-pool mode takes blocks only through adopt_blocks
            raise RuntimeError(
                "PrefixCache._alloc in shared-pool mode (use "
                "adopt_blocks)")
        if not self._free and not self._evict_one():
            return None
        return self._free.pop()

    def reclaim(self, n: int) -> int:
        """Evict up to ``n`` unpinned leaves back to the shared pool —
        cached-but-idle prefixes yield to live decode timelines. Returns
        how many blocks were reclaimed."""
        got = 0
        while got < n and self._evict_one():
            got += 1
        return got

    # -- publish ------------------------------------------------------------

    def publish(self, tokens, cache: dict, slot: int,
                eligible_tokens: int | None = None) -> int:
        """Owned-pool publish: insert the block-aligned prefix of
        ``tokens`` into the trie, copying KV for NEW blocks out of
        ``cache[:, slot]`` (which holds the prompt's KV at positions
        [0, len(tokens))). Returns the number of blocks newly published.

        Cache columns below a slot's committed length are exactly its
        prompt and accepted-token KV, so a publish after a speculative
        run copies only committed KV. ``eligible_tokens`` caps the depth
        (the summarizer passes its shared-template span); blocks already
        in the trie are only LRU-touched (dedup)."""
        if self.shared is not None:
            raise RuntimeError(
                "copy-publish on a shared-pool PrefixCache (the paged "
                "engine publishes by adopt_blocks refcount handoff)")
        self._tick += 1
        limit = len(tokens)
        if eligible_tokens is not None:
            limit = min(limit, max(0, int(eligible_tokens)))
        n_blocks = limit // self.block
        if n_blocks == 0:
            return 0
        node = self._root
        path: list[_Node] = []      # temp-pinned while we allocate
        new_rows: list[tuple[int, int]] = []   # (block_id, start_pos)
        try:
            for j, digest in enumerate(
                    self._block_digests(tokens, n_blocks)):
                child = node.children.get(digest)
                if child is None:
                    bid = self._alloc()
                    if bid is None:
                        self.stats.publish_skips += 1
                        break
                    child = _Node(digest, node, bid)
                    node.children[digest] = child
                    self._nodes.append(child)
                    new_rows.append((bid, j * self.block))
                child.last_used = self._tick
                # temp-pin: a later _alloc in this walk may evict, and a
                # just-created node is an unpinned leaf
                child.refcount += 1
                path.append(child)
                node = child
        finally:
            for n in path:
                n.refcount -= 1
        if new_rows:
            self._copy_blocks(cache, slot, new_rows)
            self.stats.blocks_published += len(new_rows)
        return len(new_rows)

    def _copy_blocks(self, cache: dict, slot: int,
                     rows: list[tuple[int, int]]) -> None:
        """One indexed cache→pool copy for every new block of a publish:
        block ``bid`` takes the slot's positions [start, start + block).
        The ids are the real ones only (no out-of-range padding to
        drop); an fp8 pool moves as bytes."""
        dev = self.pool["k"].device
        bids = torch.tensor([b for b, _ in rows], dtype=torch.long,
                            device=dev)
        pidx = (torch.tensor([s for _, s in rows], dtype=torch.long,
                             device=dev)[:, None]
                + torch.arange(self.block, device=dev)[None, :])
        for name in ("k", "v"):
            # [L, Hkv, M, block, Dh] → the pool's [L, M, Hkv, block, Dh]
            blk = storage_view(cache[name])[:, slot][:, :, pidx]
            storage_view(self.pool[name])[:, bids] = blk.transpose(1, 2)

    def adopt_blocks(self, tokens, table, owned_from: int,
                     eligible_tokens: int | None = None) -> set[int]:
        """Publish by refcount handoff. ``table`` is the retiring slot's
        block table; its first ``owned_from`` entries are BORROWED (from
        a prefix match, already in the trie), the rest slot-owned. For
        each block-aligned prompt block an existing node is LRU-touched
        (dedup) and a new node ADOPTS the slot's own block by id — the
        pool pin moves to the trie, zero bytes copied. Returns the
        adopted ids; the caller frees the slot's other owned blocks.

        Transactional: digests and validation touch no state, and the
        apply phase cannot raise, so a corrupt table adopts nothing."""
        if self.shared is None:
            raise RuntimeError(
                "adopt_blocks on an owned-pool PrefixCache (use "
                "publish)")
        self._tick += 1
        limit = len(tokens)
        if eligible_tokens is not None:
            limit = min(limit, max(0, int(eligible_tokens)))
        n_blocks = min(limit // self.block, len(table))
        adopted: set[int] = set()
        if n_blocks == 0:
            return adopted
        digests = list(self._block_digests(tokens, n_blocks))
        # walk the existing path (dedup: LRU touches only); the path is
        # linear, so the first missing child means every deeper one is
        node = self._root
        j = 0
        while j < n_blocks:
            child = node.children.get(digests[j])
            if child is None:
                break
            child.last_used = self._tick
            node = child
            j += 1
        if j >= n_blocks:
            return adopted
        if j < owned_from:
            # a borrowed block whose node is gone: the trie was flushed
            # under an active match — nothing to hand off
            self.stats.publish_skips += 1
            return adopted
        bids = [int(table[i]) for i in range(j, n_blocks)]
        if any(not 0 <= b < self.shared.num_blocks
               or self.shared.is_free(b) for b in bids):
            self.stats.publish_skips += 1
            return adopted
        for i, bid in zip(range(j, n_blocks), bids):
            child = _Node(digests[i], node, bid)
            node.children[digests[i]] = child
            self._nodes.append(child)
            self.shared.pin([bid])            # the trie's own reference
            adopted.add(bid)
            self.stats.blocks_published += 1
            child.last_used = self._tick
            node = child
        return adopted
