# The port's block pool allocator and shared-pool prefix trie: the JAX
# package's property and handoff tests (tests/test_engine_paged.py) run
# against the port, and the block digests must equal the JAX package's so
# that both tries match the same prompts.
import numpy as np
import pytest
import torch

from copilot_for_consensus_tpu.engine.kv_pool import (
    BlockPool as JaxBlockPool,
)
from copilot_for_consensus_tpu.engine.prefix_cache import (
    PrefixCache as JaxPrefixCache,
)
from copilot_for_consensus_tpu.engine.tokenizer import (
    stable_block_hash as jax_hash,
)
from copilot_for_consensus_tpu.models.configs import (
    decoder_config as jax_config,
)
from copilot_for_consensus_tpu_torch.engine.kv_pool import (
    BlockPool,
    KVPoolExhausted,
)
from copilot_for_consensus_tpu_torch.engine.prefix_cache import PrefixCache
from copilot_for_consensus_tpu_torch.engine.tokenizer import (
    stable_block_hash,
)
from copilot_for_consensus_tpu_torch.models.configs import decoder_config

CFG = decoder_config("tiny")


def _pool(n=16, blk=4):
    return BlockPool(CFG, num_blocks=n, block_size=blk,
                     kv_dtype=torch.float32, device="cpu")


def _shared_prefix(pool):
    return PrefixCache(shared=pool)


# ---------------------------------------------------------------------------
# BlockPool allocator invariants
# ---------------------------------------------------------------------------


def test_pool_tensors_have_the_stacked_layout():
    p = _pool(8, 4)
    shape = (CFG.n_layers, 8, CFG.n_kv_heads, 4, CFG.head_dim)
    assert p.k.shape == p.v.shape == shape
    assert p.k.dtype == torch.float32 and p.k.device.type == "cpu"


def test_alloc_is_exclusive_and_free_returns():
    p = _pool(8)
    a = p.alloc(3)
    b = p.alloc(2)
    assert len(set(a) | set(b)) == 5          # never double-assigned
    assert p.free_blocks == 3
    p.free(a)
    assert p.free_blocks == 6
    c = p.alloc(6)
    assert len(set(c) | set(b)) == 8


def test_double_free_and_oob_free_raise():
    p = _pool(4)
    a = p.alloc(2)
    p.free(a)
    with pytest.raises(ValueError, match="double free"):
        p.free([a[0]])
    with pytest.raises(ValueError, match="out-of-range"):
        p.free([99])


def test_pinned_blocks_cannot_be_freed_and_pins_are_counted():
    p = _pool(4)
    a = p.alloc(1)
    p.pin(a)
    p.pin(a)
    assert p.pinned_blocks == 1
    assert p.pins(a[0]) == 2
    with pytest.raises(ValueError, match="pinned"):
        p.free(a)
    p.release(a)
    with pytest.raises(ValueError, match="pinned"):
        p.free(a)
    p.release(a)
    p.free(a)
    with pytest.raises(ValueError, match="underflow"):
        p.release(a)


def test_pin_of_free_block_raises():
    p = _pool(4)
    with pytest.raises(ValueError, match="pin of free"):
        p.pin([0])


def test_exhaustion_is_all_or_nothing_and_classified():
    p = _pool(4)
    p.alloc(3)
    with pytest.raises(KVPoolExhausted) as ei:
        p.alloc(2)
    assert p.free_blocks == 1                 # nothing partially taken
    assert ei.value.resource_exhausted
    assert (ei.value.needed, ei.value.free) == (2, 1)


def test_random_sequences_never_leak_or_alias():
    """Property: under arbitrary interleavings of alloc/free/pin/release,
    every block is in exactly one place and the books balance."""
    rng = np.random.default_rng(0)
    p = _pool(12)
    held: list[int] = []
    pinned: list[int] = []
    for _ in range(2000):
        op = rng.integers(0, 4)
        if op == 0 and p.free_blocks:
            n = int(rng.integers(1, p.free_blocks + 1))
            got = p.alloc(n)
            assert not (set(got) & set(held))
            held += got
        elif op == 1 and held:
            i = int(rng.integers(0, len(held)))
            bid = held[i]
            if bid not in pinned:
                held.pop(i)
                p.free([bid])
        elif op == 2 and held:
            bid = held[int(rng.integers(0, len(held)))]
            p.pin([bid])
            pinned.append(bid)
        elif op == 3 and pinned:
            i = int(rng.integers(0, len(pinned)))
            p.release([pinned.pop(i)])
        assert p.free_blocks + len(held) == p.num_blocks
        assert p.pinned_blocks == len(set(pinned))


def test_rebuild_free_list_reclaims_unowned_blocks():
    p = _pool(8)
    a = p.alloc(4)
    p.pin(a[:1])
    changed = p.rebuild_free_list(owned=set(a[:2]))
    assert sorted(changed) == sorted(a[2:])
    assert p.free_blocks == 6
    assert p.pins(a[0]) == 1                  # owned keeps its pin


def test_geometry_helpers_match_jax():
    jp = JaxBlockPool(jax_config("tiny"), num_blocks=8, block_size=4)
    p = _pool(8)
    for n in (0, 1, 4, 5, 31):
        assert p.blocks_for(n) == jp.blocks_for(n)
    assert p.alloc(3) == jp.alloc(3)          # same ids, same order
    for used in (0, 5, 12):
        assert p.fragmentation(used) == jp.fragmentation(used)


def test_scatter_writes_in_place_and_drops_the_sentinel():
    p = _pool(4, 2)
    k_before = p.k
    l, hkv, d = CFG.n_layers, CFG.n_kv_heads, CFG.head_dim
    k_new = torch.arange(l * 2 * hkv * 3 * d, dtype=torch.float32).reshape(
        l, 2, hkv, 3, d)
    v_new = -k_new
    sbids = np.array([[1, 1, 4], [3, 4, 4]], np.int32)   # 4 = sentinel
    soffs = np.array([[0, 1, 0], [1, 0, 0]], np.int32)
    p.scatter(k_new, v_new, sbids, soffs)
    assert p.k is k_before                    # same storage
    assert torch.equal(p.k[:, 1, :, 0], k_new[:, 0, :, 0])
    assert torch.equal(p.k[:, 1, :, 1], k_new[:, 0, :, 1])
    assert torch.equal(p.v[:, 3, :, 1], v_new[:, 1, :, 0])
    assert not p.k[:, 0].any() and not p.k[:, 2].any()
    assert not p.k[:, 3, :, 0].any()


# ---------------------------------------------------------------------------
# shared-pool PrefixCache: refcounted adopt handoff
# ---------------------------------------------------------------------------


def test_adopt_blocks_hands_off_without_copy_and_pins():
    pool = _pool(8)
    pc = _shared_prefix(pool)
    tokens = list(range(10, 26))                       # 4 blocks of 4
    table = pool.alloc(4)
    adopted = pc.adopt_blocks(tokens, table, owned_from=0)
    assert adopted == set(table)
    assert pool.pinned_blocks == 4                     # trie pins
    with pytest.raises(ValueError, match="pinned"):
        pool.free(table)
    # dedup: a second slot retiring the same prefix adopts nothing
    table2 = pool.alloc(4)
    assert pc.adopt_blocks(tokens, table2, owned_from=0) == set()
    pool.free(table2)                                  # caller frees
    # a match pins nodes; eviction cannot touch them
    m = pc.lookup(tokens + [1])
    assert m.tokens == 16
    assert m.block_ids == table
    assert pc.evictable_blocks == 0
    assert pc.pinned_refcount == 4
    pc.release(m)
    assert pc.evictable_blocks == 4


def test_shared_eviction_returns_blocks_to_the_pool():
    pool = _pool(8)
    pc = _shared_prefix(pool)
    tokens = list(range(10, 26))
    pc.adopt_blocks(tokens, pool.alloc(4), owned_from=0)
    assert pool.free_blocks == 4
    assert pc.reclaim(2) == 2
    assert pool.free_blocks == 6
    assert pc.node_count == 2
    pc.flush()
    assert pool.free_blocks == 8
    assert pool.pinned_blocks == 0


def test_adopt_blocks_is_transactional_on_corrupt_tables():
    pool = _pool(8)
    pc = _shared_prefix(pool)
    tokens = list(range(10, 26))
    table = pool.alloc(4)
    bad = list(table)
    bad[2] = pool.alloc(1)[0]
    pool.free([bad[2]])                                # free mid-table
    assert pc.adopt_blocks(tokens, bad, owned_from=0) == set()
    assert pool.pinned_blocks == 0                     # nothing pinned
    assert pc.node_count == 0                          # nothing created
    assert pc.stats.publish_skips == 1
    pool.free(table)                                   # caller-safe


def test_eligible_tokens_cap_the_publish_depth():
    pool = _pool(8)
    pc = _shared_prefix(pool)
    tokens = list(range(10, 26))
    assert len(pc.adopt_blocks(tokens, pool.alloc(4), owned_from=0,
                               eligible_tokens=9)) == 2
    assert pc.adopt_blocks(tokens, pool.alloc(4), owned_from=0,
                           eligible_tokens=0) == set()


def test_lookup_leaves_a_suffix_token_and_counts():
    pool = _pool(8)
    pc = _shared_prefix(pool)
    tokens = list(range(10, 18))                        # 2 full blocks
    pc.adopt_blocks(tokens, pool.alloc(2), owned_from=0)
    m = pc.lookup(tokens)                               # whole prompt
    assert m.tokens == 4                                # one block short
    assert pc.match_tokens(tokens + [5]) == 8
    miss = pc.lookup([99] * 8)
    assert miss.tokens == 0
    st = pc.stats.as_dict()
    assert (st["lookups"], st["hits"], st["misses"]) == (2, 1, 1)
    assert st["tokens_matched"] == 4


# ---------------------------------------------------------------------------
# digests: both tries match the same prompts
# ---------------------------------------------------------------------------


def test_stable_block_hash_equals_jax():
    rng = np.random.default_rng(11)
    prev = jprev = b""
    for _ in range(20):
        block = rng.integers(0, 32000, size=int(rng.integers(1, 70)))
        prev = stable_block_hash(prev, block.tolist())
        jprev = jax_hash(jprev, block.tolist())
        assert prev == jprev
    assert stable_block_hash(b"", [-1, 2**40]) == jax_hash(b"", [-1, 2**40])


@pytest.mark.parametrize("block", [4, 64])
def test_prompt_digests_equal_jax(block):
    rng = np.random.default_rng(block)
    port = PrefixCache(shared=_pool(4, block))
    ref = JaxPrefixCache(jax_config("tiny"), num_blocks=1, block_size=block)
    for n in (1, block, block + 1, 5 * block, 5 * block + 3):
        prompt = rng.integers(3, 512, size=n).tolist()
        assert port.prompt_digests(prompt) == ref.prompt_digests(prompt)
