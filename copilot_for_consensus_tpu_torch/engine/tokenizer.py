"""Tokenizers for the serving engines.

Three drivers behind one interface:

* ``ByteTokenizer`` — raw UTF-8 bytes + specials; zero-dependency, works
  with any vocab ≥ 259. Default for self-contained runs and tests.
* ``HashWordTokenizer`` — deterministic word-hash ids; the encoder-side
  stand-in when no trained vocabulary is shipped (embeddings only need a
  stable text→id map to be meaningful relative to each other).
* ``HFTokenizer`` — loads a real trained BPE/WordPiece ``tokenizer.json``
  via the ``tokenizers`` library for production checkpoints.

The reference delegates tokenization to its external engines entirely and
budgets with a ~1.3 tokens/word estimator
(``orchestrator/app/context_selectors.py:17``); here the real ids are
first-party.
"""

from __future__ import annotations

import abc
import hashlib

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
N_SPECIALS = 3


def stable_block_hash(prev: bytes, tokens) -> bytes:
    """Chained hash of one token block for the prefix KV cache.

    ``prev`` is the parent block's digest (``b""`` for the first block),
    so a digest commits to the ENTIRE token prefix, not just its own
    block — two prompts share a radix-trie node iff every token from
    position zero matches. Uses blake2b over the explicit little-endian
    token bytes, NOT Python's ``hash()``: the digest keys cross-request
    (and potentially cross-process / on-disk) reuse, so it must not
    change between interpreter runs (PYTHONHASHSEED) or platforms."""
    h = hashlib.blake2b(prev, digest_size=16)
    h.update(b"".join(int(t).to_bytes(8, "little", signed=True)
                      for t in tokens))
    return h.digest()


class NgramDraftIndex:
    """Prompt-lookup draft index for speculative decoding (one stream).

    The n-gram analogue of the radix hashing above, but WITHIN one
    stream instead of across requests: the last ``min_ngram``–``ngram``
    tokens of the stream's context key a map to the position where the
    same n-gram last occurred WITH a continuation, and the tokens that
    followed it become the draft (Saxena, *Prompt Lookup Decoding*,
    2023). Summaries and RAG answers copy long prompt spans verbatim
    (quotes, names, draft identifiers, header fields), so drafts come
    from the stream's own context with zero extra model and zero extra
    HBM — the drafting side of ``GenerationEngine``'s ``_verify``
    dispatch.

    Unlike the prefix cache this index never leaves the host or the
    request: plain tuple keys are correct (no cross-process stability
    requirement), longest-n wins (a 3-gram match is a stronger copy
    signal than a 2-gram one), and the EARLIEST occurrence wins within
    an n — the PLD scan order, and the one that maximizes the
    available continuation: a tail-adjacent match can only draft as
    far as the repetition period, while a prompt-side match drafts the
    whole remembered span. An n-gram is only indexed once at least one
    token follows it, so the context's own tail can never match itself
    into an empty draft.

    Cost: O(ngram - min_ngram + 1) dict inserts per appended token —
    the only per-token host cost speculation adds to the decode path,
    mirroring how ``prompt_digests`` is the only one on admission.
    """

    def __init__(self, tokens=(), *, ngram: int = 3, min_ngram: int = 2):
        if min_ngram < 1 or ngram < min_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= ngram, got {min_ngram}..{ngram}")
        self.ngram = int(ngram)
        self.min_ngram = int(min_ngram)
        self._tokens: list[int] = []
        self._maps: dict[int, dict[tuple, int]] = {
            n: {} for n in range(self.min_ngram, self.ngram + 1)}
        self._next_end = 0   # first n-gram end position not yet indexed
        if tokens:
            self.extend(tokens)

    def __len__(self) -> int:
        return len(self._tokens)

    def extend(self, tokens) -> None:
        """Append accepted tokens and index every n-gram that now has a
        continuation (the n-gram ending at the new tail stays
        unindexed until the NEXT extend gives it a continuation)."""
        self._tokens.extend(int(t) for t in tokens)
        t = self._tokens
        for end in range(self._next_end, len(t)):
            # ``end`` is the exclusive end of the n-gram and t[end] its
            # continuation — the n-gram ending AT len(t) has none yet
            # and waits for the next extend
            for n, m in self._maps.items():
                if end >= n:
                    m.setdefault(tuple(t[end - n:end]), end)
        self._next_end = len(t)

    def draft(self, max_tokens: int) -> list[int]:
        """Up to ``max_tokens`` drafted continuations of the current
        tail, or ``[]`` when no indexed n-gram matches. Longest n
        first; the returned span is a verbatim copy of the context
        after the matched occurrence."""
        if max_tokens <= 0:
            return []
        t = self._tokens
        for n in range(self.ngram, self.min_ngram - 1, -1):
            if len(t) <= n:
                continue
            end = self._maps[n].get(tuple(t[-n:]))
            if end is not None:
                return t[end:end + max_tokens]
        return []


class Tokenizer(abc.ABC):
    pad_id = PAD_ID
    bos_id = BOS_ID
    eos_id = EOS_ID

    @property
    @abc.abstractmethod
    def vocab_size(self) -> int: ...

    @abc.abstractmethod
    def encode(self, text: str, add_bos: bool = False,
               add_eos: bool = False) -> list[int]: ...

    @abc.abstractmethod
    def decode(self, ids: list[int]) -> str: ...


class ByteTokenizer(Tokenizer):
    """UTF-8 bytes shifted past the special ids."""

    def __init__(self, vocab_size: int = 259):
        if vocab_size < 256 + N_SPECIALS:
            raise ValueError("ByteTokenizer needs vocab_size >= 259")
        self._vocab = vocab_size

    @property
    def vocab_size(self) -> int:
        return self._vocab

    def encode(self, text: str, add_bos: bool = False,
               add_eos: bool = False) -> list[int]:
        ids = [b + N_SPECIALS for b in text.encode("utf-8")]
        if add_bos:
            ids.insert(0, BOS_ID)
        if add_eos:
            ids.append(EOS_ID)
        return ids

    def decode(self, ids: list[int]) -> str:
        data = bytes(i - N_SPECIALS for i in ids
                     if N_SPECIALS <= i < 256 + N_SPECIALS)
        return data.decode("utf-8", errors="replace")


class HashWordTokenizer(Tokenizer):
    """Stable word→id hashing (sha1 mod vocab). Not invertible — decode
    returns placeholders — so only suitable for the encoder path."""

    def __init__(self, vocab_size: int = 30522):
        if vocab_size <= N_SPECIALS + 1:
            raise ValueError("vocab too small")
        self._vocab = vocab_size

    @property
    def vocab_size(self) -> int:
        return self._vocab

    def encode(self, text: str, add_bos: bool = False,
               add_eos: bool = False) -> list[int]:
        span = self._vocab - N_SPECIALS
        ids = [
            N_SPECIALS + int.from_bytes(
                hashlib.sha1(w.lower().encode()).digest()[:4], "big") % span
            for w in text.split()
        ]
        if add_bos:
            ids.insert(0, BOS_ID)
        if add_eos:
            ids.append(EOS_ID)
        return ids

    def decode(self, ids: list[int]) -> str:
        return " ".join(f"<{i}>" for i in ids)


class HFTokenizer(Tokenizer):
    """A trained ``tokenizer.json`` via the HuggingFace tokenizers lib.

    ``bos_id``/``eos_id`` default to the Llama/Mistral-family convention
    (1/2) but can be overridden from checkpoint metadata. ``eos_id`` may
    be a list (Llama-3.1-style multi-EOS configs); the first id is used
    when appending, all are stripped on decode. ``pad_id`` is only
    filtered when explicitly given — id 0 is a real vocab token in some
    families."""

    def __init__(self, path: str, *, bos_id: int = BOS_ID,
                 eos_id=EOS_ID, pad_id: int | None = None):
        from tokenizers import Tokenizer as _HFTok  # lazy: optional dep
        self._tok = _HFTok.from_file(path)
        self.bos_id = int(bos_id)
        eos_list = list(eos_id) if isinstance(eos_id, (list, tuple)) \
            else [int(eos_id)]
        self.eos_id = int(eos_list[0])
        self.eos_ids = tuple(int(e) for e in eos_list)
        self.pad_id = pad_id if pad_id is not None else -1

    @property
    def vocab_size(self) -> int:
        return self._tok.get_vocab_size()

    def encode(self, text: str, add_bos: bool = False,
               add_eos: bool = False) -> list[int]:
        ids = list(self._tok.encode(text).ids)
        # Real Mistral/Llama tokenizer.json files carry a post-processor
        # that already emits BOS; don't double it.
        if add_bos and (not ids or ids[0] != self.bos_id):
            ids.insert(0, self.bos_id)
        if add_eos and (not ids or ids[-1] not in self.eos_ids):
            ids.append(self.eos_id)
        return ids

    def decode(self, ids: list[int]) -> str:
        specials = {self.pad_id, self.bos_id, *self.eos_ids}
        return self._tok.decode([i for i in ids if i not in specials])


def create_tokenizer(driver: str = "byte", *, vocab_size: int = 259,
                     path: str | None = None, bos_id: int = BOS_ID,
                     eos_id: int = EOS_ID) -> Tokenizer:
    if driver == "byte":
        return ByteTokenizer(vocab_size)
    if driver == "hash_word":
        return HashWordTokenizer(vocab_size)
    if driver == "hf":
        if not path:
            raise ValueError("hf tokenizer needs a path")
        return HFTokenizer(path, bos_id=bos_id, eos_id=eos_id)
    raise ValueError(f"unknown tokenizer driver {driver!r}")
