"""Tokenizers for the serving engine (the port's own copy).

Copied from the JAX package's ``engine/tokenizer.py``: the ``Tokenizer``
interface and the zero-dependency ``ByteTokenizer`` (raw UTF-8 bytes
shifted past the special ids), which the summarizer uses when no trained
vocabulary is given.
"""

from __future__ import annotations

import abc

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
N_SPECIALS = 3


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
