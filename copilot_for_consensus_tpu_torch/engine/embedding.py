"""Cross-text-batching embedding engine (port of the JAX package's
``engine/embedding.py``).

Texts are tokenized, grouped into (rows, bucket) tiles with a handful of
shapes, and pushed through the encoder one tile a dispatch: the bucket set
is clipped to the encoder's ``max_positions``, a tile's rows pad to a
power of two capped at ``batch_size``, and padding rows carry one token
(length 1), so no row reaches attention without a key. On the card each
dispatch runs the encoder eagerly (K1 for attention, ``torch.matmul`` for
the projections) and brings the vectors back to the host.

The fault plane, the step telemetry and the scheduler's ``embed_admit``
sizing are the JAX engine's (the port's copies of ``engine/faults.py``,
``telemetry.py`` and ``scheduler.py``). A dispatch is marked by the
profiler's step annotation (``obs/profile.py``: a ``record_function``
range ``embed:<step>``, and an NVTX range on the card). Against the JAX
engine: ``device`` None means the card; a ``mesh`` is refused until the
port's sharding lands (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import pathlib
import time
from typing import Any, Sequence

import numpy as np
import torch

from copilot_for_consensus_tpu_torch.device import resolve_device, \
    resolve_dtype
from copilot_for_consensus_tpu_torch.engine.faults import resolve_faults
from copilot_for_consensus_tpu_torch.engine.scheduler import \
    resolve_scheduler
from copilot_for_consensus_tpu_torch.engine.telemetry import \
    resolve_telemetry
from copilot_for_consensus_tpu_torch.engine.tokenizer import (
    HashWordTokenizer,
    Tokenizer,
)
from copilot_for_consensus_tpu_torch.models import encoder
from copilot_for_consensus_tpu_torch.models.configs import EncoderConfig
from copilot_for_consensus_tpu_torch.obs.profile import step_annotation


class EmbeddingEngine:
    """Batched text → vector encoder."""

    def __init__(
        self,
        cfg: EncoderConfig,
        params: Any | None = None,
        *,
        mesh=None,
        tokenizer: Tokenizer | None = None,
        batch_size: int = 64,
        buckets: tuple[int, ...] = (32, 64, 128, 256, 512),
        seed: int = 0,
        dtype: str | torch.dtype = torch.bfloat16,
        attn_impl: str = "auto",
        telemetry: Any = True,
        scheduler: Any = None,
        faults: Any = None,
        device: str | torch.device | None = None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "EmbeddingEngine(mesh=...): the port has no sharding yet "
                "(ROADMAP Queue 1 item 6, parallel/)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.faults = resolve_faults(faults)
        self.telemetry = resolve_telemetry(telemetry, engine="embedding",
                                           num_slots=batch_size)
        self.scheduler = resolve_scheduler(scheduler,
                                           telemetry=self.telemetry)
        self.batch_size = batch_size
        self.buckets = tuple(sorted(set(
            min(b, cfg.max_positions) for b in buckets)))
        self.tokenizer = tokenizer or HashWordTokenizer(cfg.vocab_size)
        if self.tokenizer.vocab_size > cfg.vocab_size:
            raise ValueError(
                f"tokenizer vocab {self.tokenizer.vocab_size} exceeds "
                f"encoder vocab {cfg.vocab_size}")
        if params is None:
            params = encoder.init_params(cfg, seed=seed,
                                         dtype=resolve_dtype(dtype),
                                         device=self.device)
        self.params = _on_device(params, self.device)
        self.attn_impl = attn_impl

    @classmethod
    def from_checkpoint(cls, path: str, *, mesh=None, tokenizer=None,
                        batch_size: int = 64,
                        buckets: tuple[int, ...] = (32, 64, 128, 256, 512),
                        dtype: str = "float32",
                        attn_impl: str = "auto",
                        device: str | torch.device | None = None
                        ) -> "EmbeddingEngine":
        """Serve real encoder weights: a BERT/MiniLM-family HF checkpoint
        dir (config.json + model.safetensors [+ tokenizer.json]) → a
        ready engine, read by the port's own safetensors reader."""
        from copilot_for_consensus_tpu_torch.checkpoint import (
            load_hf_encoder_checkpoint,
        )

        device = resolve_device(device)
        cfg, params = load_hf_encoder_checkpoint(path, dtype)
        if tokenizer is None:
            tok_file = pathlib.Path(path) / "tokenizer.json"
            if tok_file.exists():
                from copilot_for_consensus_tpu_torch.engine.tokenizer import (
                    HFTokenizer,
                )
                tokenizer = HFTokenizer(str(tok_file), bos_id=0, eos_id=0)
                pad = tokenizer._tok.token_to_id("[PAD]")
                tokenizer.pad_id = 0 if pad is None else int(pad)
            else:
                # WordPiece ids are meaningless to any fallback tokenizer;
                # refuse instead of silently serving garbage vectors.
                raise ValueError(
                    f"checkpoint {path} has no tokenizer.json; pass "
                    "tokenizer= explicitly")
        return cls(cfg, params, mesh=mesh, tokenizer=tokenizer,
                   batch_size=batch_size, buckets=buckets,
                   attn_impl=attn_impl, device=device)

    @property
    def dimension(self) -> int:
        return self.cfg.d_model

    def embed(self, text: str) -> list[float]:
        """Single-text parity with the reference's
        ``EmbeddingProvider.embed(text) -> list[float]``."""
        return self.embed_batch([text])[0].tolist()

    def embed_batch(self, texts: Sequence[str], *, tenant: str = "",
                    correlation_id: str = "") -> np.ndarray:
        """[N] texts → [N, dim] f32, L2-normalised. Order preserved.

        With a scheduler configured, the call is admission-checked
        (oversized bursts shed with ``EngineOverloaded``) and the
        per-dispatch tile rows come from ``Scheduler.embed_admit`` —
        smaller under overload."""
        if not texts:
            return np.zeros((0, self.cfg.d_model), dtype=np.float32)
        rows_cap = self.batch_size
        if self.scheduler is not None:
            rows_cap = self.scheduler.embed_admit(
                len(texts), tenant=tenant, batch_size=self.batch_size,
                correlation_id=correlation_id)
        max_bucket = self.buckets[-1]
        encoded: list[list[int]] = []
        for t in texts:
            ids = self.tokenizer.encode(t)[:max_bucket]
            encoded.append(ids or [self.tokenizer.pad_id])

        out = np.zeros((len(texts), self.cfg.d_model), dtype=np.float32)
        by_bucket: dict[int, list[int]] = {}
        for i, ids in enumerate(encoded):
            b = next(bb for bb in self.buckets if len(ids) <= bb)
            by_bucket.setdefault(b, []).append(i)

        for bucket, idxs in by_bucket.items():
            for start in range(0, len(idxs), rows_cap):
                group = idxs[start:start + rows_cap]
                n = len(group)
                # rows pad to the next power of two, so a scheduler-shrunk
                # tile really is a smaller dispatch
                rows = 1
                while rows < n:
                    rows *= 2
                rows = min(rows, self.batch_size)
                tokens = np.zeros((rows, bucket), dtype=np.int32)
                lengths = np.ones(rows, dtype=np.int32)
                for row, i in enumerate(group):
                    ids = encoded[i]
                    tokens[row, :len(ids)] = ids
                    lengths[row] = len(ids)
                if self.faults is not None:
                    # host dispatch boundary
                    self.faults.check("embed")
                seq = self.telemetry.next_step() \
                    if self.telemetry is not None else None
                t0 = time.monotonic()
                with step_annotation("embed", seq, self.device):
                    vecs = self._encode(tokens, lengths)
                    out[group] = vecs[:n]
                if self.telemetry is not None:
                    self.telemetry.record_step(
                        "embed", time.monotonic() - t0, seq=seq,
                        rows=n, batch=rows,
                        tokens=int(lengths[:n].sum()),
                        padded_tokens=rows * bucket)
        return out

    def _encode(self, tokens: np.ndarray, lengths: np.ndarray
                ) -> np.ndarray:
        with torch.inference_mode():
            vecs = encoder.encode(
                self.params, torch.from_numpy(tokens).to(self.device),
                torch.from_numpy(lengths).to(self.device), self.cfg,
                attn_impl=self.attn_impl)
            return vecs.cpu().numpy()


def _on_device(tree: dict, device: torch.device) -> dict:
    """The param tree with every leaf on ``device``, dtypes kept."""
    return {k: _on_device(v, device) if isinstance(v, dict)
            else v.to(device) for k, v in tree.items()}
