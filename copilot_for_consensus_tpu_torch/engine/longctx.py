"""Long-context serving on one device — the port of the JAX package's
``engine/longctx.py`` (``LongContextEngine``).

The continuous-batching engine (``engine/generation.py``) serves many
short requests and cuts a prompt over its ``prompt_limit`` to the tail.
This engine serves one request at a time against its WHOLE prompt,
however long: the summarizer sends it every thread whose prompt is over
the short engine's limit (``summarization/summarizer.py``,
``long_context=True``).

The reference shards the sequence over an ``sp`` mesh axis: ring (or
Ulysses) attention in prefill, and a decode whose prefix cache stays
sharded. On one device ``sp`` is 1, the ring never rotates, and each
phase is the function it computes over the whole sequence:

* **Prefill** is ``decoder.prefill`` into a fresh ``[L, 1, Hkv, S, Dh]``
  cache: causal, windowed (Mistral's sliding window), length-masked
  attention over the right-padded prompt — K1 on the card — with only
  the last valid row unembedded. Prompt lengths pad to multiples of
  ``ctx_block``, so a handful of shapes cover every prompt.
* **Decode** treats that cache as a frozen prefix. Each step's token
  attends the prefix and a small suffix buffer of the generated tokens'
  KV (``[L, 1, Hkv, round_up(max_new_tokens + 1, 64), Dh]``) in one f32
  softmax over both pieces (``ops.attention._piece_mask`` and
  ``_joint_probs``), with the reference's window rule ``pos > gpos -
  window``. Prefix columns the window excludes are not read. On the card
  the scores take bf16 operands with f32 accumulation, which is what the
  reference's up-cast computes (a product of two bf16 values is exact in
  f32); the probabilities stay f32 against up-cast values, as there.
  ``decode_window`` steps run a dispatch, sampling on the device, with
  one host fetch of their tokens.

Both ``sp_impl`` values ("ring", "ulysses") are accepted and are the
same attention on one device. A ``mesh`` of more than one device raises:
the port's ``parallel/`` is ROADMAP Queue 1 item 6c.

The engine keeps the tensors it is given (one weight residency when it
shares the short engine's), runs its device work on a CUDA stream of its
own, and serves one ``generate`` at a time (a lock). The kernels' split
counters are per stream (``ops/quant_matmul.py``), so a long generate on
a caller's thread may overlap the async runner's decode graphs.
"""

from __future__ import annotations

import contextlib
import math
import threading
import time
from typing import Any

import torch

from copilot_for_consensus_tpu_torch.device import (
    resolve_device,
    resolve_dtype,
    zeros,
)
from copilot_for_consensus_tpu_torch.engine.generation import Completion
from copilot_for_consensus_tpu_torch.engine.sampling import (
    SamplingConfig,
    sample,
)
from copilot_for_consensus_tpu_torch.engine.telemetry import (
    resolve_telemetry,
)
from copilot_for_consensus_tpu_torch.models import decoder
from copilot_for_consensus_tpu_torch.models import layers as L
from copilot_for_consensus_tpu_torch.models.configs import DecoderConfig
from copilot_for_consensus_tpu_torch.models.quant import quant_kind
from copilot_for_consensus_tpu_torch.obs.profile import (
    maybe_profile,
    step_annotation,
)
from copilot_for_consensus_tpu_torch.ops.attention import (
    _joint_probs,
    _matmul_f32,
    _piece_mask,
)

SP_IMPLS = ("ring", "ulysses")


def _round_up(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def _mesh_devices(mesh) -> int:
    """Devices a mesh spans: the product of its axis sizes (``mesh.shape``,
    a mapping, as a JAX mesh gives it); no mesh is one device."""
    return 1 if mesh is None else math.prod(dict(mesh.shape).values())


def step_masks(prefix_len: int, suf_len: int, window: int, device
                ) -> tuple[int, torch.Tensor, torch.Tensor]:
    """What one decode step's attention reads, the same in every layer:
    the first prefix column the window leaves (earlier ones are masked,
    so they are not read), and the "not attended" masks of the prefix
    columns [lo, prefix_len) and the suffix columns [0, suf_len]; the
    token sits at global position ``gpos = prefix_len + suf_len``."""
    gpos = prefix_len + suf_len
    lo = min(max(0, gpos - window + 1), prefix_len) if window > 0 else 0
    pos_p = torch.arange(lo, prefix_len, device=device)
    pos_s = torch.arange(prefix_len, gpos + 1, device=device)
    return (lo, ~_piece_mask(pos_p, prefix_len, gpos, window),
            ~_piece_mask(pos_s, gpos + 1, gpos, window))


def attend_prefix_suffix(q: torch.Tensor, k_pre: torch.Tensor,
                         v_pre: torch.Tensor, k_suf: torch.Tensor,
                         v_suf: torch.Tensor, prefix_len: int, suf_len: int,
                         masks: tuple) -> torch.Tensor:
    """One decode token's attention over the frozen prefix and the suffix
    buffer, one f32 softmax over both pieces.

    q: [1, Hq, D] — the token at global position ``gpos = prefix_len +
    suf_len``; k_pre/v_pre: [1, Hkv, S, D] (valid below ``prefix_len``);
    k_suf/v_suf: [1, Hkv, W, D] (columns [0, suf_len] valid: this token's
    own KV is already at ``suf_len``); ``masks``: the step's
    :func:`step_masks`. Returns f32 [1, Hq, D]."""
    b, hq, d = q.shape
    hkv = k_pre.shape[1]
    lo, off_p, off_s = masks
    kp, vp = k_pre[:, :, lo:prefix_len], v_pre[:, :, lo:prefix_len]
    ks, vs = k_suf[:, :, :suf_len + 1], v_suf[:, :, :suf_len + 1]
    dt = q.dtype
    qg = q.reshape(b, hkv, hq // hkv, d)
    scale = d ** -0.5
    lp = _matmul_f32(qg, kp.to(dt).transpose(-1, -2)) * scale
    ls = _matmul_f32(qg, ks.to(dt).transpose(-1, -2)) * scale
    pp, ps = _joint_probs([lp.masked_fill(off_p, float("-inf")),
                           ls.masked_fill(off_s, float("-inf"))])
    out = torch.matmul(pp, vp.float()) + torch.matmul(ps, vs.float())
    return out.reshape(b, hq, d)


class LongContextEngine:
    """One long-context generation at a time on one device. Use
    ``GenerationEngine`` for short-prompt throughput."""

    def __init__(
        self,
        cfg: DecoderConfig,
        params: dict | None = None,
        *,
        mesh: Any = None,
        sp_impl: str = "ring",
        sampling: SamplingConfig = SamplingConfig(),
        eos_id: int | list[int] = 2,
        seed: int = 0,
        dtype: str | torch.dtype = torch.bfloat16,
        max_new_tokens: int = 512,
        decode_window: int = 8,
        ctx_block: int = 64,
        profile_dir: str | None = None,
        telemetry: Any = True,
        device: str | torch.device | None = None,
    ):
        if _mesh_devices(mesh) > 1:
            raise NotImplementedError(
                f"LongContextEngine(mesh=...) over {_mesh_devices(mesh)} "
                f"devices: the port's sequence parallelism (parallel/) is "
                f"ROADMAP Queue 1 item 6c; one device serves the whole "
                f"sequence")
        if sp_impl not in SP_IMPLS:
            raise ValueError(f"unknown sp_impl {sp_impl!r} (ring|ulysses)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype)
        self.profile_dir = profile_dir
        # Flight recorder and spans: one span a generate() call, one
        # StepRecord a prefill or decode dispatch; batch width 1.
        self.telemetry = resolve_telemetry(telemetry, engine="longctx",
                                           num_slots=1)
        self._tele_rid = 0
        self.sp_impl = sp_impl
        self.sampling = sampling
        eos_list = list(eos_id) if isinstance(eos_id, (list, tuple)) \
            else [int(eos_id)]
        self._eos_set = frozenset(int(e) for e in eos_list)
        self.decode_window = max(1, decode_window)
        # one shard: prompts pad to multiples of ctx_block
        self.ctx_quantum = ctx_block
        self.suffix_len = _round_up(max_new_tokens + 1, 64)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        if params is None:
            params = decoder.init_params(cfg, seed=seed, dtype=self.dtype,
                                         device=self.device)
        if params["tok_emb"].device.type != self.device.type:
            raise ValueError(
                f"params lie on {params['tok_emb'].device}, the engine on "
                f"{self.device}: the engine keeps the tensors it is given")
        layers_t = params["layers"]
        #: "int8" / "int4" (fused wqkv or not) / None
        self.quant_mode = quant_kind(layers_t.get("wq", layers_t.get("wqkv")))
        self.params = params
        #: each layer's leaves, views into the stacked tensors, made once
        self._layers = [decoder.layer_params(params, li)
                        for li in range(cfg.n_layers)]
        self._stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    # device work
    # ------------------------------------------------------------------

    @contextlib.contextmanager
    def _on_stream(self):
        """Run the enclosed device work on the engine's stream, after what
        the caller's stream holds and before what it enqueues next."""
        if self._stream is None:
            yield
            return
        caller = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(caller)
        try:
            with torch.cuda.stream(self._stream):
                yield
        finally:
            caller.wait_stream(self._stream)

    def _prefill(self, prompt: list[int], s_ctx: int):
        """(last-valid-position logits [1, V] f32, prefix cache)."""
        dev = self.device
        tokens = torch.zeros((1, s_ctx), dtype=torch.long)
        tokens[0, :len(prompt)] = torch.as_tensor(prompt)
        length = torch.tensor([len(prompt)], device=dev)
        cache = decoder.init_cache(self.cfg, 1, s_ctx, dtype=self.dtype,
                                   device=dev)
        return decoder.prefill(self.params, tokens.to(dev), length,
                               self.cfg, cache)

    def _one_token(self, tok: torch.Tensor, pos: torch.Tensor,
                   prefix: dict, prefix_len: int, suffix: dict,
                   suf_len: int) -> torch.Tensor:
        """One decode step: tok [1] at global position ``prefix_len +
        suf_len`` (``pos`` [1, 1], the same on the device, for RoPE).
        Writes this token's KV into column ``suf_len`` of the suffix
        buffer and returns its logits [1, V] f32."""
        cfg, params = self.cfg, self.params
        x = params["tok_emb"][tok.long()][:, None, :]          # [1, 1, D]
        masks = step_masks(prefix_len, suf_len, cfg.sliding_window,
                           x.device)
        for li, layer in enumerate(self._layers):
            xn = L.rms_norm(x, layer["attn_norm"], cfg.norm_eps)
            q, k, v = L._project_qkv(xn, layer, cfg, pos)
            suffix["k"][li, :, :, suf_len] = k[:, :, 0]
            suffix["v"][li, :, :, suf_len] = v[:, :, 0]
            o = attend_prefix_suffix(
                q[:, :, 0], prefix["k"][li], prefix["v"][li],
                suffix["k"][li], suffix["v"][li], prefix_len, suf_len,
                masks)
            o = o.reshape(1, 1, cfg.n_heads * cfg.head_dim).to(x.dtype)
            x = x + L.qmatmul(o, layer["wo"])
            x = x + decoder._ffn(
                L.rms_norm(x, layer["ffn_norm"], cfg.norm_eps), layer, cfg)
        return decoder._unembed(x, params, cfg)[:, 0]

    def _decode_dispatch(self, tok: int, prefix: dict, prefix_len: int,
                         suffix: dict, suf_len: int) -> list[int]:
        """``decode_window`` decode → sample → feed-back steps; one host
        fetch of their tokens."""
        dev = self.device
        cur = torch.tensor([tok], device=dev)
        pos = torch.full((1, 1), prefix_len + suf_len, device=dev)
        out = []
        for w in range(self.decode_window):
            if suf_len + w >= self.suffix_len:
                break                   # the buffer is full: max_new cap
            logits = self._one_token(cur, pos, prefix, prefix_len, suffix,
                                     suf_len + w)
            cur = sample(logits, self._gen, self.sampling)
            out.append(cur)
            pos = pos + 1
        return torch.cat(out).tolist()             # the ONE host sync

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def generate(self, prompt: list[int], max_new_tokens: int = 256, *,
                 correlation_id: str = "") -> Completion:
        """Generate against the FULL prompt, however long — no truncation.
        Returns the batch engine's ``Completion``. Captures a
        torch.profiler trace when built with ``profile_dir``.
        ``correlation_id`` tags the telemetry span (and any flight-recorder
        dump) with the pipeline event that asked."""
        with self._lock, maybe_profile(self.profile_dir):
            try:
                with torch.inference_mode():
                    return self._generate(prompt, max_new_tokens,
                                          correlation_id)
            except Exception as exc:
                if self.telemetry is not None:
                    self.telemetry.record_error(exc)
                raise

    def _generate(self, prompt: list[int], max_new_tokens: int,
                  correlation_id: str = "") -> Completion:
        if not prompt:
            raise ValueError("empty prompt")
        tele = self.telemetry
        rid = self._tele_rid
        self._tele_rid += 1
        if tele is not None:
            tele.on_submit(rid, len(prompt), correlation_id)
        max_new_tokens = min(max_new_tokens, self.suffix_len - 1)
        n = len(prompt)
        t0 = time.monotonic()
        s_ctx = _round_up(n, self.ctx_quantum)
        seq = tele.next_step() if tele is not None else None
        with step_annotation("prefill", seq, self.device), \
                self._on_stream():
            logits, prefix = self._prefill(prompt, s_ctx)
            first = int(sample(logits, self._gen, self.sampling)[0])
            del logits
        prefill_s = time.monotonic() - t0
        if tele is not None:
            tele.record_step("prefill", prefill_s, seq=seq, rows=1,
                             batch=1, tokens=n, padded_tokens=s_ctx)
            tele.on_admit(rid, wave_start=t0, admit_kind="longctx")

        t1 = time.monotonic()
        generated = [first]
        if first in self._eos_set or max_new_tokens <= 1:
            finish = "eos" if first in self._eos_set else "length"
            out_toks = [] if first in self._eos_set else [first]
            if tele is not None:
                tele.on_retire(rid, new_tokens=len(out_toks),
                               finish_reason=finish)
            return Completion(request_id=0, prompt_len=n, tokens=out_toks,
                              finish_reason=finish, prefill_s=prefill_s,
                              decode_s=0.0, ttft_s=prefill_s)

        cfg = self.cfg
        shape = (cfg.n_layers, 1, cfg.n_kv_heads, self.suffix_len,
                 cfg.head_dim)
        finish = "length"
        suf_len = 0
        with self._on_stream():
            suffix = {"k": zeros(shape, self.dtype, self.device),
                      "v": zeros(shape, self.dtype, self.device)}
        while len(generated) < max_new_tokens:
            td = time.monotonic()
            seq = tele.next_step() if tele is not None else None
            with step_annotation("decode", seq, self.device), \
                    self._on_stream():
                host = self._decode_dispatch(generated[-1], prefix, n,
                                             suffix, suf_len)
            if tele is not None:
                tele.record_step("decode", time.monotonic() - td, seq=seq,
                                 rows=1, batch=1, tokens=len(host),
                                 padded_tokens=self.decode_window)
            done = not host
            for t in host:
                generated.append(t)
                if t in self._eos_set:
                    finish, done = "eos", True
                    break
                if len(generated) >= max_new_tokens:
                    done = True
                    break
            if done:
                break
            suf_len += self.decode_window
        if generated and generated[-1] in self._eos_set:
            generated = generated[:-1]
        if tele is not None:
            tele.on_retire(rid, new_tokens=len(generated),
                           finish_reason=finish)
        return Completion(request_id=0, prompt_len=n, tokens=generated,
                          finish_reason=finish, prefill_s=prefill_s,
                          decode_s=time.monotonic() - t1, ttft_s=prefill_s)

    def generate_text(self, prompt: str, tokenizer,
                      max_new_tokens: int = 256) -> str:
        comp = self.generate(tokenizer.encode(prompt, add_bos=True),
                             max_new_tokens)
        return tokenizer.decode(comp.tokens)
