"""PyTorch / CUDA port of the summarization serving path for one NVIDIA H100.

A second package beside the JAX one (``copilot_for_consensus_tpu``), which
stays the numerical reference. The port imports neither JAX nor anything
of the JAX package: what it needs of that package's JAX-free modules it
keeps as its own copies — the host services and what they reach
(``core/``, ``bus/``, ``storage/``, ``services/``, ``schemas/`` and the
rest; ``tests/test_torch_copies.py`` lists them and holds each to its
original).

The system's entry is ``services.runner.build_pipeline``: an mbox becomes
cited reports through the port's ``cuda`` LLM driver (``summarization/
factory.py``), served from a checkpoint directory (``checkpoint/``: the
native format and HF Mistral/Llama, read without ``safetensors``).

Covered today: quantized Mistral-7B summarization serving through
``engine.generation.GenerationEngine`` — the contiguous KV cache, or the
paged pool with its zero-copy prefix cache — and the ``summarization
.summarizer.CUDASummarizer`` on top of it; int8 or int4 weights, weight-
only or with int8 activations ("a8", ``models.quant.set_act_quant``). Every
Pallas kernel of the JAX package, and the weight-stream probe's, is
hand-written CUDA for ``sm_90a`` under ``csrc/``, built at first use by
``ops/_build.py``:

* ``ops/flash_attention.py`` (``csrc/flash_attention.cu``, K1) — prefill
  flash attention;
* ``ops/quant_matmul.py`` — K2 int8 weight-only (``csrc/int8_matmul.cu``),
  K5 int4 weight-only (``csrc/int4_matmul.cu``), K4 W8A8
  (``csrc/w8a8_matmul.cu``) and K6 W4A8 (``csrc/w4a8_matmul.cu``), the
  last three sharing ``csrc/quant_mma.cuh``;
* ``ops/paged_attention.py`` (``csrc/paged_attention.cu``, K3) — flash
  partials over the paged pool;
* ``ops/probe_stream.py`` (``csrc/probe_stream.cu``, P) — the weight-stream
  probe's dma, convdot, i8dot and unpack bodies, driven by
  ``scripts/probe_stream.py`` (``python -m
  copilot_for_consensus_tpu_torch.scripts.probe_stream``).

Entry points run on the card unless the caller passes ``device="cpu"``;
on CPU tensors each kernel wrapper runs its plain PyTorch version.
"""
