"""PyTorch / CUDA port of the summarization serving path for one NVIDIA H100.

A second package beside the JAX one (``copilot_for_consensus_tpu``), which
stays the numerical reference. The port imports neither JAX nor anything
of the JAX package: what it needs of that package's JAX-free modules it
keeps as its own copies (``models/configs.py``, ``engine/tokenizer.py``,
``summarization/base.py``).

Covered today: int8 (or plain) decoder serving through the contiguous-
cache ``engine.generation.GenerationEngine`` and the ``summarization
.summarizer.CUDASummarizer`` on top of it. The Pallas kernels on that path
are hand-written CUDA for ``sm_90a`` under ``csrc/``, built at first use
by ``ops/_build.py``:

* ``ops/flash_attention.py`` (``csrc/flash_attention.cu``) — prefill
  flash attention;
* ``ops/quant_matmul.py`` (``csrc/int8_matmul.cu``) — int8 weight-only
  matmul behind every quantized projection.

Entry points run on the card unless the caller passes ``device="cpu"``;
on CPU tensors each kernel wrapper runs its plain PyTorch version.
"""
