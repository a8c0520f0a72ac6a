"""Attention and quantized-matmul ops: kernel wrappers (``flash_attention``,
``quant_matmul``), their plain versions, and the plain attention
functions (``attention``)."""
