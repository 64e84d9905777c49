"""PyTorch/CUDA port of the ``repro`` package, held against it as reference.

Slice 1 serves dense decoders (gemma-2b): prefill and greedy decode, with
hand-written CUDA kernels for RMSNorm and causal flash attention
(``repro_torch.kernels``).  The package imports ``torch`` and never JAX
or ``repro``; it keeps its own copy of what it needs (``configs``).
"""
