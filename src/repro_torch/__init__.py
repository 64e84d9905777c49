"""PyTorch/CUDA port of the ``repro`` package, held against it as reference.

It serves dense decoders (gemma-2b: prefill and greedy decode) and trains
them under the BFTrainer control loop (``launch.train`` →
``elastic.BFTrainerRuntime`` → ``ElasticTrainer`` → ``Model.loss`` →
``optim.AdamW``), with hand-written CUDA kernels for RMSNorm, causal
flash attention and the fused cross-entropy, forward and backward
(``repro_torch.kernels``).  The package imports ``torch`` and never JAX
or ``repro``; it keeps its own copy of what it needs (``configs``,
``data``, ``obs`` and the control plane in ``core``).
"""
