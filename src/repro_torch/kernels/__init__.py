"""Hand-written CUDA kernels (``csrc/``), their plain PyTorch versions
(``ref``), the build (``build``) and the dispatching wrappers (``ops``).

Nothing is compiled or loaded at import: the library is built at the
first kernel launch, so the CPU path imports this package freely.
"""
