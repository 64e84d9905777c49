"""Gemma-2B — dense decoder, GeGLU, head_dim=256, MQA (1 KV head).
[arXiv:2403.08295]
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="gemma-2b",
    family="dense",
    source="arXiv:2403.08295 (Gemma: Open Models Based on Gemini)",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,               # MQA
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    layer_pattern=(LayerSpec(mixer="attn", mlp="dense"),),
    mlp_activation="geglu",
    tie_embeddings=True,
    scale_embeddings=True,
    supports_long_context=False,
)
