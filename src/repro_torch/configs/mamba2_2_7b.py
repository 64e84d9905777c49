"""Mamba2-2.7B — attention-free SSM with SSD (state-space duality).
[arXiv:2405.21060]
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    source="arXiv:2405.21060 (Transformers are SSMs — Mamba-2)",
    n_layers=64,
    d_model=2560,
    n_heads=80,                 # d_inner / ssm head_dim = 5120/64
    n_kv_heads=0,               # attention-free
    head_dim=64,
    d_ff=0,                     # no separate MLP; mamba block is the layer
    vocab_size=50280,
    layer_pattern=(LayerSpec(mixer="mamba", mlp="none"),),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1),
    tie_embeddings=True,
    supports_long_context=True,  # O(1) recurrent state
)
