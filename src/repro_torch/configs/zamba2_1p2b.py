"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block [arXiv:2411.15242].

Zamba-style: ONE shared attention block (shared weights) applied after every
6th Mamba2 layer.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,                # unused by mamba blocks; shared attn block is attn-only
    vocab_size=32000,
    head_dim=64,
    attn_every=6,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, chunk=128),
)
