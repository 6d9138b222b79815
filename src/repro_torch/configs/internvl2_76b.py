"""internvl2-76b [vlm] — InternViT + InternLM2 backbone [arXiv:2404.16821].

Backbone only; the vision frontend is a STUB (input_specs provides
precomputed patch embeddings).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    head_dim=128,
    rope_theta=1e6,
    frontend="patch",
)
