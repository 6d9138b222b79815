"""musicgen-medium [audio] — decoder-only over EnCodec tokens [arXiv:2306.05284].

Backbone only; the EnCodec frontend is a STUB (input_specs provides
precomputed frame embeddings).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    head_dim=64,
    rope_theta=1e4,
    frontend="frames",
)
