"""mixtral-8x7b [moe] — 8 experts top-2, SWA [arXiv:2401.04088]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    sliding_window=4096,
    rope_theta=1e6,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=14336, renorm_gate=True),
)
